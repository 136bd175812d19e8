// Online-softmax (flash) attention forward for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel src/repro/kernels/flash_attention/kernel.py:
// flash_attention (body _flash_kernel), reached through ops.attention.  In
// the JAX layout q [B, Sq, H, D], k/v [B, Skv, K, D] with H = K G: query
// head h reads kv head h / G (GQA without materialising the repeat), scores
// are q.k / sqrt(D) in f32, the causal mask keeps q_pos + (Skv - Sq) >=
// k_pos and writes -1e30 (not -inf) where it masks, so a fully masked row
// averages v as the reference does.  Running row max m, sum l and f32
// accumulator follow kernel.py: m' = max(m, max s), p = exp(s - m'),
// l' = l exp(m - m') + sum p, acc' = acc exp(m - m') + p v, out = acc / l
// (l == 0 -> 1), rounded to the output type to nearest even.  Key tiles
// wholly above the causal diagonal are skipped, which leaves the result
// unchanged (exp(-1e30 - m) is exactly 0 and exp(m - m) exactly 1), except
// for a query tile with a fully masked row, which visits every key.  Keys
// at or past Skv score -inf and add nothing.  Query tiles run heaviest
// first.  Two kernels:
//
// bf16: flash_attention_kernel_tc, on the tensor cores.  Bound: operations,
// 4 Sq Skv D H multiply-adds (halved by a causal mask) at the 989 TFLOP/s
// bf16 rate, against about 2 (Sq + 2 Skv) D H bytes.  One block of three
// warpgroups per (b, h, 128-query tile).  Warpgroup 2 is the producer: one
// thread loads the query tile once, then 128-key K and V tiles into a ring
// of shared-memory stages, all by TMA from 4-D tensor maps (D, heads, seq,
// B) that zero-fill past Sq / Skv inside one batch, each stage behind a
// "full" mbarrier (bytes landed) and an "empty" one (both consumers done).
// Warpgroups 0 and 1 each own 64 query rows: S = Q K^T is wgmma
// m64n128k16 with both operands in shared memory (K's [key, d] rows are
// K-major), the online softmax runs on the f32 accumulator in registers
// (exp2 with log2(e) / sqrt(D) folded in; a row's four threads reduce with
// two shuffles), P is rounded to bf16 in registers and O += P V is wgmma
// m64nDk16 with P as the register operand and V MN-major (transposed) from
// shared memory.  Tiles are bf16 in 128-byte-swizzled boxes of 64 columns
// (D = 128 is two boxes side by side), read by wgmma through descriptors
// that step over the boxes.  setmaxnreg gives the consumers 232 registers
// and the producer 40.  The epilogue divides by l, rounds to bf16 into the
// warpgroup's own rows of the query tile and writes them with a TMA store.
// P V on bf16 P adds an error of order 2^-9 |v| to the f32 products of the
// TPU kernel, inside the bf16 tolerance.
//
// f32: flash_attention_kernel_f32tc, on the tensor cores as 3xTF32.
// Bound: operations, the same multiply-adds, each f32-accurate product
// taken as three TF32 products at the 495 TFLOP/s TF32 rate, so 165
// TFLOP/s effective.  Every operand x is split in registers into hi and
// lo = x - hi, both rounded to TF32 to nearest (cvt.rna's rounding, done
// as integer arithmetic on the f32 bits: fewer instructions), and a b is
// summed as a_lo b_hi + a_hi b_lo + a_hi b_hi, the small terms first; this
// is the scheme of PyTorch's own f32 attention (CUTLASS's
// OpMultiplyAddFastF32).  The dropped a_lo b_lo and the rounding of lo are
// of order 2^-22 |a b|, so the result keeps f32 precision (a few 1e-6
// against the f32 plain version, inside 2e-5).  The tensor cores round
// their accumulator toward zero, so each key tile's P V is summed apart
// and added to O with an f32 FMA; only the 16 k-steps of one S = Q K^T
// stay in the accumulator.
//
// One block of three warpgroups per (b, h, 128-query tile).  Warpgroup 2
// is the producer: one thread loads the query tile once, then 64-key K and
// V tiles into a ring of stages (2 at D 128, 4 at D 64), by TMA from the
// same 4-D tensor maps as bf16 in f32 boxes of 32 columns (128 bytes,
// swizzled), behind full/empty mbarriers.  The eight warps of warpgroups 0
// and 1 each own 16 query rows and run mma.sync m16n8k8 on TF32 fragments
// in registers.  S = Q K^T reads Q and K as 16-byte vectors: the sum over
// d runs in a permuted order in which each thread's four values are one
// swizzled chunk, and the eight threads of a quarter-warp read eight
// different chunks (no bank conflicts).  The online softmax runs on the
// f32 accumulator (exp2 with log2(e) / sqrt(D) folded in).  P stays in
// registers as the A operand of P V: the m16n8 accumulator of S is the
// m16n8k8 A fragment once each 8-key step takes its keys in the order 0,
// 2, 4, 6, 1, 3, 5, 7.  V's B fragments come from its [key][d] tile as it
// lies, 16 bytes at a time, the output columns permuted so that one vector
// holds four n-tiles' values; the epilogue writes each thread's eight
// contiguous output columns per 32 with two 16-byte stores.
//
// Shared memory: Q 64 KB + 2 x (32 + 32) KB of K/V at D 128 (197,672 bytes
// with barriers and alignment), Q 32 KB + 4 x (16 + 16) KB at D 64
// (164,936).  Registers: 64 (O at D 128) + 64 (a tile's P V) + 32 (S) +
// fragments; setmaxnreg gives the consumers 240 and the producer 24 (nine
// warps without it would cap every thread at 168, and D 128 spilled
// there).  mma.sync and not wgmma: wgmma's .tf32 form reads B only K-major
// from shared memory and truncates the f32 bits it reads, so V would need
// a transposed copy and K and V hi and lo tiles in shared memory (128 KB a
// 64-key stage at D 128), and a truncated split (lo up to 2^-10 |x|) is
// about three times less accurate; mma.sync takes its fragments from
// registers, where the split to nearest costs a few integer operations and
// a subtract per element.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "hopper.cuh"

namespace {

constexpr float kMasked = -1e30f;

// ---- bf16 on the tensor cores ---------------------------------------------

constexpr int kRows = 128;      // queries of a block, 64 per consumer warpgroup
constexpr int kKeys = 128;      // keys of a K/V tile
constexpr int kBox = 64;        // bf16 columns of one 128-byte swizzled box
constexpr int kTcThreads = 384; // warpgroups 0, 1 consume, 2 produces
constexpr float kLog2e = 1.4426950408889634f;

// Shared memory, from a 1024-aligned base: the query tile, then per stage
// a K tile and a V tile, each [D / 64 boxes][128 rows][64] bf16 swizzled,
// then the barriers (query, full[stages], empty[stages]).  Over 113 KB at
// both head dims, so one block holds an SM, as setmaxnreg's split assumes.
template <int D>
struct TcLayout {
  static constexpr int kStages = D == 128 ? 2 : 4;
  static constexpr int kBoxBytes = kRows * kBox * 2;      // 16 KB
  static constexpr int kTile = kRows * D * 2;             // Q, K or V tile
  static constexpr int kStage0 = kTile;                   // K, then V
  static constexpr int kBars = kTile * (1 + 2 * kStages);
  static constexpr int kAlloc = kBars + 8 * (1 + 2 * kStages) + 1024;
};

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

template <int D>
__global__ void __launch_bounds__(kTcThreads, 1)
flash_attention_kernel_tc(const __grid_constant__ CUtensorMap q_map,
                          const __grid_constant__ CUtensorMap k_map,
                          const __grid_constant__ CUtensorMap v_map,
                          const __grid_constant__ CUtensorMap o_map, int sq,
                          int skv, int h, int kh, int causal) {
  using L = TcLayout<D>;
  using namespace hopper;
  constexpr int kHalves = D / kBox;
  extern __shared__ uint8_t tc_smem[];
  const uint32_t raw = smem_addr(tc_smem);
  const uint32_t base = (raw + 1023u) & ~1023u;
  const uint32_t q_tile = base;
  const uint32_t q_full = base + L::kBars;
  const auto full = [&](int s) { return q_full + 8u * (1 + s); };
  const auto empty = [&](int s) {
    return q_full + 8u * (1 + L::kStages + s);
  };
  const auto k_tile = [&](int s) {
    return base + L::kStage0 + 2u * L::kTile * s;
  };

  const int b = blockIdx.x / h, head = blockIdx.x % h, kvh = head / (h / kh);
  const int q0 = (gridDim.y - 1 - blockIdx.y) * kRows;
  const int off = skv - sq;
  int kv_end = skv;
  if (causal && q0 + off >= 0)     // every row of the tile sees key 0
    kv_end = min(skv, min(q0 + kRows, sq) + off);
  const int n_tiles = (kv_end + kKeys - 1) / kKeys;

  if (threadIdx.x == 0) {
    mbar_init(q_full, 1);
    for (int s = 0; s < L::kStages; ++s) {
      mbar_init(full(s), 1);
      mbar_init(empty(s), 8);        // one arrival per consumer warp
    }
    mbar_init_fence();
  }
  __syncthreads();

  const int wg = threadIdx.x / 128;
  if (wg == 2) {
    // producer: one thread issues every load
    setmaxnreg_dec<40>();
    if (threadIdx.x == 256) {
      mbar_expect_tx(q_full, L::kTile);
      for (int hf = 0; hf < kHalves; ++hf)
        tma_load_4d(q_tile + hf * L::kBoxBytes, &q_map, q_full, hf * kBox,
                    head, q0, b);
      for (int i = 0; i < n_tiles; ++i) {
        const int s = i % L::kStages, use = i / L::kStages;
        if (use > 0) mbar_wait(empty(s), (use - 1) & 1);
        mbar_expect_tx(full(s), 2 * L::kTile);
        const uint32_t kt = k_tile(s), vt = kt + L::kTile;
        for (int hf = 0; hf < kHalves; ++hf) {
          tma_load_4d(kt + hf * L::kBoxBytes, &k_map, full(s), hf * kBox,
                      kvh, i * kKeys, b);
          tma_load_4d(vt + hf * L::kBoxBytes, &v_map, full(s), hf * kBox,
                      kvh, i * kKeys, b);
        }
      }
    }
  } else {
    setmaxnreg_inc<232>();
    const int t = threadIdx.x % 128, warp = t / 32, lane = t % 32;
    const int row0 = q0 + wg * 64;   // first query of this warpgroup
    int wg_end = skv;                // keys this warpgroup's rows need
    if (causal && row0 + off >= 0)
      wg_end = min(skv, min(row0 + 64, sq) + off);
    // this thread's rows (of the warpgroup's 64) are r and r + 8; its
    // accumulator columns 8 j + 2 (lane % 4) + {0, 1}
    const int r = 16 * warp + lane / 4, col = 2 * (lane % 4);
    const float scale = kLog2e / sqrtf((float)D);

    float o[D / 2];
#pragma unroll
    for (int i = 0; i < D / 2; ++i) o[i] = 0.0f;
    float m[2] = {kMasked, kMasked}, l[2] = {0.0f, 0.0f};

    // Q rows of this warpgroup, K-major: 8-row groups 1024 bytes apart,
    // k-step kk at +32 bytes inside a box, then the next box
    const uint32_t q_rows = q_tile + wg * 64 * 128;
    mbar_wait(q_full, 0);

    for (int i = 0; i < n_tiles; ++i) {
      const int s = i % L::kStages, j0 = i * kKeys;
      mbar_wait(full(s), (i / L::kStages) & 1);
      if (j0 < wg_end) {
        const uint32_t kt = k_tile(s), vt = kt + L::kTile;
        float sc[64];
        wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < D / 16; ++kk) {
          const uint32_t step = (kk / 4) * L::kBoxBytes + (kk % 4) * 32;
          wgmma_m64n128k16_ss(sc, desc_b128(q_rows + step, 16, 1024),
                              desc_b128(kt + step, 16, 1024), kk > 0);
        }
        wgmma_commit();
        wgmma_wait<0>();
        fence_regs(sc);

        // scores in the log2 domain; masks only where the tile crosses the
        // diagonal or Skv
        const bool edge = j0 + kKeys > skv ||
                          (causal && j0 + kKeys - 1 > row0 + off);
        float mx[2] = {m[0], m[1]};
#pragma unroll
        for (int i2 = 0; i2 < 64; ++i2) {
          float x = sc[i2] * scale;
          if (edge) {
            const int key = j0 + 8 * (i2 / 4) + col + (i2 & 1);
            const int qpos = row0 + r + 8 * ((i2 / 2) & 1);
            if (key >= skv) x = -INFINITY;
            else if (causal && qpos + off < key) x = kMasked;
          }
          sc[i2] = x;
          mx[(i2 / 2) & 1] = fmaxf(mx[(i2 / 2) & 1], x);
        }
        float corr[2];
#pragma unroll
        for (int hh = 0; hh < 2; ++hh) {
          mx[hh] = fmaxf(mx[hh], __shfl_xor_sync(0xffffffffu, mx[hh], 1));
          mx[hh] = fmaxf(mx[hh], __shfl_xor_sync(0xffffffffu, mx[hh], 2));
          corr[hh] = exp2f(m[hh] - mx[hh]);
          m[hh] = mx[hh];
          l[hh] *= corr[hh];
        }
        uint32_t p[8][4];
#pragma unroll
        for (int i2 = 0; i2 < 64; i2 += 2) {
          const int hh = (i2 / 2) & 1;
          const float a = exp2f(sc[i2] - m[hh]);
          const float c = exp2f(sc[i2 + 1] - m[hh]);
          l[hh] += a + c;
          p[i2 / 8][(i2 / 2) % 4] = pack_bf16(a, c);
        }
#pragma unroll
        for (int i2 = 0; i2 < D / 2; ++i2) o[i2] *= corr[(i2 / 2) & 1];

        // O += P V: V's [key][d] boxes are MN-major for B; 8-key groups
        // 1024 bytes apart (SBO), the second 64 columns one box on (LBO)
        fence_regs(o);
        fence_regs(p);
        wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < kKeys / 16; ++kk) {
          const uint64_t vd = desc_b128(vt + kk * 16 * 128, L::kBoxBytes,
                                        1024);
          if constexpr (D == 128)
            wgmma_m64n128k16_rs(o, p[kk], vd);
          else
            wgmma_m64n64k16_rs(o, p[kk], vd);
        }
        wgmma_commit();
        wgmma_wait<0>();
        fence_regs(o);
      }
      if (lane == 0) mbar_arrive(empty(s));
    }

    // epilogue: O / l in bf16 into this warpgroup's rows of the query tile
    // (swizzled as the boxes are), then one TMA store per box
#pragma unroll
    for (int hh = 0; hh < 2; ++hh) {
      l[hh] += __shfl_xor_sync(0xffffffffu, l[hh], 1);
      l[hh] += __shfl_xor_sync(0xffffffffu, l[hh], 2);
      l[hh] = l[hh] == 0.0f ? 1.0f : l[hh];
    }
#pragma unroll
    for (int i2 = 0; i2 < D / 2; i2 += 2) {
      const int hh = (i2 / 2) & 1, j = i2 / 4;
      const int row = r + 8 * hh;
      const uint32_t at = q_rows + (j / 8) * L::kBoxBytes + row * 128 +
                          (((j % 8) ^ (row % 8)) << 4) + col * 2;
      *reinterpret_cast<uint32_t*>(tc_smem + (at - raw)) =
          pack_bf16(o[i2] / l[hh], o[i2 + 1] / l[hh]);
    }
    fence_proxy_async();
    named_barrier(1 + wg, 128);
    if (t == 0 && row0 < sq) {
      for (int hf = 0; hf < kHalves; ++hf)
        tma_store_4d(&o_map, q_rows + hf * L::kBoxBytes, hf * kBox, head,
                     row0, b);
      tma_store_drain();
    }
  }
}

using EncodeTiled = CUresult (*)(CUtensorMap*, CUtensorMapDataType,
                                 cuuint32_t, void*, const cuuint64_t*,
                                 const cuuint64_t*, const cuuint32_t*,
                                 const cuuint32_t*, CUtensorMapInterleave,
                                 CUtensorMapSwizzle, CUtensorMapL2promotion,
                                 CUtensorMapFloatOOBfill);

// cuTensorMapEncodeTiled from the driver, found through the runtime so
// the library does not link libcuda
EncodeTiled encode_tiled() {
  static const EncodeTiled fn = [] {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult found;
    const cudaError_t err = cudaGetDriverEntryPointByVersion(
        "cuTensorMapEncodeTiled", &p, 12000, cudaEnableDefault, &found);
    return err == cudaSuccess && found == cudaDriverEntryPointSuccess
               ? reinterpret_cast<EncodeTiled>(p)
               : nullptr;
  }();
  return fn;
}

// a bf16 or f32 ([elem] bytes) [B, seq, heads, D] tensor as the 4-D map
// (D, heads, seq, B), innermost first, cut into (128 / elem, 1, rows, 1)
// boxes (64 bf16 or 32 f32 columns) swizzled by 128 bytes
bool tensor_map(CUtensorMap* map, const void* ptr, int64_t b, int64_t seq,
                int64_t heads, int d, int rows, int elem) {
  const EncodeTiled encode = encode_tiled();
  if (encode == nullptr) return false;
  const cuuint64_t dims[4] = {(cuuint64_t)d, (cuuint64_t)heads,
                              (cuuint64_t)seq, (cuuint64_t)b};
  const cuuint64_t strides[3] = {(cuuint64_t)d * elem,
                                 (cuuint64_t)(heads * d) * elem,
                                 (cuuint64_t)(seq * heads * d) * elem};
  const cuuint32_t box[4] = {(cuuint32_t)(128 / elem), 1, (cuuint32_t)rows,
                             1};
  const cuuint32_t unit[4] = {1, 1, 1, 1};
  return encode(map, elem == 2 ? CU_TENSOR_MAP_DATA_TYPE_BFLOAT16
                               : CU_TENSOR_MAP_DATA_TYPE_FLOAT32, 4,
                const_cast<void*>(ptr), dims, strides, box, unit,
                CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
                CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

template <int D>
cudaError_t run_tc(const void* q, const void* k, const void* v, void* o,
                   int64_t b, int64_t sq, int64_t skv, int64_t h, int64_t kh,
                   int causal, cudaStream_t stream) {
  const auto kernel = flash_attention_kernel_tc<D>;
  const int smem = TcLayout<D>::kAlloc;
  const cudaError_t attr = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (attr != cudaSuccess) return attr;
  const int64_t tiles = (sq + kRows - 1) / kRows;
  if (tiles > 65535 || b * h > INT32_MAX || sq > INT32_MAX ||
      skv > INT32_MAX)
    return cudaErrorInvalidConfiguration;
  // o is stored per consumer warpgroup, 64 rows a box
  CUtensorMap qm, km, vm, om;
  if (!tensor_map(&qm, q, b, sq, h, D, kRows, 2) ||
      !tensor_map(&km, k, b, skv, kh, D, kKeys, 2) ||
      !tensor_map(&vm, v, b, skv, kh, D, kKeys, 2) ||
      !tensor_map(&om, o, b, sq, h, D, kRows / 2, 2))
    return cudaErrorInvalidValue;
  const dim3 grid((unsigned)(b * h), (unsigned)tiles);
  kernel<<<grid, kTcThreads, smem, stream>>>(qm, km, vm, om, (int)sq,
                                             (int)skv, (int)h, (int)kh,
                                             causal);
  return cudaGetLastError();
}

// ---- f32 on the tensor cores: 3xTF32 --------------------------------------

constexpr int kF32Rows = 128;   // queries of a block, 16 per consumer warp
constexpr int kF32Keys = 64;    // keys of a K/V tile
constexpr int kF32Box = 32;     // f32 columns of one 128-byte swizzled box
constexpr int kF32Warps = 8;    // consumer warps: warpgroups 0 and 1
constexpr int kF32Threads = 384; // warpgroup 2 produces

// Shared memory, from a 1024-aligned base: the query tile, then per stage
// a K tile and a V tile, each [D / 32 boxes][rows][32] f32 swizzled, then
// the barriers (query, full[stages], empty[stages]).  Over 113 KB at both
// head dims, so one block holds an SM.
template <int D>
struct F32Layout {
  static constexpr int kStages = D == 128 ? 2 : 4;
  static constexpr int kQBox = kF32Rows * 128;          // bytes of a Q box
  static constexpr int kKBox = kF32Keys * 128;          // of a K or V box
  static constexpr int kQ = kQBox * (D / kF32Box);
  static constexpr int kKV = kKBox * (D / kF32Box);     // a K or V tile
  static constexpr int kBars = kQ + 2 * kKV * kStages;
  static constexpr int kAlloc = kBars + 8 * (1 + 2 * kStages) + 1024;
};

// x to TF32, to nearest with ties away from zero (cvt.rna's rounding), in
// two full-rate integer operations: half of the last kept bit added to the
// magnitude bits, the 13 dropped bits cleared (cvt.rna.tf32.f32 itself
// compiles to a longer sequence of compares and selects)
__device__ __forceinline__ uint32_t tf32_rna(float x) {
  return (__float_as_uint(x) + 0x1000u) & 0xFFFFE000u;
}

// x = hi + lo, each TF32 rounded to nearest
__device__ __forceinline__ void split_tf32(float x, uint32_t& hi,
                                           uint32_t& lo) {
  hi = tf32_rna(x);
  lo = tf32_rna(x - __uint_as_float(hi));
}

// d[16 x 8] += a[16 x 8] b[8 x 8], TF32 operands, f32 accumulator
__device__ __forceinline__ void mma_tf32(float (&d)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// d += a b to f32 precision: a_lo b_hi + a_hi b_lo + a_hi b_hi
__device__ __forceinline__ void mma_3xtf32(float (&d)[4],
                                           const uint32_t (&ah)[4],
                                           const uint32_t (&al)[4],
                                           const uint32_t (&bh)[2],
                                           const uint32_t (&bl)[2]) {
  mma_tf32(d, al, bh[0], bh[1]);
  mma_tf32(d, ah, bl[0], bl[1]);
  mma_tf32(d, ah, bh[0], bh[1]);
}

__device__ __forceinline__ float4 ld4(const uint8_t* p) {
  return *reinterpret_cast<const float4*>(p);
}

template <int D>
__global__ void __launch_bounds__(kF32Threads, 1)
flash_attention_kernel_f32tc(const __grid_constant__ CUtensorMap q_map,
                             const __grid_constant__ CUtensorMap k_map,
                             const __grid_constant__ CUtensorMap v_map,
                             float* __restrict__ out, int sq, int skv, int h,
                             int kh, int causal) {
  using L = F32Layout<D>;
  using namespace hopper;
  constexpr int kBoxes = D / kF32Box;
  extern __shared__ uint8_t f32_smem[];
  const uint32_t raw = smem_addr(f32_smem);
  const uint32_t base = (raw + 1023u) & ~1023u;
  const uint8_t* const tiles = f32_smem + (base - raw);
  const uint32_t q_full = base + L::kBars;
  const auto full = [&](int s) { return q_full + 8u * (1 + s); };
  const auto empty = [&](int s) {
    return q_full + 8u * (1 + L::kStages + s);
  };

  const int b = blockIdx.x / h, head = blockIdx.x % h, kvh = head / (h / kh);
  const int q0 = (gridDim.y - 1 - blockIdx.y) * kF32Rows;
  const int off = skv - sq;
  int kv_end = skv;
  if (causal && q0 + off >= 0)     // every row of the tile sees key 0
    kv_end = min(skv, min(q0 + kF32Rows, sq) + off);
  const int n_tiles = (kv_end + kF32Keys - 1) / kF32Keys;

  if (threadIdx.x == 0) {
    mbar_init(q_full, 1);
    for (int s = 0; s < L::kStages; ++s) {
      mbar_init(full(s), 1);
      mbar_init(empty(s), kF32Warps);   // one arrival per consumer warp
    }
    mbar_init_fence();
  }
  __syncthreads();

  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  if (warp >= kF32Warps) {
    // producer: one thread issues every load
    setmaxnreg_dec<24>();
    if (threadIdx.x == 32 * kF32Warps) {
      mbar_expect_tx(q_full, L::kQ);
      for (int bx = 0; bx < kBoxes; ++bx)
        tma_load_4d(base + bx * L::kQBox, &q_map, q_full, bx * kF32Box, head,
                    q0, b);
      for (int i = 0; i < n_tiles; ++i) {
        const int s = i % L::kStages, use = i / L::kStages;
        if (use > 0) mbar_wait(empty(s), (use - 1) & 1);
        mbar_expect_tx(full(s), 2 * L::kKV);
        const uint32_t kt = base + L::kQ + 2u * L::kKV * s, vt = kt + L::kKV;
        for (int bx = 0; bx < kBoxes; ++bx) {
          tma_load_4d(kt + bx * L::kKBox, &k_map, full(s), bx * kF32Box, kvh,
                      i * kF32Keys, b);
          tma_load_4d(vt + bx * L::kKBox, &v_map, full(s), bx * kF32Box, kvh,
                      i * kF32Keys, b);
        }
      }
    }
    return;
  }
  setmaxnreg_inc<240>();

  // fragments: g = lane / 4 picks rows g and g + 8 of the warp's 16 (and
  // the n index of B), t = lane % 4 the k index (t and t + 4)
  const int g = lane / 4, t = lane % 4;
  const int row0 = q0 + 16 * warp;   // first query of this warp
  int w_end = skv;                   // keys this warp's rows need
  if (row0 >= sq)
    w_end = 0;
  else if (causal && row0 + off >= 0)
    w_end = min(skv, min(row0 + 16, sq) + off);
  const float scale = kLog2e / sqrtf((float)D);

  // S = Q K^T: k-steps 2p and 2p + 1 read one 16-byte chunk of box p / 2
  // per row: logical chunk 2t + p % 2, swizzled by the row (rows 8 apart
  // share it); its values are k = t, t + 4 of step 2p, then of 2p + 1
  const int q_row = (16 * warp + g) * 128;
  const int chunk[2] = {((2 * t) ^ g) << 4, ((2 * t + 1) ^ g) << 4};
  // P V: keys 2t and 2t + 1 of each 8-key step are k = t and t + 4; a V
  // row's logical chunk g in box c holds n index g of n-tiles 4c .. 4c + 3
  const int v_off0 = 2 * t * 128 + ((g ^ (2 * t)) << 4);
  const int v_off1 = (2 * t + 1) * 128 + ((g ^ (2 * t + 1)) << 4);

  float o[D / 8][4];
#pragma unroll
  for (int n = 0; n < D / 8; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) o[n][e] = 0.0f;
  float m[2] = {kMasked, kMasked}, l[2] = {0.0f, 0.0f};
  mbar_wait(q_full, 0);

  for (int i = 0; i < n_tiles; ++i) {
    const int s = i % L::kStages, j0 = i * kF32Keys;
    mbar_wait(full(s), (i / L::kStages) & 1);
    if (j0 < w_end) {
      const uint8_t* kt = tiles + L::kQ + 2 * L::kKV * s;
      const uint8_t* vt = kt + L::kKV;
      float sc[8][4];
#pragma unroll
      for (int n = 0; n < 8; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) sc[n][e] = 0.0f;
#pragma unroll
      for (int p = 0; p < D / 16; ++p) {
        const int at = (p / 2) * L::kQBox + chunk[p % 2];
        const float4 qa = ld4(tiles + at + q_row);
        const float4 qb = ld4(tiles + at + q_row + 8 * 128);
        // A of steps 2p, 2p + 1: (row g, k t), (g + 8, t), (g, t + 4),
        // (g + 8, t + 4)
        uint32_t ah[2][4], al[2][4];
        split_tf32(qa.x, ah[0][0], al[0][0]);
        split_tf32(qb.x, ah[0][1], al[0][1]);
        split_tf32(qa.y, ah[0][2], al[0][2]);
        split_tf32(qb.y, ah[0][3], al[0][3]);
        split_tf32(qa.z, ah[1][0], al[1][0]);
        split_tf32(qb.z, ah[1][1], al[1][1]);
        split_tf32(qa.w, ah[1][2], al[1][2]);
        split_tf32(qb.w, ah[1][3], al[1][3]);
        const int kat = (p / 2) * L::kKBox + g * 128 + chunk[p % 2];
#pragma unroll
        for (int n = 0; n < 8; ++n) {
          const float4 kv = ld4(kt + kat + n * 8 * 128);   // key 8n + g
          uint32_t bh[2][2], bl[2][2];
          split_tf32(kv.x, bh[0][0], bl[0][0]);
          split_tf32(kv.y, bh[0][1], bl[0][1]);
          split_tf32(kv.z, bh[1][0], bl[1][0]);
          split_tf32(kv.w, bh[1][1], bl[1][1]);
          mma_3xtf32(sc[n], ah[0], al[0], bh[0], bl[0]);
          mma_3xtf32(sc[n], ah[1], al[1], bh[1], bl[1]);
        }
      }

      // scores in the log2 domain; sc[n] holds keys 8n + 2t + {0, 1} of
      // rows g ({0, 1}) and g + 8 ({2, 3}); masks only where the tile
      // crosses the diagonal or Skv
      const bool edge = j0 + kF32Keys > skv ||
                        (causal && j0 + kF32Keys - 1 > row0 + off);
      float mx[2] = {m[0], m[1]};
#pragma unroll
      for (int n = 0; n < 8; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          float x = sc[n][e] * scale;
          if (edge) {
            const int key = j0 + 8 * n + 2 * t + (e & 1);
            const int qpos = row0 + g + 8 * (e >> 1);
            if (key >= skv) x = -INFINITY;
            else if (causal && qpos + off < key) x = kMasked;
          }
          sc[n][e] = x;
          mx[e >> 1] = fmaxf(mx[e >> 1], x);
        }
      float corr[2];
#pragma unroll
      for (int hh = 0; hh < 2; ++hh) {
        mx[hh] = fmaxf(mx[hh], __shfl_xor_sync(0xffffffffu, mx[hh], 1));
        mx[hh] = fmaxf(mx[hh], __shfl_xor_sync(0xffffffffu, mx[hh], 2));
        corr[hh] = exp2f(m[hh] - mx[hh]);
        m[hh] = mx[hh];
        l[hh] *= corr[hh];
      }
#pragma unroll
      for (int n = 0; n < 8; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          sc[n][e] = exp2f(sc[n][e] - m[e >> 1]);
          l[e >> 1] += sc[n][e];
        }

      // P V of this tile, 8 keys a step; n-tile 4c + e, n index g is
      // column 32c + 4g + e.  It is summed apart and added to O with an f32
      // FMA: the tensor cores' accumulator truncates, and O summed there
      // over every key tile lost up to 1e-5
      float pv[D / 8][4];
#pragma unroll
      for (int n = 0; n < D / 8; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) pv[n][e] = 0.0f;
#pragma unroll
      for (int k8 = 0; k8 < 8; ++k8) {
        uint32_t ph[4], pl[4];
        split_tf32(sc[k8][0], ph[0], pl[0]);   // (g, key 2t)
        split_tf32(sc[k8][2], ph[1], pl[1]);   // (g + 8, 2t)
        split_tf32(sc[k8][1], ph[2], pl[2]);   // (g, 2t + 1)
        split_tf32(sc[k8][3], ph[3], pl[3]);   // (g + 8, 2t + 1)
        const uint8_t* vrow = vt + k8 * 8 * 128;
#pragma unroll
        for (int c = 0; c < kBoxes; ++c) {
          const float4 v0 = ld4(vrow + c * L::kKBox + v_off0);
          const float4 v1 = ld4(vrow + c * L::kKBox + v_off1);
          const float a0[4] = {v0.x, v0.y, v0.z, v0.w};
          const float a1[4] = {v1.x, v1.y, v1.z, v1.w};
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            uint32_t bh[2], bl[2];
            split_tf32(a0[e], bh[0], bl[0]);
            split_tf32(a1[e], bh[1], bl[1]);
            mma_3xtf32(pv[4 * c + e], ph, pl, bh, bl);
          }
        }
      }
#pragma unroll
      for (int n = 0; n < D / 8; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e)
          o[n][e] = fmaf(o[n][e], corr[e >> 1], pv[n][e]);
    }
    __syncwarp();
    if (lane == 0) mbar_arrive(empty(s));
  }

  // epilogue: O / l; n index 2t (2t + 1) of n-tiles 4c .. 4c + 3 are
  // columns 32c + 8t + {0..3} ({4..7}), two 16-byte stores per row and box
#pragma unroll
  for (int hh = 0; hh < 2; ++hh) {
    l[hh] += __shfl_xor_sync(0xffffffffu, l[hh], 1);
    l[hh] += __shfl_xor_sync(0xffffffffu, l[hh], 2);
    l[hh] = l[hh] == 0.0f ? 1.0f : l[hh];
    const int r = row0 + g + 8 * hh;
    if (r >= sq) continue;
    float* dst = out + (((int64_t)b * sq + r) * h + head) * D + 8 * t;
#pragma unroll
    for (int c = 0; c < kBoxes; ++c) {
      const int e0 = 2 * hh;
      *reinterpret_cast<float4*>(dst + 32 * c) = make_float4(
          o[4 * c][e0] / l[hh], o[4 * c + 1][e0] / l[hh],
          o[4 * c + 2][e0] / l[hh], o[4 * c + 3][e0] / l[hh]);
      *reinterpret_cast<float4*>(dst + 32 * c + 4) = make_float4(
          o[4 * c][e0 + 1] / l[hh], o[4 * c + 1][e0 + 1] / l[hh],
          o[4 * c + 2][e0 + 1] / l[hh], o[4 * c + 3][e0 + 1] / l[hh]);
    }
  }
}

template <int D>
cudaError_t run_f32(const void* q, const void* k, const void* v, void* o,
                    int64_t b, int64_t sq, int64_t skv, int64_t h, int64_t kh,
                    int causal, cudaStream_t stream) {
  const auto kernel = flash_attention_kernel_f32tc<D>;
  const int smem = F32Layout<D>::kAlloc;
  const cudaError_t attr = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (attr != cudaSuccess) return attr;
  const int64_t tiles = (sq + kF32Rows - 1) / kF32Rows;
  if (tiles > 65535 || b * h > INT32_MAX || sq > INT32_MAX ||
      skv > INT32_MAX)
    return cudaErrorInvalidConfiguration;
  CUtensorMap qm, km, vm;
  if (!tensor_map(&qm, q, b, sq, h, D, kF32Rows, 4) ||
      !tensor_map(&km, k, b, skv, kh, D, kF32Keys, 4) ||
      !tensor_map(&vm, v, b, skv, kh, D, kF32Keys, 4))
    return cudaErrorInvalidValue;
  const dim3 grid((unsigned)(b * h), (unsigned)tiles);
  kernel<<<grid, kF32Threads, smem, stream>>>(qm, km, vm, (float*)o, (int)sq,
                                              (int)skv, (int)h, (int)kh,
                                              causal);
  return cudaGetLastError();
}

}  // namespace

extern "C" int flash_attention(const void* q, const void* k, const void* v,
                               void* o, int64_t b, int64_t sq, int64_t skv,
                               int64_t h, int64_t kh, int d, int causal,
                               int bf16, int device, void* stream) {
  const cudaError_t set = cudaSetDevice(device);
  if (set != cudaSuccess) return (int)set;
  if (b * h * sq == 0) return (int)cudaGetLastError();
  if (skv <= 0 || kh <= 0 || h % kh != 0) return (int)cudaErrorInvalidValue;
  const cudaStream_t st = (cudaStream_t)stream;
  cudaError_t err;
  if (d == 64)
    err = bf16 ? run_tc<64>(q, k, v, o, b, sq, skv, h, kh, causal, st)
               : run_f32<64>(q, k, v, o, b, sq, skv, h, kh, causal, st);
  else if (d == 128)
    err = bf16 ? run_tc<128>(q, k, v, o, b, sq, skv, h, kh, causal, st)
               : run_f32<128>(q, k, v, o, b, sq, skv, h, kh, causal, st);
  else
    err = cudaErrorInvalidValue;
  return (int)err;
}

// dynamic shared memory the bf16 kernel asks for at head dim d
extern "C" int flash_attention_tc_smem(int d) {
  return d == 64 ? TcLayout<64>::kAlloc
                 : d == 128 ? TcLayout<128>::kAlloc : 0;
}

// dynamic shared memory the f32 kernel asks for at head dim d
extern "C" int flash_attention_f32_smem(int d) {
  return d == 64 ? F32Layout<64>::kAlloc
                 : d == 128 ? F32Layout<128>::kAlloc : 0;
}
