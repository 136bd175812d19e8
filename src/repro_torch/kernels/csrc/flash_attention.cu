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
// f32: flash_attention_kernel, scalar.  Bound: the 67 TFLOP/s f32 rate
// outside the tensor cores (TF32 would not keep f32 precision).  One block
// of 256 threads per (b, h, 64-query tile), with the query tile and one
// 64-key tile of K and V staged in shared memory (K transposed, the
// probabilities reuse K's space), and every product a scalar FMA: each
// thread owns a 4 x 4 block of scores and 4 rows x D/16 columns of the
// accumulator, read as 16-byte vectors from shared memory.  Row max and
// sum are shuffles across the 16 threads of a row.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "hopper.cuh"

namespace {

constexpr int kBQ = 64;        // queries of a block
constexpr int kBK = 64;        // keys of a tile
constexpr int kThreads = 256;  // 16 x 16: ty picks 4 rows, tx 4 keys
constexpr int kPad = 4;        // keeps rows 16-byte aligned, spreads banks
constexpr float kMasked = -1e30f;

template <int D>
struct Smem {
  float qt[D][kBQ + kPad];     // query tile, transposed
  float kt[D][kBK + kPad];     // key tile, transposed; then probabilities
  float v[kBK][D];             // value tile
};

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ void put(float* p, float x) { *p = x; }

template <typename T, int D>
__global__ void __launch_bounds__(kThreads)
flash_attention_kernel(const T* __restrict__ q, const T* __restrict__ k,
                       const T* __restrict__ v, T* __restrict__ o,
                       int64_t sq, int64_t skv, int64_t h, int64_t kh,
                       int causal) {
  constexpr int kCols = D / 16;        // accumulator columns of a thread
  extern __shared__ float4 smem_raw[];
  Smem<D>& sm = *reinterpret_cast<Smem<D>*>(smem_raw);
  float (*pt)[kBQ + kPad] = sm.kt;     // probabilities [key][query]

  const int tid = threadIdx.x, tx = tid & 15, ty = tid >> 4;
  const int64_t bh = blockIdx.x;
  const int64_t b = bh / h, head = bh % h, kvh = head / (h / kh);
  const int64_t q0 = (int64_t)(gridDim.y - 1 - blockIdx.y) * kBQ;
  const int64_t off = skv - sq;
  const float scale = 1.0f / sqrtf((float)D);

  const int64_t q_step = h * D, kv_step = kh * D;
  const T* qb = q + (b * sq * h + head) * D;
  const T* kb = k + (b * skv * kh + kvh) * D;
  const T* vb = v + (b * skv * kh + kvh) * D;

  for (int i = tid; i < kBQ * D; i += kThreads) {
    const int r = i / D, d = i % D;
    sm.qt[d][r] = q0 + r < sq ? to_f(qb[(q0 + r) * q_step + d]) : 0.0f;
  }

  int64_t kv_end = skv;
  if (causal && q0 + off >= 0)   // every row of the tile sees key 0
    kv_end = min(skv, min(q0 + kBQ, sq) + off);

  float m[4], l[4], acc[4][kCols];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    m[i] = kMasked;
    l[i] = 0.0f;
#pragma unroll
    for (int c = 0; c < kCols; ++c) acc[i][c] = 0.0f;
  }

  for (int64_t j0 = 0; j0 < kv_end; j0 += kBK) {
    __syncthreads();                   // the previous tile is consumed
    for (int i = tid; i < kBK * D; i += kThreads) {
      const int c = i / D, d = i % D;
      const bool in = j0 + c < skv;
      sm.kt[d][c] = in ? to_f(kb[(j0 + c) * kv_step + d]) : 0.0f;
      sm.v[c][d] = in ? to_f(vb[(j0 + c) * kv_step + d]) : 0.0f;
    }
    __syncthreads();

    float s[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) s[i][j] = 0.0f;
#pragma unroll 8
    for (int d = 0; d < D; ++d) {
      const float4 a = *reinterpret_cast<const float4*>(&sm.qt[d][ty * 4]);
      const float4 c = *reinterpret_cast<const float4*>(&sm.kt[d][tx * 4]);
      const float av[4] = {a.x, a.y, a.z, a.w};
      const float cv[4] = {c.x, c.y, c.z, c.w};
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) s[i][j] = fmaf(av[i], cv[j], s[i][j]);
    }

    float corr[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int64_t qpos = q0 + ty * 4 + i;
      float mx = m[i];
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int64_t kpos = j0 + tx * 4 + j;
        float x = s[i][j] * scale;
        if (kpos >= skv) x = -INFINITY;
        else if (causal && qpos + off < kpos) x = kMasked;
        s[i][j] = x;
        mx = fmaxf(mx, x);
      }
#pragma unroll
      for (int w = 8; w > 0; w >>= 1)
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, w));
      float sum = 0.0f;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        s[i][j] = expf(s[i][j] - mx);
        sum += s[i][j];
      }
#pragma unroll
      for (int w = 8; w > 0; w >>= 1)
        sum += __shfl_xor_sync(0xffffffffu, sum, w);
      corr[i] = expf(m[i] - mx);
      l[i] = l[i] * corr[i] + sum;
      m[i] = mx;
    }

    __syncthreads();                   // every thread is done with kt
#pragma unroll
    for (int j = 0; j < 4; ++j)
      *reinterpret_cast<float4*>(&pt[tx * 4 + j][ty * 4]) =
          make_float4(s[0][j], s[1][j], s[2][j], s[3][j]);
    __syncthreads();

#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int c = 0; c < kCols; ++c) acc[i][c] *= corr[i];
#pragma unroll 4
    for (int c = 0; c < kBK; ++c) {
      const float4 a = *reinterpret_cast<const float4*>(&pt[c][ty * 4]);
      const float av[4] = {a.x, a.y, a.z, a.w};
#pragma unroll
      for (int g = 0; g < D / 64; ++g) {
        const float4 w = *reinterpret_cast<const float4*>(
            &sm.v[c][g * 64 + tx * 4]);
        const float wv[4] = {w.x, w.y, w.z, w.w};
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int j = 0; j < 4; ++j)
            acc[i][g * 4 + j] = fmaf(av[i], wv[j], acc[i][g * 4 + j]);
      }
    }
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int64_t r = q0 + ty * 4 + i;
    if (r >= sq) continue;
    const float li = l[i] == 0.0f ? 1.0f : l[i];
    T* row = o + ((b * sq + r) * h + head) * D;
#pragma unroll
    for (int g = 0; g < D / 64; ++g)
#pragma unroll
      for (int j = 0; j < 4; ++j)
        put(row + g * 64 + tx * 4 + j, acc[i][g * 4 + j] / li);
  }
}

template <typename T, int D>
cudaError_t run(const void* q, const void* k, const void* v, void* o,
                 int64_t b, int64_t sq, int64_t skv, int64_t h, int64_t kh,
                 int causal, cudaStream_t stream) {
  const auto kernel = flash_attention_kernel<T, D>;
  const int smem = (int)sizeof(Smem<D>);
  const cudaError_t attr = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (attr != cudaSuccess) return attr;
  const int64_t tiles = (sq + kBQ - 1) / kBQ;
  if (tiles > 65535 || b * h > INT32_MAX) return cudaErrorInvalidConfiguration;
  const dim3 grid((unsigned)(b * h), (unsigned)tiles);
  kernel<<<grid, kThreads, smem, stream>>>((const T*)q, (const T*)k,
                                           (const T*)v, (T*)o, sq, skv, h, kh,
                                           causal);
  return cudaGetLastError();
}

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

// a bf16 [B, seq, heads, D] tensor as the 4-D map (D, heads, seq, B),
// innermost first, cut into (64, 1, rows, 1) boxes swizzled by 128 bytes
bool tensor_map(CUtensorMap* map, const void* ptr, int64_t b, int64_t seq,
                int64_t heads, int d, int rows) {
  const EncodeTiled encode = encode_tiled();
  if (encode == nullptr) return false;
  const cuuint64_t dims[4] = {(cuuint64_t)d, (cuuint64_t)heads,
                              (cuuint64_t)seq, (cuuint64_t)b};
  const cuuint64_t strides[3] = {(cuuint64_t)d * 2, (cuuint64_t)(heads * d) * 2,
                                 (cuuint64_t)(seq * heads * d) * 2};
  const cuuint32_t box[4] = {(cuuint32_t)kBox, 1, (cuuint32_t)rows, 1};
  const cuuint32_t unit[4] = {1, 1, 1, 1};
  return encode(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4,
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
  if (!tensor_map(&qm, q, b, sq, h, D, kRows) ||
      !tensor_map(&km, k, b, skv, kh, D, kKeys) ||
      !tensor_map(&vm, v, b, skv, kh, D, kKeys) ||
      !tensor_map(&om, o, b, sq, h, D, kRows / 2))
    return cudaErrorInvalidValue;
  const dim3 grid((unsigned)(b * h), (unsigned)tiles);
  kernel<<<grid, kTcThreads, smem, stream>>>(qm, km, vm, om, (int)sq,
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
               : run<float, 64>(q, k, v, o, b, sq, skv, h, kh, causal, st);
  else if (d == 128)
    err = bf16 ? run_tc<128>(q, k, v, o, b, sq, skv, h, kh, causal, st)
               : run<float, 128>(q, k, v, o, b, sq, skv, h, kh, causal, st);
  else
    err = cudaErrorInvalidValue;
  return (int)err;
}

// dynamic shared memory the bf16 kernel asks for at head dim d
extern "C" int flash_attention_tc_smem(int d) {
  return d == 64 ? TcLayout<64>::kAlloc
                 : d == 128 ? TcLayout<128>::kAlloc : 0;
}
