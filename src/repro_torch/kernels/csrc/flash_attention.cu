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
// (l == 0 -> 1), rounded to the output type to nearest even.
//
// Bound: operations (4 Sq Skv D H multiply-adds, halved by a causal mask,
// against about 2 (Sq + 2 Skv) D H bytes).  Design, simple first: one block
// of 256 threads per (b, h, 64-query tile), with the query tile and one
// 64-key tile of K and V staged in shared memory as f32 (K transposed, the
// probabilities reuse K's space), and every product a scalar f32 FMA: each
// thread owns a 4 x 4 block of scores and 4 rows x D/16 columns of the
// accumulator, read as 16-byte vectors from shared memory.  Row max and
// sum are shuffles across the 16 threads of a row.  Key tiles wholly above
// the causal diagonal are skipped, which leaves the result unchanged
// (exp(-1e30 - m) is exactly 0 and exp(m - m) exactly 1), except for a
// query tile with a fully masked row, which visits every key.  Keys at or
// past Skv score -inf and add nothing.  Query tiles run heaviest first.
// Tensor cores (mma.sync / wgmma) and TMA are left for a later version.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

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
__device__ __forceinline__ float to_f(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
__device__ __forceinline__ void put(float* p, float x) { *p = x; }
__device__ __forceinline__ void put(__nv_bfloat16* p, float x) {
  *p = __float2bfloat16_rn(x);
}

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
    err = bf16 ? run<__nv_bfloat16, 64>(q, k, v, o, b, sq, skv, h, kh, causal,
                                        st)
               : run<float, 64>(q, k, v, o, b, sq, skv, h, kh, causal, st);
  else if (d == 128)
    err = bf16 ? run<__nv_bfloat16, 128>(q, k, v, o, b, sq, skv, h, kh,
                                         causal, st)
               : run<float, 128>(q, k, v, o, b, sq, skv, h, kh, causal, st);
  else
    err = cudaErrorInvalidValue;
  return (int)err;
}
