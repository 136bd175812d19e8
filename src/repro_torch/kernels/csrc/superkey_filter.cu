// All-pairs XASH superkey containment for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel src/repro/kernels/superkey_filter/kernel.py:
// superkey_filter (body _sk_kernel), reached through ops.filter_rows:
// out[t, n] = (sk_lo[n] & q_lo[t]) == q_lo[t] && (same on the hi half),
// written as 0/1 bytes into a torch.bool [T, N] tensor.
//
// Bound: bytes.  The T N output bytes dominate; the inputs are 8 N + 8 T
// bytes.  Design: a block owns a span of 2048 neighbouring rows n and up to
// 32 queries t.  Each thread loads its 16 row digests once (16-byte vectors
// where the pointers allow) and keeps them in registers for all its
// queries.  Per query it computes 16 bools, stages them in shared memory,
// and the block writes the span of that output row in aligned 16-byte
// vectors: an output row starts at byte t N, which is not 16-byte aligned
// when N is not a multiple of 16, so the stores are realigned with funnel
// shifts and only the two partial ends of the span go byte by byte.  The
// kernel masks its ragged edges itself; nothing is padded.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 128;
constexpr int kSpan = kThreads * 16;   // rows n of one block
constexpr int kTPerBlock = 32;         // queries t of one block

__device__ __forceinline__ uint32_t contained(uint32_t lo, uint32_t hi,
                                              uint32_t ql, uint32_t qh) {
  return ((lo & ql) == ql) && ((hi & qh) == qh);
}

__global__ void __launch_bounds__(kThreads)
superkey_filter_kernel(const uint32_t* __restrict__ sk_lo,
                       const uint32_t* __restrict__ sk_hi,
                       const uint32_t* __restrict__ q_lo,
                       const uint32_t* __restrict__ q_hi,
                       uint8_t* __restrict__ out, int64_t t, int64_t n,
                       bool vec_loads) {
  __shared__ uint4 stage4[kThreads + 1];   // one spare vector for the shifts
  const uint32_t* stage = reinterpret_cast<const uint32_t*>(stage4);
  const uint8_t* stage_bytes = reinterpret_cast<const uint8_t*>(stage4);

  const int64_t nb = (int64_t)blockIdx.x * kSpan;
  const int64_t n0 = nb + (int64_t)threadIdx.x * 16;
  const int span = (int)min((int64_t)kSpan, n - nb);

  uint32_t lo[16], hi[16];
  if (vec_loads && n0 + 16 <= n) {
    const uint4* l4 = reinterpret_cast<const uint4*>(sk_lo + n0);
    const uint4* h4 = reinterpret_cast<const uint4*>(sk_hi + n0);
#pragma unroll
    for (int v = 0; v < 4; ++v) {
      const uint4 a = __ldg(l4 + v), b = __ldg(h4 + v);
      lo[4 * v] = a.x; lo[4 * v + 1] = a.y; lo[4 * v + 2] = a.z;
      lo[4 * v + 3] = a.w;
      hi[4 * v] = b.x; hi[4 * v + 1] = b.y; hi[4 * v + 2] = b.z;
      hi[4 * v + 3] = b.w;
    }
  } else {
#pragma unroll
    for (int j = 0; j < 16; ++j) {
      const bool in = n0 + j < n;
      lo[j] = in ? __ldg(sk_lo + n0 + j) : 0u;
      hi[j] = in ? __ldg(sk_hi + n0 + j) : 0u;
    }
  }

  const int64_t t0 = (int64_t)blockIdx.y * kTPerBlock;
  const int64_t t1 = min(t, t0 + kTPerBlock);
  for (int64_t ti = t0; ti < t1; ++ti) {
    const uint32_t ql = __ldg(q_lo + ti), qh = __ldg(q_hi + ti);
    uint32_t w[4];
#pragma unroll
    for (int v = 0; v < 4; ++v) {
      w[v] = 0u;
#pragma unroll
      for (int b = 0; b < 4; ++b)
        w[v] |= contained(lo[4 * v + b], hi[4 * v + b], ql, qh) << (8 * b);
    }
    __syncthreads();                 // the previous query's span is written
    stage4[threadIdx.x] = make_uint4(w[0], w[1], w[2], w[3]);
    __syncthreads();

    uint8_t* g = out + ti * n + nb;  // this block's span of output row ti
    const int s = (int)((uintptr_t)g & 15);
    const int slots = (span + s + 15) / 16;
    for (int k = threadIdx.x; k < slots; k += kThreads) {
      const int first = 16 * k - s;  // span offset of the aligned slot
      if (first >= 0 && first + 16 <= span) {
        const int wi = first >> 2, sh = (first & 3) * 8;
        uint32_t x[5];
#pragma unroll
        for (int i = 0; i < 5; ++i) x[i] = stage[wi + i];
        uint4 o;
        o.x = __funnelshift_r(x[0], x[1], sh);
        o.y = __funnelshift_r(x[1], x[2], sh);
        o.z = __funnelshift_r(x[2], x[3], sh);
        o.w = __funnelshift_r(x[3], x[4], sh);
        *reinterpret_cast<uint4*>(g + first) = o;
      } else {
        for (int b = 0; b < 16; ++b) {
          const int p = first + b;
          if (p >= 0 && p < span) g[p] = stage_bytes[p];
        }
      }
    }
  }
}

}  // namespace

extern "C" int superkey_filter(const void* sk_lo, const void* sk_hi,
                               const void* q_lo, const void* q_hi, void* out,
                               int64_t t, int64_t n, int device,
                               void* stream) {
  const cudaError_t set = cudaSetDevice(device);
  if (set != cudaSuccess) return (int)set;
  if (t > 0 && n > 0) {
    const int64_t ty = (t + kTPerBlock - 1) / kTPerBlock;
    if (ty > 65535) return (int)cudaErrorInvalidConfiguration;
    const dim3 grid((unsigned)((n + kSpan - 1) / kSpan), (unsigned)ty);
    const bool vec = (((uintptr_t)sk_lo | (uintptr_t)sk_hi) & 15) == 0;
    superkey_filter_kernel<<<grid, kThreads, 0, (cudaStream_t)stream>>>(
        (const uint32_t*)sk_lo, (const uint32_t*)sk_hi,
        (const uint32_t*)q_lo, (const uint32_t*)q_hi, (uint8_t*)out, t, n,
        vec);
  }
  return (int)cudaGetLastError();
}
