// Rowwise XASH superkey containment for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel src/repro/kernels/superkey_filter/kernel.py:
// superkey_filter_rows (body _sk_rows_kernel), the MC seeker's bloom prune:
// out[t, m] = (sk_lo[t, m] & q_lo[t]) == q_lo[t] && (same on the hi half),
// written as 0/1 bytes into a fresh contiguous torch.bool [T, M] tensor.
//
// Bound: bytes (8 read and 1 written per element).  At the MC stage's
// shapes ([256, 128] to [256, 1024], 0.3 to 2.4 MB) a launch's fixed cost
// and one round trip to device memory bound it, not bandwidth, so the
// design cuts that round trip and the instructions around it: each thread
// takes 4 neighbouring elements of the flattened [T M] array, requests its
// row's query digests first (their address waits on a division, the row
// digests' does not), then reads the 4 row digests of each half with one
// 16-byte load, tests them against the query held in registers, and
// writes its 4 bools with one 4-byte store.  A group that crosses a row end (M not a multiple of 4) takes
// each element's own query; unaligned pointers and the array's ragged end
// fall back to scalar loads and byte stores.  4 elements a thread timed
// faster than 16 at both shapes and than 8 at [256, 128].  The output is
// stored normally (not streaming): the MC stage reads the mask next, and
// it fits in L2.
#include <cuda_runtime.h>
#include <stdint.h>

#include "superkey.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kPer = 4;                  // elements a thread

__global__ void __launch_bounds__(kThreads)
superkey_filter_rows_kernel(const uint32_t* __restrict__ sk_lo,
                            const uint32_t* __restrict__ sk_hi,
                            const uint32_t* __restrict__ q_lo,
                            const uint32_t* __restrict__ q_hi,
                            uint8_t* __restrict__ out, int64_t total,
                            int64_t m, bool vec_loads, bool vec_store) {
  const int64_t i0 = ((int64_t)blockIdx.x * kThreads + threadIdx.x) * kPer;
  if (i0 >= total) return;
  const int64_t t0 = i0 / m, m0 = i0 - t0 * m;
  const uint32_t ql0 = __ldg(q_lo + t0), qh0 = __ldg(q_hi + t0);
  uint32_t nlo[kPer], nhi[kPer], w[1];
  superkey::load<kPer>(sk_lo, sk_hi, i0, total, vec_loads, nlo, nhi);
  if (m0 + kPer <= m) {                  // the whole group in row t0
    superkey::contains<kPer>(nlo, nhi, ql0, qh0, w);
  } else {                               // a row end inside the group
    int64_t t = t0, c = m0;
    w[0] = 0u;
#pragma unroll
    for (int j = 0; j < kPer; ++j) {
      if (i0 + j < total &&
          superkey::missing(nlo[j], nhi[j], __ldg(q_lo + t),
                            __ldg(q_hi + t)) == 0u)
        w[0] |= 1u << (8 * j);
      if (++c == m) { c = 0; ++t; }
    }
  }
  if (vec_store && i0 + kPer <= total) {
    *reinterpret_cast<uint32_t*>(out + i0) = w[0];
  } else {
#pragma unroll
    for (int j = 0; j < kPer; ++j)
      if (i0 + j < total) out[i0 + j] = (uint8_t)(w[0] >> (8 * j));
  }
}

}  // namespace

extern "C" int superkey_filter_rows(const void* sk_lo, const void* sk_hi,
                                    const void* q_lo, const void* q_hi,
                                    void* out, int64_t t, int64_t m,
                                    int device, void* stream) {
  const cudaError_t set = cudaSetDevice(device);
  if (set != cudaSuccess) return (int)set;
  const int64_t total = t * m;
  if (total > 0) {
    const int64_t threads = (total + kPer - 1) / kPer;
    const bool vec_loads = (((uintptr_t)sk_lo | (uintptr_t)sk_hi) & 15) == 0;
    const bool vec_store = ((uintptr_t)out & (kPer - 1)) == 0;
    superkey_filter_rows_kernel<<<(unsigned)((threads + kThreads - 1) /
                                             kThreads),
                                  kThreads, 0, (cudaStream_t)stream>>>(
        (const uint32_t*)sk_lo, (const uint32_t*)sk_hi,
        (const uint32_t*)q_lo, (const uint32_t*)q_hi, (uint8_t*)out, total,
        m, vec_loads, vec_store);
  }
  return (int)cudaGetLastError();
}
