// Rowwise XASH superkey containment for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel src/repro/kernels/superkey_filter/kernel.py:
// superkey_filter_rows (body _sk_rows_kernel), the MC seeker's bloom prune:
// out[t, m] = (sk_lo[t, m] & q_lo[t]) == q_lo[t] && (same on the hi half),
// written as 0/1 bytes into a torch.bool tensor.
//
// Bound: bytes (8 read and 1 written per element, two ANDs and compares).
// Design: one thread per (t, m) element, neighbouring threads on
// neighbouring elements so loads and stores coalesce; the per-row query
// digest is a broadcast read that stays in L1.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;

__global__ void superkey_filter_rows_kernel(const uint32_t* __restrict__ sk_lo,
                                            const uint32_t* __restrict__ sk_hi,
                                            const uint32_t* __restrict__ q_lo,
                                            const uint32_t* __restrict__ q_hi,
                                            uint8_t* __restrict__ out,
                                            int64_t n, int64_t m) {
  const int64_t i = (int64_t)blockIdx.x * kThreads + threadIdx.x;
  if (i >= n) return;
  const int64_t t = i / m;
  const uint32_t ql = __ldg(q_lo + t);
  const uint32_t qh = __ldg(q_hi + t);
  out[i] = ((__ldg(sk_lo + i) & ql) == ql) && ((__ldg(sk_hi + i) & qh) == qh);
}

}  // namespace

extern "C" int superkey_filter_rows(const void* sk_lo, const void* sk_hi,
                                    const void* q_lo, const void* q_hi,
                                    void* out, int64_t t, int64_t m,
                                    int device, void* stream) {
  const cudaError_t set = cudaSetDevice(device);
  if (set != cudaSuccess) return (int)set;
  const int64_t n = t * m;
  if (n > 0) {
    const int64_t blocks = (n + kThreads - 1) / kThreads;
    superkey_filter_rows_kernel<<<(unsigned)blocks, kThreads, 0,
                                  (cudaStream_t)stream>>>(
        (const uint32_t*)sk_lo, (const uint32_t*)sk_hi, (const uint32_t*)q_lo,
        (const uint32_t*)q_hi, (uint8_t*)out, n, m);
  }
  return (int)cudaGetLastError();
}
