// QCR scoring epilogue over segment sums for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel src/repro/kernels/qcr_score/kernel.py:
// qcr_segments (body _qcr_seg_kernel), the correlation seeker's scoring
// stage: out[d] = |2 a[d] - n[d]| / max(n[d], 1), and 0 where
// n[d] < min_support.
//
// Bound: bytes (8 read and 4 written per element, five flops).  Design: one
// thread per element.  The division is IEEE div.rn.f32 (the library is built
// without --use_fast_math), so scores equal the reference's bit for bit;
// 2a - n is exact for the integer-valued counts, fused or not.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;

__global__ void qcr_segments_kernel(const float* __restrict__ n_agree,
                                    const float* __restrict__ n_all,
                                    float* __restrict__ out, int64_t d,
                                    float min_support) {
  const int64_t i = (int64_t)blockIdx.x * kThreads + threadIdx.x;
  if (i >= d) return;
  const float a = __ldg(n_agree + i);
  const float n = __ldg(n_all + i);
  const float qcr = fabsf(2.0f * a - n) / fmaxf(n, 1.0f);
  out[i] = n >= min_support ? qcr : 0.0f;
}

}  // namespace

extern "C" int qcr_segments(const void* n_agree, const void* n_all,
                            void* out, int64_t d, float min_support,
                            int device, void* stream) {
  const cudaError_t set = cudaSetDevice(device);
  if (set != cudaSuccess) return (int)set;
  if (d > 0) {
    const int64_t blocks = (d + kThreads - 1) / kThreads;
    qcr_segments_kernel<<<(unsigned)blocks, kThreads, 0,
                          (cudaStream_t)stream>>>(
        (const float*)n_agree, (const float*)n_all, (float*)out, d,
        min_support);
  }
  return (int)cudaGetLastError();
}
