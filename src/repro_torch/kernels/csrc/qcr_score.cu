// Grouped QCR correlation scores for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel src/repro/kernels/qcr_score/kernel.py:
// qcr_score (body _qcr_kernel), reached through ops.score.  For each group
// row g of the [G, H] int8 quadrant and query-bit arrays and the bool valid
// mask: n = sum(valid), a = sum(valid & quad == qbit), and
// out[g] = |2 a - n| / max(n, 1), or 0 where n < 3.
//
// Bound: bytes (3 H read and 4 written per group, a few integer operations
// per byte).  Design: one warp per group row.  Lanes read 16-byte vectors
// of the three arrays where every row is 16-byte aligned (H % 16 == 0 and
// aligned pointers), else one byte at a time; per-byte compares are SIMD
// (__vcmpeq4, __vcmpne4) and the counts are int32, summed across the warp
// by __reduce_add_sync.  The counts are exact integers, so converting them
// to f32 equals the reference's f32 sum of 0/1 values, and the epilogue
// keeps the reference's operation order with IEEE division (no fast math):
// the scores equal the plain version's bit for bit.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kWarps = 8;   // group rows per block

// bytes of 4 that are non-zero, as a count
__device__ __forceinline__ unsigned count_set(uint32_t mask) {
  return __popc(mask) >> 3;
}

template <bool kVec>
__global__ void __launch_bounds__(kWarps * 32)
qcr_score_kernel(const int8_t* __restrict__ quad,
                 const int8_t* __restrict__ qbit,
                 const uint8_t* __restrict__ valid, float* __restrict__ out,
                 int64_t g, int64_t h) {
  const int64_t row = (int64_t)blockIdx.x * kWarps + (threadIdx.x >> 5);
  const int lane = threadIdx.x & 31;
  if (row >= g) return;              // the whole warp leaves together
  const int64_t base = row * h;
  unsigned n = 0, a = 0;
  if (kVec) {
    const uint4* q4 = reinterpret_cast<const uint4*>(quad + base);
    const uint4* b4 = reinterpret_cast<const uint4*>(qbit + base);
    const uint4* v4 = reinterpret_cast<const uint4*>(valid + base);
    for (int64_t c = lane; c < h / 16; c += 32) {
      const uint4 x = __ldg(q4 + c), y = __ldg(b4 + c), v = __ldg(v4 + c);
      const uint32_t xs[4] = {x.x, x.y, x.z, x.w};
      const uint32_t ys[4] = {y.x, y.y, y.z, y.w};
      const uint32_t vs[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const uint32_t on = __vcmpne4(vs[i], 0u);
        n += count_set(on);
        a += count_set(on & __vcmpeq4(xs[i], ys[i]));
      }
    }
  } else {
    for (int64_t i = lane; i < h; i += 32) {
      const unsigned on = valid[base + i] != 0;
      n += on;
      a += on & (unsigned)(quad[base + i] == qbit[base + i]);
    }
  }
  n = __reduce_add_sync(0xffffffffu, n);
  a = __reduce_add_sync(0xffffffffu, a);
  if (lane == 0) {
    const float nf = (float)n, af = (float)a;
    const float qcr = fabsf(2.0f * af - nf) / fmaxf(nf, 1.0f);
    out[row] = nf >= 3.0f ? qcr : 0.0f;
  }
}

}  // namespace

extern "C" int qcr_score(const void* quad, const void* qbit,
                         const void* valid, void* out, int64_t g, int64_t h,
                         int device, void* stream) {
  const cudaError_t set = cudaSetDevice(device);
  if (set != cudaSuccess) return (int)set;
  if (g > 0) {
    const int64_t blocks = (g + kWarps - 1) / kWarps;
    const bool vec = h % 16 == 0 &&
        (((uintptr_t)quad | (uintptr_t)qbit | (uintptr_t)valid) & 15) == 0;
    const cudaStream_t st = (cudaStream_t)stream;
    if (vec)
      qcr_score_kernel<true><<<(unsigned)blocks, kWarps * 32, 0, st>>>(
          (const int8_t*)quad, (const int8_t*)qbit, (const uint8_t*)valid,
          (float*)out, g, h);
    else
      qcr_score_kernel<false><<<(unsigned)blocks, kWarps * 32, 0, st>>>(
          (const int8_t*)quad, (const int8_t*)qbit, (const uint8_t*)valid,
          (float*)out, g, h);
  }
  return (int)cudaGetLastError();
}
