// Padded radix-bucket hash probe for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel src/repro/kernels/bucket_probe/kernel.py:
// bucket_probe (body _probe_kernel).  For each query key q it reads bucket
// row (q as u32) >> (32 - bucket_bits) of the padded [2^bits, W] hash and
// payload tables and writes the [W] output row: the payload where the hash
// equals q, else -1.  Bucket pads carry payload -1, so a query equal to the
// MISSING sentinel never hits.
//
// Keys are the port's order-preserving int32 form (u32 ^ 0x80000000), so the
// original hash is key ^ 0x80000000 and equality is unchanged.
//
// Bound: bytes.  Each query reads 8 W bytes of bucket row and writes 4 W
// bytes; there is one compare per element.  Design: one warp per query, the
// lanes walk the row in 16-byte vectors (int4) so every load and store is
// coalesced; a scalar loop takes rows that are not 16-byte aligned.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kWarps = 8;   // queries per block

__device__ __forceinline__ int pick(int h, int p, int key) {
  return h == key ? p : -1;
}

__global__ void bucket_probe_kernel(const int* __restrict__ bh,
                                    const int* __restrict__ bp,
                                    const int* __restrict__ q,
                                    int* __restrict__ out, int64_t m,
                                    int64_t width, int shift, bool vec) {
  const int lane = threadIdx.x & 31;
  const int64_t i = (int64_t)blockIdx.x * kWarps + (threadIdx.x >> 5);
  if (i >= m) return;
  const int key = q[i];
  const int64_t row = (int64_t)(((uint32_t)key ^ 0x80000000u) >> shift);
  const int* hrow = bh + row * width;
  const int* prow = bp + row * width;
  int* orow = out + i * width;
  if (vec) {
    const int4* h4 = reinterpret_cast<const int4*>(hrow);
    const int4* p4 = reinterpret_cast<const int4*>(prow);
    int4* o4 = reinterpret_cast<int4*>(orow);
    for (int64_t j = lane; j < width / 4; j += 32) {
      const int4 h = __ldg(h4 + j);
      const int4 p = __ldg(p4 + j);
      o4[j] = make_int4(pick(h.x, p.x, key), pick(h.y, p.y, key),
                        pick(h.z, p.z, key), pick(h.w, p.w, key));
    }
  } else {
    for (int64_t j = lane; j < width; j += 32)
      orow[j] = pick(__ldg(hrow + j), __ldg(prow + j), key);
  }
}

bool aligned16(const void* p) {
  return (reinterpret_cast<uintptr_t>(p) & 15) == 0;
}

}  // namespace

extern "C" int bucket_probe(const void* bucket_hashes,
                            const void* bucket_payload, const void* queries,
                            void* out, int64_t m, int64_t width,
                            int bucket_bits, int device, void* stream) {
  const cudaError_t set = cudaSetDevice(device);
  if (set != cudaSuccess) return (int)set;
  if (m > 0 && width > 0) {
    const bool vec = width % 4 == 0 && aligned16(bucket_hashes) &&
                     aligned16(bucket_payload) && aligned16(out);
    const int64_t blocks = (m + kWarps - 1) / kWarps;
    bucket_probe_kernel<<<(unsigned)blocks, kWarps * 32, 0,
                          (cudaStream_t)stream>>>(
        (const int*)bucket_hashes, (const int*)bucket_payload,
        (const int*)queries, (int*)out, m, width, 32 - bucket_bits, vec);
  }
  return (int)cudaGetLastError();
}
