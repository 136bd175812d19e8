// All-pairs XASH superkey containment for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel src/repro/kernels/superkey_filter/kernel.py:
// superkey_filter (body _sk_kernel), reached through ops.filter_rows:
// out[t, n] = (sk_lo[n] & q_lo[t]) == q_lo[t] && (same on the hi half),
// written as 0/1 bytes into a fresh contiguous torch.bool [T, N] tensor.
//
// Bound: bytes.  The T N output bytes are the traffic (8 N + 8 T bytes of
// input beside them), so the kernel is built around the store path:
//
// * Whole sectors of the flattened byte array.  Output row t starts at byte
//   t N, which for an odd N lies anywhere in a 32-byte sector.  The kernel
//   cuts the [T N] array into the 32-byte-aligned sectors of the array
//   itself; every sector that lies inside one row is written whole by two
//   neighbouring lanes of one warp instruction, as two aligned 16-byte
//   streaming stores (st.global.cs: the 245 MB output of the main input
//   passes through the 50 MB L2 once), so no sector is ever written in
//   part by two warps, which would cost the memory a read of the sector.
//   Only the sectors that cross a row boundary (T - 1 at most) and the
//   array's own partial ends are assembled byte by byte, by a "seam" pass
//   of one thread per sector.
// * Warp tiles, realigned in registers.  A warp owns 512 neighbouring rows
//   n, 16 per lane, and keeps their complemented digests in 32 registers
//   for every query it takes (no shared memory, no block barrier).  For
//   query t the sectors of output row t start at a shift e (0..31 bytes)
//   from the warp's first row, and e depends only on t mod 32.  So a warp
//   takes its queries class by class (t = c, c + 32, ...), and for each
//   class runs a loop compiled for that class's shift: each lane computes
//   its 16 bools, takes those of the lanes e / 16 and e / 16 + 1 places up
//   with __shfl_down_sync, and funnel-shifts the pair by e mod 16, with no
//   branch or index arithmetic per query.  Lanes 0..29 store 15 sectors;
//   lanes 30 and 31 only lend their bools, so a warp covers 480 rows n and
//   neighbouring warp tiles overlap by 32 rows of digests.
// * No barriers, no waves to balance.  The grid is one warp per tile
//   (ceil(N / 480) warps, 8 to a block), each warp taking every query for
//   its tile in class order, so at any moment the warps write neighbouring
//   sectors of the same few output rows.  At the main input (N = 958,623)
//   that is 1,998 warps in 250 blocks, fewer than an H100 holds at once
//   (two blocks on each of its 132 SMs at the 103 registers nvcc 12.9
//   gives), so there is no partial second wave.
//
// Per thread: 32 registers of digests and 12 of bools; no shared memory.
// 256 threads a block, registers left to the compiler (capping them at 64
// spilled and ran slower).  Ragged N, T, unaligned digest pointers (scalar
// loads), an unaligned output and tiny outputs are masked here; nothing is
// padded.
#include <cuda_runtime.h>
#include <stdint.h>

#include "superkey.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kTileRows = 30 * 16;       // rows n a warp tile writes

__device__ __forceinline__ void store_cs(uint8_t* p, uint4 v) {
  asm volatile("st.global.cs.v4.u32 [%0], {%1, %2, %3, %4};\n" ::"l"(p),
               "r"(v.x), "r"(v.y), "r"(v.z), "r"(v.w)
               : "memory");
}

__device__ __forceinline__ uint4 shfl_down(uint4 v, int by) {
  return make_uint4(__shfl_down_sync(0xffffffffu, v.x, by),
                    __shfl_down_sync(0xffffffffu, v.y, by),
                    __shfl_down_sync(0xffffffffu, v.z, by),
                    __shfl_down_sync(0xffffffffu, v.w, by));
}

// One warp tile against `count` queries of one class (t = c, c + 32, ...;
// every query of a class puts its row's sectors at the same shift e from
// the tile's first row).  D = e / 16 and S = (e mod 16) / 4 fix which lanes
// and words a lane's 16 bytes come from; sh = 8 (e mod 4) is the funnel
// shift.  The queries' digests are read at ql, qh with stride 32; dst is
// the lane's 16-byte slot of the first query's row, `step` bytes apart.
template <bool D, int S>
__device__ __forceinline__ void segment(const uint32_t (&nlo)[16],
                                        const uint32_t (&nhi)[16],
                                        const uint32_t* __restrict__ ql,
                                        const uint32_t* __restrict__ qh,
                                        uint8_t* dst, int64_t step, int count,
                                        uint32_t sh, bool write) {
  for (int i = 0; i < count; ++i) {
    uint32_t w[4];
    superkey::contains<16>(nlo, nhi, __ldg(ql), __ldg(qh), w);
    const uint4 own = make_uint4(w[0], w[1], w[2], w[3]);
    const uint4 a = D ? shfl_down(own, 1) : own;
    const uint4 b = shfl_down(a, 1);
    const uint32_t v[8] = {a.x, a.y, a.z, a.w, b.x, b.y, b.z, b.w};
    if (write)
      store_cs(dst, make_uint4(__funnelshift_r(v[S], v[S + 1], sh),
                               __funnelshift_r(v[S + 1], v[S + 2], sh),
                               __funnelshift_r(v[S + 2], v[S + 3], sh),
                               __funnelshift_r(v[S + 3], v[S + 4], sh)));
    dst += step;
    ql += 32;
    qh += 32;
  }
}

// the output byte of query t and row n
__device__ __forceinline__ uint32_t one(const uint32_t* __restrict__ sk_lo,
                                        const uint32_t* __restrict__ sk_hi,
                                        const uint32_t* __restrict__ q_lo,
                                        const uint32_t* __restrict__ q_hi,
                                        int64_t t, int64_t n) {
  return superkey::missing(~__ldg(sk_lo + n), ~__ldg(sk_hi + n),
                           __ldg(q_lo + t), __ldg(q_hi + t)) == 0u;
}

// The seam pass: the bytes the warp tiles do not write.  Item 0 is the head
// (bytes before the first 32-byte-aligned sector), item T the tail (bytes
// after the last whole sector), item s in 1..T-1 the sector holding the
// first byte of row s, where that byte does not start the sector; a sector
// that holds several row starts (N < 32) is taken by the first of them that
// does not start it.
__device__ void seam(const uint32_t* __restrict__ sk_lo,
                     const uint32_t* __restrict__ sk_hi,
                     const uint32_t* __restrict__ q_lo,
                     const uint32_t* __restrict__ q_hi,
                     uint8_t* __restrict__ out, int64_t t_rows, int64_t n,
                     int64_t head, int64_t sectors, int64_t s) {
  int64_t lo, hi;                            // byte range [lo, hi)
  if (s == 0) {
    lo = 0; hi = head;
  } else if (s == t_rows) {
    lo = head + 32 * sectors; hi = t_rows * n;
  } else {
    const int64_t p = s * n - head;          // row s's start past the head
    if (p < 0 || p % 32 == 0 || p / 32 >= sectors) return;
    const int64_t prev = p - n;              // row s - 1's start
    if (s >= 2 && prev >= 0 && prev / 32 == p / 32 && prev % 32 != 0) return;
    lo = head + 32 * (p / 32); hi = lo + 32;
  }
  if (lo >= hi) return;
  int64_t t = lo / n, c = lo - t * n;
  if (hi - lo == 32) {                       // a whole aligned sector
    uint32_t w[8] = {0u, 0u, 0u, 0u, 0u, 0u, 0u, 0u};
    for (int b = 0; b < 32; ++b) {
      w[b >> 2] |= one(sk_lo, sk_hi, q_lo, q_hi, t, c) << (8 * (b & 3));
      if (++c == n) { c = 0; ++t; }
    }
    store_cs(out + lo, make_uint4(w[0], w[1], w[2], w[3]));
    store_cs(out + lo + 16, make_uint4(w[4], w[5], w[6], w[7]));
    return;
  }
  for (int64_t p = lo; p < hi; ++p) {
    out[p] = (uint8_t)one(sk_lo, sk_hi, q_lo, q_hi, t, c);
    if (++c == n) { c = 0; ++t; }
  }
}

__global__ void __launch_bounds__(kThreads)
superkey_filter_kernel(const uint32_t* __restrict__ sk_lo,
                       const uint32_t* __restrict__ sk_hi,
                       const uint32_t* __restrict__ q_lo,
                       const uint32_t* __restrict__ q_hi,
                       uint8_t* __restrict__ out, int64_t t_rows, int64_t n,
                       bool vec_loads) {
  const int lane = threadIdx.x & 31;
  const int64_t warp = (int64_t)blockIdx.x * kWarps + (threadIdx.x >> 5);
  const int64_t warps = (int64_t)gridDim.x * kWarps;
  // bytes before the first 32-byte-aligned address of the output
  const int64_t head = min((int64_t)((32 - ((uintptr_t)out & 31)) & 31),
                           t_rows * n);
  const int64_t sectors = (t_rows * n - head) / 32;

  for (int64_t s = warp * 32 + lane; s <= t_rows; s += warps * 32)
    seam(sk_lo, sk_hi, q_lo, q_hi, out, t_rows, n, head, sectors, s);

  // class c holds the queries t = c, c + 32, ...; the first `rem` classes
  // one query more
  const int64_t tiles = (n + kTileRows - 1) / kTileRows;
  const int t32 = (int)t_rows;     // the entry point refuses T >= 2^31
  const int per = t32 / 32, rem = t32 % 32;
  for (int64_t tile = warp; tile < tiles; tile += warps) {
    const int64_t n_w = tile * kTileRows;
    uint32_t nlo[16], nhi[16];
    superkey::load<16>(sk_lo, sk_hi, n_w + 16 * lane, n, vec_loads, nlo,
                       nhi);
    for (int c = 0; c < 32 && c < t32; ++c) {
      const int count = per + (c < rem);
      // row c's sectors start at n_w + e, n_w + e + 32, ... (the flat
      // position is head mod 32); lane l writes half l % 2 of sector l / 2
      const uint32_t e = (uint32_t)(head - c * n - n_w) & 31u;
      const bool write = lane < 30 && n_w + e + 32 * (lane >> 1) + 32 <= n;
      uint8_t* dst = out + c * n + n_w + e + 16 * lane;
      const uint32_t sh = 8u * (e & 3u);
      const uint32_t* ql = q_lo + c;
      const uint32_t* qh = q_hi + c;
      const int64_t step = 32 * n;
#define SEGMENT(D, S) \
  segment<D, S>(nlo, nhi, ql, qh, dst, step, count, sh, write)
      switch (e >> 2) {
        case 0: SEGMENT(false, 0); break;
        case 1: SEGMENT(false, 1); break;
        case 2: SEGMENT(false, 2); break;
        case 3: SEGMENT(false, 3); break;
        case 4: SEGMENT(true, 0); break;
        case 5: SEGMENT(true, 1); break;
        case 6: SEGMENT(true, 2); break;
        default: SEGMENT(true, 3); break;
      }
#undef SEGMENT
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
  if (t >= INT32_MAX) return (int)cudaErrorInvalidValue;
  if (t > 0 && n > 0) {
    // one warp a tile; at least enough threads for the seam pass's T + 1
    // items in one sweep
    const int64_t tiles = (n + kTileRows - 1) / kTileRows;
    const int64_t warps = tiles > (t + 32) / 32 ? tiles : (t + 32) / 32;
    const bool vec = (((uintptr_t)sk_lo | (uintptr_t)sk_hi) & 15) == 0;
    superkey_filter_kernel<<<(unsigned)((warps + kWarps - 1) / kWarps),
                             kThreads, 0, (cudaStream_t)stream>>>(
        (const uint32_t*)sk_lo, (const uint32_t*)sk_hi,
        (const uint32_t*)q_lo, (const uint32_t*)q_hi, (uint8_t*)out, t, n,
        vec);
  }
  return (int)cudaGetLastError();
}
