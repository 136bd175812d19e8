// The XASH containment test shared by superkey_filter.cu and
// superkey_filter_rows.cu: a row digest (lo, hi) contains a query digest
// (ql, qh) when (lo & ql) == ql and (hi & qh) == qh.  Both kernels keep the
// row digests complemented (nlo = ~lo, nhi = ~hi), so the test is two
// three-input logic operations, (ql & nlo) | (qh & nhi), whose second one
// also sets the predicate "some bit missing"; the bool then costs one
// predicated OR into its byte of the packed word.
#pragma once
#include <stdint.h>

namespace superkey {

// the query bits the row lacks: zero iff the row contains the query
__device__ __forceinline__ uint32_t missing(uint32_t nlo, uint32_t nhi,
                                           uint32_t ql, uint32_t qh) {
  return (ql & nlo) | (qh & nhi);
}

// K containment bools (0/1 bytes, byte j of the K / 4 words for row j) of
// one query against K complemented row digests
template <int K>
__device__ __forceinline__ void contains(const uint32_t (&nlo)[K],
                                         const uint32_t (&nhi)[K],
                                         uint32_t ql, uint32_t qh,
                                         uint32_t (&w)[K / 4]) {
#pragma unroll
  for (int v = 0; v < K / 4; ++v) {
    w[v] = 0u;
#pragma unroll
    for (int j = 0; j < 4; ++j)   // a predicated OR: no select, no merge
      if (missing(nlo[4 * v + j], nhi[4 * v + j], ql, qh) == 0u)
        w[v] |= 1u << (8 * j);
  }
}

// complemented digests of rows [n0, n0 + K); rows at or past n read as
// digests of all ones (complement 0), which contain every query.  16-byte
// vector loads when the K rows are whole and the pointers 16-byte aligned
// (n0 is then a multiple of 4).
template <int K>
__device__ __forceinline__ void load(const uint32_t* __restrict__ lo,
                                     const uint32_t* __restrict__ hi,
                                     int64_t n0, int64_t n, bool vec,
                                     uint32_t (&nlo)[K], uint32_t (&nhi)[K]) {
  if (vec && n0 + K <= n) {
    const uint4* l4 = reinterpret_cast<const uint4*>(lo + n0);
    const uint4* h4 = reinterpret_cast<const uint4*>(hi + n0);
#pragma unroll
    for (int v = 0; v < K / 4; ++v) {
      const uint4 a = __ldg(l4 + v), b = __ldg(h4 + v);
      nlo[4 * v] = ~a.x; nlo[4 * v + 1] = ~a.y; nlo[4 * v + 2] = ~a.z;
      nlo[4 * v + 3] = ~a.w;
      nhi[4 * v] = ~b.x; nhi[4 * v + 1] = ~b.y; nhi[4 * v + 2] = ~b.z;
      nhi[4 * v + 3] = ~b.w;
    }
  } else {
#pragma unroll
    for (int j = 0; j < K; ++j) {
      const bool in = n0 + j < n;
      nlo[j] = in ? ~__ldg(lo + n0 + j) : 0u;
      nhi[j] = in ? ~__ldg(hi + n0 + j) : 0u;
    }
  }
}

}  // namespace superkey
