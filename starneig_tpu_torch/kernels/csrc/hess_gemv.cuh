// B1's wide-row A x form, shared by B1 (hess_gemv.cu) and H1 (hess_panel.cu).
//
// One warp takes one row of a row-major view: lane l the column pairs
// 2l + 64q (q < kLoads) of each 2 x 32 x kLoads-column stretch, all kLoads
// 16-byte loads in flight before any is summed; accumulator q sums its
// pairs in stretch order, then the accumulators fold in halves and the
// lanes by an xor shuffle.  The order is fixed by the row length alone, so
// every lane ends with the same bits on every launch.  How a row and x
// are read is the caller's: B1 streams M (__ldcs, read once a call) and
// reads x through the read-only path; H1 reads a row in stretches
// (streamed, or held in shared memory) into the same accumulators, and x
// from shared memory or, where it is not staged there, from L2.
#pragma once

#include <cuda_runtime.h>

namespace gemv_row {

constexpr int kLoads = 4;  // 16-byte loads in flight a lane

// loaders of M's entries: a pair (16-byte aligned where kVec) and one
struct StreamM {  // read once: evict first
  template <bool kVec>
  __device__ __forceinline__ double2 pair(const double* p) const {
    if (kVec) return __ldcs(reinterpret_cast<const double2*>(p));
    return make_double2(__ldcs(p), __ldcs(p + 1));
  }
  __device__ __forceinline__ double one(const double* p) const { return __ldcs(p); }
};

// a loader of M or x in shared memory (H1), 16-byte aligned pairs
struct Shared {
  template <bool kVec>
  __device__ __forceinline__ double2 pair(const double* p) const {
    return *reinterpret_cast<const double2*>(p);
  }
  __device__ __forceinline__ double one(const double* p) const { return *p; }
};

// loaders of x: the read-only path (B1)
struct ReadOnlyX {
  template <bool kVec>
  __device__ __forceinline__ double2 pair(const double* p) const {
    if (kVec) return __ldg(reinterpret_cast<const double2*>(p));
    return make_double2(__ldg(p), __ldg(p + 1));
  }
  __device__ __forceinline__ double one(const double* p) const { return __ldg(p); }
};

template <bool kVec>
__device__ __forceinline__ double2 load_m(const double* p) {
  return StreamM().pair<kVec>(p);
}

template <bool kVec>
__device__ __forceinline__ double2 load_x(const double* p) {
  return ReadOnlyX().pair<kVec>(p);
}

// acc[q] += the stretch's pairs of m[c] x[c], c < cols, in every lane of
// the calling warp; kVec needs m and x 16-byte aligned
template <bool kVec, class LM, class LX>
__device__ __forceinline__ void row_dot_acc(double (&acc)[kLoads], const double* __restrict__ m,
                                            const double* __restrict__ x, int cols, int lane,
                                            const LM& lm, const LX& lx) {
  for (int c0 = 2 * lane; c0 < cols; c0 += 64 * kLoads) {
    double2 a[kLoads], b[kLoads];
#pragma unroll
    for (int q = 0; q < kLoads; ++q) {
      const int c = c0 + 64 * q;
      a[q] = make_double2(0.0, 0.0);
      b[q] = make_double2(0.0, 0.0);
      if (c + 1 < cols) {
        a[q] = lm.template pair<kVec>(m + c);
        b[q] = lx.template pair<kVec>(x + c);
      } else if (c < cols) {
        a[q].x = lm.one(m + c);
        b[q].x = lx.one(x + c);
      }
    }
#pragma unroll
    for (int q = 0; q < kLoads; ++q) acc[q] += a[q].x * b[q].x + a[q].y * b[q].y;
  }
}

// the accumulators folded in halves, then the lanes: every lane's sum
__device__ __forceinline__ double fold(double (&acc)[kLoads]) {
#pragma unroll
  for (int w = kLoads / 2; w > 0; w >>= 1)
#pragma unroll
    for (int q = 0; q < w; ++q) acc[q] += acc[q + w];
  double sum = acc[0];
  for (int off = 16; off > 0; off >>= 1) sum += __shfl_xor_sync(0xffffffffu, sum, off);
  return sum;
}

// sum over c < cols of m[c] x[c] (M streamed, x read-only), in every lane
// of the calling warp; kVec needs m and x 16-byte aligned
template <bool kVec>
__device__ __forceinline__ double warp_row_dot(const double* __restrict__ m,
                                               const double* __restrict__ x, int cols,
                                               int lane) {
  double acc[kLoads];
#pragma unroll
  for (int q = 0; q < kLoads; ++q) acc[q] = 0.0;
  row_dot_acc<kVec>(acc, m, x, cols, lane, StreamM(), ReadOnlyX());
  return fold(acc);
}

}  // namespace gemv_row
