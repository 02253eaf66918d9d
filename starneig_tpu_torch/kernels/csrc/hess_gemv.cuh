// B1's wide-row A x form, shared by B1 (hess_gemv.cu) and H1 (hess_panel.cu).
//
// One warp takes one row of a row-major view: lane l the column pairs
// 2l + 64q (q < kLoads) of each 2 x 32 x kLoads-column stretch, all kLoads
// 16-byte loads in flight before any is summed; accumulator q sums its
// pairs in stretch order, then the accumulators fold in halves and the
// lanes by an xor shuffle.  The order is fixed by the row length alone, so
// every lane ends with the same bits on every launch.  M is read with the
// streaming hint (read once a call).  x goes through the read-only path
// in B1, where nothing writes it during the launch, and through L2
// (kCoherentX) in H1, whose blocks write the reflector x during the
// launch: the read-only cache may hold an earlier column's x.
#pragma once

#include <cuda_runtime.h>

namespace gemv_row {

constexpr int kLoads = 4;  // 16-byte loads in flight a lane

template <bool kVec>
__device__ __forceinline__ double2 load_m(const double* p) {
  if (kVec) return __ldcs(reinterpret_cast<const double2*>(p));
  return make_double2(__ldcs(p), __ldcs(p + 1));
}

template <bool kCoherentX>
__device__ __forceinline__ double load_x1(const double* p) {
  return kCoherentX ? __ldcg(p) : __ldg(p);
}

template <bool kVec, bool kCoherentX>
__device__ __forceinline__ double2 load_x(const double* p) {
  if (kVec)
    return kCoherentX ? __ldcg(reinterpret_cast<const double2*>(p))
                      : __ldg(reinterpret_cast<const double2*>(p));
  return make_double2(load_x1<kCoherentX>(p), load_x1<kCoherentX>(p + 1));
}

// sum over c < cols of m[c] x[c], in every lane of the calling warp; kVec
// needs m and x 16-byte aligned
template <bool kVec, bool kCoherentX>
__device__ __forceinline__ double warp_row_dot(const double* __restrict__ m,
                                               const double* __restrict__ x, int cols,
                                               int lane) {
  double acc[kLoads];
#pragma unroll
  for (int q = 0; q < kLoads; ++q) acc[q] = 0.0;
  for (int c0 = 2 * lane; c0 < cols; c0 += 64 * kLoads) {
    double2 a[kLoads], b[kLoads];
#pragma unroll
    for (int q = 0; q < kLoads; ++q) {
      const int c = c0 + 64 * q;
      a[q] = make_double2(0.0, 0.0);
      b[q] = make_double2(0.0, 0.0);
      if (c + 1 < cols) {
        a[q] = load_m<kVec>(m + c);
        b[q] = load_x<kVec, kCoherentX>(x + c);
      } else if (c < cols) {
        a[q].x = __ldcs(m + c);
        b[q].x = load_x1<kCoherentX>(x + c);
      }
    }
#pragma unroll
    for (int q = 0; q < kLoads; ++q) acc[q] += a[q].x * b[q].x + a[q].y * b[q].y;
  }
#pragma unroll
  for (int w = kLoads / 2; w > 0; w >>= 1)
#pragma unroll
    for (int q = 0; q < w; ++q) acc[q] += acc[q + w];
  double sum = acc[0];
  for (int off = 16; off > 0; off >>= 1) sum += __shfl_xor_sync(0xffffffffu, sum, off);
  return sum;
}

}  // namespace gemv_row
