// B1: strided fp64 GEMV for the Hessenberg panel loop.
//
// Replaces starneig_tpu/ops/pallas_hess.py:_matvec_kernel (pallas_call at
// :81, wrapper matvec_df), which computed u = M x at df32 precision over
// row blocks [row0, R).  Plain twin: ops/gpu_hess.py:gemv_plain (M @ x).
// It serves every matvec of ops/hessenberg.py:panel_factor, the panel
// loop that the distributed reduction (parallel/dm_hess.py) runs on every
// rank (the single-process reduction runs a panel as one H1 launch,
// hess_panel.cu): the panel matvec A[t0:, t0:] v against the frozen
// panel-start matrix, and the compact-WY correction products Y V[c],
// V^T a, V (T^T w), V^T v, U tcol and the two small T products.
//
// What bounds it on the H100: DRAM bandwidth for the panel matvec, launch
// latency for the rest.  At n = 4000 the frozen panel matrix is 128 MB,
// more than the 50 MB L2, so the panel matvec streams it from HBM once per
// column (2 flops per 8 bytes).  The products on the panel arrays read
// 4000 x j views (ld 288, j = 1..288: at most 9.2 MB, 2.75 us of HBM) or
// the small T[:j, :j], so one launch's fixed cost is most of their time.
// Design:
//   * trans = 0, u = M[:rows, :cols] x, one kernel in two regimes chosen
//     from cols alone.  Wide rows (cols > 64: the panel matvec, a DM rank's
//     column shard, the panel arrays from j = 65 on, T[:j, :j]): a warp a
//     row, each lane with kLoads 16-byte loads in flight (where the view's
//     start and ld and x allow them; 8-byte loads otherwise), one
//     accumulator each, M read with the streaming hint (evict first, so x
//     stays cached), four warps a block so that the card holds 64 warps an
//     SM in one wave.  The previous form (one 8-byte load a lane, one
//     accumulator) kept too few bytes in flight to stream the panel matrix
//     at the HBM rate, and left most lanes idle on the narrow views.
//     (That row form lives in hess_gemv.cuh: H1, hess_panel.cu, runs it
//     on the panel matvec inside its cooperative launch.)
//     Narrow rows (cols <= 64: the panel arrays' 4000 x j views for small
//     j, T[:j, :j]): G lanes across a row as in the transposed mode (G the
//     least power of two with 2G >= cols), the other lanes on the next
//     rows, a shuffle reduction over the G lanes, so every lane is busy at
//     j = 1, in small blocks that spread the rows over the SMs.  Each sum runs in an
//     order fixed by the shape alone (no atomics): bit-for-bit repeatable.
//   * trans = 1, u = M[:rows, :cols]^T x: one launch, no scratch from the
//     caller.  A block takes a fixed range of rows and a group of at most
//     64 columns; G lanes of a warp run across a row (G the least power of
//     two with 2G >= cols, at most 32; the other lanes take the next rows),
//     each lane loading its column pair with one 16-byte load where
//     alignment allows, 4 rows in flight.  The warp's row groups reduce by
//     shuffle, the warps in shared memory, the row blocks through a partial
//     buffer in device memory that the last row block of each column group
//     to finish (a ticket counter) sums in row-block order, with all its
//     loads in flight at once.  That tail is a fence, an atomic and one
//     round of L2 loads: a block that took all 288 columns left one block
//     to sum 288 x 96 partials, which cost more than the whole main phase
//     (PERF.md), so the columns are split into groups whose tails run in
//     parallel.  Every sum runs in an order set by the shapes alone, so the
//     result is bit-for-bit repeatable.  The partial buffer and the
//     counters are static device memory of this library: launches of the
//     transposed mode on one device run one at a time, as they do on the
//     port's one stream.
// M is any row-major view with unit column stride and leading dimension ld.
#include <cuda_runtime.h>

#include "hess_gemv.cuh"

namespace {

using gemv_row::load_m;

constexpr int kWarps = 8;
constexpr int kNarrowCols = 64;  // A x: rows of at most this many columns are narrow
constexpr int kRowWarps = 4;     // A x, wide rows: warps a block, a row each
constexpr int kNarrowWarps = 4;  // A x, narrow rows: warps a block

// the pair (p[0], p[1]): one 16-byte load when kVec, else two 8-byte ones;
// M with the streaming hint (read once a call), x through the read-only path
template <bool kVec>
__device__ __forceinline__ double2 load_x(const double* p) {
  return gemv_row::load_x<kVec>(p);
}

// u = M x for rows of more than kNarrowCols columns: warp w of the block
// takes row blockIdx.x kRowWarps + w (hess_gemv.cuh's warp_row_dot)
template <bool kVec>
__global__ void __launch_bounds__(kRowWarps * 32)
gemv_n_wide(const double* __restrict__ M, long long ld, int rows, int cols,
            const double* __restrict__ x, double* __restrict__ u) {
  const int lane = threadIdx.x & 31;
  const int row = blockIdx.x * kRowWarps + (threadIdx.x >> 5);
  if (row >= rows) return;
  const double sum = gemv_row::warp_row_dot<kVec>(M + (size_t)row * ld, x, cols, lane);
  if (lane == 0) u[row] = sum;
}

// u = M x for rows of at most kNarrowCols columns: G = 2^lg lanes across a
// row (lane p of the group the column pair 2p), the 32 / G groups of a warp
// on consecutive rows, then each row's sum over its G lanes.  Blocks of
// kNarrowWarps warps: a 4000 x 1 view then takes 32 blocks, each loading
// its scattered rows on its own SM (the first form's 4 blocks of 8 warps
// with 4 rows a lane were 0.5 us slower, PERF.md)
template <bool kVec>
__global__ void __launch_bounds__(kNarrowWarps * 32)
gemv_n_narrow(const double* __restrict__ M, long long ld, int rows, int cols,
              const double* __restrict__ x, double* __restrict__ u, int lg) {
  const int lane = threadIdx.x & 31;
  const int G = 1 << lg, p = lane & (G - 1), c = 2 * p;
  const int r = ((blockIdx.x * kNarrowWarps + (threadIdx.x >> 5)) << (5 - lg)) + (lane >> lg);
  const bool two = c + 1 < cols, one = c < cols;
  double2 xv = make_double2(0.0, 0.0), a = make_double2(0.0, 0.0);
  const double* m = M + (size_t)r * ld + c;
  if (r < rows && two) {
    a = load_m<kVec>(m);
    xv = load_x<kVec>(x + c);
  } else if (r < rows && one) {
    a.x = __ldcs(m);
    xv.x = __ldg(x + c);
  }
  double s = a.x * xv.x + a.y * xv.y;
  for (int off = G >> 1; off > 0; off >>= 1) s += __shfl_xor_sync(0xffffffffu, s, off);
  if (p == 0 && r < rows) u[r] = s;
}

constexpr int kRows = 4;            // rows a lane loads before it sums them
constexpr int kMinRowsT = 32;       // rows a block takes, at least
constexpr int kTargetBlocks = 264;  // two blocks an SM
constexpr int kMaxRowBlocks = 128;  // row blocks of a column group, at most
constexpr int kPerWarp = kMaxRowBlocks / kWarps;  // partials a tail lane sums
constexpr int kMaxGroups = 4096;    // column groups of 64: cols <= 262,144
constexpr int kPartialCap = 1 << 20;

__device__ double g_partial[kPartialCap];     // [row block][column]
__device__ unsigned int g_ticket[kMaxGroups];  // 0 between launches

// u = M^T x over the column group blockIdx.y (2G columns, one pair a lane)
// and the row block blockIdx.x (rpb rows); see the note at the top.
template <bool kVec>
__global__ void __launch_bounds__(kWarps * 32)
gemv_t_kernel(const double* __restrict__ M, long long ld, int rows, int cols,
              const double* __restrict__ x, double* __restrict__ u, int G,
              int rpb) {
  __shared__ double red[kWarps][64];
  __shared__ bool s_last;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int p = lane % G, sub = lane / G, per_warp = 32 / G;
  const int width = 2 * G, gc0 = blockIdx.y * width, c = gc0 + 2 * p;
  const int nbr = gridDim.x, rb = blockIdx.x;
  const int r0 = rb * rpb, r1 = min(rows, r0 + rpb);
  const int rstep = kWarps * per_warp;
  const bool two = c + 1 < cols, one = c < cols;
  double a0 = 0.0, a1 = 0.0;
  for (int r = r0 + warp * per_warp + sub; r < r1; r += kRows * rstep) {
    // kRows rows' loads in flight, then their sums in row order
    double2 v[kRows];
    double xr[kRows];
#pragma unroll
    for (int q = 0; q < kRows; ++q) {
      const int rq = r + q * rstep;
      const bool live = rq < r1;
      xr[q] = live ? x[rq] : 0.0;
      const double* m = M + (size_t)(live ? rq : r) * ld + c;
      v[q] = make_double2(0.0, 0.0);
      if (live && two) {
        if (kVec) {
          v[q] = *reinterpret_cast<const double2*>(m);
        } else {
          v[q].x = m[0];
          v[q].y = m[1];
        }
      } else if (live && one) {
        v[q].x = m[0];
      }
    }
#pragma unroll
    for (int q = 0; q < kRows; ++q) {
      a0 += v[q].x * xr[q];
      a1 += v[q].y * xr[q];
    }
  }
  // the warp's row groups (lanes that differ in the bits above G)
  for (int off = G; off < 32; off <<= 1) {
    a0 += __shfl_xor_sync(0xffffffffu, a0, off);
    a1 += __shfl_xor_sync(0xffffffffu, a1, off);
  }
  if (sub == 0) {
    red[warp][2 * p] = a0;
    red[warp][2 * p + 1] = a1;
  }
  __syncthreads();
  for (int t = threadIdx.x; t < width && gc0 + t < cols; t += blockDim.x) {
    double v = red[0][t];
#pragma unroll
    for (int w = 1; w < kWarps; ++w) v += red[w][t];
    if (nbr == 1)
      u[gc0 + t] = v;
    else
      g_partial[(size_t)rb * cols + gc0 + t] = v;
  }
  if (nbr == 1) return;
  // the last row block of the group to finish sums the partials in order
  __threadfence();
  __syncthreads();
  if (threadIdx.x == 0)
    s_last = atomicAdd(&g_ticket[blockIdx.y], 1u) == (unsigned)nbr - 1;
  __syncthreads();
  if (!s_last) return;
  __threadfence();
  // warp w sums row blocks [w per, (w + 1) per) in order, lanes across the
  // columns, every load in flight at once; then the warps' sums in order
  const int per = (nbr + kWarps - 1) / kWarps;
  const int b0 = warp * per, b1 = min(nbr, b0 + per);
#pragma unroll
  for (int h = 0; h < 64; h += 32) {
    const int t = h + lane;
    const bool col = t < width && gc0 + t < cols;
    double v[kPerWarp];
#pragma unroll
    for (int q = 0; q < kPerWarp; ++q)
      v[q] = col && b0 + q < b1
                 ? __ldcg(&g_partial[(size_t)(b0 + q) * cols + gc0 + t]) : 0.0;
    double acc = v[0];
#pragma unroll
    for (int q = 1; q < kPerWarp; ++q) acc += v[q];
    red[warp][t] = acc;
  }
  __syncthreads();
  for (int t = threadIdx.x; t < width && gc0 + t < cols; t += blockDim.x) {
    double v = red[0][t];
#pragma unroll
    for (int w = 1; w < kWarps; ++w) v += red[w][t];
    u[gc0 + t] = v;
  }
  if (threadIdx.x == 0) g_ticket[blockIdx.y] = 0u;
}

}  // namespace

extern "C" int hess_gemv(const void* M, long long ld, int rows, int cols,
                         const void* x, void* u, int trans, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const double* Md = static_cast<const double*>(M);
  const double* xd = static_cast<const double*>(x);
  double* ud = static_cast<double*>(u);
  if (rows <= 0 || cols <= 0) return 0;
  const bool vec = reinterpret_cast<size_t>(Md) % 16 == 0 && ld % 2 == 0;
  if (!trans) {
    const bool vx = vec && reinterpret_cast<size_t>(xd) % 16 == 0;
    if (cols > kNarrowCols) {
      const int nb = (rows + kRowWarps - 1) / kRowWarps;
      if (vx)
        gemv_n_wide<true><<<nb, kRowWarps * 32, 0, st>>>(Md, ld, rows, cols, xd, ud);
      else
        gemv_n_wide<false><<<nb, kRowWarps * 32, 0, st>>>(Md, ld, rows, cols, xd, ud);
    } else {
      int lg = 0;  // G = 2^lg lanes across a row: 2G >= cols
      while ((2 << lg) < cols) ++lg;
      const int rows_a_block = kNarrowWarps * (32 >> lg);
      const int nb = (rows + rows_a_block - 1) / rows_a_block;
      if (vx)
        gemv_n_narrow<true><<<nb, kNarrowWarps * 32, 0, st>>>(Md, ld, rows, cols, xd, ud,
                                                               lg);
      else
        gemv_n_narrow<false><<<nb, kNarrowWarps * 32, 0, st>>>(Md, ld, rows, cols, xd, ud,
                                                                lg);
    }
  } else {
    int G = 1;  // lanes across a row: 2G >= cols, G <= 32
    while (G < 32 && 2 * G < cols) G <<= 1;
    const int ncg = (cols + 2 * G - 1) / (2 * G);
    if (ncg > kMaxGroups) return static_cast<int>(cudaErrorInvalidValue);
    int nbr = (rows + kMinRowsT - 1) / kMinRowsT;
    nbr = nbr < kTargetBlocks / ncg ? nbr : kTargetBlocks / ncg;
    nbr = nbr < kMaxRowBlocks ? nbr : kMaxRowBlocks;
    nbr = nbr < kPartialCap / cols ? nbr : kPartialCap / cols;
    nbr = nbr > 1 ? nbr : 1;
    const int rpb = (rows + nbr - 1) / nbr;
    nbr = (rows + rpb - 1) / rpb;
    const dim3 grid(nbr, ncg);
    if (vec)
      gemv_t_kernel<true><<<grid, kWarps * 32, 0, st>>>(Md, ld, rows, cols,
                                                        xd, ud, G, rpb);
    else
      gemv_t_kernel<false><<<grid, kWarps * 32, 0, st>>>(Md, ld, rows, cols,
                                                         xd, ud, G, rpb);
  }
  return static_cast<int>(cudaGetLastError());
}
