// B1: strided fp64 GEMV for the Hessenberg panel loop.
//
// Replaces starneig_tpu/ops/pallas_hess.py:_matvec_kernel (pallas_call at
// :81, wrapper matvec_df), which computed u = M x at df32 precision over
// row blocks [row0, R).  Plain twin: ops/gpu_hess.py:gemv_plain (M @ x).
// It serves every matvec of the panel loop: the panel matvec
// A[t0:, t0:] v against the frozen panel-start matrix, and the compact-WY
// correction products Y V[c], V^T a, V (T^T w), V^T v, U tcol and the two
// small T products.
//
// What bounds it on the H100: DRAM bandwidth for the panel matvec, launch
// latency for the rest.  At n = 4000 the frozen panel matrix is 128 MB,
// more than the 50 MB L2, so the panel matvec streams it from HBM once per
// column (2 flops per 8 bytes).  The transposed products read V[:, :j]
// (4000 x j, ld 288, j = 0..287: at most 9.2 MB, 2.75 us of HBM) or the
// small T[:j, :j], three times a column, so one launch's fixed cost is
// most of their time.  Design:
//   * trans = 0, u = M[:rows, :cols] x: one warp per row, each lane strides
//     the row by 32 (coalesced 256-byte segments), shuffle-tree reduction;
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

namespace {

constexpr int kWarps = 8;

__global__ void __launch_bounds__(kWarps * 32)
gemv_n_kernel(const double* __restrict__ M, long long ld, int rows, int cols,
              const double* __restrict__ x, double* __restrict__ u) {
  const int lane = threadIdx.x & 31;
  const int row = blockIdx.x * kWarps + (threadIdx.x >> 5);
  if (row >= rows) return;
  const double* m = M + (size_t)row * ld;
  double acc = 0.0;
  for (int j = lane; j < cols; j += 32) acc += m[j] * x[j];
  for (int off = 16; off > 0; off >>= 1)
    acc += __shfl_down_sync(0xffffffffu, acc, off);
  if (lane == 0) u[row] = acc;
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
  if (!trans) {
    gemv_n_kernel<<<(rows + kWarps - 1) / kWarps, kWarps * 32, 0, st>>>(
        Md, ld, rows, cols, xd, ud);
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
    const bool vec = reinterpret_cast<size_t>(Md) % 16 == 0 && ld % 2 == 0;
    if (vec)
      gemv_t_kernel<true><<<grid, kWarps * 32, 0, st>>>(Md, ld, rows, cols,
                                                        xd, ud, G, rpb);
    else
      gemv_t_kernel<false><<<grid, kWarps * 32, 0, st>>>(Md, ld, rows, cols,
                                                         xd, ud, G, rpb);
  }
  return static_cast<int>(cudaGetLastError());
}
