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
// What bounds it on the H100: DRAM bandwidth.  At n = 4000 the frozen
// panel matrix is 128 MB, more than the 50 MB L2, so the panel matvec
// streams it from HBM once per column (2 flops per 8 bytes).  Design:
//   * trans = 0, u = M[:rows, :cols] x: one warp per row, each lane strides
//     the row by 32 (coalesced 256-byte segments), shuffle-tree reduction;
//   * trans = 1, u = M[:rows, :cols]^T x: blocks tile 32 columns x a chunk
//     of 128 rows, 8 row phases per block reduce in shared memory and
//     write one partial per (chunk, column); a second pass sums the
//     partials in chunk order, so the result is deterministic.
// M is any row-major view with unit column stride and leading dimension ld.
#include <cuda_runtime.h>

namespace {

constexpr int kWarps = 8;
constexpr int kRowChunk = 128;

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

__global__ void __launch_bounds__(256)
gemv_t_partial_kernel(const double* __restrict__ M, long long ld, int rows,
                      int cols, const double* __restrict__ x,
                      double* __restrict__ partial) {
  __shared__ double red[8][33];
  const int tx = threadIdx.x & 31, ty = threadIdx.x >> 5;
  const int col = blockIdx.x * 32 + tx;
  const int r0 = blockIdx.y * kRowChunk;
  const int r1 = min(rows, r0 + kRowChunk);
  double acc = 0.0;
  if (col < cols)
    for (int r = r0 + ty; r < r1; r += 8) acc += M[(size_t)r * ld + col] * x[r];
  red[ty][tx] = acc;
  __syncthreads();
  if (ty == 0 && col < cols) {
    double s = red[0][tx];
    for (int k = 1; k < 8; ++k) s += red[k][tx];
    partial[(size_t)blockIdx.y * cols + col] = s;
  }
}

__global__ void gemv_t_sum_kernel(const double* __restrict__ partial,
                                  int chunks, int cols, double* __restrict__ u) {
  const int col = blockIdx.x * blockDim.x + threadIdx.x;
  if (col >= cols) return;
  double s = 0.0;
  for (int c = 0; c < chunks; ++c) s += partial[(size_t)c * cols + col];
  u[col] = s;
}

}  // namespace

// scratch must hold ceil(rows / 128) * cols doubles when trans != 0
extern "C" int hess_gemv(const void* M, long long ld, int rows, int cols,
                         const void* x, void* u, int trans, void* scratch,
                         void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const double* Md = static_cast<const double*>(M);
  const double* xd = static_cast<const double*>(x);
  double* ud = static_cast<double*>(u);
  if (rows <= 0 || cols <= 0) return 0;
  if (!trans) {
    gemv_n_kernel<<<(rows + kWarps - 1) / kWarps, kWarps * 32, 0, st>>>(
        Md, ld, rows, cols, xd, ud);
  } else {
    const int chunks = (rows + kRowChunk - 1) / kRowChunk;
    double* part = static_cast<double*>(scratch);
    dim3 grid((cols + 31) / 32, chunks);
    gemv_t_partial_kernel<<<grid, 256, 0, st>>>(Md, ld, rows, cols, xd, part);
    gemv_t_sum_kernel<<<(cols + 127) / 128, 128, 0, st>>>(part, chunks, cols, ud);
  }
  return static_cast<int>(cudaGetLastError());
}
