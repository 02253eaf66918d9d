// G1: the interleaved Givens cascade of the Hessenberg-triangular reduction,
// and its window mode, the GEP AED recondense.
//
// Replaces two XLA loops of the JAX package (no Pallas kernel there):
// starneig_tpu/ops/hess_triangular.py:_ht_reduce (:36), a double fori_loop
// over the ~n^2/2 rotation steps, and starneig_tpu/ops/qz_driver.py:
// _aed_recondense_gep (:166), the spike chase and the window re-reduction.
// Plain twins: ops/hess_triangular.py:_ht_reduce and
// ops/qz_driver.py:_aed_recondense_gep.
//
// The cascade: for each column j, bottom-up for i >= j+2, a left rotation
// on rows (i-1, i) of A and B (and columns of Q) zeroes A[i, j]; it fills
// B[i, i-1], which a right rotation on columns (i-1, i) of B, A (and Z)
// zeroes at once.  Each right rotation depends on B's current 2x2 at
// (i-1, i), which the pass's earlier rotations changed, so a pass is serial
// along B's diagonal: about n^2/2 dependent steps (2.0 M at n = 2000).
//
// What bounds it on the H100: that chain of steps, each a rotation
// generated by one thread and applied by the block, with a barrier between
// phases; not flops (6 a touched entry) nor bytes (a step touches two rows
// and two columns, which stay in L2 between neighbouring steps).  Design,
// simple first: one persistent block walks the cascade in the JAX order,
// each step in four phases (left rotation, its row updates, right rotation,
// its column updates) with the update of each rotation spread over the
// block's threads.  Entries known to be zero are skipped (A's rows left of
// column j, B's rows left of column i-1 and B's columns below row i): the
// rotations there are exact identities.  In the full reduction Q and Z do
// not feed back into the rotations, so the cascade only logs (c, s, cr, sr)
// a step and a second kernel applies the log to Q's and Z's rows, a thread
// a row walking its row with the rotated column pair in a register: that
// keeps Q's and Z's 2n column entries a step off the chain.  Window mode
// (WA <= a few hundred) updates its Q and Z in the step and applies every
// rotation at the window's full width, as the JAX version does.
#include "common.cuh"

namespace {

constexpr int kThreads = 512;

// rows (i-1, i) <- (c r0 + s r1, -s r0 + c r1) on columns [c0, c1); the
// entry (i, zero_col) is planted 0 (zero_col < 0: none)
DEVI void rot_rows(double* M, int ld, int i, int c0, int c1, double c,
                   double s, int zero_col) {
  double* r0 = M + (size_t)(i - 1) * ld;
  double* r1 = M + (size_t)i * ld;
  for (int col = c0 + (int)threadIdx.x; col < c1; col += blockDim.x) {
    const double a = r0[col], b = r1[col];
    r0[col] = c * a + s * b;
    r1[col] = col == zero_col ? 0.0 : -s * a + c * b;
  }
}

// columns (i-1, i) <- (c c0 + s c1, -s c0 + c c1) on rows [r0, r1); the
// entry (zero_row, i-1) is planted 0 (zero_row < 0: none)
DEVI void rot_cols(double* M, int ld, int i, int r0, int r1, double c,
                   double s, int zero_row) {
  for (int r = r0 + (int)threadIdx.x; r < r1; r += blockDim.x) {
    double* p = M + (size_t)r * ld + i - 1;
    const double a = p[0], b = p[1];
    p[0] = r == zero_row ? 0.0 : c * a + s * b;
    p[1] = -s * a + c * b;
  }
}

// One rotation pair at row i after the left rotation (c, s) is in sh[0..1]
// and visible to the block.  full: the HT reduction of an n x n pencil
// (skip the known zeros, log the rotations at rot[4 pos..]); else the
// window mode (full widths, Q and Z in the step).  jcol >= 0 is the column
// whose entry A[i, jcol] the left rotation zeroes.
DEVI void pair_step(double* A, double* B, double* Q, double* Z, int n, int i,
                    int jcol, bool full, double* sh, double* rot, long long pos) {
  const double c = sh[0], s = sh[1];
  rot_rows(A, n, i, full ? jcol : 0, n, c, s, jcol);
  rot_rows(B, n, i, full ? i - 1 : 0, n, c, s, -1);
  if (!full) rot_cols(Q, n, i, 0, n, c, s, -1);
  __syncthreads();
  if (threadIdx.x == 0) {
    double cr, sr, r;
    givens(B[(size_t)i * n + i], B[(size_t)i * n + i - 1], cr, sr, r);
    sh[2] = cr;
    sh[3] = sr;
    if (full) {
      rot[4 * pos] = c;
      rot[4 * pos + 1] = s;
      rot[4 * pos + 2] = cr;
      rot[4 * pos + 3] = sr;
    }
  }
  __syncthreads();
  const double cr = sh[2], msr = -sh[3];
  rot_cols(B, n, i, 0, full ? i + 1 : n, cr, msr, i);
  rot_cols(A, n, i, 0, n, cr, msr, -1);
  if (!full) rot_cols(Z, n, i, 0, n, cr, msr, -1);
  __syncthreads();
}

// the cascade's left rotation from (f, g), by thread 0 into sh[0..1]
DEVI void left_rotation(double f, double g, double* sh, double* r_out) {
  double c, s, r;
  givens(f, g, c, s, r);
  sh[0] = c;
  sh[1] = s;
  if (r_out) *r_out = r;
}

__global__ void __launch_bounds__(kThreads)
ht_full_kernel(double* __restrict__ A, double* __restrict__ B,
               double* __restrict__ rot, int n) {
  __shared__ double sh[4];
  long long pos = 0;
  for (int j = 0; j < n - 2; ++j) {
    for (int i = n - 1; i >= j + 2; --i, ++pos) {
      if (threadIdx.x == 0)
        left_rotation(A[(size_t)(i - 1) * n + j], A[(size_t)i * n + j], sh, nullptr);
      __syncthreads();
      pair_step(A, B, nullptr, nullptr, n, i, j, true, sh, rot, pos);
    }
  }
}

// Q and Z take the logged rotations: blockIdx.y = 0 applies the left ones
// to Q's rows, 1 the right ones to Z's rows; a thread a row, in the
// cascade's order, the row's entry at column i carried in a register
__global__ void ht_apply_kernel(double* __restrict__ Q, double* __restrict__ Z,
                                const double* __restrict__ rot, int n) {
  const int which = blockIdx.y;
  const int r = blockIdx.x * blockDim.x + threadIdx.x;
  if (r >= n) return;
  double* row = (which == 0 ? Q : Z) + (size_t)r * n;
  long long pos = 0;
  for (int j = 0; j < n - 2; ++j) {
    double carry = row[n - 1];
    for (int i = n - 1; i >= j + 2; --i, ++pos) {
      const double c = rot[4 * pos + 2 * which];
      const double s = which == 0 ? rot[4 * pos + 1] : -rot[4 * pos + 3];
      const double a = row[i - 1];
      row[i] = -s * a + c * carry;
      carry = c * a + s * carry;
    }
    row[j + 1] = carry;
  }
}

// window mode: the spike s Q[0, :kbot] condensed into beta e1 by rotation
// pairs (the cascade's column -1), then the cascade on the leading kbot
// block, then T's lower triangle inside it zeroed
__global__ void __launch_bounds__(kThreads)
ht_window_kernel(double* __restrict__ S, double* __restrict__ T,
                 double* __restrict__ Q, double* __restrict__ Z, int W,
                 int kbot, double spike, double* __restrict__ beta) {
  extern __shared__ double sp[];
  __shared__ double sh[4];
  for (int e = threadIdx.x; e < W; e += blockDim.x)
    sp[e] = e < kbot ? spike * Q[e] : 0.0;
  __syncthreads();
  for (int i = kbot - 1; i >= 1; --i) {
    if (threadIdx.x == 0) {
      double r;
      left_rotation(sp[i - 1], sp[i], sh, &r);
      sp[i - 1] = r;
      sp[i] = 0.0;
    }
    __syncthreads();
    pair_step(S, T, Q, Z, W, i, -1, false, sh, nullptr, 0);
  }
  if (threadIdx.x == 0) beta[0] = sp[0];
  for (int j = 0; j < kbot - 2; ++j) {
    for (int i = kbot - 1; i >= j + 2; --i) {
      if (threadIdx.x == 0)
        left_rotation(S[(size_t)(i - 1) * W + j], S[(size_t)i * W + j], sh, nullptr);
      __syncthreads();
      pair_step(S, T, Q, Z, W, i, j, false, sh, nullptr, 0);
    }
  }
  for (int e = threadIdx.x; e < kbot * kbot; e += blockDim.x) {
    const int r = e / kbot, c = e % kbot;
    if (r > c) T[(size_t)r * W + c] = 0.0;
  }
}

}  // namespace

extern "C" int ht_cascade(void* A, void* B, void* Q, void* Z, void* rot, int n,
                          void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (n <= 2) return 0;
  ht_full_kernel<<<1, kThreads, 0, st>>>(static_cast<double*>(A),
                                         static_cast<double*>(B),
                                         static_cast<double*>(rot), n);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return static_cast<int>(e);
  constexpr int kRows = 32;
  ht_apply_kernel<<<dim3((n + kRows - 1) / kRows, 2), kRows, 0, st>>>(
      static_cast<double*>(Q), static_cast<double*>(Z),
      static_cast<const double*>(rot), n);
  return static_cast<int>(cudaGetLastError());
}

extern "C" int ht_recondense(void* S, void* T, void* Q, void* Z, int W, int kbot,
                             double s, void* beta, void* stream) {
  const size_t smem = (size_t)W * sizeof(double);
  if (smem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(
        ht_window_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  ht_window_kernel<<<1, kThreads, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<double*>(S), static_cast<double*>(T), static_cast<double*>(Q),
      static_cast<double*>(Z), W, kbot, s, static_cast<double*>(beta));
  return static_cast<int>(cudaGetLastError());
}
