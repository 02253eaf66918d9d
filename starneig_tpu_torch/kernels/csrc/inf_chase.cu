// G5: the window chase of the multishift QZ's infinite-eigenvalue push, one
// window in one block.
//
// Replaces the XLA fori_loop of starneig_tpu/ops/qz_driver.py:
// _inf_chase_kernel (:328-395).  Plain twin:
// ops/qz_driver.py:_inf_chase_kernel.
//
// The window (H Hessenberg, T upper triangular, Wb x Wb) has a negligible
// T-diagonal entry at jrel; step i = jrel .. mrel-2 moves it one row down:
// a left rotation from T's pair (T[i, i+1], T[i+1, i+1]) on rows i, i+1 of
// H and T (and columns of Qw) zeroes T[i+1, i+1] (planted: T[i, i+1] = r,
// T[i+1, i+1] = T[i+1, i] = 0), then a right reflection
// [[-sr, cr], [cr, sr]] from H's fill pair (H[i+1, i-1], H[i+1, i]) on
// columns i-1, i of H, T and Zw restores H's Hessenberg form (planted:
// H[i+1, i] = rr, H[i+1, i-1] = 0), except at step lrel (the decoupled
// segment top, where no fill arises).  At i = 0 both columns of the
// reflection are column 0, and the second write wins, as in the twin.
//
// What bounds it on the H100: the chain of 2 (Wb - 1) rotations, each
// waiting for the previous one's update of the two rows (columns) it is
// formed from; the updates are O(Wb) a rotation on three matrices.
// Design, simple first: the H and T windows live in shared memory (leading
// dimension Wb + 1 against bank conflicts; 2 x 74.5 KB at Wb = 96), Qw and
// Zw in global memory; thread 0 forms each rotation (common.cuh:givens, the
// primitives.givens formulas) and plants the exact zeros; the block applies
// the left rotation to rows of H, T and columns of Qw, takes a barrier,
// then applies the right reflection to columns of H, T and Zw.
#include "common.cuh"

namespace {

constexpr int kThreads = 256;

__global__ void __launch_bounds__(kThreads)
inf_chase_kernel(double* __restrict__ H, double* __restrict__ T,
                 double* __restrict__ Q, double* __restrict__ Z, int Wb,
                 int jrel, int mrel, int lrel) {
  extern __shared__ double smem[];
  const int ld = Wb + 1;
  double* sH = smem;
  double* sT = smem + (size_t)Wb * ld;
  __shared__ double s_rot[3];  // c, s, r of the left rotation
  __shared__ double s_ref[3];  // cr, sr, rr of the right reflection
  __shared__ int s_skip;
  const int tid = threadIdx.x, nt = blockDim.x;
  for (int e = tid; e < Wb * Wb; e += nt) {
    const int r = e / Wb, c = e % Wb;
    sH[r * ld + c] = H[e];
    sT[r * ld + c] = T[e];
    Q[e] = r == c ? 1.0 : 0.0;
    Z[e] = r == c ? 1.0 : 0.0;
  }
  __syncthreads();
  if (tid == 0 && jrel >= 0 && jrel < Wb) sT[jrel * ld + jrel] = 0.0;
  for (int i = jrel > 0 ? jrel : 0; i < mrel - 1; ++i) {
    const int i1 = i + 1;
    if (tid == 0) {
      double c, s, r;
      givens(sT[i * ld + i1], sT[i1 * ld + i1], c, s, r);
      s_rot[0] = c;
      s_rot[1] = s;
      s_rot[2] = r;
    }
    __syncthreads();
    {
      const double c = s_rot[0], s = s_rot[1];
      // rows i, i1 of H and T; columns i, i1 of Qw
      for (int e = tid; e < 3 * Wb; e += nt) {
        if (e < 2 * Wb) {
          double* X = e < Wb ? sH : sT;
          const int col = e % Wb;
          const double r0 = X[i * ld + col], r1 = X[i1 * ld + col];
          X[i * ld + col] = c * r0 + s * r1;
          X[i1 * ld + col] = -s * r0 + c * r1;
        } else {
          double* q = Q + (size_t)(e - 2 * Wb) * Wb;
          const double q0 = q[i], q1 = q[i1];
          q[i] = c * q0 + s * q1;
          q[i1] = -s * q0 + c * q1;
        }
      }
    }
    __syncthreads();
    const int im1 = i - 1 > 0 ? i - 1 : 0;
    if (tid == 0) {
      sT[i * ld + i1] = s_rot[2];
      sT[i1 * ld + i1] = 0.0;
      sT[i1 * ld + i] = 0.0;
      s_skip = i == lrel;
      if (!s_skip) {
        double cr, sr, rr;
        givens(sH[i1 * ld + im1], sH[i1 * ld + i], cr, sr, rr);
        s_ref[0] = cr;
        s_ref[1] = sr;
        s_ref[2] = rr;
      }
    }
    __syncthreads();
    if (s_skip) continue;  // uniform: every thread read the same flag
    {
      const double cr = s_ref[0], sr = s_ref[1];
      // columns im1, i of H, T (Wb rows each) and Zw
      for (int e = tid; e < 3 * Wb; e += nt) {
        const int row = e % Wb;
        double* a;
        double* b;
        if (e < 2 * Wb) {
          double* X = e < Wb ? sH : sT;
          a = X + row * ld + im1;
          b = X + row * ld + i;
        } else {
          a = Z + (size_t)row * Wb + im1;
          b = Z + (size_t)row * Wb + i;
        }
        const double x0 = *a, x1 = *b;
        const double na = -sr * x0 + cr * x1, nb = cr * x0 + sr * x1;
        *a = na;
        *b = nb;  // at i = 0, a == b: nb wins, as in the twin
      }
    }
    __syncthreads();
    if (tid == 0) {
      sH[i1 * ld + i] = s_ref[2];
      sH[i1 * ld + im1] = 0.0;
    }
    // thread 0 forms the next rotation itself; the others wait for it at
    // the next step's first barrier
  }
  __syncthreads();
  for (int e = tid; e < Wb * Wb; e += nt) {
    const int r = e / Wb, c = e % Wb;
    H[e] = sH[r * ld + c];
    T[e] = sT[r * ld + c];
  }
}

}  // namespace

extern "C" int inf_chase(void* H, void* T, void* Q, void* Z, int Wb, int jrel,
                         int mrel, int lrel, void* stream) {
  const size_t smem = 2 * (size_t)Wb * (Wb + 1) * sizeof(double);
  if (Wb < 2 || smem > 227 * 1024 || mrel > Wb)
    return static_cast<int>(cudaErrorInvalidValue);
  static size_t configured = 0;
  if (smem > 48 * 1024 && smem > configured) {
    cudaError_t e = cudaFuncSetAttribute(
        inf_chase_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return static_cast<int>(e);
    configured = smem;
  }
  inf_chase_kernel<<<1, kThreads, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<double*>(H), static_cast<double*>(T), static_cast<double*>(Q),
      static_cast<double*>(Z), Wb, jrel, mrel, lrel);
  return static_cast<int>(cudaGetLastError());
}
