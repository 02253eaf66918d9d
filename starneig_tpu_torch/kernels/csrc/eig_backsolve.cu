// E1: the SEP eigenvector backsolve, one launch for every selected
// eigenvalue.
//
// Replaces the JAX package's row loop starneig_tpu/ops/eigenvectors.py:
// _backsolve_all (the lax.fori_loop at :173, vmapped over the eigenvalues),
// which the TPU ran as one device program.  Plain twin:
// ops/eigenvectors.py:_backsolve_rows, a host loop over the rows of ~90
// launches a row.  For each eigenvalue e (lam_r + i lam_i, its block at
// pos) it solves (S - lambda I) x = 0 by backward substitution over the
// quasi-triangular S, from row pos - 1 up to row 0, with the twin's guards:
// a shifted diagonal (or 2x2 determinant) below smin is lifted to smin and
// flags `close`; before a division whose result would pass the growth
// bound omega, the whole vector is scaled by fac < 1 first.  x (xr, xi, m x
// n, row-major) comes in with the block's initial entries and leaves
// unnormalized, as the twin leaves it.
//
// What bounds it on the H100: the chain of n dependent row steps (each row
// needs every entry solved below it), and the reads of the vectors: row k
// reads x[e, k+1 : pos+2] of every eigenvalue, about m n^2 / 3 doubles
// (real parts, and the imaginary parts of pairs) for eigenvalues spread
// over the diagonal.
// Design: a block per group of kG eigenvalues, a warp each; the wrapper
// sorts the eigenvalues by pos (descending), so a group's rows cover
// similar ranges.  The block walks its rows from max(pos) - 1 down to 0;
// at each row it stages S[k, k+1:hi] (and S[k+1, k+2:hi] for a 2x2 block)
// in shared memory in chunks, each warp takes the dot with its own
// x[e, k+1 : pos+2] (lanes across the entries, a fixed xor-shuffle sum),
// and every lane then runs the same guarded 1x1 or 2x2 solve on the same
// sums (no broadcast).  Where fac < 1 the warp scales its vector before
// lane 0 writes x[k].  The solve's arithmetic uses explicitly rounded
// operations (no fused multiply-adds; eig_solve.cuh), as the twin's
// elementwise torch ops round each one, so the guards' decisions (near,
// near2: they read S and lambda alone) equal the twin's bit for bit; the
// dots sum in another order than the twin's matmul.  Only the warp that owns a vector reads
// and writes it.
#include <cuda_runtime.h>

#include "eig_solve.cuh"

namespace {

constexpr int kG = 8;          // eigenvalues a block, a warp each
constexpr int kChunk = 2048;   // columns of S staged a pass
constexpr unsigned kFull = 0xffffffffu;

struct Solve {
  const double* S;
  int n, m;
  const double *lam_r, *lam_i, *smin;
  const int *pos, *pair, *kind, *order;  // kind: 0 a 1x1 row, 1 a 2x2 block's first, 2 its second
  double omega, smlnum;
  double *xr, *xi;
  int* close;
};

__global__ void __launch_bounds__(kG * 32) eig_backsolve_kernel(Solve p) {
  __shared__ double s1[kChunk], s2[kChunk];
  __shared__ int s_top;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int n = p.n;
  const int slot = blockIdx.x * kG + warp;
  const bool live = slot < p.m;
  const int e = live ? p.order[slot] : 0;
  const int pe = live ? p.pos[e] : -1;
  const bool pair = live && p.pair[e] != 0;
  const int hi_e = min(n, pe + 2);  // x[e] is zero from pos + 2 on
  if (threadIdx.x == 0) {
    int top = -1;
    for (int w = 0; w < kG && blockIdx.x * kG + w < p.m; ++w)
      top = max(top, p.pos[p.order[blockIdx.x * kG + w]]);
    s_top = top;
  }
  __syncthreads();
  const int top = s_top;             // the group's largest pos
  const int hi = min(n, top + 2);
  double* xr = p.xr + (size_t)e * n;
  double* xi = p.xi + (size_t)e * n;
  const double lr = live ? p.lam_r[e] : 0.0, li = live ? p.lam_i[e] : 0.0;
  const double smin = live ? p.smin[e] : 1.0;
  const double omega = p.omega, smlnum = p.smlnum;
  bool close = false;

  for (int k = top - 1; k >= 0; --k) {
    const int kd = p.kind[k];
    if (kd == 2) continue;  // a 2x2 block's rows are solved at its first
    const bool two = kd == 1;
    const bool in = live && k < pe;
    double d1r = 0.0, d1i = 0.0, d2r = 0.0, d2i = 0.0;
    for (int lo = k + 1; lo < hi; lo += kChunk) {
      const int len = min(kChunk, hi - lo);
      __syncthreads();  // the previous chunk's readers are done
      const double* row = p.S + (size_t)k * n + lo;
      for (int t = threadIdx.x; t < len; t += blockDim.x) {
        s1[t] = row[t];
        if (two) s2[t] = row[n + t];
      }
      __syncthreads();
      if (in) {
        const int end = min(len, hi_e - lo);
        for (int t = lane; t < end; t += 32) {
          const double a = xr[lo + t];
          const double b = pair ? xi[lo + t] : 0.0;
          d1r += a * s1[t];
          if (pair) d1i += b * s1[t];
          if (two && lo + t > k + 1) {
            d2r += a * s2[t];
            if (pair) d2i += b * s2[t];
          }
        }
      }
    }
    if (!in) continue;
    for (int off = 16; off > 0; off >>= 1) {
      d1r += __shfl_xor_sync(kFull, d1r, off);
      d1i += __shfl_xor_sync(kFull, d1i, off);
      d2r += __shfl_xor_sync(kFull, d2r, off);
      d2i += __shfl_xor_sync(kFull, d2i, off);
    }
    const double rhs_r = -d1r, rhs_i = -d1i;
    const double skk = p.S[(size_t)k * n + k];
    double fac, v1r, v1i, v2r = 0.0, v2i = 0.0;
    if (!two) {
      // 1x1 row: x[k] = rhs / (S[k, k] - lambda), protected
      double dr = rsub(skk, lr), di = -li;
      double dabs = radd(fabs(dr), fabs(di));
      if (dabs < smin) {
        dr = smin;
        di = 0.0;
        close = true;
      }
      dabs = dmax(dabs, smin);
      fac = rescale(radd(fabs(rhs_r), fabs(rhs_i)), dabs, omega, smlnum);
      cdiv(rmul(rhs_r, fac), rmul(rhs_i, fac), dr, di, smlnum, v1r, v1i);
    } else {
      // 2x2 block rows (k, k + 1): the complex 2x2 system by Cramer's rule
      const int k1 = k + 1;
      const double rhs2_r = -d2r, rhs2_i = -d2i;
      const double m11r = rsub(skk, lr), m11i = -li;
      const double m22r = rsub(p.S[(size_t)k1 * n + k1], lr), m22i = -li;
      const double m12 = p.S[(size_t)k * n + k1], m21 = p.S[(size_t)k1 * n + k];
      double detr = rsub(rsub(rmul(m11r, m22r), rmul(m11i, m22i)), rmul(m12, m21));
      double deti = radd(rmul(m11r, m22i), rmul(m11i, m22r));
      double detabs = radd(fabs(detr), fabs(deti));
      const double blkscale =
          radd(radd(radd(radd(radd(radd(fabs(m11r), fabs(m11i)), fabs(m12)), fabs(m21)), fabs(m22r)),
                  fabs(m22i)),
              smin);
      const double sb = rmul(smin, blkscale);
      if (detabs < sb) {
        detr = sb;
        deti = 0.0;
        close = true;
      }
      detabs = dmax(detabs, sb);
      const double n1r = rsub(rsub(rmul(m22r, rhs_r), rmul(m22i, rhs_i)), rmul(m12, rhs2_r));
      const double n1i = rsub(radd(rmul(m22r, rhs_i), rmul(m22i, rhs_r)), rmul(m12, rhs2_i));
      const double n2r = rsub(rsub(rmul(m11r, rhs2_r), rmul(m11i, rhs2_i)), rmul(m21, rhs_r));
      const double n2i = rsub(radd(rmul(m11r, rhs2_i), rmul(m11i, rhs2_r)), rmul(m21, rhs_i));
      const double nmax = dmax(radd(fabs(n1r), fabs(n1i)), radd(fabs(n2r), fabs(n2i)));
      fac = rescale(nmax, detabs, omega, smlnum);
      cdiv(rmul(n1r, fac), rmul(n1i, fac), detr, deti, smlnum, v1r, v1i);
      cdiv(rmul(n2r, fac), rmul(n2i, fac), detr, deti, smlnum, v2r, v2i);
    }
    if (fac != 1.0) {
      // scale the vector before the growing division's result joins it
      for (int l = k + 1 + lane; l < hi_e; l += 32) {
        xr[l] = rmul(xr[l], fac);
        if (pair) xi[l] = rmul(xi[l], fac);
      }
    }
    __syncwarp();
    if (lane == 0) {
      xr[k] = v1r;
      xi[k] = v1i;
      if (two) {
        xr[k + 1] = v2r;
        xi[k + 1] = v2i;
      }
    }
    __syncwarp();
  }
  if (live && lane == 0) p.close[e] = close ? 1 : 0;
}

}  // namespace

// x[e, :] for the m eigenvalues of S (n x n), in place; close[e] 1 where a
// guard lifted a shifted diagonal or determinant.  order: the eigenvalues
// sorted by pos, descending (a block takes kG consecutive ones).
extern "C" int eig_backsolve(const void* S, int n, const void* lam_r, const void* lam_i,
                             const void* smin, const void* pos, const void* pair,
                             const void* kind, const void* order, int m, double omega,
                             double smlnum, void* xr, void* xi, void* close, void* stream) {
  if (m <= 0) return 0;
  Solve p;
  p.S = static_cast<const double*>(S);
  p.n = n;
  p.m = m;
  p.lam_r = static_cast<const double*>(lam_r);
  p.lam_i = static_cast<const double*>(lam_i);
  p.smin = static_cast<const double*>(smin);
  p.pos = static_cast<const int*>(pos);
  p.pair = static_cast<const int*>(pair);
  p.kind = static_cast<const int*>(kind);
  p.order = static_cast<const int*>(order);
  p.omega = omega;
  p.smlnum = smlnum;
  p.xr = static_cast<double*>(xr);
  p.xi = static_cast<double*>(xi);
  p.close = static_cast<int*>(close);
  const int blocks = (m + kG - 1) / kG;
  eig_backsolve_kernel<<<blocks, kG * 32, 0, static_cast<cudaStream_t>(stream)>>>(p);
  return static_cast<int>(cudaGetLastError());
}
