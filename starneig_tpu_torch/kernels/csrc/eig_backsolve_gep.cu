// E2: the GEP eigenvector backsolve, one launch for every selected
// eigenvalue of a pencil.
//
// Replaces the JAX package's row loop starneig_tpu/ops/eigenvectors.py:
// _backsolve_all_gep (the lax.fori_loop at :395, vmapped over the
// eigenvalues at :404), which the TPU ran as one device program.  Plain
// twin: ops/eigenvectors.py:_backsolve_rows_gep, a host loop over the rows
// of ~60 launches a row.  For each eigenvalue e (alpha = ar + i ai, beta =
// bt, scaled to magnitude about 1; its block at pos) it solves
// (beta S - alpha T) x = 0 by backward substitution over the generalized
// Schur form, from row pos - 1 up to row 0, with the twin's guards: a
// shifted diagonal M[k, k] (or a 2x2 determinant) below smin is lifted to
// smin and flags `close`; before a division whose result would pass the
// growth bound omega, the whole vector is scaled by fac < 1 first.  An
// infinite eigenvalue (beta = 0, M = -alpha T) takes the same recurrence.
// x (xr, xi, m x n, row-major) comes in with the block's start entries
// and leaves unnormalized, as the twin leaves it.
//
// What bounds it on the H100: the chain of dependent row steps (each row
// needs every entry solved below it), and the reads of the vectors: row k
// reads x[e, k+1 : pos+2] of every eigenvalue.
// Design (E1's, eig_backsolve.cu): a block per group of kG eigenvalues, a
// warp each; the wrapper sorts the eigenvalues by pos (descending), so a
// group's rows cover similar ranges.  The block walks its rows from
// max(pos) - 1 down to 0; at each row it stages S[k, k+1:hi] and
// T[k, k+1:hi] (and rows k+1 of both for a 2x2 block: four rows of kChunk
// doubles, 32 KB of static shared memory) in chunks; each warp forms
// M[k, j] = bt S[k, j] - alpha T[k, j] on the fly and takes its dot with
// its own x[e, k+1 : pos+2] (lanes across the entries, a fixed
// xor-shuffle sum; a real eigenvalue's xi stays zero and its imaginary
// dots are skipped), and every lane then runs the same guarded 1x1 or 2x2
// solve on the same sums.  Where fac < 1 the warp scales its vector before
// lane 0 writes x[k].  The solve's arithmetic, M's entries in it included,
// uses explicitly rounded operations (eig_solve.cuh) in the twin's order,
// so the guards' decisions (near, near2: they read S, T, alpha, beta and
// smin alone) equal the twin's bit for bit; the dots sum in another order
// than the twin's.  Only the warp that owns a vector reads and writes it.
#include <cuda_runtime.h>

#include "eig_solve.cuh"

namespace {

constexpr int kG = 8;          // eigenvalues a block, a warp each
constexpr int kChunk = 1024;   // columns of S and T staged a pass
constexpr unsigned kFull = 0xffffffffu;

struct SolveGep {
  const double *S, *T;
  int n, m;
  const double *ar, *ai, *bt, *smin;
  const int *pos, *pair, *kind, *order;  // kind: 0 a 1x1 row, 1 a 2x2 block's first, 2 its second
  double omega, smlnum;
  double *xr, *xi;
  int* close;
};

// M[k, j] = bt S[k, j] - (ar + i ai) T[k, j], rounded as the twin's mentry
DEVI void mentry(double bt, double ar, double ai, double s, double t, double& mr,
                 double& mi) {
  mr = rsub(rmul(bt, s), rmul(ar, t));
  mi = rmul(-ai, t);
}

__global__ void __launch_bounds__(kG * 32) eig_backsolve_gep_kernel(SolveGep p) {
  __shared__ double s1[kChunk], t1[kChunk], s2[kChunk], t2[kChunk];
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
  const double ar = live ? p.ar[e] : 0.0, ai = live ? p.ai[e] : 0.0;
  const double bt = live ? p.bt[e] : 0.0;
  const double smin = live ? p.smin[e] : 1.0;
  const double omega = p.omega, smlnum = p.smlnum;
  const double* S = p.S;
  const double* T = p.T;
  bool close = false;

  for (int k = top - 1; k >= 0; --k) {
    const int kd = p.kind[k];
    if (kd == 2) continue;  // a 2x2 block's rows are solved at its first
    const bool two = kd == 1;
    const bool in = live && k < pe;
    // row k's sums: sum M_r x_r, M_i x_i, M_r x_i, M_i x_r; row k+1's the same
    double a1 = 0.0, b1 = 0.0, c1 = 0.0, d1 = 0.0;
    double a2 = 0.0, b2 = 0.0, c2 = 0.0, d2 = 0.0;
    for (int lo = k + 1; lo < hi; lo += kChunk) {
      const int len = min(kChunk, hi - lo);
      __syncthreads();  // the previous chunk's readers are done
      const size_t at = (size_t)k * n + lo;
      for (int t = threadIdx.x; t < len; t += blockDim.x) {
        s1[t] = S[at + t];
        t1[t] = T[at + t];
        if (two) {
          s2[t] = S[at + n + t];
          t2[t] = T[at + n + t];
        }
      }
      __syncthreads();
      if (in) {
        const int end = min(len, hi_e - lo);
        for (int t = lane; t < end; t += 32) {
          const double xa = xr[lo + t];
          const double xb = pair ? xi[lo + t] : 0.0;
          const double mr = bt * s1[t] - ar * t1[t];
          a1 += mr * xa;
          if (pair) {
            const double mi = -ai * t1[t];
            b1 += mi * xb;
            c1 += mr * xb;
            d1 += mi * xa;
          }
          if (two && lo + t > k + 1) {
            const double mr2 = bt * s2[t] - ar * t2[t];
            a2 += mr2 * xa;
            if (pair) {
              const double mi2 = -ai * t2[t];
              b2 += mi2 * xb;
              c2 += mr2 * xb;
              d2 += mi2 * xa;
            }
          }
        }
      }
    }
    if (!in) continue;
    for (int off = 16; off > 0; off >>= 1) {
      a1 += __shfl_xor_sync(kFull, a1, off);
      b1 += __shfl_xor_sync(kFull, b1, off);
      c1 += __shfl_xor_sync(kFull, c1, off);
      d1 += __shfl_xor_sync(kFull, d1, off);
      if (two) {
        a2 += __shfl_xor_sync(kFull, a2, off);
        b2 += __shfl_xor_sync(kFull, b2, off);
        c2 += __shfl_xor_sync(kFull, c2, off);
        d2 += __shfl_xor_sync(kFull, d2, off);
      }
    }
    const double rhs_r = -(a1 - b1), rhs_i = -(c1 + d1);
    const size_t kk = (size_t)k * n + k;
    double fac, v1r, v1i, v2r = 0.0, v2i = 0.0;
    if (!two) {
      // 1x1 row: x[k] = rhs / M[k, k], protected
      double dr, di;
      mentry(bt, ar, ai, S[kk], T[kk], dr, di);
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
      // (M[k+1, k] stays a formula although T[k+1, k] = 0, as in the twin)
      const double rhs2_r = -(a2 - b2), rhs2_i = -(c2 + d2);
      double a11r, a11i, a12r, a12i, a21r, a21i, a22r, a22i;
      mentry(bt, ar, ai, S[kk], T[kk], a11r, a11i);
      mentry(bt, ar, ai, S[kk + 1], T[kk + 1], a12r, a12i);
      mentry(bt, ar, ai, S[kk + n], T[kk + n], a21r, a21i);
      mentry(bt, ar, ai, S[kk + n + 1], T[kk + n + 1], a22r, a22i);
      double detr = rsub(rsub(rmul(a11r, a22r), rmul(a11i, a22i)),
                         rsub(rmul(a12r, a21r), rmul(a12i, a21i)));
      double deti = rsub(radd(rmul(a11r, a22i), rmul(a11i, a22r)),
                         radd(rmul(a12r, a21i), rmul(a12i, a21r)));
      double detabs = radd(fabs(detr), fabs(deti));
      // the twin's left-to-right sum of the eight magnitudes, then smin
      const double blkscale = radd(
          radd(radd(radd(radd(radd(radd(radd(fabs(a11r), fabs(a11i)), fabs(a12r)), fabs(a12i)),
                              fabs(a21r)),
                         fabs(a21i)),
                    fabs(a22r)),
               fabs(a22i)),
          smin);
      const double sb = rmul(smin, blkscale);
      if (detabs < sb) {
        detr = sb;
        deti = 0.0;
        close = true;
      }
      detabs = dmax(detabs, sb);
      const double n1r = rsub(rsub(rmul(a22r, rhs_r), rmul(a22i, rhs_i)),
                              rsub(rmul(a12r, rhs2_r), rmul(a12i, rhs2_i)));
      const double n1i = rsub(radd(rmul(a22r, rhs_i), rmul(a22i, rhs_r)),
                              radd(rmul(a12r, rhs2_i), rmul(a12i, rhs2_r)));
      const double n2r = rsub(rsub(rmul(a11r, rhs2_r), rmul(a11i, rhs2_i)),
                              rsub(rmul(a21r, rhs_r), rmul(a21i, rhs_i)));
      const double n2i = rsub(radd(rmul(a11r, rhs2_i), rmul(a11i, rhs2_r)),
                              radd(rmul(a21r, rhs_i), rmul(a21i, rhs_r)));
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
      if (pair) xi[k] = v1i;
      if (two) {
        xr[k + 1] = v2r;
        if (pair) xi[k + 1] = v2i;
      }
    }
    __syncwarp();
  }
  if (live && lane == 0) p.close[e] = close ? 1 : 0;
}

}  // namespace

// x[e, :] for the m eigenvalues of the pencil (S, T) (n x n each), in
// place; close[e] 1 where a guard lifted a shifted diagonal or
// determinant.  order: the eigenvalues sorted by pos, descending (a block
// takes kG consecutive ones).
extern "C" int eig_backsolve_gep(const void* S, const void* T, int n, const void* ar,
                                 const void* ai, const void* bt, const void* smin,
                                 const void* pos, const void* pair, const void* kind,
                                 const void* order, int m, double omega, double smlnum,
                                 void* xr, void* xi, void* close, void* stream) {
  if (m <= 0) return 0;
  SolveGep p;
  p.S = static_cast<const double*>(S);
  p.T = static_cast<const double*>(T);
  p.n = n;
  p.m = m;
  p.ar = static_cast<const double*>(ar);
  p.ai = static_cast<const double*>(ai);
  p.bt = static_cast<const double*>(bt);
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
  eig_backsolve_gep_kernel<<<blocks, kG * 32, 0, static_cast<cudaStream_t>(stream)>>>(p);
  return static_cast<int>(cudaGetLastError());
}
