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
// needs every entry solved below it), about one step a 1x1 or 2x2 block of
// the rows above the highest selected block, and the dots: row k of
// eigenvalue e sums M[k, k+1 : pos+2] x[e, k+1 : pos+2], two dots (S's and
// T's row) an entry, four for a complex pair.
// Design: E1's blocked backsolve (eig_blocked.cuh: LAPACK dtrevc3's
// blocked form) extended to the pencil.  A block takes a group of kG
// eigenvalues (the wrapper sorts them by pos, descending) and walks its
// rows in row blocks of at most kNB from the group's largest pos down to
// row 0.  For the row block [r0, r1):
//   far  FS = S[r0:r1, r1:hi] X and FT = T[r0:r1, r1:hi] X for the group's
//        2 kG vectors (Re and Im) on the fp64 tensor cores, each warp a
//        slice of the columns; a lane's accumulators hold FS and FT of the
//        Re and Im columns of one group member, so it forms that member's
//        F = M X = (bt S - (ar + i ai) T)(xr + i xi) in registers
//        (combine: Fr = bt FSr - ar FTr + ai FTi, Fi = bt FSi - ar FTi -
//        ai FTr) before the slices are added in warp order through shared
//        memory: the slices stay E1's 16 x 64 doubles;
//   near each warp its eigenvalue's chain, rows r1 - 1 down to r0: the
//        dots of S's and T's rows with x[k+1 : r1) (the near tiles of S and
//        T and the warp's x in shared memory, at most kNB - 1 entries,
//        lanes across the entries), combined a lane at a time with the
//        same formula, a fixed xor-shuffle sum, added to F; then the
//        guarded 1x1 or 2x2 solve.  What the solve takes from S, T, alpha,
//        beta and smin alone (M's diagonal entry, or a 2x2 block's four
//        complex entries, its determinant and blkscale, the lift to the
//        guard that sets `close`, the growth limit, the complex division's
//        denominator) the warp's lanes compute ahead, a row each
//        (solve_prep_gep); the chain keeps the numerators, the rescale and
//        the division's last step (solve_fin_gep).  Every operation of the
//        solve is rounded on its own (eig_solve.cuh) in the twin's order,
//        so `close` equals the twin's bit for bit.  Where fac < 1 the warp
//        scales its vector (in global memory and its near copy) and the F
//        of its row block's rows still to come, as dtrevc3 scales the
//        right-hand side.
// Shared memory is fixed (kSmemBytes, about 193 KB) at every n.  Every sum
// runs in an order fixed by the shape, so two launches give the same bits;
// the sums run in another order than the twin's.
// On a column shard (parallel/dm_eig.py): S is the diagonal block of the
// rows the shard solves, a vector whose block lies past them has pos = n
// (every row solved), f0r/f0i give each vector's far sum from the columns
// past n, added to the row block's far product scaled by the vector's
// product of scalings so far (dtrevc3 scales the right-hand side with the
// vector), and scale returns that product.
#include <cuda_runtime.h>

#include "eig_blocked.cuh"

namespace {

constexpr int kPre = 12;    // doubles a solve step computes ahead (solve_prep_gep)

// shared memory (doubles): the near tiles of S and T, each warp's near x
// (Re, Im), F, the warps' slices of F, each warp's solve steps computed
// ahead; then the row block's kinds
constexpr int kSmemDoubles =
    2 * kNB * kLdN + kG * 2 * kNB + kVecs * kNB + kG * kVecs * kNB + kG * kNB * kPre;
constexpr size_t kSmemBytes = sizeof(double) * kSmemDoubles + sizeof(int) * kNB;
static_assert(kSmemBytes <= 232448, "E2's shared memory passes the H100's 227 KB");

struct SolveGep {
  const double *S, *T;
  int n, m;
  const double *ar, *ai, *bt, *smin;
  const int *pos, *pair, *kind, *order;  // kind: 0 a 1x1 row, 1 a 2x2 block's first, 2 its second
  double omega, smlnum;
  double *xr, *xi;
  int* close;
  const double *f0r, *f0i;  // null, or each vector's far sum from rows past n (m x n)
  double* scale;            // null, or each vector's product of the scalings (m)
};

// M[k, j] = bt S[k, j] - (ar + i ai) T[k, j], rounded as the twin's mentry
DEVI void mentry(double bt, double ar, double ai, double s, double t, double& mr,
                 double& mi) {
  mr = rsub(rmul(bt, s), rmul(ar, t));
  mi = rmul(-ai, t);
}

// (fr, fi) = M x from (sr, si) = S x and (tr, ti) = T x; the order of
// testing/backsolve_blocked.py:combine
DEVI void combine(double bt, double ar, double ai, double sr, double si, double tr, double ti,
                  double& fr, double& fi) {
  fr = bt * sr - ar * tr + ai * ti;
  fi = bt * si - ar * ti - ai * tr;
}

// What the guarded solve of a 1x1 row i (two false) or of a 2x2 block's
// rows i, i + 1 of the row block takes from S, T, alpha, beta and smin
// alone, with the twin's operations in the twin's order: M's diagonal entry
// or the block's determinant, lifted to the guard where below it (close),
// the growth limit den omega, the complex division's denominator part, and
// for a 2x2 block its four complex entries.
// pre[0] lim, [1] big, [2] r, [3] den, [4..11] a11, a12, a21, a22 (Re, Im)
DEVI void solve_prep_gep(const double* sNS, const double* sNT, int i, bool two, double bt,
                         double ar, double ai, double smin, double omega, double smlnum,
                         double* pre, bool& close) {
  const int ii = i * kLdN + i;
  CdivDen d;
  double lim;
  if (!two) {
    double dr, di;
    mentry(bt, ar, ai, sNS[ii], sNT[ii], dr, di);
    double dabs = radd(fabs(dr), fabs(di));
    if (dabs < smin) {
      dr = smin;
      di = 0.0;
      close = true;
    }
    dabs = dmax(dabs, smin);
    lim = rmul(dabs, omega);
    d = cdiv_den(dr, di, smlnum);
  } else {
    // the complex 2x2 block (M[k+1, k] stays a formula although T[k+1, k]
    // = 0, as in the twin)
    double a11r, a11i, a12r, a12i, a21r, a21i, a22r, a22i;
    mentry(bt, ar, ai, sNS[ii], sNT[ii], a11r, a11i);
    mentry(bt, ar, ai, sNS[ii + 1], sNT[ii + 1], a12r, a12i);
    mentry(bt, ar, ai, sNS[ii + kLdN], sNT[ii + kLdN], a21r, a21i);
    mentry(bt, ar, ai, sNS[ii + kLdN + 1], sNT[ii + kLdN + 1], a22r, a22i);
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
    lim = rmul(detabs, omega);
    d = cdiv_den(detr, deti, smlnum);
    pre[4] = a11r;
    pre[5] = a11i;
    pre[6] = a12r;
    pre[7] = a12i;
    pre[8] = a21r;
    pre[9] = a21i;
    pre[10] = a22r;
    pre[11] = a22i;
  }
  pre[0] = lim;
  pre[1] = d.big ? 1.0 : 0.0;
  pre[2] = d.r;
  pre[3] = d.den;
}

// The rest of the guarded solve on the chain, from the right-hand sides
// rhs = -(the rows' sums): returns fac and sets x[k] (and x[k + 1])
DEVI double solve_fin_gep(const double* pre, bool two, double smlnum, double rhs_r,
                          double rhs_i, double rhs2_r, double rhs2_i, double& v1r, double& v1i,
                          double& v2r, double& v2i) {
  CdivDen d;
  d.big = pre[1] != 0.0;
  d.r = pre[2];
  d.den = pre[3];
  if (!two) {
    const double fac = rescale_lim(radd(fabs(rhs_r), fabs(rhs_i)), pre[0], smlnum);
    cdiv_fin(rmul(rhs_r, fac), rmul(rhs_i, fac), d, v1r, v1i);
    return fac;
  }
  const double a11r = pre[4], a11i = pre[5], a12r = pre[6], a12i = pre[7];
  const double a21r = pre[8], a21i = pre[9], a22r = pre[10], a22i = pre[11];
  // x_k = (a22 r1 - a12 r2) / det ; x_k1 = (a11 r2 - a21 r1) / det
  const double n1r = rsub(rsub(rmul(a22r, rhs_r), rmul(a22i, rhs_i)),
                          rsub(rmul(a12r, rhs2_r), rmul(a12i, rhs2_i)));
  const double n1i = rsub(radd(rmul(a22r, rhs_i), rmul(a22i, rhs_r)),
                          radd(rmul(a12r, rhs2_i), rmul(a12i, rhs2_r)));
  const double n2r = rsub(rsub(rmul(a11r, rhs2_r), rmul(a11i, rhs2_i)),
                          rsub(rmul(a21r, rhs_r), rmul(a21i, rhs_i)));
  const double n2i = rsub(radd(rmul(a11r, rhs2_i), rmul(a11i, rhs2_r)),
                          radd(rmul(a21r, rhs_i), rmul(a21i, rhs_r)));
  const double nmax = dmax(radd(fabs(n1r), fabs(n1i)), radd(fabs(n2r), fabs(n2i)));
  const double fac = rescale_lim(nmax, pre[0], smlnum);
  cdiv_fin(rmul(n1r, fac), rmul(n1i, fac), d, v1r, v1i);
  cdiv_fin(rmul(n2r, fac), rmul(n2i, fac), d, v2r, v2i);
  return fac;
}

__global__ void __launch_bounds__(kThreads, 1) eig_backsolve_gep_kernel(SolveGep p) {
  extern __shared__ double sm[];
  double* sNS = sm;                       // kNB x kLdN: S[r0:r1, r0:r1]
  double* sNT = sNS + kNB * kLdN;         // kNB x kLdN: T[r0:r1, r0:r1]
  double* sX = sNT + kNB * kLdN;          // kG x 2 x kNB: each warp's x[r0:r1] (Re, Im)
  double* sF = sX + kG * 2 * kNB;         // kVecs x kNB: F, vector 2 g + (0 Re | 1 Im)
  double* sR = sF + kVecs * kNB;          // kG x kVecs x kNB: the warps' slices of F
  double* sP = sR + kG * kVecs * kNB;     // kG x kNB x kPre: the solve steps ahead
  int* sK = reinterpret_cast<int*>(sP + kG * kNB * kPre);  // kNB: the row kinds
  __shared__ int s_top;
  __shared__ double s_sc[kG];  // each warp's product of its scalings so far
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int n = p.n;
  const int slot = blockIdx.x * kG + warp;
  const bool live = slot < p.m;
  const int e = live ? p.order[slot] : 0;
  const int pe = live ? p.pos[e] : -1;
  const bool pair = live && p.pair[e] != 0;
  const int hi_e = min(n, pe + 2);  // x[e] is zero from pos + 2 on
  if (tid == 0) {
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
  bool close = false;
  double sc = 1.0;
  double* xnr = sX + warp * 2 * kNB;
  double* xni = xnr + kNB;
  double* fr = sF + (2 * warp) * kNB;
  double* fi = fr + kNB;
  double* pre = sP + warp * kNB * kPre;
  const double omega = p.omega, smlnum = p.smlnum;

  // the far product's fragments: A's row of each DMMA tile, B's vector; the
  // member whose Re and Im columns this lane's accumulators hold, and its
  // alpha and beta
  const int fm = lane >> 2, fk = lane & 3;
  const double* bvec[2];
  double cbt[2], car[2], cai[2];
#pragma unroll
  for (int nt = 0; nt < 2; ++nt) {
    const int v = 8 * nt + fm, g = v >> 1, s = blockIdx.x * kG + g;
    const bool ok = s < p.m && ((v & 1) == 0 || p.pair[p.order[s]] != 0);
    bvec[nt] = ok ? ((v & 1) ? p.xi : p.xr) + (size_t)p.order[s] * n : nullptr;
    const int sm_ = blockIdx.x * kG + 4 * nt + fk;
    const int ec = sm_ < p.m ? p.order[sm_] : -1;
    cbt[nt] = ec >= 0 ? p.bt[ec] : 0.0;
    car[nt] = ec >= 0 ? p.ar[ec] : 0.0;
    cai[nt] = ec >= 0 ? p.ai[ec] : 0.0;
  }

  for (int r1 = top; r1 > 0;) {
    const int r0 = row_block_start(p.kind, r1);
    const int nr = r1 - r0;
    // stage the row block: S's and T's near tiles, the kinds, each warp's near x
    for (int i = warp; i < nr; i += kG)
      for (int jj = lane; jj < nr; jj += 32) {
        const size_t at = (size_t)(r0 + i) * n + r0 + jj;
        sNS[i * kLdN + jj] = __ldg(p.S + at);
        sNT[i * kLdN + jj] = __ldg(p.T + at);
      }
    for (int i = tid; i < nr; i += kThreads) sK[i] = p.kind[r0 + i];
    for (int i = lane; i < nr; i += 32) {
      xnr[i] = live ? xr[r0 + i] : 0.0;
      xni[i] = pair ? xi[r0 + i] : 0.0;
    }

    // far: warp w's slice of FS = S[r0:r1, r1:hi] X and FT = T[r0:r1, r1:hi] X,
    // k-steps w, w + kG, ... of 4 columns; then its slice of F = M X
    {
      const size_t row0 = (size_t)(r0 + fm) * n;
      double accS[kMT][2][2], accT[kMT][2][2];
#pragma unroll
      for (int mt = 0; mt < kMT; ++mt)
#pragma unroll
        for (int nt = 0; nt < 2; ++nt)
          accS[mt][nt][0] = accS[mt][nt][1] = accT[mt][nt][0] = accT[mt][nt][1] = 0.0;
      const int k4 = (hi - r1 + 3) / 4;
      for (int s0 = warp; s0 < k4; s0 += kG) {
        // a k-step's 18 loads in flight (E1 has two k-steps of 10: the
        // accumulators of FS and FT leave no registers for a second)
        const int col = r1 + 4 * s0 + fk;
        const bool ok = col < hi;
        double as[kMT], at[kMT], b[2];
#pragma unroll
        for (int mt = 0; mt < kMT; ++mt) {
          const bool okr = ok && 8 * mt + fm < nr;
          const size_t idx = row0 + (size_t)(8 * mt) * n + col;
          as[mt] = okr ? __ldg(p.S + idx) : 0.0;
          at[mt] = okr ? __ldg(p.T + idx) : 0.0;
        }
#pragma unroll
        for (int nt = 0; nt < 2; ++nt) b[nt] = ok && bvec[nt] ? bvec[nt][col] : 0.0;
#pragma unroll
        for (int mt = 0; mt < kMT; ++mt)
#pragma unroll
          for (int nt = 0; nt < 2; ++nt) {
            dmma(accS[mt][nt], as[mt], b[nt]);
            dmma(accT[mt][nt], at[mt], b[nt]);
          }
      }
      double* red = sR + warp * kVecs * kNB;
#pragma unroll
      for (int mt = 0; mt < kMT; ++mt)
#pragma unroll
        for (int nt = 0; nt < 2; ++nt) {
          double f_r, f_i;
          combine(cbt[nt], car[nt], cai[nt], accS[mt][nt][0], accS[mt][nt][1], accT[mt][nt][0],
                  accT[mt][nt][1], f_r, f_i);
          red[(8 * nt + 2 * fk) * kNB + 8 * mt + fm] = f_r;
          red[(8 * nt + 2 * fk + 1) * kNB + 8 * mt + fm] = f_i;
        }
    }
    if (lane == 0) s_sc[warp] = sc;
    __syncthreads();
    for (int idx = tid; idx < kVecs * kNB; idx += kThreads) {
      double s = sR[idx];
      for (int w = 1; w < kG; ++w) s += sR[w * kVecs * kNB + idx];
      if (p.f0r != nullptr) {
        // the far sum from rows past n, scaled with the vector so far
        const int v = idx / kNB, i = idx % kNB, g = v >> 1, slot = blockIdx.x * kG + g;
        if (i < nr && slot < p.m) {
          const double* f0 = (v & 1) ? p.f0i : p.f0r;
          s += s_sc[g] * f0[(size_t)p.order[slot] * n + r0 + i];
        }
      }
      sF[idx] = s;
    }
    // each warp's solve steps ahead of its chain, a lane a row
    for (int i = lane; i < nr && live; i += 32)
      if (sK[i] != 2 && r0 + i < pe)
        solve_prep_gep(sNS, sNT, i, sK[i] == 1, bt, ar, ai, smin, omega, smlnum,
                       pre + i * kPre, close);
    __syncthreads();

    // near: each warp its eigenvalue's chain over the row block
    for (int k = r1 - 1; k >= r0 && live; --k) {
      const int i = k - r0;
      const int kd = sK[i];
      if (kd == 2) continue;  // a 2x2 block's rows are solved at its first
      if (k >= pe) continue;
      const bool two = kd == 1;
      double s1r = 0.0, s1i = 0.0, t1r = 0.0, t1i = 0.0;
      double s2r = 0.0, s2i = 0.0, t2r = 0.0, t2i = 0.0;
      for (int l = i + 1 + lane; l < nr; l += 32) {
        const double a = xnr[l], b = xni[l];
        const double s1 = sNS[i * kLdN + l], t1 = sNT[i * kLdN + l];
        s1r += s1 * a;
        s1i += s1 * b;
        t1r += t1 * a;
        t1i += t1 * b;
        if (two && l > i + 1) {
          const double s2 = sNS[(i + 1) * kLdN + l], t2 = sNT[(i + 1) * kLdN + l];
          s2r += s2 * a;
          s2i += s2 * b;
          t2r += t2 * a;
          t2i += t2 * b;
        }
      }
      double d1r, d1i, d2r, d2i;
      combine(bt, ar, ai, s1r, s1i, t1r, t1i, d1r, d1i);
      combine(bt, ar, ai, s2r, s2i, t2r, t2i, d2r, d2i);
      for (int off = 16; off > 0; off >>= 1) {
        d1r += __shfl_xor_sync(kFull, d1r, off);
        d1i += __shfl_xor_sync(kFull, d1i, off);
        d2r += __shfl_xor_sync(kFull, d2r, off);
        d2i += __shfl_xor_sync(kFull, d2i, off);
      }
      d1r = fr[i] + d1r;
      d1i = fi[i] + d1i;
      if (two) {
        d2r = fr[i + 1] + d2r;
        d2i = fi[i + 1] + d2i;
      }
      double v1r, v1i, v2r = 0.0, v2i = 0.0;
      const double fac = solve_fin_gep(pre + i * kPre, two, smlnum, -d1r, -d1i, -d2r, -d2i, v1r,
                                       v1i, v2r, v2i);
      if (fac != 1.0) {
        // scale the vector, and F of the rows still to come, before the
        // growing division's result joins it
        sc = rmul(sc, fac);
        for (int l = k + 1 + lane; l < hi_e; l += 32) {
          const double vr = rmul(xr[l], fac);
          xr[l] = vr;
          if (l < r1) xnr[l - r0] = vr;
          if (pair) {
            const double vi = rmul(xi[l], fac);
            xi[l] = vi;
            if (l < r1) xni[l - r0] = vi;
          }
        }
        for (int ii = lane; ii < i; ii += 32) {
          fr[ii] = rmul(fr[ii], fac);
          fi[ii] = rmul(fi[ii], fac);
        }
      }
      __syncwarp();
      if (lane == 0) {
        // a real eigenvalue's xi stays zero
        xr[k] = xnr[i] = v1r;
        if (pair) xi[k] = xni[i] = v1i;
        if (two) {
          xr[k + 1] = xnr[i + 1] = v2r;
          if (pair) xi[k + 1] = xni[i + 1] = v2i;
        }
      }
      __syncwarp();
    }
    __syncthreads();  // x[r0:r1] is in global memory for the next far product
    r1 = r0;
  }
  close = __any_sync(kFull, close);
  if (live && lane == 0) {
    p.close[e] = close ? 1 : 0;
    if (p.scale != nullptr) p.scale[e] = sc;
  }
}

}  // namespace

// x[e, :] for the m eigenvalues of the pencil (S, T) (n x n each), in
// place; close[e] 1 where a guard lifted a shifted diagonal or
// determinant.  order: the eigenvalues sorted by pos, descending (a block
// takes kG consecutive ones); pos = n: the block lies past the rows
// solved here (a column shard's rows of the pencil), every row is solved.
// f0r, f0i (null or m x n): each vector's sum over the columns past n,
// scaled with the vector; scale (null or m): each vector's product of its
// scalings out.
extern "C" int eig_backsolve_gep(const void* S, const void* T, int n, const void* ar,
                                 const void* ai, const void* bt, const void* smin,
                                 const void* pos, const void* pair, const void* kind,
                                 const void* order, int m, double omega, double smlnum,
                                 void* xr, void* xi, void* close, const void* f0r,
                                 const void* f0i, void* scale, void* stream) {
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
  p.f0r = static_cast<const double*>(f0r);
  p.f0i = static_cast<const double*>(f0i);
  p.scale = static_cast<double*>(scale);
  cudaError_t err = cudaFuncSetAttribute(eig_backsolve_gep_kernel,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(kSmemBytes));
  if (err != cudaSuccess) return static_cast<int>(err);
  const int blocks = (m + kG - 1) / kG;
  eig_backsolve_gep_kernel<<<blocks, kThreads, kSmemBytes, static_cast<cudaStream_t>(stream)>>>(
      p);
  return static_cast<int>(cudaGetLastError());
}
