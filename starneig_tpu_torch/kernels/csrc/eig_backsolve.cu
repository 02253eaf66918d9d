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
// What bounds it on the H100: the chain of dependent row steps (each row
// needs every entry solved below it), about one step a 1x1 or 2x2 block of
// the rows above the highest selected block, and the dots: row k of
// eigenvalue e sums S[k, k+1 : pos+2] x[e, k+1 : pos+2], about m n^2 / 3
// products for eigenvalues spread over the diagonal.
// Design: LAPACK dtrevc3's blocked backsolve.  A block takes a group of kG
// eigenvalues (the wrapper sorts them by pos, descending, so a group's
// rows cover similar ranges) and walks its rows in row blocks of at most
// kNB, from the group's largest pos down to row 0; a boundary that would
// split a 2x2 block moves up one row.  For the row block [r0, r1):
//   far  the part of every row's sum that comes from rows already solved,
//        F[r0:r1, g] = S[r0:r1, r1:hi] X[r1:hi, g], for the group's 2 kG
//        vectors (real and imaginary parts) at once: a product of width
//        2 kG on the double-precision tensor cores (mma.sync m8n8k4,
//        fragments loaded straight from global memory: S through the
//        read-only path, X, which the block itself writes, plainly, after
//        a block barrier), each warp a slice of the columns, the slices
//        added in warp order through shared memory;
//   near each warp its eigenvalue's chain, rows r1 - 1 down to r0: the
//        dot over x[k+1 : r1) (at most kNB - 1 entries, S's row block and
//        x's entries in shared memory, lanes across the entries, a fixed
//        xor-shuffle sum) added to F, then the guarded 1x1 or 2x2 solve of
//        eig_solve.cuh, every operation rounded on its own as the twin's
//        torch ops round it, so the guards' decisions (near, near2: they
//        read S and lambda alone) equal the twin's bit for bit.  What the
//        solve takes from S and lambda alone (the guarded shifted diagonal
//        or determinant, the growth limit, the complex division's
//        denominator) the warp's lanes compute ahead, a row each
//        (solve_prep); the chain keeps the rest (solve_fin).  Where fac < 1
//        the warp scales its vector and the F of its row block's rows
//        still to come (dtrevc3 scales the right-hand side so).
// Only the short near dot and the right-hand side's part of the solve stay
// on the chain; the far product runs between row blocks on the whole
// block.
// Choices: kG = 8 eigenvalues a block (a warp each for the chains; the
// leading block of n = 4000's chain has 1,020 eigenvalues, 128 blocks on
// 132 SMs; the product is 16 vectors wide, two 8-wide DMMA tiles); kNB =
// 64 rows (eight 8-row DMMA tiles: a warp's k-step loads 10 fragments for
// 16 products, and S's tiles are read once for the group; the near dot is
// at most 63 entries, two a lane).  Every sum runs in an order fixed by the
// shape, so two launches give the same bits; the sums run in another
// order than the twin's matmul.
// On a column shard (parallel/dm_eig.py): S is the diagonal block of the
// rows the shard solves, a vector whose block lies past them has pos = n
// (every row solved), f0r/f0i give each vector's far sum from the columns
// past n, added to the row block's far product scaled by the vector's
// product of scalings so far (dtrevc3 scales the right-hand side with the
// vector), and scale returns that product.
#include <cuda_runtime.h>

#include "eig_blocked.cuh"

namespace {

constexpr int kSteps = 2;          // k-steps of 4 columns a warp has in flight

// shared memory (doubles): the near tile, each warp's near x (Re, Im), F,
// the warps' slices of F, each warp's solve steps computed ahead; then the
// row block's kinds
constexpr int kPre = 8;           // doubles a solve step computes ahead (solve_prep)
constexpr int kSmemDoubles =
    kNB * kLdN + kG * 2 * kNB + kVecs * kNB + kG * kVecs * kNB + kG * kNB * kPre;
constexpr size_t kSmemBytes = sizeof(double) * kSmemDoubles + sizeof(int) * kNB;

struct Solve {
  const double* S;
  int n, m;
  const double *lam_r, *lam_i, *smin;
  const int *pos, *pair, *kind, *order;  // kind: 0 a 1x1 row, 1 a 2x2 block's first, 2 its second
  double omega, smlnum;
  double *xr, *xi;
  int* close;
  const double *f0r, *f0i;  // null, or each vector's far sum from rows past n (m x n)
  double* scale;            // null, or each vector's product of the scalings (m)
};

// What the guarded solve of a 1x1 row k (two false) or of a 2x2 block's
// rows k, k + 1 takes from S and lambda alone, computed ahead of the chain
// with the twin's operations in the twin's order: the shifted diagonal or
// determinant, lifted to the guard where below it (close), the growth
// limit den omega, the complex division's denominator part, and for a 2x2
// block the entries of M = S - lambda I that the right-hand sides meet.
// pre[0] lim, [1] big, [2] r, [3] den, [4] m11r, [5] m22r, [6] m12, [7] m21
__device__ __forceinline__ void solve_prep(const double* sN, int i, bool two, double lr,
                                           double li, double smin, double omega, double smlnum,
                                           double* pre, bool& close) {
  const double skk = sN[i * kLdN + i];
  CdivDen d;
  double lim;
  if (!two) {
    double dr = rsub(skk, lr), di = -li;
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
    const double m11r = rsub(skk, lr), m11i = -li;
    const double m22r = rsub(sN[(i + 1) * kLdN + i + 1], lr), m22i = -li;
    const double m12 = sN[i * kLdN + i + 1], m21 = sN[(i + 1) * kLdN + i];
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
    lim = rmul(detabs, omega);
    d = cdiv_den(detr, deti, smlnum);
    pre[4] = m11r;
    pre[5] = m22r;
    pre[6] = m12;
    pre[7] = m21;
  }
  pre[0] = lim;
  pre[1] = d.big ? 1.0 : 0.0;
  pre[2] = d.r;
  pre[3] = d.den;
}

// The rest of the guarded solve on the chain, from the right-hand sides
// rhs = -(the rows' dots): returns fac and sets x[k] (and x[k + 1])
__device__ __forceinline__ double solve_fin(const double* pre, bool two, double li, double smlnum,
                                            double rhs_r, double rhs_i, double rhs2_r,
                                            double rhs2_i, double& v1r, double& v1i,
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
  const double m11r = pre[4], m22r = pre[5], m12 = pre[6], m21 = pre[7];
  const double m11i = -li, m22i = -li;
  // x_k = (m22 r1 - m12 r2) / det ; x_k1 = (m11 r2 - m21 r1) / det
  const double n1r = rsub(rsub(rmul(m22r, rhs_r), rmul(m22i, rhs_i)), rmul(m12, rhs2_r));
  const double n1i = rsub(radd(rmul(m22r, rhs_i), rmul(m22i, rhs_r)), rmul(m12, rhs2_i));
  const double n2r = rsub(rsub(rmul(m11r, rhs2_r), rmul(m11i, rhs2_i)), rmul(m21, rhs_r));
  const double n2i = rsub(radd(rmul(m11r, rhs2_i), rmul(m11i, rhs2_r)), rmul(m21, rhs_i));
  const double nmax = dmax(radd(fabs(n1r), fabs(n1i)), radd(fabs(n2r), fabs(n2i)));
  const double fac = rescale_lim(nmax, pre[0], smlnum);
  cdiv_fin(rmul(n1r, fac), rmul(n1i, fac), d, v1r, v1i);
  cdiv_fin(rmul(n2r, fac), rmul(n2i, fac), d, v2r, v2i);
  return fac;
}

__global__ void __launch_bounds__(kThreads, 1) eig_backsolve_kernel(Solve p) {
  extern __shared__ double sm[];
  double* sN = sm;                        // kNB x kLdN: S[r0:r1, r0:r1]
  double* sX = sN + kNB * kLdN;           // kG x 2 x kNB: each warp's x[r0:r1] (Re, Im)
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
  const double lr = live ? p.lam_r[e] : 0.0, li = live ? p.lam_i[e] : 0.0;
  const double smin = live ? p.smin[e] : 1.0;
  bool close = false;
  double sc = 1.0;
  double* xnr = sX + warp * 2 * kNB;
  double* xni = xnr + kNB;
  double* fr = sF + (2 * warp) * kNB;
  double* fi = fr + kNB;
  double* pre = sP + warp * kNB * kPre;
  const double omega = p.omega, smlnum = p.smlnum;

  // the far product's fragments: A's row of each DMMA tile, B's vector
  const int ar = lane >> 2, ak = lane & 3;
  const double* bvec[2];
#pragma unroll
  for (int nt = 0; nt < 2; ++nt) {
    const int v = 8 * nt + ar, g = v >> 1, s = blockIdx.x * kG + g;
    const bool ok = s < p.m && ((v & 1) == 0 || p.pair[p.order[s]] != 0);
    bvec[nt] = ok ? ((v & 1) ? p.xi : p.xr) + (size_t)p.order[s] * n : nullptr;
  }

  for (int r1 = top; r1 > 0;) {
    const int r0 = row_block_start(p.kind, r1);
    const int nr = r1 - r0;
    // stage the row block: S's near tile, the kinds, each warp's near x
    for (int i = warp; i < nr; i += kG)
      for (int jj = lane; jj < nr; jj += 32)
        sN[i * kLdN + jj] = __ldg(p.S + (size_t)(r0 + i) * n + r0 + jj);
    for (int i = tid; i < nr; i += kThreads) sK[i] = p.kind[r0 + i];
    for (int i = lane; i < nr; i += 32) {
      xnr[i] = live ? xr[r0 + i] : 0.0;
      xni[i] = pair ? xi[r0 + i] : 0.0;
    }

    // far: warp w's slice of F = S[r0:r1, r1:hi] X[r1:hi, :], k-steps w,
    // w + kG, ... of 4 columns
    {
      const double* arow[kMT];
#pragma unroll
      for (int mt = 0; mt < kMT; ++mt)
        arow[mt] = 8 * mt + ar < nr ? p.S + (size_t)(r0 + 8 * mt + ar) * n : nullptr;
      double acc[kMT][2][2];
#pragma unroll
      for (int mt = 0; mt < kMT; ++mt)
#pragma unroll
        for (int nt = 0; nt < 2; ++nt) acc[mt][nt][0] = acc[mt][nt][1] = 0.0;
      const int k4 = (hi - r1 + 3) / 4;
      for (int s0 = warp; s0 < k4; s0 += kG * kSteps) {
        double a[kSteps][kMT], b[kSteps][2];
#pragma unroll
        for (int u = 0; u < kSteps; ++u) {
          const int col = r1 + 4 * (s0 + u * kG) + ak;
          const bool ok = s0 + u * kG < k4 && col < hi;
#pragma unroll
          for (int mt = 0; mt < kMT; ++mt) a[u][mt] = ok && arow[mt] ? __ldg(arow[mt] + col) : 0.0;
#pragma unroll
          for (int nt = 0; nt < 2; ++nt) b[u][nt] = ok && bvec[nt] ? bvec[nt][col] : 0.0;
        }
#pragma unroll
        for (int u = 0; u < kSteps; ++u)
#pragma unroll
          for (int mt = 0; mt < kMT; ++mt)
#pragma unroll
            for (int nt = 0; nt < 2; ++nt) dmma(acc[mt][nt], a[u][mt], b[u][nt]);
      }
      double* red = sR + warp * kVecs * kNB;
#pragma unroll
      for (int mt = 0; mt < kMT; ++mt)
#pragma unroll
        for (int nt = 0; nt < 2; ++nt)
#pragma unroll
          for (int i = 0; i < 2; ++i) red[(8 * nt + 2 * ak + i) * kNB + 8 * mt + ar] = acc[mt][nt][i];
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
        solve_prep(sN, i, sK[i] == 1, lr, li, smin, omega, smlnum, pre + i * kPre, close);
    __syncthreads();

    // near: each warp its eigenvalue's chain over the row block
    for (int k = r1 - 1; k >= r0 && live; --k) {
      const int i = k - r0;
      const int kd = sK[i];
      if (kd == 2) continue;  // a 2x2 block's rows are solved at its first
      if (k >= pe) continue;
      const bool two = kd == 1;
      double d1r = 0.0, d1i = 0.0, d2r = 0.0, d2i = 0.0;
      for (int l = i + 1 + lane; l < nr; l += 32) {
        const double a = xnr[l], b = xni[l];
        const double s1 = sN[i * kLdN + l];
        d1r += a * s1;
        d1i += b * s1;
        if (two && l > i + 1) {
          const double s2 = sN[(i + 1) * kLdN + l];
          d2r += a * s2;
          d2i += b * s2;
        }
      }
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
      const double fac =
          solve_fin(pre + i * kPre, two, li, smlnum, -d1r, -d1i, -d2r, -d2i, v1r, v1i, v2r, v2i);
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
        xr[k] = xnr[i] = v1r;
        xi[k] = v1i;
        xni[i] = pair ? v1i : 0.0;
        if (two) {
          xr[k + 1] = xnr[i + 1] = v2r;
          xi[k + 1] = v2i;
          xni[i + 1] = pair ? v2i : 0.0;
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

// x[e, :] for the m eigenvalues of S (n x n), in place; close[e] 1 where a
// guard lifted a shifted diagonal or determinant.  order: the eigenvalues
// sorted by pos, descending (a block takes kG consecutive ones); pos = n:
// the block lies past the rows solved here (a column shard's rows of S),
// every row is solved.  f0r, f0i (null or m x n): each vector's sum over
// the columns past n, scaled with the vector; scale (null or m): each
// vector's product of its scalings out.
extern "C" int eig_backsolve(const void* S, int n, const void* lam_r, const void* lam_i,
                             const void* smin, const void* pos, const void* pair,
                             const void* kind, const void* order, int m, double omega,
                             double smlnum, void* xr, void* xi, void* close, const void* f0r,
                             const void* f0i, void* scale, void* stream) {
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
  p.f0r = static_cast<const double*>(f0r);
  p.f0i = static_cast<const double*>(f0i);
  p.scale = static_cast<double*>(scale);
  cudaError_t err = cudaFuncSetAttribute(eig_backsolve_kernel,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(kSmemBytes));
  if (err != cudaSuccess) return static_cast<int>(err);
  const int blocks = (m + kG - 1) / kG;
  eig_backsolve_kernel<<<blocks, kThreads, kSmemBytes, static_cast<cudaStream_t>(stream)>>>(p);
  return static_cast<int>(cudaGetLastError());
}
