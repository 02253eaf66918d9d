// Scalar device primitives shared by the Schur kernels (fp64).
//
// Device twins of starneig_tpu_torch/ops/primitives.py and ops/swaps.py:
// the same formulas, the same guards (sdiv maps a zero denominator to 0,
// sgn(0) == +1, householder pre-scales by max|x|), so each kernel's control
// flow matches its plain PyTorch version step for step.  The scalar
// functions run on one thread over registers; the block_* functions on a
// whole block, the *_warp functions on a whole warp.
#pragma once

#include <cuda_runtime.h>
#include <float.h>
#include <math.h>

#define DEVI __device__ __forceinline__

DEVI double sdiv(double num, double den) { return den != 0.0 ? num / den : 0.0; }

DEVI double sgn(double x) { return x >= 0.0 ? 1.0 : -1.0; }

DEVI double dmax(double a, double b) { return a >= b ? a : b; }

DEVI double dmin(double a, double b) { return a <= b ? a : b; }

DEVI int clampi(int x, int lo, int hi) { return x < lo ? lo : (x > hi ? hi : x); }

DEVI double hypot2(double x, double y) {
  double ax = fabs(x), ay = fabs(y);
  double w = dmax(ax, ay), z = dmin(ax, ay);
  double r = sdiv(z, w);
  return w == 0.0 ? 0.0 : w * sqrt(1.0 + r * r);
}

// dlarfg on x[0..m) (m <= 4); bit i of mask marks entry i active.
DEVI void householder(const double* xin, unsigned mask, int m, double* v,
                      double& tau, double& beta) {
  double xs[4];
  double mx = 0.0;
  for (int i = 0; i < m; ++i) {
    xs[i] = ((mask >> i) & 1u) ? xin[i] : 0.0;
    mx = dmax(mx, fabs(xs[i]));
  }
  double msafe = mx == 0.0 ? 1.0 : mx;
  for (int i = 0; i < m; ++i) xs[i] = xs[i] / msafe;
  double alpha = xs[0];
  double ss = 0.0;
  for (int i = 1; i < m; ++i) ss += xs[i] * xs[i];
  double xnorm = sqrt(ss);
  double b = -sgn(alpha) * hypot2(alpha, xnorm);
  bool degen = xnorm == 0.0;
  tau = degen ? 0.0 : sdiv(b - alpha, b);
  double scale = sdiv(1.0, alpha - b);
  v[0] = 1.0;
  for (int i = 1; i < m; ++i)
    v[i] = (degen || !((mask >> i) & 1u)) ? 0.0 : xs[i] * scale;
  beta = (degen ? alpha : b) * msafe;
}

// ---------------------------------------------------------------------------
// block-wide reductions and reflector (every thread of the block calls them;
// red is __shared__ scratch of at least blockDim.x / 32 doubles)
// ---------------------------------------------------------------------------

DEVI double block_reduce(double v, double* red, bool is_max) {
  for (int o = 16; o > 0; o >>= 1) {
    const double u = __shfl_xor_sync(0xffffffffu, v, o);
    v = is_max ? dmax(v, u) : v + u;
  }
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  __syncthreads();  // the previous reduction's readers are done with red
  if (lane == 0) red[warp] = v;
  __syncthreads();
  v = red[0];
  for (int i = 1; i < (int)(blockDim.x >> 5); ++i)
    v = is_max ? dmax(v, red[i]) : v + red[i];
  return v;
}

// dlarfg on x[0..m) (m >= 1) in shared memory, the block-wide twin of
// householder() above and of ops/primitives.py:householder: pre-scaled by
// max|x|, sdiv guards on the zero denominators.  On return x holds v
// (v[0] == 1, v == 0 past x[0] when the tail is zero) and every thread
// holds tau and beta.  blockDim.x must be a multiple of 32.
DEVI void block_householder(double* x, int m, double* red, double& tau,
                            double& beta) {
  const int tid = threadIdx.x, nt = blockDim.x;
  double mx = 0.0;
  for (int i = tid; i < m; i += nt) mx = dmax(mx, fabs(x[i]));
  mx = block_reduce(mx, red, true);
  const double msafe = mx == 0.0 ? 1.0 : mx;
  double ss = 0.0;
  for (int i = tid; i < m; i += nt) {
    const double xs = x[i] / msafe;
    if (i >= 1) ss += xs * xs;  // x[0] is alpha, outside the tail norm
  }
  ss = block_reduce(ss, red, false);
  const double alpha = x[0] / msafe;
  const double xnorm = sqrt(ss);
  const double b = -sgn(alpha) * hypot2(alpha, xnorm);
  const bool degen = xnorm == 0.0;
  tau = degen ? 0.0 : sdiv(b - alpha, b);
  const double scale = sdiv(1.0, alpha - b);
  beta = (degen ? alpha : b) * msafe;
  __syncthreads();  // every thread has read x[0]
  for (int i = tid; i < m; i += nt)
    x[i] = i == 0 ? 1.0 : (degen ? 0.0 : (x[i] / msafe) * scale);
  __syncthreads();
}

DEVI void givens(double f, double g, double& c, double& s, double& r) {
  double rmag = hypot2(f, g);
  double r0 = sgn(f) * rmag;
  double rsafe = r0 == 0.0 ? 1.0 : r0;
  c = g == 0.0 ? 1.0 : (f == 0.0 ? 0.0 : f / rsafe);
  s = g == 0.0 ? 0.0 : (f == 0.0 ? 1.0 : g / rsafe);
  r = g == 0.0 ? f : (f == 0.0 ? g : r0);
}

DEVI void eig2x2(double a, double b, double c, double d, double& l1r,
                 double& l1i, double& l2r, double& l2i) {
  double sc = fabs(a) + fabs(b) + fabs(c) + fabs(d);
  sc = sc == 0.0 ? 1.0 : sc;
  a /= sc; b /= sc; c /= sc; d /= sc;
  double p = 0.5 * (a - d);
  double bc = b * c;
  double disc = p * p + bc;
  double sq = sqrt(fabs(disc));
  double mid = 0.5 * (a + d);
  if (disc >= 0.0) {
    double z = p + sgn(p) * sq;
    l1r = d + z;
    l2r = z == 0.0 ? d : d - sdiv(bc, z);
    l1i = 0.0;
    l2i = 0.0;
  } else {
    l1r = mid;
    l2r = mid;
    l1i = sq;
    l2i = -sq;
  }
  l1r *= sc; l1i *= sc; l2r *= sc; l2i *= sc;
}

// dlanv2: out = {aa, bb, cc, dd, cs, sn}
DEVI void standardize_2x2(double a, double b, double c, double d, double* out) {
  double aa, bb, cc, dd, cs, sn;
  double temp0 = a - d;
  if (c == 0.0) {
    aa = a; bb = b; cc = c; dd = d; cs = 1.0; sn = 0.0;
  } else if (b == 0.0) {
    aa = d; bb = -c; cc = 0.0; dd = a; cs = 0.0; sn = 1.0;
  } else if (temp0 == 0.0 && sgn(b) != sgn(c)) {
    aa = a; bb = b; cc = c; dd = d; cs = 1.0; sn = 0.0;
  } else {
    double p0 = 0.5 * temp0;
    double bcmax = dmax(fabs(b), fabs(c));
    double bcmis = dmin(fabs(b), fabs(c)) * sgn(b) * sgn(c);
    double scale = dmax(fabs(p0), bcmax);
    double z0 = sdiv(p0, scale) * p0 + sdiv(bcmax, scale) * bcmis;
    if (z0 >= 4.0 * DBL_EPSILON) {
      double zr = p0 + sgn(p0) * sqrt(dmax(scale, 0.0)) * sqrt(dmax(z0, 0.0));
      aa = d + zr;
      dd = d - sdiv(bcmax, zr) * bcmis;
      double tau_r = hypot2(c, zr);
      cs = sdiv(zr, tau_r);
      sn = sdiv(c, tau_r);
      bb = b - c;
      cc = 0.0;
    } else {
      double sigma = b + c;
      double tau_c = hypot2(sigma, temp0);
      double cs_c = sqrt(0.5 * (1.0 + sdiv(fabs(sigma), tau_c)));
      double sn_c = -sdiv(p0, tau_c * cs_c) * sgn(sigma);
      double a0 = a * cs_c + b * sn_c;
      double b0 = -a * sn_c + b * cs_c;
      double c0 = c * cs_c + d * sn_c;
      double d0 = -c * sn_c + d * cs_c;
      double a1 = a0 * cs_c + c0 * sn_c;
      double b1 = b0 * cs_c + d0 * sn_c;
      double c1 = -a0 * sn_c + c0 * cs_c;
      double d1 = -b0 * sn_c + d0 * cs_c;
      double tmid = 0.5 * (a1 + d1);
      if (c1 != 0.0 && b1 != 0.0 && sgn(b1) == sgn(c1)) {
        double sab = sqrt(fabs(b1));
        double sac = sqrt(fabs(c1));
        double p1 = sgn(c1) * sab * sac;
        double tau1 = sdiv(1.0, sqrt(dmax(fabs(b1 + c1), DBL_MIN)));
        aa = tmid + p1;
        dd = tmid - p1;
        bb = b1 - c1;
        cc = 0.0;
        double cs1 = sab * tau1;
        double sn1 = sac * tau1;
        cs = cs_c * cs1 - sn_c * sn1;
        sn = cs_c * sn1 + sn_c * cs1;
      } else if (c1 != 0.0 && b1 == 0.0) {
        aa = tmid; dd = tmid; bb = -c1; cc = 0.0; cs = -sn_c; sn = cs_c;
      } else {
        aa = tmid; dd = tmid; bb = b1; cc = c1; cs = cs_c; sn = sn_c;
      }
    }
  }
  if (cc != 0.0) dd = aa;  // a standardized complex block has aa == dd
  out[0] = aa; out[1] = bb; out[2] = cc; out[3] = dd; out[4] = cs; out[5] = sn;
}

// dlaqr1 on the 3x3 block h (row-major); v gets 3 entries.
DEVI void first_column_shifted(const double* h, double sr1, double si1,
                               double sr2, double si2, bool use3, double* v) {
  double h11 = h[0], h12 = h[1], h13 = h[2];
  double h21 = h[3], h22 = h[4], h23 = h[5];
  double h31 = h[6], h32 = h[7], h33 = h[8];
  if (use3) {
    double s3 = fabs(h11 - sr2) + fabs(si2) + fabs(h21) + fabs(h31);
    double h21s3 = sdiv(h21, s3), h31s3 = sdiv(h31, s3);
    double v1 = (h11 - sr1) * sdiv(h11 - sr2, s3) - si1 * sdiv(si2, s3)
                + h12 * h21s3 + h13 * h31s3;
    double v2 = h21s3 * (h11 + h22 - sr1 - sr2) + h23 * h31s3;
    double v3 = h31s3 * (h11 + h33 - sr1 - sr2) + h21s3 * h32;
    bool z = s3 == 0.0;
    v[0] = z ? 0.0 : v1; v[1] = z ? 0.0 : v2; v[2] = z ? 0.0 : v3;
  } else {
    double s2 = fabs(h11 - sr2) + fabs(si2) + fabs(h21);
    double h21s2 = sdiv(h21, s2);
    double v1 = h21s2 * h12 + (h11 - sr1) * sdiv(h11 - sr2, s2)
                - si1 * sdiv(si2, s2);
    double v2 = h21s2 * (h11 + h22 - sr1 - sr2);
    bool z = s2 == 0.0;
    v[0] = z ? 0.0 : v1; v[1] = z ? 0.0 : v2; v[2] = 0.0;
  }
}

// ---------------------------------------------------------------------------
// adjacent block swap on a 4x4 (row-major, double[16]) on a warp; the twin
// of ops/swaps.py:swap_adjacent
// ---------------------------------------------------------------------------
// Every lane of a warp calls swap_adjacent_warp with the same D, p, q and
// gets the same Q, Dh and accept: the plain twin's formulas in its order.
// p and q become template arguments, so no array is indexed by a run-time
// value and every intermediate stays in registers; the 4x4 products run an
// entry a lane on 16 lanes and reach every lane by shuffles; the Sylvester
// elimination runs a row a lane on lanes 0..3, each step's pivot chosen from
// the four candidates gathered by shuffles.

DEVI void eye4(double* Q) {
  for (int i = 0; i < 16; ++i) Q[i] = (i % 5 == 0) ? 1.0 : 0.0;
}

DEVI double sel4(double v0, double v1, double v2, double v3, int i) {
  return i == 0 ? v0 : (i == 1 ? v1 : (i == 2 ? v2 : v3));
}

// C = A^T B (TN) or A B (row-major 4x4), an entry a lane, k in order
template <bool TN>
DEVI void matmul4_warp(const double* A, const double* B, double* C) {
  const int lane = threadIdx.x & 31, i = (lane >> 2) & 3, j = lane & 3;
  double s = 0.0;
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    const double a = TN ? sel4(A[k * 4], A[k * 4 + 1], A[k * 4 + 2], A[k * 4 + 3], i)
                        : sel4(A[k], A[4 + k], A[8 + k], A[12 + k], i);
    const double b = sel4(B[k * 4], B[k * 4 + 1], B[k * 4 + 2], B[k * 4 + 3], j);
    s += a * b;
  }
#pragma unroll
  for (int e = 0; e < 16; ++e) C[e] = __shfl_sync(0xffffffffu, s, e);
}

// solve4 with row r of M on the lanes r (mod 4)
DEVI void solve4_warp(const double* M /* 4x5 */, double* x) {
  const int r = threadIdx.x & 3;
  double m[5];
#pragma unroll
  for (int c = 0; c < 5; ++c) m[c] = sel4(M[c], M[5 + c], M[10 + c], M[15 + c], r);
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    const double val = r >= k ? fabs(m[k]) : -1.0;
    int piv = 0;
    double best = -2.0;
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const double vi = __shfl_sync(0xffffffffu, val, i);
      if (vi > best) { best = vi; piv = i; }
    }
    const int src = r == k ? piv : (r == piv ? k : r);
#pragma unroll
    for (int c = 0; c < 5; ++c) m[c] = __shfl_sync(0xffffffffu, m[c], src);
    double rowk[5];
#pragma unroll
    for (int c = 0; c < 5; ++c) rowk[c] = __shfl_sync(0xffffffffu, m[c], k);
    double pivval = rowk[k];
    pivval = pivval == 0.0 ? DBL_MIN : pivval;
    const double f = r == k ? 0.0 : m[k] / pivval;
#pragma unroll
    for (int c = 0; c < 5; ++c) m[c] = m[c] - f * rowk[c];
  }
  double dg = sel4(m[0], m[1], m[2], m[3], r);
  dg = dg == 0.0 ? DBL_MIN : dg;
  const double xr = m[4] / dg;
#pragma unroll
  for (int i = 0; i < 4; ++i) x[i] = __shfl_sync(0xffffffffu, xr, i);
}

DEVI bool swap_11_warp(const double* D, double* Q, double* Dh) {
  double t11 = D[0], t12 = D[1], t22 = D[5];
  double cs, sn, r;
  givens(t12, t22 - t11, cs, sn, r);
  eye4(Q);
  Q[0] = cs; Q[4] = sn; Q[1] = -sn; Q[5] = cs;
  double T[16];
  matmul4_warp<true>(Q, D, T);
  matmul4_warp<false>(T, Q, Dh);
  Dh[0] = t22; Dh[5] = t11; Dh[4] = 0.0;
  return true;
}

template <int P, int Qn>
DEVI bool swap_general_warp(const double* D, double* Q, double* Dh) {
  constexpr int d = P + Qn;
  double T11[4] = {0, 0, 0, 0}, T22[4] = {0, 0, 0, 0}, T12[4] = {0, 0, 0, 0};
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < 2; ++j) {
      if (i < P && j < P) T11[i * 2 + j] = D[i * 4 + j];
      if (i < Qn && j < Qn) T22[i * 2 + j] = D[(P + i) * 4 + P + j];
      if (i < P && j < Qn) T12[i * 2 + j] = D[i * 4 + P + j];
    }
  double M[20];
#pragma unroll
  for (int i = 0; i < 20; ++i) M[i] = 0.0;
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    const int i = k % 2, j = k / 2;
    if (i < P && j < Qn) {
      M[k * 5 + 2 * j + 0] += T11[i * 2 + 0];
      M[k * 5 + 2 * j + 1] += T11[i * 2 + 1];
      M[k * 5 + 0 + i] += -T22[0 * 2 + j];
      M[k * 5 + 2 + i] += -T22[1 * 2 + j];
      M[k * 5 + 4] = -T12[i * 2 + j];
    } else {
      M[k * 5 + k] = 1.0;
    }
  }
  double x[4];
  solve4_warp(M, x);
  double Mx[8];
#pragma unroll
  for (int r = 0; r < 4; ++r)
#pragma unroll
    for (int c = 0; c < 2; ++c) {
      double val = r < P ? x[2 * c + r] : 0.0;
      if (r >= P && r - P == c && c < Qn) val += 1.0;
      Mx[r * 2 + c] = val;
    }
  double col[4], v1[4], tau1, b1;
#pragma unroll
  for (int r = 0; r < 4; ++r) col[r] = Mx[r * 2 + 0];
  constexpr unsigned mask1 = (1u << d) - 1u;
  householder(col, mask1, 4, v1, tau1, b1);
  double w[2];
#pragma unroll
  for (int c = 0; c < 2; ++c) {
    double s = 0.0;
#pragma unroll
    for (int r = 0; r < 4; ++r) s += v1[r] * Mx[r * 2 + c];
    w[c] = s;
  }
  double M1c1[4];
#pragma unroll
  for (int r = 0; r < 4; ++r) M1c1[r] = Mx[r * 2 + 1] - tau1 * (v1[r] * w[1]);
  double x2[4], v2r[4], tau2, b2;
#pragma unroll
  for (int i = 0; i < 3; ++i) x2[i] = M1c1[i + 1];
  x2[3] = 0.0;
  constexpr unsigned mask2 = (d > 1 ? 1u : 0u) | (d > 2 ? 2u : 0u) | (d > 3 ? 4u : 0u);
  householder(x2, mask2, 4, v2r, tau2, b2);
  const double v2[4] = {v2r[3], v2r[0], v2r[1], v2r[2]};
  if (Qn <= 1) tau2 = 0.0;
  double Qa[16], Qb[16];
  eye4(Qa);
#pragma unroll
  for (int pass = 0; pass < 2; ++pass) {
    const double* v = pass == 0 ? v1 : v2;
    const double tau = pass == 0 ? tau1 : tau2;
    double ww[4];
#pragma unroll
    for (int c = 0; c < 4; ++c) {
      double s = 0.0;
#pragma unroll
      for (int r = 0; r < 4; ++r) s += v[r] * Qa[r * 4 + c];
      ww[c] = s;
    }
#pragma unroll
    for (int r = 0; r < 4; ++r)
#pragma unroll
      for (int c = 0; c < 4; ++c) Qb[r * 4 + c] = Qa[r * 4 + c] - tau * (v[r] * ww[c]);
#pragma unroll
    for (int i = 0; i < 16; ++i) Qa[i] = Qb[i];
  }
#pragma unroll
  for (int r = 0; r < 4; ++r)
#pragma unroll
    for (int c = 0; c < 4; ++c) Q[r * 4 + c] = Qa[c * 4 + r];
  double T[16];
  matmul4_warp<true>(Q, D, T);
  matmul4_warp<false>(T, Q, Dh);
  double dnorm = 0.0, err = 0.0;
#pragma unroll
  for (int r = 0; r < 4; ++r)
#pragma unroll
    for (int c = 0; c < 4; ++c) {
      const bool act = r < d && c < d;
      if (act) dnorm = dmax(dnorm, fabs(D[r * 4 + c]));
      if (act && r >= Qn && c < Qn) {
        err = dmax(err, fabs(Dh[r * 4 + c]));
        Dh[r * 4 + c] = 0.0;
      }
    }
  return err <= dmax(10.0 * DBL_EPSILON * dnorm, DBL_MIN);
}

template <int OFF>
DEVI void standardize_at_warp(double* Dh, double* Q) {
  double o[6];
  standardize_2x2(Dh[OFF * 4 + OFF], Dh[OFF * 4 + OFF + 1],
                  Dh[(OFF + 1) * 4 + OFF], Dh[(OFF + 1) * 4 + OFF + 1], o);
  const double cs = o[4], sn = o[5];
  double G[16], T[16], D2[16], Q2[16];
  eye4(G);
  G[OFF * 4 + OFF] = cs; G[(OFF + 1) * 4 + OFF] = sn;
  G[OFF * 4 + OFF + 1] = -sn; G[(OFF + 1) * 4 + OFF + 1] = cs;
  matmul4_warp<true>(G, Dh, T);
  matmul4_warp<false>(T, G, D2);
  D2[OFF * 4 + OFF] = o[0]; D2[OFF * 4 + OFF + 1] = o[1];
  D2[(OFF + 1) * 4 + OFF] = o[2]; D2[(OFF + 1) * 4 + OFF + 1] = o[3];
  matmul4_warp<false>(Q, G, Q2);
#pragma unroll
  for (int i = 0; i < 16; ++i) { Dh[i] = D2[i]; Q[i] = Q2[i]; }
}

template <int P, int Qn>
DEVI bool swap_adjacent_warp_pq(const double* D, double* Q, double* Dh) {
  bool accept;
  if constexpr (P == 1 && Qn == 1)
    accept = swap_11_warp(D, Q, Dh);
  else
    accept = swap_general_warp<P, Qn>(D, Q, Dh);
  if constexpr (Qn == 2)
    if (accept) standardize_at_warp<0>(Dh, Q);
  if constexpr (P == 2)
    if (accept) standardize_at_warp<Qn>(Dh, Q);
  if (!accept) {
    eye4(Q);
#pragma unroll
    for (int i = 0; i < 16; ++i) Dh[i] = D[i];
  }
  return accept;
}

// swap the (p, q) blocks at the top of D on the whole warp; returns accept
// (Q = I, Dh = D if not)
DEVI bool swap_adjacent_warp(const double* D, int p, int q, double* Q, double* Dh) {
  if (p == 1)
    return q == 1 ? swap_adjacent_warp_pq<1, 1>(D, Q, Dh)
                  : swap_adjacent_warp_pq<1, 2>(D, Q, Dh);
  return q == 1 ? swap_adjacent_warp_pq<2, 1>(D, Q, Dh)
                : swap_adjacent_warp_pq<2, 2>(D, Q, Dh);
}
