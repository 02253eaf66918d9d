// Scalar device primitives of the GEP kernels (fp64), one thread each.
//
// Device twins of starneig_tpu_torch/ops/qz.py (_safe, _pencil_m2,
// _shifts_qz, _first_col_qz, std_gep_2x2) and ops/swaps_gep.py
// (swap_adjacent_gep with _solve8, _qr_cols, _std_at): the same formulas and
// guards in the same order, so a kernel's decisions follow its plain twin.
#pragma once

#include "common.cuh"

// sqrt(DBL_MIN): the pivots' safety floor of the QZ formulas
constexpr double kGepFloor = 1.4916681462400413e-154;

DEVI double safe_piv(double x) {
  return fabs(x) < kGepFloor ? (x < 0.0 ? -kGepFloor : kGepFloor) : x;
}

// M = H2 inv(T2) for a 2x2 pencil with T upper triangular
DEVI void pencil_m2(double h11, double h12, double h21, double h22, double t11,
                    double t12, double t22, double& m11, double& m12,
                    double& m21, double& m22) {
  t11 = safe_piv(t11);
  t22 = safe_piv(t22);
  m11 = h11 / t11;
  m21 = h21 / t11;
  m12 = (h12 - m11 * t12) / t22;
  m22 = (h22 - m21 * t12) / t22;
}

// double shift from the trailing 2x2 of the pencil (H, T row-major, ld),
// exceptional every 10 iterations: out = {sr1, si1, sr2, si2}
DEVI void shifts_qz(const double* H, const double* T, int ld, int i, int its,
                    double* out) {
  double m11, m12, m21, m22;
  pencil_m2(H[(i - 1) * ld + i - 1], H[(i - 1) * ld + i], H[i * ld + i - 1],
            H[i * ld + i], T[(i - 1) * ld + i - 1], T[(i - 1) * ld + i],
            T[i * ld + i], m11, m12, m21, m22);
  double a = m11, b = m12, c = m21, d = m22;
  if (its > 0 && its % 10 == 0) {
    const double s = fabs(H[i * ld + i - 1] / safe_piv(T[(i - 1) * ld + i - 1])) +
                     fabs(H[(i - 1) * ld + i - 2] / safe_piv(T[(i - 2) * ld + i - 2]));
    const double e11 = 0.75 * s + m22;
    a = e11;
    b = -0.4375 * s;
    c = s;
    d = e11;
  }
  double rt1r, rt1i, rt2r, rt2i;
  eig2x2(a, b, c, d, rt1r, rt1i, rt2r, rt2i);
  const bool real_pair = rt1i == 0.0;
  const bool use1 = fabs(m22 - rt1r) <= fabs(m22 - rt2r);
  const double sr1 = real_pair ? (use1 ? rt1r : rt2r) : rt1r;
  const double sr2 = real_pair ? sr1 : rt2r;
  const double si1 = real_pair ? 0.0 : rt1i;
  out[0] = sr1;
  out[1] = si1;
  out[2] = sr2;
  out[3] = -si1;
}

// first column of (H T^-1 - s1)(H T^-1 - s2) at (l, l), 3 rows
// (ops/qz.py:_first_col_qz): T's pivots floored keeping their sign or,
// with plus_floor, at +floor (the QZ train's rule)
DEVI void first_col_qz(const double* H, const double* T, int ld, int l,
                       const double* sh, bool use3, bool plus_floor, double* v) {
  auto piv = [plus_floor](double x) {
    return plus_floor ? (fabs(x) < kGepFloor ? kGepFloor : x) : safe_piv(x);
  };
  const double t11 = piv(T[l * ld + l]), t22 = piv(T[(l + 1) * ld + l + 1]);
  const double t33 = piv(T[(l + 2) * ld + l + 2]);
  const double t12 = T[l * ld + l + 1], t13 = T[l * ld + l + 2];
  const double t23 = T[(l + 1) * ld + l + 2];
  double inv[9] = {1.0 / t11, -t12 / (t11 * t22),
                   (t12 * t23 - t13 * t22) / (t11 * t22 * t33),
                   0.0, 1.0 / t22, -t23 / (t22 * t33),
                   0.0, 0.0, 1.0 / t33};
  double m3[9];
  for (int r = 0; r < 3; ++r)
    for (int c = 0; c < 3; ++c) {
      double s = 0.0;
      for (int k = 0; k < 3; ++k) s += H[(l + r) * ld + l + k] * inv[k * 3 + c];
      m3[r * 3 + c] = s;
    }
  first_column_shifted(m3, sh[0], sh[1], sh[2], sh[3], use3, v);
}

// dlagv2 on the 2x2 pencil (a row-major, b row-major): o[0..3] the new A
// block, o[4..7] the new B block, o[8..11] = cl, sl, cr, sr
DEVI void std_gep_2x2(const double* a, const double* b, double* o) {
  const double a11 = a[0], a12 = a[1], a21 = a[2], a22 = a[3];
  const double b11 = b[0], b12 = b[1], b22 = b[3];
  double m11, m12, m21, m22;
  pencil_m2(a11, a12, a21, a22, b11, b12, b22, m11, m12, m21, m22);
  double l1r, l1i, l2r, l2i;
  eig2x2(m11, m12, m21, m22, l1r, l1i, l2r, l2i);
  const double bnorm = fabs(b11) + fabs(b12) + fabs(b22);
  const bool b_sing = dmin(fabs(b11), fabs(b22)) <= 8.0 * DBL_EPSILON * bnorm;
  const bool is_real = l1i == 0.0 || b_sing;
  const double lam = l1r;
  const double r00 = a11 - lam * b11, r01 = a12 - lam * b12;
  const double r10 = a21, r11 = a22 - lam * b22;
  const bool use_r1 = r10 * r10 + r11 * r11 > r00 * r00 + r01 * r01;
  const double w0 = -(use_r1 ? r11 : r01), w1 = use_r1 ? r10 : r00;
  const double nw = sqrt(w0 * w0 + w1 * w1);
  const bool degen = nw < kGepFloor;
  double cr = degen ? 1.0 : w0 / nw, sr = degen ? 0.0 : w1 / nw;
  double cl, sl, r;
  if (b_sing) {
    const bool inf_at_11 = fabs(b11) <= fabs(b22);
    const double rinf = sqrt(b12 * b12 + b11 * b11);
    const bool rdeg = rinf < kGepFloor;
    cr = inf_at_11 ? 1.0 : (rdeg ? 1.0 : -b12 / rinf);
    sr = inf_at_11 ? 0.0 : (rdeg ? 0.0 : b11 / rinf);
    givens(a11 * cr + a12 * sr, a21 * cr + a22 * sr, cl, sl, r);
  } else {
    givens(b11 * cr + b12 * sr, b22 * sr, cl, sl, r);
  }
  if (!is_real) {
    cr = 1.0;
    sr = 0.0;
    cl = 1.0;
    sl = 0.0;
  }
  const double* x[2] = {a, b};
  for (int t = 0; t < 2; ++t) {
    const double y11 = cl * x[t][0] + sl * x[t][2];
    const double y12 = cl * x[t][1] + sl * x[t][3];
    const double y21 = -sl * x[t][0] + cl * x[t][2];
    const double y22 = -sl * x[t][1] + cl * x[t][3];
    o[4 * t + 0] = y11 * cr + y12 * sr;
    o[4 * t + 1] = -y11 * sr + y12 * cr;
    o[4 * t + 2] = y21 * cr + y22 * sr;
    o[4 * t + 3] = -y21 * sr + y22 * cr;
  }
  if (is_real) o[2] = 0.0;
  o[6] = 0.0;
  if (b_sing) o[4] = 0.0;
  o[8] = cl;
  o[9] = sl;
  o[10] = cr;
  o[11] = sr;
}

// ---------------------------------------------------------------------------
// the generalized adjacent swap (dtgex2), one thread
// ---------------------------------------------------------------------------

// C = X^T Y or X Y (4x4 row-major), k in order
DEVI void mm4(const double* X, const double* Y, double* C, bool tn) {
  double t[16];
  for (int r = 0; r < 4; ++r)
    for (int c = 0; c < 4; ++c) {
      double s = 0.0;
      for (int k = 0; k < 4; ++k) s += (tn ? X[k * 4 + r] : X[r * 4 + k]) * Y[k * 4 + c];
      t[r * 4 + c] = s;
    }
  for (int e = 0; e < 16; ++e) C[e] = t[e];
}

// Gauss-Jordan with partial pivoting on the 8x9 augmented system
DEVI void solve8(double* M, double* x) {
  for (int k = 0; k < 8; ++k) {
    int piv = k;
    double best = -1.0;
    for (int r = 0; r < 8; ++r) {
      const double v = r >= k ? fabs(M[r * 9 + k]) : -1.0;
      if (v > best) { best = v; piv = r; }
    }
    if (piv != k)
      for (int c = 0; c < 9; ++c) {
        const double t = M[k * 9 + c];
        M[k * 9 + c] = M[piv * 9 + c];
        M[piv * 9 + c] = t;
      }
    double pv = M[k * 9 + k];
    pv = pv == 0.0 ? DBL_MIN : pv;
    double f[8];
    for (int r = 0; r < 8; ++r) f[r] = r == k ? 0.0 : M[r * 9 + k] / pv;
    // product and difference rounded apart, as the plain twin's (no fused
    // multiply-add: a swap's acceptance near its threshold follows them)
    for (int r = 0; r < 8; ++r)
      for (int c = 0; c < 9; ++c)
        M[r * 9 + c] = __dsub_rn(M[r * 9 + c], __dmul_rn(f[r], M[k * 9 + c]));
  }
  for (int r = 0; r < 8; ++r) {
    double dg = M[r * 9 + r];
    dg = dg == 0.0 ? DBL_MIN : dg;
    x[r] = M[r * 9 + 8] / dg;
  }
}

// orthogonal Q (4x4) whose leading q columns span the columns of M4 (4x2,
// row-major; rows >= d and columns >= q zero)
DEVI void qr_cols(const double* M4, int d, int q, double* Q) {
  const unsigned rmask = (1u << d) - 1u;
  double x[4], v1[4], tau1, b1;
  for (int r = 0; r < 4; ++r) x[r] = M4[r * 2];
  householder(x, rmask, 4, v1, tau1, b1);
  double w1 = 0.0;
  for (int r = 0; r < 4; ++r) w1 += v1[r] * M4[r * 2 + 1];
  double m2[4];
  for (int r = 0; r < 4; ++r) m2[r] = r >= 1 ? M4[r * 2 + 1] - tau1 * (v1[r] * w1) : 0.0;
  const double x2[4] = {m2[1], m2[2], m2[3], m2[0]};
  const unsigned mask2 = (rmask >> 1) & 7u;  // roll(rmask & (r >= 1), -1)
  double v2r[4], tau2, b2;
  householder(x2, mask2, 4, v2r, tau2, b2);
  const double v2[4] = {v2r[3], v2r[0], v2r[1], v2r[2]};
  if (q <= 1) tau2 = 0.0;
  double Qa[16];
  for (int e = 0; e < 16; ++e) Qa[e] = e % 5 == 0 ? 1.0 : 0.0;
  for (int pass = 0; pass < 2; ++pass) {
    const double* v = pass == 0 ? v1 : v2;
    const double tau = pass == 0 ? tau1 : tau2;
    double w[4];
    for (int c = 0; c < 4; ++c) {
      double s = 0.0;
      for (int r = 0; r < 4; ++r) s += v[r] * Qa[r * 4 + c];
      w[c] = s;
    }
    for (int r = 0; r < 4; ++r)
      for (int c = 0; c < 4; ++c) Qa[r * 4 + c] = Qa[r * 4 + c] - tau * (v[r] * w[c]);
  }
  for (int r = 0; r < 4; ++r)
    for (int c = 0; c < 4; ++c) Q[r * 4 + c] = Qa[c * 4 + r];
}

DEVI void embed2(double* G, int off, double c, double s) {
  for (int e = 0; e < 16; ++e) G[e] = e % 5 == 0 ? 1.0 : 0.0;
  G[off * 4 + off] = c;
  G[off * 4 + off + 1] = -s;
  G[(off + 1) * 4 + off] = s;
  G[(off + 1) * 4 + off + 1] = c;
}

// re-triangularize and standardize the 2x2 pencil block at off
DEVI void std_at(double* Ah, double* Bh, double* Qs, double* Zs, int off) {
  double A2[4] = {Ah[off * 4 + off], Ah[off * 4 + off + 1],
                  Ah[(off + 1) * 4 + off], Ah[(off + 1) * 4 + off + 1]};
  double B2[4] = {Bh[off * 4 + off], Bh[off * 4 + off + 1],
                  Bh[(off + 1) * 4 + off], Bh[(off + 1) * 4 + off + 1]};
  double c0, s0, r0;
  givens(B2[0], B2[2], c0, s0, r0);
  // G0^T X with G0 = [[c0, -s0], [s0, c0]]
  const double a2[4] = {c0 * A2[0] + s0 * A2[2], c0 * A2[1] + s0 * A2[3],
                        -s0 * A2[0] + c0 * A2[2], -s0 * A2[1] + c0 * A2[3]};
  const double b2[4] = {c0 * B2[0] + s0 * B2[2], c0 * B2[1] + s0 * B2[3], 0.0,
                        -s0 * B2[1] + c0 * B2[3]};
  double G[16], T[16];
  embed2(G, off, c0, s0);
  mm4(G, Ah, Ah, true);
  mm4(G, Bh, Bh, true);
  mm4(Qs, G, Qs, false);
  double o[12];
  std_gep_2x2(a2, b2, o);
  double Gl[16], Gr[16];
  embed2(Gl, off, o[8], o[9]);
  embed2(Gr, off, o[10], o[11]);
  mm4(Gl, Ah, T, true);
  mm4(T, Gr, Ah, false);
  mm4(Gl, Bh, T, true);
  mm4(T, Gr, Bh, false);
  Ah[off * 4 + off] = o[0];
  Ah[off * 4 + off + 1] = o[1];
  Ah[(off + 1) * 4 + off] = o[2];
  Ah[(off + 1) * 4 + off + 1] = o[3];
  Bh[off * 4 + off] = o[4];
  Bh[off * 4 + off + 1] = o[5];
  Bh[(off + 1) * 4 + off] = o[6];
  Bh[(off + 1) * 4 + off + 1] = o[7];
  mm4(Qs, Gl, Qs, false);
  mm4(Zs, Gr, Zs, false);
}

// swap the adjacent (p, q) blocks at the top of the 4x4 pencil (A4, B4);
// returns accept (Qs = Zs = I and Ah, Bh = the inputs when rejected)
DEVI bool swap_adjacent_gep(const double* A4, const double* B4, int p, int q,
                            double* Qs, double* Zs, double* Ah, double* Bh) {
  const int d = p + q;
  double M[72];
  for (int e = 0; e < 72; ++e) M[e] = 0.0;
  for (int blk = 0; blk < 2; ++blk) {
    const double* X = blk == 0 ? A4 : B4;
    double X11[4] = {0, 0, 0, 0}, X22[4] = {0, 0, 0, 0}, X12[4] = {0, 0, 0, 0};
    for (int i = 0; i < 2; ++i)
      for (int j = 0; j < 2; ++j) {
        if (i < p && j < p) X11[i * 2 + j] = X[i * 4 + j];
        if (i < q && j < q) X22[i * 2 + j] = X[(p + i) * 4 + p + j];
        if (i < p && j < q) X12[i * 2 + j] = X[i * 4 + p + j];
      }
    for (int k = 0; k < 4; ++k) {
      double* row = M + (blk * 4 + k) * 9;
      const int i = k % 2, j = k / 2;
      if (i < p && j < q) {
        row[2 * j] += X11[i * 2 + 0];
        row[2 * j + 1] += X11[i * 2 + 1];
        row[4 + i] += -X22[0 * 2 + j];
        row[6 + i] += -X22[1 * 2 + j];
        row[8] = -X12[i * 2 + j];
      } else {
        row[blk * 4 + k] = 1.0;
      }
    }
  }
  double x[8];
  solve8(M, x);
  double MR[8], ML[8];
  for (int r = 0; r < 4; ++r)
    for (int c = 0; c < 2; ++c) {
      MR[r * 2 + c] = r < p ? x[2 * c + r] : 0.0;
      ML[r * 2 + c] = r < p ? x[4 + 2 * c + r] : 0.0;
      if (r >= p && r - p == c && c < q) {
        MR[r * 2 + c] += 1.0;
        ML[r * 2 + c] += 1.0;
      }
    }
  qr_cols(MR, d, q, Zs);
  qr_cols(ML, d, q, Qs);
  double T[16];
  mm4(Qs, A4, T, true);
  mm4(T, Zs, Ah, false);
  mm4(Qs, B4, T, true);
  mm4(T, Zs, Bh, false);
  double nrm = 0.0, err = 0.0;
  for (int r = 0; r < 4; ++r)
    for (int c = 0; c < 4; ++c) {
      if (r >= d || c >= d) continue;
      nrm = dmax(nrm, dmax(fabs(A4[r * 4 + c]), fabs(B4[r * 4 + c])));
      if (r >= q && c < q) {
        err = dmax(err, dmax(fabs(Ah[r * 4 + c]), fabs(Bh[r * 4 + c])));
        Ah[r * 4 + c] = 0.0;
        Bh[r * 4 + c] = 0.0;
      }
    }
  const bool accept = err <= dmax(20.0 * DBL_EPSILON * nrm, DBL_MIN);
  if (!accept) {
    for (int e = 0; e < 16; ++e) {
      Qs[e] = Zs[e] = e % 5 == 0 ? 1.0 : 0.0;
      Ah[e] = A4[e];
      Bh[e] = B4[e];
    }
    return false;
  }
  if (q == 2) std_at(Ah, Bh, Qs, Zs, 0);
  if (p == 2) std_at(Ah, Bh, Qs, Zs, q);
  return true;
}
