// Scalar device primitives of the GEP kernels (fp64), one thread each.
//
// Device twins of starneig_tpu_torch/ops/qz.py (_safe, _pencil_m2,
// _shifts_qz, _first_col_qz, std_gep_2x2): the same formulas and guards in
// the same order, so a kernel's decisions follow its plain twin.  The
// generalized swap (dtgex2, ops/swaps_gep.py) runs on a warp:
// swap_chain_gep.cuh:swap_adjacent_gep_warp.
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

// the rotation [[c, -s], [s, c]] at rows and columns (off, off + 1) of a
// 4x4 identity (row-major): the dtgex2 standardization's embedding
DEVI void embed2(double* G, int off, double c, double s) {
  for (int e = 0; e < 16; ++e) G[e] = e % 5 == 0 ? 1.0 : 0.0;
  G[off * 4 + off] = c;
  G[off * 4 + off + 1] = -s;
  G[(off + 1) * 4 + off] = s;
  G[(off + 1) * 4 + off + 1] = c;
}
