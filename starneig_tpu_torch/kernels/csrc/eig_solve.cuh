// The guarded scalar solves of the eigenvector backsolves E1 and E2 (fp64).
//
// Device twins of ops/eigenvectors.py:_cdiv and _rescale, every operation
// rounded on its own (no fused multiply-adds), as the twins' elementwise
// torch ops round each one: a guard's decision then equals the twin's bit
// for bit.  They run on one lane for a row computed ahead of the chain, or
// on every lane of a warp over the same registers on the chain.
#pragma once

#include "common.cuh"

DEVI double radd(double a, double b) { return __dadd_rn(a, b); }
DEVI double rsub(double a, double b) { return __dsub_rn(a, b); }
DEVI double rmul(double a, double b) { return __dmul_rn(a, b); }
DEVI double rdiv(double a, double b) { return __ddiv_rn(a, b); }

// ops/eigenvectors.py:_cdiv ((ar + i ai) / (br + i bi), Smith's algorithm)
// in two parts.  cdiv_den: (br + i bi) lifted by guard where below it,
// then Smith's ratio r and denominator den of the branch big (|br| >=
// |bi|); cdiv_fin: the numerator's part
struct CdivDen {
  bool big;
  double r, den;
};

DEVI CdivDen cdiv_den(double br, double bi, double guard) {
  const double babs = radd(fabs(br), fabs(bi));
  br = radd(br, babs < guard ? guard : 0.0);
  CdivDen d;
  d.big = fabs(br) >= fabs(bi);
  if (d.big) {
    d.r = rdiv(bi, br == 0.0 ? 1.0 : br);
    d.den = radd(br, rmul(bi, d.r));
  } else {
    d.r = rdiv(br, bi == 0.0 ? 1.0 : bi);
    d.den = radd(bi, rmul(br, d.r));
  }
  d.den = d.den == 0.0 ? guard : d.den;
  return d;
}

DEVI void cdiv_fin(double ar, double ai, const CdivDen& d, double& xr, double& xi) {
  if (d.big) {
    xr = rdiv(radd(ar, rmul(ai, d.r)), d.den);
    xi = rdiv(rsub(ai, rmul(ar, d.r)), d.den);
  } else {
    xr = rdiv(radd(rmul(ar, d.r), ai), d.den);
    xi = rdiv(rsub(rmul(ai, d.r), ar), d.den);
  }
}

// fac <= 1 that keeps num fac / den below omega (the twin's _rescale),
// from lim = den omega, rounded, computed ahead
DEVI double rescale_lim(double num, double lim, double smlnum) {
  return num > lim ? rdiv(lim, dmax(num, smlnum)) : 1.0;
}
