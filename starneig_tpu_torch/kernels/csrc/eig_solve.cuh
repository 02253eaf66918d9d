// The guarded scalar solves of the eigenvector backsolves E1 and E2 (fp64).
//
// Device twins of ops/eigenvectors.py:_cdiv and _rescale, every operation
// rounded on its own (no fused multiply-adds), as the twins' elementwise
// torch ops round each one: a guard's decision then equals the twin's bit
// for bit.  They run on every lane of a warp over the same registers.
#pragma once

#include "common.cuh"

DEVI double radd(double a, double b) { return __dadd_rn(a, b); }
DEVI double rsub(double a, double b) { return __dsub_rn(a, b); }
DEVI double rmul(double a, double b) { return __dmul_rn(a, b); }
DEVI double rdiv(double a, double b) { return __ddiv_rn(a, b); }

// ops/eigenvectors.py:_cdiv: (ar + i ai) / (br + i bi), Smith's algorithm,
// a denominator below guard lifted by guard
DEVI void cdiv(double ar, double ai, double br, double bi, double guard, double& xr,
               double& xi) {
  const double babs = radd(fabs(br), fabs(bi));
  br = radd(br, babs < guard ? guard : 0.0);
  if (fabs(br) >= fabs(bi)) {
    const double r = rdiv(bi, br == 0.0 ? 1.0 : br);
    double den = radd(br, rmul(bi, r));
    den = den == 0.0 ? guard : den;
    xr = rdiv(radd(ar, rmul(ai, r)), den);
    xi = rdiv(rsub(ai, rmul(ar, r)), den);
  } else {
    const double r = rdiv(br, bi == 0.0 ? 1.0 : bi);
    double den = radd(bi, rmul(br, r));
    den = den == 0.0 ? guard : den;
    xr = rdiv(radd(rmul(ar, r), ai), den);
    xi = rdiv(rsub(rmul(ai, r), ar), den);
  }
}

// fac <= 1 that keeps num fac / den below omega (the twin's _rescale)
DEVI double rescale(double num, double den, double omega, double smlnum) {
  const double lim = rmul(den, omega);
  return num > lim ? rdiv(lim, dmax(num, smlnum)) : 1.0;
}
