// The blocked layout that the eigenvector backsolves E1 (eig_backsolve.cu)
// and E2 (eig_backsolve_gep.cu) share: LAPACK dtrevc3's blocked backsolve,
// a block a group of kG eigenvalues (a warp each), rows in row blocks of at
// most kNB, the far part of a row block's sums a product of width 2 kG on
// the fp64 tensor cores.
#pragma once

#include "eig_solve.cuh"

namespace {

constexpr int kG = 8;              // eigenvalues a block, a warp each
constexpr int kThreads = kG * 32;
constexpr int kNB = 64;            // rows a row block
constexpr int kMT = kNB / 8;       //   its 8-row DMMA tiles
constexpr int kVecs = 2 * kG;      // the group's vectors: Re and Im of each
constexpr int kLdN = kNB + 1;      // row stride of a near tile
constexpr unsigned kFull = 0xffffffffu;

// d = a b + d on the tensor cores: A 8 x 4 (a = A[lane / 4][lane % 4]), B
// 4 x 8 (b = B[lane % 4][lane / 4]), D 8 x 8 (d[i] = D[lane / 4][2 (lane % 4) + i])
__device__ __forceinline__ void dmma(double (&d)[2], double a, double b) {
  asm volatile("mma.sync.aligned.m8n8k4.row.col.f64.f64.f64.f64 {%0, %1}, {%2}, {%3}, {%0, %1};\n"
               : "+d"(d[0]), "+d"(d[1])
               : "d"(a), "d"(b));
}

// The first row of the row block that ends at r1: kNB rows before it, or
// one row later where that would split a 2x2 block (kind 2 marks a
// block's second row)
__device__ __forceinline__ int row_block_start(const int* kind, int r1) {
  int r0 = max(0, r1 - kNB);
  if (r0 > 0 && kind[r0] == 2) ++r0;
  return r0;
}

}  // namespace
