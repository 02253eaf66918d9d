// The two-sided swap-chain engine of the pencil kernels: one thread block
// moves 1x1/2x2 diagonal blocks of a generalized Schur pair (S
// quasi-triangular, T upper triangular, both WP x WP) toward the top by
// adjacent dtgex2 swaps, and applies every swap's left transform Qs to
// S's and T's rows and to the columns of Q, its right transform Zs to S's
// and T's columns and to the columns of Z (ld WP).  Its users are the
// pencil reordering's window bubble (reorder_bubble_gep.cu) and G4's spike
// deflation (aed_deflate_gep.cu).
//
// What bounds it on the H100: the serial chain of swaps.  Each swap's
// 4x4 pencil decision (the pivoted 8x8 Sylvester solve, two 4x2 column QRs,
// the acceptance test on both matrices, the 2x2 standardizations) needs the
// previous swap's result on the diagonal; the rest (4 rows and 4 columns
// of S and T, 4 columns of Q and Z) is parallel but small, and applied
// block-wide after every swap behind barriers it would sit on the chain.
//
// Design: the one-sided engine of swap_chain.cuh made two-sided.
//   * Warp 0 is the chain warp, warps 1..7 update warps.
//   * Segments.  A move runs in segments of at most kSegSwaps swaps.
//     Before a segment the chain warp loads the diagonal blocks S[lo:hi,
//     lo:hi] and T[lo:hi, lo:hi] it will touch into shared memory.  Every
//     lane runs swap_adjacent_gep_warp (below: the 8x8 solve a row a lane,
//     the 4x4 products an entry a lane), and the warp applies the swap to
//     the segment's rows and columns inside both blocks and logs its
//     (c, d, Qs, Zs); nothing goes to global memory inside a segment.
//   * Flushes.  At a segment's end the chain warp writes the blocks back
//     and posts the log (a two-slot ring); the update warps replay it in
//     order on 32-row or 32-column tiles staged with coalesced loads: S's
//     and T's rows right of the segment take each Qs^T, their columns above
//     it, Q's and Z's columns each Qs and Zs.  Every entry so takes the
//     plain twin's operations in the twin's order.  (Accumulated factors,
//     applied as level-3 products, change the rounding of the flushed
//     entries, which later swaps read: a dtgex2 acceptance near its
//     threshold then parts from the twin's, as measured on the GEP chain's
//     windows; at W <= 128 the replay's flops are below the products'.)
//   * Overlap.  The next segment of a move sits directly above and reads
//     only the kSeg rows just above this one in the columns above: the
//     update warps replay those first, then a named barrier lets the chain
//     warp go on while they replay the rest.
//   * State.  S's subdiagonal (the block sizes) lives in shared memory,
//     kept current by the chain warp swap by swap, with what the caller adds
//     (the bubble's selection, G4's spike) through on_swap.
// The barriers and ring discipline are swap_chain.cuh's.
#pragma once

#include "gep_common.cuh"
#include "swap_chain.cuh"

namespace swap_chain_gep {

using swap_chain::bar_arrive;
using swap_chain::bar_sync;
using swap_chain::kArrived;
using swap_chain::kBarFree;
using swap_chain::kBarNear;
using swap_chain::kBarReady;
using swap_chain::kCapped;
using swap_chain::kLd;
using swap_chain::kLimit;
using swap_chain::kRejected;
using swap_chain::kSeg;
using swap_chain::kSegSwaps;
using swap_chain::kThreads;
using swap_chain::kTl;
using swap_chain::kUpdWarps;

// ---------------------------------------------------------------------------
// dtgex2 on a warp: the twin of ops/swaps_gep.py:swap_adjacent_gep
// ---------------------------------------------------------------------------
// Every lane calls it with the same 4x4 pair and gets the same transforms
// and decision.  p and q are template arguments, so every array stays in
// registers; the 8x8 Gauss-Jordan elimination runs a row a lane on the
// lanes r (mod 8), each step's pivot chosen from the eight candidates
// gathered by shuffles (the first largest, as the twin's _solve8); the
// 4x4 products run an entry a lane (common.cuh:matmul4_warp).  The
// formulas and their order are the twin's _solve8's, _qr_cols', its 4x4
// products' and _std_at's.

DEVI double pick9(const double (&m)[9], int i) {
  double v = m[0];
#pragma unroll
  for (int c = 1; c < 9; ++c)
    if (c == i) v = m[c];
  return v;
}

// row r of the 8x9 system (the twin's layout), r a compile-time constant
template <int P, int Qn, int R>
DEVI void sylvester_row(const double* A4, const double* B4, double (&row)[9]) {
#pragma unroll
  for (int c = 0; c < 9; ++c) row[c] = 0.0;
  const double* X = R < 4 ? A4 : B4;
  constexpr int k = R % 4, i = k % 2, j = k / 2;
  if constexpr (i < P && j < Qn) {
    auto x11 = [&](int ii, int jj) { return (ii < P && jj < P) ? X[ii * 4 + jj] : 0.0; };
    auto x22 = [&](int ii, int jj) {
      return (ii < Qn && jj < Qn) ? X[(P + ii) * 4 + P + jj] : 0.0;
    };
    row[2 * j] += x11(i, 0);
    row[2 * j + 1] += x11(i, 1);
    row[4 + i] += -x22(0, j);
    row[6 + i] += -x22(1, j);
    row[8] = -X[i * 4 + P + j];
  } else {
    row[R] = 1.0;
  }
}

template <int P, int Qn>
DEVI void solve8_warp(const double* A4, const double* B4, double (&x)[8]) {
  const int r = threadIdx.x & 7;
  double m[9];
#pragma unroll
  for (int rr = 0; rr < 8; ++rr) {
    double row[9];
    switch (rr) {
      case 0: sylvester_row<P, Qn, 0>(A4, B4, row); break;
      case 1: sylvester_row<P, Qn, 1>(A4, B4, row); break;
      case 2: sylvester_row<P, Qn, 2>(A4, B4, row); break;
      case 3: sylvester_row<P, Qn, 3>(A4, B4, row); break;
      case 4: sylvester_row<P, Qn, 4>(A4, B4, row); break;
      case 5: sylvester_row<P, Qn, 5>(A4, B4, row); break;
      case 6: sylvester_row<P, Qn, 6>(A4, B4, row); break;
      default: sylvester_row<P, Qn, 7>(A4, B4, row); break;
    }
    if (rr == r) {
#pragma unroll
      for (int c = 0; c < 9; ++c) m[c] = row[c];
    }
  }
#pragma unroll
  for (int k = 0; k < 8; ++k) {
    const double val = r >= k ? fabs(m[k]) : -1.0;
    int piv = k;
    double best = -1.0;
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      const double vi = __shfl_sync(0xffffffffu, val, i);
      if (vi > best) { best = vi; piv = i; }
    }
    const int src = r == k ? piv : (r == piv ? k : r);
#pragma unroll
    for (int c = 0; c < 9; ++c) m[c] = __shfl_sync(0xffffffffu, m[c], src);
    double rowk[9];
#pragma unroll
    for (int c = 0; c < 9; ++c) rowk[c] = __shfl_sync(0xffffffffu, m[c], k);
    double pv = rowk[k];
    pv = pv == 0.0 ? DBL_MIN : pv;
    const double f = r == k ? 0.0 : m[k] / pv;
    // the product and the difference rounded apart, as the plain twin's
    // elimination rounds them (a fused multiply-add here moves the
    // acceptance error of an ill-conditioned swap across its threshold)
#pragma unroll
    for (int c = 0; c < 9; ++c) m[c] = __dsub_rn(m[c], __dmul_rn(f, rowk[c]));
  }
  double dg = pick9(m, r);
  dg = dg == 0.0 ? DBL_MIN : dg;
  const double xr = m[8] / dg;
#pragma unroll
  for (int i = 0; i < 8; ++i) x[i] = __shfl_sync(0xffffffffu, xr, i);
}

// the twin's _qr_cols with d and q compile-time constants
template <int D, int Qn>
DEVI void qr_cols_t(const double (&M4)[8], double* Q) {
  constexpr unsigned rmask = (1u << D) - 1u;
  double x[4], v1[4], tau1, b1;
#pragma unroll
  for (int r = 0; r < 4; ++r) x[r] = M4[r * 2];
  householder(x, rmask, 4, v1, tau1, b1);
  double w1 = 0.0;
#pragma unroll
  for (int r = 0; r < 4; ++r) w1 += v1[r] * M4[r * 2 + 1];
  double m2[4];
#pragma unroll
  for (int r = 0; r < 4; ++r) m2[r] = r >= 1 ? M4[r * 2 + 1] - tau1 * (v1[r] * w1) : 0.0;
  const double x2[4] = {m2[1], m2[2], m2[3], m2[0]};
  constexpr unsigned mask2 = (rmask >> 1) & 7u;
  double v2r[4], tau2, b2;
  householder(x2, mask2, 4, v2r, tau2, b2);
  const double v2[4] = {v2r[3], v2r[0], v2r[1], v2r[2]};
  if (Qn <= 1) tau2 = 0.0;
  double Qa[16];
  eye4(Qa);
#pragma unroll
  for (int pass = 0; pass < 2; ++pass) {
    const double* v = pass == 0 ? v1 : v2;
    const double tau = pass == 0 ? tau1 : tau2;
    double w[4];
#pragma unroll
    for (int c = 0; c < 4; ++c) {
      double s = 0.0;
#pragma unroll
      for (int r = 0; r < 4; ++r) s += v[r] * Qa[r * 4 + c];
      w[c] = s;
    }
#pragma unroll
    for (int r = 0; r < 4; ++r)
#pragma unroll
      for (int c = 0; c < 4; ++c) Qa[r * 4 + c] = Qa[r * 4 + c] - tau * (v[r] * w[c]);
  }
#pragma unroll
  for (int r = 0; r < 4; ++r)
#pragma unroll
    for (int c = 0; c < 4; ++c) Q[r * 4 + c] = Qa[c * 4 + r];
}

// the twin's _std_at on the warp: the 2x2 pencil block at OFF
// re-triangularized and standardized
template <int OFF>
DEVI void std_at_warp(double* Ah, double* Bh, double* Qs, double* Zs) {
  const double A2[4] = {Ah[OFF * 4 + OFF], Ah[OFF * 4 + OFF + 1],
                        Ah[(OFF + 1) * 4 + OFF], Ah[(OFF + 1) * 4 + OFF + 1]};
  const double B2[4] = {Bh[OFF * 4 + OFF], Bh[OFF * 4 + OFF + 1],
                        Bh[(OFF + 1) * 4 + OFF], Bh[(OFF + 1) * 4 + OFF + 1]};
  double c0, s0, r0;
  givens(B2[0], B2[2], c0, s0, r0);
  const double a2[4] = {c0 * A2[0] + s0 * A2[2], c0 * A2[1] + s0 * A2[3],
                        -s0 * A2[0] + c0 * A2[2], -s0 * A2[1] + c0 * A2[3]};
  const double b2[4] = {c0 * B2[0] + s0 * B2[2], c0 * B2[1] + s0 * B2[3], 0.0,
                        -s0 * B2[1] + c0 * B2[3]};
  double G[16], T[16];
  embed2(G, OFF, c0, s0);
  matmul4_warp<true>(G, Ah, T);
#pragma unroll
  for (int e = 0; e < 16; ++e) Ah[e] = T[e];
  matmul4_warp<true>(G, Bh, T);
#pragma unroll
  for (int e = 0; e < 16; ++e) Bh[e] = T[e];
  matmul4_warp<false>(Qs, G, T);
#pragma unroll
  for (int e = 0; e < 16; ++e) Qs[e] = T[e];
  double o[12];
  std_gep_2x2(a2, b2, o);
  double Gl[16], Gr[16];
  embed2(Gl, OFF, o[8], o[9]);
  embed2(Gr, OFF, o[10], o[11]);
  matmul4_warp<true>(Gl, Ah, T);
  matmul4_warp<false>(T, Gr, Ah);
  matmul4_warp<true>(Gl, Bh, T);
  matmul4_warp<false>(T, Gr, Bh);
  Ah[OFF * 4 + OFF] = o[0];
  Ah[OFF * 4 + OFF + 1] = o[1];
  Ah[(OFF + 1) * 4 + OFF] = o[2];
  Ah[(OFF + 1) * 4 + OFF + 1] = o[3];
  Bh[OFF * 4 + OFF] = o[4];
  Bh[OFF * 4 + OFF + 1] = o[5];
  Bh[(OFF + 1) * 4 + OFF] = o[6];
  Bh[(OFF + 1) * 4 + OFF + 1] = o[7];
  matmul4_warp<false>(Qs, Gl, T);
#pragma unroll
  for (int e = 0; e < 16; ++e) Qs[e] = T[e];
  matmul4_warp<false>(Zs, Gr, T);
#pragma unroll
  for (int e = 0; e < 16; ++e) Zs[e] = T[e];
}

template <int P, int Qn>
DEVI bool swap_adjacent_gep_warp_pq(const double* A4, const double* B4, double* Qs,
                                    double* Zs, double* Ah, double* Bh) {
  constexpr int d = P + Qn;
  double x[8];
  solve8_warp<P, Qn>(A4, B4, x);
  double MR[8], ML[8];
#pragma unroll
  for (int r = 0; r < 4; ++r)
#pragma unroll
    for (int c = 0; c < 2; ++c) {
      MR[r * 2 + c] = r < P ? x[2 * c + r] : 0.0;
      ML[r * 2 + c] = r < P ? x[4 + 2 * c + r] : 0.0;
      if (r >= P && r - P == c && c < Qn) {
        MR[r * 2 + c] += 1.0;
        ML[r * 2 + c] += 1.0;
      }
    }
  qr_cols_t<d, Qn>(MR, Zs);
  qr_cols_t<d, Qn>(ML, Qs);
  double T[16];
  matmul4_warp<true>(Qs, A4, T);
  matmul4_warp<false>(T, Zs, Ah);
  matmul4_warp<true>(Qs, B4, T);
  matmul4_warp<false>(T, Zs, Bh);
  double nrm = 0.0, err = 0.0;
#pragma unroll
  for (int r = 0; r < 4; ++r)
#pragma unroll
    for (int c = 0; c < 4; ++c) {
      if (r >= d || c >= d) continue;
      nrm = dmax(nrm, dmax(fabs(A4[r * 4 + c]), fabs(B4[r * 4 + c])));
      if (r >= Qn && c < Qn) {
        err = dmax(err, dmax(fabs(Ah[r * 4 + c]), fabs(Bh[r * 4 + c])));
        Ah[r * 4 + c] = 0.0;
        Bh[r * 4 + c] = 0.0;
      }
    }
  const bool accept = err <= dmax(20.0 * DBL_EPSILON * nrm, DBL_MIN);
  if (!accept) {
#pragma unroll
    for (int e = 0; e < 16; ++e) {
      Qs[e] = Zs[e] = e % 5 == 0 ? 1.0 : 0.0;
      Ah[e] = A4[e];
      Bh[e] = B4[e];
    }
    return false;
  }
  if constexpr (Qn == 2) std_at_warp<0>(Ah, Bh, Qs, Zs);
  if constexpr (P == 2) std_at_warp<Qn>(Ah, Bh, Qs, Zs);
  return true;
}

// swap the (p, q) blocks at the top of the 4x4 pencil (A4, B4) on the
// whole warp; returns accept (Qs = Zs = I, Ah, Bh = the inputs if not)
DEVI bool swap_adjacent_gep_warp(const double* A4, const double* B4, int p, int q,
                                 double* Qs, double* Zs, double* Ah, double* Bh) {
  if (p == 1)
    return q == 1 ? swap_adjacent_gep_warp_pq<1, 1>(A4, B4, Qs, Zs, Ah, Bh)
                  : swap_adjacent_gep_warp_pq<1, 2>(A4, B4, Qs, Zs, Ah, Bh);
  return q == 1 ? swap_adjacent_gep_warp_pq<2, 1>(A4, B4, Qs, Zs, Ah, Bh)
                : swap_adjacent_gep_warp_pq<2, 2>(A4, B4, Qs, Zs, Ah, Bh);
}

// ---------------------------------------------------------------------------
// shared memory
// ---------------------------------------------------------------------------

// a logged swap: c, d, then Qs and Zs (row-major 4 x 4)
constexpr int kRec = 34;

// segment meta, per ring slot: lo (the blocks' top row), amin, hi, flags
// (bit 0: the move goes on, so the chain waits for the rows above; bit 1:
// stop, no more segments), the swaps logged
struct Meta {
  int v[2][5];
};

// the ring (2 slots of swap logs), the segment's blocks of S and T, the
// update warps' tiles, S's subdiagonal (n + 4), the caller's extra state
struct Smem {
  double* ring;   // 2 x kSegSwaps x kRec
  double* blk;    // 2 x kSeg x kLd: S's, then T's
  double* tiles;  // kUpdWarps x 32 x kTl
  double* sub;    // S[i+1][i]
  double* extra;  // n + 4 doubles or ints
};

constexpr int kRing = 2 * kSegSwaps * kRec;  // even: the blocks stay 16-byte aligned

__host__ __device__ constexpr size_t smem_bytes(int n) {
  return sizeof(double) * ((size_t)kRing + 2 * (size_t)kSeg * kLd +
                           (size_t)kUpdWarps * 32 * kTl + 2 * (size_t)(n + 4));
}

__device__ __forceinline__ Smem carve(double* base, int n) {
  Smem s;
  s.ring = base;
  s.blk = s.ring + kRing;
  s.tiles = s.blk + 2 * kSeg * kLd;  // kRing + 2 kSeg kLd doubles: 16-byte aligned
  s.sub = s.tiles + kUpdWarps * 32 * kTl;
  s.extra = s.sub + (n + 4);
  return s;
}

// ---------------------------------------------------------------------------
// the flush (update warps)
// ---------------------------------------------------------------------------

// x[0 .. d-1] <- x G (tn false) or G^T x (tn true), G = Qs or Zs of a logged
// swap: the plain twin's 4-term sums, the terms past d being exact zeros
template <bool TN>
DEVI void replay_one(double* x, int d, const double* G) {
  double v[4], o[4];
#pragma unroll
  for (int t = 0; t < 4; ++t) v[t] = t < d ? x[t] : 0.0;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    double acc = 0.0;
#pragma unroll
    for (int t = 0; t < 4; ++t)
      if (t < d) acc += TN ? G[t * 4 + i] * v[t] : v[t] * G[t * 4 + i];
    o[i] = acc;
  }
#pragma unroll
  for (int i = 0; i < 4; ++i)
    if (i < d) x[i] = o[i];
}

// the log's nsw swaps (f = 0: Qs, 1: Zs) replayed on a tile row of n
// entries whose index 0 is the matrix index c0
template <bool TN>
DEVI void replay(double* row, int c0, const double* swl, int nsw, int f) {
  for (int s = 0; s < nsw; ++s) {
    const double* r = swl + s * kRec;
    replay_one<TN>(row + ((int)r[0] - c0), (int)r[1], r + 2 + 16 * f);
  }
}

// rows r0 .. r0 + nr - 1 (nr <= 32) of the row-major A (ld lda), columns
// c0 .. c0 + n - 1 (n <= 32): each row takes the log's column transforms
// (f = 0: Qs, 1: Zs); staged through the tile, a row a lane
DEVI void rows_replay(double* A, int lda, int r0, int nr, int c0, int n,
                      const double* swl, int nsw, int f, double* tile) {
  const int lane = threadIdx.x & 31;
  for (int rb = 0; rb < nr; rb += 8) {  // 8 loads a lane in flight
    double v[8];
#pragma unroll
    for (int u = 0; u < 8; ++u)
      v[u] = (rb + u < nr && lane < n) ? A[(size_t)(r0 + rb + u) * lda + c0 + lane] : 0.0;
#pragma unroll
    for (int u = 0; u < 8; ++u)
      if (rb + u < nr) tile[(rb + u) * kTl + lane] = v[u];
  }
  __syncwarp();
  if (lane < nr) replay<false>(tile + lane * kTl, c0, swl, nsw, f);
  __syncwarp();
  for (int rb = 0; rb < nr; ++rb)
    if (lane < n) A[(size_t)(r0 + rb) * lda + c0 + lane] = tile[rb * kTl + lane];
  __syncwarp();  // the tile is free
}

// columns c0 .. c0 + nc - 1 (nc <= 32) of rows a0 .. a0 + n - 1 of A: each
// column takes the log's Qs^T; staged transposed, a column a lane
DEVI void cols_replay(double* A, int lda, int a0, int n, int c0, int nc,
                      const double* swl, int nsw, double* tile) {
  const int lane = threadIdx.x & 31;
  for (int kb = 0; kb < n; kb += 8) {
    double v[8];
#pragma unroll
    for (int u = 0; u < 8; ++u)
      v[u] = (kb + u < n && lane < nc) ? A[(size_t)(a0 + kb + u) * lda + c0 + lane] : 0.0;
#pragma unroll
    for (int u = 0; u < 8; ++u)
      if (kb + u < n) tile[lane * kTl + kb + u] = v[u];
  }
  __syncwarp();
  if (lane < nc) replay<true>(tile + lane * kTl, a0, swl, nsw, 0);
  __syncwarp();
  for (int k = 0; k < n; ++k)
    if (lane < nc) A[(size_t)(a0 + k) * lda + c0 + lane] = tile[lane * kTl + k];
  __syncwarp();  // the tile is free
}

// The update warps' loop: take segments from the ring until the stop flag.
// The rows replayed: Q's q0 .. m1 - 1 and Z's z0 .. m1 - 1 (ld WP).
DEVI void update_warps(double* S, double* T, int WP, double* Q, int q0, double* Z, int z0,
                       int m1, const Smem& sm, const Meta& meta) {
  const int ut = threadIdx.x - 32, uw = ut >> 5;
  double* tile = sm.tiles + uw * 32 * kTl;
  for (int j = 0;; ++j) {
    const int slot = j & 1;
    bar_sync(kBarReady + slot);
    const int lo = meta.v[slot][0], amin = meta.v[slot][1];
    const int hi = meta.v[slot][2], flags = meta.v[slot][3], nsw = meta.v[slot][4];
    if (flags & 2) break;
    const int n = hi - amin;
    const double* swl = sm.ring + slot * kSegSwaps * kRec;
    // the rows above the segment that the next one reads (S's, then T's),
    // split over the update warps, then the chain warp may go on
    const int nr0 = lo - kSeg > 0 ? lo - kSeg : 0, nn = lo - nr0;
    if (nn > 0) {
      const int per = (2 * nn + kUpdWarps - 1) / kUpdWarps;
      const int e1 = min((uw + 1) * per, 2 * nn);
      for (int e0 = uw * per; e0 < e1;) {
        const int which = e0 / nn, r0 = nr0 + e0 % nn;
        const int r1 = min(lo, r0 + (e1 - e0));
        rows_replay(which ? T : S, WP, r0, r1 - r0, amin, n, swl, nsw, 1, tile);
        e0 += r1 - r0;
      }
    }
    if (flags & 1) bar_arrive(kBarNear + slot);
    // the rest, 32 rows or columns a task: S's and T's rows above those,
    // Z's and Q's rows, S's and T's rows of the segment right of it
    const int n2 = (nr0 + 31) / 32;
    const int nz = (m1 - z0 + 31) / 32, nq = (m1 - q0 + 31) / 32;
    const int n1 = (WP - hi + 31) / 32;
    const int ntask = 2 * n2 + nz + nq + 2 * n1;
    for (int t = uw; t < ntask; t += kUpdWarps) {
      if (t < 2 * n2) {
        const int tt = t % n2;
        const int r1 = nr0 - 32 * tt, r0 = r1 - 32 > 0 ? r1 - 32 : 0;
        rows_replay(t < n2 ? S : T, WP, r0, r1 - r0, amin, n, swl, nsw, 1, tile);
      } else if (t < 2 * n2 + nz + nq) {
        const int tt = t - 2 * n2;
        const bool isz = tt < nz;
        const int r0 = isz ? z0 + 32 * tt : q0 + 32 * (tt - nz);
        rows_replay(isz ? Z : Q, WP, r0, min(32, m1 - r0), amin, n, swl, nsw,
                    isz ? 1 : 0, tile);
      } else {
        const int tt = t - 2 * n2 - nz - nq;
        const int c0 = hi + 32 * (tt % n1);
        cols_replay(tt < n1 ? S : T, WP, amin, n, c0, min(32, WP - c0), swl, nsw, tile);
      }
    }
    bar_arrive(kBarFree + slot);
  }
}

// ---------------------------------------------------------------------------
// the chain warp
// ---------------------------------------------------------------------------

// The chain warp's state; every lane holds the same scalars.
struct Chain {
  double* S;
  double* T;
  int WP;
  int nlim;  // a block starting at i is 2x2 when i + 1 < nlim and sub[i] != 0
  Smem sm;
  Meta* meta;
  int posted = 0, freed = 0;  // segments handed over, ring slots taken back
  long long steps = 0, cap = 0;

  __device__ int bsize(int i) const {
    return (i + 1 < nlim && sm.sub[i] != 0.0) ? 2 : 1;
  }

  // wait until every posted segment is applied
  __device__ void drain() {
    while (freed < posted) {
      bar_sync(kBarFree + (freed & 1));
      ++freed;
    }
  }

  // post the stop flag (after drain)
  __device__ void stop() {
    const int lane = threadIdx.x & 31;
    if (lane == 0) meta->v[posted & 1][3] = 2;
    bar_arrive(kBarReady + (posted & 1));
  }

  // x[rows r0 .. r0+d-1, columns j] <- G^T x (rows right of the 4x4
  // inside a block, j from j0); cols_g: x[a row, columns r0 ..] <- x G
  // (the columns above it)
  template <int D>
  __device__ static void rows_gt(double* blk, int r0, int j0, int nb, const double* G) {
    const int lane = threadIdx.x & 31;
    for (int j = j0 + lane; j < nb; j += 32) {
      double r[4], o[4];
#pragma unroll
      for (int t = 0; t < 4; ++t) r[t] = t < D ? blk[(r0 + t) * kLd + j] : 0.0;
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        double acc = 0.0;
#pragma unroll
        for (int t = 0; t < 4; ++t)
          if (t < D) acc += G[t * 4 + i] * r[t];
        o[i] = acc;
      }
#pragma unroll
      for (int i = 0; i < 4; ++i)
        if (i < D) blk[(r0 + i) * kLd + j] = o[i];
    }
  }

  template <int D>
  __device__ static void cols_g(double* row, const double* G) {
    double x[4], o[4];
#pragma unroll
    for (int t = 0; t < 4; ++t) x[t] = t < D ? row[t] : 0.0;
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      double acc = 0.0;
#pragma unroll
      for (int t = 0; t < 4; ++t)
        if (t < D) acc += x[t] * G[t * 4 + i];
      o[i] = acc;
    }
#pragma unroll
    for (int i = 0; i < 4; ++i)
      if (i < D) row[i] = o[i];
  }

  template <int D>
  __device__ void apply_swap(double* bS, double* bT, int r0, int nb, const double* Qs,
                             const double* Zs, const double* Ah, const double* Bh) const {
    const int lane = threadIdx.x & 31;
    rows_gt<D>(bS, r0, r0 + D, nb, Qs);
    rows_gt<D>(bT, r0, r0 + D, nb, Qs);
    // the columns above the 4x4 inside the blocks
    for (int rr = lane; rr < r0; rr += 32) {
      cols_g<D>(bS + rr * kLd + r0, Zs);
      cols_g<D>(bT + rr * kLd + r0, Zs);
    }
#pragma unroll
    for (int e = 0; e < 16; ++e)
      if (lane == e && (e >> 2) < D && (e & 3) < D) {
        bS[(r0 + (e >> 2)) * kLd + r0 + (e & 3)] = Ah[e];
        bT[(r0 + (e >> 2)) * kLd + r0 + (e & 3)] = Bh[e];
      }
  }

  // Move the block starting at src up by adjacent swaps until it reaches
  // top (then top += its size), a swap is rejected, or steps reaches cap.
  // on_swap(c, p, q, accept, Qs) runs on every lane after each swap (the
  // caller's extra state; Qs the swap's left transform, every lane's
  // copy).  Returns kArrived, kRejected or kCapped.
  template <class OnSwap>
  __device__ int move(int src, int& top, OnSwap on_swap) {
    const int lane = threadIdx.x & 31;
    drain();
    bool cont = false;
    while (true) {
      const int hi = src + bsize(src);
      const int lo = max(max(hi - kSeg, 0), min(top, hi - 4));
      const int nb = hi - lo;
      if (cont) bar_sync(kBarNear + ((posted - 1) & 1));
      if (posted - freed == 2) {
        bar_sync(kBarFree + (freed & 1));
        ++freed;
      }
      const int slot = posted & 1;
      double* swl = sm.ring + slot * kSegSwaps * kRec;
      double* bS = sm.blk;
      double* bT = sm.blk + kSeg * kLd;
      for (int rb = 0; rb < nb; rb += 4) {  // a column a lane, 8 loads in flight
        double v[8];
#pragma unroll
        for (int u = 0; u < 4; ++u) {
          const bool ok = rb + u < nb && lane < nb;
          const size_t at = (size_t)(lo + rb + u) * WP + lo + lane;
          v[u] = ok ? S[at] : 0.0;
          v[4 + u] = ok ? T[at] : 0.0;
        }
#pragma unroll
        for (int u = 0; u < 4; ++u)
          if (rb + u < nb) {
            bS[(rb + u) * kLd + lane] = v[u];
            bT[(rb + u) * kLd + lane] = v[4 + u];
          }
      }
      __syncwarp();
      int amin = hi, nsw = 0, nlog = 0, why;
      while (true) {
        if (steps >= cap) { why = kCapped; break; }
        const int p = (src >= 2 && sm.sub[src - 2] != 0.0) ? 2 : 1;
        const int a = src - p;
        const int c = a > 0 ? a : 0;
        const int q = bsize(src);
        if (nsw == kSegSwaps || c < lo) { why = kLimit; break; }
        const int r0 = c - lo, d = p + q;
        double A4[16], B4[16], Qs[16], Zs[16], Ah[16], Bh[16];
#pragma unroll
        for (int r = 0; r < 4; ++r)
#pragma unroll
          for (int cc = 0; cc < 4; ++cc) {
            const bool in = r0 + r < nb && r0 + cc < nb;
            A4[r * 4 + cc] = in ? bS[(r0 + r) * kLd + r0 + cc] : 0.0;
            B4[r * 4 + cc] = in ? bT[(r0 + r) * kLd + r0 + cc] : 0.0;
          }
        const bool accept = swap_adjacent_gep_warp(A4, B4, p, q, Qs, Zs, Ah, Bh);
        __syncwarp();  // every lane has read the 4x4s
        if (accept) {
          switch (d) {
            case 2: apply_swap<2>(bS, bT, r0, nb, Qs, Zs, Ah, Bh); break;
            case 3: apply_swap<3>(bS, bT, r0, nb, Qs, Zs, Ah, Bh); break;
            default: apply_swap<4>(bS, bT, r0, nb, Qs, Zs, Ah, Bh); break;
          }
          double* rec = swl + nlog * kRec;
#pragma unroll
          for (int e = 0; e < 16; ++e)
            if (lane == e) {
              rec[2 + e] = Qs[e];
              rec[18 + e] = Zs[e];
            }
          if (lane == 16) {
            rec[0] = c;
            rec[1] = d;
          }
          ++nlog;
#pragma unroll
          for (int i = 0; i < 3; ++i)
            if (lane == i && i + 1 < d) sm.sub[c + i] = Ah[(i + 1) * 4 + i];
        }
        on_swap(c, p, q, accept, static_cast<const double*>(Qs));
        ++steps;
        ++nsw;
        __syncwarp();
        if (!accept) { why = kRejected; break; }
        amin = c;
        src = a;
        if (src == top) {
          top += q;
          why = kArrived;
          break;
        }
        if (src < 0) {  // only when top splits a 2x2 block (the bubble's guard)
          why = kArrived;
          break;
        }
      }
      if (amin < hi) {
        // the blocks' changed columns go back; the log goes to the update warps
        const int off = amin - lo, nc = hi - amin;
        for (int r = 0; r < nb; ++r)
          if (lane < nc) {
            const size_t at = (size_t)(lo + r) * WP + amin + lane;
            S[at] = bS[r * kLd + off + lane];
            T[at] = bT[r * kLd + off + lane];
          }
        if (lane == 0) {
          meta->v[slot][0] = lo;
          meta->v[slot][1] = amin;
          meta->v[slot][2] = hi;
          meta->v[slot][3] = why == kLimit ? 1 : 0;
          meta->v[slot][4] = nlog;
        }
        bar_arrive(kBarReady + slot);
        ++posted;
      }
      if (why != kLimit) return why;
      cont = true;
    }
  }
};

}  // namespace swap_chain_gep
