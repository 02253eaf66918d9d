// The swap-chain engine shared by B4 (aed_deflate.cu) and the window bubble
// (reorder_bubble.cu): one thread block moves 1x1/2x2 blocks of a
// quasi-triangular (WP x WP) matrix T toward the top by adjacent swaps, and
// applies every swap's transform to T and to the columns of a second matrix
// M (B4's V, the bubble's Q; ld WP).
//
// What bounds it on the H100: the serial chain of swaps.  Each swap's 4x4
// decision (swap_adjacent_warp in common.cuh) needs the previous swap's result on
// the diagonal, and the rest of its work (a rank-4 update of 4 full rows and
// 4 full columns of T and of 4 columns of M) is parallel but small: run
// block-wide after every swap, behind barriers, with the 4x4 read from
// global memory / L2, it would sit on the chain and take most of a swap.
//
// Design.  Warp 0 is the chain warp; warps 1..7 are update warps.
//   * Segments.  A move runs in segments of at most kSegSwaps swaps.  Before
//     a segment the chain warp loads the diagonal block T[lo:hi, lo:hi] it
//     will touch (hi the moving block's bottom + 1, hi - lo <= kSeg) into
//     shared memory and sets U = I.  Every lane runs the same
//     swap_adjacent_warp on the 4x4 (common.cuh: all in registers, the 4x4
//     products and the elimination spread over the lanes), and the warp
//     applies the swap to the segment's rows and columns inside the shared
//     block and to U; nothing goes to global memory inside a segment.
//   * The flush.  At a segment's end the chain warp writes the block back
//     and hands U (a two-slot ring) to the update warps, which apply it as
//     level-3 products: T[amin:hi, hi:] <- U^T T[amin:hi, hi:] (the rows
//     right of the segment), T[:lo, amin:hi] <- T[:lo, amin:hi] U (the
//     columns above it) and M[:, amin:hi] <- M[:, amin:hi] U, amin the
//     topmost row the segment moved.  A lane holds a column of U in
//     registers (so kSeg <= 32); 32 rows (or columns) at a time are staged
//     in the warp's tile with coalesced loads and read back two entries a
//     16-byte broadcast load.
//   * Overlap.  The next segment of the same move sits directly above and
//     needs only the kSeg rows just above this one in the columns above
//     (split over all update warps, done first, then a named barrier); the
//     update warps apply the rest while the chain warp runs on.  A new move
//     starts after every flush is applied (at most two are outstanding).
//   * The state the chain reads lives in shared memory, kept current by the
//     chain warp swap by swap: T's diagonal and subdiagonal, and what the
//     caller adds (B4: V's row 0, the spike; the bubble: the selection).
// Named barriers follow francis.cu: each kind alternates two ids by the
// segment's parity, so an id's instance completes before its reuse.
//
// Entries inside a segment see the same operations in the same order as in
// the plain twins (up to FMA contraction); the flushed parts take the
// accumulated U, which changes their rounding only.
#pragma once

#include "common.cuh"

namespace swap_chain {

constexpr int kThreads = 256;
constexpr int kUpd = kThreads - 32;       // threads of the update warps
constexpr int kUpdWarps = kUpd / 32;
constexpr int kSeg = 32;                  // rows of a segment's block at most:
                                          // a flush output column a lane
constexpr int kSegSwaps = kSeg - 4;       // swaps a segment at most
constexpr int kLd = kSeg + 1;             // odd: conflict-free lane rows
constexpr int kTl = kSeg + 2;             // even: 16-byte aligned tile rows

// named barriers (0 is __syncthreads), two ids each
constexpr int kBarReady = 1;  // chain -> update: a segment's U is posted
constexpr int kBarNear = 3;   // update -> chain: the rows above are done
constexpr int kBarFree = 5;   // update -> chain: the segment is applied

enum { kArrived = 0, kRejected = 1, kCapped = 2, kLimit = 3 };

__device__ __forceinline__ void bar_sync(int id) {
  __syncwarp();
  asm volatile("barrier.sync %0, %1;" ::"r"(id), "r"(kThreads) : "memory");
}
__device__ __forceinline__ void bar_arrive(int id) {
  __threadfence_block();
  __syncwarp();
  asm volatile("barrier.arrive %0, %1;" ::"r"(id), "r"(kThreads) : "memory");
}

// Dynamic shared memory: the ring, the segment block, the update warps'
// tiles, then T's diagonal and subdiagonal (n + 4 each) and the caller's
// extra state.
struct Smem {
  double* ring;   // 2 x kSeg x kLd: U of a segment, row-major
  double* blk;    // kSeg x kLd: the segment's diagonal block
  double* tiles;  // kUpdWarps x 32 x kTl
  double* diag;   // T[i][i]
  double* sub;    // T[i+1][i]
  double* extra;  // n + 4 doubles (B4's spike) or ints (the bubble's flags)
};

__host__ __device__ constexpr size_t smem_bytes(int n) {
  return sizeof(double) * ((size_t)(2 + 1) * kSeg * kLd +
                           (size_t)kUpdWarps * 32 * kTl + 3 * (size_t)(n + 4));
}

__device__ __forceinline__ Smem carve(double* base, int n) {
  Smem s;
  s.ring = base;
  s.blk = s.ring + 2 * kSeg * kLd;
  s.tiles = s.blk + kSeg * kLd;  // 3 kSeg kLd doubles: 16-byte aligned
  s.diag = s.tiles + kUpdWarps * 32 * kTl;
  s.sub = s.diag + (n + 4);
  s.extra = s.sub + (n + 4);
  return s;
}

// segment meta, per ring slot: lo (the block's top row), amin, hi, flags
// (bit 0: the move goes on, so the chain waits for the rows above; bit 1:
// stop, no more segments)
struct Meta {
  int v[2][4];
};

// ---------------------------------------------------------------------------
// the flush (update warps)
// ---------------------------------------------------------------------------
// A lane holds column `lane` of the segment's U (n x n, n <= 32) in
// registers and computes output column `lane` of each row: o = sum_k
// X[r][k] U[k][lane], in k order.  A row of X comes from the warp's tile,
// two entries a 16-byte broadcast load; four rows run at once.

// o[u] = sum_k tile[(rb + u) * kTl + k] ucol[k] for u < 4
__device__ __forceinline__ void tile_rows_times_u(const double* tile, int rb, int n,
                                                  const double (&ucol)[kSeg],
                                                  double (&o)[4]) {
#pragma unroll
  for (int u = 0; u < 4; ++u) o[u] = 0.0;
#pragma unroll
  for (int k = 0; k < kSeg; k += 2) {
    if (k < n) {
#pragma unroll
      for (int u = 0; u < 4; ++u) {
        const double2 xx = *reinterpret_cast<const double2*>(tile + (rb + u) * kTl + k);
        o[u] += xx.x * ucol[k];
        if (k + 1 < n) o[u] += xx.y * ucol[k + 1];
      }
    }
  }
}

// rows r0 .. r0 + nr - 1 (nr <= 32) of the row-major A (ld lda), columns
// c0 .. c0 + n - 1, times U: rows staged through the tile, coalesced
__device__ __forceinline__ void rows_times_u(double* A, int lda, int r0, int nr,
                                             int c0, int n, const double (&ucol)[kSeg],
                                             double* tile) {
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
  for (int rb = 0; rb < nr; rb += 4) {
    double o[4];
    tile_rows_times_u(tile, rb, n, ucol, o);
#pragma unroll
    for (int u = 0; u < 4; ++u)
      if (rb + u < nr && lane < n) A[(size_t)(r0 + rb + u) * lda + c0 + lane] = o[u];
  }
  __syncwarp();  // the tile is free
}

// columns c0 .. c0 + nc - 1 (nc <= 32) of rows a0 .. a0 + n - 1 of A, U^T
// times them: staged transposed (tile row = a column of A), the results
// back into the tile, then stored row by row, coalesced
__device__ __forceinline__ void cols_times_ut(double* A, int lda, int a0, int n,
                                              int c0, int nc, const double (&ucol)[kSeg],
                                              double* tile) {
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
  for (int cb = 0; cb < nc; cb += 4) {
    double o[4];
    tile_rows_times_u(tile, cb, n, ucol, o);
    __syncwarp();  // every lane has read these tile rows
#pragma unroll
    for (int u = 0; u < 4; ++u)
      if (cb + u < nc && lane < n) tile[(cb + u) * kTl + lane] = o[u];
  }
  __syncwarp();
  for (int k = 0; k < n; ++k)
    if (lane < nc) A[(size_t)(a0 + k) * lda + c0 + lane] = tile[lane * kTl + k];
  __syncwarp();  // the tile is free
}

// The update warps' loop: take segments from the ring until the stop flag.
// M has rows m0 .. m1 - 1 (ld WP) that take the transforms.
__device__ __forceinline__ void update_warps(double* T, int WP, double* M,
                                             int m0, int m1, const Smem& sm,
                                             const Meta& meta) {
  const int ut = threadIdx.x - 32, uw = ut >> 5, lane = threadIdx.x & 31;
  double* tile = sm.tiles + uw * 32 * kTl;
  for (int j = 0;; ++j) {
    const int slot = j & 1;
    bar_sync(kBarReady + slot);
    const int lo = meta.v[slot][0], amin = meta.v[slot][1];
    const int hi = meta.v[slot][2], flags = meta.v[slot][3];
    if (flags & 2) break;
    const int n = hi - amin, off = amin - lo;
    const double* U = sm.ring + slot * kSeg * kLd + off * kLd + off;
    double ucol[kSeg];
#pragma unroll
    for (int k = 0; k < kSeg; ++k) ucol[k] = (k < n && lane < n) ? U[k * kLd + lane] : 0.0;
    // the rows above the segment that the next one reads, split over the
    // update warps, then the chain warp may go on
    const int nr0 = lo - kSeg > 0 ? lo - kSeg : 0;
    const int per = (lo - nr0 + kUpdWarps - 1) / kUpdWarps;
    const int my0 = nr0 + uw * per, my1 = min(my0 + per, lo);
    if (my1 > my0) rows_times_u(T, WP, my0, my1 - my0, amin, n, ucol, tile);
    if (flags & 1) bar_arrive(kBarNear + slot);
    // the rest: T's rows above those, M's rows, T's rows of the segment
    // right of it, 32 at a time
    const int n2 = (nr0 + 31) / 32, n3 = (m1 - m0 + 31) / 32, n1 = (WP - hi + 31) / 32;
    for (int t = uw; t < n2 + n3 + n1; t += kUpdWarps) {
      if (t < n2) {
        const int r1 = nr0 - 32 * t, r0 = r1 - 32 > 0 ? r1 - 32 : 0;
        rows_times_u(T, WP, r0, r1 - r0, amin, n, ucol, tile);
      } else if (t < n2 + n3) {
        const int r0 = m0 + 32 * (t - n2);
        rows_times_u(M, WP, r0, min(32, m1 - r0), amin, n, ucol, tile);
      } else {
        const int c0 = hi + 32 * (t - n2 - n3);
        cols_times_ut(T, WP, amin, n, c0, min(32, WP - c0), ucol, tile);
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

  // Move the block starting at src up by adjacent swaps until it reaches
  // top (then top += its size), a swap is rejected, or steps reaches cap.
  // on_swap(c, p, q, accept, Qs) runs on every lane after each swap (the
  // caller's extra state).  Returns kArrived, kRejected or kCapped.
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
      double* U = sm.ring + slot * kSeg * kLd;
      double* blk = sm.blk;
      for (int rb = 0; rb < nb; rb += 8) {  // a column a lane, 8 loads in flight
        double v[8];
#pragma unroll
        for (int u = 0; u < 8; ++u)
          v[u] = (rb + u < nb && lane < nb) ? T[(size_t)(lo + rb + u) * WP + lo + lane] : 0.0;
#pragma unroll
        for (int u = 0; u < 8; ++u)
          if (rb + u < nb) {
            blk[(rb + u) * kLd + lane] = v[u];
            U[(rb + u) * kLd + lane] = rb + u == lane ? 1.0 : 0.0;
          }
      }
      __syncwarp();
      int amin = hi, nsw = 0, why;
      while (true) {
        if (steps >= cap) { why = kCapped; break; }
        const int p = (src >= 2 && sm.sub[src - 2] != 0.0) ? 2 : 1;
        const int a = src - p;
        const int c = a > 0 ? a : 0;
        const int q = bsize(src);
        if (nsw == kSegSwaps || c < lo) { why = kLimit; break; }
        const int r0 = c - lo, d = p + q;
        double D[16], Qs[16], Dh[16];
#pragma unroll
        for (int r = 0; r < 4; ++r)
#pragma unroll
          for (int cc = 0; cc < 4; ++cc)
            D[r * 4 + cc] = (r0 + r < nb && r0 + cc < nb)
                                ? blk[(r0 + r) * kLd + r0 + cc] : 0.0;
        const bool accept = swap_adjacent_warp(D, p, q, Qs, Dh);
        __syncwarp();  // every lane has read the 4x4
        if (accept) {
          // rows r0..r0+d-1 right of the 4x4, inside the block
          for (int j = r0 + d + lane; j < nb; j += 32) {
            double r[4], o[4];
#pragma unroll
            for (int t = 0; t < 4; ++t) r[t] = t < d ? blk[(r0 + t) * kLd + j] : 0.0;
#pragma unroll
            for (int i = 0; i < 4; ++i) {
              double acc = 0.0;
#pragma unroll
              for (int t = 0; t < 4; ++t)
                if (t < d) acc += Qs[t * 4 + i] * r[t];
              o[i] = acc;
            }
#pragma unroll
            for (int i = 0; i < 4; ++i)
              if (i < d) blk[(r0 + i) * kLd + j] = o[i];
          }
          // columns r0..r0+d-1 above the 4x4, inside the block; then U's
          // rows r0.. (its rows above r0 are zero in these columns)
          for (int rr = lane; rr < nb; rr += 32) {
            double* row = rr < r0 ? blk + rr * kLd + r0 : U + rr * kLd + r0;
            double x[4], o[4];
#pragma unroll
            for (int t = 0; t < 4; ++t) x[t] = t < d ? row[t] : 0.0;
#pragma unroll
            for (int i = 0; i < 4; ++i) {
              double acc = 0.0;
#pragma unroll
              for (int t = 0; t < 4; ++t)
                if (t < d) acc += x[t] * Qs[t * 4 + i];
              o[i] = acc;
            }
#pragma unroll
            for (int i = 0; i < 4; ++i)
              if (i < d) row[i] = o[i];
          }
#pragma unroll
          for (int e = 0; e < 16; ++e)
            if (lane == e && (e >> 2) < d && (e & 3) < d)
              blk[(r0 + (e >> 2)) * kLd + r0 + (e & 3)] = Dh[e];
#pragma unroll
          for (int i = 0; i < 4; ++i) {
            if (lane == i && i < d) sm.diag[c + i] = Dh[i * 5];
            if (lane == i && i + 1 < d) sm.sub[c + i] = Dh[(i + 1) * 4 + i];
          }
        }
        on_swap(c, p, q, accept, Qs);
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
        // the block's changed columns go back; U goes to the update warps
        const int off = amin - lo, nc = hi - amin;
        for (int r = 0; r < nb; ++r)
          if (lane < nc) T[(size_t)(lo + r) * WP + amin + lane] = blk[r * kLd + off + lane];
        if (lane == 0) {
          meta->v[slot][0] = lo;
          meta->v[slot][1] = amin;
          meta->v[slot][2] = hi;
          meta->v[slot][3] = why == kLimit ? 1 : 0;
        }
        bar_arrive(kBarReady + slot);
        ++posted;
      }
      if (why != kLimit) return why;
      cont = true;
    }
  }
};

}  // namespace swap_chain
