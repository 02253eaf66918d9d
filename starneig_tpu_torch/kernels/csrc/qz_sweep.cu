// G3: one hop (3B steps) of a B-bulge QZ train inside its (6B+4)-row window;
// its train mode (below) runs every hop of a train in two launches.
//
// Replaces the XLA fori_loop of starneig_tpu/ops/qz_driver.py:
// _qz_sweep_chunk (:444, run by _qz_sweep_batch :432 and _qz_iter :953-980),
// which updates full rows and columns of the padded pencil at every step.
// Plain twin: ops/qz_driver.py:_qz_train_hop; the driver's _qz_sweep runs
// a train as hops in windows and applies each window's transforms to the
// off-window strips and to Q, Z with GEMMs, as the SEP sweep does
// (ops/schur.py:_sweep_wave with train_hops.cu).
//
// Per step and active bulge b (k = l_rel + s - 3b): a left 3-reflector on
// rows k..k+2 of S and T (from the shifted product's first column at the
// bulge's introduction, else from the bulge column k-1), the bulge column
// planted, a right 3-reflector from T's row k+2 zeroing T[k+2, k:k+2], and a
// right rotation zeroing T[k+1, k]; Qw and Zw accumulate.
//
// What bounds it on the H100: not flops or bytes (a hop is ~2 MFLOP on
// 277 KB) but the step chain (3B steps a hop, each three dependent
// transforms a bulge, each a chain of divides and square roots) and the
// block's instruction issue: every chase warp computes its reflectors in
// all lanes and then its share of the updates, and at B = 12 a step takes
// ~6,800 cycles, in which a warp's part with no work of its own waits
// ~1,000 cycles for the SM's four schedulers (clock64, PERF.md).  The
// first form ran the whole block through every phase: one
// thread a bulge for each reflector and rotation, eight block barriers a
// step, updates at full window width with a division and a modulo on every
// element, Qw and Zw on the chain, and a row stride of WC = 6B+4 doubles
// (a multiple of 4 banks pairs: 4-way conflicts on column walks).
//
// Design.  S, T, Qw and Zw live in shared memory with the odd row stride
// WC + 1 (column walks conflict-free).
//   * The chase group: warp b owns bulge b and computes its transforms in
//     every lane.  A step has two phases, each ended by one named barrier
//     of the chase group.  Phase L: the left reflector (from the bulge
//     column, or the shifts at its introduction), its update of rows
//     k..k+2 (a lane a column, all its columns loaded before any is
//     updated), the plant; then, after __syncwarp, the right reflector from
//     T's row k+2 and the rotation from T's row k+1 after it, in registers;
//     the step's record goes to a ring slot, a value a lane.  Phase R: the
//     right reflector and the rotation in one pass over the rows of
//     columns k..k+2 (a lane a row, all its rows loaded first), with T's
//     plants.  The JAX order holds
//     where two bulges share entries: bulge b's left update reaches columns
//     k+3..k+5 that bulge b-1's right transforms update, and its right
//     transforms reach rows k-3..k-1 that bulge b+1's left update writes,
//     so every left update precedes every right one in a step, and no two
//     warps update one entry in a phase.
//   * The update group (kUpdWarps warps) owns Qw and Zw, which never feed
//     back into the chase: it takes each step's records from a ring of
//     kRing steps and applies them behind the chase, warp g mod kUpdWarps
//     a bulge g, a lane a row.  Two named barriers a slot hand it over
//     (the chase arrives, the update group waits) and back: blocked warps
//     take no issue slots, where polling a counter with __nanosleep let the
//     update group fall behind by its sleeps and the chase wait for slots
//     (clock64: ~700 cycles a step, PERF.md).
//   * Only the entries that can change are touched: the left update skips
//     S's columns left of k-1 and T's left of k (zeros: Hessenberg and
//     triangular form, the exact plants); the right transforms skip S's
//     rows below k+3 and T's below k+2 (zeros: the same, once every left
//     update of the step has planted its bulge column); Qw's and Zw's
//     updates skip the rows outside [min k, max k + 2] of the hop's steps
//     so far (identity rows, zero in those columns).  Subtracting tau v 0
//     from a zero leaves a zero, so the outputs equal the full-width
//     twin's (tests/test_torch_gep_driver.py:test_g3_ranges models these
//     ranges in torch and holds them to the twin entry for entry).  One
//     input breaks the zeros: a hop that introduces bulges at l_rel where
//     S[l_rel, l_rel - 1] != 0 (a sweep starts where that entry is zero,
//     but a caller may pass any window); its first reflector fills column
//     l_rel - 1 below the subdiagonal, so that hop runs at the full ranges.
// The reflectors are householder() and the rotations givens(), the plain
// twin's formulas; the updates differ from it only by fused multiply-adds.
#include "gep_common.cuh"

namespace {

constexpr int kMaxB = 13;      // WC = 6B+4 <= 82: four padded windows fit one block
constexpr int kUpdWarps = 4;   // the update group
constexpr int kMaxThreads = (kMaxB + kUpdWarps) * 32;
constexpr int kRing = 4;       // steps of records between the groups (a power of 2)
constexpr int kRec = 9;        // v1 v2 tau (v0 = 1), u0 u1 u2 tau_r, c, s
constexpr int kCols = 3;       // column blocks of 32 a lane covers: 96 >= WC
constexpr int kRowsR = 6;      // row blocks of 32 of the right update: 192 >= 2 WC + 1
constexpr int kBatchR = 3;     //   loaded together
// named barriers (0 is __syncthreads): the chase group's, the update
// group's, and for each ring slot one that hands its records to the update
// group (the chase arrives, the update group waits) and one that frees it
// (the update group arrives, the chase waits)
constexpr int kBarChase = 1, kBarUpd = 2, kBarReady = 3, kBarFree = 3 + kRing;

DEVI void bar_sync(int id, int nthreads) {
  asm volatile("barrier.sync %0, %1;" ::"r"(id), "r"(nthreads) : "memory");
}

DEVI void bar_arrive(int id, int nthreads) {
  __threadfence_block();
  __syncwarp();
  asm volatile("barrier.arrive %0, %1;" ::"r"(id), "r"(nthreads) : "memory");
}

// (I - tau v v^T) on the column entries (a, b, c), v = (1, v1, v2)
DEVI void refl_left(double& a, double& b, double& c, double v1, double v2, double tau) {
  const double s = a + v1 * b + v2 * c;
  a -= tau * s;
  b -= tau * (v1 * s);
  c -= tau * (v2 * s);
}

// the row entries (a, b, c) times (I - tau u u^T)
DEVI void refl_right(double& a, double& b, double& c, const double* u, double tau) {
  const double s = a * u[0] + b * u[1] + c * u[2];
  a -= tau * (s * u[0]);
  b -= tau * (s * u[1]);
  c -= tau * (s * u[2]);
}

// the left reflector on rows (p, p + ld, p + 2 ld) over the columns
// [c0, WC), a lane a column, every lane's loads before its updates; the
// column `plant` (the bulge column) set to (beta, 0, 0 where use3) instead
DEVI void left_rows(double* p, int ld, int c0, int WC, double v1, double v2, double tau,
                    int plant, double beta, bool use3) {
  const int lane = threadIdx.x & 31;
  double a[kCols][3];
#pragma unroll
  for (int i = 0; i < kCols; ++i) {
    const int c = c0 + lane + 32 * i;
    if (c < WC) {
      a[i][0] = p[c];
      a[i][1] = p[ld + c];
      a[i][2] = p[2 * ld + c];
    }
  }
#pragma unroll
  for (int i = 0; i < kCols; ++i) {
    const int c = c0 + lane + 32 * i;
    if (c < WC) {
      refl_left(a[i][0], a[i][1], a[i][2], v1, v2, tau);
      if (c == plant) {
        a[i][0] = beta;
        a[i][1] = 0.0;
        if (use3) a[i][2] = 0.0;
      }
      p[c] = a[i][0];
      p[ld + c] = a[i][1];
      p[2 * ld + c] = a[i][2];
    }
  }
}

// the right reflector (where use3) and the rotation on columns k..k+2 of
// the rows e in [e0, e0 + 32 kBatch) of the list S's rows 0..rS-1 then
// T's rows 0..rT-1, a lane a row, its loads before its updates; T's plants
template <int kBatch>
DEVI void right_rows(double* S, double* T, int ld, int k, int rS, int rT, int e0,
                     const double* u, double taur, double c2, double s2, bool use3) {
  const int lane = threadIdx.x & 31;
  double q[kBatch][3];
#pragma unroll
  for (int i = 0; i < kBatch; ++i) {
    const int e = e0 + lane + 32 * i;
    if (e < rS + rT) {
      const double* p = (e >= rS ? T + (e - rS) * ld : S + e * ld) + k;
      q[i][0] = p[0];
      q[i][1] = p[1];
      q[i][2] = p[2];
    }
  }
#pragma unroll
  for (int i = 0; i < kBatch; ++i) {
    const int e = e0 + lane + 32 * i;
    if (e < rS + rT) {
      const bool isT = e >= rS;
      const int r = isT ? e - rS : e;
      double aa = q[i][0], bb = q[i][1];
      if (use3) {
        refl_right(aa, bb, q[i][2], u, taur);
        if (isT && r == k + 2) {
          aa = 0.0;
          bb = 0.0;
        }
      }
      double* p = (isT ? T : S) + r * ld + k;
      const double n0 = c2 * aa - s2 * bb, n1 = s2 * aa + c2 * bb;
      p[0] = isT && r == k + 1 ? 0.0 : n0;
      p[1] = n1;
      p[2] = q[i][2];
    }
  }
}

// the left reflector's input at an introduction: the first column of the
// shifted pencil product (out of line: at most one step a bulge a hop)
__device__ __noinline__ void intro_column(const double* S, const double* T, int ld, int l,
                                          const double* sh, bool use3, double* x) {
  first_col_qz(S, T, ld, l, sh, use3, true, x);
}

struct Hop {
  int WC, ld, B, HOP, l_rel, ihi_rel, s0;
  bool full;
};

// the chase group: warp b runs bulge b's transforms on S and T
DEVI void chase(const Hop& h, double* S, double* T, double* ring, int* ring_k,
                const double* sh) {
  const int b = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int ld = h.ld, WC = h.WC, nchase = h.B * 32, nall = nchase + kUpdWarps * 32;
  for (int t = 0; t < h.HOP; ++t) {
    const int k = h.l_rel + h.s0 + t - 3 * b;
    const bool active = k >= h.l_rel && k <= h.ihi_rel - 2;
    const bool use3 = k <= h.ihi_rel - 3;
    const int slot = t & (kRing - 1);
    if (t >= kRing) bar_sync(kBarFree + slot, nall);  // the update group read the slot
    double u[3] = {0.0, 0.0, 0.0}, taur = 0.0, c2 = 1.0, s2 = 0.0;
    if (active) {
      // ---- phase L: the left reflector and its update of rows k..k+2 ----
      const bool intro = k == h.l_rel;
      double x[3];
      if (intro) {
        intro_column(S, T, ld, k, sh + 4 * b, use3, x);
      } else {
        x[0] = S[k * ld + k - 1];
        x[1] = S[(k + 1) * ld + k - 1];
        x[2] = S[(k + 2) * ld + k - 1];
      }
      double v[3], tau, beta;
      householder(x, use3 ? 7u : 3u, 3, v, tau, beta);
      const double v1 = v[1], v2 = v[2];
      const int cS = h.full ? 0 : (k >= 1 ? k - 1 : 0), cT = h.full ? 0 : k;
      left_rows(S + k * ld, ld, cS, WC, v1, v2, tau, !intro ? k - 1 : -1, beta, use3);
      left_rows(T + k * ld, ld, cT, WC, v1, v2, tau, -1, 0.0, false);
      __syncwarp();
      // the right reflector from T's row k+2 (reversed) and the rotation
      // from T's row k+1 after it, in every lane
      double r1[3] = {T[(k + 1) * ld + k], T[(k + 1) * ld + k + 1], T[(k + 1) * ld + k + 2]};
      if (use3) {
        const double xr[3] = {T[(k + 2) * ld + k + 2], T[(k + 2) * ld + k + 1],
                              T[(k + 2) * ld + k]};
        double vr[3], br;
        householder(xr, 7u, 3, vr, taur, br);
        u[0] = vr[2];
        u[1] = vr[1];
        u[2] = vr[0];
        refl_right(r1[0], r1[1], r1[2], u, taur);
      }
      double rr;
      givens(r1[1], r1[0], c2, s2, rr);
      // the step's record, a value a lane
      const double rv[kRec] = {v1, v2, tau, u[0], u[1], u[2], taur, c2, s2};
      double val = rv[0];
#pragma unroll
      for (int j = 1; j < kRec; ++j)
        if (lane == j) val = rv[j];
      if (lane < kRec) ring[(slot * h.B + b) * kRec + lane] = val;
    }
    if (lane == 0) ring_k[slot * h.B + b] = active ? (k << 1) | (use3 ? 1 : 0) : -1;
    bar_arrive(kBarReady + slot, nall);  // the update group takes the step
    bar_sync(kBarChase, nchase);
    // ---- phase R: the right reflector and the rotation on columns
    // k..k+2, S's rows 0..k+3 and T's rows 0..k+2, T's plants; every
    // lane's rows loaded before any is updated ----
    if (active) {
      const int rS = h.full ? WC : min(k + 4, WC), rT = h.full ? WC : k + 3;
#pragma unroll
      for (int e0 = 0; e0 < 32 * kRowsR; e0 += 32 * kBatchR)
        if (e0 < rS + rT) right_rows<kBatchR>(S, T, ld, k, rS, rT, e0, u, taur, c2, s2, use3);
    }
    bar_sync(kBarChase, nchase);
  }
}

// the update group: Qw's left reflectors and Zw's right reflectors and
// rotations, behind the chase, on the rows [qlo, qhi)
DEVI void update(const Hop& h, double* Qw, double* Zw, const double* ring,
                 const int* ring_k) {
  const int ut = threadIdx.x - h.B * 32, uw = ut >> 5, lane = ut & 31;
  const int ld = h.ld, nall = h.B * 32 + kUpdWarps * 32;
  int qlo = h.full ? 0 : h.WC, qhi = h.full ? h.WC : 0;
  for (int t = 0; t < h.HOP; ++t) {
    const int slot = t & (kRing - 1);
    bar_sync(kBarReady + slot, nall);  // the chase's records of step t
    const int* ks = ring_k + slot * h.B;
    for (int g = 0; g < h.B; ++g) {
      const int kk = ks[g];
      if (kk >= 0) {
        qlo = min(qlo, kk >> 1);
        qhi = max(qhi, (kk >> 1) + 3);
      }
    }
    for (int g = uw; g < h.B; g += kUpdWarps) {
      const int kk = ks[g];
      if (kk < 0) continue;
      const int k = kk >> 1;
      const bool use3 = kk & 1;
      const double* rc = ring + (slot * h.B + g) * kRec;
      const double v1 = rc[0], v2 = rc[1], tau = rc[2];
      const double u[3] = {rc[3], rc[4], rc[5]};
      const double taur = rc[6], c2 = rc[7], s2 = rc[8];
      double w[kCols][3];
      // Qw[:, k:k+3] -= tau (Qw[:, k:k+3] v) v^T
#pragma unroll
      for (int i = 0; i < kCols; ++i) {
        const int r = qlo + lane + 32 * i;
        if (r < qhi) {
          const double* q = Qw + r * ld + k;
          w[i][0] = q[0];
          w[i][1] = q[1];
          w[i][2] = q[2];
        }
      }
#pragma unroll
      for (int i = 0; i < kCols; ++i) {
        const int r = qlo + lane + 32 * i;
        if (r < qhi) {
          double* q = Qw + r * ld + k;
          const double sq = w[i][0] + w[i][1] * v1 + w[i][2] * v2;
          q[0] = w[i][0] - tau * sq;
          q[1] = w[i][1] - tau * (sq * v1);
          q[2] = w[i][2] - tau * (sq * v2);
        }
      }
      // Zw's columns k..k+2: the right reflector, then the rotation
#pragma unroll
      for (int i = 0; i < kCols; ++i) {
        const int r = qlo + lane + 32 * i;
        if (r < qhi) {
          const double* z = Zw + r * ld + k;
          w[i][0] = z[0];
          w[i][1] = z[1];
          w[i][2] = z[2];
        }
      }
#pragma unroll
      for (int i = 0; i < kCols; ++i) {
        const int r = qlo + lane + 32 * i;
        if (r < qhi) {
          double* z = Zw + r * ld + k;
          if (use3) refl_right(w[i][0], w[i][1], w[i][2], u, taur);
          z[0] = c2 * w[i][0] - s2 * w[i][1];
          z[1] = s2 * w[i][0] + c2 * w[i][1];
          z[2] = w[i][2];
        }
      }
    }
    bar_sync(kBarUpd, kUpdWarps * 32);  // the rows are done
    if (t + kRing < h.HOP) bar_arrive(kBarFree + slot, nall);  // the slot is read
  }
}

__global__ void __launch_bounds__(kMaxThreads)
qz_sweep_kernel(double* __restrict__ Sg, double* __restrict__ Tg,
                double* __restrict__ Qg, double* __restrict__ Zg,
                const double* __restrict__ shifts, int WC, int B, int HOP,
                int l_rel, int ihi_rel, int s0) {
  extern __shared__ __align__(16) double smem[];
  __shared__ int ring_k[kRing * kMaxB];
  const int ld = WC + 1;
  double* S = smem;
  double* T = S + WC * ld;
  double* Qw = T + WC * ld;
  double* Zw = Qw + WC * ld;
  double* ring = Zw + WC * ld;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int nwarps = blockDim.x >> 5;
  for (int r = warp; r < WC; r += nwarps)
    for (int c = lane; c < WC; c += 32) {
      S[r * ld + c] = Sg[r * WC + c];
      T[r * ld + c] = Tg[r * WC + c];
      const double one = r == c ? 1.0 : 0.0;
      Qw[r * ld + c] = one;
      Zw[r * ld + c] = one;
    }
  __syncthreads();
  // the full ranges where an introduction meets a nonzero subdiagonal
  const int b_first = s0 <= 0 ? 0 : (s0 + 2) / 3;  // bulge b enters at step 3b
  const bool intro_hop = b_first < B && 3 * b_first < s0 + HOP;
  const bool full = intro_hop && l_rel >= 1 && l_rel < WC &&
                    S[l_rel * ld + l_rel - 1] != 0.0;
  const Hop h{WC, ld, B, HOP, l_rel, ihi_rel, s0, full};
  if (warp < B)
    chase(h, S, T, ring, ring_k, shifts);
  else
    update(h, Qw, Zw, ring, ring_k);
  __syncthreads();
  for (int r = warp; r < WC; r += nwarps)
    for (int c = lane; c < WC; c += 32) {
      Sg[r * WC + c] = S[r * ld + c];
      Tg[r * WC + c] = T[r * ld + c];
      Qg[r * WC + c] = Qw[r * ld + c];
      Zg[r * WC + c] = Zw[r * ld + c];
    }
}

size_t smem_bytes(int B, int WC) {
  return sizeof(double) * (4 * (size_t)WC * (WC + 1) + (size_t)kRing * B * kRec);
}

}  // namespace

extern "C" int qz_sweep(void* S, void* T, void* Qw, void* Zw, void* shifts,
                        int WC, int B, int HOP, int l_rel, int ihi_rel, int s0,
                        void* stream) {
  if (B < 1 || B > kMaxB || WC != 6 * B + 4 || HOP < 0)
    return static_cast<int>(cudaErrorInvalidValue);
  static bool configured = false;
  if (!configured) {
    cudaError_t e = cudaFuncSetAttribute(qz_sweep_kernel,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         (int)smem_bytes(kMaxB, 6 * kMaxB + 4));
    if (e != cudaSuccess) return static_cast<int>(e);
    configured = true;
  }
  qz_sweep_kernel<<<1, (B + kUpdWarps) * 32, smem_bytes(B, WC),
                    static_cast<cudaStream_t>(stream)>>>(
      static_cast<double*>(S), static_cast<double*>(T), static_cast<double*>(Qw),
      static_cast<double*>(Zw), static_cast<const double*>(shifts), WC, B, HOP,
      l_rel, ihi_rel, s0);
  return static_cast<int>(cudaGetLastError());
}

// ---------------------------------------------------------------------------
// Train mode: every hop of a train in two launches, in place on the padded
// pencil (ops/qz_driver.py:_qz_train; the hop loop it replaces on the
// dense card path is _qz_sweep, which stays for the DM path and the CPU).
//
// What bounded the hop loop: the host.  A hop was about 17 device
// operations queued from Python (G3 on copies of the window, the strip
// GEMMs and their copies), longer on the host than on the card, so the card
// idled about 0.3 ms a hop of its 0.14 ms of G3 (PERF.md, section 5).
//
// Design.
//   * qz_train_kernel, one cooperative launch.  Block 0 chases the hops in
//     the JAX order with G3's chase and update groups unchanged: it loads
//     the hop's (WC, WC) window pair from the padded buffers, runs 3B steps,
//     writes the window back and the hop's Qw and Zw to a stack (H, WC, WC)
//     each, and publishes the hop.  The window of hop h+1 takes the columns
//     [we_h, we_h + 3B) (tile h) new, and their rows carry the left
//     transforms of EVERY earlier hop: hop h mixes rows that hop h-1 mixed,
//     and so on back to the first, so no fixed band of columns past the
//     window can be brought up to date by the chase alone.  The other blocks
//     keep the row strips current: block 1 + w owns the column tiles j = w,
//     w + W, ... (3B columns each, from we_0 to the buffer's edge) and
//     applies each published hop to them in hop order, Qw^T on the hop's WC
//     rows; it hands tile j to the chase after hop j-1 (a flag), and the
//     chase applies hop j there itself before loading window j+1.  Tiles
//     past the train's windows take every hop from their owner.  Tile j is
//     written by one block at a time, so no entry races.  The same blocks
//     apply each hop's Qw to Q's and Zw to Z's columns [ws_h, ws_h + WC), a
//     tile of four rows a warp, while the chase runs on: no window reads
//     Q or Z, and no left transform reaches them.
//   * qz_train_far_kernel, one launch after it: the right transforms of S's
//     and T's rows above each window, which the strips' left transforms
//     also reach (so they wait for them): a block a tile of kFarRows rows
//     of S or T, each hop's Zw on its WC columns in hop order.
// Each entry takes its left transforms in hop order and its right ones in
// hop order; the two sides commute, so the result equals the hop loop's up
// to the order of sums (cuBLAS's there, a thread's dot here).  What bounds
// it: the chase, block 0's serial chain (G3's, about 0.14 ms a hop at
// B = 12), plus a tile's left product a hop (WC x 3B x WC multiply-adds on
// one SM); the strips and the far pass are parallel over tiles and stay off
// that chain.
// ---------------------------------------------------------------------------
namespace {

constexpr int kFarWarps = 16;               // the far pass: 4 rows a warp
constexpr int kFarRows = 4 * kFarWarps;     //   rows a block

__device__ __forceinline__ unsigned ld_acquire(const unsigned* p) {
  unsigned v;
  asm volatile("ld.acquire.gpu.global.u32 %0, [%1];" : "=r"(v) : "l"(p) : "memory");
  return v;
}

__device__ __forceinline__ void st_release(unsigned* p, unsigned v) {
  asm volatile("st.release.gpu.global.u32 [%0], %1;" ::"l"(p), "r"(v) : "memory");
}

// thread 0 waits until *flag reaches at_least, then the block goes on (it
// polls every ~0.2 us: a hop takes ~140 us, and ~100 blocks polling one
// line would crowd the chase's L2 traffic); a wait of ~10 s (a block that
// never publishes) traps, failing the launch where it would hang the card
DEVI void block_wait(const unsigned* flag, unsigned at_least) {
  if (threadIdx.x == 0) {
    const long long t0 = clock64();
    while (ld_acquire(flag) < at_least) {
      __nanosleep(200);
      if (clock64() - t0 > 20000000000LL) __trap();
    }
  }
  __syncthreads();
}

// every thread's global writes, then *flag = v for the other blocks
DEVI void block_publish(unsigned* flag, unsigned v) {
  __threadfence();
  __syncthreads();
  if (threadIdx.x == 0) st_release(flag, v);
}

struct Train {
  double* S;            // the padded pencil, NP x NP, row stride NP
  double* T;
  double* Q;            // n x NP, row stride NP
  double* Z;
  double* Qs;           // the hops' Qw, (H, WC, WC), then their Zw
  double* Zs;
  const double* sh;     // the train's shifts, (B, 4)
  unsigned* sync;       // [0] the hops published; [1 + j] tile j handed over
  int NP, n, WC, B, HOP, l, ihi, H, J, tQZ, W;
};

// rows [ws, ws + m) x columns [c0, c0 + nc) of the padded M into shared X
// (row stride lx).  Every load of what another block may have written goes
// through L2 (__ldcg), here and below: L1 is not coherent across SMs, and
// a line this SM cached beside its own columns can hold another block's
// stale entries
DEVI void stage(const double* M, int NP, int ws, int c0, int m, int nc, double* X, int lx) {
  for (int e = threadIdx.x; e < m * nc; e += blockDim.x) {
    const int r = e / nc, c = e % nc;
    X[r * lx + c] = __ldcg(M + (size_t)(ws + r) * NP + c0 + c);
  }
}

// rows [ws, ws + m) x columns [c0, c0 + nc) of the padded S and T = Qw^T
// X: Qw in shared memory (m x m, row stride lq), XS and XT their staged
// rows; a thread an output column and four rows of one of them
DEVI void left_apply(const double* Qw, int lq, const double* XS, const double* XT, int lx,
                     int m, int nc, double* S, double* T, int NP, int ws, int c0) {
  constexpr int kR = 4;
  const int nrb = (m + kR - 1) / kR;
  for (int e = threadIdx.x; e < 2 * nrb * nc; e += blockDim.x) {
    const bool second = e >= nrb * nc;
    const double* X = second ? XT : XS;
    double* M = second ? T : S;
    const int f = second ? e - nrb * nc : e;
    const int c = f % nc, i0 = (f / nc) * kR;
    int ic[kR];
#pragma unroll
    for (int r = 0; r < kR; ++r) ic[r] = min(i0 + r, m - 1);
    double acc[kR] = {0.0, 0.0, 0.0, 0.0};
    for (int j = 0; j < m; ++j) {
      const double x = X[j * lx + c];
#pragma unroll
      for (int r = 0; r < kR; ++r) acc[r] = fma(Qw[j * lq + ic[r]], x, acc[r]);
    }
#pragma unroll
    for (int r = 0; r < kR; ++r)
      if (i0 + r < m) M[(size_t)(ws + i0 + r) * NP + c0 + c] = acc[r];
  }
}

// rows [r0, r0 + nr) x columns [ws, ws + m) of the padded M = X Mw: Mw in
// shared memory (m x m, row stride lm), X those rows staged (row stride
// lx); a warp four rows at a time, a lane a column of each block of 32 (m
// <= 96), every product a 4 x 3 register tile
DEVI void right_apply(const double* Mw, int lm, const double* X, int lx, int nr, int m,
                      double* M, int NP, int r0, int ws) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31, nw = blockDim.x >> 5;
  for (int rw = 4 * warp; rw < nr; rw += 4 * nw) {
    double acc[4][kCols] = {};
    int cc[kCols], rr[4];
#pragma unroll
    for (int q = 0; q < kCols; ++q) cc[q] = min(lane + 32 * q, m - 1);
#pragma unroll
    for (int r = 0; r < 4; ++r) rr[r] = min(rw + r, nr - 1);
    for (int k = 0; k < m; ++k) {
      double mk[kCols], xk[4];
#pragma unroll
      for (int q = 0; q < kCols; ++q) mk[q] = Mw[k * lm + cc[q]];
#pragma unroll
      for (int r = 0; r < 4; ++r) xk[r] = X[rr[r] * lx + k];
#pragma unroll
      for (int r = 0; r < 4; ++r)
#pragma unroll
        for (int q = 0; q < kCols; ++q) acc[r][q] = fma(xk[r], mk[q], acc[r][q]);
    }
#pragma unroll
    for (int r = 0; r < 4; ++r)
#pragma unroll
      for (int q = 0; q < kCols; ++q) {
        const int c = lane + 32 * q;
        if (rw + r < nr && c < m) M[(size_t)(r0 + rw + r) * NP + ws + c] = acc[r][q];
      }
  }
}

// hop h's left transform on tile j's columns of S and T (X staged into XS,
// XT of row stride lx); ends with the block synchronized
DEVI void tile_left(const Train& p, const double* Qw, int lq, int h, int j, double* XS,
                    double* XT, int lx) {
  const int ws = p.l + h * p.HOP - 3 * (p.B - 1) - 1;
  const int c0 = p.l - 3 * (p.B - 1) - 1 + p.WC + j * p.HOP;
  const int nc = min(p.HOP, p.NP - c0);
  stage(p.S, p.NP, ws, c0, p.WC, nc, XS, lx);
  stage(p.T, p.NP, ws, c0, p.WC, nc, XT, lx);
  __syncthreads();
  left_apply(Qw, lq, XS, XT, lx, p.WC, nc, p.S, p.T, p.NP, ws, c0);
  __syncthreads();
}

DEVI void train_chase(const Train& p, double* smem, int* ring_k) {
  const int WC = p.WC, ld = WC + 1, NP = p.NP;
  double* S = smem;
  double* T = S + WC * ld;
  double* Qw = T + WC * ld;
  double* Zw = Qw + WC * ld;
  double* ring = Zw + WC * ld;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int nwarps = blockDim.x >> 5;
  for (int h = 0; h < p.H; ++h) {
    const int s0 = h * p.HOP, ws = p.l + s0 - 3 * (p.B - 1) - 1;
    double* Sg = p.S + (size_t)ws * NP + ws;
    double* Tg = p.T + (size_t)ws * NP + ws;
    for (int r = warp; r < WC; r += nwarps)
      for (int c = lane; c < WC; c += 32) {
        S[r * ld + c] = __ldcg(Sg + (size_t)r * NP + c);
        T[r * ld + c] = __ldcg(Tg + (size_t)r * NP + c);
        const double one = r == c ? 1.0 : 0.0;
        Qw[r * ld + c] = one;
        Zw[r * ld + c] = one;
      }
    __syncthreads();
    // the hop kernel's rule for the full ranges
    const int l_rel = p.l - ws;
    const int b_first = s0 <= 0 ? 0 : (s0 + 2) / 3;
    const bool intro_hop = b_first < p.B && 3 * b_first < s0 + p.HOP;
    const bool full = intro_hop && l_rel >= 1 && l_rel < WC && S[l_rel * ld + l_rel - 1] != 0.0;
    const Hop hp{WC, ld, p.B, p.HOP, l_rel, p.ihi - ws, s0, full};
    if (warp < p.B)
      chase(hp, S, T, ring, ring_k, p.sh);
    else
      update(hp, Qw, Zw, ring, ring_k);
    __syncthreads();
    double* Qh = p.Qs + (size_t)h * WC * WC;
    double* Zh = p.Zs + (size_t)h * WC * WC;
    for (int r = warp; r < WC; r += nwarps)
      for (int c = lane; c < WC; c += 32) {
        Sg[(size_t)r * NP + c] = S[r * ld + c];
        Tg[(size_t)r * NP + c] = T[r * ld + c];
        Qh[r * WC + c] = Qw[r * ld + c];
        Zh[r * WC + c] = Zw[r * ld + c];
      }
    block_publish(p.sync, h + 1);
    if (h + 1 < p.H) {
      // tile h, which window h+1 takes new: hops 0..h-1 from its owner,
      // hop h here (S's and T's areas stage it)
      if (h > 0) block_wait(p.sync + 1 + h, 1u);
      tile_left(p, Qw, ld, h, h, S, T, p.HOP + 1);
    }
  }
}

DEVI void train_strips(const Train& p, double* smem) {
  const int WC = p.WC, ld = WC + 1, w = blockIdx.x - 1;
  const int nq = 2 * p.tQZ;           // Q's row tiles, then Z's
  double* Qw = smem;
  double* Zw = Qw + WC * ld;
  double* XS = Zw + WC * ld;          // a tile's S and T rows, or Q's or Z's
  double* XT = XS + WC * (p.HOP + 1);
  // hop h reaches tile j where the chase does not: j > h, or no window
  // takes the tile (j >= H - 1); Q and Z take every hop
  auto takes = [&](int h, int j) { return h < j || j >= p.H - 1; };
  for (int h = 0; h < p.H; ++h) {
    bool any = w < nq;
    for (int j = w; j < p.J; j += p.W) any = any || takes(h, j);
    if (!any) break;
    block_wait(p.sync, h + 1);
    const double* Qh = p.Qs + (size_t)h * WC * WC;
    const double* Zh = p.Zs + (size_t)h * WC * WC;
    for (int e = threadIdx.x; e < WC * WC; e += blockDim.x) {
      Qw[(e / WC) * ld + e % WC] = __ldcg(Qh + e);
      if (w < nq) Zw[(e / WC) * ld + e % WC] = __ldcg(Zh + e);
    }
    __syncthreads();
    for (int j = w; j < p.J; j += p.W) {
      if (!takes(h, j)) continue;
      tile_left(p, Qw, ld, h, j, XS, XT, p.HOP + 1);
      if (h == j - 1 && j + 1 < p.H) block_publish(p.sync + 1 + j, 1u);
    }
    const int ws = p.l + h * p.HOP - 3 * (p.B - 1) - 1;
    for (int q = w; q < nq; q += p.W) {
      const bool isq = q < p.tQZ;
      double* M = isq ? p.Q : p.Z;
      const int r0 = (isq ? q : q - p.tQZ) * 4 * (blockDim.x >> 5);
      const int nr = min(4 * (int)(blockDim.x >> 5), p.n - r0);
      stage(M, p.NP, r0, ws, nr, WC, XS, WC);
      __syncthreads();
      right_apply(isq ? Qw : Zw, ld, XS, WC, nr, WC, M, p.NP, r0, ws);
      __syncthreads();
    }
  }
}

__global__ void __launch_bounds__(kMaxThreads) qz_train_kernel(Train p) {
  extern __shared__ __align__(16) double smem[];
  __shared__ int ring_k[kRing * kMaxB];
  if (blockIdx.x == 0)
    train_chase(p, smem, ring_k);
  else
    train_strips(p, smem);
}

struct Far {
  double* M[2];         // S, T (NP x NP, row stride NP)
  const double* Zs;     // the hops' Zw, (H, WC, WC)
  int NP, WC, B, HOP, l, H, tST;
};

// The right transforms of S and T: block b a tile of kFarRows rows of S
// (b < tST: the rows above the last window) or T; hop h's Zw on the
// columns [ws_h, ws_h + WC) of its rows above ws_h, in hop order.
__global__ void __launch_bounds__(kFarWarps * 32) qz_train_far_kernel(Far p) {
  extern __shared__ __align__(16) double smem[];
  const int WC = p.WC, NP = p.NP;
  double* Mw = smem;                  // WC x WC
  double* X = Mw + WC * WC;           // kFarRows x WC
  const int m = blockIdx.x < p.tST ? 0 : 1;
  double* A = p.M[m];
  const int r0 = (blockIdx.x - m * p.tST) * kFarRows;
  for (int h = 0; h < p.H; ++h) {
    const int ws = p.l + h * p.HOP - 3 * (p.B - 1) - 1;
    const int nr = min(kFarRows, ws - r0);
    if (nr <= 0) continue;
    const double* Mh = p.Zs + (size_t)h * WC * WC;
    for (int e = threadIdx.x; e < WC * WC; e += blockDim.x) Mw[e] = Mh[e];
    stage(A, NP, r0, ws, nr, WC, X, WC);
    __syncthreads();
    right_apply(Mw, WC, X, WC, nr, WC, A, NP, r0, ws);
    __syncthreads();
  }
}

size_t train_smem_bytes(int B, int WC) { return smem_bytes(B, WC); }

size_t far_smem_bytes(int WC) {
  return sizeof(double) * ((size_t)WC * WC + (size_t)kFarRows * WC);
}

}  // namespace

// One B-bulge train across the padded segment [l, ihi), in place: S, T
// (NP x NP), Q, Z (n x NP), all row-major with row stride NP; stack (2, H,
// WC, WC) the hops' Qw then Zw; sync (NP + 1) unsigned ints, zeroed (sync[0]
// ends at the hops the chase ran); H the train's hops (ops/gpu_gep.py:
// sweep_hops).  S[ihi, ihi-1] = 0, as the hop kernel's ranges assume.  Two
// launches: the chase with the row strips and Q's and Z's products
// (cooperative: its blocks wait on each other), then S's and T's right
// transforms.
extern "C" int qz_train(void* S, void* T, void* Q, void* Z, void* stack, void* shifts,
                        void* sync, int NP, int n, int B, int l, int ihi, int H,
                        void* stream) {
  const int WC = 6 * B + 4, HOP = 3 * B;
  const int ws0 = l - 3 * (B - 1) - 1;
  if (B < 1 || B > kMaxB || H < 1 || ws0 < 0 || ws0 + (H - 1) * HOP + WC > NP || ihi > NP ||
      n > NP)
    return static_cast<int>(cudaErrorInvalidValue);
  const int J = (NP - ws0 - WC + HOP - 1) / HOP;
  const int nthreads = (B + kUpdWarps) * 32;
  const size_t smem = train_smem_bytes(B, WC);
  static bool configured = false;
  cudaError_t e = cudaSuccess;
  if (!configured) {
    e = cudaFuncSetAttribute(qz_train_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)train_smem_bytes(kMaxB, 6 * kMaxB + 4));
    if (e == cudaSuccess)
      e = cudaFuncSetAttribute(qz_train_far_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                               (int)far_smem_bytes(6 * kMaxB + 4));
    if (e != cudaSuccess) return static_cast<int>(e);
    configured = true;
  }
  int dev = 0, nsm = 0, occ = 0;
  e = cudaGetDevice(&dev);
  if (e == cudaSuccess) e = cudaDeviceGetAttribute(&nsm, cudaDevAttrMultiProcessorCount, dev);
  if (e == cudaSuccess)
    e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&occ, qz_train_kernel, nthreads, smem);
  if (e == cudaSuccess && occ * nsm < 2) e = cudaErrorCooperativeLaunchTooLarge;
  if (e != cudaSuccess) {
    cudaGetLastError();
    return static_cast<int>(e);
  }
  Train p;
  p.S = static_cast<double*>(S);
  p.T = static_cast<double*>(T);
  p.Q = static_cast<double*>(Q);
  p.Z = static_cast<double*>(Z);
  p.Qs = static_cast<double*>(stack);
  p.Zs = p.Qs + (size_t)H * WC * WC;
  p.sh = static_cast<const double*>(shifts);
  p.sync = static_cast<unsigned*>(sync);
  p.NP = NP;
  p.n = n;
  p.WC = WC;
  p.B = B;
  p.HOP = HOP;
  p.l = l;
  p.ihi = ihi;
  p.H = H;
  p.J = J;
  // Q's and Z's tiles: four rows a warp of a strip block, staged behind
  // its Qw and Zw in the 2 WC (WC + 1) doubles of the chase's S and T
  p.tQZ = (n + 4 * (nthreads / 32) - 1) / (4 * (nthreads / 32));
  p.W = min(max(J, 2 * p.tQZ), occ * nsm - 1);
  void* args[] = {&p};
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  e = cudaLaunchCooperativeKernel((const void*)qz_train_kernel, dim3(1 + p.W), dim3(nthreads),
                                  args, smem, st);
  if (e != cudaSuccess) {
    cudaGetLastError();  // a refused launch is not sticky: clear it for the next caller
    return static_cast<int>(e);
  }
  Far f;
  f.M[0] = p.S;
  f.M[1] = p.T;
  f.Zs = p.Zs;
  f.NP = NP;
  f.WC = WC;
  f.B = B;
  f.HOP = HOP;
  f.l = l;
  f.H = H;
  f.tST = (ws0 + (H - 1) * HOP + kFarRows - 1) / kFarRows;
  const int grid = 2 * f.tST;
  if (grid > 0)
    qz_train_far_kernel<<<grid, kFarWarps * 32, far_smem_bytes(WC), st>>>(f);
  return static_cast<int>(cudaGetLastError());
}
