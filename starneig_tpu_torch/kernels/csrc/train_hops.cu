// B3: one hop (HOP = 3B chase steps) of G staggered B-bulge trains, one
// thread block per train, for any B.
//
// Replaces starneig_tpu/ops/pallas_schur.py:_train_hops_kernel/
// _train_hops_body (pallas_call at :732, wrapper train_hops_pallas).  Plain
// twin: ops/schur.py:_train_hop, which matches the JAX package's XLA
// _train_hop step for step (no vigilant deflation).  Each step: bulge
// introduction from the shifts or a gather of the chase column, B
// 3-element reflectors, the left update on the 3B-row train block, the
// exact plant of each chase column, the right update on the window's
// columns, and the accumulation of the window transform Qw (the identity
// at the start).
//
// What bounds it on the H100: latency.  A step is ~12 B WC flops, and the
// next step's reflectors need every W update of this one, so the chain of
// a hop is its 3B steps, each a dependent reflector (a square root and
// divides), the W updates and their barriers.  The version before this one
// ran everything on one block of 256 threads with W and Qw in global
// memory: four block barriers a step, and each thread's 15-45 triple
// updates a step were L2 round trips one after another (clock64 split:
// PERF.md).
//
// Design.  Two groups of eight warps.
//   * The chase group owns W.  Where W fits in shared memory with the ring
//     (B <= 26, WC <= 160; the n=4000 path has WC = 154) it is copied in at
//     the start, reached through the shared array itself (typed shared
//     loads, not generic ones) and written back at the end; otherwise it
//     stays in global memory.  Per step: the reflectors, a thread a bulge
//     (the first ceil(B/32) warps); the left update, a warp a row triple and
//     a lane a column; the plants; W's right update, a lane a column triple
//     (its reflector in registers) and a warp a block of rows; a group
//     barrier (named, 256 threads) after each.  Every load of a block of
//     columns or rows is issued before any of its updates, and no index is
//     divided in the loops.
//   * The update group owns Qw, which never feeds back into the chase: it
//     takes each step's reflectors from a ring of R slots in shared memory
//     (R <= 16, flow control by two counters in shared memory) and applies
//     them to Qw in global memory behind the chase.
//   * Only the entries that can change are touched.  The left update skips
//     the columns left of loc - 1 (zeros: Hessenberg form and the exact
//     plants), W's right update the rows below loc + 3B (zeros in the
//     train's columns), and Qw's right update every row outside [loc0,
//     loc + 3B) (identity rows, zero in those columns).  Subtracting tau v 0
//     from a zero leaves it as it was, so W and Qw keep the plain twin's
//     values (checked on the card against the full ranges, PERF.md).  One
//     input breaks those zeros: a hop that introduces bulges at l_rel
//     where W[l_rel, l_rel - 1] != 0 (a sweep starts where that entry was
//     set to zero, but a caller may pass any window), whose first
//     reflector fills column l_rel - 1 below the subdiagonal; that hop
//     runs at the full ranges.
//   * Every B-sized array (the ring, beta, the chase columns and flags) is
//     in dynamic shared memory sized at launch: (R (32 B + 4) + 16 B) bytes,
//     plus 8 WC^2 with W.  The launch is refused only when the ring with
//     R = 2 does not fit the 227 KB of one block (B > 3,000), or G > 32.
//
// Index semantics follow the JAX version: row/column starts of the train
// block are clamped into the window as lax.dynamic_slice clamps them, and
// the chase-column plant is written only for bulges that are active and
// past their introduction (the only writes of the JAX scatter that change
// a value).  Parked trains (l_rel = 1, ihi_rel = 0) are exact no-ops.
#include "common.cuh"

namespace {

constexpr int kGroup = 256;             // threads of each group
constexpr int kThreads = 2 * kGroup;
constexpr int kMaxG = 32;
constexpr int kGroupWarps = kGroup / 32;
constexpr int kLeftCols = 4;            // columns a lane loads at once (left update)
constexpr int kChaseRows = 4;           // rows a warp loads at once: W's right update
constexpr int kQwRows = 8;              //   and Qw's
constexpr int kRingMax = 16;
constexpr size_t kSmemMax = 231424;     // dynamic shared memory: 226 of the 227 KB
constexpr int kBarChase = 1, kBarUpd = 2;

struct HopParams {
  int G, B, WC, HOP, R, w_smem;
  int gidx[kMaxG], l_rel[kMaxG], ihi_rel[kMaxG], s0[kMaxG];
};

DEVI void group_sync(int id) {
  asm volatile("barrier.sync %0, %1;" ::"r"(id), "r"(kGroup) : "memory");
}

DEVI int vload(const int* p) { return *reinterpret_cast<const volatile int*>(p); }

DEVI void wait_until(const int* counter, int at_least) {
  while (vload(counter) < at_least) __nanosleep(20);
  __threadfence_block();
}

// left update of rows [loc, loc + 3B) over the columns [clo, WC): warp w
// takes the row triples j = w, w + 8, ... (ref[j] broadcast once), its lanes
// the columns, kLeftCols a lane loaded before any is updated
DEVI void left_update(double* W, int WC, int B, int loc, int clo,
                      const double* ref, int warp, int lane) {
  const int nc = WC - clo;
  for (int j = warp; j < B; j += kGroupWarps) {
    const double v0 = ref[4 * j], v1 = ref[4 * j + 1], v2 = ref[4 * j + 2];
    const double tau = ref[4 * j + 3];
    const double tv0 = tau * v0, tv1 = tau * v1, tv2 = tau * v2;
    double* row = W + (size_t)(loc + 3 * j) * WC + clo;
    for (int c0 = lane; c0 < nc; c0 += 32 * kLeftCols) {
      double a[kLeftCols][3];
#pragma unroll
      for (int u = 0; u < kLeftCols; ++u) {
        const int c = c0 + 32 * u;
        if (c < nc) { a[u][0] = row[c]; a[u][1] = row[WC + c]; a[u][2] = row[2 * WC + c]; }
      }
#pragma unroll
      for (int u = 0; u < kLeftCols; ++u) {
        const int c = c0 + 32 * u;
        if (c < nc) {
          const double sum = v0 * a[u][0] + v1 * a[u][1] + v2 * a[u][2];
          row[c] = a[u][0] - tv0 * sum;
          row[WC + c] = a[u][1] - tv1 * sum;
          row[2 * WC + c] = a[u][2] - tv2 * sum;
        }
      }
    }
  }
}

// right update of columns [loc, loc + 3B) over the rows [r0, r1) of M: a
// lane a column triple (its reflector in registers), warp w the rows in
// blocks of kRows from r0 + w kRows on, every load of a block before any
// update
template <int kRows>
DEVI void right_update(double* M, int WC, int B, int loc, int r0, int r1,
                       const double* ref, int warp, int lane) {
  for (int j = lane; j - lane < B; j += 32) {
    const bool on = j < B;
    double v0 = 0.0, v1 = 0.0, v2 = 0.0, tau = 0.0;
    if (on) { v0 = ref[4 * j]; v1 = ref[4 * j + 1]; v2 = ref[4 * j + 2]; tau = ref[4 * j + 3]; }
    double* col = M + loc + 3 * j;
    for (int rb = r0 + warp * kRows; rb < r1; rb += kGroupWarps * kRows) {
      double a[kRows][3];
#pragma unroll
      for (int u = 0; u < kRows; ++u) {
        const double* p = col + (size_t)(rb + u) * WC;
        if (on && rb + u < r1) { a[u][0] = p[0]; a[u][1] = p[1]; a[u][2] = p[2]; }
      }
#pragma unroll
      for (int u = 0; u < kRows; ++u) {
        double* p = col + (size_t)(rb + u) * WC;
        if (on && rb + u < r1) {
          const double ts = tau * (a[u][0] * v0 + a[u][1] * v1 + a[u][2] * v2);
          p[0] = a[u][0] - ts * v0;
          p[1] = a[u][1] - ts * v1;
          p[2] = a[u][2] - ts * v2;
        }
      }
    }
  }
}

// the shared-memory carve-up of one block
struct Carve {
  double* ring;    // R slots of B (v0, v1, v2, tau), column/row triple order
  double* beta;    // B
  double* w;       // WC^2 when W is in shared memory
  int* ring_loc;   // R
  int* kc;         // B
  int* flag;       // B: bit 0 plant, bit 1 use3
};

DEVI Carve carve(double* smem, const HopParams& prm) {
  Carve c;
  c.ring = smem;
  c.beta = c.ring + (size_t)prm.R * prm.B * 4;
  c.w = c.beta + prm.B;
  c.ring_loc = reinterpret_cast<int*>(c.w + (prm.w_smem ? (size_t)prm.WC * prm.WC : 0));
  c.kc = c.ring_loc + prm.R;
  c.flag = c.kc + prm.B;
  return c;
}

// the chase group: every W step; W is the block's shared copy when kSmem
template <bool kSmem>
DEVI void chase(const HopParams& prm, double* Wg, const double* sh, bool full,
                int* s_posted, const int* s_freed) {
  extern __shared__ __align__(16) double smem[];
  const Carve cv = carve(smem, prm);
  double* W = kSmem ? cv.w : Wg;
  const int g = blockIdx.x, tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int B = prm.B, WC = prm.WC, HOP = prm.HOP, R = prm.R;
  const int l_rel = prm.l_rel[g], ihi_rel = prm.ihi_rel[g], s0 = prm.s0[g];
  for (int t = 0; t < HOP; ++t) {
    const int s = s0 + t, slot = t % R;
    double* ref = cv.ring + (size_t)slot * B * 4;
    const int lo = l_rel + s - 3 * (B - 1);
    const int loc = clampi(lo, 0, WC - 3 * B);
    if (t >= R) wait_until(s_freed, t - R + 1);   // the slot is free
    for (int b = tid; b < B; b += kGroup) {
      const int k = l_rel + s - 3 * b;
      const bool active = k >= l_rel && k <= ihi_rel - 2;
      const int kc = active ? k : 1;
      const bool intro = active && k == l_rel;
      const bool use3 = k <= ihi_rel - 3;
      double x[3];
      if (intro) {
        const int lr = clampi(l_rel, 0, WC - 3);
        double h3[9];
        for (int r = 0; r < 3; ++r)
          for (int c = 0; c < 3; ++c) h3[r * 3 + c] = W[(lr + r) * WC + lr + c];
        first_column_shifted(h3, sh[b * 4 + 0], sh[b * 4 + 1], sh[b * 4 + 2],
                             sh[b * 4 + 3], use3, x);
      } else {
        const int r0 = clampi(kc, 0, WC - 3);
        const int c0 = clampi(kc - 1 > 0 ? kc - 1 : 0, 0, WC - 1);
        for (int r = 0; r < 3; ++r) x[r] = W[(r0 + r) * WC + c0];
      }
      double v[3], tau, beta;
      householder(x, use3 ? 7u : 3u, 3, v, tau, beta);
      double* rj = ref + 4 * (B - 1 - b);     // row/column triple B-1-b
      rj[0] = v[0]; rj[1] = v[1]; rj[2] = v[2];
      rj[3] = active ? tau : 0.0;
      cv.beta[b] = beta;
      cv.kc[b] = kc;
      cv.flag[b] = (active && !intro ? 1 : 0) | (use3 ? 2 : 0);
    }
    if (tid == 0) cv.ring_loc[slot] = loc;
    __threadfence_block();
    group_sync(kBarChase);
    if (tid == 0) *reinterpret_cast<volatile int*>(s_posted) = t + 1;
    left_update(W, WC, B, loc, full ? 0 : (loc >= 1 ? loc - 1 : 0), ref, warp, lane);
    group_sync(kBarChase);
    for (int b = tid; b < B; b += kGroup) {
      const int f = cv.flag[b];
      if (!(f & 1)) continue;
      const int kc = cv.kc[b];
      W[kc * WC + kc - 1] = cv.beta[b];
      W[(kc + 1) * WC + kc - 1] = 0.0;
      if (f & 2) W[(kc + 2) * WC + kc - 1] = 0.0;
    }
    group_sync(kBarChase);
    right_update<kChaseRows>(W, WC, B, loc, 0, full ? WC : min(WC, loc + 3 * B + 1), ref,
                             warp, lane);
    group_sync(kBarChase);
  }
}

__global__ void __launch_bounds__(kThreads, 1)
train_hops_kernel(double* __restrict__ wnds, double* __restrict__ qws,
                  const double* __restrict__ shifts, HopParams prm) {
  extern __shared__ __align__(16) double smem[];
  __shared__ int s_posted, s_freed;
  const int g = blockIdx.x, tid = threadIdx.x;
  const int B = prm.B, WC = prm.WC, HOP = prm.HOP, R = prm.R;
  const int l_rel = prm.l_rel[g], s0 = prm.s0[g];
  double* Wg = wnds + (size_t)g * WC * WC;
  double* Q = qws + (size_t)g * WC * WC;
  const Carve cv = carve(smem, prm);

  // the full ranges where an introduction meets a nonzero subdiagonal
  const int b_first = s0 <= 0 ? 0 : (s0 + 2) / 3;   // first bulge introduced
  const bool intro_hop = b_first < B && 3 * b_first < s0 + HOP;
  const bool full = intro_hop && !(l_rel >= 1 && l_rel <= WC - 3 &&
                                   Wg[(size_t)l_rel * WC + l_rel - 1] == 0.0);
  for (int e = tid; e < WC * WC; e += kThreads) {
    Q[e] = (e % (WC + 1) == 0) ? 1.0 : 0.0;
    if (prm.w_smem) cv.w[e] = Wg[e];
  }
  if (tid == 0) { s_posted = 0; s_freed = 0; }
  __syncthreads();

  if (tid < kGroup) {
    const double* sh = shifts + (size_t)prm.gidx[g] * B * 4;
    if (prm.w_smem)
      chase<true>(prm, Wg, sh, full, &s_posted, &s_freed);
    else
      chase<false>(prm, Wg, sh, full, &s_posted, &s_freed);
  } else {
    // ---- the update group: Qw, behind the chase ----
    const int tq = tid - kGroup, warp = tq >> 5, lane = tq & 31;
    int loc0 = 0;
    for (int t = 0; t < HOP; ++t) {
      const int slot = t % R;
      wait_until(&s_posted, t + 1);
      const int loc = cv.ring_loc[slot];
      if (t == 0) loc0 = loc;
      right_update<kQwRows>(Q, WC, B, loc, full ? 0 : loc0, full ? WC : loc + 3 * B,
                            cv.ring + (size_t)slot * B * 4, warp, lane);
      group_sync(kBarUpd);     // Qw's next step reads these entries; the slot is read
      if (tq == 0) {
        __threadfence_block();
        *reinterpret_cast<volatile int*>(&s_freed) = t + 1;
      }
    }
  }
  if (prm.w_smem) {
    __syncthreads();
    for (int e = tid; e < WC * WC; e += kThreads) Wg[e] = cv.w[e];
  }
}

size_t smem_bytes(int B, int WC, int R, bool w_smem) {
  return sizeof(double) * ((size_t)R * B * 4 + B + (w_smem ? (size_t)WC * WC : 0)) +
         sizeof(int) * ((size_t)R + 2 * B);
}

}  // namespace

extern "C" int train_hops(void* wnds, void* qws, const void* shifts, int G,
                          int B, int WC, int HOP, const int* gidx,
                          const int* l_rel, const int* ihi_rel, const int* s0,
                          void* stream) {
  if (G < 1 || G > kMaxG || B < 1 || WC < 3 * B || HOP < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  int R = HOP < kRingMax ? HOP : kRingMax;
  const bool w_smem = smem_bytes(B, WC, R, true) <= kSmemMax;
  if (!w_smem)   // the largest ring that fits, at least two slots
    while (R > 2 && smem_bytes(B, WC, R, false) > kSmemMax) --R;
  const size_t bytes = smem_bytes(B, WC, R, w_smem);
  if (bytes > kSmemMax) return static_cast<int>(cudaErrorInvalidValue);
  static bool attr_set = false;
  if (!attr_set) {
    const cudaError_t e = cudaFuncSetAttribute(
        train_hops_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)kSmemMax);
    if (e != cudaSuccess) return static_cast<int>(e);
    attr_set = true;
  }
  HopParams prm;
  prm.G = G; prm.B = B; prm.WC = WC; prm.HOP = HOP; prm.R = R;
  prm.w_smem = w_smem ? 1 : 0;
  for (int g = 0; g < G; ++g) {
    prm.gidx[g] = gidx[g];
    prm.l_rel[g] = l_rel[g];
    prm.ihi_rel[g] = ihi_rel[g];
    prm.s0[g] = s0[g];
  }
  train_hops_kernel<<<G, kThreads, bytes, static_cast<cudaStream_t>(stream)>>>(
      static_cast<double*>(wnds), static_cast<double*>(qws),
      static_cast<const double*>(shifts), prm);
  return static_cast<int>(cudaGetLastError());
}
