// G2: the window QZ machine (double-shift QZ with infinite eigenvalues and
// 2x2 standardization) on one window, the whole state machine in one block.
//
// Replaces the XLA while_loop of starneig_tpu/ops/qz.py:_build_qz_machine
// (:215, run by small_qz :177): find_l, process_inf (:252), sweep (:315),
// deflate2 (:389) and the iteration caps.  Plain twin:
// ops/qz.py:_small_qz_plain.  It serves the AED window (w = WA) and the
// whole problem below the small limit.
//
// What bounds it on the H100: the serial chain of the chase.  A window
// solve runs thousands of chase steps, and step k of a sweep needs three
// scalar transforms in a row, each from entries the previous one updated:
// the left 3-reflector from H[k:k+3, k-1] (rows k..k+2 of H and T), the
// right 3-reflector from T[k+2, k:k+3] (columns k..k+2) and the rotation
// from T[k+1, k:k+2] (columns k, k+1); the next step's reflector needs
// column k of H after all three.  The flops a step (O(w)) are few and
// parallel.  At w = 162 the padded H and T are 2 x 165^2 x 8 B = 436 KB,
// more than a block's 227 KB of shared memory: they stay in global memory
// (L2-resident).
//
// Design: B2's (francis.cu) made two-sided.  Nothing later in a sweep
// reads
//   * rows 0..k of columns k..k+2 (above the bulge): their right updates
//     and rotations from step k on,
//   * Q and Z: all their updates,
//   * H's and T's columns right of the bulge's reach: their left updates,
// so a sweep runs in blocks of kBlockSteps steps and those updates are
// deferred to their block's end.  The block's near-diagonal windows of H
// and T (rows k0..k1+3, columns k0-1..k1+2, at most 36 x 36 each) live in
// shared memory while its steps run.
//
// Warp 0 is the chase warp, warps 1..7 update warps, a pipeline one block
// deep (named barriers, a two-slot ring of step logs).  The chase warp
// copies the windows of block b in and runs its steps: the left reflector
// a column a lane on rows k..k+2 of both windows; rows k+1, k+2 of columns
// k..k+2 go to every lane by shuffle, every lane computes the right
// reflector and T's row k+1 after it and the rotation, and five lanes
// apply them to H's rows k+1..k+3 and T's rows k+1, k+2; column k of H
// goes to every lane by shuffle as the next step's input.  Each step is
// logged (v, tau twice and c, s: 10 doubles).  The chase warp writes the
// windows back, hands the log to the update warps, applies block b's left
// updates itself to the kNear columns right of the windows (block b+1's
// windows and near strips), and goes on to block b+1 while the update
// warps apply the rest of block b: the far columns nearest the diagonal
// first (then a barrier for the chase warp), the other far columns, and
// 32-row tiles staged with coalesced loads of H's and T's rows above the
// bulge (full height), Q's columns k0..k1+2 and Z's.  Every entry takes
// its updates in the plain twin's order (ops/qz.py:_sweep), up to FMA
// contraction; entries that are exactly zero there (rows below k+3,
// columns left of k-1) are skipped.  The reflectors come from
// chase_reflector (common.cuh), the rotations from givens.
//
// Between sweeps the block runs the machine's other phases as whole-block
// steps, as the plain twin does: the deflation scan and T's largest
// diagonal entry, the infinite-eigenvalue test and chase (thread 0 for each
// rotation, the block for its full-width update), the 2x2 standardization
// and the shifts.  The decisions are the plain twin's; over thousands of
// steps rounding may still change a deflation order, so the kernel is held
// to the contract, not elementwise.  info = {0 or the failing row + 1,
// the chase steps run}.
#include "gep_common.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kUpd = kThreads - 32;  // threads of the update warps
constexpr int kItmaxPerBlock = 40;
constexpr int kBlockSteps = 32;
constexpr int kNear = 32;                 // columns the chase warp slides itself
constexpr int kWinRows = kBlockSteps + 4;
constexpr int kWinLd = kBlockSteps + 5;   // odd: conflict-free lane columns
constexpr int kTileLd = kBlockSteps + 3;  // odd: conflict-free lane rows
constexpr int kRec = 10;  // a step's log: v0 v1 v2 tau, u0 u1 u2 tau_r, c, s

// named barriers (0 is __syncthreads); each kind alternates two ids by the
// block's parity, so one instance completes before its id is reused
constexpr int kBarReady = 1;  // chase -> update: the block's log
constexpr int kBarNear = 3;   // update -> chase: the near far columns done
constexpr int kBarFree = 5;   // update -> chase: the ring slot is free

__device__ __forceinline__ void bar_sync(int id) {
  __syncwarp();
  asm volatile("barrier.sync %0, %1;" ::"r"(id), "r"(kThreads) : "memory");
}
__device__ __forceinline__ void bar_arrive(int id) {
  __threadfence_block();
  __syncwarp();
  asm volatile("barrier.arrive %0, %1;" ::"r"(id), "r"(kThreads) : "memory");
}

struct Win {
  double *H, *T, *Q, *Z;
  int w, wp;  // H, T are wp x wp, Q, Z are w x wp (row-major, ld wp)
};

// rows (i-1, i) of H and T over the full width, columns (i-1, i) of Q:
// (c r0 + s r1, -s r0 + c r1)
DEVI void left_rot(const Win& W, int i, double c, double s) {
  for (int e = threadIdx.x; e < 2 * W.wp + W.w; e += blockDim.x) {
    double *p0, *p1;
    if (e < 2 * W.wp) {
      double* M = e < W.wp ? W.H : W.T;
      const int col = e % W.wp;
      p0 = M + (size_t)(i - 1) * W.wp + col;
      p1 = p0 + W.wp;
    } else {
      p0 = W.Q + (size_t)(e - 2 * W.wp) * W.wp + i - 1;
      p1 = p0 + 1;
    }
    const double a = *p0, b = *p1;
    *p0 = c * a + s * b;
    *p1 = -s * a + c * b;
  }
}

// columns (i-1, i) of H, T (all wp rows) and Z (w rows):
// (c c0 + s c1, -s c0 + c c1)
DEVI void right_rot(const Win& W, int i, double c, double s) {
  for (int e = threadIdx.x; e < 2 * W.wp + W.w; e += blockDim.x) {
    double* M = e < W.wp ? W.H : (e < 2 * W.wp ? W.T : W.Z);
    const int r = e < 2 * W.wp ? e % W.wp : e - 2 * W.wp;
    double* p = M + (size_t)r * W.wp + i - 1;
    const double a = p[0], b = p[1];
    p[0] = c * a + s * b;
    p[1] = -s * a + c * b;
  }
}

// ---------------------------------------------------------------------------
// the deferred updates
// ---------------------------------------------------------------------------

// a left reflector on the 3 entries (a, b, c) of a column: (I - tau v v^T)
DEVI void refl_left(double& a, double& b, double& c, const double* r) {
  const double s = r[0] * a + r[1] * b + r[2] * c;
  a -= r[3] * (r[0] * s);
  b -= r[3] * (r[1] * s);
  c -= r[3] * (r[2] * s);
}

// a right reflector on the 3 entries (a, b, c) of a row: x (I - tau u u^T)
DEVI void refl_right(double& a, double& b, double& c, const double* r) {
  const double s = a * r[0] + b * r[1] + c * r[2];
  a -= r[3] * (s * r[0]);
  b -= r[3] * (s * r[1]);
  c -= r[3] * (s * r[2]);
}

// the rotation on the 2 entries (a, b) of a row: (c a + s b, -s a + c b)
DEVI void rot_right(double& a, double& b, double c, double s) {
  const double x = a, y = b;
  a = c * x + s * y;
  b = -s * x + c * y;
}

// The left reflectors of steps k0..k1 (log rec) on the column strip
// p[(k - k0) * stride], k = k0 .. k1 + 2, in step order.  The strip (at
// most kBlockSteps + 2 entries) is loaded into registers first, so its
// loads overlap instead of chaining.
DEVI void slide_col(double* p, int stride, int k0, int k1, const double (*rec)[kRec]) {
  const int n = k1 - k0 + 3;
  double seg[kBlockSteps + 2];
#pragma unroll
  for (int j = 0; j < kBlockSteps + 2; ++j)
    if (j < n) seg[j] = p[(size_t)j * stride];
#pragma unroll
  for (int j = 0; j < kBlockSteps; ++j)
    if (j < n - 2) refl_left(seg[j], seg[j + 1], seg[j + 2], rec[j]);
#pragma unroll
  for (int j = 0; j < kBlockSteps + 2; ++j)
    if (j < n) p[(size_t)j * stride] = seg[j];
}

// Rows r0 .. r0+31 (< rend) of the row-major M (leading dimension ld),
// columns k0 .. k1+2, staged through the warp's tile; row r takes the
// steps from kf = max(r, k0) on when diag (H and T above the bulge), else
// from k0 (Q, Z).  left: the steps' left reflectors (Q's columns), else
// their right reflectors and rotations (H, T, Z).
DEVI void row_tile(double* M, int ld, int r0, int rend, int k0, int k1, bool diag,
                   bool left, double* tile, const double (*rec)[kRec]) {
  const int lane = threadIdx.x & 31;
  const int nc = k1 - k0 + 3;  // <= kBlockSteps + 2
  const int nr = min(32, rend - r0);
  for (int e = lane; e < nr * nc; e += 32)
    tile[(e / nc) * kTileLd + e % nc] = M[(size_t)(r0 + e / nc) * ld + k0 + e % nc];
  __syncwarp();
  const int r = r0 + lane;
  if (lane < nr) {
    double* x = tile + lane * kTileLd;
    const int kf = diag && r > k0 ? r : k0;
    for (int k = kf; k <= k1; ++k) {
      const double* g = rec[k - k0];
      double* y = x + (k - k0);
      if (left) {
        // Q[:, k:k+3] -= tau (Q[:, k:k+3] v) v^T
        const double s = y[0] * g[0] + y[1] * g[1] + y[2] * g[2];
        y[0] -= g[3] * (s * g[0]);
        y[1] -= g[3] * (s * g[1]);
        y[2] -= g[3] * (s * g[2]);
      } else {
        refl_right(y[0], y[1], y[2], g + 4);
        rot_right(y[0], y[1], g[8], g[9]);
      }
    }
  }
  __syncwarp();
  for (int e = lane; e < nr * nc; e += 32)
    M[(size_t)(r0 + e / nc) * ld + k0 + e % nc] = tile[(e / nc) * kTileLd + e % nc];
  __syncwarp();  // the tile is free
}

// ---------------------------------------------------------------------------
// one sweep over [l, i]: the chase warp
// ---------------------------------------------------------------------------

DEVI void chase_warp(const Win& W, int l, int i, const double* shifts,
                     double (*win)[kWinRows][kWinLd], double (*ring)[kBlockSteps][kRec]) {
  const int lane = threadIdx.x & 31;
  const int wp = W.wp;
  double(*sH)[kWinLd] = win[0];
  double(*sT)[kWinLd] = win[1];
  const int nblk = (i - l + kBlockSteps - 1) / kBlockSteps;
  double x0 = 0.0, x1 = 0.0, x2 = 0.0;  // the next chase column
  for (int b = 0; b < nblk; ++b) {
    const int k0 = l + b * kBlockSteps;
    const int k1 = min(k0 + kBlockSteps - 1, i - 1);
    const int c_hi = k1 + 3;  // columns the block's right updates reach
    const int R0 = k0, C0 = k0 - 1 > 0 ? k0 - 1 : 0;
    const int nR = k1 + 4 - R0, nC = c_hi - C0;  // k1 + 3 <= i + 2 < wp
    double(*rec)[kRec] = ring[b & 1];
    // the windows are current: block b-1's went back and its near strips
    // were slid by this warp
    for (int e = lane; e < nR * nC; e += 32) {
      const size_t at = (size_t)(R0 + e / nC) * wp + C0 + e % nC;
      sH[e / nC][e % nC] = W.H[at];
      sT[e / nC][e % nC] = W.T[at];
    }
    // the ring slot's previous block (b-2) is applied
    if (b >= 2) bar_sync(kBarFree + (b & 1));
    __syncwarp();
    for (int k = k0; k <= k1; ++k) {
      const bool use3 = k <= i - 2;
      if (k == l) {
        double x[3];
        first_col_qz(&sH[k - R0][k - C0], &sT[k - R0][k - C0], kWinLd, 0, shifts, true,
                     false, x);
        x0 = x[0];
        x1 = x[1];
        x2 = x[2];
      }
      // H's row k+3 of columns k..k+2: no update of this block has reached it
      const double q0 = sH[k + 3 - R0][k - C0], q1 = sH[k + 3 - R0][k + 1 - C0];
      const double q2 = sH[k + 3 - R0][k + 2 - C0];
      double v1, v2, tau, beta;
      chase_reflector(x0, x1, use3 ? x2 : 0.0, v1, v2, tau, beta);
      const double rl[4] = {1.0, v1, v2, tau};
      // 1. the left reflector on rows k..k+2 of both windows, columns
      // k-1 .. c_hi-1, a column a lane, then the plant of the chase column;
      // the columns from c_hi on wait for the block's end
      const int cL = k - 1 > C0 ? k - 1 : C0;
      double h1 = 0.0, h2 = 0.0, t1 = 0.0, t2 = 0.0;  // rows k+1, k+2 of the lane's column
      for (int c = cL + lane; c < c_hi; c += 32) {
        const int cc = c - C0;
        double a = sH[k - R0][cc], bb = sH[k + 1 - R0][cc], d = sH[k + 2 - R0][cc];
        refl_left(a, bb, d, rl);
        if (k > l && c == k - 1) {
          a = beta;
          bb = 0.0;
          if (use3) d = 0.0;
        }
        sH[k - R0][cc] = a;
        sH[k + 1 - R0][cc] = bb;
        sH[k + 2 - R0][cc] = d;
        double ta = 0.0, tb = 0.0, td = 0.0;
        if (c >= k) {  // T's rows k..k+2 are zero left of column k
          ta = sT[k - R0][cc];
          tb = sT[k + 1 - R0][cc];
          td = sT[k + 2 - R0][cc];
          refl_left(ta, tb, td, rl);
          sT[k - R0][cc] = ta;
          sT[k + 1 - R0][cc] = tb;
          sT[k + 2 - R0][cc] = td;
        }
        if (c < cL + 32) {
          h1 = bb;
          h2 = d;
          t1 = tb;
          t2 = td;
        }
      }
      // rows k+1, k+2 of columns k..k+2 from the lanes that updated them
      const int j0 = k - cL;
      double T1[3], T2[3], H1[3], H2[3];
#pragma unroll
      for (int j = 0; j < 3; ++j) {
        T1[j] = __shfl_sync(0xffffffffu, t1, j0 + j);
        T2[j] = __shfl_sync(0xffffffffu, t2, j0 + j);
        H1[j] = __shfl_sync(0xffffffffu, h1, j0 + j);
        H2[j] = __shfl_sync(0xffffffffu, h2, j0 + j);
      }
      // 2. the right reflector from T's row k+2, reversed (u2 = 1); every
      // lane computes it and T's row k+1 after it
      double ur[4] = {0.0, 0.0, 0.0, 0.0};
      if (use3) {
        double w1, w2, taur, betar;
        chase_reflector(T2[2], T2[1], T2[0], w1, w2, taur, betar);
        ur[0] = w2;
        ur[1] = w1;
        ur[2] = 1.0;
        ur[3] = taur;
        refl_right(T1[0], T1[1], T1[2], ur);
        refl_right(T2[0], T2[1], T2[2], ur);
      }
      // 3. the rotation from T's row k+1, zeroing T[k+1, k]
      double cr, sr, rr;
      givens(T1[1], T1[0], cr, sr, rr);
      const double sn = -sr;
      // lanes 0..2: H's rows k+1..k+3 of columns k..k+2; lane 3: T's row
      // k+1; lane 4: T's row k+2 (its columns k, k+1 planted 0 after the
      // reflector, the rotation's zeros)
      double e0, e1, e2;
      if (lane == 0) {
        e0 = H1[0];
        e1 = H1[1];
        e2 = H1[2];
      } else if (lane == 1) {
        e0 = H2[0];
        e1 = H2[1];
        e2 = H2[2];
      } else {
        e0 = q0;
        e1 = q1;
        e2 = q2;
      }
      if (use3) refl_right(e0, e1, e2, ur);
      rot_right(e0, e1, cr, sn);
      double g1 = T1[1], g0 = T1[0];
      rot_right(g0, g1, cr, sn);
      __syncwarp();  // the left update's stores precede these
      if (lane < 3) {
        double* row = &sH[k + 1 + lane - R0][k - C0];
        row[0] = e0;
        row[1] = e1;
        row[2] = e2;
      } else if (lane == 3) {
        double* row = &sT[k + 1 - R0][k - C0];
        row[0] = 0.0;
        row[1] = g1;
        row[2] = T1[2];
      } else if (lane == 4 && use3) {
        double* row = &sT[k + 2 - R0][k - C0];
        row[0] = 0.0;
        row[1] = 0.0;
        row[2] = T2[2];
      }
      if (lane < kRec) {
        const double lg[kRec] = {1.0, v1, v2, tau, ur[0], ur[1], ur[2], ur[3], cr, sn};
        double val = lg[0];
#pragma unroll
        for (int j = 1; j < kRec; ++j)
          if (lane == j) val = lg[j];
        rec[k - k0][lane] = val;
      }
      // column k of H after the step: the next step's input
      x0 = __shfl_sync(0xffffffffu, e0, 0);
      x1 = __shfl_sync(0xffffffffu, e0, 1);
      x2 = __shfl_sync(0xffffffffu, e0, 2);
      __syncwarp();
    }
    for (int e = lane; e < nR * nC; e += 32) {
      const size_t at = (size_t)(R0 + e / nC) * wp + C0 + e % nC;
      W.H[at] = sH[e / nC][e % nC];
      W.T[at] = sT[e / nC][e % nC];
    }
    __syncwarp();
    bar_arrive(kBarReady + (b & 1));  // the update warps take block b
    // block b's left updates of the kNear columns right of the windows,
    // after block b-1's (the update warps did those that were far columns
    // of b-1)
    if (b >= 1) bar_sync(kBarNear + ((b - 1) & 1));
    const int c = c_hi + lane;
    if (b + 1 < nblk && c < wp) {
      slide_col(W.H + (size_t)k0 * wp + c, wp, k0, k1, rec);
      slide_col(W.T + (size_t)k0 * wp + c, wp, k0, k1, rec);
    }
    __syncwarp();
  }
}

// ---------------------------------------------------------------------------
// one sweep over [l, i]: the update warps
// ---------------------------------------------------------------------------

DEVI void update_warps(const Win& W, int l, int i, double* tile,
                       double (*ring)[kBlockSteps][kRec]) {
  const int ut = threadIdx.x - 32, uw = ut >> 5;
  const int wp = W.wp;
  const int nblk = (i - l + kBlockSteps - 1) / kBlockSteps;
  for (int b = 0; b < nblk; ++b) {
    const int k0 = l + b * kBlockSteps;
    const int k1 = min(k0 + kBlockSteps - 1, i - 1);
    const int c_hi = k1 + 3;
    const double(*rec)[kRec] = ring[b & 1];
    const bool last = b + 1 == nblk;
    bar_sync(kBarReady + (b & 1));
    // far columns of H and T (rows k0..k1+2): the chase warp took [c_hi,
    // c_hi + kNear) unless this is the sweep's last block; the first ones
    // after that go first
    const int cs = last ? c_hi : min(c_hi + kNear, wp);
    const int nfar = 2 * (wp - cs);
    int e = ut;
    if (e < nfar)
      slide_col((e & 1 ? W.T : W.H) + (size_t)k0 * wp + cs + (e >> 1), wp, k0, k1, rec);
    if (b + 1 < nblk) bar_arrive(kBarNear + (b & 1));
    for (e += kUpd; e < nfar; e += kUpd)
      slide_col((e & 1 ? W.T : W.H) + (size_t)k0 * wp + cs + (e >> 1), wp, k0, k1, rec);
    // row tiles: H's and T's rows 0..k1 from step max(r, k0) on, then Z's
    // and Q's rows
    const int nh = (k1 + 1 + 31) / 32, nz = (W.w + 31) / 32;
    for (int t = uw; t < 2 * nh + 2 * nz; t += kUpd / 32) {
      if (t < 2 * nh)
        row_tile(t < nh ? W.H : W.T, wp, (t % nh) * 32, k1 + 1, k0, k1, true, false, tile,
                 rec);
      else if (t < 2 * nh + nz)
        row_tile(W.Z, wp, (t - 2 * nh) * 32, W.w, k0, k1, false, false, tile, rec);
      else
        row_tile(W.Q, wp, (t - 2 * nh - nz) * 32, W.w, k0, k1, false, true, tile, rec);
    }
    if (b + 2 < nblk) bar_arrive(kBarFree + (b & 1));
  }
}

__global__ void __launch_bounds__(kThreads)
qz_window_kernel(double* __restrict__ H, double* __restrict__ T,
                 double* __restrict__ Q, double* __restrict__ Z, int w, int m,
                 double thresh_h, double thresh_t, int* __restrict__ info) {
  const Win W{H, T, Q, Z, w, w + 3};
  const int wp = w + 3;
  const int tid = threadIdx.x;
  const double ulp = DBL_EPSILON;
  __shared__ int s_l, s_jinf, s_flag;
  __shared__ double s_tmax;
  __shared__ double sh[16];
  // the chase's near-diagonal windows of H and T, and the ring of step logs
  __shared__ double s_win[2][kWinRows][kWinLd];
  __shared__ double s_ring[2][kBlockSteps][kRec];
  extern __shared__ double s_tiles[];  // a 32 x kTileLd tile per update warp

  int i = m - 1, its = 0, total = 0, steps = 0;
  bool failed = false;
  const int maxiter = 40 * w;  // the total-iteration cap
  while (i >= 0 && !failed && total < maxiter) {
    // ---- deflation point, T's largest diagonal entry ----
    if (tid == 0) {
      s_l = 0;
      s_jinf = w;
      s_tmax = 0.0;
    }
    __syncthreads();
    double tmax = 0.0;
    for (int idx = tid; idx < w; idx += blockDim.x) {
      tmax = dmax(tmax, fabs(T[idx * wp + idx]));
      if (idx > 0 && idx <= i) {
        const double sub = H[idx * wp + idx - 1];
        const double tst = fabs(H[(idx - 1) * wp + idx - 1]) + fabs(H[idx * wp + idx]);
        if (fabs(sub) <= dmax(ulp * tst, thresh_h)) atomicMax(&s_l, idx);
      }
    }
    // a max of nonnegative doubles by their bit patterns
    atomicMax(reinterpret_cast<unsigned long long*>(&s_tmax),
              (unsigned long long)__double_as_longlong(tmax));
    __syncthreads();
    const int l = s_l;
    const double tsmall = dmax(thresh_t, ulp * s_tmax);
    for (int idx = l + tid; idx <= i; idx += blockDim.x)
      if (fabs(T[idx * wp + idx]) <= tsmall) atomicMin(&s_jinf, idx);
    __syncthreads();
    if (tid == 0) {
      if (l > 0) H[l * wp + l - 1] = 0.0;
      int j = s_jinf;
      if (j < w && j != l) {
        // dhgeqz's ILAZRO/ILAZR2: chase only if the dropped fill is negligible
        const double hjm = fabs(H[j * wp + (j >= 1 ? j - 1 : 0)]);
        const double hsub = fabs(H[(j + 1 < w ? j + 1 : w - 1) * wp + j]);
        const double hdia = fabs(H[j * wp + j]);
        if (!(hjm * hsub <= dmax(thresh_h, ulp * hdia * (hjm + hsub + hdia)))) j = w;
      }
      s_jinf = j;
    }
    __syncthreads();
    const int jinf = s_jinf;

    if (jinf < w) {
      // ---- infinite eigenvalue: chase the zero T[j, j] down ----
      if (tid == 0) T[jinf * wp + jinf] = 0.0;
      bool stopped = false;
      for (int jc = jinf; jc <= i - 1; ++jc) {
        __syncthreads();
        if (tid == 0) {
          double c, s, r;
          givens(H[jc * wp + jc], H[(jc + 1) * wp + jc], c, s, r);
          sh[0] = c;
          sh[1] = s;
        }
        __syncthreads();
        left_rot(W, jc + 1, sh[0], sh[1]);
        __syncthreads();
        if (tid == 0) {
          H[(jc + 1) * wp + jc] = 0.0;
          if (jc == jinf && jc > l && jc >= 1) H[(jc + 1) * wp + jc - 1] = 0.0;
          const bool tsig = fabs(T[(jc + 1) * wp + jc + 1]) >
                            dmax(thresh_t, ulp * fabs(T[jc * wp + jc + 1]));
          if (!tsig) T[(jc + 1) * wp + jc + 1] = 0.0;
          s_flag = tsig;
        }
        __syncthreads();
        if (s_flag) {
          stopped = true;
          break;
        }
      }
      if (!stopped && i >= 1) {
        __syncthreads();
        if (tid == 0) {
          double c, s, r;
          givens(H[i * wp + i], H[i * wp + i - 1], c, s, r);
          sh[0] = c;
          sh[1] = s;
        }
        __syncthreads();
        right_rot(W, i, sh[0], -sh[1]);
        __syncthreads();
        if (tid == 0) {
          H[i * wp + i - 1] = 0.0;
          T[i * wp + i - 1] = 0.0;
        }
      }
      if (!stopped) i -= 1;
      its = 0;
    } else if (l >= i - 1) {
      // ---- deflation; a 2x2 block is standardized ----
      if (l == i - 1) {
        if (tid == 0) {
          const double a[4] = {H[(i - 1) * wp + i - 1], H[(i - 1) * wp + i],
                               H[i * wp + i - 1], H[i * wp + i]};
          const double b[4] = {T[(i - 1) * wp + i - 1], T[(i - 1) * wp + i],
                               T[i * wp + i - 1], T[i * wp + i]};
          std_gep_2x2(a, b, sh);
        }
        __syncthreads();
        left_rot(W, i, sh[8], sh[9]);
        __syncthreads();
        right_rot(W, i, sh[10], sh[11]);
        __syncthreads();
        if (tid == 0) {
          H[(i - 1) * wp + i - 1] = sh[0];
          H[(i - 1) * wp + i] = sh[1];
          H[i * wp + i - 1] = sh[2];
          H[i * wp + i] = sh[3];
          T[(i - 1) * wp + i - 1] = sh[4];
          T[(i - 1) * wp + i] = sh[5];
          T[i * wp + i - 1] = sh[6];
          T[i * wp + i] = sh[7];
        }
      }
      i = l == i ? i - 1 : i - 2;
      its = 0;
    } else {
      // ---- one double-shift QZ sweep over [l, i], in blocks of steps ----
      if (tid == 0) shifts_qz(H, T, wp, i, its, sh + 12);
      steps += i - l;
      __syncthreads();  // the shifts and thread 0's zeroing of H[l, l-1]
      if (tid < 32)
        chase_warp(W, l, i, sh + 12, s_win, s_ring);
      else
        update_warps(W, l, i, s_tiles + ((tid - 32) >> 5) * 32 * kTileLd, s_ring);
      its += 1;
      failed = its >= kItmaxPerBlock;
    }
    total += 1;
    __syncthreads();  // the sweep's last block is applied and visible
  }
  if (tid == 0) {
    info[0] = failed ? i + 1 : 0;
    info[1] = steps;
  }
}

constexpr int kTileBytes = (kThreads / 32 - 1) * 32 * kTileLd * sizeof(double);

}  // namespace

extern "C" int qz_window(void* H, void* T, void* Q, void* Z, int w, int m,
                         double thresh_h, double thresh_t, void* info,
                         void* stream) {
  static bool configured = false;
  if (!configured) {
    cudaError_t e = cudaFuncSetAttribute(
        qz_window_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, kTileBytes);
    if (e != cudaSuccess) return static_cast<int>(e);
    configured = true;
  }
  qz_window_kernel<<<1, kThreads, kTileBytes, static_cast<cudaStream_t>(stream)>>>(
      static_cast<double*>(H), static_cast<double*>(T), static_cast<double*>(Q),
      static_cast<double*>(Z), w, m, thresh_h, thresh_t,
      static_cast<int*>(info));
  return static_cast<int>(cudaGetLastError());
}
