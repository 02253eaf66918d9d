// B2: Francis double-shift QR on one window, the whole state machine in one
// thread block.
//
// Replaces starneig_tpu/ops/pallas_schur.py:_francis_kernel/_francis_body
// (pallas_call at :419, wrapper small_schur_pallas).  Plain twin:
// ops/small_schur.py:_small_schur_plain, which follows the JAX package's
// XLA small_schur (deflation scan with the pairwise test plus an absolute
// floor, Wilkinson shifts made exceptional every 10 iterations, a
// 3-element bulge chase, 2x2 standardization, Z accumulation).
//
// What bounds it on the H100: the serial chain of the chase, not flops or
// bytes.  A window solve runs ~w^2 chase steps (about 10^5 at the main
// path's w = 322), and each step's reflector depends on the previous
// step's updates: max|x|, a square root, then the divides for tau and the
// scale, some hundreds of cycles a step.  The steps' other work (the
// deferred row and column updates, O(w) per step) is parallel and must be
// kept off that chain.  At w = 322 the padded H and Z are 2 x 0.83 MB: too
// large for one block's 227 KB of shared memory, so they stay in global
// memory and live in L1/L2.
//
// Design.  Step k of a sweep needs rows k..k+2 (left update) and then rows
// k+1..k+3 of columns k..k+2 (right update), which leave the next chase
// column.  Nothing later in the sweep reads
//   * rows 0..k (above the bulge): their right updates from step k on,
//   * Z: all its right updates,
//   * columns right of the bulge's reach: their left updates,
// so the sweep runs in blocks of kBlockSteps steps, and those updates are
// deferred to the end of their block.  The block's near-diagonal window
// (rows k0..k1+3, columns k0-1..k1+2, at most 36 x 36) lives in shared
// memory while its steps run.
//
// Warp 0 is the chase warp; warps 1..7 are update warps, and the two run
// a pipeline one block deep.  The chase warp copies the window of block b
// in, runs its steps (each lane computes the reflector itself; __syncwarp
// between the two updates),
// buffers the reflectors in one of two ring slots, writes the window back
// and hands the slot to the update warps (a named barrier).  It then
// applies block b's left updates itself to the 32 columns right of the
// window, which block b+1's window and near strips need, and goes on to
// block b+1 while the update warps apply the rest of block b: the far
// columns nearest the diagonal first (then a barrier for the chase warp,
// which slides them for block b+1), the other far columns, and the row
// strips of H above the bulge and of Z.  A row strip is staged 32 rows x
// 34 columns at a time in shared memory with coalesced loads, each lane
// slides its row there in registers, and the tile goes back coalesced.
// Every entry sees the same operations in the same order as in the plain
// version (up to FMA contraction).  The row updates run at full height
// above the bulge (band-limiting them from above is unsound: upper content
// migrates into later decisions); rows below k+3 and columns left of k-1
// are exactly zero there and skipped.  The deflation scan, the shifts and
// the 2x2 standardization are whole-block phases between sweeps, and a
// sweep's last block drains the pipeline.
//
// The chain itself is kept short: the chase warp's reflector
// (chase_reflector) takes one square root and one reciprocal of
// (alpha - beta), and pre-scales by max|x| only where a square could leave
// the normal range; the right update's inputs (rows k+1, k+2 of columns
// k..k+2) come from the left update's lanes by shuffle, and the next chase
// column goes to every lane by shuffle, with no shared-memory round trip.
// (Its measured times: PERF.md.)
#include "common.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kUpd = kThreads - 32;  // threads of the update warps
constexpr int kItmaxPerBlock = 30;
constexpr int kBlockSteps = 32;
constexpr int kNear = 32;            // columns the chase warp slides itself
constexpr int kTileLd = kBlockSteps + 3;  // odd: conflict-free lane rows

// named barriers (0 is __syncthreads); each kind alternates two ids by the
// block's parity, so one instance completes before its id is reused
constexpr int kBarReady = 1;  // chase -> update: the block's reflectors
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

// Apply the buffered reflectors of steps kfirst..klast (ref[k - k0] holds
// v0, v1, v2, tau of step k) to the strip p[(k - origin) * stride], k =
// kfirst .. klast + 2, in step order: one 3-element update per step.  The
// strip (at most kBlockSteps + 2 entries) is loaded into registers first,
// so its loads overlap instead of chaining.
__device__ __forceinline__ void slide(double* p, int stride, int origin,
                                      int kfirst, int klast, int k0,
                                      const double (*ref)[4]) {
  const int n = klast - kfirst + 3;
  p += (long long)(kfirst - origin) * stride;
  double seg[kBlockSteps + 2];
#pragma unroll
  for (int j = 0; j < kBlockSteps + 2; ++j)
    if (j < n) seg[j] = p[j * stride];
#pragma unroll
  for (int j = 0; j < kBlockSteps; ++j) {
    if (j < n - 2) {
      const double* r = ref[kfirst + j - k0];
      double s = r[0] * seg[j] + r[1] * seg[j + 1] + r[2] * seg[j + 2];
      seg[j] -= r[3] * (r[0] * s);
      seg[j + 1] -= r[3] * (r[1] * s);
      seg[j + 2] -= r[3] * (r[2] * s);
    }
  }
#pragma unroll
  for (int j = 0; j < kBlockSteps + 2; ++j)
    if (j < n) p[j * stride] = seg[j];
}

// The right updates of block [k0, k1] on rows r0 .. r0+31 (< rend) of the
// row-major matrix M (leading dimension ld), columns k0 .. k1+2, staged
// through the warp's tile.  Row r takes the steps from max(r, k0) on when
// diag (H above the bulge), else all of them (Z).
__device__ __forceinline__ void row_tile(double* M, int ld, int r0, int rend,
                                         int k0, int k1, bool diag,
                                         double* tile, const double (*ref)[4]) {
  const int lane = threadIdx.x & 31;
  const int nc = k1 - k0 + 3;  // <= kBlockSteps + 2
  const int nr = min(32, rend - r0);
  for (int e = lane; e < nr * nc; e += 32)
    tile[(e / nc) * kTileLd + e % nc] = M[(size_t)(r0 + e / nc) * ld + k0 + e % nc];
  __syncwarp();
  const int r = r0 + lane;
  if (lane < nr) {
    const int kf = diag && r > k0 ? r : k0;
    if (kf <= k1) slide(tile + lane * kTileLd, 1, k0, kf, k1, k0, ref);
  }
  __syncwarp();
  for (int e = lane; e < nr * nc; e += 32)
    M[(size_t)(r0 + e / nc) * ld + k0 + e % nc] = tile[(e / nc) * kTileLd + e % nc];
  __syncwarp();  // the tile is free
}

// dlarfg on (a, x1, x2) for the chase step, on the chain: the guards of
// householder() keep their results (tau = 0 and v = e1 when the tail is
// zero; sgn(0) = +1), but the entries are pre-scaled by max|x| only where
// a square could leave the normal range (as LAPACK's dlarfg rescales only
// near underflow), and one reciprocal of (a - beta) replaces the divides.
// Returns v1, v2 (v0 = 1), tau and beta.
__device__ __forceinline__ void chase_reflector(double a, double x1, double x2,
                                                double& v1, double& v2,
                                                double& tau, double& beta) {
  constexpr double kTiny = 0x1p-500, kHuge = 0x1p+500;
  const double m1 = fabs(x1), m2 = fabs(x2);
  const double mx = dmax(fabs(a), dmax(m1, m2));
  double sc = 1.0;
  if (mx > kHuge || (m1 != 0.0 && m1 < kTiny) || (m2 != 0.0 && m2 < kTiny)) {
    const double r = 1.0 / mx;
    a *= r;
    x1 *= r;
    x2 *= r;
    sc = mx;
  }
  const double ss = x1 * x1 + x2 * x2;
  if (ss == 0.0) {
    v1 = 0.0;
    v2 = 0.0;
    tau = 0.0;
    beta = a * sc;
    return;
  }
  const double nrm = sqrt(a * a + ss);
  const double b = a >= 0.0 ? -nrm : nrm;
  const double d = a - b;  // |d| >= nrm > 0
  const double rd = 1.0 / d;
  tau = -d / b;
  v1 = x1 * rd;
  v2 = x2 * rd;
  beta = b * sc;
}

__global__ void __launch_bounds__(kThreads)
francis_kernel(double* __restrict__ H, double* __restrict__ Z, int w, int m,
               int ilo, int maxiter, double thresh, int* __restrict__ info) {
  const int wp = w + 2;  // H is (w+2) x (w+2), Z is w x (w+2), row-major
  const int tid = threadIdx.x;
  const int nt = blockDim.x;
  const int warp = tid >> 5, lane = tid & 31;
  const double ulp = DBL_EPSILON;

  __shared__ int s_l;
  __shared__ double s_rot[6];
  __shared__ double s_ref[2][kBlockSteps][4];
  // the block's near-diagonal window: rows k0..k1+3, columns k0-1..k1+2
  __shared__ double s_win[kBlockSteps + 4][kBlockSteps + 5];
  extern __shared__ double s_tiles[];  // a 32 x kTileLd tile per update warp

  int i = m - 1, its = 0, total = 0;
  bool failed = false;

  while (i >= ilo && !failed && total < maxiter) {
    // deflation scan: l = the largest idx in (ilo, i] with a negligible
    // subdiagonal, else ilo
    if (tid == 0) s_l = ilo;
    __syncthreads();
    for (int idx = ilo + 1 + tid; idx <= i; idx += nt) {
      double sub = H[idx * wp + idx - 1];
      double tst = fabs(H[(idx - 1) * wp + idx - 1]) + fabs(H[idx * wp + idx]);
      if (fabs(sub) <= dmax(ulp * tst, thresh)) atomicMax(&s_l, idx);
    }
    __syncthreads();
    const int l = s_l;
    if (tid == 0 && l > ilo) H[l * wp + l - 1] = 0.0;

    if (l >= i - 1) {
      if (l == i - 1) {  // standardize and deflate the 2x2 block
        if (tid == 0)
          standardize_2x2(H[(i - 1) * wp + i - 1], H[(i - 1) * wp + i],
                          H[i * wp + i - 1], H[i * wp + i], s_rot);
        __syncthreads();
        const double cs = s_rot[4], sn = s_rot[5];
        for (int c = tid; c < wp; c += nt) {
          double r0 = H[(i - 1) * wp + c], r1 = H[i * wp + c];
          H[(i - 1) * wp + c] = cs * r0 + sn * r1;
          H[i * wp + c] = -sn * r0 + cs * r1;
        }
        __syncthreads();
        for (int r = tid; r < wp; r += nt) {
          double c0 = H[r * wp + i - 1], c1 = H[r * wp + i];
          H[r * wp + i - 1] = cs * c0 + sn * c1;
          H[r * wp + i] = -sn * c0 + cs * c1;
        }
        for (int r = tid; r < w; r += nt) {
          double z0 = Z[r * wp + i - 1], z1 = Z[r * wp + i];
          Z[r * wp + i - 1] = cs * z0 + sn * z1;
          Z[r * wp + i] = -sn * z0 + cs * z1;
        }
        __syncthreads();
        if (tid == 0) {
          H[(i - 1) * wp + i - 1] = s_rot[0];
          H[(i - 1) * wp + i] = s_rot[1];
          H[i * wp + i - 1] = s_rot[2];
          H[i * wp + i] = s_rot[3];
        }
      }
      i = (l == i) ? i - 1 : i - 2;
      its = 0;
      total += 1;
      __syncthreads();  // l has been read before s_l is reset
      continue;
    }

    // Wilkinson double shift from the trailing 2x2, exceptional every 10;
    // these entries are not the one thread 0 may have just zeroed
    double sr1, si1, sr2;
    {
      double h11 = H[(i - 1) * wp + i - 1], h12 = H[(i - 1) * wp + i];
      double h21 = H[i * wp + i - 1], h22 = H[i * wp + i];
      bool exc = its > 0 && its % 10 == 0;
      int im2 = i - 2 > 0 ? i - 2 : 0;
      double s = fabs(h21) + fabs(H[(i - 1) * wp + im2]);
      double e11 = 0.75 * s + h22;
      double a = exc ? e11 : h11, b = exc ? -0.4375 * s : h12;
      double c = exc ? s : h21, d = exc ? e11 : h22;
      double rt1r, rt1i, rt2r, rt2i;
      eig2x2(a, b, c, d, rt1r, rt1i, rt2r, rt2i);
      bool real_pair = rt1i == 0.0;
      bool use1 = fabs(h22 - rt1r) <= fabs(h22 - rt2r);
      sr1 = real_pair ? (use1 ? rt1r : rt2r) : rt1r;
      sr2 = real_pair ? sr1 : rt2r;
      si1 = real_pair ? 0.0 : rt1i;
    }
    // thread 0's zeroing of H[l, l-1] is visible to the chase warp
    __syncthreads();

    // one bulge chase over the active block [l, i], in blocks of steps
    const int nblk = (i - l + kBlockSteps - 1) / kBlockSteps;
    if (warp == 0) {
      // ---- the chase warp ----
      double x0 = 0.0, x1 = 0.0, x2 = 0.0;  // the next chase column
      for (int b = 0; b < nblk; ++b) {
        const int k0 = l + b * kBlockSteps;
        const int k1 = min(k0 + kBlockSteps - 1, i - 1);
        const int c_hi = k1 + 3;  // columns the block's right updates reach
        const int R0 = k0, C0 = k0 - 1 > 0 ? k0 - 1 : 0;
        const int nR = k1 + 4 - R0, nC = c_hi - C0;  // k1 + 3 <= i + 2 < wp
        double(*ref)[4] = s_ref[b & 1];
        // the window is current: block b-1's window went back and its
        // near strips were slid by this warp
        for (int e = lane; e < nR * nC; e += 32)
          s_win[e / nC][e % nC] = H[(R0 + e / nC) * wp + C0 + e % nC];
        // the ring slot's previous block (b-2) is applied
        if (b >= 2) bar_sync(kBarFree + (b & 1));
        __syncwarp();
        for (int k = k0; k <= k1; ++k) {
          const bool use3 = k <= i - 2;
          double x[3];
          if (k == l) {
            double h3[9];
            for (int r = 0; r < 3; ++r)
              for (int c = 0; c < 3; ++c)
                h3[r * 3 + c] = s_win[k + r - R0][k + c - C0];
            first_column_shifted(h3, sr1, si1, sr2, -si1, use3, x);
            __syncwarp();  // every lane has read the block before it changes
          } else {
            x[0] = x0;
            x[1] = x1;
            x[2] = use3 ? x2 : 0.0;
          }
          // row k+3 of columns k..k+2: no update of this block has reached it
          double q0 = 0.0, q1 = 0.0, q2 = 0.0;
          if (lane == 2) {
            q0 = s_win[k + 3 - R0][k - C0];
            q1 = s_win[k + 3 - R0][k + 1 - C0];
            q2 = s_win[k + 3 - R0][k + 2 - C0];
          }
          const double v0 = 1.0;
          double v1, v2, tau, beta;
          chase_reflector(x[0], x[1], use3 ? x[2] : 0.0, v1, v2, tau, beta);
          // rows k..k+2, columns k-1 .. c_hi-1, then the exact plant of the
          // chase column; the columns from c_hi on wait for the block's end
          const int c0 = k - 1 > 0 ? k - 1 : 0;
          double t1 = 0.0, t2 = 0.0;  // rows k+1, k+2 of this lane's column
          for (int c = c0 + lane; c < c_hi; c += 32) {
            double* w0 = &s_win[k - R0][c - C0];
            double* w1 = &s_win[k + 1 - R0][c - C0];
            double* w2 = &s_win[k + 2 - R0][c - C0];
            double r0 = *w0, r1 = *w1, r2 = *w2;
            double s = v0 * r0 + v1 * r1 + v2 * r2;
            r0 -= tau * (v0 * s);
            r1 -= tau * (v1 * s);
            r2 -= tau * (v2 * s);
            if (k > l && c == k - 1) {
              r0 = beta;
              r1 = 0.0;
              if (use3) r2 = 0.0;
            }
            *w0 = r0;
            *w1 = r1;
            *w2 = r2;
            if (c < c0 + 32) {
              t1 = r1;
              t2 = r2;
            }
          }
          // rows k+1..k+3 of columns k..k+2, passed by shuffle from the
          // lanes that updated them; column k of them is the next chase
          // column
          const int j0 = k - c0;
          const double a0 = __shfl_sync(0xffffffffu, t1, j0);
          const double a1 = __shfl_sync(0xffffffffu, t1, j0 + 1);
          const double a2 = __shfl_sync(0xffffffffu, t1, j0 + 2);
          const double b0 = __shfl_sync(0xffffffffu, t2, j0);
          const double b1 = __shfl_sync(0xffffffffu, t2, j0 + 1);
          const double b2 = __shfl_sync(0xffffffffu, t2, j0 + 2);
          double e0 = lane == 0 ? a0 : (lane == 1 ? b0 : q0);
          double e1 = lane == 0 ? a1 : (lane == 1 ? b1 : q1);
          double e2 = lane == 0 ? a2 : (lane == 1 ? b2 : q2);
          __syncwarp();  // the left update's stores precede these
          double nx = 0.0;
          if (lane < 3) {
            double s = e0 * v0 + e1 * v1 + e2 * v2;
            e0 -= tau * (s * v0);
            e1 -= tau * (s * v1);
            e2 -= tau * (s * v2);
            double* row = &s_win[k + 1 + lane - R0][k - C0];
            row[0] = e0;
            row[1] = e1;
            row[2] = e2;
            nx = e0;
          }
          if (lane == 0) {
            ref[k - k0][0] = v0;
            ref[k - k0][1] = v1;
            ref[k - k0][2] = v2;
            ref[k - k0][3] = tau;
          }
          x0 = __shfl_sync(0xffffffffu, nx, 0);
          x1 = __shfl_sync(0xffffffffu, nx, 1);
          x2 = __shfl_sync(0xffffffffu, nx, 2);
          __syncwarp();
        }
        for (int e = lane; e < nR * nC; e += 32)
          H[(R0 + e / nC) * wp + C0 + e % nC] = s_win[e / nC][e % nC];
        __syncwarp();
        bar_arrive(kBarReady + (b & 1));  // the update warps take block b
        // block b's left updates of the kNear columns right of the window,
        // after block b-1's (the update warps did those that were far
        // columns of b-1)
        if (b >= 1) bar_sync(kBarNear + ((b - 1) & 1));
        const int c = c_hi + lane;
        if (b + 1 < nblk && c < wp) slide(H + c, wp, 0, k0, k1, k0, ref);
        __syncwarp();
      }
    } else {
      // ---- the update warps ----
      const int ut = tid - 32, uw = ut >> 5;
      double* tile = s_tiles + uw * 32 * kTileLd;
      for (int b = 0; b < nblk; ++b) {
        const int k0 = l + b * kBlockSteps;
        const int k1 = min(k0 + kBlockSteps - 1, i - 1);
        const int c_hi = k1 + 3;
        const double(*ref)[4] = s_ref[b & 1];
        const bool last = b + 1 == nblk;
        bar_sync(kBarReady + (b & 1));
        // far columns: the chase warp took [c_hi, c_hi + kNear) unless this
        // is the sweep's last block; the first kNear after that go first
        const int cs = last ? c_hi : min(c_hi + kNear, wp);
        int c = cs + ut;
        if (c < wp) slide(H + c, wp, 0, k0, k1, k0, ref);
        if (b + 1 < nblk) bar_arrive(kBarNear + (b & 1));
        for (c += kUpd; c < wp; c += kUpd) slide(H + c, wp, 0, k0, k1, k0, ref);
        // row strips: H rows 0..k1 from step max(r, k0) on, then Z
        const int nh = (k1 + 1 + 31) / 32, nz = (w + 31) / 32;
        for (int t = uw; t < nh + nz; t += kUpd / 32) {
          if (t < nh)
            row_tile(H, wp, t * 32, k1 + 1, k0, k1, true, tile, ref);
          else
            row_tile(Z, wp, (t - nh) * 32, w, k0, k1, false, tile, ref);
        }
        if (b + 2 < nblk) bar_arrive(kBarFree + (b & 1));
      }
    }
    __syncthreads();  // the sweep's last block is applied and visible
    its += 1;
    total += 1;
    failed = its >= kItmaxPerBlock;
  }
  if (tid == 0) info[0] = failed ? i + 1 : 0;
}

constexpr int kTileBytes = (kThreads / 32 - 1) * 32 * kTileLd * sizeof(double);

}  // namespace

extern "C" int francis(void* H, void* Z, int w, int m, int ilo, int maxiter,
                       double thresh, void* info, void* stream) {
  static bool configured = false;
  if (!configured) {
    cudaError_t e = cudaFuncSetAttribute(
        francis_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, kTileBytes);
    if (e != cudaSuccess) return static_cast<int>(e);
    configured = true;
  }
  francis_kernel<<<1, kThreads, kTileBytes, static_cast<cudaStream_t>(stream)>>>(
      static_cast<double*>(H), static_cast<double*>(Z), w, m, ilo, maxiter,
      thresh, static_cast<int*>(info));
  return static_cast<int>(cudaGetLastError());
}
