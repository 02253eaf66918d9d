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
// What bounds it on the H100: latency, not flops or bytes.  Each chase step
// is a serial dependency chain (reflector -> 3 rows -> 3 columns); a window
// solve runs ~w^2 such steps.  At the main path's w = 322 the padded H and
// Z are 2 x 0.83 MB: too large for one block's 227 KB of shared memory, so
// they stay in global memory and live in L1/L2.
//
// Design: keep on the serial path only what the next reflector reads.  The
// iteration state (i, its, total) lives in registers, the same in every
// thread.  Step k of a sweep needs rows k..k+2 (left update) and then rows
// k+1..k+3 of columns k..k+2 (right update), which leave the next chase
// column in shared memory.  Nothing later in the sweep reads
//   * rows 0..k (above the bulge): their right updates from step k on,
//   * Z: all its right updates,
//   * columns right of the bulge's reach: their left updates,
// so the sweep runs in blocks of kBlockSteps steps.  A block copies its
// near-diagonal window (rows k0..k1+3, columns k0-1..k1+2, at most 36 x 36)
// into shared memory, one warp runs the block's steps there (each lane
// computes the reflector itself; __syncwarp between the two updates) and
// buffers the reflectors, the window goes back, and every thread then
// applies the buffered reflectors to its own rows or columns in step
// order, the strip held in registers, with no barrier.  Each matrix entry
// sees the same operations in the same order as in the plain version (up
// to FMA contraction).  The row updates run at full height above the bulge
// (band-limiting them from above is unsound: upper content migrates into
// later decisions); rows below k+3 and columns left of k-1 are exactly zero
// there and skipped.
#include "common.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kItmaxPerBlock = 30;
constexpr int kBlockSteps = 32;

// Apply the buffered reflectors of steps kfirst..klast (ref[k - k0] holds
// v0, v1, v2, tau of step k) to the strip p[k * stride], k = kfirst ..
// klast + 2, in step order: one 3-element update per step.  The strip (at
// most kBlockSteps + 2 entries) is loaded into registers first, so its
// loads overlap instead of chaining.
__device__ __forceinline__ void slide(double* p, int stride, int kfirst,
                                      int klast, int k0,
                                      const double (*ref)[4]) {
  const int n = klast - kfirst + 3;
  double seg[kBlockSteps + 2];
#pragma unroll
  for (int j = 0; j < kBlockSteps + 2; ++j)
    if (j < n) seg[j] = p[(kfirst + j) * stride];
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
    if (j < n) p[(kfirst + j) * stride] = seg[j];
}

__global__ void __launch_bounds__(kThreads)
francis_kernel(double* __restrict__ H, double* __restrict__ Z, int w, int m,
               int ilo, int maxiter, double thresh, int* __restrict__ info) {
  const int wp = w + 2;  // H is (w+2) x (w+2), Z is w x (w+2), row-major
  const int tid = threadIdx.x;
  const int nt = blockDim.x;
  const double ulp = DBL_EPSILON;

  __shared__ int s_l;
  __shared__ double s_x[3], s_rot[6];
  __shared__ double s_ref[kBlockSteps][4];
  // the block's near-diagonal window: rows k0..k1+3, columns k0-1..k1+2
  __shared__ double s_win[kBlockSteps + 4][kBlockSteps + 5];

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

    // one bulge chase over the active block [l, i], in blocks of steps
    for (int k0 = l; k0 <= i - 1; k0 += kBlockSteps) {
      const int k1 = min(k0 + kBlockSteps - 1, i - 1);
      const int c_hi = k1 + 3;  // columns the block's right updates reach; < wp
      const int R0 = k0, C0 = k0 - 1 > 0 ? k0 - 1 : 0;
      const int nR = k1 + 4 - R0, nC = c_hi - C0;  // k1 + 3 <= i + 2 < wp
      // the window is current: the previous block's deferred updates (and
      // thread 0's zeroing of H[l, l-1]) are done and visible
      __syncthreads();
      for (int e = tid; e < nR * nC; e += nt)
        s_win[e / nC][e % nC] = H[(R0 + e / nC) * wp + C0 + e % nC];
      __syncthreads();
      if (tid < 32) {  // the block's steps, on one warp
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
            x[0] = s_x[0];
            x[1] = s_x[1];
            x[2] = use3 ? s_x[2] : 0.0;
          }
          double v[3], tau, beta;
          householder(x, use3 ? 7u : 3u, 3, v, tau, beta);
          const double v0 = v[0], v1 = v[1], v2 = v[2];
          // rows k..k+2, columns k-1 .. c_hi-1, then the exact plant of the
          // chase column; the columns from c_hi on wait for the block's end
          const int c0 = k - 1 > 0 ? k - 1 : 0;
          for (int c = c0 + tid; c < c_hi; c += 32) {
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
          }
          __syncwarp();
          // rows k+1..k+3 of columns k..k+2; column k of them is the next
          // chase column
          if (tid < 3) {
            double* row = &s_win[k + 1 + tid - R0][k - C0];
            double s = row[0] * v0 + row[1] * v1 + row[2] * v2;
            row[0] -= tau * (s * v0);
            row[1] -= tau * (s * v1);
            row[2] -= tau * (s * v2);
            s_x[tid] = row[0];
          }
          if (tid == 0) {
            s_ref[k - k0][0] = v0;
            s_ref[k - k0][1] = v1;
            s_ref[k - k0][2] = v2;
            s_ref[k - k0][3] = tau;
          }
          __syncwarp();
        }
      }
      __syncthreads();
      for (int e = tid; e < nR * nC; e += nt)
        H[(R0 + e / nC) * wp + C0 + e % nC] = s_win[e / nC][e % nC];
      __syncthreads();
      // the block's deferred updates, each strip by one thread in step
      // order: the left updates of columns c_hi.., the right updates of
      // rows 0..k1 from step max(r, k0) on, and those of every row of Z
      const int nfar = wp - c_hi, nrows = k1 + 1;
      for (int e = tid; e < nfar + nrows + w; e += nt) {
        if (e < nfar) {
          slide(H + c_hi + e, wp, k0, k1, k0, s_ref);
        } else if (e < nfar + nrows) {
          const int r = e - nfar;
          slide(H + r * wp, 1, r > k0 ? r : k0, k1, k0, s_ref);
        } else {
          slide(Z + (e - nfar - nrows) * wp, 1, k0, k1, k0, s_ref);
        }
      }
    }
    __syncthreads();  // the last block's deferred updates are visible
    its += 1;
    total += 1;
    failed = its >= kItmaxPerBlock;
  }
  if (tid == 0) info[0] = failed ? i + 1 : 0;
}

}  // namespace

extern "C" int francis(void* H, void* Z, int w, int m, int ilo, int maxiter,
                       double thresh, void* info, void* stream) {
  francis_kernel<<<1, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<double*>(H), static_cast<double*>(Z), w, m, ilo, maxiter,
      thresh, static_cast<int*>(info));
  return static_cast<int>(cudaGetLastError());
}
