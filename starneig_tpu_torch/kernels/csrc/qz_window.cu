// G2: the window QZ machine (double-shift QZ with infinite eigenvalues and
// 2x2 standardization) on one window, the whole state machine in one block.
//
// Replaces the XLA while_loop of starneig_tpu/ops/qz.py:_build_qz_machine
// (:215, run by small_qz :177): find_l, process_inf (:252), sweep (:315),
// deflate2 (:389) and the iteration caps.  Plain twin:
// ops/qz.py:_small_qz_plain.  It serves the AED window (w = WA) and the
// whole problem below the small limit.
//
// What bounds it on the H100: the serial chain of decisions and chase
// steps.  A window solve runs thousands of steps, each a 3-reflector, a
// right 3-reflector and a rotation, every one depending on the previous
// step's updates; the flops a step (O(w)) are few.  Design, simple first:
// one block, the padded (w+3) matrices in global memory (L1/L2), thread 0
// for every scalar decision (the deflation point, the infinite-eigenvalue
// test, the shifts, each reflector and rotation, the standardization),
// the block for each update, a barrier between phases.  The updates run
// at the JAX version's widths (full padded rows and columns), so every
// entry sees the same operations in the same order as in the plain twin,
// up to FMA contraction.  The decisions are the plain twin's; over
// thousands of steps rounding may still change a deflation order, so the
// kernel is held to the contract, not elementwise.
#include "gep_common.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kItmaxPerBlock = 40;

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

  int i = m - 1, its = 0, total = 0;
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
      // ---- one double-shift QZ sweep over [l, i] ----
      if (tid == 0) shifts_qz(H, T, wp, i, its, sh + 12);
      for (int k = l; k <= i - 1; ++k) {
        const bool use3 = k <= i - 2;
        __syncthreads();
        if (tid == 0) {
          double x[3];
          if (k == l) {
            first_col_qz(H, T, wp, l, sh + 12, true, false, x);
          } else {
            x[0] = H[k * wp + k - 1];
            x[1] = H[(k + 1) * wp + k - 1];
            x[2] = H[(k + 2) * wp + k - 1];
          }
          double v[3], tau, beta;
          householder(x, use3 ? 7u : 3u, 3, v, tau, beta);
          sh[0] = v[0];
          sh[1] = v[1];
          sh[2] = v[2];
          sh[3] = tau;
          sh[4] = beta;
        }
        __syncthreads();
        {
          const double v0 = sh[0], v1 = sh[1], v2 = sh[2], tau = sh[3];
          for (int e = tid; e < 2 * wp + w; e += blockDim.x) {
            double *p0, *p1, *p2;
            if (e < 2 * wp) {
              double* M = e < wp ? H : T;
              p0 = M + (size_t)k * wp + e % wp;
              p1 = p0 + wp;
              p2 = p1 + wp;
            } else {
              p0 = Q + (size_t)(e - 2 * wp) * wp + k;
              p1 = p0 + 1;
              p2 = p0 + 2;
            }
            const double a = *p0, b = *p1, c = *p2;
            const double s = v0 * a + v1 * b + v2 * c;
            *p0 = a - tau * (v0 * s);
            *p1 = b - tau * (v1 * s);
            *p2 = c - tau * (v2 * s);
          }
        }
        __syncthreads();
        if (tid == 0) {
          if (k > l) {
            H[k * wp + k - 1] = sh[4];
            H[(k + 1) * wp + k - 1] = 0.0;
            if (use3) H[(k + 2) * wp + k - 1] = 0.0;
          }
          if (use3) {
            // right reflector from T's row k+2, reversed
            const double x[3] = {T[(k + 2) * wp + k + 2], T[(k + 2) * wp + k + 1],
                                 T[(k + 2) * wp + k]};
            double v[3], tau, beta;
            householder(x, 7u, 3, v, tau, beta);
            sh[5] = v[2];
            sh[6] = v[1];
            sh[7] = v[0];
            sh[8] = tau;
          }
        }
        __syncthreads();
        if (use3) {
          const double v0 = sh[5], v1 = sh[6], v2 = sh[7], tau = sh[8];
          for (int e = tid; e < 2 * wp + w; e += blockDim.x) {
            double* M = e < wp ? H : (e < 2 * wp ? T : Z);
            const int r = e < 2 * wp ? e % wp : e - 2 * wp;
            double* p = M + (size_t)r * wp + k;
            const double a = p[0], b = p[1], c = p[2];
            const double s = a * v0 + b * v1 + c * v2;
            p[0] = a - tau * (s * v0);
            p[1] = b - tau * (s * v1);
            p[2] = c - tau * (s * v2);
          }
          __syncthreads();
        }
        if (tid == 0) {
          if (use3) {
            T[(k + 2) * wp + k] = 0.0;
            T[(k + 2) * wp + k + 1] = 0.0;
          }
          double c2, s2, r;
          givens(T[(k + 1) * wp + k + 1], T[(k + 1) * wp + k], c2, s2, r);
          sh[9] = c2;
          sh[10] = s2;
        }
        __syncthreads();
        right_rot(W, k + 1, sh[9], -sh[10]);
        __syncthreads();
        if (tid == 0) T[(k + 1) * wp + k] = 0.0;
      }
      its += 1;
      failed = its >= kItmaxPerBlock;
    }
    total += 1;
    __syncthreads();
  }
  if (tid == 0) info[0] = failed ? i + 1 : 0;
}

}  // namespace

extern "C" int qz_window(void* H, void* T, void* Q, void* Z, int w, int m,
                         double thresh_h, double thresh_t, void* info,
                         void* stream) {
  qz_window_kernel<<<1, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<double*>(H), static_cast<double*>(T), static_cast<double*>(Q),
      static_cast<double*>(Z), w, m, thresh_h, thresh_t,
      static_cast<int*>(info));
  return static_cast<int>(cudaGetLastError());
}
