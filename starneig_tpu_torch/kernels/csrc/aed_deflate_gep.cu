// G4: the GEP AED spike deflation (the bottom-up spike test and the
// generalized block moves) on one window, in one block.
//
// Replaces the XLA while_loop of starneig_tpu/ops/qz_driver.py:
// _aed_deflate_gep (:63) with _aed_gep_test (:99) and _aed_gep_move (:121),
// which calls starneig_tpu/ops/swaps_gep.py:swap_adjacent_gep (:85) a move.
// Plain twin: ops/qz_driver.py:_aed_deflate_gep (with ops/swaps_gep.py).
//
// State: kbot (rows still undeflated), ilst (the front the undeflatable
// blocks move to), src (the block being moved, or -1 for a test).  A test
// reads the spike entries s Q[0, .] of the bottom block: negligible ->
// kbot shrinks past it; else it moves to the front by adjacent swaps, each
// a dtgex2 (an 8x8 pivoted Sylvester solve, two 4x2 column QRs, the
// acceptance test on both matrices, the 2x2 standardizations) applied to
// rows a..a+3 and columns a..a+3 of S and T and to columns of Q and Z.  A
// rejected swap ends the scan (fail).
//
// What bounds it on the H100: the chain of tests and swaps, each swap's
// scalar work depending on the previous swap's update; the updates are
// O(WA) a swap.  Design, simple first: thread 0 runs the state machine and
// each swap (gep_common.cuh:swap_adjacent_gep, the plain twin's formulas);
// the block applies an accepted swap's 4x4 transforms at the window's full
// width (padded WA + 4, global memory, L1/L2) with a barrier between the
// row and the column phase.  kbot, fail and the step count equal the plain
// twin's.
#include "gep_common.cuh"

namespace {

constexpr int kThreads = 256;

__global__ void __launch_bounds__(kThreads)
aed_deflate_gep_kernel(double* __restrict__ S, double* __restrict__ T,
                       double* __restrict__ Q, double* __restrict__ Z, int WA,
                       int w, double spike, double thresh, int* __restrict__ stat) {
  const int wp = WA + 4;  // S, T: wp x wp; Q, Z: WA x wp (row-major, ld wp)
  const int tid = threadIdx.x;
  __shared__ double s_Q[16], s_Z[16], s_A[16], s_B[16];
  __shared__ int s_state[5];  // kbot, ilst, src, fail, a (the moved block's row; -1: none)
  if (tid == 0) {
    s_state[0] = w;
    s_state[1] = 0;
    s_state[2] = -1;
    s_state[3] = 0;
  }
  int steps = 0;
  for (;;) {
    __syncthreads();
    if (!(s_state[0] > s_state[1] && !s_state[3] && steps < 4 * WA * WA)) break;
    __syncthreads();  // everyone has read the state before thread 0 moves on
    if (tid == 0) {
      int kbot = s_state[0], ilst = s_state[1], src = s_state[2];
      s_state[4] = -1;
      if (src < 0) {
        const int e = kbot - 1;
        const int sz = (e >= 1 && S[e * wp + e - 1] != 0.0) ? 2 : 1;
        const int start = kbot - sz;
        const double sp0 = spike * Q[start > 0 ? start : 0];
        const double sp1 = spike * Q[kbot - 1 > 0 ? kbot - 1 : 0];
        const double foot = dmax(fabs(sp0), fabs(sp1) * (sz == 2 ? 1.0 : 0.0));
        const double tst = fabs(S[start * wp + start]) +
                           (sz == 2 ? fabs(S[(kbot - 1) * wp + kbot - 1]) : 0.0);
        if (foot <= dmax(DBL_EPSILON * tst, thresh)) {
          kbot = start;
          src = -1;
        } else if (start == ilst) {
          ilst += sz;
          src = -1;
        } else {
          src = start;
        }
      } else {
        const int e = src - 1;
        const int p = (e >= 1 && S[e * wp + e - 1] != 0.0) ? 2 : 1;
        const int a = src - p;
        const int q = (src + 1 < WA && S[(src + 1) * wp + src] != 0.0) ? 2 : 1;
        double A4[16], B4[16];
        for (int r = 0; r < 4; ++r)
          for (int c = 0; c < 4; ++c) {
            A4[r * 4 + c] = S[(a + r) * wp + a + c];
            B4[r * 4 + c] = T[(a + r) * wp + a + c];
          }
        double Qs[16], Zs[16], Ah[16], Bh[16];
        const bool accept = swap_adjacent_gep(A4, B4, p, q, Qs, Zs, Ah, Bh);
        if (accept) {
          for (int i = 0; i < 16; ++i) {
            s_Q[i] = Qs[i];
            s_Z[i] = Zs[i];
            s_A[i] = Ah[i];
            s_B[i] = Bh[i];
          }
          s_state[4] = a;
          src = a;
          if (src == ilst) {
            ilst += q;
            src = -1;
          }
        } else {
          src = -1;
          s_state[3] = 1;
        }
      }
      s_state[0] = kbot;
      s_state[1] = ilst;
      s_state[2] = src;
    }
    __syncthreads();
    ++steps;
    const int a = s_state[4];
    if (a < 0) continue;
    // rows a..a+3 of S and T: Qs^T rows, full width
    for (int e = tid; e < 2 * wp; e += blockDim.x) {
      double* M = (e < wp ? S : T) + (size_t)a * wp + e % wp;
      double x[4], y[4];
      for (int r = 0; r < 4; ++r) x[r] = M[r * wp];
      for (int c = 0; c < 4; ++c) {
        double s = 0.0;
        for (int k = 0; k < 4; ++k) s += s_Q[k * 4 + c] * x[k];
        y[c] = s;
      }
      for (int r = 0; r < 4; ++r) M[r * wp] = y[r];
    }
    __syncthreads();
    // columns a..a+3 of S, T (full height) times Zs, of Q times Qs and of Z
    // times Zs
    for (int e = tid; e < 2 * wp + 2 * WA; e += blockDim.x) {
      double* M;
      const double* G;
      int r;
      if (e < 2 * wp) {
        M = e < wp ? S : T;
        r = e % wp;
        G = s_Z;
      } else {
        M = e < 2 * wp + WA ? Q : Z;
        r = (e - 2 * wp) % WA;
        G = e < 2 * wp + WA ? s_Q : s_Z;
      }
      double* p = M + (size_t)r * wp + a;
      double x[4], y[4];
      for (int c = 0; c < 4; ++c) x[c] = p[c];
      for (int c = 0; c < 4; ++c) {
        double s = 0.0;
        for (int k = 0; k < 4; ++k) s += x[k] * G[k * 4 + c];
        y[c] = s;
      }
      for (int c = 0; c < 4; ++c) p[c] = y[c];
    }
    __syncthreads();
    if (tid < 16) {
      S[(size_t)(a + tid / 4) * wp + a + tid % 4] = s_A[tid];
      T[(size_t)(a + tid / 4) * wp + a + tid % 4] = s_B[tid];
    }
  }
  if (tid == 0) {
    stat[0] = s_state[0];
    stat[1] = s_state[3];
    stat[2] = steps;
  }
}

}  // namespace

extern "C" int aed_deflate_gep(void* S, void* T, void* Q, void* Z, int WA, int w,
                               double s, double thresh, void* stat, void* stream) {
  aed_deflate_gep_kernel<<<1, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<double*>(S), static_cast<double*>(T), static_cast<double*>(Q),
      static_cast<double*>(Z), WA, w, s, thresh, static_cast<int*>(stat));
  return static_cast<int>(cudaGetLastError());
}
