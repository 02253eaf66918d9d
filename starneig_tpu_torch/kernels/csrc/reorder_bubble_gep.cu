// G6: the window bubble of the pencil reordering, one window a block.
//
// Replaces the XLA while_loop of starneig_tpu/ops/reorder.py:
// _run_gep_bubble (:405), with its scan and swap bodies _gep_bubble_scan
// (:345) and _gep_bubble_swap (:361), which calls
// starneig_tpu/ops/swaps_gep.py:swap_adjacent_gep a swap.  Plain twin:
// ops/reorder.py:_window_bubble_gep (with ops/swaps_gep.py).
//
// State machine: a scan finds the first selected block at or below the
// insertion row dst (above the frozen rows >= wlim); a block already at dst
// advances dst, another becomes src and moves up by adjacent swaps, each a
// dtgex2 (the 8x8 pivoted Sylvester solve, two 4x2 column QRs, the
// acceptance test on both matrices, the 2x2 standardizations) applied to
// rows a..a+3 and columns a..a+3 of S and T and to columns of Q and Z.  A
// rejected swap deselects the moving block; dst advances only when a block
// arrives.  The loop ends when no selected block is left below dst, when
// dst reaches dst_limit, or after 4 W^2 steps.  Block sizes come from S's
// subdiagonal (T's 2x2 diagonal blocks are triangular).
//
// What bounds it on the H100: the chain of scans and swaps, each swap's
// scalar work depending on the previous swap's update; the updates are
// O(W) a swap.  Design, simple first (G4's, aed_deflate_gep.cu): thread 0
// runs the state machine and each swap (gep_common.cuh:swap_adjacent_gep,
// the plain twin's formulas, so the decisions follow the twin); the block
// applies an accepted swap's Qs^T to 4 rows of S and T at width W + 4, then
// Zs to 4 columns of S and T and Qs, Zs to 4 columns of Q and Z, then
// plants Ah and Bh over the 4x4 block (the JAX order).  The windows stay in
// global memory (L1/L2): at W = 128 the padded S and T take 2 x 139 KB,
// more than a block's 227 KB of shared memory.
//
// Layout, per window g: S, T (W+4) x (W+4) and Q, Z W x (W+4), row-major;
// sel W+4 ints (0/1); state {dst0, dst_limit, wlim, 0} in, {dst, nfail,
// steps, swaps} out.
#include "gep_common.cuh"

namespace {

constexpr int kThreads = 256;

__global__ void __launch_bounds__(kThreads)
reorder_bubble_gep_kernel(double* __restrict__ S_all, double* __restrict__ T_all,
                          double* __restrict__ Q_all, double* __restrict__ Z_all,
                          int* __restrict__ sel_all, int* __restrict__ state_all,
                          int W) {
  const int wp = W + 4;
  const size_t g = blockIdx.x;
  double* S = S_all + g * wp * wp;
  double* T = T_all + g * wp * wp;
  double* Q = Q_all + g * W * wp;
  double* Z = Z_all + g * W * wp;
  int* sel = sel_all + g * wp;
  int* state = state_all + 4 * g;
  const int tid = threadIdx.x;
  __shared__ double s_Q[16], s_Z[16], s_A[16], s_B[16];
  __shared__ int s_go, s_a;  // another step; the accepted swap's row (-1: none)
  // the state machine, in thread 0's registers
  int dst = state[0];
  const int dst_limit = state[1], wlim = state[2];
  int src = -1, nfail = 0, steps = 0, nswaps = 0;
  bool done = false;
  auto block_start = [&](int i) { return i == 0 || S[(size_t)i * wp + i - 1] == 0.0; };
  auto bsize = [&](int i) {
    return (i + 1 < W && S[(size_t)(i + 1) * wp + i] != 0.0) ? 2 : 1;
  };
  for (;;) {
    __syncthreads();  // the previous step's updates and reads are done
    if (tid == 0) {
      s_a = -1;
      s_go = !done && steps < 4 * W * W;
      if (s_go && src < 0) {
        const int hi = wlim < W ? wlim : W;
        int s = W;
        for (int i = dst > 0 ? dst : 0; i < hi; ++i)
          if (sel[i] && block_start(i)) {
            s = i;
            break;
          }
        done = s >= W || dst >= dst_limit;
        const bool at_dst = s == dst && !done;
        if (at_dst) dst += bsize(s < W - 1 ? s : W - 1);
        src = (done || at_dst) ? -1 : s;
        ++steps;
      } else if (s_go) {
        const int a = (src >= 2 && !block_start(src - 1)) ? src - 2 : src - 1;
        const int p = src - a, q = bsize(src);
        const int c = a > 0 ? a : 0;  // a < 0 only when dst0 splits a 2x2 block
        double A4[16], B4[16];
        for (int r = 0; r < 4; ++r)
          for (int k = 0; k < 4; ++k) {
            A4[r * 4 + k] = S[(size_t)(c + r) * wp + c + k];
            B4[r * 4 + k] = T[(size_t)(c + r) * wp + c + k];
          }
        double Qs[16], Zs[16], Ah[16], Bh[16];
        const bool accept = swap_adjacent_gep(A4, B4, p, q, Qs, Zs, Ah, Bh);
        int old[4];
        for (int k = 0; k < 4; ++k) old[k] = sel[c + k];
        if (accept) {
          for (int e = 0; e < 16; ++e) {
            s_Q[e] = Qs[e];
            s_Z[e] = Zs[e];
            s_A[e] = Ah[e];
            s_B[e] = Bh[e];
          }
          s_a = c;
          for (int k = 0; k < 4; ++k) sel[c + k] = k < q ? 1 : (k < p + q ? 0 : old[k]);
          src = a;
          if (src == dst) {
            dst += q;
            src = -1;
          }
        } else {
          for (int k = 0; k < 4; ++k) sel[c + k] = (k >= p && k < p + q) ? 0 : old[k];
          src = -1;
          ++nfail;
        }
        ++nswaps;
        ++steps;
      }
    }
    __syncthreads();
    if (!s_go) break;
    const int a = s_a;
    if (a < 0) continue;
    // rows a..a+3 of S and T: Qs^T rows, full width
    for (int e = tid; e < 2 * wp; e += blockDim.x) {
      double* M = (e < wp ? S : T) + (size_t)a * wp + e % wp;
      double x[4], y[4];
      for (int r = 0; r < 4; ++r) x[r] = M[r * wp];
      for (int k = 0; k < 4; ++k) {
        double s = 0.0;
        for (int r = 0; r < 4; ++r) s += s_Q[r * 4 + k] * x[r];
        y[k] = s;
      }
      for (int r = 0; r < 4; ++r) M[r * wp] = y[r];
    }
    __syncthreads();
    // columns a..a+3 of S, T (full height) times Zs, of Q times Qs and of Z
    // times Zs
    for (int e = tid; e < 2 * wp + 2 * W; e += blockDim.x) {
      double* M;
      const double* G;
      int r;
      if (e < 2 * wp) {
        M = e < wp ? S : T;
        r = e % wp;
        G = s_Z;
      } else {
        M = e < 2 * wp + W ? Q : Z;
        r = (e - 2 * wp) % W;
        G = e < 2 * wp + W ? s_Q : s_Z;
      }
      double* p = M + (size_t)r * wp + a;
      double x[4], y[4];
      for (int k = 0; k < 4; ++k) x[k] = p[k];
      for (int k = 0; k < 4; ++k) {
        double s = 0.0;
        for (int j = 0; j < 4; ++j) s += x[j] * G[j * 4 + k];
        y[k] = s;
      }
      for (int k = 0; k < 4; ++k) p[k] = y[k];
    }
    __syncthreads();
    if (tid < 16) {
      S[(size_t)(a + tid / 4) * wp + a + tid % 4] = s_A[tid];
      T[(size_t)(a + tid / 4) * wp + a + tid % 4] = s_B[tid];
    }
  }
  if (tid == 0) {
    state[0] = dst;
    state[1] = nfail;
    state[2] = steps;
    state[3] = nswaps;
  }
}

}  // namespace

extern "C" int reorder_bubble_gep(void* S, void* T, void* Q, void* Z, void* sel,
                                  void* state, int G, int W, void* stream) {
  if (G < 1 || W < 2) return static_cast<int>(cudaErrorInvalidValue);
  reorder_bubble_gep_kernel<<<G, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<double*>(S), static_cast<double*>(T), static_cast<double*>(Q),
      static_cast<double*>(Z), static_cast<int*>(sel), static_cast<int*>(state), W);
  return static_cast<int>(cudaGetLastError());
}
