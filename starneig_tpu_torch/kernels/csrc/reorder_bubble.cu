// Window bubble of the eigenvalue reordering: selected 1x1/2x2 blocks move
// to the top of each window by adjacent swaps, one thread block per window.
//
// No TPU kernel to replace: the JAX package runs this state machine as one
// vmapped XLA while-loop (starneig_tpu/ops/reorder.py:_run_bubble_b,
// :143-156, over _bubble_scan/_bubble_swap, :92-136).  Plain twin:
// ops/reorder.py:_window_bubble, which matches it step for step.  A scan
// step finds the first selected block start in [dst, wlim); a block at dst
// advances dst, any other block becomes the source.  A swap step exchanges
// the source with the block above it (swap_adjacent in common.cuh: 4x4
// Sylvester solve, Householder step, acceptance test), applies the 4x4
// transform to 4 rows and 4 columns of the (W+4)^2 window and to 4 columns
// of the W x (W+4) transform, and moves the selection flags; a rejected
// swap deselects the stuck block and counts a failure.  The loop stops when
// no candidate is left, when dst reaches dst_limit, or after 4 W^2 steps.
//
// Inputs per window g: Tp (W+4, W+4) with the window in [:W, :W], Qp
// (W, W+4) = [I 0], sel (W+4) int flags (0 past W), state = {dst0,
// dst_limit, wlim, 0}; rows < dst0 and >= wlim are frozen.  On return
// state = {dst, nfail, steps, swaps}.
//
// What bounds it on the H100: latency, as in B4 (aed_deflate.cu).  Every
// swap is a scalar decision and the 4x4 swap on thread 0's registers, then
// a rank-4 similarity on 4 rows and 4 columns (~40 W flops) behind
// barriers; the window at W = 160 is 0.22 MB and stays in global memory /
// L2.  The windows of one pass are independent, so a launch runs them on
// as many SMs.
#include "common.cuh"

namespace {

constexpr int kThreads = 256;

__global__ void __launch_bounds__(kThreads)
reorder_bubble_kernel(double* __restrict__ Tall, double* __restrict__ Qall,
                      int* __restrict__ sall, int* __restrict__ stall, int W) {
  const int g = blockIdx.x;
  const int WP = W + 4;
  double* T = Tall + (size_t)g * WP * WP;
  double* Q = Qall + (size_t)g * W * WP;
  int* sel = sall + (size_t)g * (W + 4);
  int* st = stall + 4 * g;
  const int tid = threadIdx.x, nt = blockDim.x;
  const long long cap = 4LL * W * W;

  __shared__ int s_dst, s_src, s_nfail, s_done, s_cand, s_swaps;
  __shared__ int s_dst_limit, s_wlim, s_a, s_c, s_q, s_accept;
  __shared__ long long s_steps;
  __shared__ double s_Q[16], s_Dh[16];

  if (tid == 0) {
    s_dst = st[0];
    s_dst_limit = st[1];
    s_wlim = st[2];
    s_src = -1;
    s_nfail = 0;
    s_done = 0;
    s_steps = 0;
    s_swaps = 0;
    s_cand = W;
  }
  __syncthreads();

  // a block of the window starts at row i (i < W)
  auto block_start = [&](int i) { return i == 0 || T[i * WP + i - 1] == 0.0; };
  // size of the block starting at row i
  auto bsize = [&](int i) {
    return (i + 1 < W && T[(i + 1) * WP + i] != 0.0) ? 2 : 1;
  };

  while (true) {
    const bool go = !s_done && s_steps < cap;
    const bool scan = s_src < 0;
    const int dst = s_dst;
    __syncthreads();  // every thread has read the state before it changes
    if (!go) break;
    if (scan) {
      const int hi = s_wlim < W ? s_wlim : W;
      int best = W;
      for (int i = dst + tid; i < hi; i += nt)
        if (i >= 0 && sel[i] && block_start(i)) { best = i; break; }
      if (best < W) atomicMin(&s_cand, best);
      __syncthreads();
      if (tid == 0) {
        const int s = s_cand;
        const bool done = s >= W || dst >= s_dst_limit;
        const bool at_dst = s == dst && !done;
        if (at_dst) s_dst = dst + bsize(s < W - 1 ? s : W - 1);
        s_src = (done || at_dst) ? -1 : s;
        s_done = done;
        s_steps += 1;
        s_cand = W;
      }
      __syncthreads();
      continue;
    }
    // swap the source block with the block above it
    if (tid == 0) {
      const int src = s_src;
      const int a = (src >= 2 && !block_start(src - 1)) ? src - 2 : src - 1;
      const int p = src - a;
      const int q = bsize(src);
      // a < 0 only when dst0 splits a 2x2 block, which the reorder routines
      // never do; the slices then start at 0 and stay in bounds (as in the twin)
      const int ac = a > 0 ? a : 0;
      double D[16], Qs[16], Dh[16];
      for (int r = 0; r < 4; ++r)
        for (int c = 0; c < 4; ++c) D[r * 4 + c] = T[(ac + r) * WP + ac + c];
      const bool accept = swap_adjacent(D, p, q, Qs, Dh);
      for (int i = 0; i < 16; ++i) { s_Q[i] = Qs[i]; s_Dh[i] = Dh[i]; }
      s_a = a;
      s_c = ac;
      s_q = q;
      s_accept = accept;
      int flags[4];
      for (int i = 0; i < 4; ++i) {
        const int old = sel[ac + i];
        const int moved = i < q ? 1 : (i < p + q ? 0 : old);
        const int stuck = (i >= p && i < p + q) ? 0 : old;
        flags[i] = accept ? moved : stuck;
      }
      for (int i = 0; i < 4; ++i) sel[ac + i] = flags[i];
    }
    __syncthreads();
    const int a = s_c;
    // rows a..a+3 <- Qs^T rows, full width
    for (int c = tid; c < WP; c += nt) {
      double r[4], o[4];
      for (int j = 0; j < 4; ++j) r[j] = T[(a + j) * WP + c];
      for (int i = 0; i < 4; ++i) {
        double acc = 0.0;
        for (int j = 0; j < 4; ++j) acc += s_Q[j * 4 + i] * r[j];
        o[i] = acc;
      }
      for (int i = 0; i < 4; ++i) T[(a + i) * WP + c] = o[i];
    }
    __syncthreads();
    // columns a..a+3 <- cols Qs, full height; then Q's columns
    for (int r = tid; r < WP + W; r += nt) {
      double* row = r < WP ? T + r * WP + a : Q + (r - WP) * WP + a;
      double x[4], o[4];
      for (int j = 0; j < 4; ++j) x[j] = row[j];
      for (int i = 0; i < 4; ++i) {
        double acc = 0.0;
        for (int j = 0; j < 4; ++j) acc += x[j] * s_Q[j * 4 + i];
        o[i] = acc;
      }
      for (int i = 0; i < 4; ++i) row[i] = o[i];
    }
    __syncthreads();
    if (tid == 0) {
      for (int r = 0; r < 4; ++r)
        for (int c = 0; c < 4; ++c) T[(a + r) * WP + a + c] = s_Dh[r * 4 + c];
      int src = s_accept ? s_a : -1;
      if (s_accept && src == s_dst) {
        s_dst += s_q;
        src = -1;
      }
      s_src = src;
      s_nfail += s_accept ? 0 : 1;
      s_steps += 1;
      s_swaps += 1;
    }
    __syncthreads();
  }
  if (tid == 0) {
    st[0] = s_dst;
    st[1] = s_nfail;
    st[2] = (int)s_steps;
    st[3] = s_swaps;
  }
}

}  // namespace

extern "C" int reorder_bubble(void* Tp, void* Qp, void* sel, void* state, int G,
                              int W, void* stream) {
  if (G < 1 || W < 1) return static_cast<int>(cudaErrorInvalidValue);
  reorder_bubble_kernel<<<G, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<double*>(Tp), static_cast<double*>(Qp), static_cast<int*>(sel),
      static_cast<int*>(state), W);
  return static_cast<int>(cudaGetLastError());
}
