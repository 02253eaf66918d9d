// Window bubble of the eigenvalue reordering: selected 1x1/2x2 blocks move
// to the top of each window by adjacent swaps, one thread block per window,
// on the swap-chain engine (swap_chain.cuh).
//
// No TPU kernel to replace: the JAX package runs this state machine as one
// vmapped XLA while-loop (starneig_tpu/ops/reorder.py:_run_bubble_b,
// :143-156, over _bubble_scan/_bubble_swap, :92-136).  Plain twin:
// ops/reorder.py:_window_bubble, which matches it step for step.  A scan
// step finds the first selected block start in [dst, wlim); a block at dst
// advances dst, any other block becomes the source.  A swap step exchanges
// the source with the block above it (swap_adjacent_warp in common.cuh: 4x4
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
// What bounds it on the H100: the serial swap chain of each window, as in
// B4 (aed_deflate.cu).  The chain warp scans the selection flags and T's
// subdiagonal in shared memory (a ballot over 32 rows at a time), moves
// each block by the engine's segments, and updates the flags swap by swap;
// the update warps apply each segment's transform to the rest of the
// window and to Qp.  The window at W = 160 is 0.22 MB and stays in global
// memory / L2.  The windows of one pass are independent, so a launch runs
// them on as many SMs.
#include "swap_chain.cuh"

namespace {

using namespace swap_chain;

__global__ void __launch_bounds__(kThreads)
reorder_bubble_kernel(double* __restrict__ Tall, double* __restrict__ Qall,
                      int* __restrict__ sall, int* __restrict__ stall, int W) {
  extern __shared__ __align__(16) double smem[];
  __shared__ Meta meta;
  const int g = blockIdx.x;
  const int WP = W + 4;
  double* T = Tall + (size_t)g * WP * WP;
  double* Q = Qall + (size_t)g * W * WP;
  int* sel = sall + (size_t)g * (W + 4);
  int* st = stall + 4 * g;
  const int tid = threadIdx.x;
  const Smem sm = carve(smem, W);
  int* flags = reinterpret_cast<int*>(sm.extra);

  for (int i = tid; i < WP; i += kThreads) {
    sm.diag[i] = T[(size_t)i * WP + i];
    sm.sub[i] = i + 1 < WP ? T[(size_t)(i + 1) * WP + i] : 0.0;
    flags[i] = sel[i];
  }
  __syncthreads();

  if (tid >= 32) {
    update_warps(T, WP, Q, 0, W, sm, meta);
  } else {
    const int lane = tid;
    Chain ch{T, WP, W, sm, &meta};
    ch.cap = 4LL * W * W;
    int dst = st[0];
    const int dst_limit = st[1], wlim = st[2];
    int nfail = 0, swaps = 0;
    bool done = false;
    // the flags of the swapped rows: a moved block takes its selection
    // along, a stuck one is deselected
    auto on_swap = [&](int c, int p, int q, bool accept, const double*) {
      if (lane < 4) {
        const int old = flags[c + lane];
        const int moved = lane < q ? 1 : (lane < p + q ? 0 : old);
        const int stuck = (lane >= p && lane < p + q) ? 0 : old;
        flags[c + lane] = accept ? moved : stuck;
      }
      ++swaps;
    };
    while (!done && ch.steps < ch.cap) {
      // scan: the first selected block start in [dst, min(wlim, W))
      const int hi = wlim < W ? wlim : W;
      int s = W;
      for (int base = dst > 0 ? dst : 0; base < hi; base += 32) {
        const int i = base + lane;
        const bool hit = i < hi && flags[i] && (i == 0 || sm.sub[i - 1] == 0.0);
        const unsigned m = __ballot_sync(0xffffffffu, hit);
        if (m) {
          s = base + __ffs(m) - 1;
          break;
        }
      }
      done = s >= W || dst >= dst_limit;
      const bool at_dst = s == dst && !done;
      if (at_dst) dst += ch.bsize(s < W - 1 ? s : W - 1);
      ch.steps += 1;
      if (done || at_dst) continue;
      if (ch.move(s, dst, on_swap) == kRejected) nfail += 1;
    }
    ch.drain();
    ch.stop();
    if (lane == 0) {
      st[0] = dst;
      st[1] = nfail;
      st[2] = (int)ch.steps;
      st[3] = swaps;
    }
  }
  __syncthreads();
  for (int i = tid; i < W + 4; i += kThreads) sel[i] = flags[i];
}

}  // namespace

extern "C" int reorder_bubble(void* Tp, void* Qp, void* sel, void* state, int G,
                              int W, void* stream) {
  if (G < 1 || W < 1) return static_cast<int>(cudaErrorInvalidValue);
  static size_t configured = 0;
  const size_t bytes = smem_bytes(W);
  if (bytes > configured) {
    cudaError_t e = cudaFuncSetAttribute(
        reorder_bubble_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
    if (e != cudaSuccess) return static_cast<int>(e);
    configured = bytes;
  }
  reorder_bubble_kernel<<<G, kThreads, bytes, static_cast<cudaStream_t>(stream)>>>(
      static_cast<double*>(Tp), static_cast<double*>(Qp), static_cast<int*>(sel),
      static_cast<int*>(state), W);
  return static_cast<int>(cudaGetLastError());
}
