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
// acceptance test on both matrices, the 2x2 standardizations).  A rejected
// swap deselects the moving block; dst advances only when a block arrives.
// The loop ends when no selected block is left below dst, when dst reaches
// dst_limit, or after 4 W^2 steps.  Block sizes come from S's subdiagonal
// (T's 2x2 diagonal blocks are triangular).
//
// What bounds it on the H100: the chain of swaps, each swap's scalar work
// depending on the previous swap's result; the updates are O(W) a swap.
// Design: the two-sided swap-chain engine (swap_chain_gep.cuh): the chain
// warp runs the state machine (a scan is one ballot over 32 rows of the
// selection and S's subdiagonal in shared memory) and every swap on its
// lanes (swap_adjacent_gep_warp, the plain twin's formulas, so accept and
// reject follow the twin), on the segment's diagonal blocks of S and T in
// shared memory; the update warps apply each segment's left and right
// factors to the rest of S and T and to Q and Z as level-3 products.
//
// Layout, per window g: S, T (W+4) x (W+4) and Q, Z W x (W+4), row-major;
// sel W+4 ints (0/1); state {dst0, dst_limit, wlim, 0} in, {dst, nfail,
// steps, swaps} out.
#include "swap_chain_gep.cuh"

namespace {

using namespace swap_chain_gep;

__global__ void __launch_bounds__(kThreads)
reorder_bubble_gep_kernel(double* __restrict__ S_all, double* __restrict__ T_all,
                          double* __restrict__ Q_all, double* __restrict__ Z_all,
                          int* __restrict__ sel_all, int* __restrict__ state_all,
                          int W) {
  extern __shared__ __align__(16) double smem[];
  __shared__ Meta meta;
  const int WP = W + 4;
  const size_t g = blockIdx.x;
  double* S = S_all + g * WP * WP;
  double* T = T_all + g * WP * WP;
  double* Q = Q_all + g * W * WP;
  double* Z = Z_all + g * W * WP;
  int* sel = sel_all + g * WP;
  int* st = state_all + 4 * g;
  const int tid = threadIdx.x;
  const Smem sm = carve(smem, W);
  int* flags = reinterpret_cast<int*>(sm.extra);

  for (int i = tid; i < WP; i += kThreads) {
    sm.sub[i] = i + 1 < WP ? S[(size_t)(i + 1) * WP + i] : 0.0;
    flags[i] = sel[i];
  }
  __syncthreads();

  if (tid >= 32) {
    update_warps(S, T, WP, Q, 0, Z, 0, W, sm, meta);
  } else {
    const int lane = tid;
    Chain ch{S, T, WP, W, sm, &meta};
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
  for (int i = tid; i < WP; i += kThreads) sel[i] = flags[i];
}

}  // namespace

extern "C" int reorder_bubble_gep(void* S, void* T, void* Q, void* Z, void* sel,
                                  void* state, int G, int W, void* stream) {
  if (G < 1 || W < 2) return static_cast<int>(cudaErrorInvalidValue);
  static size_t configured = 0;
  const size_t bytes = smem_bytes(W);
  if (bytes > configured) {
    cudaError_t e = cudaFuncSetAttribute(
        reorder_bubble_gep_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)bytes);
    if (e != cudaSuccess) return static_cast<int>(e);
    configured = bytes;
  }
  reorder_bubble_gep_kernel<<<G, kThreads, bytes, static_cast<cudaStream_t>(stream)>>>(
      static_cast<double*>(S), static_cast<double*>(T), static_cast<double*>(Q),
      static_cast<double*>(Z), static_cast<int*>(sel), static_cast<int*>(state), W);
  return static_cast<int>(cudaGetLastError());
}
