// G4: the GEP AED spike deflation (the bottom-up spike test and the
// generalized block moves) on one window, in one block, on the two-sided
// swap-chain engine (swap_chain_gep.cuh).
//
// Replaces the XLA while_loop of starneig_tpu/ops/qz_driver.py:
// _aed_deflate_gep (:63) with _aed_gep_test (:99) and _aed_gep_move (:121),
// which calls starneig_tpu/ops/swaps_gep.py:swap_adjacent_gep (:85) a move.
// Plain twin: ops/qz_driver.py:_aed_deflate_gep (with ops/swaps_gep.py).
//
// State: kbot (rows still undeflated), ilst (the front the undeflatable
// blocks move to).  A test reads the spike entries s Q[0, .] of the bottom
// block: negligible -> kbot shrinks past it; else it moves to the front by
// adjacent swaps, each a dtgex2 (an 8x8 pivoted Sylvester solve, two 4x2
// column QRs, the acceptance test on both matrices, the 2x2
// standardizations).  A rejected swap ends the scan (fail).  The step cap
// is 4 WA^2, a test or a swap a step.
//
// What bounds it on the H100: the chain of tests and swaps, each swap's
// scalar work depending on the previous swap's result; the updates (4 rows
// and 4 columns of S and T, 4 columns of Q and Z, O(WA) a swap) are
// parallel but would sit on the chain if applied block-wide after every
// swap.  Design: the engine's chain warp (warp 0) runs the test steps and
// each move's segments of swaps in shared memory (swap_adjacent_gep_warp,
// the plain twin's formulas and rounding, so every decision is the twin's);
// the update warps (1..7) replay each segment's logged Qs and Zs on the
// rest of S and T, on Q's rows from row 1 and on all of Z's.  The state a
// test reads: S's subdiagonal (the block sizes, the engine's), the spike
// (Q's row 0, kept only in the chain warp's shared memory, where it takes
// each accepted swap's Qs in the twin's order, and written back at the
// end) and S's two diagonal entries, read from global memory after the
// move's blocks went back (the update warps never write S's diagonal).
// kbot, fail and the step count equal the plain twin's.
#include "swap_chain_gep.cuh"

namespace {

using namespace swap_chain_gep;

__global__ void __launch_bounds__(kThreads)
aed_deflate_gep_kernel(double* S, double* T, double* Q, double* Z, int WA, int w,
                       double s, double thresh, int* __restrict__ stat) {
  extern __shared__ __align__(16) double smem[];
  __shared__ Meta meta;
  const int WP = WA + 4;  // S, T: WP x WP; Q, Z: WA x WP (row-major, ld WP)
  const int tid = threadIdx.x;
  const Smem sm = carve(smem, WA);
  double* spike = sm.extra;  // Q's row 0

  for (int i = tid; i < WP; i += kThreads) {
    sm.sub[i] = i + 1 < WP ? S[(size_t)(i + 1) * WP + i] : 0.0;
    spike[i] = Q[i];
  }
  __syncthreads();

  if (tid >= 32) {
    update_warps(S, T, WP, Q, 1, Z, 0, WA, sm, meta);
  } else {
    const int lane = tid;
    Chain ch{S, T, WP, WA, sm, &meta};
    ch.cap = 4LL * WA * WA;
    int kbot = w, ilst = 0;
    bool fail = false;
    // the spike takes each accepted swap's Qs, in the plain twin's order
    auto on_swap = [&](int c, int p, int q, bool accept, const double* Qs) {
      if (!accept) return;
      const int d = p + q;
      double x[4];
#pragma unroll
      for (int t = 0; t < 4; ++t) x[t] = t < d ? spike[c + t] : 0.0;
      __syncwarp();  // every lane has read the entries before they change
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        double acc = 0.0;
#pragma unroll
        for (int t = 0; t < 4; ++t)
          if (t < d) acc += x[t] * Qs[t * 4 + i];
        if (i == lane && i < d) spike[c + i] = acc;
      }
    };
    while (kbot > ilst && !fail && ch.steps < ch.cap) {
      // test the bottom block
      const int sz = (kbot - 1 >= 1 && sm.sub[kbot - 2] != 0.0) ? 2 : 1;
      const int start = kbot - sz;
      const double sp0 = s * spike[start > 0 ? start : 0];
      const double sp1 = s * spike[kbot - 1 > 0 ? kbot - 1 : 0];
      const double foot = dmax(fabs(sp0), fabs(sp1) * (sz == 2 ? 1.0 : 0.0));
      const double tst = fabs(S[(size_t)start * WP + start]) +
                         (sz == 2 ? fabs(S[(size_t)(kbot - 1) * WP + kbot - 1]) : 0.0);
      ch.steps += 1;
      if (foot <= dmax(DBL_EPSILON * tst, thresh)) {
        kbot = start;
      } else if (start == ilst) {
        ilst += sz;
      } else {
        fail = ch.move(start, ilst, on_swap) == kRejected;
        __syncwarp();  // the move's write-back of S is visible to every lane
      }
    }
    ch.drain();
    ch.stop();
    if (lane == 0) {
      stat[0] = kbot;
      stat[1] = fail;
      stat[2] = (int)ch.steps;
    }
  }
  __syncthreads();
  for (int i = tid; i < WP; i += kThreads) Q[i] = spike[i];
}

}  // namespace

extern "C" int aed_deflate_gep(void* S, void* T, void* Q, void* Z, int WA, int w,
                               double s, double thresh, void* stat, void* stream) {
  static size_t configured = 0;
  const size_t bytes = smem_bytes(WA);
  if (bytes > configured) {
    cudaError_t e = cudaFuncSetAttribute(
        aed_deflate_gep_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
    if (e != cudaSuccess) return static_cast<int>(e);
    configured = bytes;
  }
  aed_deflate_gep_kernel<<<1, kThreads, bytes, static_cast<cudaStream_t>(stream)>>>(
      static_cast<double*>(S), static_cast<double*>(T), static_cast<double*>(Q),
      static_cast<double*>(Z), WA, w, s, thresh, static_cast<int*>(stat));
  return static_cast<int>(cudaGetLastError());
}
