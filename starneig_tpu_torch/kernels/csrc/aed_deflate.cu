// B4: AED spike deflation with block moves, the whole test/move state
// machine in one thread block, on the swap-chain engine (swap_chain.cuh).
//
// Replaces starneig_tpu/ops/pallas_schur.py:_deflate_kernel/_deflate_body
// (pallas_call at :985, wrapper aed_deflate_pallas).  Plain twin:
// ops/schur.py:_aed_deflate, the JAX package's XLA _aed_deflate
// (schur.py:225-312).  A test step checks the bottom 1x1/2x2 block's spike
// entries s * V[0, .] against max(ulp |diag|, thresh): a negligible block
// deflates, any other block is moved toward the top by adjacent swaps
// (swap_adjacent_warp: 4x4 Sylvester solve, Householder step, acceptance
// test).  The step cap is 4 WA^2.  Returns (T, V, kbot, fail).
//
// What bounds it on the H100: the serial swap chain (latency).  A move of a
// block is a chain of swaps, each a scalar decision on a 4x4 that the
// previous swap produced; the rank-4 similarity around it (4 rows and 4
// columns of the (WA+4)^2 window, 4 columns of V, ~50 WA flops) is
// parallel.  The window at WA = 322 is 0.86 MB and stays in global memory
// / L2.  The chain warp runs the test steps and the moves' segments in
// shared memory, reading T's diagonal, its subdiagonal and the spike (V's
// row 0, updated swap by swap in the chain warp) from shared memory; the
// update warps apply each segment's accumulated transform to the rest of T
// and to V's rows 1.. (the engine's notes in swap_chain.cuh).
#include "swap_chain.cuh"

namespace {

using namespace swap_chain;

__global__ void __launch_bounds__(kThreads)
aed_deflate_kernel(double* __restrict__ T, double* __restrict__ V, int WA,
                   int w, double s, double thresh, int* __restrict__ stat) {
  extern __shared__ __align__(16) double smem[];
  __shared__ Meta meta;
  const int WP = WA + 4;  // T is WP x WP, V is WA x WP, row-major
  const int tid = threadIdx.x;
  const Smem sm = carve(smem, WA);
  double* spike = sm.extra;  // V's row 0

  for (int i = tid; i < WP; i += kThreads) {
    sm.diag[i] = T[(size_t)i * WP + i];
    sm.sub[i] = i + 1 < WP ? T[(size_t)(i + 1) * WP + i] : 0.0;
    spike[i] = V[i];
  }
  __syncthreads();

  if (tid >= 32) {
    update_warps(T, WP, V, 1, WA, sm, meta);
  } else {
    const int lane = tid;
    const double ulp = DBL_EPSILON;
    Chain ch{T, WP, WA, sm, &meta};
    ch.cap = 4LL * WA * WA;
    int kbot = w, ilst = 0;
    bool fail = false;
    // V's row 0 takes each swap in the chain warp, in the plain twin's order
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
      const double tst = fabs(sm.diag[start]) +
                         (sz == 2 ? fabs(sm.diag[kbot - 1]) : 0.0);
      ch.steps += 1;
      if (foot <= dmax(ulp * tst, thresh)) {
        kbot = start;
      } else if (start == ilst) {
        ilst += sz;
      } else {
        fail = ch.move(start, ilst, on_swap) == kRejected;
      }
    }
    ch.drain();
    ch.stop();
    if (lane == 0) {
      stat[0] = kbot;
      stat[1] = fail;
    }
  }
  __syncthreads();
  for (int i = tid; i < WP; i += kThreads) V[i] = spike[i];
}

}  // namespace

extern "C" int aed_deflate(void* T, void* V, int WA, int w, double s,
                           double thresh, void* stat, void* stream) {
  static size_t configured = 0;
  const size_t bytes = smem_bytes(WA);
  if (bytes > configured) {
    cudaError_t e = cudaFuncSetAttribute(
        aed_deflate_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
    if (e != cudaSuccess) return static_cast<int>(e);
    configured = bytes;
  }
  aed_deflate_kernel<<<1, kThreads, bytes, static_cast<cudaStream_t>(stream)>>>(
      static_cast<double*>(T), static_cast<double*>(V), WA, w, s, thresh,
      static_cast<int*>(stat));
  return static_cast<int>(cudaGetLastError());
}
