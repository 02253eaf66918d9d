// B4: AED spike deflation with block moves, the whole test/move state
// machine in one thread block.
//
// Replaces starneig_tpu/ops/pallas_schur.py:_deflate_kernel/_deflate_body
// (pallas_call at :985, wrapper aed_deflate_pallas).  Plain twin:
// ops/schur.py:_aed_deflate, the JAX package's XLA _aed_deflate
// (schur.py:225-312).  A test step checks the bottom 1x1/2x2 block's spike
// entries s * V[0, .] against max(ulp |diag|, thresh): a negligible block
// deflates, any other block is moved toward the top by adjacent swaps
// (swap_adjacent: 4x4 Sylvester solve, Householder step, acceptance test).
// The step cap is 4 WA^2.  Returns (T, V, kbot, fail).
//
// What bounds it on the H100: latency.  Every step is a scalar decision
// followed, for a move, by a rank-4 similarity on 4 rows and 4 columns of
// the (WA+4)^2 window and 4 columns of V (~50 WA flops).  The window at
// WA = 322 is 0.86 MB and stays in global memory / L2.  Thread 0 runs the
// state machine and the 4x4 swap on registers; the block applies the
// 4-row and 4-column updates; two barriers per move step, one per test.
#include "common.cuh"

namespace {

constexpr int kThreads = 256;

__global__ void __launch_bounds__(kThreads)
aed_deflate_kernel(double* __restrict__ T, double* __restrict__ V, int WA,
                   int w, double s, double thresh, int* __restrict__ stat) {
  const int WP = WA + 4;  // T is WP x WP, V is WA x WP, row-major
  const int tid = threadIdx.x, nt = blockDim.x;
  const double ulp = DBL_EPSILON;
  const long long cap = 4LL * WA * WA;

  __shared__ int s_kbot, s_ilst, s_src, s_fail, s_a, s_q, s_accept;
  __shared__ long long s_steps;
  __shared__ double s_Q[16], s_Dh[16];

  if (tid == 0) {
    s_kbot = w;
    s_ilst = 0;
    s_src = -1;
    s_fail = 0;
    s_steps = 0;
  }
  __syncthreads();

  while (true) {
    const bool go = s_kbot > s_ilst && !s_fail && s_steps < cap;
    const bool test = s_src < 0;
    __syncthreads();  // every thread has read the state before it changes
    if (!go) break;
    if (test) {  // test the bottom block
      if (tid == 0) {
        const int kbot = s_kbot, e = kbot - 1;
        const int sz = (e >= 1 && T[e * WP + e - 1] != 0.0) ? 2 : 1;
        const int start = kbot - sz;
        double sp0 = s * V[start > 0 ? start : 0];
        double sp1 = s * V[kbot - 1 > 0 ? kbot - 1 : 0];
        double foot = dmax(fabs(sp0), fabs(sp1) * (sz == 2 ? 1.0 : 0.0));
        double tst = fabs(T[start * WP + start]) +
                     (sz == 2 ? fabs(T[(kbot - 1) * WP + kbot - 1]) : 0.0);
        bool deflatable = foot <= dmax(ulp * tst, thresh);
        int src = deflatable ? -1 : start;
        if (deflatable) s_kbot = start;
        if (!deflatable && start == s_ilst) {
          s_ilst += sz;
          src = -1;
        }
        s_src = src;
        s_steps += 1;
      }
      __syncthreads();
      continue;
    }
    // move the block starting at src one position up
    if (tid == 0) {
      const int src = s_src;
      const int e = src - 1;
      const int p = (e >= 1 && T[e * WP + e - 1] != 0.0) ? 2 : 1;
      const int a = src - p;
      const int q = (src + 1 < WA && T[(src + 1) * WP + src] != 0.0) ? 2 : 1;
      double D[16], Qs[16], Dh[16];
      for (int r = 0; r < 4; ++r)
        for (int c = 0; c < 4; ++c) D[r * 4 + c] = T[(a + r) * WP + a + c];
      bool accept = swap_adjacent(D, p, q, Qs, Dh);
      for (int i = 0; i < 16; ++i) { s_Q[i] = Qs[i]; s_Dh[i] = Dh[i]; }
      s_a = a;
      s_q = q;
      s_accept = accept;
    }
    __syncthreads();
    const int a = s_a;
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
    // columns a..a+3 <- cols Qs, full height; then V's columns
    for (int r = tid; r < WP + WA; r += nt) {
      double* row = r < WP ? T + r * WP + a : V + (r - WP) * WP + a;
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
      int src = s_accept ? a : -1;
      if (s_accept && src == s_ilst) {
        s_ilst += s_q;
        src = -1;
      }
      s_src = src;
      s_fail = s_fail || !s_accept;
      s_steps += 1;
    }
    __syncthreads();
  }
  if (tid == 0) {
    stat[0] = s_kbot;
    stat[1] = s_fail;
  }
}

}  // namespace

extern "C" int aed_deflate(void* T, void* V, int WA, int w, double s,
                           double thresh, void* stat, void* stream) {
  aed_deflate_kernel<<<1, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<double*>(T), static_cast<double*>(V), WA, w, s, thresh,
      static_cast<int*>(stat));
  return static_cast<int>(cudaGetLastError());
}
