// B3: one hop (HOP = 3B chase steps) of G staggered B-bulge trains, one
// thread block per train.
//
// Replaces starneig_tpu/ops/pallas_schur.py:_train_hops_kernel/
// _train_hops_body (pallas_call at :732, wrapper train_hops_pallas).  Plain
// twin: ops/schur.py:_train_hop, which matches the JAX package's XLA
// _train_hop step for step (no vigilant deflation).  Each step: bulge
// introduction from the shifts or a gather of the chase column, B
// 3-element reflectors, the left update on the 3B-row train block, the
// exact plant of each chase column, the right update on the window's
// columns, and the accumulation of the window transform Qw (initialized to
// the identity here).
//
// What bounds it on the H100: latency.  A step is ~12 B WC flops spread
// over the block, then a barrier; the window and Qw are (WC, WC) fp64 each
// (190 KB at WC = 154), so the two do not fit one block's shared memory
// and stay in global memory, resident in L2.  Within a step the B
// reflectors act on disjoint row triples and column triples, so the block
// splits its threads over (bulge, column) pairs.  Four barriers per step.
//
// Index semantics follow the JAX version: row/column starts of the train
// block are clamped into the window as lax.dynamic_slice clamps them, and
// the chase-column plant is written only for bulges that are active and
// past their introduction (the only writes of the JAX scatter that change
// a value).  Parked trains (l_rel = 1, ihi_rel = 0) are exact no-ops.
#include "common.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kMaxG = 32;
constexpr int kMaxB = 64;

struct HopParams {
  int G, B, WC, HOP;
  int gidx[kMaxG], l_rel[kMaxG], ihi_rel[kMaxG], s0[kMaxG];
};

__global__ void __launch_bounds__(kThreads)
train_hops_kernel(double* __restrict__ wnds, double* __restrict__ qws,
                  const double* __restrict__ shifts, HopParams prm) {
  const int g = blockIdx.x;
  const int B = prm.B, WC = prm.WC, HOP = prm.HOP;
  const int l_rel = prm.l_rel[g], ihi_rel = prm.ihi_rel[g], s0 = prm.s0[g];
  double* W = wnds + (size_t)g * WC * WC;
  double* Q = qws + (size_t)g * WC * WC;
  const double* sh = shifts + (size_t)prm.gidx[g] * B * 4;
  const int tid = threadIdx.x, nt = blockDim.x;

  __shared__ double s_v[kMaxB][3], s_tau[kMaxB], s_beta[kMaxB];
  __shared__ int s_kc[kMaxB], s_fix[kMaxB], s_use3[kMaxB];

  for (int e = tid; e < WC * WC; e += nt) Q[e] = (e % (WC + 1) == 0) ? 1.0 : 0.0;

  for (int t = 0; t < HOP; ++t) {
    const int s = s0 + t;
    __syncthreads();
    // reflectors: every bulge reads the window, none writes it
    for (int b = tid; b < B; b += nt) {
      const int k = l_rel + s - 3 * b;
      const bool active = k >= l_rel && k <= ihi_rel - 2;
      const int kc = active ? k : 1;
      const bool intro = active && k == l_rel;
      const bool use3 = k <= ihi_rel - 3;
      double x[3];
      if (intro) {
        const int lr = clampi(l_rel, 0, WC - 3);
        double h3[9];
        for (int r = 0; r < 3; ++r)
          for (int c = 0; c < 3; ++c) h3[r * 3 + c] = W[(lr + r) * WC + lr + c];
        first_column_shifted(h3, sh[b * 4 + 0], sh[b * 4 + 1], sh[b * 4 + 2],
                             sh[b * 4 + 3], use3, x);
      } else {
        const int r0 = clampi(kc, 0, WC - 3);
        const int c0 = clampi(kc - 1 > 0 ? kc - 1 : 0, 0, WC - 1);
        for (int r = 0; r < 3; ++r) x[r] = W[(r0 + r) * WC + c0];
      }
      double v[3], tau, beta;
      householder(x, use3 ? 7u : 3u, 3, v, tau, beta);
      s_v[b][0] = v[0]; s_v[b][1] = v[1]; s_v[b][2] = v[2];
      s_tau[b] = active ? tau : 0.0;
      s_beta[b] = beta;
      s_kc[b] = kc;
      s_fix[b] = active && !intro;
      s_use3[b] = use3;
    }
    __syncthreads();
    const int lo = l_rel + s - 3 * (B - 1);
    const int loc = clampi(lo, 0, WC - 3 * B);
    // left update: row triple j of the train block belongs to bulge B-1-j
    for (int e = tid; e < B * WC; e += nt) {
      const int j = e / WC, c = e % WC, b = B - 1 - j;
      const double v0 = s_v[b][0], v1 = s_v[b][1], v2 = s_v[b][2], tau = s_tau[b];
      double* p = W + (loc + 3 * j) * WC + c;
      double r0 = p[0], r1 = p[WC], r2 = p[2 * WC];
      double sum = v0 * r0 + v1 * r1 + v2 * r2;
      p[0] = r0 - (tau * v0) * sum;
      p[WC] = r1 - (tau * v1) * sum;
      p[2 * WC] = r2 - (tau * v2) * sum;
    }
    __syncthreads();
    // exact chase-column plants
    for (int b = tid; b < B; b += nt) {
      if (!s_fix[b]) continue;
      const int kc = s_kc[b];
      W[kc * WC + kc - 1] = s_beta[b];
      W[(kc + 1) * WC + kc - 1] = 0.0;
      if (s_use3[b]) W[(kc + 2) * WC + kc - 1] = 0.0;
    }
    __syncthreads();
    // right update of the train's columns at full height, and Qw
    for (int e = tid; e < 2 * WC * B; e += nt) {
      const int half = e / (WC * B), rem = e % (WC * B);
      const int r = rem / B, j = rem % B, b = B - 1 - j;
      const double v0 = s_v[b][0], v1 = s_v[b][1], v2 = s_v[b][2], tau = s_tau[b];
      double* p = (half == 0 ? W : Q) + r * WC + loc + 3 * j;
      double sum = p[0] * v0 + p[1] * v1 + p[2] * v2;
      double ts = tau * sum;
      p[0] -= ts * v0;
      p[1] -= ts * v1;
      p[2] -= ts * v2;
    }
  }
}

}  // namespace

extern "C" int train_hops(void* wnds, void* qws, const void* shifts, int G,
                          int B, int WC, int HOP, const int* gidx,
                          const int* l_rel, const int* ihi_rel, const int* s0,
                          void* stream) {
  if (G < 1 || G > kMaxG || B < 1 || B > kMaxB || WC < 3 * B)
    return static_cast<int>(cudaErrorInvalidValue);
  HopParams prm;
  prm.G = G; prm.B = B; prm.WC = WC; prm.HOP = HOP;
  for (int g = 0; g < G; ++g) {
    prm.gidx[g] = gidx[g];
    prm.l_rel[g] = l_rel[g];
    prm.ihi_rel[g] = ihi_rel[g];
    prm.s0[g] = s0[g];
  }
  train_hops_kernel<<<G, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<double*>(wnds), static_cast<double*>(qws),
      static_cast<const double*>(shifts), prm);
  return static_cast<int>(cudaGetLastError());
}
