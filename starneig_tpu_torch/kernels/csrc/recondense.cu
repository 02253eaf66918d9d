// B5: AED recondense -- the spike reflector, then the unblocked Householder
// re-reduction of the undeflated block T[:kbot, :kbot] to Hessenberg form,
// applied to T from both sides and to V; one thread block per window.
//
// Replaces starneig_tpu/ops/pallas_schur.py:_recondense_kernel/
// _recondense_body (pallas_call at :1208, wrapper aed_recondense_pallas).
// Plain twin: ops/schur.py:_aed_recondense, the JAX package's XLA
// _aed_recondense (schur.py:315-360), which the kernel matches step for
// step: a dlarfg of s * V[0, :kbot] applied to T[0:kbot, :], T[:, 0:kbot]
// and V[:, 0:kbot]; then for j < min(kbot - 1, WA - 2) a dlarfg of
// T[j+1:kbot, j] applied to rows and columns [j+1, kbot), with the exact
// plants T[j+1, j] = beta_j and T[j+2:kbot, j] = 0.  kbot == 0 gives beta 0
// and leaves T and V as they are.  Returns (T, V, beta) in place.
//
// What bounds it on the H100: L2 bandwidth and barriers of one SM.  At
// WA = 322 T and V are 0.83 MB each, beyond a block's 227 KB of shared
// memory, so they stay in global memory / L2; a step reads and writes
// about 3 (m (WA - j) + 2 WA m) doubles for a reflector of length m.  The
// reflector itself (length up to kbot) is a block reduction
// (block_householder in common.cuh, with the pre-scale by max|x| and the
// sdiv guards of ops/primitives.py:householder) on a shared copy of the
// column.  The left update runs one thread per column (coalesced along the
// rows); the right update one warp per row of T and V, reduced by shuffles.
// The left update of step j skips the columns left of j + 1: their rows
// [j+1, kbot) are the exact zeros planted by the earlier steps, so the
// plain version's update leaves them as they are.
#include "common.cuh"

namespace {

constexpr int kThreads = 512;

// T[lo:lo+m, c0:WA] -= tau v (v^T T[lo:lo+m, c0:WA]); then
// X[:, lo:lo+m] -= tau (X[:, lo:lo+m] v) v^T for X = T and X = V
__device__ void apply_both(double* __restrict__ T, double* __restrict__ V,
                           int WA, const double* __restrict__ v, double tau,
                           int lo, int m, int c0) {
  const int tid = threadIdx.x, nt = blockDim.x;
  for (int c = c0 + tid; c < WA; c += nt) {
    double* col = T + (size_t)lo * WA + c;
    double w = 0.0;
    for (int i = 0; i < m; ++i) w += v[i] * col[(size_t)i * WA];
    for (int i = 0; i < m; ++i) col[(size_t)i * WA] -= tau * (v[i] * w);
  }
  __syncthreads();
  const int lane = tid & 31, warp = tid >> 5, nw = nt >> 5;
  for (int r = warp; r < 2 * WA; r += nw) {
    double* row = (r < WA ? T + (size_t)r * WA : V + (size_t)(r - WA) * WA) + lo;
    double y = 0.0;
    for (int j = lane; j < m; j += 32) y += row[j] * v[j];
    for (int o = 16; o > 0; o >>= 1) y += __shfl_xor_sync(0xffffffffu, y, o);
    for (int j = lane; j < m; j += 32) row[j] -= tau * (y * v[j]);
  }
  __syncthreads();
}

__global__ void __launch_bounds__(kThreads)
recondense_kernel(double* __restrict__ T, double* __restrict__ V, int WA,
                  int kbot, double s, double* __restrict__ beta_out) {
  extern __shared__ double s_v[];  // the current reflector, WA doubles
  __shared__ double s_red[32];
  const int tid = threadIdx.x, nt = blockDim.x;
  if (kbot <= 0) {
    if (tid == 0) beta_out[0] = 0.0;
    return;
  }
  // spike reflector: s * V[0, :kbot] -> beta e1
  for (int i = tid; i < kbot; i += nt) s_v[i] = s * V[i];
  __syncthreads();
  double tau, beta;
  block_householder(s_v, kbot, s_red, tau, beta);
  if (tid == 0) beta_out[0] = beta;
  apply_both(T, V, WA, s_v, tau, 0, kbot, 0);

  const int steps = kbot - 1 < WA - 2 ? kbot - 1 : WA - 2;
  for (int j = 0; j < steps; ++j) {
    const int lo = j + 1, m = kbot - lo;
    for (int i = tid; i < m; i += nt) s_v[i] = T[(size_t)(lo + i) * WA + j];
    __syncthreads();
    double b;
    block_householder(s_v, m, s_red, tau, b);
    // tau == 0 (m == 1, or a zero tail): the plain update subtracts zeros
    if (tau != 0.0) apply_both(T, V, WA, s_v, tau, lo, m, lo);
    for (int i = tid; i < m; i += nt)
      T[(size_t)(lo + i) * WA + j] = i == 0 ? b : 0.0;
    __syncthreads();
  }
}

}  // namespace

extern "C" int recondense(void* T, void* V, int WA, int kbot, double s,
                          void* beta, void* stream) {
  if (WA < 1 || kbot < 0 || kbot > WA ||
      (size_t)WA * sizeof(double) > 48 * 1024)
    return static_cast<int>(cudaErrorInvalidValue);
  recondense_kernel<<<1, kThreads, WA * sizeof(double),
                      static_cast<cudaStream_t>(stream)>>>(
      static_cast<double*>(T), static_cast<double*>(V), WA, kbot, s,
      static_cast<double*>(beta));
  return static_cast<int>(cudaGetLastError());
}
