// B5: AED recondense -- the spike reflector, then the unblocked Householder
// re-reduction of the undeflated block T[:kbot, :kbot] to Hessenberg form,
// applied to T from both sides and to V; one thread-block cluster per
// window.
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
// What bounds it on the H100: a step reads and writes about m (WA - j) +
// 2 WA m doubles for a reflector of length m (0.6 GB in all at WA = 322,
// kbot = 300), and its reflector needs the previous step's updates.  The
// version before this one ran on one block: T and V in global memory /
// L2, at one SM's share of L2 bandwidth (~127 GB/s), so no one-block
// design gets under ~5 ms there, and four or more block barriers a step.
//
// Design.  A cluster of 16 blocks (a non-portable size: the launch fails
// where cudaOccupancyMaxActiveClusters schedules no such cluster), each
// owning a slab of rs = ceil(WA / 16) rows of T and of V: in its shared
// memory where both slabs fit (16 WA rs bytes; WA = 322), else in place in
// global memory, touched by the owner alone (WA = 802, the n=10,000
// geometry).  Per step:
//   * the owners of the column's rows [lo, kbot) have published them in
//     their shared memory; every block gathers them through distributed
//     shared memory and computes the same dlarfg from the same bits
//     (block_householder in common.cuh: the pre-scale by max|x| and the
//     sdiv guards of ops/primitives.py:householder);
//   * each block forms the partial v^T T over its own rows and publishes
//     it; after a cluster barrier the owners of rows in [lo, kbot) sum the
//     partials in block order (the same sum in every block) and apply the
//     rank-1 update to their rows;
//   * the right update (T v and V v, a warp a row) is local to the row's
//     owner; so are the plants and the publication of the next column;
//     then a second cluster barrier.
// Two cluster barriers a step; the published column and partials alternate
// between two buffers, so no block overwrites what another still reads.
// The left update of step j skips the columns left of j + 1: their rows
// [j+1, kbot) are the exact zeros planted by the earlier steps.  The right
// update of T skips the rows from kbot on: zeros in those columns (the
// deflated block below the undeflated one).  WA <= 5,785 (five WA-long
// buffers in shared memory).
#include <cooperative_groups.h>

#include "common.cuh"

namespace cg = cooperative_groups;

namespace {

constexpr int kThreads = 512;
constexpr int kCluster = 16;         // blocks of the cluster (a non-portable size)
constexpr size_t kSmemMax = 231424;   // dynamic shared memory: 226 of the 227 KB

__global__ void __launch_bounds__(kThreads, 1)
recondense_kernel(double* __restrict__ T, double* __restrict__ V, int WA,
                  int kbot, double s, double* __restrict__ beta_out, int rs,
                  int slab_smem) {
  extern __shared__ __align__(16) double smem[];
  __shared__ double s_red[32];
  cg::cluster_group cluster = cg::this_cluster();
  const int q = (int)cluster.block_rank();
  const int tid = threadIdx.x, nt = blockDim.x;
  const int lane = tid & 31, warp = tid >> 5, nw = nt >> 5;
  const int r_lo = q * rs < WA ? q * rs : WA;
  const int r_hi = r_lo + rs < WA ? r_lo + rs : WA;

  double* s_v = smem;                 // the reflector, WA
  double* xb = s_v + WA;              // 2 x WA: the published column, by row
  double* pb = xb + 2 * WA;           // 2 x WA: the partial v^T T, by column
  double* sT = pb + 2 * WA;           // rs x WA each, when slab_smem
  double* sV = sT + (size_t)rs * WA;
  // row r (r_lo <= r < r_hi) of T and of V where this block keeps it
  auto rowT = [&](int r) { return slab_smem ? sT + (size_t)(r - r_lo) * WA : T + (size_t)r * WA; };
  auto rowV = [&](int r) { return slab_smem ? sV + (size_t)(r - r_lo) * WA : V + (size_t)r * WA; };

  if (kbot <= 0) {
    if (q == 0 && tid == 0) beta_out[0] = 0.0;
    return;
  }
  if (slab_smem)
    for (size_t e = tid; e < (size_t)(r_hi - r_lo) * WA; e += nt) {
      sT[e] = T[(size_t)r_lo * WA + e];
      sV[e] = V[(size_t)r_lo * WA + e];
    }
  // the spike: s * V[0, :kbot], published by row 0's owner
  if (q == 0)
    for (int i = tid; i < kbot; i += nt) xb[i] = s * rowV(0)[i];
  cluster.sync();

  const int steps = kbot - 1 < WA - 2 ? kbot - 1 : WA - 2;
  for (int j = -1; j < steps; ++j) {   // j = -1: the spike reflector
    const int par = (j + 1) & 1;
    const int lo = j + 1, m = kbot - lo;
    double* x_pub = xb + par * WA;
    double* p_pub = pb + par * WA;
    // gather the column (the spike: row 0 of V) from its owners
    for (int i = tid; i < m; i += nt) {
      const int owner = j < 0 ? 0 : (lo + i) / rs;
      s_v[i] = cluster.map_shared_rank(x_pub, owner)[j < 0 ? i : lo + i];
    }
    __syncthreads();
    double tau, beta;
    block_householder(s_v, m, s_red, tau, beta);
    if (j < 0 && q == 0 && tid == 0) beta_out[0] = beta;
    const int a = r_lo > lo ? r_lo : lo, b = r_hi < kbot ? r_hi : kbot;  // own rows in [lo, kbot)
    if (tau != 0.0) {     // the same in every block: the plain update subtracts zeros
      for (int c = lo + tid; c < WA; c += nt) {
        double w = 0.0;
        for (int r = a; r < b; ++r) w += s_v[r - lo] * rowT(r)[c];
        p_pub[c] = w;
      }
      cluster.sync();
      if (a < b) {
        const int p0 = lo / rs, p1 = (kbot - 1) / rs;
        for (int c = lo + tid; c < WA; c += nt) {
          double w = 0.0;
          for (int p = p0; p <= p1; ++p) w += cluster.map_shared_rank(p_pub, p)[c];
          for (int r = a; r < b; ++r) rowT(r)[c] -= tau * (s_v[r - lo] * w);
        }
      }
      __syncthreads();
      // right update: X[r, lo:kbot] -= tau (X[r, lo:kbot] v) v^T, a warp a row,
      // T's own rows below kbot, then V's own rows
      const int nT = (r_hi < kbot ? r_hi : kbot) - r_lo;
      const int nrows = (nT > 0 ? nT : 0) + (r_hi - r_lo);
      for (int k = warp; k < nrows; k += nw) {
        double* row = (k < nT ? rowT(r_lo + k) : rowV(r_lo + k - (nT > 0 ? nT : 0))) + lo;
        double y = 0.0;
        for (int i = lane; i < m; i += 32) y += row[i] * s_v[i];
        for (int o = 16; o > 0; o >>= 1) y += __shfl_xor_sync(0xffffffffu, y, o);
        for (int i = lane; i < m; i += 32) row[i] -= tau * (y * s_v[i]);
      }
    }
    // the plants of column j, then publish column j + 1's rows [j + 2, kbot)
    if (j >= 0)
      for (int r = a + tid; r < b; r += nt) rowT(r)[j] = r == lo ? beta : 0.0;
    __syncthreads();
    if (j + 1 < steps)
      for (int r = (a > j + 2 ? a : j + 2) + tid; r < b; r += nt)
        xb[(par ^ 1) * WA + r] = rowT(r)[j + 1];
    cluster.sync();
  }
  if (slab_smem) {
    for (size_t e = tid; e < (size_t)(r_hi - r_lo) * WA; e += nt) {
      T[(size_t)r_lo * WA + e] = sT[e];
      V[(size_t)r_lo * WA + e] = sV[e];
    }
  }
}

size_t smem_bytes(int WA, int rs, bool slab) {
  return sizeof(double) * (5 * (size_t)WA + (slab ? 2 * (size_t)rs * WA : 0));
}

}  // namespace

extern "C" int recondense(void* T, void* V, int WA, int kbot, double s,
                          void* beta, void* stream) {
  if (WA < 1 || kbot < 0 || kbot > WA || smem_bytes(WA, 0, false) > kSmemMax)
    return static_cast<int>(cudaErrorInvalidValue);
  static bool attr_set = false;
  if (!attr_set) {
    cudaError_t e = cudaFuncSetAttribute(
        recondense_kernel, cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
    if (e == cudaSuccess)
      e = cudaFuncSetAttribute(recondense_kernel,
                               cudaFuncAttributeMaxDynamicSharedMemorySize, (int)kSmemMax);
    if (e != cudaSuccess) return static_cast<int>(e);
    attr_set = true;
  }
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = kCluster;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(kCluster);
  cfg.blockDim = dim3(kThreads);
  cfg.stream = static_cast<cudaStream_t>(stream);
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  const int rs = (WA + kCluster - 1) / kCluster;
  const bool slab = smem_bytes(WA, rs, true) <= kSmemMax;
  cfg.dynamicSmemBytes = smem_bytes(WA, rs, slab);
  int clusters = 0;
  const cudaError_t e = cudaOccupancyMaxActiveClusters(&clusters, recondense_kernel, &cfg);
  if (e != cudaSuccess) return static_cast<int>(e);
  if (clusters < 1) return static_cast<int>(cudaErrorInvalidConfiguration);
  cudaLaunchKernelEx(&cfg, recondense_kernel, static_cast<double*>(T),
                     static_cast<double*>(V), WA, kbot, s,
                     static_cast<double*>(beta), rs, slab ? 1 : 0);
  return static_cast<int>(cudaGetLastError());
}
