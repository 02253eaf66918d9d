// H1: the Hessenberg panel, one cooperative launch a panel.
//
// Replaces the JAX package's panel loop, starneig_tpu/ops/hessenberg.py:_panel
// (a jitted lax.fori_loop a panel: :158 with B1 inside, :163 plain), which
// the TPU ran as one device program.  Plain twin:
// ops/hessenberg.py:panel_factor, a host loop of ~55 launches a column.
// Computes (V, T, Y, P) of columns k..k+nb-1 of the frozen panel-start
// matrix A as panel_factor does: V (n x nb) the reflectors (v_j on rows >
// k+j, v[k+j+1] = 1), T (nb x nb) the upper triangular compact-WY factor,
// Y = A V T on rows >= t0, P the final panel columns (exact zeros below
// the subdiagonal); a column c >= lim - 1 is not reduced (tau = 0, v = 0,
// P = the corrected column).
//
// What bounds it on the H100: the panel matvec u = A[t0:, t0:] v streams
// the trailing rows of A from HBM once a column (128 MB, 38 us, at n =
// 4000 and t0 = 0), and each column is a chain of card-wide dependencies:
// the corrected column needs V^T a over all rows, the reflector the norm
// of the whole column, the matvec the whole reflector.  The host loop paid
// ~55 launches a column for that chain.
// Design: one cooperative launch (the grid from the occupancy and the SM
// count, one block an SM: every block resident, so grid.sync() is a
// barrier of the card) runs the column loop.  Block b owns a fixed slab of
// rows [t0 + b rpb, t0 + (b + 1) rpb) in every phase, so what a block
// writes for its rows (a, v, Y, Z, V's rows) only it reads back; the
// products that mix rows go through per-block partial sums in global
// memory, which every block adds up in block order after a barrier.  Three
// barriers a column:
//   (a) a = A[:, c] - Y[:, :j] V[c, :j] on the slab; the partial V^T a;
//   --- sync 1
//   (b) w1 = the partials' sum; a -= V T^T w1 as a -= Z w1, Z = V T^T
//       kept on the slab's rows (a rank-1 update by T's newest column a
//       column), so no block reads all of T; the slab's max |x| and sum
//       of (x / max)^2 (x = a[c+1:]), and x[0] from its owner;
//   --- sync 2
//   (c) dlarfg's scalars from the blocks' (max, sum) pairs, each sum
//       rescaled to the largest max (one barrier for both); v, V[:, j],
//       P[:, j] on the slab; the partial V^T v;
//   --- sync 3
//   (d) q = V^T v; T[:j, j] = -tau T q, its rows dealt out over the
//       blocks (a row i to block i mod grid); u[r] = A[r, c':] v[c':] on
//       the slab, a warp a row in B1's wide-row form (hess_gemv.cuh), c' =
//       c + 1 rounded down to even (v is zero above c + 1, so a column
//       reads (n - t0)(n - c') doubles, not (n - t0)^2); Y[r, j] =
//       U[r, :j+1] T[:j+1, j] as tau (u[r] - Y[r, :j] q), which needs no
//       T and no U (Y[:, :j] = U[:, :j] T[:j, :j]).  (A first form had
//       every block form T^T w1 and T's column from all of T in L2, a
//       latency-bound j^2 / 2 reads twice a column: 25.4 ms against 20.8
//       for n = 4000's first panel, PERF.md.)
//   Column j + 1's (a) reads the slab's own Y and V[c + 1, :], which sync
//   3 published, and its (b) T's column j, which sync 1 publishes, so no
//   barrier follows (d).
// Every sum runs in an order fixed by the shape and the grid, so two
// launches on one card give the same bits.  What one block writes and
// another reads (V[c, :], T, the partials, x[0], v) is read through L2
// (__ldcg), after a barrier: L1 is not coherent across SMs.  Shared memory
// holds the slab's a and v and three vectors of length nb, never T (1.7 MB
// at nb = 464); Z (n x nb) is scratch in global memory.
#include <cooperative_groups.h>
#include <cuda_runtime.h>

#include "common.cuh"
#include "hess_gemv.cuh"

namespace cg = cooperative_groups;

namespace {

constexpr int kThreads = 512;
constexpr int kWarps = kThreads / 32;
constexpr int kChunk = 256;        // columns a pass of col_sum
constexpr int kQ = kChunk / 32;    //   a lane's columns in a pass
constexpr int kBlocksPerSM = 1;    // each block reduces every partial: one an SM
constexpr unsigned kFull = 0xffffffffu;

struct Panel {
  const double* A;
  long long lda;
  int n, k, nb, t0, lim, rpb;
  double *V, *T, *Y, *P;      // n x nb (T nb x nb), row-major, zeroed by the caller
  double* Z;                   // n x nb: V T^T on the slabs' rows
  double* v;                   // n: the column's reflector, for the matvec
  double* part_w;              // grid x nb: the slabs' partial V^T a
  double* part_v;              // grid x nb: the slabs' partial V^T v
  double* part_n;              // grid x 2: the slabs' max |x| and sum of (x / max)^2
  double* alpha;               // x[0] = a[c + 1]
};

size_t smem_bytes(int nb, int rpb) {
  return sizeof(double) *
         (2 * (size_t)rpb + 3 * (size_t)nb + (size_t)kWarps * kChunk + 2 * kWarps + 8);
}

template <bool kL2>
__device__ __forceinline__ double ld(const double* p) {
  return kL2 ? __ldcg(p) : *p;
}

// out[i] = sum over l < L of M[l ld + i] x[l] (x == nullptr: x[l] = 1), for
// i < J.  Warp w sums its contiguous share of l in order, lanes across i;
// then thread i adds the warps' sums in warp order.  out is shared or
// global memory.  Every thread of the block calls it.
template <bool kL2>
__device__ void col_sum(const double* M, int ld_m, int L, int J, const double* x, double* out,
                        double* red) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int per = (L + kWarps - 1) / kWarps;
  const int l0 = min(L, warp * per), l1 = min(L, l0 + per);
  for (int i0 = 0; i0 < J; i0 += kChunk) {
    double acc[kQ];
#pragma unroll
    for (int q = 0; q < kQ; ++q) acc[q] = 0.0;
#pragma unroll 4
    for (int l = l0; l < l1; ++l) {
      const double xl = x ? x[l] : 1.0;
      const double* row = M + (size_t)l * ld_m + i0 + lane;
#pragma unroll
      for (int q = 0; q < kQ; ++q) {
        const int i = i0 + lane + 32 * q;
        if (i < J) acc[q] += ld<kL2>(row + 32 * q) * xl;
      }
    }
#pragma unroll
    for (int q = 0; q < kQ; ++q) red[warp * kChunk + lane + 32 * q] = acc[q];
    __syncthreads();
    for (int ii = threadIdx.x; ii < kChunk && i0 + ii < J; ii += blockDim.x) {
      double s = red[ii];
      for (int w = 1; w < kWarps; ++w) s += red[w * kChunk + ii];
      out[i0 + ii] = s;
    }
    __syncthreads();
  }
}

// sum over l < L of m[l] xs[l] (xs in shared memory), in every lane of the
// calling warp
template <bool kL2>
__device__ __forceinline__ double warp_dot(const double* m, const double* xs, int L, int lane) {
  double acc = 0.0;
  for (int l = lane; l < L; l += 32) acc += ld<kL2>(m + l) * xs[l];
  for (int off = 16; off > 0; off >>= 1) acc += __shfl_xor_sync(kFull, acc, off);
  return acc;
}

template <bool kVec>
__global__ void __launch_bounds__(kThreads, kBlocksPerSM) hess_panel_kernel(Panel p) {
  cg::grid_group grid = cg::this_grid();
  extern __shared__ double sm[];
  const int n = p.n, nb = p.nb, k = p.k;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int b = blockIdx.x, nblk = gridDim.x;
  const int r0 = min(n, p.t0 + b * p.rpb), r1 = min(n, r0 + p.rpb), nr = r1 - r0;
  double* a_s = sm;                      // rpb: the slab's corrected column
  double* v_s = a_s + p.rpb;             // rpb: the slab's reflector entries
  double* vc_s = v_s + p.rpb;            // nb: V[c, :j]
  double* w_s = vc_s + nb;               // nb: w1 = V^T a, then q = V^T v
  double* t_s = w_s + nb;                // nb: T[:j, j - 1]
  double* red = t_s + nb;                // kWarps x kChunk
  double* bred = red + kWarps * kChunk;  // 2 kWarps: block reductions
  double* sc = bred + 2 * kWarps;        // the column's scalars

  // rows above t0 take no part in the loop: P = the panel's columns there
  // (_apply_panel rebuilds them); Y and V stay zero
  for (long long idx = (long long)b * kThreads + tid; idx < (long long)p.t0 * nb;
       idx += (long long)nblk * kThreads) {
    const long long r = idx / nb, j = idx % nb;
    p.P[idx] = p.A[r * p.lda + k + j];
  }
  for (int i = tid; i < nr * nb; i += kThreads) p.Z[(size_t)r0 * nb + i] = 0.0;
  const int z0 = clampi(k + 1 - r0, 0, nr);  // the slab's first row where V, Z may be nonzero

  for (int j = 0; j < nb; ++j) {
    const int c = k + j;
    const bool active = c < p.lim - 1 && c < n - 1;
    // (a) the column corrected by the panel's earlier reflectors
    for (int i = tid; i < j; i += kThreads) vc_s[i] = __ldcg(p.V + (size_t)c * nb + i);
    __syncthreads();
    for (int rr = warp; rr < nr; rr += kWarps) {
      const int r = r0 + rr;
      const double d = warp_dot<false>(p.Y + (size_t)r * nb, vc_s, j, lane);
      if (lane == 0) a_s[rr] = p.A[(size_t)r * p.lda + c] - d;
    }
    __syncthreads();
    col_sum<false>(p.V + (size_t)(r0 + z0) * nb, nb, nr - z0, j, a_s + z0,
                   p.part_w + (size_t)b * nb, red);  // the slab's partial V^T a
    grid.sync();

    // (b) w1; Z[:, :j] += V[:, j-1] T[:j, j-1]^T, a -= Z w1; the slab's
    // share of the column norm
    if (j > 0) {
      for (int i = tid; i < j; i += kThreads) t_s[i] = __ldcg(p.T + (size_t)i * nb + j - 1);
      __syncthreads();
      for (int idx = tid; idx < (nr - z0) * j; idx += kThreads) {
        const size_t r = r0 + z0 + idx / j;
        const int l = idx % j;
        p.Z[r * nb + l] += p.V[r * nb + j - 1] * t_s[l];
      }
    }
    col_sum<true>(p.part_w, nb, nblk, j, nullptr, w_s, red);
    for (int rr = z0 + warp; rr < nr; rr += kWarps) {
      const double d = warp_dot<false>(p.Z + (size_t)(r0 + rr) * nb, w_s, j, lane);
      if (lane == 0) a_s[rr] -= d;
    }
    __syncthreads();
    double mx = 0.0;
    for (int rr = tid; rr < nr; rr += kThreads)
      if (r0 + rr > c) mx = dmax(mx, fabs(a_s[rr]));
    mx = block_reduce(mx, bred, true);
    const double mslab = mx == 0.0 ? 1.0 : mx;
    double ss = 0.0;
    for (int rr = tid; rr < nr; rr += kThreads)
      if (r0 + rr > c + 1) {
        const double xs = a_s[rr] / mslab;
        ss += xs * xs;
      }
    ss = block_reduce(ss, bred + kWarps, false);
    if (tid == 0) {
      p.part_n[2 * b] = mx;
      p.part_n[2 * b + 1] = ss;
      if (c + 1 >= r0 && c + 1 < r1) *p.alpha = a_s[c + 1 - r0];
    }
    grid.sync();

    // (c) the reflector: dlarfg pre-scaled by max |x| (primitives.householder)
    if (warp == 0) {
      double m = 0.0;
      for (int q = lane; q < nblk; q += 32) m = dmax(m, __ldcg(p.part_n + 2 * q));
      for (int off = 16; off > 0; off >>= 1) m = dmax(m, __shfl_xor_sync(kFull, m, off));
      const double msafe = m == 0.0 ? 1.0 : m;
      double s = 0.0;
      for (int q = lane; q < nblk; q += 32) {
        const double rq = __ldcg(p.part_n + 2 * q) / msafe;
        s += __ldcg(p.part_n + 2 * q + 1) * rq * rq;
      }
      for (int off = 16; off > 0; off >>= 1) s += __shfl_xor_sync(kFull, s, off);
      if (lane == 0) {
        const double alpha = (active ? __ldcg(p.alpha) : 0.0) / msafe;
        const double xnorm = sqrt(s);
        const double bt = -sgn(alpha) * hypot2(alpha, xnorm);
        const bool degen = xnorm == 0.0;
        sc[0] = active && !degen ? sdiv(bt - alpha, bt) : 0.0;  // tau
        sc[1] = sdiv(1.0, alpha - bt);                          // v's scale
        sc[2] = (degen ? alpha : bt) * msafe;                   // beta
        sc[3] = msafe;
        sc[4] = degen ? 1.0 : 0.0;
      }
    }
    __syncthreads();
    const double tau = sc[0];
    {
      const double scale = sc[1], beta = sc[2], msafe = sc[3];
      const bool degen = sc[4] != 0.0;
      for (int rr = tid; rr < nr; rr += kThreads) {
        const int r = r0 + rr;
        const double a = a_s[rr];
        double v = 0.0, pc = a;  // outside [begin, end): the corrected column
        if (active) {
          v = r <= c ? 0.0 : (r == c + 1 ? 1.0 : (degen ? 0.0 : (a / msafe) * scale));
          pc = r <= c ? a : (r == c + 1 ? beta : 0.0);
        }
        v_s[rr] = v;
        p.v[r] = v;
        p.V[(size_t)r * nb + j] = v;
        p.P[(size_t)r * nb + j] = pc;
      }
    }
    __syncthreads();
    {  // the slab's partial V^T v (v is zero on rows <= c)
      const int s0 = clampi(c + 1 - r0, 0, nr);
      col_sum<false>(p.V + (size_t)(r0 + s0) * nb, nb, nr - s0, j, v_s + s0,
                     p.part_v + (size_t)b * nb, red);
    }
    grid.sync();

    // (d) q = V^T v; this block's rows of T[:, j]; the panel matvec and
    // Y[:, j] on the slab
    col_sum<true>(p.part_v, nb, nblk, j, nullptr, w_s, red);
    for (int i = b + warp * nblk; i < j; i += kWarps * nblk) {
      const double d = warp_dot<true>(p.T + (size_t)i * nb + i, w_s + i, j - i, lane);
      if (lane == 0) p.T[(size_t)i * nb + j] = -tau * d;
    }
    if (b == 0 && tid == 0) p.T[(size_t)j * nb + j] = tau;
    const int cs = (c + 1) & ~1;
    for (int rr = warp; rr < nr; rr += kWarps) {
      const int r = r0 + rr;
      const double u = active ? gemv_row::warp_row_dot<kVec, true>(
                                    p.A + (size_t)r * p.lda + cs, p.v + cs, n - cs, lane)
                              : 0.0;
      const double y = warp_dot<false>(p.Y + (size_t)r * nb, w_s, j, lane);
      if (lane == 0) p.Y[(size_t)r * nb + j] = tau * (u - y);
    }
    __syncthreads();
  }
}

template <bool kVec>
cudaError_t occupancy(int rpb, int nb, int* blocks) {
  const size_t smem = smem_bytes(nb, rpb);
  cudaError_t e = cudaFuncSetAttribute(hess_panel_kernel<kVec>,
                                       cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e != cudaSuccess) return e;
  return cudaOccupancyMaxActiveBlocksPerMultiprocessor(blocks, hess_panel_kernel<kVec>,
                                                       kThreads, smem);
}

// the grid of a panel with n - t0 trailing rows: the SM count times the
// blocks an SM holds, at most kBlocksPerSM (sized for that grid's slabs)
cudaError_t auto_grid(int rows, int nb, int* grid) {
  int dev = 0, sms = 0, occ = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e == cudaSuccess) e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (e != cudaSuccess) return e;
  const int g = sms * kBlocksPerSM;
  e = occupancy<true>((rows + g - 1) / g, nb, &occ);
  if (e != cudaSuccess) return e;
  *grid = sms * (occ < kBlocksPerSM ? occ : kBlocksPerSM);
  return *grid > 0 ? cudaSuccess : cudaErrorInvalidConfiguration;
}

long long work_doubles(int n, int nb, int grid) {
  return (long long)((n + 1) & ~1) + (long long)n * nb + 2LL * grid * nb + 2LL * grid + 2;
}

}  // namespace

// The grid of a panel (*grid <= 0 on entry: the one hess_panel takes when
// it is given none; else *grid as it is) and the doubles of work a launch
// on it needs
extern "C" int hess_panel_grid(int n, int nb, int t0, void* grid, void* work) {
  int* g = static_cast<int*>(grid);
  if (*g <= 0) {
    const cudaError_t e = auto_grid(n - t0, nb, g);
    if (e != cudaSuccess) {
      cudaGetLastError();
      return static_cast<int>(e);
    }
  }
  *static_cast<long long*>(work) = work_doubles(n, nb, *g);
  return 0;
}

// One panel: A (n x n, row stride lda, unit column stride), columns
// k..k+nb-1 with t0 <= k, k + nb <= n; V, T, Y, P zeroed by the caller;
// work of hess_panel_grid's doubles for that grid.  A grid larger than the
// card holds at once fails (cudaErrorCooperativeLaunchTooLarge).
extern "C" int hess_panel(const void* A, long long lda, int n, int k, int nb, int t0, int lim,
                          void* V, void* T, void* Y, void* P, void* work,
                          long long work_len, int grid, void* stream) {
  if (nb <= 0 || t0 < 0 || t0 > k || k + nb > n) return static_cast<int>(cudaErrorInvalidValue);
  if (grid <= 0) {
    const cudaError_t e = auto_grid(n - t0, nb, &grid);
    if (e != cudaSuccess) {
      cudaGetLastError();
      return static_cast<int>(e);
    }
  }
  if (work_len < work_doubles(n, nb, grid)) return static_cast<int>(cudaErrorInvalidValue);
  Panel p;
  p.A = static_cast<const double*>(A);
  p.lda = lda;
  p.n = n;
  p.k = k;
  p.nb = nb;
  p.t0 = t0;
  p.lim = lim;
  p.rpb = (n - t0 + grid - 1) / grid;
  p.V = static_cast<double*>(V);
  p.T = static_cast<double*>(T);
  p.Y = static_cast<double*>(Y);
  p.P = static_cast<double*>(P);
  double* w = static_cast<double*>(work);
  p.v = w;
  p.Z = w + ((n + 1) & ~1);
  p.part_w = p.Z + (size_t)n * nb;
  p.part_v = p.part_w + (size_t)grid * nb;
  p.part_n = p.part_v + (size_t)grid * nb;
  p.alpha = p.part_n + 2 * (size_t)grid;
  const bool vec = reinterpret_cast<size_t>(A) % 16 == 0 && lda % 2 == 0;
  const size_t smem = smem_bytes(nb, p.rpb);
  int occ = 0;
  cudaError_t e = vec ? occupancy<true>(p.rpb, nb, &occ) : occupancy<false>(p.rpb, nb, &occ);
  if (e == cudaSuccess) {
    void* args[] = {&p};
    e = cudaLaunchCooperativeKernel(
        vec ? (const void*)hess_panel_kernel<true> : (const void*)hess_panel_kernel<false>,
        dim3(grid), dim3(kThreads), args, smem, static_cast<cudaStream_t>(stream));
  }
  if (e != cudaSuccess) {
    cudaGetLastError();  // a refused launch is not sticky: clear it for the next caller
    return static_cast<int>(e);
  }
  return static_cast<int>(cudaGetLastError());
}
