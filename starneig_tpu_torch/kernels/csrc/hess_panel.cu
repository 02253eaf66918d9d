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
// What bounds it on the H100: the panel matvec u = A[t0:, c':] v reads the
// frozen trailing rows of A once a column (128 MB at n = 4000 and t0 = 0:
// 38 us from HBM), and each column is a chain of card-wide dependencies:
// the corrected column needs V^T a over all rows, the reflector the norm
// of the whole column, the matvec the whole reflector.
// Design: one cooperative launch (one block an SM, the grid the SM count:
// every block resident) runs the column loop.  Block b owns a fixed slab
// of rows [t0 + b rpb, t0 + (b + 1) rpb) in every phase, so what a block
// writes for its rows (a, v, Y, Z, V's rows) only it reads back.
//   A plan from the wrapper (ops/gpu_hess.py:panel_plan) splits each
// block's shared memory between the column's reflector and the frozen
// matrix.  v[vs:n) is staged once a column, so no warp reads it from L2 a
// row: all of v from c' where it fits (8 n bytes: up to n of about 27,000
// beside the scratch), else its right-most part, the rest of it read from
// the published column through L2 as each row needs it.  What the
// staged v leaves holds the slab's right-most res_cols columns [gend, n)
// of A for the whole panel; only [c', gend) streams from HBM, evict-first.
//   Products that mix rows go through per-block partial sums, added in two
// levels behind epoch flags: a block publishes its partial with its flag;
// the first block of each group of kGroup waits for its members' flags,
// adds their partials in block order and publishes the group's flag and
// sum; every block waits for the groups' flags and adds their sums in
// group order.  A flag is a release store of the column's index and a wait
// acquire loads, a thread a flag in parallel: a barrier that also
// publishes the sum, in place of a grid.sync and a read of every partial
// by every block.  Two card-wide dependencies a column:
//   (a) a = A[:, c] - Y[:, :j] V[c, :j] on the slab, from what column j-1
//       left: A[:, c] read a column ahead, Y[:, :j-1] V[c, :j-1] from its
//       pass over Y, Y[:, j-1], and V[c, j-1] = 1 where it was reduced;
//       the partial V^T a;
//   --- reduce W: w1 = V^T a
//   (b) Z[:, :j] += V[:, j-1] T[:j, j-1]^T and a -= Z w1 in one pass over
//       the slab's rows (Z = V T^T kept on the slab's rows, so no block
//       reads all of T); warp 0 the slab's max |x| and sum of (x / max)^2
//       (x = a[c+1:]) while the others publish a and form the partial
//       V_tail^T a_tail over rows > c + 1;
//   --- reduce N: V_tail^T a_tail, and the pairs and a are complete
//   (c) every block: dlarfg's scalars from the blocks' (max, sum) pairs,
//       each sum rescaled to the largest max; v over [c', n) from the
//       published a (v = a scale / max: the same operations as the
//       owner's, so the same bits); q = V^T v = V[c + 1, :j] + (V_tail^T
//       a_tail) scale / max, which saves a third reduction; V[:, j],
//       P[:, j] on the slab; one pass over the slab's Y[:, :j] gives Y
//       V[c + 1, :j] (the next column's) and Y q;
//   (d) T[:j, j] = -tau T q, its rows dealt out over the blocks (a row i
//       to block i mod grid); u[r] = A[r, c':] v[c':] on the slab, a warp
//       a row in B1's wide-row form (hess_gemv.cuh) over the row's
//       streamed and resident stretches (v from L2 left of vs), c' = c + 1
//       rounded down to even (v is zero above c + 1); Y[r, j] = tau (u[r]
//       - Y[r, :j] q),
//       which needs no T and no U.
//   Column j + 1's (b) reads T's column j, which reduce W publishes, and
//   its (c) V[c + 2, :j + 1], which reduce N publishes.  The passes over
//   the slab (the Z pass, Y's pass) give a row kTPR threads, the partials a
//   column a thread, and every round of L2 loads goes out at once: a
//   column's chain is a few rounds of L2 latency beside the two reductions
//   (PERF.md: divisions on it cost as much).
// Every sum runs in an order fixed by the shape, the grid and the plan, so
// two launches on one card give the same bits.  What one block writes and
// another reads (V's rows, T, the partials and sums, the pairs, a) is read
// through L2 (__ldcg), after the flags say it is there: L1 is not
// coherent across SMs.
#include <cuda_runtime.h>

#include "common.cuh"
#include "hess_gemv.cuh"

namespace {

constexpr int kThreads = 512;
constexpr int kWarps = kThreads / 32;
constexpr int kTPR = 16;           // threads a slab row in the row passes
constexpr int kGroup = 12;         // blocks a group of the two-level sums
constexpr int kMaxGroups = 32;
constexpr int kMaxGrid = 256;      // flags a reduction
constexpr int kNormPer = 8;        // norm pairs a lane of warp 0 loads: grid <= 256
constexpr int kBatch = 12;         // L2 loads a thread has in flight in the sums
constexpr unsigned kFull = 0xffffffffu;

struct Panel {
  const double* A;
  long long lda;
  int n, k, nb, t0, lim, rpb;
  int vs;                      // v's first staged entry (even)
  int gend, ws;                // resident columns [gend, n), row stride ws
  double *V, *T, *Y, *P;       // n x nb (T nb x nb), row-major, zeroed by the caller
  double* Z;                   // n x nb: V T^T on the slabs' rows
  double* a;                   // n: the corrected column, published for every block's v
  double *part_w, *part_q;     // grid x nb: the slabs' partial V^T a and V_tail^T a_tail
  double *gsum_w, *gsum_q;     // groups x nb: the groups' sums
  double* part_n;              // grid x 2: the slabs' max |x| and sum of (x / max)^2
  unsigned* sync;              // zeroed by the caller: block and group flags of W and of N
};

// shared doubles before the resident columns (ops/gpu_hess.py:
// panel_plan computes the same): nv staged entries of v, six slab vectors
// (a, v, the next column, Y q, the next Y V[c] and Y[:, j]), three vectors
// of length nb and the column's scalars, rounded up to even (the resident
// rows are read in 16-byte pairs)
__host__ __device__ long long fixed_doubles(int nv, int nb, int rpb) {
  return ((((long long)nv + 1) & ~1LL) + 6LL * rpb + 3LL * nb + 8 + 1) & ~1LL;
}

// v[r] from the corrected column's a[r], alike in every block: 0 on rows
// <= c, 1 on c + 1, a scale below (0 where dlarfg found nothing to reduce)
__device__ __forceinline__ double v_of(int r, double a, int c, double scale, bool degen) {
  return r <= c ? 0.0 : (r == c + 1 ? 1.0 : (degen ? 0.0 : a * scale));
}

// the matvec's loader of v where it is not staged: from the published
// column a through L2, by v_of (the staged entries' operations, so their
// bits); a pair's entry is even, and a 16-byte aligned
struct PublishedV {
  const double* a;
  int c;
  double scale;
  bool degen;
  template <bool kVec>
  __device__ __forceinline__ double2 pair(const double* p) const {
    const double2 x = __ldcg(reinterpret_cast<const double2*>(p));
    const int r = static_cast<int>(p - a);
    return make_double2(v_of(r, x.x, c, scale, degen), v_of(r + 1, x.y, c, scale, degen));
  }
  __device__ __forceinline__ double one(const double* p) const {
    return v_of(static_cast<int>(p - a), __ldcg(p), c, scale, degen);
  }
};

__device__ __forceinline__ unsigned ld_acquire(const unsigned* p) {
  unsigned v;
  asm volatile("ld.acquire.gpu.global.u32 %0, [%1];" : "=r"(v) : "l"(p) : "memory");
  return v;
}

// sum over l < L of m[l] xs[l] (xs in shared memory, m another block's row
// in global memory, read through L2), in every lane of the calling warp:
// eight loads a lane in flight, summed in an order fixed by L
__device__ __forceinline__ double warp_dot_l2(const double* m, const double* xs, int L,
                                              int lane) {
  double acc[8] = {0.0, 0.0, 0.0, 0.0, 0.0, 0.0, 0.0, 0.0};
  for (int l = lane; l < L; l += 256) {
    double a[8];
#pragma unroll
    for (int u = 0; u < 8; ++u) a[u] = __ldcg(m + min(l + 32 * u, L - 1));
#pragma unroll
    for (int u = 0; u < 8; ++u)
      if (l + 32 * u < L) acc[u] += a[u] * xs[l + 32 * u];
  }
  double s = ((acc[0] + acc[1]) + (acc[2] + acc[3])) + ((acc[4] + acc[5]) + (acc[6] + acc[7]));
  for (int off = 16; off > 0; off >>= 1) s += __shfl_xor_sync(kFull, s, off);
  return s;
}

// the sums over l < J of m[l] x1[l] and of m[l] x2[l] by the kTPR threads
// of a slab row (one pass over m, as row_dot), in all of them
__device__ __forceinline__ void row_dot2(const double* m, const double* x1, const double* x2,
                                         int J, int sub, bool live, double& d1, double& d2) {
  double a1[4] = {0.0, 0.0, 0.0, 0.0}, a2[4] = {0.0, 0.0, 0.0, 0.0};
  if (live) {
    for (int l = sub; l < J; l += 4 * kTPR) {
      double a[4];
#pragma unroll
      for (int u = 0; u < 4; ++u) a[u] = m[min(l + kTPR * u, J - 1)];
#pragma unroll
      for (int u = 0; u < 4; ++u)
        if (l + kTPR * u < J) {
          a1[u] += a[u] * x1[l + kTPR * u];
          a2[u] += a[u] * x2[l + kTPR * u];
        }
    }
  }
  d1 = (a1[0] + a1[1]) + (a1[2] + a1[3]);
  d2 = (a2[0] + a2[1]) + (a2[2] + a2[3]);
  for (int off = kTPR / 2; off > 0; off >>= 1) {
    d1 += __shfl_xor_sync(kFull, d1, off);
    d2 += __shfl_xor_sync(kFull, d2, off);
  }
}

// out[i] = sum over l < L of M[l ld + i] x[l] (x in shared memory), for
// i < J: a thread a column (threads t0.. of the block), l in order, kBatch
// loads in flight
__device__ __forceinline__ void col_sum(const double* M, int ld_m, int L, int J, const double* x,
                                        double* out, int t0 = 0) {
  for (int i = threadIdx.x - t0; i < J; i += kThreads - t0) {
    double s = 0.0;
    for (int l0 = 0; l0 < L; l0 += kBatch) {
      double m[kBatch];
#pragma unroll
      for (int u = 0; u < kBatch; ++u) m[u] = M[(size_t)min(l0 + u, L - 1) * ld_m + i];
#pragma unroll
      for (int u = 0; u < kBatch; ++u)
        if (l0 + u < L) s += m[u] * x[l0 + u];
    }
    out[i] = s;
  }
}

// sum over q < cnt of ldcg(p[q * ld]) in order, kBatch loads in flight
__device__ __forceinline__ double strided_sum(const double* p, size_t ld, int cnt) {
  double s = 0.0;
  for (int q0 = 0; q0 < cnt; q0 += kBatch) {
    double v[kBatch];
#pragma unroll
    for (int u = 0; u < kBatch; ++u) v[u] = __ldcg(p + (size_t)min(q0 + u, cnt - 1) * ld);
    s = q0 == 0 ? v[0] : s + v[0];
#pragma unroll
    for (int u = 1; u < kBatch; ++u)
      if (q0 + u < cnt) s += v[u];
  }
  return s;
}

__device__ __forceinline__ void st_release(unsigned* p, unsigned v) {
  asm volatile("st.release.gpu.global.u32 [%0], %1;" ::"l"(p), "r"(v) : "memory");
}

// threads 0..cnt-1 wait, in parallel, until flags[t * stride] reaches
// epoch; then the block goes on
__device__ __forceinline__ void wait_flags(const unsigned* flags, int cnt, unsigned epoch) {
  if (threadIdx.x < cnt)
    while (ld_acquire(flags + threadIdx.x) < epoch) {
    }
  __syncthreads();
}

// The two-level sum of the blocks' partials part[b][:J] (written by this
// block before the call), behind epoch flags (a flag a block, a flag a
// group): a block publishes its flag; the first block of each group of
// kGroup waits for its members' flags, adds their partials in block order
// into gsum[g] and publishes the group's flag; every block waits for the
// groups' flags and adds their sums in group order into out (shared
// memory).  A flag is a release store, a wait acquire loads: whatever a
// block wrote before the call is visible to every block after it.
__device__ void reduce_partials(const double* part, double* gsum, unsigned* bflag,
                                unsigned* gflag, unsigned epoch, int nb, int J, double* out) {
  const int b = blockIdx.x, nblk = gridDim.x, tid = threadIdx.x;
  const int g = b / kGroup, ng = (nblk + kGroup - 1) / kGroup;
  const int b0 = g * kGroup, gsize = min(kGroup, nblk - b0);
  __syncthreads();  // the block's writes are done
  if (b != b0) {
    if (tid == 0) st_release(bflag + b, epoch);
  } else {
    wait_flags(bflag + b0 + 1, gsize - 1, epoch);
    for (int i = tid; i < J; i += kThreads)
      gsum[(size_t)g * nb + i] = strided_sum(part + (size_t)b0 * nb + i, nb, gsize);
    __syncthreads();
    if (tid == 0) st_release(gflag + g, epoch);
  }
  wait_flags(gflag, ng, epoch);
  for (int i = tid; i < J; i += kThreads) out[i] = strided_sum(gsum + i, nb, ng);
  __syncthreads();
}

template <bool kVec>
__global__ void __launch_bounds__(kThreads, 1) hess_panel_kernel(Panel p) {
  extern __shared__ double sm[];
  const int n = p.n, nb = p.nb, k = p.k;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int sub = tid % kTPR, rsub = tid / kTPR;  // the row passes: kTPR threads a row
  const int b = blockIdx.x, nblk = gridDim.x;
  const int r0 = min(n, p.t0 + b * p.rpb), r1 = min(n, r0 + p.rpb), nr = r1 - r0;
  const int ws = p.ws, gend = p.gend, vs = p.vs;
  const int vlen = ((n - vs) + 1) & ~1;
  double* vsh = sm;                      // vlen: v[vs:n] for the matvec
  double* a_s = vsh + vlen;              // rpb: the slab's corrected column
  double* v_s = a_s + p.rpb;             // rpb: the slab's reflector entries
  double* acol = v_s + p.rpb;            // rpb: the slab's A[:, c], read a column ahead
  double* y_s = acol + p.rpb;            // rpb: the slab's Y[:, :j] q
  double* d1_s = y_s + p.rpb;            // rpb: the slab's Y[:, :j] V[c + 1, :j]
  double* ycol = d1_s + p.rpb;           // rpb: the slab's Y[:, j]
  double* vc_s = ycol + p.rpb;           // nb: V[c + 1, :j]
  double* w_s = vc_s + nb;               // nb: w1 = V^T a, then q = V^T v
  double* t_s = w_s + nb;                // nb: T[:j, j - 1], then V_tail^T a_tail
  double* sc = t_s + nb;                 // 8: the column's scalars
  double* sA = sm + fixed_doubles(n - vs, nb, p.rpb);  // rpb x ws: the slab's columns [gend, n)
  unsigned* bflag_w = p.sync;
  unsigned* gflag_w = bflag_w + kMaxGrid;
  unsigned* bflag_n = gflag_w + kMaxGroups;
  unsigned* gflag_n = bflag_n + kMaxGrid;

  // rows above t0 take no part in the loop: P = the panel's columns there
  // (_apply_panel rebuilds them); Y and V stay zero
  for (long long idx = (long long)b * kThreads + tid; idx < (long long)p.t0 * nb;
       idx += (long long)nblk * kThreads) {
    const long long r = idx / nb, j = idx % nb;
    p.P[idx] = p.A[r * p.lda + k + j];
  }
  for (int i = tid; i < nr * nb; i += kThreads) p.Z[(size_t)r0 * nb + i] = 0.0;
  // the slab's resident columns, read once; the first column
  const int w = n - gend;
  for (int rr = warp; rr < nr; rr += kWarps)
    for (int cc = lane; cc < w; cc += 32)
      sA[rr * ws + cc] = __ldcs(p.A + (size_t)(r0 + rr) * p.lda + gend + cc);
  for (int rr = tid; rr < nr; rr += kThreads) {
    acol[rr] = p.A[(size_t)(r0 + rr) * p.lda + k];
    d1_s[rr] = ycol[rr] = 0.0;
  }
  const int z0 = clampi(k + 1 - r0, 0, nr);  // the slab's first row where V, Z may be nonzero
  bool prev_active = false;
  __syncthreads();

  for (int j = 0; j < nb; ++j) {
    const int c = k + j;
    const unsigned epoch = j + 1;
    const bool active = c < p.lim - 1 && c < n - 1;
    // (a) the column corrected by the panel's earlier reflectors, a = A[:, c]
    // - Y[:, :j] V[c, :j]: Y[:, :j-1] V[c, :j-1] came from column j-1's
    // pass over Y, and V[c, j-1] = v_{j-1}[c] is 1 where column j-1 was
    // reduced
    for (int rr = tid; rr < nr; rr += kThreads)
      a_s[rr] = acol[rr] - (d1_s[rr] + (prev_active ? ycol[rr] : 0.0));
    __syncthreads();
    col_sum(p.V + (size_t)(r0 + z0) * nb, nb, nr - z0, j, a_s + z0, p.part_w + (size_t)b * nb);
    reduce_partials(p.part_w, p.gsum_w, bflag_w, gflag_w, epoch, nb, j, w_s);

    // (b) Z[:, :j] += V[:, j-1] T[:j, j-1]^T and a -= Z w1 in one pass; the
    // slab's share of the column norm and of V_tail^T a_tail; a published
    if (j > 0)
      for (int i = tid; i < j; i += kThreads) t_s[i] = __ldcg(p.T + (size_t)i * nb + j - 1);
    __syncthreads();
    for (int rr0 = z0; rr0 < nr; rr0 += kThreads / kTPR) {
      const int rr = rr0 + rsub;
      double acc[8] = {0.0, 0.0, 0.0, 0.0, 0.0, 0.0, 0.0, 0.0};
      if (rr < nr) {
        double* __restrict__ z = p.Z + (size_t)(r0 + rr) * nb;
        const double vr = j > 0 ? p.V[(size_t)(r0 + rr) * nb + j - 1] : 0.0;
        for (int l = sub; l < j; l += 8 * kTPR) {
          double zl[8];
#pragma unroll
          for (int u = 0; u < 8; ++u) zl[u] = z[min(l + kTPR * u, j - 1)];
#pragma unroll
          for (int u = 0; u < 8; ++u) {
            const int lu = l + kTPR * u;
            if (lu < j) {
              zl[u] += vr * t_s[lu];
              z[lu] = zl[u];
              acc[u] += zl[u] * w_s[lu];
            }
          }
        }
      }
      double d = ((acc[0] + acc[1]) + (acc[2] + acc[3])) + ((acc[4] + acc[5]) + (acc[6] + acc[7]));
      for (int off = kTPR / 2; off > 0; off >>= 1) d += __shfl_xor_sync(kFull, d, off);
      if (sub == 0 && rr < nr) a_s[rr] -= d;
    }
    __syncthreads();
    if (warp == 0) {  // the slab's max |x| and sum of (x / max)^2
      double mx = 0.0;
      for (int rr = lane; rr < nr; rr += 32)
        if (r0 + rr > c) mx = dmax(mx, fabs(a_s[rr]));
      for (int off = 16; off > 0; off >>= 1) mx = dmax(mx, __shfl_xor_sync(kFull, mx, off));
      const double rs = 1.0 / (mx == 0.0 ? 1.0 : mx);
      double ss = 0.0;
      for (int rr = lane; rr < nr; rr += 32)
        if (r0 + rr > c + 1) {
          const double xs = a_s[rr] * rs;
          ss += xs * xs;
        }
      for (int off = 16; off > 0; off >>= 1) ss += __shfl_xor_sync(kFull, ss, off);
      if (lane == 0) {
        p.part_n[2 * b] = mx;
        p.part_n[2 * b + 1] = ss;
      }
    } else {  // a published; the slab's partial V_tail^T a_tail (rows > c + 1)
      for (int rr = tid - 32; rr < nr; rr += kThreads - 32) p.a[r0 + rr] = a_s[rr];
      const int s0 = clampi(c + 2 - r0, 0, nr);
      col_sum(p.V + (size_t)(r0 + s0) * nb, nb, nr - s0, j, a_s + s0, p.part_q + (size_t)b * nb,
              32);
    }
    reduce_partials(p.part_q, p.gsum_q, bflag_n, gflag_n, epoch, nb, j, t_s);

    // (c) the reflector: dlarfg pre-scaled by max |x| (primitives.householder)
    if (warp == 0) {
      double mq[kNormPer], sq[kNormPer];
#pragma unroll
      for (int u = 0; u < kNormPer; ++u) {
        const int q = min(lane + 32 * u, nblk - 1);
        mq[u] = __ldcg(p.part_n + 2 * q);
        sq[u] = __ldcg(p.part_n + 2 * q + 1);
      }
#pragma unroll
      for (int u = 0; u < kNormPer; ++u)
        if (lane + 32 * u >= nblk) mq[u] = sq[u] = 0.0;
      const double alpha_raw = active ? __ldcg(p.a + c + 1) : 0.0;
      double m = 0.0;
#pragma unroll
      for (int u = 0; u < kNormPer; ++u) m = dmax(m, mq[u]);
      for (int off = 16; off > 0; off >>= 1) m = dmax(m, __shfl_xor_sync(kFull, m, off));
      const double msafe = m == 0.0 ? 1.0 : m;
      const double rinv = 1.0 / msafe;
      double s = 0.0;
#pragma unroll
      for (int u = 0; u < kNormPer; ++u) {
        const double rq = mq[u] * rinv;
        s += sq[u] * rq * rq;
      }
      for (int off = 16; off > 0; off >>= 1) s += __shfl_xor_sync(kFull, s, off);
      if (lane == 0) {
        const double alpha = alpha_raw / msafe;
        const double xnorm = sqrt(s);
        const double bt = -sgn(alpha) * hypot2(alpha, xnorm);
        const bool degen = xnorm == 0.0;
        sc[0] = active && !degen ? sdiv(bt - alpha, bt) : 0.0;  // tau
        sc[1] = sdiv(1.0, alpha - bt);                          // v's scale
        sc[2] = (degen ? alpha : bt) * msafe;                   // beta
        sc[3] = msafe;
        sc[4] = degen ? 1.0 : 0.0;
        sc[5] = degen ? 0.0 : sc[1] / msafe;                    // v = a scale / msafe
      }
    }
    __syncthreads();
    const double tau = sc[0];
    const double vscale = sc[5];
    const bool degen = sc[4] != 0.0;
    {
      const double beta = sc[2];
      for (int rr = tid; rr < nr; rr += kThreads) {
        const int r = r0 + rr;
        const double a = a_s[rr];
        double v = 0.0, pc = a;  // outside [begin, end): the corrected column
        if (active) {
          v = v_of(r, a, c, vscale, degen);
          pc = r <= c ? a : (r == c + 1 ? beta : 0.0);
        }
        v_s[rr] = v;
        p.V[(size_t)r * nb + j] = v;
        p.P[(size_t)r * nb + j] = pc;
      }
    }
    const int cs = (c + 1) & ~1;
    // V[c + 1, :j]; q = V^T v = V[c + 1, :j] + (V_tail^T a_tail) scale /
    // msafe
    for (int i = tid; i < j; i += kThreads) {
      const double vn = c + 1 < n ? __ldcg(p.V + (size_t)(c + 1) * nb + i) : 0.0;
      vc_s[i] = vn;
      w_s[i] = active ? vn + (degen ? 0.0 : t_s[i] * vscale) : 0.0;
    }
    if (active) {
      // v over [max(c', vs), n) for the matvec, from the published column
#pragma unroll 8
      for (int i = max(cs, vs) - vs + tid; i < n - vs; i += kThreads)
        vsh[i] = v_of(vs + i, __ldcg(p.a + vs + i), c, vscale, degen);
    }
    __syncthreads();
    // one pass over the slab's Y[:, :j]: Y V[c + 1, :j] (the next column's
    // correction) and Y (V_tail^T a_tail), so Y q = the first + the second
    // scale / msafe, for Y[:, j] after the matvec
    for (int rr0 = 0; rr0 < nr; rr0 += kThreads / kTPR) {
      const int rr = rr0 + rsub;
      double d1, d2;
      row_dot2(p.Y + (size_t)(r0 + rr) * nb, vc_s, t_s, j, sub, rr < nr, d1, d2);
      if (sub == 0 && rr < nr) {
        d1_s[rr] = d1;
        y_s[rr] = active ? d1 + (degen ? 0.0 : d2 * vscale) : 0.0;
      }
    }
    __syncthreads();

    // (d) this block's rows of T[:, j]; the panel matvec and Y[:, j] on
    // the slab; the next column's A[:, c + 1]
    for (int i = b + warp * nblk; i < j; i += kWarps * nblk) {
      const double d = warp_dot_l2(p.T + (size_t)i * nb + i, w_s + i, j - i, lane);
      if (lane == 0) p.T[(size_t)i * nb + j] = -tau * d;
    }
    if (b == 0 && tid == 0) p.T[(size_t)j * nb + j] = tau;
    if (j + 1 < nb)
      for (int rr = tid; rr < nr; rr += kThreads)
        acol[rr] = p.A[(size_t)(r0 + rr) * p.lda + c + 1];
    // the row's stretches: [cs, s1) streamed with v from L2, [s1, gend)
    // streamed with v staged, [s2, n) resident (vs <= gend: the plan)
    const int s1 = min(max(cs, vs), gend), s2 = max(cs, gend);
    const PublishedV vg{p.a, c, vscale, degen};
    for (int rr = warp; rr < nr; rr += kWarps) {
      const int r = r0 + rr;
      double u = 0.0;
      if (active) {
        double acc[gemv_row::kLoads];
#pragma unroll
        for (int q = 0; q < gemv_row::kLoads; ++q) acc[q] = 0.0;
        const double* arow = p.A + (size_t)r * p.lda;
        if (cs < s1)
          gemv_row::row_dot_acc<kVec>(acc, arow + cs, p.a + cs, s1 - cs, lane,
                                      gemv_row::StreamM(), vg);
        if (s1 < gend)
          gemv_row::row_dot_acc<kVec>(acc, arow + s1, vsh + (s1 - vs), gend - s1, lane,
                                      gemv_row::StreamM(), gemv_row::Shared());
        if (s2 < n)
          gemv_row::row_dot_acc<true>(acc, sA + rr * ws + (s2 - gend), vsh + (s2 - vs), n - s2,
                                      lane, gemv_row::Shared(), gemv_row::Shared());
        u = gemv_row::fold(acc);
      }
      if (lane == 0) p.Y[(size_t)r * nb + j] = ycol[rr] = tau * (u - y_s[rr]);
    }
    prev_active = active;
    __syncthreads();
  }
}

template <bool kVec>
cudaError_t occupancy(size_t smem, int* blocks) {
  cudaError_t e = cudaFuncSetAttribute(hess_panel_kernel<kVec>,
                                       cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e != cudaSuccess) return e;
  return cudaOccupancyMaxActiveBlocksPerMultiprocessor(blocks, hess_panel_kernel<kVec>,
                                                       kThreads, smem);
}

// the grid of a panel: one block an SM, where the kernel fits one (with
// the least shared memory a launch takes)
cudaError_t auto_grid(int n, int nb, int t0, int* grid) {
  int dev = 0, sms = 0, occ = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e == cudaSuccess) e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (e != cudaSuccess) return e;
  const int rpb = (n - t0 + sms - 1) / sms;
  e = occupancy<true>(sizeof(double) * fixed_doubles(0, nb, rpb), &occ);
  if (e != cudaSuccess) return e;
  *grid = occ >= 1 ? sms : 0;
  return *grid > 0 ? cudaSuccess : cudaErrorInvalidConfiguration;
}

long long work_doubles(int n, int nb, int grid) {
  const long long ng = (grid + kGroup - 1) / kGroup;
  return (long long)((n + 1) & ~1) + (long long)n * nb + 2LL * grid * nb + 2LL * ng * nb +
         2LL * grid;
}

}  // namespace

// The grid of a panel (*grid <= 0 on entry: the one hess_panel takes when
// it is given none; else *grid as it is), the doubles of work and the
// unsigned ints of the zeroed counters a launch on it needs, and the
// shared memory a block may have (bytes)
extern "C" int hess_panel_grid(int n, int nb, int t0, void* grid, void* work, void* sync,
                               void* smem_max) {
  int* g = static_cast<int*>(grid);
  if (*g <= 0) {
    const cudaError_t e = auto_grid(n, nb, t0, g);
    if (e != cudaSuccess) {
      cudaGetLastError();
      return static_cast<int>(e);
    }
  }
  int dev = 0, optin = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e == cudaSuccess)
    e = cudaDeviceGetAttribute(&optin, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
  if (e != cudaSuccess) {
    cudaGetLastError();
    return static_cast<int>(e);
  }
  *static_cast<long long*>(work) = work_doubles(n, nb, *g);
  *static_cast<int*>(sync) = 2 * (kMaxGrid + kMaxGroups);
  *static_cast<int*>(smem_max) = optin;
  return 0;
}

// One panel: A (n x n, row stride lda, unit column stride), columns
// k..k+nb-1 with t0 <= k, k + nb <= n; V, T, Y, P zeroed by the caller;
// work of hess_panel_grid's doubles for that grid and its counters,
// zeroed.  The plan (ops/gpu_hess.py:panel_plan): res_cols columns [n -
// res_cols, n) of each slab resident in shared memory, v staged from
// entry vs (even, from k + 1 rounded down to even up to n - res_cols),
// smem_bytes of shared memory a block.  A grid larger than the card holds
// at once fails (cudaErrorCooperativeLaunchTooLarge), as does a plan that
// does not fit.
extern "C" int hess_panel(const void* A, long long lda, int n, int k, int nb, int t0, int lim,
                          void* V, void* T, void* Y, void* P, void* work, long long work_len,
                          void* sync, int grid, int res_cols, int vs, int smem_bytes,
                          void* stream) {
  if (nb <= 0 || t0 < 0 || t0 > k || k + nb > n) return static_cast<int>(cudaErrorInvalidValue);
  if (grid <= 0) {
    const cudaError_t e = auto_grid(n, nb, t0, &grid);
    if (e != cudaSuccess) {
      cudaGetLastError();
      return static_cast<int>(e);
    }
  }
  const int ng = (grid + kGroup - 1) / kGroup;
  const int rpb = (n - t0 + grid - 1) / grid;
  const int cs0 = (k + 1) & ~1;
  const int gend = n - res_cols;
  const int ws = res_cols + (res_cols & 1);
  const long long need = sizeof(double) * (fixed_doubles(n - vs, nb, rpb) + (long long)rpb * ws);
  if (work_len < work_doubles(n, nb, grid) || ng > kMaxGroups || grid > kMaxGrid || grid > 32 * kNormPer ||
      res_cols < 0 || (res_cols > 0 && (gend & 1)) || (vs & 1) || vs < cs0 || vs > gend ||
      gend < cs0 ||
      smem_bytes < need)
    return static_cast<int>(cudaErrorInvalidValue);
  Panel p;
  p.A = static_cast<const double*>(A);
  p.lda = lda;
  p.n = n;
  p.k = k;
  p.nb = nb;
  p.t0 = t0;
  p.lim = lim;
  p.rpb = rpb;
  p.vs = vs;
  p.gend = gend;
  p.ws = ws;
  p.V = static_cast<double*>(V);
  p.T = static_cast<double*>(T);
  p.Y = static_cast<double*>(Y);
  p.P = static_cast<double*>(P);
  double* w = static_cast<double*>(work);
  p.a = w;
  p.Z = w + ((n + 1) & ~1);
  p.part_w = p.Z + (size_t)n * nb;
  p.part_q = p.part_w + (size_t)grid * nb;
  p.gsum_w = p.part_q + (size_t)grid * nb;
  p.gsum_q = p.gsum_w + (size_t)ng * nb;
  p.part_n = p.gsum_q + (size_t)ng * nb;
  p.sync = static_cast<unsigned*>(sync);
  const bool vec = reinterpret_cast<size_t>(A) % 16 == 0 && lda % 2 == 0;
  const size_t smem = static_cast<size_t>(smem_bytes);
  int occ = 0;
  cudaError_t e = vec ? occupancy<true>(smem, &occ) : occupancy<false>(smem, &occ);
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
