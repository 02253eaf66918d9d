// G1's window mode: the GEP AED recondense, a chain launch and a replay
// launch a window.
//
// Replaces the XLA loops of starneig_tpu/ops/qz_driver.py:
// _aed_recondense_gep (:166): the spike s Q[0, :kbot] condensed into
// beta e1 by rotation pairs (the cascade's "column -1"), then the
// Hessenberg-triangular cascade on the leading kbot block, then T's lower
// triangle inside it zeroed.  Plain twins: ops/qz_driver.py:
// _aed_recondense_gep (the oracle, the JAX order) and the stage twins of
// this form, testing/recondense.py: recondense_chain and recondense_replay
// (aed_recondense_split composes them).
//
// The work.  kbot (kbot - 1) / 2 rotation pairs, 12,403 at WA = 162,
// kbot = 158, every one nontrivial (the spike chase fills the block's
// lower triangle).  Cascade j (j = -1 the spike) has kbot - 2 - j pairs,
// k = kbot - 1 down to j + 2: a left rotation on rows (k-1, k) zeroing
// x[k] (x = A's column j, or the spike), then the right rotation on
// columns (k-1, k) zeroing the T[k, k-1] fill.  Its left rotations depend
// only on x; its right rotation at k on T's row k swept by the right
// rotations below k; cascade j + 1's x is column j + 1 after cascade j's
// last right rotation.  So the serial chain is two rotations a pair, and
// Q, Z and the parts of S and T outside the leading block (S[:kbot,
// kbot:], S[kbot:, :kbot], the same of T) take only left or only right
// rotations, which commute with nothing the chain reads.
//
// What bounds it on the H100: that chain (24,806 dependent rotations at
// WA = 162), not flops (~0.4 GFLOP) or bytes (1 MB).  Design:
//   * ht_win_chain_kernel, one block of 512 threads, a loop over the
//     cascades with three block barriers a cascade (not a pair).  T's
//     leading block lives packed (upper triangle plus the fill's
//     subdiagonal, column-major) in shared memory where it fits (kbot <=
//     196), else in a global scratch through the same generic pointer;
//     the cascade's vectors (x and the rotations by k) likewise (kbot <=
//     4,096); S stays in global memory (L2).  Phase A: warp 0 forms all of the
//     cascade's left rotations at once from x: the carried entry of the
//     left chain is sigma_k ||x[k:]|| (sigma_k the sign of x[k:]'s first
//     nonzero), a suffix scan of squares scaled by max|x| (a lane a chunk,
//     then shuffles), then every rotation from (x[k-1], g_k) scaled, by one
//     reciprocal square root (givens_rs); it plants column j (beta for the
//     spike).  Phase B: a thread a column of S and of T applies them
//     bottom-up with the carried entry in a register, a batch of 8 loads in
//     flight while the batch before is rotated (S's rows coalesced, from
//     L2).  Phase C: warp 0 runs the right
//     chain on T in shared memory, every lane forming each rotation from
//     the diagonal pair by one reciprocal square root (givens_rs) and
//     updating its rows of the column pair (all of a lane's loads before its
//     stores), the fill planted; no barrier but __syncwarp.  Phase D, beside C: the cascade's right rotations on
//     S's rows (8 warps, a 32 x 32 tile at a time staged through shared
//     memory for coalesced loads, a lane a row swept right to left) and on
//     T's rows above the cascade (a lane a row in shared memory), each
//     tile once the chain has published its 32 rotations (a counter in
//     shared memory).  Every pair goes to a log (c, s, cr, sr).
//   * ht_win_replay_kernel: Q's and Z's rows, S's and T's rows below the
//     block and their columns right of it, a lane a vector, each applying
//     the log's left or right rotations in order, the carried entry in a
//     register.  A warp stages as many vectors as fit in shared memory (an
//     odd stride: conflict-free; 32 up to kbot ~ 870) and each cascade's
//     rotations; where not one vector fits (kbot > ~9,680) its 32 vectors
//     stay in place in global memory and the rotations are read from the
//     log.
// The left rotations come from suffix norms where the twin chains givens
// through the rotated entry, every rotation from one reciprocal square
// root, and every left rotation of a cascade is applied before its right
// ones: rounding only (the stage twins model this order; the kernel is
// held to the oracle within 1e-12 at kbot <= 10 and to the recondense
// contract above).  T's leading block must be upper triangular on entry
// (the window's generalized Schur form): entries below its subdiagonal
// are not read.
#include "common.cuh"

namespace {

constexpr int kThreads = 512;
constexpr int kWarps = kThreads / 32;
constexpr int kTileWarps = 8;      // Phase D's S tiles (the other warps: T's rows)
constexpr int kTileLd = 33;        // odd: a lane's row conflict-free
constexpr int kTile = 32 * kTileLd;
constexpr int kPre = 8;            // loads a walking thread keeps in flight
constexpr size_t kSmemMax = 232448;

// T's packed leading block: column c holds rows 0 .. c+1 (c + 2 entries)
__host__ __device__ inline int poff(int c) { return c * (c + 3) / 2; }

// the log's entry of cascade m (j = m - 1) at row k
DEVI long long log_pos(int kbot, int m, int k) {
  return (long long)m * (kbot - 1) - (long long)m * (m - 1) / 2 + (kbot - 1 - k);
}

// the rotations k = kmax .. kmin ((c, s) = rot(k)) bottom-up on the vector
// p[r * stride]: (v[k-1], v[k]) <- (c v[k-1] + s v[k], -s v[k-1] + c
// v[k]); v[k-1] is untouched until step k, so it loads ahead: a batch of
// kPre loads in flight while the batch before is rotated
template <class Rot>
DEVI void walk(double* p, long long stride, int kmax, int kmin, Rot rot) {
  if (kmax < kmin) return;
  double y = p[kmax * stride];
  double a[kPre], nx[kPre];
#pragma unroll
  for (int u = 0; u < kPre; ++u) a[u] = kmax - u >= kmin ? p[(kmax - u - 1) * stride] : 0.0;
  for (int k0 = kmax; k0 >= kmin; k0 -= kPre) {
    const int k1 = k0 - kPre;
#pragma unroll
    for (int u = 0; u < kPre; ++u) nx[u] = k1 - u >= kmin ? p[(k1 - u - 1) * stride] : 0.0;
#pragma unroll
    for (int u = 0; u < kPre; ++u) {
      const int k = k0 - u;
      if (k >= kmin) {
        double c, s;
        rot(k, c, s);
        p[k * stride] = -s * a[u] + c * y;
        y = c * a[u] + s * y;
      }
    }
#pragma unroll
    for (int u = 0; u < kPre; ++u) a[u] = nx[u];
  }
  p[(kmin - 1) * stride] = y;
}

// Phase C's update of T's rows rlo .. k in the column pair (k - 1, k),
// NQ rows a lane, every load before the stores (the fill planted)
template <int NQ>
DEVI void chain_rows(double* cm, double* ck, int rlo, int k, double cr, double sr, int lane) {
  double a[NQ], b[NQ];
#pragma unroll
  for (int q = 0; q < NQ; ++q) {
    const int r = rlo + lane + 32 * q;
    a[q] = r <= k ? cm[r] : 0.0;
    b[q] = r <= k ? ck[r] : 0.0;
  }
#pragma unroll
  for (int q = 0; q < NQ; ++q) {
    const int r = rlo + lane + 32 * q;
    if (r <= k) {
      cm[r] = r == k ? 0.0 : cr * a[q] - sr * b[q];
      ck[r] = sr * a[q] + cr * b[q];
    }
  }
}

// wait until the right chain has published rotation `need` (the chain
// counts down from kbot): rotations are published in rc/rs before the
// counter moves
DEVI void wait_chain(const volatile int* prog, int need) {
  while (*prog > need) __nanosleep(64);
  __threadfence_block();
}

// Phase D on S's rows r0 .. r0 + rows - 1: the right rotations k = kbot-1
// .. kmin, a lane a row, 32 columns at a time staged through the warp's
// tile (coalesced loads and stores) [the pattern of ht_cascade.cu's
// ht_rpass_kernel], each tile once the chain has published its rotations
DEVI void rsweep_tile(double* S, int W, int r0, int rows, int kbot, int kmin,
                      const double* rc, const double* rs, double* tile,
                      const volatile int* prog) {
  const int lane = threadIdx.x & 31, lowest = kmin - 1;
  double* trow = tile + lane * kTileLd;
  double* M = S + (size_t)r0 * W;
  double y = 0.0;
  for (int c1 = kbot; c1 > lowest; c1 -= 32) {
    const int c0 = max(c1 - 32, lowest), nc = c1 - c0;
    for (int rb = 0; rb < rows; rb += 8) {
      double v[8];
#pragma unroll
      for (int u = 0; u < 8; ++u)
        v[u] = (rb + u < rows && lane < nc) ? M[(size_t)(rb + u) * W + c0 + lane] : 0.0;
#pragma unroll
      for (int u = 0; u < 8; ++u)
        if (rb + u < rows) tile[(rb + u) * kTileLd + lane] = v[u];
    }
    wait_chain(prog, max(c0 + 1, kmin));   // the tile's rotations are out
    __syncwarp();
    if (c1 == kbot) y = trow[nc - 1];
    for (int k = c1 == kbot ? kbot - 1 : c1; k > c0 && k >= kmin; --k) {
      const double cr = rc[k], sr = rs[k];
      const double a = trow[k - 1 - c0];
      const double nk = sr * a + cr * y;
      if (k == c1) {
        if (lane < rows) M[(size_t)lane * W + k] = nk;   // the previous tile's column
      } else {
        trow[k - c0] = nk;
      }
      y = cr * a - sr * y;
    }
    if (c0 == lowest) trow[0] = y;
    __syncwarp();
    for (int rr = 0; rr < rows; ++rr)
      if (lane < nc) M[(size_t)rr * W + c0 + lane] = tile[rr * kTileLd + lane];
    __syncwarp();
  }
}

__global__ void __launch_bounds__(kThreads, 1)   // one block: 128 registers a thread
ht_win_chain_kernel(double* __restrict__ S, double* __restrict__ Tg,
                    const double* __restrict__ Q, double* __restrict__ Tscratch,
                    double* __restrict__ logp, int W, int kbot, double spike,
                    double* __restrict__ beta, int v_shared, int t_shared) {
  extern __shared__ double sm[];
  __shared__ int s_prog;
  double* tiles = sm;              // kTileWarps tiles
  double* xs = v_shared ? tiles + kTileWarps * kTile : Tscratch + poff(kbot);   // x, kbot
  double* lc = xs + kbot;          // left (c, s), right (cr, sr), by k
  double* ls = lc + kbot;
  double* rc = ls + kbot;
  double* rs = rc + kbot;
  double* Tp = t_shared ? rs + kbot : Tscratch;
  volatile int* prog = &s_prog;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  if (kbot <= 1) {
    if (tid == 0) beta[0] = kbot == 1 ? spike * Q[0] : 0.0;
    return;
  }
  for (int c = warp; c < kbot; c += kWarps) {
    const int hi = min(c + 1, kbot - 1);
    for (int r = lane; r <= hi; r += 32) Tp[poff(c) + r] = Tg[(size_t)r * W + c];
  }
  __syncthreads();
  for (int m = 0; m <= kbot - 2; ++m) {
    const int j = m - 1, kmin = j + 2, len = kbot - 1 - j;
    // -- A: the left rotations from x (rows j+1 .. kbot-1), warp 0 (a
    // chunk a lane)
    if (warp == 0) {
      double mx = 0.0;
      for (int r = lane; r < len; r += 32) {
        const double v = j < 0 ? spike * Q[r] : S[(size_t)(j + 1 + r) * W + j];
        xs[r] = v;
        mx = dmax(mx, fabs(v));
      }
#pragma unroll
      for (int o = 16; o > 0; o >>= 1) mx = dmax(mx, __shfl_xor_sync(0xffffffffu, mx, o));
      const double sc = mx == 0.0 ? 1.0 : mx, rsc = 1.0 / sc;
      if (lane == 0) *prog = kbot;
      __syncwarp();
      const int chunk = (len + 31) / 32;
      const int lo = min(lane * chunk, len), hi = min(lo + chunk, len);
      double part = 0.0;
      int sg = 0;
      for (int r = hi - 1; r >= lo; --r) {
        const double v = xs[r] * rsc;
        part += v * v;
        if (xs[r] != 0.0) sg = xs[r] > 0.0 ? 1 : -1;
      }
      // suffix scans over the lanes: the sum of the squares and the sign
      // of the first nonzero, then shifted by a lane (exclusive)
      double inc = part;
      int sgi = sg;
#pragma unroll
      for (int o = 1; o < 32; o <<= 1) {
        const double t = __shfl_down_sync(0xffffffffu, inc, o);
        const int ts = __shfl_down_sync(0xffffffffu, sgi, o);
        if (lane + o < 32) {
          inc += t;
          if (sgi == 0) sgi = ts;
        }
      }
      double acc = __shfl_down_sync(0xffffffffu, inc, 1);
      int sgn = __shfl_down_sync(0xffffffffu, sgi, 1);
      if (lane == 31) {
        acc = 0.0;
        sgn = 0;
      }
      // the carried entries g_r of the chunk first (a chain of additions
      // only), then its rotations, independent of each other
      for (int r = hi - 1; r >= lo; --r) {
        const double xr = xs[r], v = xr * rsc;
        acc += v * v;
        if (xr != 0.0) sgn = xr > 0.0 ? 1 : -1;
        const double g = sgn < 0 ? -sc * sqrt(acc) : sc * sqrt(acc);
        if (r >= 1) {
          ls[j + 1 + r] = g;     // g_r, until its rotation replaces it
        } else if (j < 0) {
          beta[0] = g;
        } else {
          S[(size_t)(j + 1) * W + j] = g;
        }
      }
      for (int r = max(lo, 1); r < hi; ++r) {
        const int k = j + 1 + r;
        double c, s;
        givens_rs(xs[r - 1] * rsc, ls[k] * rsc, c, s);
        lc[k] = c;
        ls[k] = s;
        double* e = logp + 4 * log_pos(kbot, m, k);
        e[0] = c;
        e[1] = s;
      }
      if (j >= 0)
        for (int r = 1 + lane; r < len; r += 32) S[(size_t)(j + 1 + r) * W + j] = 0.0;
    }
    __syncthreads();
    // -- B: the left rotations on S's and T's columns, a thread a column
    {
      const int c0 = j + 1 > 0 ? j + 1 : 0, nc = kbot - c0;
      for (int t = tid; t < 2 * nc; t += kThreads) {
        auto rot = [&](int k, double& c, double& s) {
          c = lc[k];
          s = ls[k];
        };
        if (t < nc) {
          walk(S + c0 + t, W, kbot - 1, kmin, rot);
        } else {
          const int c = c0 + t - nc;
          walk(Tp + poff(c), 1, min(c + 1, kbot - 1), kmin, rot);
        }
      }
    }
    __syncthreads();
    if (warp == 0) {
      // -- C: the right chain on T's rows j+1 .. k, warp 0: every lane
      // forms each rotation, a lane a row updates the column pair; a
      // tile's 32 rotations are published at once to the other warps
      const int rlo = j + 1 > 0 ? j + 1 : 0;
      int ok = poff(kbot - 1);
      for (int k = kbot - 1; k >= kmin; --k) {
        double* ck = Tp + ok;
        double* cm = Tp + ok - (k + 1);      // poff(k - 1)
        double cr, sr;
        givens_rs(ck[k], cm[k], cr, sr);
        __syncwarp();   // every lane has read the pair before row k is written
        switch ((k - rlo) / 32) {
          case 0: chain_rows<1>(cm, ck, rlo, k, cr, sr, lane); break;
          case 1: chain_rows<2>(cm, ck, rlo, k, cr, sr, lane); break;
          case 2: chain_rows<3>(cm, ck, rlo, k, cr, sr, lane); break;
          case 3: chain_rows<4>(cm, ck, rlo, k, cr, sr, lane); break;
          case 4: chain_rows<5>(cm, ck, rlo, k, cr, sr, lane); break;
          case 5: chain_rows<6>(cm, ck, rlo, k, cr, sr, lane); break;
          default:
            for (int r0 = rlo; r0 <= k; r0 += 6 * 32)
              chain_rows<6>(cm, ck, r0, k, cr, sr, lane);
        }
        if (lane == 0) {
          rc[k] = cr;
          rs[k] = sr;
          double* e = logp + 4 * log_pos(kbot, m, k);
          e[2] = cr;
          e[3] = sr;
          if ((kbot - k) % 32 == 31 || k == kmin) {   // a tile's rotations are out
            __threadfence_block();
            *prog = k;
          }
        }
        __syncwarp();
        ok -= k + 1;
      }
    } else if (warp <= kTileWarps) {
      // -- D (behind the chain): the right rotations on S's rows, a tile
      // of 32 columns once the chain has passed it
      for (int gq = warp - 1; gq * 32 < kbot; gq += kTileWarps)
        rsweep_tile(S, W, gq * 32, min(32, kbot - gq * 32), kbot, kmin, rc, rs,
                    tiles + (warp - 1) * kTile, prog);
    } else {
      // ... and on T's rows 0 .. j, a lane a row, a tile's rotations at a
      // time (kbot - 32 t .. kbot - 32 t - 31)
      const int nw = kWarps - 1 - kTileWarps;
      for (int r0 = (warp - 1 - kTileWarps) * 32; r0 <= j; r0 += nw * 32) {
        const int r = r0 + lane;
        int ok = poff(kbot - 1);
        double y = r <= j ? Tp[ok + r] : 0.0;
        for (int t = 0; min(kbot - 32 * t, kbot - 1) >= kmin; ++t) {
          const int k1 = min(kbot - 32 * t, kbot - 1), k0 = max(kbot - 32 * t - 31, kmin);
          wait_chain(prog, k0);
          for (int k = k1; k >= k0; --k) {
            const int om = ok - (k + 1);
            if (r <= j) {
              const double a = Tp[om + r];
              Tp[ok + r] = rs[k] * a + rc[k] * y;
              y = rc[k] * a - rs[k] * y;
            }
            ok = om;
          }
        }
        if (r <= j) Tp[ok + r] = y;
      }
    }
    __syncthreads();
  }
  // T's leading block back, its lower triangle zero
  for (int e = tid; e < kbot * kbot; e += kThreads) {
    const int r = e / kbot, c = e % kbot;
    Tg[(size_t)r * W + c] = r <= c ? Tp[poff(c) + r] : 0.0;
  }
}

// task kinds of the replay: the vector, the log's half
enum { kQRow, kZRow, kSRow, kTRow, kSCol, kTCol, kKinds };

__global__ void __launch_bounds__(32)
ht_win_replay_kernel(double* __restrict__ S, double* __restrict__ T,
                     double* __restrict__ Q, double* __restrict__ Z,
                     const double* __restrict__ logp, int W, int kbot, int ld,
                     int nbq, int nbs, int nv) {
  // nv > 0: nv vectors a block staged in shared memory; nv = 0: 32 in place
  extern __shared__ double sm[];
  double* cs = sm;                 // the cascade's (c, s) by k: 2 kbot
  double* buf = cs + 2 * kbot;     // nv vectors, stride ld
  const int lane = threadIdx.x, per = nv > 0 ? nv : 32;
  // the block's kind and first index
  int b = blockIdx.x, kind = 0;
  while (kind < kKinds - 1 && b >= (kind <= kZRow ? nbq : nbs))
    b -= kind++ <= kZRow ? nbq : nbs;
  const bool rowk = kind <= kTRow, left = kind == kQRow || kind == kSCol || kind == kTCol;
  const int base = (kind == kQRow || kind == kZRow) ? 0 : kbot;
  const int i0 = base + per * b, cnt = min(per, W - i0);
  double* M = kind == kQRow ? Q : kind == kZRow ? Z : (kind == kSRow || kind == kSCol) ? S : T;
  // the lane's vector: a row kind's row (lane a row) or a column kind's
  // column; staged loads and stores coalesced (a row kind's along its rows)
  double* v = nullptr;
  long long vs = 1;
  if (nv > 0) {
    v = buf + lane * ld;
    if (rowk) {
      for (int rr = 0; rr < cnt; ++rr)
        for (int e = lane; e < kbot; e += 32) buf[rr * ld + e] = M[(size_t)(i0 + rr) * W + e];
    } else {
      for (int e = 0; e < kbot; ++e)
        if (lane < cnt) v[e] = M[(size_t)e * W + i0 + lane];
    }
  } else if (lane < cnt) {
    v = rowk ? M + (size_t)(i0 + lane) * W : M + i0 + lane;
    vs = rowk ? 1 : W;
  }
  __syncwarp();
  const int off = left ? 0 : 2;
  const double sg = left ? 1.0 : -1.0;   // the right rotations' -sr
  for (int m = 0; m <= kbot - 2; ++m) {
    const int kmin = m + 1;
    if (nv > 0) {
      // the cascade's (c, s) staged by k, each lane's vector walked with a
      // batch of kPre loads from shared memory
      for (int k = kbot - 1 - lane; k >= kmin; k -= 32) {
        const double* e = logp + 4 * log_pos(kbot, m, k) + off;
        cs[2 * k] = e[0];
        cs[2 * k + 1] = sg * e[1];
      }
      __syncwarp();
      if (lane < cnt) {
        double y = v[kbot - 1];
        for (int k0 = kbot - 1; k0 >= kmin; k0 -= kPre) {
          double a[kPre];
#pragma unroll
          for (int u = 0; u < kPre; ++u) a[u] = k0 - u >= kmin ? v[k0 - u - 1] : 0.0;
#pragma unroll
          for (int u = 0; u < kPre; ++u) {
            const int k = k0 - u;
            if (k >= kmin) {
              const double c = cs[2 * k], s = cs[2 * k + 1];
              v[k] = -s * a[u] + c * y;
              y = c * a[u] + s * y;
            }
          }
        }
        v[kmin - 1] = y;
      }
      __syncwarp();
    } else if (lane < cnt) {
      // in place, the rotations read from the log (log_pos falls by one a k)
      const double* P = logp + 4 * log_pos(kbot, m, 0) + off;
      walk(v, vs, kbot - 1, kmin, [&](int k, double& c, double& s) {
        c = P[-4 * k];
        s = sg * P[1 - 4 * k];
      });
    }
  }
  if (nv > 0) {
    if (rowk) {
      for (int rr = 0; rr < cnt; ++rr)
        for (int e = lane; e < kbot; e += 32) M[(size_t)(i0 + rr) * W + e] = buf[rr * ld + e];
    } else {
      for (int e = 0; e < kbot; ++e)
        if (lane < cnt) M[(size_t)e * W + i0 + lane] = v[e];
    }
  }
}

// the chain kernel's dynamic shared memory: the tiles, the cascade's
// vectors where v_shared, T's packed block where t_shared
size_t chain_smem(int kbot, bool v_shared, bool t_shared) {
  size_t d = (size_t)kTileWarps * kTile;
  if (v_shared) d += 5 * (size_t)kbot;
  if (t_shared) d += (size_t)poff(kbot);
  return d * sizeof(double);
}

// budget: the bytes of shared memory the launch may give to what grows
// with kbot
cudaError_t launch_chain(cudaStream_t st, double* S, double* T, const double* Q,
                         double* Tscratch, double* logp, int W, int kbot, double s,
                         double* beta, size_t budget) {
  const size_t fixed = chain_smem(kbot, false, false);
  const bool v_shared = chain_smem(kbot, true, false) - fixed <= budget;
  const bool t_shared = v_shared && chain_smem(kbot, true, true) - fixed <= budget;
  const size_t csm = chain_smem(kbot, v_shared, t_shared);
  cudaError_t e = cudaFuncSetAttribute(ht_win_chain_kernel,
                                       cudaFuncAttributeMaxDynamicSharedMemorySize,
                                       (int)csm);
  if (e != cudaSuccess) return e;
  ht_win_chain_kernel<<<1, kThreads, csm, st>>>(S, T, Q, Tscratch, logp, W, kbot, s, beta,
                                                v_shared ? 1 : 0, t_shared ? 1 : 0);
  return cudaGetLastError();
}

}  // namespace

// S, T, Q, Z: the (W, W) window, row-major, updated in place; Tscratch:
// poff(kbot) + 5 kbot doubles (T's block and the cascade's vectors where
// they do not fit shared memory); logp: 4 kbot (kbot - 1) / 2 doubles;
// beta: one double; smem_cap: the most bytes of shared memory a launch
// gives to what grows with kbot (<= 0: as much as the card allows; a
// smaller cap puts the same work in global memory, as a large kbot does)
extern "C" int ht_recondense(void* S, void* T, void* Q, void* Z, void* Tscratch,
                             void* logp, int W, int kbot, double s, void* beta,
                             int smem_cap, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (kbot < 0 || kbot > W) return static_cast<int>(cudaErrorInvalidValue);
  size_t cap = kSmemMax - 1024;   // the chain's static shared memory too
  if (smem_cap > 0 && (size_t)smem_cap < cap) cap = smem_cap;
  double* Sd = static_cast<double*>(S);
  double* Td = static_cast<double*>(T);
  const double* Qd = static_cast<const double*>(Q);
  double* Ts = static_cast<double*>(Tscratch);
  double* lg = static_cast<double*>(logp);
  double* bt = static_cast<double*>(beta);
  const size_t tiles = chain_smem(kbot, false, false);
  cudaError_t e = launch_chain(st, Sd, Td, Qd, Ts, lg, W, kbot, s, bt,
                               cap < kSmemMax - 1024 - tiles ? cap : kSmemMax - 1024 - tiles);
  if (e != cudaSuccess || kbot < 2) return static_cast<int>(e);
  // the replay: as many staged vectors a block as fit beside the rotations
  const int ld = kbot | 1;
  const long long room = (long long)(cap / sizeof(double)) - 2LL * kbot;
  const int nv = room < ld ? 0 : room / ld < 32 ? (int)(room / ld) : 32;
  const int per = nv > 0 ? nv : 32;
  const size_t rsm = nv > 0 ? (2 * (size_t)kbot + (size_t)nv * ld) * sizeof(double) : 0;
  const int nb0 = (W + per - 1) / per, nb2 = (W - kbot + per - 1) / per;
  const int nblk = 2 * nb0 + 4 * nb2;
  e = cudaFuncSetAttribute(ht_win_replay_kernel,
                           cudaFuncAttributeMaxDynamicSharedMemorySize, (int)rsm);
  if (e != cudaSuccess) return static_cast<int>(e);
  ht_win_replay_kernel<<<nblk, 32, rsm, st>>>(Sd, Td, static_cast<double*>(Q),
                                              static_cast<double*>(Z), lg, W, kbot, ld,
                                              nb0, nb2, nv);
  return static_cast<int>(cudaGetLastError());
}
