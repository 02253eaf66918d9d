// G5: the window chase of the multishift QZ's infinite-eigenvalue push, one
// window in one block.
//
// Replaces the XLA fori_loop of starneig_tpu/ops/qz_driver.py:
// _inf_chase_kernel (:329).  Plain twin: ops/qz_driver.py:_inf_chase_kernel.
//
// The window (H Hessenberg, T upper triangular, Wb x Wb) has a negligible
// T-diagonal entry at jrel; step i = jrel .. mrel-2 moves it one row down:
// a left rotation from T's pair (T[i, i+1], T[i+1, i+1]) on rows i, i+1 of
// H and T (and columns of Qw) zeroes T[i+1, i+1] (planted: T[i, i+1] = r,
// T[i+1, i+1] = T[i+1, i] = 0), then a right reflection
// [[-sr, cr], [cr, sr]] from H's fill pair (H[i+1, i-1], H[i+1, i]) on
// columns i-1, i of H, T and Zw restores H's Hessenberg form (planted:
// H[i+1, i] = rr, H[i+1, i-1] = 0), except at step lrel (the decoupled
// segment top, where no fill arises).  At i = 0 both columns of the
// reflection are column 0, and the second write wins, as in the twin.
//
// What bounds it on the H100: the chain of 2 (Wb - 1) rotations, each
// formed from entries the previous one updates; the updates are O(Wb) a
// rotation.  Design: the H and T windows live in shared memory (leading
// dimension Wb + 1 against bank conflicts; 2 x 72.8 KB at Wb = 96), one
// chase warp runs every step with no block barrier, __syncwarp only, and
// four update warps follow it through a record of every step (c, s, cr,
// sr; 128 steps fit, so the chase never waits for them):
//   * every lane of the chase warp forms each rotation itself, by one
//     reciprocal square root (givens_rs; the twin's formulas where an entry
//     is zero or a square would leave the normal range), so none waits on
//     a broadcast; the next step's left rotation reads T only where this
//     step's reflection does not write, so it is formed beside the
//     reflection (two independent chains);
//   * the chase warp updates rows i, i+1 where they can be nonzero (H from
//     column i-1, T from column i+1: Hessenberg and triangular form and the
//     exact plants; a lane a column), and columns i-1, i of the rows near
//     the step (i-31 .. i+1; a lane a row), all its loads before its
//     stores; the lane that owns a planted entry plants it after its own
//     update (a reflection skipped inside the chase, lrel > jrel, leaves
//     H's fill: such a window takes full rows and columns);
//   * the update warps take what no later rotation reads: columns i-1, i
//     of the rows far above the step (each row passes from the chase to
//     them once, in order), and Qw and Zw, which start as the identity, so
//     at step i a row's entry in the column the rotation carries on (Qw's
//     i+1, Zw's i) is the identity's: a lane a row keeps its row's carried
//     entry in a register and stores the column the step finishes, for
//     the rows the chase has reached, as a row of Qw^T (Zw^T): coalesced.
// The rotations are the twin's to rounding (within 1e-12 max|M| of it);
// the exact zeros are planted as the twin plants them.  The whole block
// stages the window (8 loads in flight a thread) and writes it back to
// the outputs, so the wrapper copies nothing.
#include "common.cuh"

namespace {

constexpr int kThreads = 512;
constexpr int kMaxQ = 4;    // rows (columns) a lane at Wb <= 128
constexpr int kLoad = 8;    // loads a thread keeps in flight staging the window
constexpr int kUpd = 4;     // update warps: warp 1 + u owns rows 32 u .. 32 u + 31
constexpr int kNear = 32;   // rows i - 31 .. i + 1: the chase's column updates
constexpr int kRec = 5;     // a step's record: c, s, cr, sr, reflected

// the reflection (cr, sr) on columns im1, i of the rows rnear .. hhi of H
// and rnear .. thi of T (NQ rows a lane), all loads before the stores;
// the owner of row i + 1 plants H's entries there
template <int NQ>
DEVI void near_columns(double* sH, double* sT, int ld, int i, int im1, int rnear, int hhi,
                       int thi, double cr, double sr, double rr, int lane) {
  double ha[NQ], hb[NQ], ta[NQ], tb[NQ];
#pragma unroll
  for (int q = 0; q < NQ; ++q) {
    const int r = rnear + lane + 32 * q;
    ha[q] = r <= hhi ? sH[r * ld + im1] : 0.0;
    hb[q] = r <= hhi ? sH[r * ld + i] : 0.0;
    ta[q] = r <= thi ? sT[r * ld + im1] : 0.0;
    tb[q] = r <= thi ? sT[r * ld + i] : 0.0;
  }
#pragma unroll
  for (int q = 0; q < NQ; ++q) {
    const int r = rnear + lane + 32 * q;
    if (r <= hhi) {
      if (im1 == i) {
        sH[r * ld + i] = cr * ha[q] + sr * hb[q];
      } else {
        sH[r * ld + im1] = -sr * ha[q] + cr * hb[q];
        sH[r * ld + i] = cr * ha[q] + sr * hb[q];
      }
      if (r == i + 1) {   // the plants, in the twin's order
        sH[r * ld + i] = rr;
        sH[r * ld + im1] = 0.0;
      }
    }
    if (r <= thi) {
      if (im1 == i) {
        sT[r * ld + i] = cr * ta[q] + sr * tb[q];
      } else {
        sT[r * ld + im1] = -sr * ta[q] + cr * tb[q];
        sT[r * ld + i] = cr * ta[q] + sr * tb[q];
      }
    }
  }
}

__global__ void __launch_bounds__(kThreads)
inf_chase_kernel(const double* Hin, const double* Tin, double* H, double* T,
                 double* __restrict__ QT, double* __restrict__ ZT, int Wb,
                 int jrel, int mrel, int lrel) {
  extern __shared__ double smem[];
  __shared__ double rec[128 * kRec];
  __shared__ int s_pub;
  const int ld = Wb + 1, nn = Wb * Wb;
  double* sH = smem;
  double* sT = smem + (size_t)Wb * ld;
  volatile int* pub = &s_pub;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  for (int e0 = tid; e0 < nn; e0 += kThreads * kLoad) {
    double h[kLoad], t[kLoad];
#pragma unroll
    for (int u = 0; u < kLoad; ++u) {
      const int e = e0 + u * kThreads;
      h[u] = e < nn ? Hin[e] : 0.0;
      t[u] = e < nn ? Tin[e] : 0.0;
    }
#pragma unroll
    for (int u = 0; u < kLoad; ++u) {
      const int e = e0 + u * kThreads;
      if (e < nn) {
        const int r = e / Wb, c = e - r * Wb;
        sH[r * ld + c] = h[u];
        sT[r * ld + c] = t[u];
        QT[e] = r == c ? 1.0 : 0.0;
        ZT[e] = r == c ? 1.0 : 0.0;
      }
    }
  }
  if (tid == 0) s_pub = 0;
  __syncthreads();
  const int i0 = jrel, last = mrel - 2;
  // a reflection skipped inside the chase (lrel > jrel; the push's windows
  // have lrel = jrel or -1) leaves H's fill: the full ranges
  const bool full = lrel > jrel;
  if (warp == 0) {
    // -- the chase: every step's rotations, the row updates, the column
    // updates of the near rows (the others never feed back)
    if (lane == 0) sT[jrel * ld + jrel] = 0.0;   // after the staging barrier
    __syncwarp();
    double c = 1.0, s = 0.0, rl = 0.0;
    if (i0 <= last) givens_rs(sT[i0 * ld + i0 + 1], sT[(i0 + 1) * ld + i0 + 1], c, s, rl);
    for (int i = i0; i <= last; ++i) {
      const int i1 = i + 1;
      const int hlo = full ? 0 : (i - 1 > 0 ? i - 1 : 0), tlo = full ? 0 : i1;
      {
        double h0[kMaxQ], h1[kMaxQ], t0[kMaxQ], t1[kMaxQ];
#pragma unroll
        for (int q = 0; q < kMaxQ; ++q) {
          const int ch = hlo + lane + 32 * q, ct = tlo + lane + 32 * q;
          h0[q] = ch < Wb ? sH[i * ld + ch] : 0.0;
          h1[q] = ch < Wb ? sH[i1 * ld + ch] : 0.0;
          t0[q] = ct < Wb ? sT[i * ld + ct] : 0.0;
          t1[q] = ct < Wb ? sT[i1 * ld + ct] : 0.0;
        }
#pragma unroll
        for (int q = 0; q < kMaxQ; ++q) {
          const int ch = hlo + lane + 32 * q, ct = tlo + lane + 32 * q;
          if (ch < Wb) {
            sH[i * ld + ch] = c * h0[q] + s * h1[q];
            sH[i1 * ld + ch] = -s * h0[q] + c * h1[q];
          }
          if (ct < Wb) {
            sT[i * ld + ct] = c * t0[q] + s * t1[q];
            sT[i1 * ld + ct] = -s * t0[q] + c * t1[q];
            if (ct == i1) {   // the plants, by the owner of each column
              sT[i * ld + i1] = rl;
              sT[i1 * ld + i1] = 0.0;
            } else if (ct == i) {
              sT[i1 * ld + i] = 0.0;
            }
          }
        }
        if (!full && lane == 0) sT[i1 * ld + i] = 0.0;   // column i: no lane's
      }
      __syncwarp();
      // the next step's left rotation (T's rows i1, i1+1 from column i1+1,
      // which this reflection does not touch) beside this one's reflection
      // (H's row i1 after the left rotation)
      const bool refl = i != lrel;
      const int im1 = i - 1 > 0 ? i - 1 : 0;
      double cr = 1.0, sr = 0.0, rr = 0.0, cn = c, sn = s, rn = rl;
      if (refl) givens_rs(sH[i1 * ld + im1], sH[i1 * ld + i], cr, sr, rr);
      if (i1 <= last) givens_rs(sT[i1 * ld + i1 + 1], sT[(i1 + 1) * ld + i1 + 1], cn, sn, rn);
      __syncwarp();   // every lane has read H's pair before it is written
      if (refl) {
        // columns im1, i of the near rows: H's rnear .. i1, T's rnear .. i
        const int rnear = i - (kNear - 1) > 0 ? i - (kNear - 1) : 0;
        if (full)
          near_columns<kMaxQ>(sH, sT, ld, i, im1, rnear, Wb - 1, Wb - 1, cr, sr, rr, lane);
        else
          near_columns<2>(sH, sT, ld, i, im1, rnear, i1, i, cr, sr, rr, lane);
      }
      if (lane == 0) {   // the step's record, for the update warps (4 at a time)
        double* e = rec + (i - i0) * kRec;
        e[0] = c;
        e[1] = s;
        e[2] = cr;
        e[3] = sr;
        e[4] = refl ? 1.0 : 0.0;
        if ((i - i0) % 4 == 3 || i == last) {
          __threadfence_block();
          *pub = i - i0 + 1;
        }
      }
      c = cn;
      s = sn;
      rl = rn;
      __syncwarp();
    }
  } else if (warp <= kUpd) {
    // -- an update warp: rows r = 32 (warp - 1) + lane, behind the chase:
    // Qw's and Zw's rows (the entry of the column the step carries on in a
    // register), and H's and T's columns im1, i where the row is far
    // above the step (r < i - 31: no later rotation reads it)
    const int r = 32 * (warp - 1) + lane;
    const int zlo = jrel - 1 > 0 ? jrel - 1 : 0;
    double qv = r == i0 ? 1.0 : 0.0, zv = r == i0 - 1 ? 1.0 : 0.0;
    for (int i = i0; i <= last; ++i) {
      while (*pub <= i - i0) __nanosleep(32);
      __threadfence_block();
      const double* e = rec + (i - i0) * kRec;
      const double c = e[0], s = e[1], cr = e[2], sr = e[3];
      const bool refl = e[4] != 0.0;
      const int i1 = i + 1;
      {
        const double a = r == i1 ? 1.0 : 0.0;
        const double nq = c * qv + s * a;
        qv = -s * qv + c * a;
        if (r >= i0 && r <= i1) QT[(size_t)i * Wb + r] = nq;
      }
      const double a = r == i ? 1.0 : 0.0;
      if (!refl) {
        if (i > 0 && r >= zlo && r <= i) ZT[(size_t)(i - 1) * Wb + r] = zv;
        zv = a;
        continue;
      }
      if (i == 0) {
        zv = cr * a + sr * a;
      } else {
        if (r >= zlo && r <= i) ZT[(size_t)(i - 1) * Wb + r] = -sr * zv + cr * a;
        zv = cr * zv + sr * a;
      }
      if (r < i - (kNear - 1)) {   // far: i >= 32, so im1 = i - 1
        const int hhi = full ? Wb - 1 : i1, thi = full ? Wb - 1 : i;
        if (r <= hhi) {
          const double x = sH[r * ld + i - 1], y = sH[r * ld + i];
          sH[r * ld + i - 1] = -sr * x + cr * y;
          sH[r * ld + i] = cr * x + sr * y;
        }
        if (r <= thi) {
          const double x = sT[r * ld + i - 1], y = sT[r * ld + i];
          sT[r * ld + i - 1] = -sr * x + cr * y;
          sT[r * ld + i] = cr * x + sr * y;
        }
      }
    }
    if (i0 <= last) {
      if (r >= i0 && r <= last + 1) QT[(size_t)(last + 1) * Wb + r] = qv;
      if (r >= zlo && r <= last) ZT[(size_t)last * Wb + r] = zv;
    }
  }
  __syncthreads();
  for (int e = tid; e < nn; e += kThreads) {
    const int r = e / Wb, c = e - r * Wb;
    H[e] = sH[r * ld + c];
    T[e] = sT[r * ld + c];
  }
}

}  // namespace

// Hin, Tin: the window (read); H, T: its chased copy (written; they may
// be Hin, Tin); QT, ZT: the window transforms Qw, Zw transposed (written)
extern "C" int inf_chase(const void* Hin, const void* Tin, void* H, void* T, void* QT,
                         void* ZT, int Wb, int jrel, int mrel, int lrel, void* stream) {
  const size_t smem = 2 * (size_t)Wb * (Wb + 1) * sizeof(double);
  if (Wb < 2 || Wb > 32 * kMaxQ || smem > 227 * 1024 || jrel < 0 || jrel >= Wb ||
      mrel > Wb)
    return static_cast<int>(cudaErrorInvalidValue);
  static size_t configured = 0;
  if (smem > 48 * 1024 && smem > configured) {
    cudaError_t e = cudaFuncSetAttribute(
        inf_chase_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return static_cast<int>(e);
    configured = smem;
  }
  inf_chase_kernel<<<1, kThreads, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const double*>(Hin), static_cast<const double*>(Tin),
      static_cast<double*>(H), static_cast<double*>(T), static_cast<double*>(QT),
      static_cast<double*>(ZT), Wb, jrel, mrel, lrel);
  return static_cast<int>(cudaGetLastError());
}
