// G3: one hop (3B steps) of a B-bulge QZ train inside its (6B+4)-row window.
//
// Replaces the XLA fori_loop of starneig_tpu/ops/qz_driver.py:
// _qz_sweep_chunk (:444, run by _qz_sweep_batch :432 and _qz_iter :953-980),
// which updates full rows and columns of the padded pencil at every step.
// Plain twin: ops/qz_driver.py:_qz_train_hop; the driver's _qz_sweep runs
// a train as hops in windows and applies each window's transforms to the
// off-window strips and to Q, Z with GEMMs, as the SEP sweep does
// (ops/schur.py:_sweep_wave with train_hops.cu).
//
// Per step and active bulge b (k = l_rel + s - 3b): a left 3-reflector on
// rows k..k+2 of S and T (from the shifted product's first column at the
// bulge's introduction, else from the bulge column k-1), the bulge column
// planted, a right 3-reflector from T's row k+2 zeroing T[k+2, k:k+2], and a
// right rotation zeroing T[k+1, k]; Qw and Zw accumulate.  The bulges of a
// step touch disjoint row and column triples, so each phase runs for all of
// them at once.
//
// What bounds it on the H100: the step chain (3B steps a hop, each three
// dependent transforms a bulge), not flops or bytes.  Design, simple first:
// one block a window, S, T, Qw and Zw in shared memory (4 x 46 KB at the
// driver's B = 12, WC = 76), one thread a bulge for the reflectors and
// rotations, the block for their updates at window width, a barrier between
// phases.
#include "gep_common.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kMaxB = 13;  // WC = 6B+4 <= 82: four WC x WC buffers fit one block

struct Bulge {
  double v[3], tau, beta, vr[3], taur, c2, s2;
  int k, b;  // the bulge's row, its index in the train (its shift row)
  bool use3, intro;
};

__global__ void __launch_bounds__(kThreads)
qz_sweep_kernel(double* __restrict__ Sg, double* __restrict__ Tg,
                double* __restrict__ Qg, double* __restrict__ Zg,
                const double* __restrict__ shifts, int WC, int B, int HOP,
                int l_rel, int ihi_rel, int s0) {
  extern __shared__ double smem[];
  double* S = smem;
  double* T = S + WC * WC;
  double* Qw = T + WC * WC;
  double* Zw = Qw + WC * WC;
  __shared__ Bulge bl[kMaxB];
  __shared__ int s_nact;
  const int tid = threadIdx.x, nt = blockDim.x;
  const int n2 = WC * WC;
  for (int e = tid; e < n2; e += nt) {
    S[e] = Sg[e];
    T[e] = Tg[e];
    const double one = (e / WC == e % WC) ? 1.0 : 0.0;
    Qw[e] = one;
    Zw[e] = one;
  }
  __syncthreads();

  for (int t = 0; t < HOP; ++t) {
    const int s = s0 + t;
    __syncthreads();  // the previous step's bulge list has been read
    // active bulges, in order of b; bulge b acts at k = l_rel + s - 3b
    if (tid == 0) {
      int na = 0;
      for (int b = 0; b < B; ++b) {
        const int k = l_rel + s - 3 * b;
        if (k >= l_rel && k <= ihi_rel - 2) {
          bl[na].k = k;
          bl[na].use3 = k <= ihi_rel - 3;
          bl[na].intro = k == l_rel;
          bl[na].b = b;
          ++na;
        }
      }
      s_nact = na;
    }
    __syncthreads();
    const int na = s_nact;
    if (na == 0) continue;
    // ---- left reflectors, a thread a bulge ----
    if (tid < na) {
      Bulge& g = bl[tid];
      const int k = g.k;
      double x[3];
      if (g.intro) {
        first_col_qz(S, T, WC, l_rel, shifts + 4 * g.b, g.use3, true, x);
      } else {
        x[0] = S[k * WC + k - 1];
        x[1] = S[(k + 1) * WC + k - 1];
        x[2] = S[(k + 2) * WC + k - 1];
      }
      double beta;
      householder(x, g.use3 ? 7u : 3u, 3, g.v, g.tau, beta);
      g.beta = beta;
    }
    __syncthreads();
    // rows k..k+2 of S and T at column e % WC, and row e % WC of Qw at
    // columns k..k+2, for the bulge e / WC
    for (int e = tid; e < 3 * na * WC; e += nt) {
      const int part = e / (na * WC), f = e % (na * WC);
      const Bulge& g = bl[f / WC];
      const int x = f % WC, k = g.k;
      double *p0, *p1, *p2;
      if (part < 2) {
        double* M = part == 0 ? S : T;
        p0 = M + k * WC + x;
        p1 = p0 + WC;
        p2 = p1 + WC;
      } else {
        p0 = Qw + x * WC + k;
        p1 = p0 + 1;
        p2 = p0 + 2;
      }
      const double a = *p0, b = *p1, c = *p2;
      if (part < 2) {
        const double sdot = g.v[0] * a + g.v[1] * b + g.v[2] * c;
        *p0 = a - g.tau * (g.v[0] * sdot);
        *p1 = b - g.tau * (g.v[1] * sdot);
        *p2 = c - g.tau * (g.v[2] * sdot);
      } else {
        const double sdot = a * g.v[0] + b * g.v[1] + c * g.v[2];
        *p0 = a - g.tau * (sdot * g.v[0]);
        *p1 = b - g.tau * (sdot * g.v[1]);
        *p2 = c - g.tau * (sdot * g.v[2]);
      }
    }
    __syncthreads();
    // ---- bulge-column plants, right reflectors from T's row k+2 ----
    if (tid < na) {
      Bulge& g = bl[tid];
      const int k = g.k;
      if (!g.intro) {
        S[k * WC + k - 1] = g.beta;
        S[(k + 1) * WC + k - 1] = 0.0;
        if (g.use3) S[(k + 2) * WC + k - 1] = 0.0;
      }
      g.taur = 0.0;
      if (g.use3) {
        const double x[3] = {T[(k + 2) * WC + k + 2], T[(k + 2) * WC + k + 1],
                             T[(k + 2) * WC + k]};
        double v[3], beta;
        householder(x, 7u, 3, v, g.taur, beta);
        g.vr[0] = v[2];
        g.vr[1] = v[1];
        g.vr[2] = v[0];
      }
    }
    __syncthreads();
    for (int e = tid; e < 3 * na * WC; e += nt) {
      const int part = e / (na * WC), f = e % (na * WC);
      const Bulge& g = bl[f / WC];
      if (!g.use3) continue;
      double* M = part == 0 ? S : (part == 1 ? T : Zw);
      double* p = M + (f % WC) * WC + g.k;
      const double a = p[0], b = p[1], c = p[2];
      const double sdot = a * g.vr[0] + b * g.vr[1] + c * g.vr[2];
      p[0] = a - g.taur * (sdot * g.vr[0]);
      p[1] = b - g.taur * (sdot * g.vr[1]);
      p[2] = c - g.taur * (sdot * g.vr[2]);
    }
    __syncthreads();
    // ---- plants of T's row k+2, rotations zeroing T[k+1, k] ----
    if (tid < na) {
      Bulge& g = bl[tid];
      const int k = g.k;
      if (g.use3) {
        T[(k + 2) * WC + k] = 0.0;
        T[(k + 2) * WC + k + 1] = 0.0;
      }
      double r;
      givens(T[(k + 1) * WC + k + 1], T[(k + 1) * WC + k], g.c2, g.s2, r);
    }
    __syncthreads();
    for (int e = tid; e < 3 * na * WC; e += nt) {
      const int part = e / (na * WC), f = e % (na * WC);
      const Bulge& g = bl[f / WC];
      double* M = part == 0 ? S : (part == 1 ? T : Zw);
      const int r = f % WC;
      double* p = M + r * WC + g.k;
      const double a = p[0], b = p[1];
      p[0] = (part == 1 && r == g.k + 1) ? 0.0 : g.c2 * a - g.s2 * b;
      p[1] = g.s2 * a + g.c2 * b;
    }
    __syncthreads();
  }
  for (int e = tid; e < n2; e += nt) {
    Sg[e] = S[e];
    Tg[e] = T[e];
    Qg[e] = Qw[e];
    Zg[e] = Zw[e];
  }
}

}  // namespace

extern "C" int qz_sweep(void* S, void* T, void* Qw, void* Zw, void* shifts,
                        int WC, int B, int HOP, int l_rel, int ihi_rel, int s0,
                        void* stream) {
  if (B < 1 || B > kMaxB || WC != 6 * B + 4)
    return static_cast<int>(cudaErrorInvalidValue);
  const size_t smem = 4 * (size_t)WC * WC * sizeof(double);
  static size_t configured = 0;
  if (smem > 48 * 1024 && smem > configured) {
    cudaError_t e = cudaFuncSetAttribute(
        qz_sweep_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return static_cast<int>(e);
    configured = smem;
  }
  qz_sweep_kernel<<<1, kThreads, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<double*>(S), static_cast<double*>(T), static_cast<double*>(Qw),
      static_cast<double*>(Zw), static_cast<const double*>(shifts), WC, B, HOP,
      l_rel, ihi_rel, s0);
  return static_cast<int>(cudaGetLastError());
}
