// G1: the Hessenberg-triangular reduction, blocked.  Its window mode, the
// GEP AED recondense, is ht_recondense.cu.
//
// Replaces an XLA loop of the JAX package (no Pallas kernel there):
// starneig_tpu/ops/hess_triangular.py:_ht_reduce (:36), a double fori_loop
// over the ~n^2/2 rotation steps.  Plain twins:
// ops/hess_triangular.py:_ht_generate and _ht_slivers (the blocked form,
// held to the unblocked _ht_reduce).
//
// The cascade: for each column j, bottom-up for k >= j+2, a left rotation
// on rows (k-1, k) of A and B zeroes A[k, j]; it fills B[k, k-1], which a
// right rotation on columns (k-1, k) zeroes at once.  Cascade j's left
// rotations depend only on A's column j, which depends on every rotation
// of cascade j-1 (its right rotations chain through all columns to the
// right); its right rotation at k on B's row k swept by the cascade's
// right rotations below it.  So generation is a serial chain of ~n^2/2
// rotations on the whole trailing pencil.
//
// What bounds it on the H100: that chain's latency, and the O(n^3)
// rotation work around it (6 flops an entry a rotation; the trailing
// pencil moves ~n^3/2 entries in all), which one block walking a step at a
// time behind barriers cannot spread over the card.  Design
// (ops/hess_triangular.py's blocked form, dgghd3's blocking):
//   * ht_generate, a host loop over the block's cascades, four launches a
//     cascade, each with shared memory of a fixed size, so any n runs.
//     ht_lgen_kernel: one block generates the left rotations all at once
//     into the log (the chain's carried entry is a signed suffix norm of
//     A's column j, taken by suffix scans).  ht_lpass_kernel: a thread a
//     column applies them bottom-up to A's columns >= j and B's columns
//     >= j+1, reading neighbouring columns (coalesced), the carried entry
//     in a register, kPre loads ahead, the rotations staged kCs at a time.
//     ht_rchain_kernel: one block; the chain warp runs the right rotations
//     in chunks of 31 on a 32 x 32 band of B in shared memory (a lane a
//     row; every lane computes the rotation, by one reciprocal square
//     root, so none waits on a broadcast); the band's last column, row r
//     swept by the rotations below the chunk, is the dot product of B's row
//     r with the weights of that sweep (products of the sines, a global
//     vector), whose far part the helper warps take (coalesced) while the
//     chain warp runs the chunk before.
//     ht_rpass_kernel: a lane a row applies the cascade's right rotations
//     to A's and B's rows below the block's first row, right to left with
//     the carried entry in a register, 32 columns at a time staged through
//     the warp's tile in shared memory (coalesced loads and stores) beside
//     the tile's 32 rotations.
//   * ht_sliver_kernel: the deferred updates' factors.  A sliver is L
//     positions of each of the block's cascades, the window sliding a row
//     a cascade, so that rotations of different slivers that do not
//     commute keep their order; a block of threads accumulates one
//     sliver's left or right rotations into its dense factor of order L + nb
//     (a thread a row).  The host then applies the factors to Q, Z and the
//     rows above the block as matrix products.
#include "common.cuh"

namespace {

// -- the blocked reduction ----------------------------------------------------

constexpr int kPass = 64;      // threads a block of the left kernels
constexpr int kChain = 1024;   // threads of the right-chain block
constexpr int kBand = 32;      // band rows (a lane each): chunks of 31 rotations
constexpr int kBandLd = kBand + 1;

constexpr int kPre = 16;       // loads a walking thread keeps in flight
constexpr int kCs = 1024;      // left rotations a pass block stages at a time

// cascade j's left rotations into the log, one block.  The carried entry
// of the left chain (the column's entry k after the rotations below k, the
// g of k's rotation) is, but for rounding, sigma_k ||x[k:]||, sigma_k the
// sign of the first nonzero of x[k:], x = A[j+1 .., j]: suffix scans over
// the threads' chunks (scaled by max|x|), then every rotation at once with
// givens(x[k-1], g_k).  x is read from A where it lies; nothing is staged.
__global__ void __launch_bounds__(kPass)
ht_lgen_kernel(const double* __restrict__ A, double* __restrict__ rot, int n,
               int j, long long off) {
  __shared__ double s_part[kPass], s_red[kPass];
  __shared__ int s_sign[kPass];
  const int len = n - j - 1, tid = threadIdx.x;
  const double* x = A + (size_t)(j + 1) * n + j;   // x[r * n] = A[j+1+r, j]
  double mx = 0.0;
#pragma unroll 8
  for (int r = tid; r < len; r += kPass) mx = dmax(mx, fabs(x[(size_t)r * n]));
  s_red[tid] = mx;
  __syncthreads();
  mx = 0.0;
  for (int t = 0; t < kPass; ++t) mx = dmax(mx, s_red[t]);
  const double sc = mx == 0.0 ? 1.0 : mx;
  const int chunk = (len + kPass - 1) / kPass;
  const int c0 = min(tid * chunk, len), c1 = min(c0 + chunk, len);
  double part = 0.0;
  int sign = 0;
#pragma unroll 8
  for (int r = c1 - 1; r >= c0; --r) {
    const double xr = x[(size_t)r * n], v = xr / sc;
    part += v * v;
    if (xr != 0.0) sign = xr > 0.0 ? 1 : -1;
  }
  s_part[tid] = part;
  s_sign[tid] = sign;
  __syncthreads();
  double acc = 0.0;
  for (int t = kPass - 1; t > tid; --t) acc += s_part[t];
  sign = 0;
  for (int t = kPass - 1; t > tid; --t)
    if (s_sign[t] != 0) sign = s_sign[t];
#pragma unroll 4
  for (int r = c1 - 1; r >= c0; --r) {
    const double xr = x[(size_t)r * n], v = xr / sc;
    acc += v * v;
    if (xr != 0.0) sign = xr > 0.0 ? 1 : -1;
    if (r == 0) break;                    // g_0 is no rotation's
    const double g = sign < 0 ? -sc * sqrt(acc) : sc * sqrt(acc);
    const long long q = 4 * (off + n - 2 - j - r);   // k = j + 1 + r
    double c, sn, rr;
    givens(x[(size_t)(r - 1) * n], g, c, sn, rr);
    rot[q] = c;
    rot[q + 1] = sn;
  }
}

// cascade j's left rotations (from the log) on A's columns j .. n-1 (the
// zeros of column j planted) and B's columns j+1 .. n-1 (rows from
// min(c+1, n-1) up), a thread a column, bottom-up with the carried entry in
// a register and kPre loads ahead; the block stages kCs rotations at a time
__global__ void __launch_bounds__(kPass)
ht_lpass_kernel(double* __restrict__ A, double* __restrict__ B,
                const double* __restrict__ rot, int n, int j, long long off) {
  __shared__ double cs[2 * kCs];        // (c, s) of k = hi, hi-1, .. lo
  const int tid = threadIdx.x, gi = blockIdx.x * blockDim.x + tid, na = n - j;
  double* p = nullptr;
  int kmax = -1;
  if (gi < na) {
    p = A + j + gi;
    kmax = n - 1;
  } else if (gi < na + na - 1) {
    const int col = j + 1 + (gi - na);
    p = B + col;
    kmax = min(col + 1, n - 1);
  }
  const bool act = kmax >= j + 2, plant = gi == 0;
  double y = act ? p[(size_t)kmax * n] : 0.0;
  for (int hi = n - 1; hi >= j + 2; hi -= kCs) {
    const int lo = max(j + 2, hi - kCs + 1);
    __syncthreads();
    for (int e = tid; e <= hi - lo; e += blockDim.x) {
      const long long q = 4 * (off + n - 1 - (hi - e));
      cs[2 * e] = rot[q];
      cs[2 * e + 1] = rot[q + 1];
    }
    __syncthreads();
    if (!act) continue;
    for (int k0 = min(hi, kmax); k0 >= lo; k0 -= kPre) {
      double a[kPre];
#pragma unroll
      for (int u = 0; u < kPre; ++u)
        a[u] = k0 - u >= lo ? p[(size_t)(k0 - u - 1) * n] : 0.0;
#pragma unroll
      for (int u = 0; u < kPre; ++u) {
        const int k = k0 - u;
        if (k >= lo) {
          const double cc = cs[2 * (hi - k)], ss = cs[2 * (hi - k) + 1];
          p[(size_t)k * n] = plant ? 0.0 : -ss * a[u] + cc * y;
          y = cc * a[u] + ss * y;
        }
      }
    }
  }
  if (act) p[(size_t)(j + 1) * n] = y;
}

// givens' (c, s) by one reciprocal square root, inside the range where
// f^2 + g^2 neither overflows nor underflows (else givens itself): the same
// rotation to rounding, a third of the dependent latency
DEVI void givens_fast(double f, double g, double& c, double& s) {
  if (g == 0.0) {
    c = 1.0;
    s = 0.0;
    return;
  }
  if (f == 0.0) {
    c = 0.0;
    s = 1.0;
    return;
  }
  const double mx = dmax(fabs(f), fabs(g));
  if (mx > 1e150 || mx < 1e-150) {
    double r;
    givens(f, g, c, s, r);
    return;
  }
  const double rs = rsqrt(f * f + g * g);
  c = fabs(f) * rs;
  s = (f >= 0.0 ? g : -g) * rs;
}

// cascade j's right rotations from B (after the left pass), bottom-up in
// chunks of up to 31 on a band (rows and columns base .. khi) in shared
// memory; B itself is not written.  The band's last column is row r swept
// by the rotations below the chunk: the dot product of B's row r with the
// weights wgt (wgt[m] = cr_{m+1} prod_{q=khi+1}^{m} (-sr_q), wgt[n-1] the
// product alone; a global vector of n, so that shared memory stays fixed
// at any n).  While the chain warp runs a chunk, the helper warps stage
// the next chunk's band and the far part of its last column (the dot with
// the current weights, columns >= khi); after it, the chain warp adds the
// near part (columns base .. khi-1, with the chunk's new weights) and the
// helpers scale the tail of the weights by the chunk's product of sines:
// two block barriers a chunk.
__global__ void __launch_bounds__(kChain)
ht_rchain_kernel(const double* __restrict__ B, double* __restrict__ rot,
                 double* __restrict__ wgt, int n, int j, long long off) {
  __shared__ double bands[2 * kBand * kBandLd];   // the chunk's and the next
  __shared__ double nearb[kBand * kBandLd];
  __shared__ double s_cr[kBand], s_sr[kBand], s_far[kBand];
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  // the first chunk's band: its last column is column n-1 itself
  int khi = n - 1;
  int klo = max(j + 2, khi - (kBand - 2)), base = klo - 1;
  for (int e = tid; e < kBand * kBand; e += blockDim.x) {
    const int t = e / kBand, c = e % kBand;
    if (t <= khi - base && c <= khi - base)
      bands[t * kBandLd + c] = B[(size_t)(base + t) * n + base + c];
  }
  if (tid == 0) wgt[n - 1] = 1.0;
  __syncthreads();
  for (int par = 0;; par ^= 1) {
    double* cur = bands + par * kBand * kBandLd;
    double* nxt = bands + (par ^ 1) * kBand * kBandLd;
    const int khi2 = base, klo2 = max(j + 2, khi2 - (kBand - 2)), base2 = klo2 - 1;
    const bool more = base >= j + 2;
    if (warp == 0) {
      for (int k = khi; k >= klo; --k) {
        const int t = k - base;
        double cr, sr;
        givens_fast(cur[t * kBandLd + t], cur[t * kBandLd + t - 1], cr, sr);
        __syncwarp();
        if (lane <= t) {
          double* p = cur + lane * kBandLd + t - 1;
          const double a = p[0], b = p[1];
          p[0] = lane == t ? 0.0 : cr * a - sr * b;
          p[1] = sr * a + cr * b;
        }
        if (lane == 0) {
          s_cr[k - klo] = cr;
          s_sr[k - klo] = sr;
          rot[4 * (off + n - 1 - k) + 2] = cr;
          rot[4 * (off + n - 1 - k) + 3] = sr;
        }
        __syncwarp();
      }
    } else if (more) {
      // the next band's rows base2 .. khi2: columns base2 .. khi2-1, the
      // near columns base .. khi-1, the far dot over columns >= khi
      for (int t = warp - 1; t <= khi2 - base2; t += (kChain / 32) - 1) {
        const double* row = B + (size_t)(base2 + t) * n;
        if (lane < khi2 - base2) nxt[t * kBandLd + lane] = row[base2 + lane];
        if (lane < khi - base) nearb[t * kBandLd + lane] = row[base + lane];
        double acc = 0.0;
        for (int c = khi + lane; c < n; c += 32) acc += row[c] * wgt[c];
#pragma unroll
        for (int o = 16; o > 0; o >>= 1) acc += __shfl_down_sync(0xffffffffu, acc, o);
        if (lane == 0) s_far[t] = acc;
      }
    }
    __syncthreads();
    if (!more) break;
    if (warp == 0) {
      // the new weights of columns base .. khi-1 and the next band's last
      // column: near part + the chunk's product of sines times the far part
      double pre = 1.0, acc = 0.0;
      const int t = lane;
      for (int q = base; q < khi; ++q) {
        const double w = s_cr[q + 1 - klo] * pre;
        if (lane == 0) wgt[q] = w;
        if (t <= khi2 - base2) acc += nearb[t * kBandLd + q - base] * w;
        pre *= -s_sr[q + 1 - klo];
      }
      if (t <= khi2 - base2) nxt[t * kBandLd + khi2 - base2] = acc + pre * s_far[t];
    } else {
      double P = 1.0;
      for (int q = klo; q <= khi; ++q) P *= -s_sr[q - klo];
      for (int c = khi + tid - 32; c < n; c += blockDim.x - 32) wgt[c] *= P;
    }
    __syncthreads();
    khi = khi2;
    klo = klo2;
    base = base2;
  }
}

// cascade j's right rotations, a warp a tile of 32 rows (A's rows J0+1 ..
// n-1, columns j+1 ..; B's rows J0+1 .. n-1, columns from max(j+2, r) - 1,
// B's fill at (r, r-1) planted 0): the rows swept right to left a lane a
// row with the carried entry in a register, 32 columns at a time staged
// through the warp's tile with coalesced loads and stores, beside the
// tile's rotations (k = c0+1 .. c1) from the log
constexpr int kRpWarps = 2;
constexpr int kTile = 33;      // odd: conflict-free lane rows

__global__ void __launch_bounds__(32 * kRpWarps)
ht_rpass_kernel(double* __restrict__ A, double* __restrict__ B,
                const double* __restrict__ rot, int n, int j, int J0,
                long long off) {
  __shared__ double tiles[kRpWarps][32 * kTile];
  __shared__ double wcs[kRpWarps][64];  // (cr, sr) of k = c1, c1-1, ..
  const int lane = threadIdx.x & 31, wl = threadIdx.x >> 5;
  double* tile = tiles[wl];
  double* crs = wcs[wl];
  const int nr = n - J0 - 1, nt = (nr + 31) / 32;
  const int w = blockIdx.x * kRpWarps + wl;
  if (w >= 2 * nt) return;
  const bool isb = w >= nt;
  const int r0 = J0 + 1 + 32 * (isb ? w - nt : w);
  const int rows = min(32, n - r0);
  const int r = r0 + lane;
  const int kmin = r < n ? (isb ? max(j + 2, r) : j + 2) : n;   // none past n - 1
  const int lowest = (isb ? max(j + 2, r0) : j + 2) - 1;
  double* M = (isb ? B : A) + (size_t)r0 * n;
  double* trow = tile + lane * kTile;
  double y = 0.0;
  for (int c1 = n; c1 > lowest; c1 -= 32) {
    const int c0 = max(c1 - 32, lowest), nc = c1 - c0;
    {
      const int k = c1 - lane;
      if (k > c0 && k <= n - 1) {
        const long long q = 4 * (off + n - 1 - k) + 2;
        crs[2 * lane] = rot[q];
        crs[2 * lane + 1] = rot[q + 1];
      }
    }
    for (int rb = 0; rb < rows; rb += 8) {   // 8 loads a lane in flight
      double v[8];
#pragma unroll
      for (int u = 0; u < 8; ++u)
        v[u] = (rb + u < rows && lane < nc) ? M[(size_t)(rb + u) * n + c0 + lane] : 0.0;
#pragma unroll
      for (int u = 0; u < 8; ++u)
        if (rb + u < rows) tile[(rb + u) * kTile + lane] = v[u];
    }
    __syncwarp();
    if (c1 == n) y = trow[nc - 1];
    // steps k = c1 (its column is the previous tile's: written directly)
    // down to max(c0 + 1, kmin)
    for (int k = c1 == n ? n - 1 : c1; k > c0 && k >= kmin; --k) {
      const double cr = crs[2 * (c1 - k)], sr = crs[2 * (c1 - k) + 1];
      const double a = trow[k - 1 - c0];
      const double nk = sr * a + cr * y;
      if (k == c1) M[(size_t)lane * n + k] = nk;
      else trow[k - c0] = nk;
      y = cr * a - sr * y;
    }
    if (kmin - 1 >= c0 && kmin - 1 < c1 && kmin <= n - 1)
      trow[kmin - 1 - c0] = (isb && kmin == r) ? 0.0 : y;
    __syncwarp();
    for (int rr = 0; rr < rows; ++rr)
      if (lane < nc) M[(size_t)rr * n + c0 + lane] = tile[rr * kTile + lane];
    __syncwarp();
  }
}

// the dense factor of sliver blockIdx.x + 1 of block [J0, J1), left
// (blockIdx.y = 0) or right rotations, into U (row-major w x w, w = L + J1
// - J0, indices lo_nom .. lo_nom + w - 1): a thread a row of the factor,
// held transposed in shared memory
__global__ void ht_sliver_kernel(const double* __restrict__ rot,
                                 double* __restrict__ U_all, int n, int J0,
                                 int J1, int L) {
  extern __shared__ double ut[];        // w x w, ut[col * w + row]
  const int w = L + J1 - J0, s = blockIdx.x + 1, f = blockIdx.y;
  const int lo_nom = n - s * L - 1;
  const int r = threadIdx.x;
  for (int e = r; e < w * w; e += blockDim.x) ut[e] = (e % (w + 1)) == 0 ? 1.0 : 0.0;
  __syncthreads();
  if (r < w) {
    for (int j = J0; j < J1; ++j) {
      const long long off = (long long)j * (n - 2) - (long long)j * (j - 1) / 2;
      const int kmax = min(n - 1, n - (s - 1) * L + (j - J0) - 1);
      const int kmin = max(j + 2, n - s * L + (j - J0));
      for (int k = kmax; k >= kmin; --k) {
        const double* g = rot + 4 * (off + n - 1 - k) + 2 * f;
        const double c = g[0], sn = g[1];
        double* p = ut + (size_t)(k - 1 - lo_nom) * w + r;
        const double u0 = p[0], u1 = p[w];
        if (f == 0) {
          p[0] = c * u0 + sn * u1;
          p[w] = -sn * u0 + c * u1;
        } else {
          p[0] = c * u0 - sn * u1;
          p[w] = sn * u0 + c * u1;
        }
      }
    }
  }
  __syncthreads();
  double* U = U_all + ((size_t)blockIdx.x * 2 + f) * w * w;
  for (int e = threadIdx.x; e < w * w; e += blockDim.x) U[e] = ut[(e % w) * w + e / w];
}

}  // namespace

static cudaError_t smem_attr(const void* fn, size_t bytes) {
  if (bytes <= 48 * 1024) return cudaSuccess;
  return cudaFuncSetAttribute(fn, cudaFuncAttributeMaxDynamicSharedMemorySize,
                              (int)bytes);
}

// the generation of cascades J0 .. J1-1: four launches a cascade, shared
// memory of fixed size (any n); work: n doubles, the right chain's weights
extern "C" int ht_generate(void* A, void* B, void* rot, void* work, int n, int J0,
                           int J1, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  double* a = static_cast<double*>(A);
  double* b = static_cast<double*>(B);
  double* lg = static_cast<double*>(rot);
  double* wk = static_cast<double*>(work);
  for (int j = J0; j < J1; ++j) {
    if (j + 2 > n - 1) break;
    const long long off = (long long)j * (n - 2) - (long long)j * (j - 1) / 2;
    const int ncol = 2 * (n - j) - 1;
    ht_lgen_kernel<<<1, kPass, 0, st>>>(a, lg, n, j, off);
    ht_lpass_kernel<<<(ncol + kPass - 1) / kPass, kPass, 0, st>>>(a, b, lg, n, j, off);
    ht_rchain_kernel<<<1, kChain, 0, st>>>(b, lg, wk, n, j, off);
    const int ntile = 2 * ((n - J0 - 1 + 31) / 32);
    ht_rpass_kernel<<<(ntile + kRpWarps - 1) / kRpWarps, 32 * kRpWarps, 0, st>>>(
        a, b, lg, n, j, J0, off);
    const cudaError_t e = cudaGetLastError();
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  return 0;
}

// the factors of block [J0, J1)'s S slivers into U (S x 2 x w x w)
extern "C" int ht_slivers(void* rot, void* U, int n, int J0, int J1, int L,
                          int S, void* stream) {
  const int w = L + J1 - J0;
  const size_t smem = sizeof(double) * (size_t)w * w;
  cudaError_t e = smem_attr((const void*)ht_sliver_kernel, smem);
  if (e != cudaSuccess) return static_cast<int>(e);
  const int threads = ((w + 31) / 32) * 32;
  ht_sliver_kernel<<<dim3(S, 2), threads, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const double*>(rot), static_cast<double*>(U), n, J0, J1, L);
  return static_cast<int>(cudaGetLastError());
}
