// A1-A3: the elementwise passes of one ADMM iteration of the graphical lasso,
// in float64.
//
// Replaces the body of the XLA-compiled while_loop of graphical_lasso_admm
// (mcmcdate_tpu/utils/glasso.py:81, body 109-135, loop 140), around the two
// library calls that stay outside any kernel, torch.linalg.eigh and the
// product T = Qs Q^T:
//
//   A1 admm_shift      U <- U / fac_prev (in place; the previous iteration's
//                      residual balancing), then A = (B + B^T) / 2 with
//                      B = t (Z - U) - S: the eigh input, symmetrised as
//                      jnp.linalg.eigh symmetrises it (torch's eigh reads
//                      only the lower triangle).
//   A2 admm_eig_scale  theta_k = (lam_k + sqrt(lam_k^2 + 4 t)) / (2 t) and
//                      Qs = Q diag(theta) (glasso.py:111-112), for Q in
//                      either layout (torch's eigh returns it column-major).
//   A3 admm_update     Tr = alpha T + (1 - alpha) Z; Z' = soft(Tr + U, rho/t)
//                      with exact zeros; U' = U + Tr - Z' (both in place) and
//                      the sums of (T - Z')^2 and (Z' - Z)^2 (glasso.py:125-129)
//                      by per-block partials that a second one-block pass sums
//                      in a fixed order, so r and s repeat run to run.
//
// What bounds them on the H100: bytes.  At p = 1,997 one p x p float64 matrix
// is 31.9 MB; A1 reads Z, U, S and writes U and A (5 matrices, 0.048 ms at
// 3.35 TB/s), A2 reads Q and writes Qs (0.019 ms), A3 reads T, Z, U and
// writes Z and U (0.048 ms).  An iteration's eigh (O(p^3), float64) and its
// product (2 p^3 = 15.9 GFLOP) dominate it by far.  The design is plain:
// A1 takes a pair of mirrored 32 x 32 tiles per CTA (the upper triangle's
// tiles; the lower ones exit), staged through shared memory so that both the
// element and its transpose are read and written coalesced, and each U entry
// is divided and written back by exactly one thread; A2 and A3 are grid-stride
// loops.  Built with -fmad=false, so that every product is rounded on its own
// as in the op-by-op plain versions: A1, A2 and A3's Z and U are bitwise equal
// to them.

#include <cuda_runtime.h>

namespace {

constexpr int kTile = 32;
constexpr int kTileRows = 8;  // a CTA of 32 x 8 threads, 4 rows a thread
constexpr int kThreads = 256;
constexpr int kMaxBlocks = 132 * 8;

__global__ void admm_shift_kernel(double* __restrict__ U, const double* __restrict__ Z,
                                  const double* __restrict__ S, double* __restrict__ A, int p,
                                  double t, double fac) {
  const int bi = blockIdx.y, bj = blockIdx.x;
  if (bi > bj) return;  // tile (bj, bi) is handled with its mirror (bi, bj)
  __shared__ double b1[kTile][kTile + 1];  // B on tile (bi, bj)
  __shared__ double b2[kTile][kTile + 1];  // B on tile (bj, bi)
  const int tx = threadIdx.x, ty = threadIdx.y;
  const bool diag = bi == bj;
  for (int r = ty; r < kTile; r += kTileRows) {
    const int i = bi * kTile + r, j = bj * kTile + tx;
    if (i < p && j < p) {
      const size_t m = (size_t)i * p + j;
      const double u = U[m] / fac;
      U[m] = u;
      b1[r][tx] = t * (Z[m] - u) - S[m];
    }
    if (!diag) {
      const int i2 = bj * kTile + r, j2 = bi * kTile + tx;
      if (i2 < p && j2 < p) {
        const size_t m = (size_t)i2 * p + j2;
        const double u = U[m] / fac;
        U[m] = u;
        b2[r][tx] = t * (Z[m] - u) - S[m];
      }
    }
  }
  __syncthreads();
  // A[i, j] = (B[i, j] + B[j, i]) / 2: B[j, i] of tile (bi, bj) is b2[c][r]
  // (b1[c][r] on a diagonal tile), B[j, i] of tile (bj, bi) is b1[c][r].
  double(*mirror)[kTile + 1] = diag ? b1 : b2;
  for (int r = ty; r < kTile; r += kTileRows) {
    const int i = bi * kTile + r, j = bj * kTile + tx;
    if (i < p && j < p) A[(size_t)i * p + j] = (b1[r][tx] + mirror[tx][r]) / 2.0;
    if (!diag) {
      const int i2 = bj * kTile + r, j2 = bi * kTile + tx;
      if (i2 < p && j2 < p) A[(size_t)i2 * p + j2] = (b2[r][tx] + b1[tx][r]) / 2.0;
    }
  }
}

__global__ void admm_eig_scale_kernel(const double* __restrict__ lam,
                                      const double* __restrict__ Q, double* __restrict__ out,
                                      int p, long long n, int col_major, double t) {
  const long long stride = (long long)gridDim.x * blockDim.x;
  for (long long m = (long long)blockIdx.x * blockDim.x + threadIdx.x; m < n; m += stride) {
    const int k = col_major ? (int)(m / p) : (int)(m % p);
    const double l = lam[k];
    const double th = (l + sqrt(l * l + 4.0 * t)) / (2.0 * t);
    out[m] = Q[m] * th;
  }
}

// Sum of v over the CTA in a fixed order (shuffles, then the warps' sums in
// warp order); the result is valid in thread 0.
__device__ double block_sum(double v, double* warp_sums) {
  for (int o = 16; o > 0; o >>= 1) v += __shfl_down_sync(0xffffffffu, v, o);
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  __syncthreads();
  if (lane == 0) warp_sums[warp] = v;
  __syncthreads();
  double s = 0.0;
  if (threadIdx.x == 0)
    for (int w = 0; w < (int)(blockDim.x >> 5); ++w) s += warp_sums[w];
  return s;
}

__global__ void admm_update_kernel(const double* __restrict__ T, double* __restrict__ Z,
                                   double* __restrict__ U, long long n, double alpha,
                                   double beta, double k, double* __restrict__ partial) {
  __shared__ double warp_sums[kThreads / 32];
  double r = 0.0, s = 0.0;
  const long long stride = (long long)gridDim.x * blockDim.x;
  for (long long m = (long long)blockIdx.x * blockDim.x + threadIdx.x; m < n; m += stride) {
    const double tv = T[m], z = Z[m], u = U[m];
    const double tr = alpha * tv + beta * z;
    const double a = tr + u;
    const double sg = (double)((a > 0.0) - (a < 0.0));
    double mag = fabs(a) - k;
    mag = mag < 0.0 ? 0.0 : mag;
    const double zn = sg * mag;
    Z[m] = zn;
    U[m] = u + tr - zn;
    const double dr = tv - zn, ds = zn - z;
    r += dr * dr;
    s += ds * ds;
  }
  r = block_sum(r, warp_sums);
  s = block_sum(s, warp_sums);
  if (threadIdx.x == 0) {
    partial[2 * blockIdx.x] = r;
    partial[2 * blockIdx.x + 1] = s;
  }
}

// One CTA: out = the sums of the partials, each thread over a fixed stride of
// blocks, then the CTA's fixed-order sum.
__global__ void admm_reduce_kernel(const double* __restrict__ partial, int blocks,
                                   double* __restrict__ out) {
  __shared__ double warp_sums[kThreads / 32];
  double r = 0.0, s = 0.0;
  for (int b = threadIdx.x; b < blocks; b += blockDim.x) {
    r += partial[2 * b];
    s += partial[2 * b + 1];
  }
  r = block_sum(r, warp_sums);
  s = block_sum(s, warp_sums);
  if (threadIdx.x == 0) {
    out[0] = r;
    out[1] = s;
  }
}

int grid_of(long long n) {
  const long long b = (n + kThreads - 1) / kThreads;
  return (int)(b < kMaxBlocks ? (b > 0 ? b : 1) : kMaxBlocks);
}

}  // namespace

extern "C" int mcmcdate_admm_shift_f64(double* U, const double* Z, const double* S, double* A,
                                       int p, double t, double fac, void* stream) {
  if (p > 0) {
    const int nb = (p + kTile - 1) / kTile;
    admm_shift_kernel<<<dim3(nb, nb), dim3(kTile, kTileRows), 0, (cudaStream_t)stream>>>(
        U, Z, S, A, p, t, fac);
  }
  return (int)cudaGetLastError();
}

extern "C" int mcmcdate_admm_eig_scale_f64(const double* lam, const double* Q, double* out,
                                           int p, int col_major, double t, void* stream) {
  const long long n = (long long)p * p;
  if (n > 0)
    admm_eig_scale_kernel<<<grid_of(n), kThreads, 0, (cudaStream_t)stream>>>(lam, Q, out, p, n,
                                                                              col_major, t);
  return (int)cudaGetLastError();
}

// The partials buffer the wrapper allocates holds 2 doubles a block.
extern "C" int mcmcdate_admm_update_blocks(int p) { return grid_of((long long)p * p); }

extern "C" int mcmcdate_admm_update_f64(const double* T, double* Z, double* U, int p,
                                        double alpha, double beta, double k, double* partial,
                                        double* out, void* stream) {
  const long long n = (long long)p * p;
  if (n > 0) {
    cudaStream_t st = (cudaStream_t)stream;
    const int blocks = grid_of(n);
    admm_update_kernel<<<blocks, kThreads, 0, st>>>(T, Z, U, n, alpha, beta, k, partial);
    const cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
    admm_reduce_kernel<<<1, kThreads, 0, st>>>(partial, blocks, out);
  }
  return (int)cudaGetLastError();
}
