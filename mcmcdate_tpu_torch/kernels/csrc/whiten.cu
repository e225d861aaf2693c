// K2 whiten: gathered-row product with the precision Cholesky factor.
//
//   dy[c, :] = (x[c, rows] - sub[rows]) @ L[rows, :]  (- y[c, :] if minus_y)
//   red[c]   = scale * sum_j dy[c, j] * (2 y[c, j] + dy[c, j])   (y given)
//            = scale * sum_j dy[c, j]^2                          (no y)
//
// Replaces the XLA-compiled whitened_residual_internal
// (mcmcdate_tpu/models/dating.py:209), mvn_log_density (ops/mvn.py:121) and
// the incremental likelihood classes of MHKernel._ticket_step
// (engine/mh.py:147-180): br_full (rows = all), br_gather (rows = the <= KG
// touched entries) and mk_range(64/256/1024) (rows = {0} U [lo, lo+B)).
// Row entries >= D read as zero, as the zero-padded L_pad rows do in JAX.
//
// What bounds it on the H100: the full class is a [C, D] x [D, D] product
// in f32 (2 C D^2 FLOP: 0.15 GFLOP at 1024 x 269, 8 GFLOP at 1024 x 2k),
// run on the SIMT cores because TF32 tensor cores would cost the sampler's
// acceptance deltas precision; the gather and range classes have a short
// inner dimension and are bound by reading L[rows, :] and writing dy.  The
// design: 64 x 64 output tiles, 16-deep k-slices staged in shared memory,
// 4 x 4 outputs per thread; the gather and the mu subtraction happen while
// the A tile is loaded, and the epilogue writes dy and reduces each chain's
// row into a per-tile partial (a second tiny pass sums the partials in a
// fixed order, so results do not depend on scheduling).

#include <cuda_runtime.h>

namespace {

constexpr int BM = 64;
constexpr int BN = 64;
constexpr int BK = 16;
constexpr int TM = 4;
constexpr int TN = 4;
constexpr int THREADS = (BM / TM) * (BN / TN);  // 256

__global__ void __launch_bounds__(THREADS)
    whiten_kernel(const float* __restrict__ x, const float* __restrict__ sub,
                  const int* __restrict__ rows, int R, const float* __restrict__ L,
                  const float* __restrict__ y, int minus_y, float* __restrict__ dy,
                  float* __restrict__ partial, int C, int D) {
  __shared__ float As[BK][BM + 1];
  __shared__ float Bs[BK][BN];
  const int tid = threadIdx.x;
  const int tx = tid % (BN / TN);
  const int ty = tid / (BN / TN);
  const int m0 = blockIdx.y * BM;
  const int n0 = blockIdx.x * BN;
  float acc[TM][TN];
#pragma unroll
  for (int i = 0; i < TM; ++i)
#pragma unroll
    for (int j = 0; j < TN; ++j) acc[i][j] = 0.f;

  for (int k0 = 0; k0 < R; k0 += BK) {
    for (int i = tid; i < BM * BK; i += THREADS) {
      const int m = i / BK, k = i % BK;
      const int c = m0 + m, kk = k0 + k;
      float v = 0.f;
      if (c < C && kk < R) {
        const int r = rows[kk];
        if (r < D) {
          v = x[(size_t)c * D + r];
          if (sub != nullptr) v -= sub[r];
        }
      }
      As[k][m] = v;
    }
    for (int i = tid; i < BK * BN; i += THREADS) {
      const int k = i / BN, n = i % BN;
      const int kk = k0 + k, col = n0 + n;
      float v = 0.f;
      if (kk < R && col < D) {
        const int r = rows[kk];
        if (r < D) v = L[(size_t)r * D + col];
      }
      Bs[k][n] = v;
    }
    __syncthreads();
#pragma unroll
    for (int k = 0; k < BK; ++k) {
      float a[TM], b[TN];
#pragma unroll
      for (int i = 0; i < TM; ++i) a[i] = As[k][ty * TM + i];
#pragma unroll
      for (int j = 0; j < TN; ++j) b[j] = Bs[k][tx * TN + j];
#pragma unroll
      for (int i = 0; i < TM; ++i)
#pragma unroll
        for (int j = 0; j < TN; ++j) acc[i][j] += a[i] * b[j];
    }
    __syncthreads();
  }

#pragma unroll
  for (int i = 0; i < TM; ++i) {
    const int c = m0 + ty * TM + i;
    float part = 0.f;
#pragma unroll
    for (int j = 0; j < TN; ++j) {
      const int col = n0 + tx * TN + j;
      if (c < C && col < D) {
        float o = acc[i][j];
        const size_t at = (size_t)c * D + col;
        if (y != nullptr) {
          const float yy = y[at];
          if (minus_y) o -= yy;
          part += o * (2.0f * yy + o);
        } else {
          part += o * o;
        }
        dy[at] = o;
      }
    }
    // The 16 threads sharing this output row are 16 consecutive lanes.
#pragma unroll
    for (int off = (BN / TN) / 2; off > 0; off >>= 1)
      part += __shfl_xor_sync(0xffffffffu, part, off);
    if (tx == 0 && c < C) partial[(size_t)c * gridDim.x + blockIdx.x] = part;
  }
}

__global__ void reduce_partials_kernel(const float* __restrict__ partial, int G, int C,
                                       float scale, float* __restrict__ red) {
  const int c = blockIdx.x * blockDim.x + threadIdx.x;
  if (c >= C) return;
  float s = 0.f;
  for (int g = 0; g < G; ++g) s += partial[(size_t)c * G + g];
  red[c] = scale * s;
}

}  // namespace

// Number of column tiles: the partials buffer the wrapper allocates is [C, tiles].
extern "C" int mcmcdate_whiten_tiles(int D) { return (D + BN - 1) / BN; }

extern "C" int mcmcdate_whiten_f32(const float* x, const float* sub, const int* rows, int R,
                                   const float* L, const float* y, int minus_y, float scale,
                                   float* dy, float* red, float* partial, int C, int D,
                                   void* stream) {
  if (C > 0 && D > 0) {
    const dim3 grid((D + BN - 1) / BN, (C + BM - 1) / BM);
    whiten_kernel<<<grid, THREADS, 0, (cudaStream_t)stream>>>(x, sub, rows, R, L, y, minus_y, dy,
                                                              partial, C, D);
    cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
    reduce_partials_kernel<<<(C + 255) / 256, 256, 0, (cudaStream_t)stream>>>(partial, grid.x, C,
                                                                             scale, red);
  }
  return (int)cudaGetLastError();
}
