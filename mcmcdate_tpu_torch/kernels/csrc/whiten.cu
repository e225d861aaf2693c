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
// in f32 (2 C D^2 FLOP: 0.15 GFLOP at 1024 x 269, 8.2 GFLOP at 1024 x
// 1997), run on the SIMT cores because TF32 tensor cores would cost the
// sampler's acceptance deltas precision: operations, 67 TFLOP/s.  The
// gather and range classes have a short inner dimension and are bound by
// reading L[rows, :] and writing dy.
//
// The design (an f32 SIMT GEMM): each thread keeps a register tile of
// (4 MA) x (4 NA) outputs, read from shared memory as float4 rows of the
// k-major A and B stages, MA and NA quads apart so that a warp's float4
// reads do not conflict.  16-deep k-slices are staged with cp.async into
// two buffers, so the next slice's copies fly while the current one is
// multiplied; A is staged transposed (k-major), and `sub` is subtracted
// from the staged A elements by the threads that copied them (each thread
// copies a single k of every slice, so it reads one row index and one
// `sub` value per slice, a slice ahead).  The full class reads its rows
// contiguously with no index reads (a template flag), the other classes
// through the row list, rows >= D reading as zero.  Tiles: 128 x 128 (8 x 8
// per thread, 256 threads) where they give at least one CTA per SM (1000
// taxa x 1024 chains: 128 CTAs), else 64 x 32 (4 x 4 per thread; 144 CTAs
// at 269 x 1024).  The epilogue writes dy and reduces each chain's row
// into one partial per column tile; a second tiny pass sums the partials
// in a fixed order, so results do not depend on scheduling.

#include <cuda_runtime.h>

#include "async_copy.cuh"

namespace {

using namespace mcmcdate;

constexpr int BK = 16;
constexpr int kBigMinCtas = 120;  // about one per SM

template <int MA, int NA, int TY, int TX>
struct Tile {
  static constexpr int BM = 4 * MA * TY;
  static constexpr int BN = 4 * NA * TX;
  static constexpr int THREADS = TY * TX;
  static constexpr int LDA = BM + 4;  // padded against bank conflicts of the A copies
};

using Big = Tile<2, 2, 16, 16>;
using Small = Tile<1, 1, 16, 8>;

template <int MA, int NA, int TY, int TX, bool FULL>
__global__ void __launch_bounds__(TY * TX)
    whiten_kernel(const float* __restrict__ x, const float* __restrict__ sub,
                  const int* __restrict__ rows, int R, const float* __restrict__ L,
                  const float* __restrict__ y, int minus_y, float* __restrict__ dy,
                  float* __restrict__ partial, int C, int D) {
  using T = Tile<MA, NA, TY, TX>;
  constexpr int BM = T::BM, BN = T::BN, THREADS = T::THREADS, LDA = T::LDA;
  __shared__ __align__(16) float As[2][BK][LDA];
  __shared__ __align__(16) float Bs[2][BK][BN];
  const int tid = threadIdx.x;
  const int tx = tid % TX;
  const int ty = tid / TX;
  const int m0 = blockIdx.y * BM;
  const int n0 = blockIdx.x * BN;

  // Row of L (and column of x) behind position kk of the row list; D for
  // padding and past the end.
  auto row_of = [&](int kk) -> int {
    if (kk >= R) return D;
    return FULL ? kk : rows[kk];
  };

  // Every A element a thread stages has k = tid % BK (THREADS is a
  // multiple of BK), so it reads one row index and one `sub` value per
  // slice, a slice ahead.
  static_assert(THREADS % BK == 0, "A staging assumes THREADS % BK == 0");
  const int ka = tid % BK;
  auto stage = [&](int k0, int buf, int ra) {
    for (int i = tid; i < BM * BK; i += THREADS) {
      const int c = m0 + i / BK;
      const bool ok = c < C && ra < D;
      cp_async_f32(&As[buf][ka][i / BK], ok ? x + (size_t)c * D + ra : x, ok);
    }
    for (int i = tid; i < BK * BN; i += THREADS) {
      const int k = i / BN, n = i % BN;
      const int col = n0 + n;
      const int r = row_of(k0 + k);
      const bool ok = col < D && r < D;
      cp_async_f32(&Bs[buf][k][n], ok ? L + (size_t)r * D + col : L, ok);
    }
  };
  auto sub_of = [&](int ra) { return sub != nullptr && ra < D ? sub[ra] : 0.f; };

  float acc[4 * MA][4 * NA];
#pragma unroll
  for (int i = 0; i < 4 * MA; ++i)
#pragma unroll
    for (int j = 0; j < 4 * NA; ++j) acc[i][j] = 0.f;

  const int nk = (R + BK - 1) / BK;
  int ra = row_of(ka);
  float sa = sub_of(ra);
  stage(0, 0, ra);
  cp_async_commit();
  for (int t = 0; t < nk; ++t) {
    const int buf = t & 1;
    int ra_next = D;
    float sa_next = 0.f;
    if (t + 1 < nk) {
      ra_next = row_of((t + 1) * BK + ka);
      sa_next = sub_of(ra_next);
      stage((t + 1) * BK, buf ^ 1, ra_next);
    }
    cp_async_commit();
    cp_async_wait<1>();
    // x - sub on the A elements this thread copied (zero-filled ones stay 0).
    if (sub != nullptr && ra < D) {
      for (int i = tid; i < BM * BK; i += THREADS) {
        if (m0 + i / BK < C) As[buf][ka][i / BK] -= sa;
      }
    }
    __syncthreads();
#pragma unroll
    for (int k = 0; k < BK; ++k) {
      float a[4 * MA], b[4 * NA];
#pragma unroll
      for (int q = 0; q < MA; ++q) {
        const float4 v = *reinterpret_cast<const float4*>(&As[buf][k][ty * 4 + q * (BM / MA)]);
        a[4 * q] = v.x; a[4 * q + 1] = v.y; a[4 * q + 2] = v.z; a[4 * q + 3] = v.w;
      }
#pragma unroll
      for (int q = 0; q < NA; ++q) {
        const float4 v = *reinterpret_cast<const float4*>(&Bs[buf][k][tx * 4 + q * (BN / NA)]);
        b[4 * q] = v.x; b[4 * q + 1] = v.y; b[4 * q + 2] = v.z; b[4 * q + 3] = v.w;
      }
#pragma unroll
      for (int i = 0; i < 4 * MA; ++i)
#pragma unroll
        for (int j = 0; j < 4 * NA; ++j) acc[i][j] += a[i] * b[j];
    }
    __syncthreads();
    ra = ra_next;
    sa = sa_next;
  }
  cp_async_wait<0>();

#pragma unroll
  for (int i = 0; i < 4 * MA; ++i) {
    const int c = m0 + ty * 4 + (i / 4) * (BM / MA) + i % 4;
    float part = 0.f;
#pragma unroll
    for (int j = 0; j < 4 * NA; ++j) {
      const int col = n0 + tx * 4 + (j / 4) * (BN / NA) + j % 4;
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
    // The TX threads sharing this output row are TX consecutive lanes.
#pragma unroll
    for (int off = TX / 2; off > 0; off >>= 1) part += __shfl_xor_sync(0xffffffffu, part, off);
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

bool use_big(int C, int D) {
  return (long)((C + Big::BM - 1) / Big::BM) * ((D + Big::BN - 1) / Big::BN) >= kBigMinCtas;
}

template <int MA, int NA, int TY, int TX>
cudaError_t launch(const float* x, const float* sub, const int* rows, int R, const float* L,
                   const float* y, int minus_y, float* dy, float* partial, int C, int D,
                   cudaStream_t st) {
  using T = Tile<MA, NA, TY, TX>;
  const dim3 grid((D + T::BN - 1) / T::BN, (C + T::BM - 1) / T::BM);
  if (rows == nullptr) {
    whiten_kernel<MA, NA, TY, TX, true><<<grid, T::THREADS, 0, st>>>(
        x, sub, rows, D, L, y, minus_y, dy, partial, C, D);
  } else {
    whiten_kernel<MA, NA, TY, TX, false><<<grid, T::THREADS, 0, st>>>(
        x, sub, rows, R, L, y, minus_y, dy, partial, C, D);
  }
  return cudaGetLastError();
}

}  // namespace

// Number of column tiles: the partials buffer the wrapper allocates is [C, tiles].
extern "C" int mcmcdate_whiten_tiles(int C, int D) {
  const int bn = use_big(C, D) ? Big::BN : Small::BN;
  return (D + bn - 1) / bn;
}

// rows == NULL: the full class (every row, in order, R ignored).
extern "C" int mcmcdate_whiten_f32(const float* x, const float* sub, const int* rows, int R,
                                   const float* L, const float* y, int minus_y, float scale,
                                   float* dy, float* red, float* partial, int C, int D,
                                   void* stream) {
  if (C > 0 && D > 0) {
    cudaStream_t st = (cudaStream_t)stream;
    const bool big = use_big(C, D);
    const cudaError_t err =
        big ? launch<2, 2, 16, 16>(x, sub, rows, R, L, y, minus_y, dy, partial, C, D, st)
            : launch<1, 1, 16, 8>(x, sub, rows, R, L, y, minus_y, dy, partial, C, D, st);
    if (err != cudaSuccess) return (int)err;
    const int tiles = mcmcdate_whiten_tiles(C, D);
    reduce_partials_kernel<<<(C + 255) / 256, 256, 0, st>>>(partial, tiles, C, scale, red);
  }
  return (int)cudaGetLastError();
}
