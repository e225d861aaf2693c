// B1 band_matmul and B2 band_matmul_t: products with a block-tridiagonal
// matrix, the banded likelihood kind's every precision and Cholesky site.
//
//   M is given by its blocks B3 [nb, 3, wb, wb], B3[n, o] = M[block n, block
//   n + o - 1] (zero-padded to nb wb rows and columns), and X is [C, D]:
//   B1: out[:, block m] = sum_o (X - sub)[:, block m+1-o] @ B3[m+1-o, o]
//   B2: out[:, block m] = sum_o (X - sub)[:, block m+o-1] @ B3[m, o]^T
//   for the output blocks m of a window [n0, n1) (the inputs it reads are
//   blocks n0 - 1 to n1; X reads as zero outside the columns [r0, r1)),
//   and one value per chain over the window:
//   red[c] = scale * sum_j out[c, j] (2 y[c, j] + out[c, j])   (y given)
//          = scale * sum_j out[c, j]^2                          (no y)
//
// Replaces the XLA-compiled block_tridiag_matmul and block_tridiag_matmul_t
// (mcmcdate_tpu/ops/banded.py:209, 235): three batched block products and
// two block shifts there, one GEMM per output block here, whose inner
// dimension runs over the three input blocks in turn.  `upper` skips o = 0,
// whose blocks are zero for the upper-banded Cholesky factor L (so an input
// block moves only its own and the next output block); `accumulate` adds
// the product to `out` instead of writing it (z += dacc P on a window, no
// reduction then); with neither, the CTAs of output blocks outside the
// window write zeros, so `out` is the whole product of an X that is zero
// outside the window's reach.
//
// What bounds it on the H100: at 5,000 taxa x 1024 chains (D = 9,997, wb =
// 128, nb = 79) 2 C nb 3 wb^2 = 7.95 GFLOP against 97 MB of X, out and B3:
// operations, on the SIMT cores in float32 (no TF32, as K2).
//
// The design is K2's (csrc/whiten.cu): each thread keeps a register tile
// of (4 MA) x (4 NA) outputs, read from shared memory as float4 rows of the
// k-major A and B stages; 16-deep k-slices are staged with cp.async into
// two buffers, A transposed, `sub` subtracted from the staged A elements by
// the threads that copied them (each thread copies a single k of every
// slice).  B1 stages B3's rows as they lie; B2 stages the transposed block,
// a warp reading 16 consecutive floats of each of two rows.  Tiles: 128
// chains x 128 columns (8 x 8 per thread, 256 threads) where they give
// about one CTA per SM, else 64 x 32.  Each CTA writes one partial per chain
// of its tile; a second pass sums them in a fixed order.

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

struct BandArgs {
  const float* x;
  const float* sub;
  const float* B3;
  const float* y;
  float* out;
  float* partial;  // [C, gridDim.x], or NULL: no reduction
  int C, D, nb, wb;
  int n0, n1;      // the window of output blocks
  int r0, r1;      // the columns of X read (zero elsewhere)
  int g0;          // the output block of grid column 0
  int tpb;         // column tiles per output block
  int o_lo;        // 1 for an upper-banded matrix, else 0
  int accumulate;
};

template <int MA, int NA, int TY, int TX, bool TRANS>
__global__ void __launch_bounds__(TY * TX) band_kernel(const BandArgs a) {
  using T = Tile<MA, NA, TY, TX>;
  constexpr int BM = T::BM, BN = T::BN, THREADS = T::THREADS, LDA = T::LDA;
  __shared__ __align__(16) float As[2][BK][LDA];
  __shared__ __align__(16) float Bs[2][BK][BN];
  const int tid = threadIdx.x;
  const int tx = tid % TX;
  const int ty = tid / TX;
  const int blk = a.g0 + blockIdx.x / a.tpb;   // output block
  const int j0 = (blockIdx.x % a.tpb) * BN;    // first column within it
  const int m0 = blockIdx.y * BM;              // first chain
  const int C = a.C, D = a.D, wb = a.wb;
  const bool in_window = blk >= a.n0 && blk < a.n1;

  float acc[4 * MA][4 * NA];
#pragma unroll
  for (int i = 0; i < 4 * MA; ++i)
#pragma unroll
    for (int j = 0; j < 4 * NA; ++j) acc[i][j] = 0.f;

  // The k-slices: for each term o, ceil(wb / BK) slices of input block n.
  const int kpb = (wb + BK - 1) / BK;
  const int nk = in_window ? (3 - a.o_lo) * kpb : 0;
  auto slice = [&](int t, int& n, const float*& Bm, int& k0) -> bool {
    const int o = a.o_lo + t / kpb;
    k0 = (t % kpb) * BK;
    n = TRANS ? blk + o - 1 : blk + 1 - o;
    if (n < 0 || n >= a.nb) return false;
    Bm = a.B3 + ((size_t)(TRANS ? blk : n) * 3 + o) * wb * wb;
    return true;
  };
  static_assert(THREADS % BK == 0, "A staging assumes THREADS % BK == 0");
  const int ka = tid % BK;
  // The input column this thread's A copies read in slice t (D: none).
  auto col_of = [&](int t) -> int {
    int n, k0;
    const float* Bm;
    if (!slice(t, n, Bm, k0) || k0 + ka >= wb) return D;
    const int col = n * wb + k0 + ka;
    return col >= a.r0 && col < a.r1 ? col : D;
  };
  auto stage = [&](int t, int buf, int ca) {
    int n, k0;
    const float* Bm = a.B3;
    const bool live = slice(t, n, Bm, k0);
    for (int i = tid; i < BM * BK; i += THREADS) {
      const int c = m0 + i / BK;
      const bool ok = c < C && ca < D;
      cp_async_f32(&As[buf][ka][i / BK], ok ? a.x + (size_t)c * D + ca : a.x, ok);
    }
    for (int i = tid; i < BK * BN; i += THREADS) {
      int k, j;
      if (TRANS) {
        j = i / BK;
        k = i % BK;
      } else {
        k = i / BN;
        j = i % BN;
      }
      const bool ok = live && k0 + k < wb && j0 + j < wb;
      const float* src = TRANS ? Bm + (size_t)(j0 + j) * wb + k0 + k
                               : Bm + (size_t)(k0 + k) * wb + j0 + j;
      cp_async_f32(&Bs[buf][k][j], ok ? src : a.B3, ok);
    }
  };
  auto sub_of = [&](int ca) { return a.sub != nullptr && ca < D ? a.sub[ca] : 0.f; };

  if (nk > 0) {
    int ca = col_of(0);
    float sa = sub_of(ca);
    stage(0, 0, ca);
    cp_async_commit();
    for (int t = 0; t < nk; ++t) {
      const int buf = t & 1;
      int ca_next = D;
      float sa_next = 0.f;
      if (t + 1 < nk) {
        ca_next = col_of(t + 1);
        sa_next = sub_of(ca_next);
        stage(t + 1, buf ^ 1, ca_next);
      }
      cp_async_commit();
      cp_async_wait<1>();
      // x - sub on the A elements this thread copied (zero-filled ones stay 0).
      if (a.sub != nullptr && ca < D) {
        for (int i = tid; i < BM * BK; i += THREADS) {
          if (m0 + i / BK < C) As[buf][ka][i / BK] -= sa;
        }
      }
      __syncthreads();
#pragma unroll
      for (int k = 0; k < BK; ++k) {
        float av[4 * MA], bv[4 * NA];
#pragma unroll
        for (int q = 0; q < MA; ++q) {
          const float4 v = *reinterpret_cast<const float4*>(&As[buf][k][ty * 4 + q * (BM / MA)]);
          av[4 * q] = v.x; av[4 * q + 1] = v.y; av[4 * q + 2] = v.z; av[4 * q + 3] = v.w;
        }
#pragma unroll
        for (int q = 0; q < NA; ++q) {
          const float4 v = *reinterpret_cast<const float4*>(&Bs[buf][k][tx * 4 + q * (BN / NA)]);
          bv[4 * q] = v.x; bv[4 * q + 1] = v.y; bv[4 * q + 2] = v.z; bv[4 * q + 3] = v.w;
        }
#pragma unroll
        for (int i = 0; i < 4 * MA; ++i)
#pragma unroll
          for (int j = 0; j < 4 * NA; ++j) acc[i][j] += av[i] * bv[j];
      }
      __syncthreads();
      ca = ca_next;
      sa = sa_next;
    }
    cp_async_wait<0>();
  }

  // Epilogue: write (or add) the tile, reduce each chain's row of it.  A CTA
  // outside the window writes zeros (it is launched only when the caller
  // wants the whole product) and a zero partial.
#pragma unroll
  for (int i = 0; i < 4 * MA; ++i) {
    const int c = m0 + ty * 4 + (i / 4) * (BM / MA) + i % 4;
    float part = 0.f;
#pragma unroll
    for (int j = 0; j < 4 * NA; ++j) {
      const int jj = j0 + tx * 4 + (j / 4) * (BN / NA) + j % 4;
      const int col = blk * wb + jj;
      if (c < C && jj < wb && col < D) {
        const float o = acc[i][j];
        const size_t at = (size_t)c * D + col;
        if (a.accumulate) {
          a.out[at] += o;
        } else {
          a.out[at] = o;
        }
        if (a.partial != nullptr) {
          if (a.y != nullptr) {
            part += o * (2.0f * a.y[at] + o);
          } else {
            part += o * o;
          }
        }
      }
    }
    if (a.partial != nullptr) {
      // The TX threads sharing this output row are TX consecutive lanes.
#pragma unroll
      for (int off = TX / 2; off > 0; off >>= 1) part += __shfl_xor_sync(0xffffffffu, part, off);
      if (tx == 0 && c < C) a.partial[(size_t)c * gridDim.x + blockIdx.x] = part;
    }
  }
}

__global__ void band_reduce_kernel(const float* __restrict__ partial, int G, int C, float scale,
                                   float* __restrict__ red) {
  const int c = blockIdx.x * blockDim.x + threadIdx.x;
  if (c >= C) return;
  float s = 0.f;
  for (int g = 0; g < G; ++g) s += partial[(size_t)c * G + g];
  red[c] = scale * s;
}

template <typename T>
int tiles_per_block(int wb) {
  return (wb + T::BN - 1) / T::BN;
}

bool use_big(int C, int wb, int blocks) {
  return (long)((C + Big::BM - 1) / Big::BM) * blocks * tiles_per_block<Big>(wb) >= kBigMinCtas;
}

template <int MA, int NA, int TY, int TX>
cudaError_t launch(BandArgs a, int trans, int blocks, cudaStream_t st) {
  using T = Tile<MA, NA, TY, TX>;
  a.tpb = tiles_per_block<T>(a.wb);
  const dim3 grid(blocks * a.tpb, (a.C + T::BM - 1) / T::BM);
  if (trans) {
    band_kernel<MA, NA, TY, TX, true><<<grid, T::THREADS, 0, st>>>(a);
  } else {
    band_kernel<MA, NA, TY, TX, false><<<grid, T::THREADS, 0, st>>>(a);
  }
  return cudaGetLastError();
}

}  // namespace

// The number of partials per chain of a call over `blocks` output blocks:
// the wrapper allocates [C, that].
extern "C" int mcmcdate_band_partials(int C, int wb, int blocks) {
  const int tpb = use_big(C, wb, blocks) ? tiles_per_block<Big>(wb) : tiles_per_block<Small>(wb);
  return blocks * tpb;
}

// out[:, window] += the product with accumulate; without, out = the product
// on the window and zero on the other blocks (the whole grid is launched).
// red (NULL: none) the per-chain reduction over the window, scaled.
extern "C" int mcmcdate_band_matmul_f32(const float* x, const float* sub, const float* B3,
                                        const float* y, float* out, float* red, float* partial,
                                        int C, int D, int nb, int wb, int n0, int n1, int r0,
                                        int r1, int trans, int upper, int accumulate, float scale,
                                        void* stream) {
  if (C > 0 && D > 0 && n1 > n0) {
    cudaStream_t st = (cudaStream_t)stream;
    const int g0 = accumulate ? n0 : 0;
    const int blocks = accumulate ? n1 - n0 : nb;
    BandArgs a{x, sub, B3, y, out, red != nullptr ? partial : nullptr, C, D, nb, wb, n0, n1,
               r0, r1 < D ? r1 : D, g0, 0, upper ? 1 : 0, accumulate};
    const cudaError_t err = use_big(C, wb, blocks) ? launch<2, 2, 16, 16>(a, trans, blocks, st)
                                                    : launch<1, 1, 16, 8>(a, trans, blocks, st);
    if (err != cudaSuccess) return (int)err;
    if (red != nullptr) {
      const int G = mcmcdate_band_partials(C, wb, blocks);
      band_reduce_kernel<<<(C + 255) / 256, 256, 0, st>>>(partial, G, C, scale, red);
    }
  }
  return (int)cudaGetLastError();
}
