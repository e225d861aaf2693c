// K5 range_scan: Gram blocks and accept scan of a subtree-range block.
//
// Replaces the XLA-compiled core of FastSweeps._mega_range_lik
// (mcmcdate_tpu/engine/fast_sweep.py:1839-1874).  Each of the block's S
// tickets has a rank-1 distance delta coef_a g_a on RB rows.  Per chain:
//   G_ab  = g_a' Q[a, b] g_b                 (a <= b; Q = P between the rows)
//   v_a   = g_a . zg_a,  dq0_a = 2 coef_a v_a + coef_a^2 G_aa
//   dq_t  = dq0_t + 2 sum_{a < t accepted} coef_a G_at coef_t
//   accept_t = log u_t < dpr_t - dq_t / 2 + lmhg_t
//
// What bounds it on the H100: operations.  G is (S RB)^2 multiply-adds per
// chain (S RB = 1024 in every bucket: about 1 G at 1024 chains), against a
// few MB of inputs.  The design: range_scan_gram_kernel takes one block
// per (tile of 32 chains, ticket pair a <= b), stages the tile's g_a and
// g_b rows in shared memory (rows padded by one float against bank
// conflicts) and reads Q[a, b] rows as warp-wide broadcasts from L1/L2;
// eight warps split the rows of g_a and a final shared-memory sum gives
// G_ab.  range_scan_accept_kernel then runs the serial scan with one warp per chain (S <= 64, two tickets
// per lane) and a warp-reduced correction.

#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int kTile = 32;    // chains per gram block
constexpr int kGroups = 8;   // warps splitting the rows of g_a
constexpr int kWarpsPerScanBlock = 8;

__global__ void __launch_bounds__(kTile * kGroups)
    range_scan_gram_kernel(const float* __restrict__ g, const float* __restrict__ Q,
                           float* __restrict__ gram, int C, int S, int RB) {
  extern __shared__ float sm[];
  const int ld = RB + 1;
  float* ga = sm;                 // [kTile, RB+1]
  float* gb = ga + kTile * ld;    // [kTile, RB+1]
  float* red = gb + kTile * ld;   // [kGroups, kTile]
  // Pair index -> (a, b) with a <= b, b-major: p = b (b + 1) / 2 + a.
  const int p = blockIdx.y;
  int b = (int)((sqrtf(8.0f * p + 1.0f) - 1.0f) * 0.5f);
  while (b * (b + 1) / 2 > p) --b;
  while ((b + 1) * (b + 2) / 2 <= p) ++b;
  const int a = p - b * (b + 1) / 2;
  const int c0 = blockIdx.x * kTile;
  const int tid = threadIdx.x;
  for (int k = tid; k < kTile * RB; k += blockDim.x) {
    const int cl = k / RB, i = k - cl * RB;
    const int c = c0 + cl;
    const bool in = c < C;
    ga[cl * ld + i] = in ? g[((size_t)c * S + a) * RB + i] : 0.f;
    gb[cl * ld + i] = in ? g[((size_t)c * S + b) * RB + i] : 0.f;
  }
  __syncthreads();
  const int cl = tid % kTile;
  const int grp = tid / kTile;
  const size_t F = (size_t)S * RB;
  float acc = 0.f;
  for (int i = grp; i < RB; i += kGroups) {
    const float* qrow = Q + ((size_t)a * RB + i) * F + (size_t)b * RB;
    float w = 0.f;
    for (int j = 0; j < RB; ++j) w += qrow[j] * gb[cl * ld + j];
    acc += ga[cl * ld + i] * w;
  }
  red[grp * kTile + cl] = acc;
  __syncthreads();
  if (grp == 0 && c0 + cl < C) {
    float sum = 0.f;
    for (int k = 0; k < kGroups; ++k) sum += red[k * kTile + cl];
    gram[((size_t)(c0 + cl) * S + a) * S + b] = sum;
  }
}

__global__ void __launch_bounds__(32 * kWarpsPerScanBlock)
    range_scan_accept_kernel(const float* __restrict__ g, const float* __restrict__ zg,
                             const float* __restrict__ gram, const float* __restrict__ coef,
                             const float* __restrict__ d_pr, const float* __restrict__ lmhg,
                             const float* __restrict__ u, unsigned char* __restrict__ accept,
                             float* __restrict__ dq, int C, int S, int RB) {
  const int c = blockIdx.x * kWarpsPerScanBlock + threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  if (c >= C) return;
  const float* G = gram + (size_t)c * S * S;
  const float* cf = coef + (size_t)c * S;
  // Lane owns tickets lane and lane + 32.
  float dq0[2] = {0.f, 0.f};
  float ca[2] = {0.f, 0.f};
  bool acc[2] = {false, false};
  for (int s = 0; s < 2; ++s) {
    const int at = lane + 32 * s;
    if (at >= S) continue;
    const float* ga = g + ((size_t)c * S + at) * RB;
    const float* za = zg + ((size_t)c * S + at) * RB;
    float v = 0.f;
    for (int i = 0; i < RB; ++i) v += ga[i] * za[i];
    ca[s] = cf[at];
    dq0[s] = 2.0f * ca[s] * v + ca[s] * ca[s] * G[at * S + at];
  }
  for (int t = 0; t < S; ++t) {
    const float ct = cf[t];
    float part = 0.f;
    for (int s = 0; s < 2; ++s) {
      const int at = lane + 32 * s;
      if (at < t && acc[s]) part += ca[s] * G[at * S + t] * ct;
    }
    for (int off = 16; off > 0; off >>= 1) part += __shfl_xor_sync(0xffffffffu, part, off);
    part = __shfl_sync(0xffffffffu, part, 0);
    const float dq0_t = __shfl_sync(0xffffffffu, t < 32 ? dq0[0] : dq0[1], t % 32);
    const size_t o = (size_t)c * S + t;
    const float dq_t = dq0_t + 2.0f * part;
    float la = d_pr[o] - 0.5f * dq_t + lmhg[o];
    if (isnan(la)) la = -INFINITY;
    const bool ok = logf(u[o]) < la;
    if (lane == t % 32) acc[t / 32] = ok;
    if (lane == 0) {
      accept[o] = ok;
      dq[o] = dq_t;
    }
  }
}

}  // namespace

extern "C" int mcmcdate_range_scan_f32(const float* g, const float* zg, const float* Q,
                                       const float* coef, const float* d_pr, const float* lmhg,
                                       const float* u, float* gram, unsigned char* accept,
                                       float* dq, int C, int S, int RB, void* stream) {
  if (S > 64) return (int)cudaErrorInvalidValue;
  if (C == 0 || S == 0) return (int)cudaGetLastError();
  cudaStream_t st = (cudaStream_t)stream;
  const size_t smem = (2 * (size_t)kTile * (RB + 1) + kGroups * kTile) * sizeof(float);
  if (smem > 48 * 1024) {
    cudaError_t err = cudaFuncSetAttribute(
        range_scan_gram_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return (int)err;
  }
  dim3 grid((C + kTile - 1) / kTile, S * (S + 1) / 2);
  range_scan_gram_kernel<<<grid, kTile * kGroups, smem, st>>>(g, Q, gram, C, S, RB);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  const int scan_blocks = (C + kWarpsPerScanBlock - 1) / kWarpsPerScanBlock;
  range_scan_accept_kernel<<<scan_blocks, 32 * kWarpsPerScanBlock, 0, st>>>(
      g, zg, gram, coef, d_pr, lmhg, u, accept, dq, C, S, RB);
  return (int)cudaGetLastError();
}
