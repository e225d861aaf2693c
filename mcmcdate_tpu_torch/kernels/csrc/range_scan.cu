// K5 range_scan: the Gram blocks and the accept scan of a subtree-range
// block, fused.
//
// Replaces the XLA-compiled core of FastSweeps._mega_range_lik
// (mcmcdate_tpu/engine/fast_sweep.py:1839-1874).  Each of the block's S
// tickets has a rank-1 distance delta coef_a g_a on RB rows (F = S RB <=
// 1024 rows in all).  Per chain:
//   G_ab  = g_a' Q[a, b] g_b                 (a <= b; Q = P between the rows)
//   dq_t  = 2 coef_t g_t . zg_t + coef_t^2 G_tt + 2 sum_{a < t accepted} coef_a G_at coef_t
//   accept_t = log u_t < bprior_c dpr_t - (beta_c dq_t) / 2 + lmhg_t
// (beta_c and bprior_c the chain's likelihood and prior temperatures: the
// JAX scan's la_t, fast_sweep.py:1860; bprior_c dpr_t is taken when d_pr is
// staged, by __fmul_rn, so a temperature of 1 keeps dpr_t's bits)
//
// What bounds it on the H100: operations.  The upper triangle of G is
// F^2 / 2 multiply-adds per chain (about 0.5 G at 1024 chains and F =
// 1024), against a few MB of inputs.  Q (up to 4 MB) stays in L2, but
// every CTA streams its upper triangle, so the L2 traffic is that times
// the number of CTAs: fewer chains per CTA mean more L2 traffic, more
// chains a longer serial walk per CTA.  Measured on the H100, the walk's
// latency dominates (a CTA's tickets are a chain of small dependent steps)
// down to 4 chains per CTA, where the largest blocks approach the L2's
// bandwidth.
//
// The design: one CTA of 256 threads owns a tile of 4 chains (256 CTAs at
// 1024 chains, two resident per SM, so one CTA's barriers and waits
// overlap the other's work) and walks the block's tickets t in order.  For
// ticket t it forms Y_t[c, m] = sum_j Q[m, t RB + j] g_t[c, j] for the rows
// m < (t + 1) RB only (the upper triangle a <= t), as a small GEMM: each
// thread holds 4 rows x 4 chains in registers; Q's columns of block t
// (rows of Q', which the caller lays out with a 16-byte pitch) are staged 8
// at a time into a ring of 4 shared-memory buffers (2 where F > 640) by
// bulk copies (one thread issues a copy per column, an mbarrier per buffer
// counts the bytes in), so up to three stages are in flight while one is
// used; each staged Q value is used for all 4 chains; g is kept in shared
// memory transposed ([row][chain]) so a thread reads the 4 chains' values
// as one float4 broadcast.  Then the CTA contracts Y_t with g_t (G_tt) and
// with the accepted deltas of the tickets before t (coef_a g_a, from g and
// each ticket's accepted coefficient), which gives dq_t with g_t . zg_t,
// and the scan step for t decides.  G is never stored: the scan needs only
// column t of G, once the decisions before t are known.  The tile's
// g_t . zg_t, coef, d_pr, lmhg and log u are computed or loaded into shared
// memory first, so the serial step reads no global memory.  Every sum runs
// in a fixed order (registers, warp butterflies, then the 8 warps in
// order), so results do not depend on scheduling.

#include <cuda_runtime.h>
#include <math.h>

#include "async_copy.cuh"
#include "lane_groups.cuh"

namespace {

using namespace mcmcdate;

constexpr int kChains = 4;         // chains per CTA
constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kRowsPerThread = 4;
constexpr int kFMax = kThreads * kRowsPerThread;  // 1024
constexpr int kKT = 8;             // Q columns per stage
constexpr int kSMax = 64;
// The ring of Q stages: 4 (three in flight while one is used) where two
// CTAs still fit on an SM, F <= kFDeep, else 2.
constexpr int kFDeep = 640;

// Shared-memory row pitch of a staged Q column: 16-byte rows.
__host__ __device__ inline int pitch(int F) { return (F + 3) / 4 * 4; }

int stages_for(int F) { return F <= kFDeep ? 4 : 2; }

size_t smem_bytes(int S, int F) {
  return sizeof(float) * ((size_t)stages_for(F) * kKT * pitch(F)  // Q stages
                          + (size_t)F * kChains             // g
                          + kWarps * kChains                // warp partials
                          + 6 * (size_t)kChains * S);       // v, coef, d_pr, lmhg, log u, steps
}

// Qt[j * ldq + m] = Q[m, j]: Q's columns as rows of pitch ldq (a multiple
// of 4 floats, 16-byte aligned), staged with 16-byte copies.
template <int kStages>
__global__ void __launch_bounds__(kThreads, 2)
    range_scan_kernel(const float* __restrict__ g, const float* __restrict__ zg,
                      const float* __restrict__ Qt, int ldq, const float* __restrict__ coef,
                      const float* __restrict__ d_pr, const float* __restrict__ lmhg,
                      const float* __restrict__ u, const float* __restrict__ beta,
                      const float* __restrict__ beta_prior, unsigned char* __restrict__ accept,
                      float* __restrict__ dq, int C, int S, int RB) {
  extern __shared__ __align__(16) float sm[];
  __shared__ unsigned long long bars[kStages];  // one per Q stage buffer
  const int F = S * RB;
  const int LDS = pitch(F);
  float* qs = sm;                         // [kStages][kKT][LDS]: Q[m, t RB + j0 + j] at [j][m]
  float* gT = qs + kStages * kKT * LDS;   // [F][kChains]
  float* red = gT + (size_t)F * kChains;  // [kWarps][kChains]
  float* vs = red + kWarps * kChains;     // [kChains][S] g_s . zg_s
  float* cs = vs + kChains * S;           // [kChains][S] coef
  float* dps = cs + kChains * S;          // [kChains][S] d_pr
  float* lms = dps + kChains * S;         // [kChains][S] lmhg
  float* lus = lms + kChains * S;         // [kChains][S] log u
  float* steps = lus + kChains * S;       // [kChains][S] coef if accepted, else 0
  const int tid = threadIdx.x;
  const int lane = tid % 32, warp = tid / 32;
  const int c0 = blockIdx.x * kChains;
  // The tile's likelihood temperatures, one a deciding thread (tid < kChains).
  const float bt = (tid < kChains && c0 + tid < C) ? beta[c0 + tid] : 1.f;

  const int kch = (RB + kKT - 1) / kKT;  // stages per ticket
  const int n_stages = S * kch;
  // Stage st (issued by thread 0): columns t RB + j0 + [0, kKT) of Q (rows
  // of Qt), rows m < (t + 1) RB rounded up to 16 bytes, one bulk copy per
  // column; columns past the ticket's RB are not copied (never read).
  auto stage = [&](int st) {
    if (st >= n_stages) return;
    const int t = st / kch, j0 = (st - t * kch) * kKT;
    const unsigned row_bytes = 16u * (((t + 1) * RB + 3) / 4);
    const int jn = min(kKT, RB - j0);
    float* dst = qs + (st % kStages) * kKT * LDS;
    const float* src = Qt + (size_t)(t * RB + j0) * ldq;
    unsigned long long* bar = &bars[st % kStages];
    mbar_expect_bytes(bar, jn * row_bytes);
    for (int j = 0; j < jn; ++j) bulk_copy(dst + j * LDS, src + (size_t)j * ldq, row_bytes, bar);
  };
  if (tid == 0) {
    for (int b = 0; b < kStages; ++b) mbar_init(&bars[b]);
  }
  // The chain tile first, with the Q stage buffers as scratch for the
  // products g zg.  Row-major over gT (conflict-free stores); the global
  // reads of a warp touch eight rows of 4 chains, and L1 keeps the lines
  // for the next rows.
  float* prod = qs;  // [F][kChains]
  for (int i = tid; i < kChains * F; i += kThreads) {
    const int m = i / kChains, cl = i % kChains;
    const int c = c0 + cl;
    const float gi = c < C ? g[(size_t)c * F + m] : 0.f;
    gT[i] = gi;
    prod[i] = c < C ? gi * zg[(size_t)c * F + m] : 0.f;
  }
  for (int i = tid; i < kChains * S; i += kThreads) {
    const int c = c0 + i / S;
    const size_t o = (size_t)c * S + i % S;
    const bool in = c < C;
    cs[i] = in ? coef[o] : 0.f;
    dps[i] = in ? __fmul_rn(beta_prior[c], d_pr[o]) : 0.f;
    lms[i] = in ? lmhg[o] : 0.f;
    lus[i] = in ? logf(u[o]) : 0.f;
    steps[i] = 0.f;
  }
  __syncthreads();
  // v = g_s . zg_s per (chain, ticket): a warp per pair, lanes over rows.
  for (int p = warp; p < kChains * S; p += kWarps) {
    const int cl = p / S, s0 = (p % S) * RB;
    float v = 0.f;
    for (int i = lane; i < RB; i += 32) v += prod[(s0 + i) * kChains + cl];
    v = warp_sum(v);
    if (lane == 0) vs[p] = v;
  }
  // The scratch writes and the barriers' initialisation before any bulk
  // copy into the same memory.
  fence_async_shared();
  __syncthreads();
  if (tid == 0) {
    for (int st = 0; st < kStages - 1; ++st) stage(st);
  }

  float acc[kRowsPerThread][kChains];
#pragma unroll
  for (int r = 0; r < kRowsPerThread; ++r)
#pragma unroll
    for (int k = 0; k < kChains; ++k) acc[r][k] = 0.f;

  for (int st = 0; st < n_stages; ++st) {
    const int t = st / kch, j0 = (st - t * kch) * kKT;
    const int lo = t * RB, n = lo + RB;
    __syncthreads();  // stage st - 1's buffer is no longer read
    if (tid == 0) stage(st + kStages - 1);  // into that buffer
    mbar_wait(&bars[st % kStages], (st / kStages) & 1);
    const float* qb = qs + (st % kStages) * kKT * LDS;
    const int jn = min(kKT, RB - j0);
#pragma unroll
    for (int j = 0; j < kKT; ++j) {
      if (j < jn) {
        const float4* gp = reinterpret_cast<const float4*>(gT + (lo + j0 + j) * kChains);
        float gv[kChains];
#pragma unroll
        for (int q = 0; q < kChains / 4; ++q) {
          const float4 v = gp[q];
          gv[4 * q] = v.x; gv[4 * q + 1] = v.y; gv[4 * q + 2] = v.z; gv[4 * q + 3] = v.w;
        }
#pragma unroll
        for (int r = 0; r < kRowsPerThread; ++r) {
          const int m = tid + r * kThreads;
          if (m < n) {
            const float q = qb[j * LDS + m];
#pragma unroll
            for (int k = 0; k < kChains; ++k) acc[r][k] += q * gv[k];
          }
        }
      }
    }
    if (j0 + kKT < RB) continue;
    // Ticket t's column is complete: per chain, the sum over rows of
    // coef_t g_t Y_t (rows of t) + 2 steps_a g_a Y_t (rows of the tickets a
    // before t), which is (coef_t^2 G_tt + 2 sum_{a < t accepted} X_at) /
    // coef_t; the scan step then adds 2 v_t and multiplies by coef_t.
    float part[kChains];
#pragma unroll
    for (int k = 0; k < kChains; ++k) part[k] = 0.f;
    if (warp * 32 < n) {
#pragma unroll
      for (int r = 0; r < kRowsPerThread; ++r) {
        const int m = tid + r * kThreads;
        if (m < lo) {
          const float* st_a = steps + m / RB;
#pragma unroll
          for (int k = 0; k < kChains; ++k)
            part[k] += 2.0f * st_a[k * S] * gT[m * kChains + k] * acc[r][k];
        } else if (m < n) {
#pragma unroll
          for (int k = 0; k < kChains; ++k)
            part[k] += cs[k * S + t] * gT[m * kChains + k] * acc[r][k];
        }
      }
#pragma unroll
      for (int k = 0; k < kChains; ++k) part[k] = warp_sum(part[k]);
    }
    if (lane == 0) {
#pragma unroll
      for (int k = 0; k < kChains; ++k) red[warp * kChains + k] = part[k];
    }
#pragma unroll
    for (int r = 0; r < kRowsPerThread; ++r)
#pragma unroll
      for (int k = 0; k < kChains; ++k) acc[r][k] = 0.f;
    __syncthreads();
    if (tid < kChains) {
      const int c = c0 + tid;
      if (c < C) {
        float sum = 0.f;
        for (int w = 0; w < kWarps; ++w) sum += red[w * kChains + tid];
        const int o = tid * S + t;
        const float ct = cs[o];
        const float dq_t = ct * (2.0f * vs[o] + sum);
        float la = dps[o] - 0.5f * (bt * dq_t) + lms[o];
        if (isnan(la)) la = -INFINITY;
        const bool ok = lus[o] < la;
        accept[(size_t)c * S + t] = ok;
        dq[(size_t)c * S + t] = dq_t;
        steps[o] = ok ? ct : 0.f;
      }
    }
    // The next stage's barrier orders `steps` and `red` before any use.
  }
}

}  // namespace

extern "C" int mcmcdate_range_scan_f32(const float* g, const float* zg, const float* Qt, int ldq,
                                       const float* coef, const float* d_pr, const float* lmhg,
                                       const float* u, const float* beta,
                                       const float* beta_prior, unsigned char* accept, float* dq,
                                       int C, int S, int RB,
                                       void* stream) {
  if (S > kSMax || S * RB > kFMax || ldq % 4 != 0 || ldq < S * RB ||
      reinterpret_cast<size_t>(Qt) % 16 != 0)
    return (int)cudaErrorInvalidValue;
  if (C == 0 || S == 0 || RB == 0) return (int)cudaGetLastError();
  const int F = S * RB;
  const size_t smem = smem_bytes(S, F);
  auto kernel = stages_for(F) == 4 ? range_scan_kernel<4> : range_scan_kernel<2>;
  if (smem > 48 * 1024) {
    const cudaError_t err =
        cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return (int)err;
  }
  kernel<<<(C + kChains - 1) / kChains, kThreads, smem, (cudaStream_t)stream>>>(
      g, zg, Qt, ldq, coef, d_pr, lmhg, u, beta, beta_prior, accept, dq, C, S, RB);
  return (int)cudaGetLastError();
}
