// K4 point_scan: the sequential-correction accept scan of a point mega-step.
//
// Replaces the XLA-compiled correction scan of FastSweeps._mega_point_lik
// (mcmcdate_tpu/engine/fast_sweep.py:1477-1534).  Per chain, over the
// step's B tickets (each with a distance delta on KD rows; F = B KD rows in
// all), in sub-blocks of tickets:
//   dq0_t = 2 delta_t . zG_t + delta_t' Pblk[t, t] delta_t
//   T_at  = delta_a' Pblk[a, t] delta_t                       (a < t)
//   dq_t  = dq0_t + 2 sum_{a < t accepted} T_at
//   accept_t = log u_t < bprior_c dpr_t - (beta_c dq_t) / 2 + lmhg_t
// (beta_c and bprior_c the chain's likelihood and prior temperatures: the
// JAX scan's la_t, fast_sweep.py:1511; bprior_c dpr_t is taken when d_pr
// is loaded, by __fmul_rn, so a temperature of 1 keeps dpr_t's bits)
// and between sub-blocks zG += sum_{a accepted} delta_a' Pblk[a, :].
//
// What bounds it on the H100: the serial scan (one dependent step per
// ticket) and the reads of Pblk, which every chain needs (up to 1536^2
// floats, 9.4 MB, at 1000 taxa: L2-resident, but a block per chain would
// read it once per chain, about 10 GB of L2 traffic per step).  The operations are
// about F^2 / 2 multiply-adds per chain (the zG updates of the later
// columns) and F S KD for the scan.
//
// The design: a CTA of 8 warps takes a tile of 8 chains, so Pblk is read
// from L2 once per tile.  The scan is taken incrementally: a sub-block
// holds S = 192 / KD tickets (its diagonal block of Pblk, at most 192^2
// floats, fits in shared memory; sub-blocks change only the order of the
// sums).  For each sub-block the CTA
//   A. stages the diagonal block (16-byte cp.async: the caller pads
//      Pblk's rows to a 16-byte pitch) while each warp loads its chain's
//      deltas, zG, d_pr, lmhg and log u of the sub-block;
//   B. runs one warp per chain through the sub-block's tickets.  For KD
//      <= 3 lane l holds tickets l, l + 32, ... in registers (delta, zG
//      and the scan inputs) and the scan goes by windows of 32 tickets:
//      every lane forms its ticket's dq0 and its column of the window's
//      cross terms, T[k] = delta_k' Pblk[k, t] delta_t (k < l), in
//      registers; then at step k every lane evaluates its own ticket with
//      the accepted cross terms so far, a shuffle hands lane k's decision
//      to all, and each lane adds T[k] where it accepted.  So a step is a
//      compare, a shuffle and an add: no shared-memory load, no branch.
//      A rejected ticket's delta is zeroed, which leaves the accepted
//      deltas (dacc), and the window's dacc goes through the diagonal
//      block into the later windows' zG.  dq and the decisions are stored
//      after the sub-block.  Larger KD keeps the tickets in shared memory
//      (scan_shared);
//   C. streams the panels of Pblk's later columns (64 at a time from a
//      16-byte aligned column, two shared-memory buffers, 16-byte
//      cp.async) and adds dacc' Pblk[sub rows,
//      panel] to zG there: each warp takes a slice of the sub-block's rows
//      for all 8 chains ([row][chain] in shared memory, two float4 reads)
//      and 2 columns a lane (16 sums in registers per float2 of Pblk), and
//      the 8 slices are summed in a fixed order.
// The chains' zG lives in a scratch copy (zwork); the caller's zG is read
// only.  Every sum runs in a fixed order, so results do not depend on
// scheduling.

#include <cuda_runtime.h>
#include <math.h>

#include "async_copy.cuh"

namespace {

using namespace mcmcdate;

constexpr int kChains = 8;  // chains per CTA: one warp each in the scan
constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kRowsMax = 192;  // rows of a sub-block's diagonal block
constexpr int kPanel = 64;     // later columns per staged panel (2 per lane)
static_assert(kWarps == kChains, "one warp per chain in the scan");

struct PointArgs {
  const float* delta;  // [C, F]
  const float* zG;     // [C, F]
  const float* Pblk;   // [F, ldp], ldp a multiple of 4, 16-byte aligned
  const float* d_pr;   // [C, B]
  const float* lmhg;   // [C, B]
  const float* u;      // [C, B]
  const float* beta;   // [C] likelihood temperature
  const float* beta_prior;  // [C] prior temperature
  unsigned char* accept;  // [C, B]
  float* dq;              // [C, B]
  float* zwork;           // [C, F]
  int C, B, KD, S, ldp;   // S: tickets per sub-block
};

// The largest pitch of a staged diagonal block of n columns, which starts
// and ends on 16-byte boundaries.
__host__ __device__ inline int diag_pitch(int n) { return (n + 6 + 3) / 4 * 4; }

// Floats of the region that holds a diagonal block or two panels, for
// sub-blocks of at most n rows (a multiple of 4: 16-byte alignment after it).
__host__ __device__ inline int region_floats(int n) {
  const int diag = n * diag_pitch(n);
  const int r = diag > 2 * n * kPanel ? diag : 2 * n * kPanel;
  return (r + 3) / 4 * 4;
}

size_t smem_bytes(int n) {
  return sizeof(float) * ((size_t)region_floats(n) + 2 * (size_t)n * kChains  // dl, zl
                          + (size_t)kWarps * kChains * kPanel);              // red
}

// The scan of one chain whose tickets lie in shared memory (any KD): every
// lane forms dq_t (the same bits on every lane), and where ticket t accepts
// the lanes share the sub-block's later rows of zG.  Element (r, k) of the
// diagonal block is pd[r pitch + off + k].
__device__ __forceinline__ void scan_shared(const PointArgs& a, const float* pd, int pitch,
                                            int off, float* dl, float* z, int c, int warp,
                                            int lane, int lo, int sn, int n, float beta,
                                            float bprior) {
  for (int t0 = 0; t0 < sn; t0 += 32) {
    const int tt = t0 + lane;
    const size_t o = (size_t)c * a.B + lo + tt;
    const bool have = tt < sn;
    const float dpr_l = have ? __fmul_rn(bprior, a.d_pr[o]) : 0.f;
    const float lm_l = have ? a.lmhg[o] : -INFINITY;
    const float lu_l = have ? logf(a.u[o]) : 0.f;
    const int t1 = min(t0 + 32, sn);
    for (int t = t0; t < t1; ++t) {
      const float dpr = __shfl_sync(0xffffffffu, dpr_l, t - t0);
      const float lm = __shfl_sync(0xffffffffu, lm_l, t - t0);
      const float lu = __shfl_sync(0xffffffffu, lu_l, t - t0);
      const int base = t * a.KD;
      float lin = 0.f, self = 0.f;
      for (int i = 0; i < a.KD; ++i) lin += dl[(base + i) * kChains + warp] * z[base + i];
      for (int i = 0; i < a.KD; ++i) {
        float w = 0.f;
        for (int j = 0; j < a.KD; ++j) {
          w += pd[(base + i) * pitch + off + base + j] * dl[(base + j) * kChains + warp];
        }
        self += dl[(base + i) * kChains + warp] * w;
      }
      const float dq_t = 2.0f * lin + self;
      float la = dpr - 0.5f * (beta * dq_t) + lm;
      if (isnan(la)) la = -INFINITY;
      const bool acc = lu < la;
      __syncwarp();  // every lane has read this ticket's deltas before they change
      if (lane == 0) {
        a.accept[(size_t)c * a.B + lo + t] = acc;
        a.dq[(size_t)c * a.B + lo + t] = dq_t;
      }
      if (acc) {
        for (int k = base + a.KD + lane; k < n; k += 32) {
          float add = 0.f;
          for (int i = 0; i < a.KD; ++i) {
            add += dl[(base + i) * kChains + warp] * pd[(base + i) * pitch + off + k];
          }
          z[k] += add;
        }
      } else {
        for (int i = lane; i < a.KD; i += 32) dl[(base + i) * kChains + warp] = 0.f;
      }
      __syncwarp();
    }
  }
}

// KDT > 0: the scan with each lane's tickets (t = lane + 32 j) in registers,
// for KD = KDT; KDT = 0: any KD, the tickets in shared memory.
template <int KDT>
__global__ void __launch_bounds__(kThreads) point_scan_kernel(PointArgs a) {
  extern __shared__ __align__(16) float sm[];
  constexpr int KDR = KDT > 0 ? KDT : 1;
  constexpr int J = (kRowsMax / KDR + 31) / 32;  // tickets a lane holds
  const int KD = KDT > 0 ? KDT : a.KD;
  const int F = a.B * KD;
  const int n_max = a.S * KD;
  float* pd = sm;                            // diagonal block, or two panels [n][64]
  float* dl = pd + region_floats(n_max);     // deltas, then dacc [n][kChains]
  float* zl = dl + n_max * kChains;          // zG of the sub-block [kChains][n] (KDT = 0)
  float* red = zl + n_max * kChains;         // panel partials [kWarps][kChains][kPanel]
  const int tid = threadIdx.x;
  const int warp = tid / 32;
  const int lane = tid % 32;
  const int c0 = blockIdx.x * kChains;
  const int c = c0 + warp;                   // the chain this warp scans
  const float beta = c < a.C ? a.beta[c] : 1.f;
  const float bprior = c < a.C ? a.beta_prior[c] : 1.f;
  const float* P = a.Pblk;
  const int n_sub = (a.B + a.S - 1) / a.S;
  for (int s0 = 0; s0 < n_sub; ++s0) {
    const int lo = s0 * a.S;
    const int sn = min(a.S, a.B - lo);
    const int n = sn * KD;
    const int r0 = lo * KD;
    const float* zsrc = s0 == 0 ? a.zG : a.zwork;
    // A. The diagonal block (asynchronously: its columns from the 16-byte
    // boundary at or before r0), and each chain's deltas, zG and scan
    // inputs of the sub-block.
    const int cs = r0 & ~3;
    const int pitch = ((r0 + n + 3) & ~3) - cs;
    const int off = r0 - cs;
    for (int e = tid; e < n * (pitch / 4); e += kThreads) {
      const int rr = e / (pitch / 4);
      const int k4 = 4 * (e - rr * (pitch / 4));
      cp_async_f32x4(&pd[rr * pitch + k4], &P[(size_t)(r0 + rr) * a.ldp + cs + k4], true);
    }
    cp_async_commit();
    float dr[J][KDR], zr[J][KDR], dpr[J], lm[J], lu[J], dqr[J];
    if constexpr (KDT > 0) {
#pragma unroll
      for (int j = 0; j < J; ++j) {
        const int t = 32 * j + lane;
        const bool have = c < a.C && t < sn;
        const size_t o = (size_t)c * a.B + lo + t;
        const size_t row = (size_t)c * F + r0 + t * KD;
#pragma unroll
        for (int i = 0; i < KDR; ++i) {
          dr[j][i] = have ? a.delta[row + i] : 0.f;
          zr[j][i] = have ? zsrc[row + i] : 0.f;
        }
        dpr[j] = have ? __fmul_rn(bprior, a.d_pr[o]) : 0.f;
        lm[j] = have ? a.lmhg[o] : -INFINITY;
        lu[j] = have ? logf(a.u[o]) : 0.f;
        dqr[j] = 0.f;
      }
    } else {
      for (int e = tid; e < kChains * n; e += kThreads) {
        const int ch = e / n;
        const int k = e - ch * n;
        const bool ok = c0 + ch < a.C;
        dl[k * kChains + ch] = ok ? a.delta[(size_t)(c0 + ch) * F + r0 + k] : 0.f;
        zl[ch * n + k] = ok ? zsrc[(size_t)(c0 + ch) * F + r0 + k] : 0.f;
      }
    }
    cp_async_wait<0>();
    __syncthreads();
    // B. The scan, a warp per chain.
    if constexpr (KDT > 0) {
      // Element (r, col) of the diagonal block.
      auto P_at = [&](int r, int col) { return pd[r * pitch + off + col]; };
      unsigned acc_bits = 0;  // bit w: ticket 32 w + lane accepted
#pragma unroll
      for (int w = 0; w < J; ++w) {
        if (32 * w >= sn) break;
        const int t = min(32 * w + lane, sn - 1);  // this lane's ticket of the window
        // dq0 = 2 delta . zG + delta' Pblk[t, t] delta, and the window's
        // cross terms T[k] = delta_k' Pblk[k, t] delta_t (k < lane matter).
        float lin = 0.f, self = 0.f;
#pragma unroll
        for (int i = 0; i < KDR; ++i) {
          float v = 0.f;
#pragma unroll
          for (int k = 0; k < KDR; ++k) v += P_at(t * KD + i, t * KD + k) * dr[w][k];
          lin += dr[w][i] * zr[w][i];
          self += dr[w][i] * v;
        }
        const float dq0 = 2.0f * lin + self;
        float T[32];
#pragma unroll
        for (int k = 0; k < 32; ++k) {
          const int tk = min(32 * w + k, sn - 1);
          float v = 0.f;
#pragma unroll
          for (int i = 0; i < KDR; ++i) {
            const float dk = __shfl_sync(0xffffffffu, dr[w][i], k);
            float pv = 0.f;
#pragma unroll
            for (int j = 0; j < KDR; ++j) pv += P_at(tk * KD + i, t * KD + j) * dr[w][j];
            v += dk * pv;
          }
          T[k] = v;
        }
        // The scan: at step k every lane evaluates its own ticket with the
        // accepted cross terms so far; lane k's is final and decides.
        float corr = 0.f, dq_mine = 0.f;
        bool acc_mine = false;
#pragma unroll
        for (int k = 0; k < 32; ++k) {
          const float dq_l = dq0 + 2.0f * corr;
          float la = dpr[w] - 0.5f * (beta * dq_l) + lm[w];
          if (isnan(la)) la = -INFINITY;
          const bool acc = __shfl_sync(0xffffffffu, (int)(lu[w] < la), k) != 0;
          dq_mine = lane == k ? dq_l : dq_mine;
          acc_mine = lane == k ? acc : acc_mine;
          corr += acc ? T[k] : 0.f;
        }
        dqr[w] = dq_mine;
        acc_bits |= (unsigned)acc_mine << w;
        // The accepted deltas (dacc) of the window, and the later windows'
        // zG with them.
#pragma unroll
        for (int i = 0; i < KDR; ++i) dr[w][i] = acc_mine ? dr[w][i] : 0.f;
#pragma unroll
        for (int w2 = w + 1; w2 < J; ++w2) {
          if (32 * w2 >= sn) break;
          const int t2 = min(32 * w2 + lane, sn - 1);
#pragma unroll 4
          for (int k = 0; k < 32; ++k) {
            const int tk = min(32 * w + k, sn - 1);
#pragma unroll
            for (int i = 0; i < KDR; ++i) {
              const float dk = __shfl_sync(0xffffffffu, dr[w][i], k);
#pragma unroll
              for (int j = 0; j < KDR; ++j) zr[w2][j] += dk * P_at(tk * KD + i, t2 * KD + j);
            }
          }
        }
      }
      // The decisions, dq and the accepted deltas (zero for rejected
      // tickets and absent chains, for the later columns).
#pragma unroll
      for (int w = 0; w < J; ++w) {
        const int t = 32 * w + lane;
        if (t >= sn) continue;
        if (c < a.C) {
          a.accept[(size_t)c * a.B + lo + t] = (acc_bits >> w) & 1u;
          a.dq[(size_t)c * a.B + lo + t] = dqr[w];
        }
#pragma unroll
        for (int i = 0; i < KDR; ++i) dl[(t * KD + i) * kChains + warp] = dr[w][i];
      }
    } else if (c < a.C) {
      scan_shared(a, pd, pitch, off, dl, zl + warp * n, c, warp, lane, lo, sn, n, beta,
                  bprior);
    }
    __syncthreads();
    if (s0 == n_sub - 1) break;
    // C. The later columns: zwork = zsrc + dacc' Pblk[sub rows, col] for
    // col >= col0, in panels from the 16-byte boundary at or before col0.
    const int col0 = r0 + n;
    const int ps = col0 & ~3;
    const int n_pan = (F - ps + kPanel - 1) / kPanel;
    float* pan[2] = {pd, pd + n * kPanel};
    auto stage = [&](int p, float* buf) {
      for (int e = tid; e < n * (kPanel / 4); e += kThreads) {
        const int rr = e / (kPanel / 4);
        const int k4 = 4 * (e - rr * (kPanel / 4));
        const int col = ps + p * kPanel + k4;
        cp_async_f32x4(&buf[rr * kPanel + k4],
                       &P[(size_t)(r0 + rr) * a.ldp + (col < a.ldp ? col : 0)], col < a.ldp);
      }
      cp_async_commit();
    };
    const int nr = (n + kWarps - 1) / kWarps;
    const int rlo = warp * nr;
    const int rhi = min(n, rlo + nr);
    constexpr int kOut = kChains * kPanel / kThreads;  // outputs a thread finishes
    stage(0, pan[0]);
    for (int p = 0; p < n_pan; ++p) {
      if (p + 1 < n_pan) {
        stage(p + 1, pan[(p + 1) & 1]);
        cp_async_wait<1>();
      } else {
        cp_async_wait<0>();
      }
      // This thread's outputs' old zG, loaded while the panel is used.
      float zold[kOut];
#pragma unroll
      for (int m = 0; m < kOut; ++m) {
        const int e = tid + m * kThreads;
        const int cc = c0 + e / kPanel;
        const int col = ps + p * kPanel + e % kPanel;
        zold[m] = (cc < a.C && col >= col0 && col < F) ? zsrc[(size_t)cc * F + col] : 0.f;
      }
      __syncthreads();
      const float* buf = pan[p & 1];
      float acc[kChains][2];
#pragma unroll
      for (int ch = 0; ch < kChains; ++ch) acc[ch][0] = acc[ch][1] = 0.f;
#pragma unroll 4
      for (int r = rlo; r < rhi; ++r) {
        const float4 a0 = *reinterpret_cast<const float4*>(&dl[r * kChains]);
        const float4 a1 = *reinterpret_cast<const float4*>(&dl[r * kChains + 4]);
        const float2 pv = *reinterpret_cast<const float2*>(&buf[r * kPanel + 2 * lane]);
        const float av[kChains] = {a0.x, a0.y, a0.z, a0.w, a1.x, a1.y, a1.z, a1.w};
#pragma unroll
        for (int ch = 0; ch < kChains; ++ch) {
          acc[ch][0] += av[ch] * pv.x;
          acc[ch][1] += av[ch] * pv.y;
        }
      }
#pragma unroll
      for (int ch = 0; ch < kChains; ++ch) {
        *reinterpret_cast<float2*>(&red[(warp * kChains + ch) * kPanel + 2 * lane]) =
            make_float2(acc[ch][0], acc[ch][1]);
      }
      __syncthreads();
#pragma unroll
      for (int m = 0; m < kOut; ++m) {
        const int e = tid + m * kThreads;
        const int ch = e / kPanel;
        const int k = e % kPanel;
        const int col = ps + p * kPanel + k;
        const int cc = c0 + ch;
        if (cc >= a.C || col < col0 || col >= F) continue;
        float s = 0.f;
        for (int g = 0; g < kWarps; ++g) s += red[(g * kChains + ch) * kPanel + k];
        a.zwork[(size_t)cc * F + col] = zold[m] + s;
      }
    }
    __syncthreads();
  }
}

template <int KDT>
int launch(const PointArgs& a, size_t smem, cudaStream_t stream) {
  if (smem > 48 * 1024) {
    cudaError_t err = cudaFuncSetAttribute(
        point_scan_kernel<KDT>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return (int)err;
  }
  point_scan_kernel<KDT><<<(a.C + kChains - 1) / kChains, kThreads, smem, stream>>>(a);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" int mcmcdate_point_scan_f32(const float* delta, const float* zG, const float* Pblk,
                                       const float* d_pr, const float* lmhg, const float* u,
                                       const float* beta, const float* beta_prior,
                                       unsigned char* accept, float* dq,
                                       float* zwork, int C, int B, int KD, int ldp,
                                       void* stream) {
  if (KD < 1 || KD > kRowsMax || ldp % 4 || ldp < B * KD ||
      reinterpret_cast<size_t>(Pblk) % 16) {
    return (int)cudaErrorInvalidValue;
  }
  const int S = B < kRowsMax / KD ? B : kRowsMax / KD;
  PointArgs a{delta,  zG, Pblk,  d_pr, lmhg, u, beta, beta_prior,
              accept, dq, zwork, C,    B,    KD, S, ldp};
  if (C <= 0 || B <= 0) return (int)cudaGetLastError();
  const size_t smem = smem_bytes(S * KD);
  cudaStream_t st = (cudaStream_t)stream;
  switch (KD) {
    case 1: return launch<1>(a, smem, st);
    case 2: return launch<2>(a, smem, st);
    case 3: return launch<3>(a, smem, st);
    default: return launch<0>(a, smem, st);
  }
}
