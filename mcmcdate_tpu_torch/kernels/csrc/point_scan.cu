// K4 point_scan: the sequential-correction accept scan of a point mega-step.
//
// Replaces the XLA-compiled correction scan of FastSweeps._mega_point_lik
// (mcmcdate_tpu/engine/fast_sweep.py:1477-1534).  Per chain, over the
// step's B tickets (each with a distance delta on KD rows), in sub-blocks
// of SUB tickets:
//   dq0_t = 2 delta_t . zG_t + delta_t' Pblk[t, t] delta_t
//   T_at  = delta_a' Pblk[a, t] delta_t                       (a < t)
//   dq_t  = dq0_t + 2 sum_{a < t accepted} T_at
//   accept_t = log u_t < dpr_t - dq_t / 2 + lmhg_t
// and between sub-blocks zG += sum_{a accepted} delta_a' Pblk[a, :].
//
// What bounds it on the H100: operations and the serial scan.  The cross
// terms are B SUB KD^2 multiply-adds per chain and the zG update at most
// (B KD)^2, all reading the step's Pblk (shared by every chain, at most
// 1536^2 floats for binary trees, so it streams from L2); the scan is SUB
// dependent steps per sub-block.  The design: one block per chain, with
// the chain's zG and deltas and the sub-block's T in shared memory; the
// block computes dq0 and T in parallel, one warp runs the scan with a
// warp-reduced correction over the accepted tickets, and the block applies
// the accepted deltas to the later columns of zG.

#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int kThreads = 256;

struct PointArgs {
  const float* delta;  // [C, B*KD]
  const float* zG;     // [C, B*KD]
  const float* Pblk;   // [B*KD, B*KD]
  const float* d_pr;   // [C, B]
  const float* lmhg;   // [C, B]
  const float* u;      // [C, B]
  unsigned char* accept;  // [C, B]
  float* dq;              // [C, B]
  int C, B, KD, SUB;
};

__global__ void __launch_bounds__(kThreads) point_scan_kernel(PointArgs a) {
  extern __shared__ float sm[];
  const int F = a.B * a.KD;
  const int S = a.SUB;
  float* zg = sm;             // [F]
  float* dl = zg + F;         // [F]
  float* T = dl + F;          // [S, S]
  float* dq0 = T + S * S;     // [S]
  int* acc_list = reinterpret_cast<int*>(dq0 + S);  // [S]
  __shared__ int n_acc;
  const int c = blockIdx.x;
  const int tid = threadIdx.x;
  const float* P = a.Pblk;
  for (int k = tid; k < F; k += blockDim.x) {
    zg[k] = a.zG[(size_t)c * F + k];
    dl[k] = a.delta[(size_t)c * F + k];
  }
  __syncthreads();
  const int n_sub = (a.B + S - 1) / S;
  for (int s0 = 0; s0 < n_sub; ++s0) {
    const int lo = s0 * S;
    const int sn = min(S, a.B - lo);
    for (int t = tid; t < sn; t += blockDim.x) {
      const int base = (lo + t) * a.KD;
      float lin = 0.f, self = 0.f;
      for (int i = 0; i < a.KD; ++i) lin += dl[base + i] * zg[base + i];
      for (int i = 0; i < a.KD; ++i) {
        float w = 0.f;
        for (int j = 0; j < a.KD; ++j) w += P[(size_t)(base + i) * F + base + j] * dl[base + j];
        self += dl[base + i] * w;
      }
      dq0[t] = 2.0f * lin + self;
    }
    for (int k = tid; k < sn * sn; k += blockDim.x) {
      const int ai = k / sn;
      const int bi = k - ai * sn;
      float v = 0.f;
      if (ai < bi) {
        const int ra = (lo + ai) * a.KD;
        const int rb = (lo + bi) * a.KD;
        for (int i = 0; i < a.KD; ++i) {
          float w = 0.f;
          for (int j = 0; j < a.KD; ++j) w += P[(size_t)(ra + i) * F + rb + j] * dl[rb + j];
          v += dl[ra + i] * w;
        }
      }
      T[ai * S + bi] = v;
    }
    __syncthreads();
    if (tid < 32) {
      const int lane = tid;
      int cnt = 0;
      for (int t = 0; t < sn; ++t) {
        float part = 0.f;
        for (int k = lane; k < cnt; k += 32) part += T[acc_list[k] * S + t];
        for (int off = 16; off > 0; off >>= 1) part += __shfl_xor_sync(0xffffffffu, part, off);
        part = __shfl_sync(0xffffffffu, part, 0);
        const size_t o = (size_t)c * a.B + lo + t;
        const float dq_t = dq0[t] + 2.0f * part;
        float la = a.d_pr[o] - 0.5f * dq_t + a.lmhg[o];
        if (isnan(la)) la = -INFINITY;
        const bool acc = logf(a.u[o]) < la;
        if (lane == 0) {
          a.accept[o] = acc;
          a.dq[o] = dq_t;
          if (acc) acc_list[cnt] = t;
        }
        __syncwarp();
        cnt += acc;
      }
      if (lane == 0) n_acc = cnt;
    }
    __syncthreads();
    if (s0 < n_sub - 1) {
      const int na = n_acc;
      for (int col = (lo + sn) * a.KD + tid; col < F; col += blockDim.x) {
        float add = 0.f;
        for (int k = 0; k < na; ++k) {
          const int r0 = (lo + acc_list[k]) * a.KD;
          for (int i = 0; i < a.KD; ++i) add += dl[r0 + i] * P[(size_t)(r0 + i) * F + col];
        }
        zg[col] += add;
      }
      __syncthreads();
    }
  }
}

}  // namespace

extern "C" int mcmcdate_point_scan_f32(const float* delta, const float* zG, const float* Pblk,
                                       const float* d_pr, const float* lmhg, const float* u,
                                       unsigned char* accept, float* dq, int C, int B, int KD,
                                       int SUB, void* stream) {
  PointArgs a{delta, zG, Pblk, d_pr, lmhg, u, accept, dq, C, B, KD, SUB};
  const size_t smem = (2 * (size_t)B * KD + (size_t)SUB * SUB + 2 * (size_t)SUB) * sizeof(float);
  if (smem > 48 * 1024) {
    cudaError_t err = cudaFuncSetAttribute(
        point_scan_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return (int)err;
  }
  if (C > 0 && B > 0) {
    point_scan_kernel<<<C, kThreads, smem, (cudaStream_t)stream>>>(a);
  }
  return (int)cudaGetLastError();
}
