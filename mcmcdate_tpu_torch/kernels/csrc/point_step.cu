// K4's point mega-step around point_scan: its prologue and epilogue.
//
// Together with point_scan_kernel (csrc/point_scan.cu) and the product
// z += dacc @ Prow they replace the XLA-compiled FastSweeps._mega_point_lik
// (mcmcdate_tpu/engine/fast_sweep.py:1324-1565).  A step holds B tickets on
// nodes with no parent-child pair among them: the node kind slides node i's
// height from a truncated normal between its oldest child and its parent,
// the branch kind scales i's rate by a gamma factor.  Each ticket touches
// the distance rows d_rows[b, :KD] (i's branch, and for a slide its
// children's) and the term rows t_rows[b, :KT].
//
// point_lik_prologue_kernel: from the injected draw, the proposal (the new
// height, or the rate factor) and its log ratio lq, the new birth-death (in
// double), clock and calibration terms tn, the distance deltas
// delta = d_new - d_old, d_pr, lmhg = (invalid or pad) ? -inf : lq, and,
// with a likelihood (z not null), the carried z at the distance rows (zG).
// point_lik_epilogue_kernel: for the accepted tickets, the stores of the new
// height or rate and terms, d += delta (rows are disjoint within a step, so
// plain stores suffice), the accept counts, q += the accepted dq (summed
// in a fixed order; skipped without a likelihood, dq null), and dacc (delta
// where accepted, else 0) for the z update.  Without a likelihood it also
// takes the decisions, log u < d_pr + lmhg (u_acc not null, accept written).
//
// What bounds them on the H100: special functions (the inverse normal CDF
// and erfc, or lgamma, and the birth-death exp/log in double for up to
// 1 + KC nodes per ticket), a few gathered floats per (chain, ticket) in and
// out.  The design: the prologue takes a thread per (chain, ticket), its
// terms in registers (KT <= 64); the epilogue a lane per (chain, ticket),
// and the first warp of each chain sums q over its tickets in a fixed
// order.  Both mirror
// their plain versions (kernels/point_step.py) operation by operation and
// are built with -fmad=false; the normal CDF, its inverse and log are
// CUDA's, so a slide's proposal may differ from the plain one in its last
// bits.

#include <cuda_runtime.h>
#include <math.h>

#include "device_math.cuh"
#include "lane_groups.cuh"

namespace {

using namespace mcmcdate;

constexpr int kThreads = 256;
constexpr int kKtMax = 64;

struct PrologueArgs {
  const float* heights;  // [C, N]
  const float* rates;    // [C, N]
  const float* terms;    // [C, T]
  const float* d;        // [C, D]
  const float* z;        // [C, D], null without a likelihood
  const float* tuning;   // [C, P]
  const float* birth;    // [C]
  const float* death;
  const float* rate_var;
  const float* height;
  const float* rate_mean;
  const int* node;    // [B]
  const int* par;     // [B]
  const int* ch;      // [B, KC], -1 padding
  const int* t_rows;  // [B, KT], -1 padding
  const int* d_rows;  // [B, KD], -1 padding
  const int* rows;    // [B]
  const unsigned char* valid;  // [B]
  const float* sd;             // [B]
  const float* cal_lo;         // [B, KN]
  const float* cal_lo_s;
  const float* cal_hi;
  const float* cal_hi_s;
  const unsigned char* is_leaf;  // [N]
  const int* pos;                // [N] distance row of each node's branch
  const float* draw;             // [C, B]
  float* prop;   // [C, B]
  float* lq;     // [C, B]
  float* tn;     // [C, B, KT]
  float* delta;  // [C, B, KD]
  float* d_pr;   // [C, B]
  float* lmhg;   // [C, B]
  float* zG;     // [C, B, KD] (with z)
  int C, B, N, T, P, D, KC, KT, KD, KN, clock_model, branch;
};

__global__ void __launch_bounds__(kThreads) point_lik_prologue_kernel(PrologueArgs a) {
  const long idx = (long)blockIdx.x * blockDim.x + threadIdx.x;
  if (idx >= (long)a.C * a.B) return;
  const int c = (int)(idx / a.B);
  const int b = (int)(idx - (long)c * a.B);
  const float* h = a.heights + (size_t)c * a.N;
  const float* r = a.rates + (size_t)c * a.N;
  const float* te = a.terms + (size_t)c * a.T;
  const float* dc = a.d + (size_t)c * a.D;
  const int i = a.node[b];
  const int p = a.par[b];
  const int* ch = a.ch + (size_t)b * a.KC;
  const int* tr = a.t_rows + (size_t)b * a.KT;
  const int* dr = a.d_rows + (size_t)b * a.KD;
  const float tune = a.tuning[(size_t)c * a.P + a.rows[b]];
  const float sd = a.sd[b];
  const float dw = a.draw[idx];
  const float var = a.rate_var[c];
  float* tn = a.tn + (size_t)idx * a.KT;
  float* delta = a.delta + (size_t)idx * a.KD;
  float prop, lq;
  float tv[kKtMax];
  if (a.branch) {
    // gamma_scale_sample: u = g (tune / shape); gamma_scale_lq at u.
    prop = dw * (tune / sd);
    const float k = sd / tune;
    const float theta = tune / sd;
    const float logu = logf(prop);
    const float base =
        gamma_logpdf(k, theta, 1.0f / prop) - gamma_logpdf(k, theta, prop) - 2.0f * logu;
    lq = base + logu;
    tv[0] = clock_term_local(a.clock_model, r[i] * prop, h[p] - h[i], var);
    for (int k2 = 1; k2 < a.KT; ++k2) tv[k2] = 0.f;
    for (int s = 0; s < a.KD; ++s) {
      const bool ok = dr[s] >= 0;
      const float d_old = dc[ok ? dr[s] : 0];
      delta[s] = ok ? d_old * prop - d_old : 0.f;
    }
  } else {
    const float hi = h[i];
    const float hp = h[p];
    float hc_max = -INFINITY;
    for (int j = 0; j < a.KC; ++j) {
      if (ch[j] >= 0) hc_max = fmaxf(hc_max, h[ch[j]]);
    }
    truncnorm_sample(dw, hi, sd, tune, hc_max, hp, &prop, &lq);
    const float hnew = prop;
    const double la = a.birth[c], mu = a.death[c];
    tv[0] = bd_term_local(hnew, hp, false, la, mu);
    tv[1] = clock_term_local(a.clock_model, r[i], hp - hnew, var);
    for (int j = 0; j < a.KC; ++j) {
      const int cj = ch[j];
      if (cj >= 0) {
        const float hc = h[cj];
        tv[2 + j] = bd_term_local(hc, hnew, a.is_leaf[cj] != 0, la, mu);
        tv[2 + a.KC + j] = clock_term_local(a.clock_model, r[cj], hnew - hc, var);
      } else {
        tv[2 + j] = 0.f;
        tv[2 + a.KC + j] = 0.f;
      }
    }
    for (int j = 0; j < a.KN; ++j) {
      const size_t k = (size_t)b * a.KN + j;
      tv[2 * (1 + a.KC) + j] = cal_term_local(hnew, a.height[c], a.cal_lo[k], a.cal_lo_s[k],
                                              a.cal_hi[k], a.cal_hi_s[k]);
    }
    // The node's own branch gets t = hp - hnew, a child c's t = hnew - h_c;
    // d = (height rate_mean) t r.
    const float sc = a.height[c] * a.rate_mean[c];
    const int pos_i = a.pos[i];
    for (int s = 0; s < a.KD; ++s) {
      if (dr[s] < 0) {
        delta[s] = 0.f;
        continue;
      }
      float t_val = 0.f, r_val = 0.f;
      if (dr[s] == pos_i) {
        t_val = hp - hnew;
        r_val = r[i];
      }
      for (int j = 0; j < a.KC; ++j) {
        const int cj = ch[j];
        if (cj >= 0 && dr[s] == a.pos[cj]) {
          t_val = hnew - h[cj];
          r_val = r[cj];
        }
      }
      const float d_old = dc[dr[s]];
      delta[s] = sc * t_val * r_val - d_old;
    }
  }
  float dp = 0.f;
  bool bad = false;
  for (int k = 0; k < a.KT; ++k) {
    tn[k] = tv[k];
    if (tr[k] < 0) continue;
    const float diff = tv[k] - te[tr[k]];
    if (!isnan(diff)) dp += diff;
    bad = bad || is_bad(tv[k]);
  }
  a.prop[idx] = prop;
  a.lq[idx] = lq;
  a.d_pr[idx] = dp;
  a.lmhg[idx] = (bad || !a.valid[b]) ? -INFINITY : lq;
  if (a.z == nullptr) return;
  const float* zc = a.z + (size_t)c * a.D;
  for (int s = 0; s < a.KD; ++s) a.zG[(size_t)idx * a.KD + s] = dr[s] >= 0 ? zc[dr[s]] : 0.f;
}

struct EpilogueArgs {
  float* heights;  // [C, N]
  float* rates;    // [C, N]
  float* terms;    // [C, T]
  float* d;        // [C, D]
  float* q;        // [C]
  int* acc;        // [C, P]
  float* dacc;     // [C, B, KD]
  unsigned char* accept;        // [C, B] (written when u_acc is given)
  const float* dq;              // [C, B], null without a likelihood
  const float* u_acc;           // [C, B], null with a likelihood
  const float* d_pr;            // [C, B]
  const float* lmhg;            // [C, B]
  const float* prop;            // [C, B]
  const float* tn;              // [C, B, KT]
  const float* delta;           // [C, B, KD]
  const int* node;              // [B]
  const int* t_rows;            // [B, KT]
  const int* d_rows;            // [B, KD]
  const int* rows;              // [B]
  const unsigned char* valid;   // [B]
  int C, B, N, T, P, D, KT, KD, branch;
};

// A lane per (chain, ticket): warp k of chain c takes tickets 32 k .. 32 k +
// 31; with a likelihood, warp 0 of each chain also sums q over all its
// tickets, lanes over the tickets, in a fixed order.
__global__ void __launch_bounds__(kThreads) point_lik_epilogue_kernel(EpilogueArgs a) {
  const long w = ((long)blockIdx.x * blockDim.x + threadIdx.x) / 32;
  const int lane = threadIdx.x % 32;
  const int chunks = (a.B + 31) / 32;
  if (w >= (long)a.C * chunks) return;  // whole warps
  const int c = (int)(w / chunks);
  const int chunk = (int)(w - (long)c * chunks);
  const int b = chunk * 32 + lane;
  if (b < a.B) {
    const size_t cb = (size_t)c * a.B + b;
    bool ok;
    if (a.u_acc != nullptr) {
      // The plain version's log u < (NaN ? -inf : d_pr + lmhg): a NaN
      // compares false as well.
      ok = logf(a.u_acc[cb]) < a.d_pr[cb] + a.lmhg[cb] && a.valid[b];
      a.accept[cb] = ok;
    } else {
      ok = a.accept[cb] && a.valid[b];
    }
    const int* dr = a.d_rows + (size_t)b * a.KD;
    float* dc = a.d + (size_t)c * a.D;
    for (int s = 0; s < a.KD; ++s) {
      const float dl = (ok && dr[s] >= 0) ? a.delta[cb * a.KD + s] : 0.f;
      a.dacc[cb * a.KD + s] = dl;
      if (ok && dr[s] >= 0) dc[dr[s]] += dl;
    }
    if (ok) {
      const int i = a.node[b];
      if (a.branch) {
        float* r = a.rates + (size_t)c * a.N;
        r[i] = r[i] * a.prop[cb];
      } else {
        a.heights[(size_t)c * a.N + i] = a.prop[cb];
      }
      float* te = a.terms + (size_t)c * a.T;
      const int* tr = a.t_rows + (size_t)b * a.KT;
      for (int k = 0; k < a.KT; ++k) {
        if (tr[k] >= 0) te[tr[k]] = a.tn[cb * a.KT + k];
      }
      a.acc[(size_t)c * a.P + a.rows[b]] += 1;
    }
  }
  if (chunk == 0 && a.dq != nullptr) {
    float q_acc = 0.f;
    for (int t = lane; t < a.B; t += 32) {
      const size_t ct = (size_t)c * a.B + t;
      if (a.accept[ct] && a.valid[t]) q_acc += a.dq[ct];
    }
    q_acc = warp_sum(q_acc);
    if (lane == 0) a.q[c] = a.q[c] + q_acc;
  }
}

int blocks_for(long threads) { return (int)((threads + kThreads - 1) / kThreads); }

}  // namespace

extern "C" int mcmcdate_point_lik_prologue_f32(
    const float* heights, const float* rates, const float* terms, const float* d, const float* z,
    const float* tuning, const float* birth, const float* death, const float* rate_var,
    const float* height, const float* rate_mean, const int* node, const int* par, const int* ch,
    const int* t_rows, const int* d_rows, const int* rows, const unsigned char* valid,
    const float* sd, const float* cal_lo, const float* cal_lo_s, const float* cal_hi,
    const float* cal_hi_s, const unsigned char* is_leaf, const int* pos, const float* draw,
    float* prop, float* lq, float* tn, float* delta, float* d_pr, float* lmhg, float* zG, int C,
    int B, int N, int T, int P, int D, int KC, int KT, int KD, int KN, int clock_model,
    int branch, void* stream) {
  if (KT > kKtMax || (!branch && 2 * (1 + KC) + KN != KT)) return (int)cudaErrorInvalidValue;
  PrologueArgs a{heights, rates,   terms,    d,        z,      tuning,   birth,  death,
                 rate_var, height, rate_mean, node,    par,    ch,       t_rows, d_rows,
                 rows,    valid,   sd,       cal_lo,   cal_lo_s, cal_hi, cal_hi_s, is_leaf,
                 pos,     draw,    prop,     lq,       tn,     delta,    d_pr,   lmhg,
                 zG,      C,       B,        N,        T,      P,        D,      KC,
                 KT,      KD,      KN,       clock_model, branch};
  const long n = (long)C * B;
  if (n > 0) {
    point_lik_prologue_kernel<<<blocks_for(n), kThreads, 0, (cudaStream_t)stream>>>(a);
  }
  return (int)cudaGetLastError();
}

extern "C" int mcmcdate_point_lik_epilogue_f32(
    float* heights, float* rates, float* terms, float* d, float* q, int* acc, float* dacc,
    unsigned char* accept, const float* dq, const float* u_acc, const float* d_pr,
    const float* lmhg, const float* prop, const float* tn, const float* delta, const int* node,
    const int* t_rows, const int* d_rows, const int* rows, const unsigned char* valid, int C,
    int B, int N, int T, int P, int D, int KT, int KD, int branch, void* stream) {
  // With the decisions taken here, the sum of q would read other warps'.
  if (u_acc != nullptr && dq != nullptr) return (int)cudaErrorInvalidValue;
  EpilogueArgs a{heights, rates, terms,  d,    q,    acc,    dacc,   accept, dq,
                 u_acc,   d_pr,  lmhg,   prop, tn,   delta,  node,   t_rows, d_rows,
                 rows,    valid, C,      B,    N,    T,      P,      D,      KT,
                 KD,      branch};
  const long warps = (long)C * ((B + 31) / 32);
  if (warps > 0) {
    point_lik_epilogue_kernel<<<blocks_for(32 * warps), kThreads, 0, (cudaStream_t)stream>>>(a);
  }
  return (int)cudaGetLastError();
}
