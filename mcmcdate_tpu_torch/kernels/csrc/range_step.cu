// K5's likelihood range-block step around range_scan: its prologue and
// epilogue.
//
// Together with range_scan_kernel (csrc/range_scan.cu) and the product
// z += dacc @ Prow they replace the XLA-compiled FastSweeps._mega_range_lik
// (mcmcdate_tpu/engine/fast_sweep.py:1695-1909).  A block holds S tickets;
// ticket s scales the subtree of node i (rows own[s, :], pre-order,
// disjoint from the other tickets' subtrees): the ultrametric kind draws
// h_i' from a truncated normal on (0, h_parent) and scales the heights
// inside by f = h_i'/h_i (the subtree root keeps its parent), the rate kind
// scales the rates inside by a gamma factor f.  Every distance of the
// subtree moves by (f - 1) g, so the likelihood change is the rank-1 form
// that range_scan evaluates.
//
// range_lik_prologue_kernel: from the injected draw, the proposal and its
// log ratio lq (with the Jacobian's log f terms), each row's new height or
// rate with its birth-death (in double) and clock terms, the calibration
// terms inside the range, d_pr, lmhg = invalid ? -inf : lq, coef = f - 1,
// and each row's delta direction g and, with a likelihood (z not null), its
// carried z (zg).
// range_lik_epilogue_kernel: for the accepted tickets, the stores of the
// new heights or rates and terms, d += coef g (rows are disjoint within a
// block, so plain stores suffice), the accept counts, q += the accepted
// dq (summed in a fixed order; skipped without a likelihood, dq null), and
// dacc (coef g where accepted, else 0) for the z update.  Without a
// likelihood it also takes the decisions, log u < d_pr + lmhg (u_acc not
// null, accept written).
//
// What bounds them on the H100: special functions (the inverse normal CDF
// and erfc, or lgamma, per ticket; the birth-death exp/log in double and a
// gamma or log-normal density per row), a few gathered floats per row in
// and out.  The design: the prologue takes a group of lanes per (chain,
// ticket), as many as the block's rows rounded up to a power of 2 and at
// most a warp (16 for the 15-row blocks of the smallest bucket, two
// tickets per warp); every lane of a group evaluates the ticket's proposal
// (no lane waits for another), the lanes stride over the subtree's rows
// and calibration slots, and shuffles within the group sum d_pr, so a
// 256-row subtree is 8 rows per lane, not 256 for one thread (what holds
// K6's range mode at a few percent of its bound).
// It stores each row's new values, so the epilogue only selects and
// stores, with one warp per (chain, ticket) as well, its lanes over the
// rows.  Both mirror their plain versions (kernels/range_step.py)
// operation by operation and are built with -fmad=false; the normal CDF,
// its inverse and log are CUDA's, so a proposal may differ from the plain
// one in its last bits.

#include <cuda_runtime.h>
#include <math.h>

#include "device_math.cuh"
#include "lane_groups.cuh"

namespace {

using namespace mcmcdate;

constexpr int kThreads = 256;
constexpr int kWarpsPerBlock = kThreads / 32;

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
  const int* node;     // [S]
  const int* par;      // [S]
  const int* own;      // [S, RB], -1 padding
  const int* own_par;  // [S, RB]
  const int* d_flat;   // [S, RB] distance row of each covered node
  const int* rows;     // [S]
  const unsigned char* valid;  // [S]
  const float* sd;             // [S]
  const int* n_inner;          // [S]
  const int* n_nodes;          // [S]
  const int* cal_t_rows;  // [S, KN], -1 padding
  const int* cal_hsrc;    // [S, KN]
  const float* cal_lo;    // [S, KN]
  const float* cal_lo_s;
  const float* cal_hi;
  const float* cal_hi_s;
  const unsigned char* is_leaf;  // [N]
  const float* draw;             // [C, S]
  float* prop;    // [C, S]
  float* lq;      // [C, S]
  float* coef;    // [C, S]
  float* d_pr;    // [C, S]
  float* lmhg;    // [C, S]
  float* g;       // [C, S, RB]
  float* zg;      // [C, S, RB] (with z)
  float* x_new;   // [C, S, RB]
  float* bd_new;  // [C, S, RB] (ultrametric only)
  float* ck_new;  // [C, S, RB]
  float* cal_new;  // [C, S, KN]
  int C, S, N, T, P, D, RB, KN, clock_model, rate;
};

// One group of `width` lanes per (chain, ticket); the groups of a warp
// never return early, so that every lane takes part in the shuffles.
__global__ void __launch_bounds__(kThreads) range_lik_prologue_kernel(PrologueArgs a, int width) {
  const long gid = ((long)blockIdx.x * blockDim.x + threadIdx.x) / width;
  const int lane = threadIdx.x % width;
  const bool live = gid < (long)a.C * a.S;
  const int c = live ? (int)(gid / a.S) : 0;
  const int s = live ? (int)(gid - (long)c * a.S) : 0;
  const bool act = live && a.valid[s];
  const size_t cs = (size_t)c * a.S + s;
  const size_t out0 = cs * a.RB;
  const float* h = a.heights + (size_t)c * a.N;
  const float* r = a.rates + (size_t)c * a.N;
  const float* te = a.terms + (size_t)c * a.T;
  const int i = a.node[s];
  float prop = NAN, f = NAN, lq = NAN;
  if (act) {
    const float tune = a.tuning[(size_t)c * a.P + a.rows[s]];
    const float sd = a.sd[s];
    const float dr = a.draw[cs];
    if (a.rate) {
      // gamma_scale_sample: u = g (tune / shape); gamma_scale_lq at u.
      f = dr * (tune / sd);
      prop = f;
      const float k = sd / tune;
      const float theta = tune / sd;
      const float logu = logf(f);
      const float base =
          gamma_logpdf(k, theta, 1.0f / f) - gamma_logpdf(k, theta, f) - 2.0f * logu;
      lq = base + (float)a.n_nodes[s] * logu;
    } else {
      const float hi = h[i];
      truncnorm_sample(dr, hi, sd, tune, 0.f, h[a.par[s]], &prop, &lq);
      f = prop / hi;
      lq = lq + (float)(a.n_inner[s] - 1) * logf(f);
    }
  }
  const double la = a.birth[c], mu = a.death[c];
  const float var = a.rate_var[c];
  const float height_rm = a.height[c] * a.rate_mean[c];
  const int o_ck = 4 + a.N + 1;
  float s_bd = 0.f, s_ck = 0.f, s_cal = 0.f;
  bool bad = false;
  for (int k = lane; live && k < a.RB; k += width) {
    const size_t at = out0 + k;
    const size_t m = (size_t)s * a.RB + k;
    const int o = a.own[m];
    if (!act || o < 0) {
      a.g[at] = 0.f;
      if (a.z != nullptr) a.zg[at] = 0.f;
      a.x_new[at] = 0.f;
      if (!a.rate) a.bd_new[at] = 0.f;
      a.ck_new[at] = 0.f;
      continue;
    }
    const int dpos = a.d_flat[m];
    const float d_old = a.d[(size_t)c * a.D + dpos];
    const float h_own = h[o];
    const float hpar_own = h[a.own_par[m]];
    const float r_own = r[o];
    float xn, ck, gg;
    if (a.rate) {
      xn = r_own * f;
      ck = clock_term_local(a.clock_model, xn, hpar_own - h_own, var);
      gg = d_old;
    } else {
      const bool is_root = o == i;
      xn = f * h_own;
      const float hpar_new = is_root ? hpar_own : f * hpar_own;
      const float bd = bd_term_local(xn, hpar_new, a.is_leaf[o] != 0, la, mu);
      ck = clock_term_local(a.clock_model, r_own, hpar_new - xn, var);
      gg = is_root ? -height_rm * r_own * h_own : d_old;
      const float dbd = bd - te[4 + o];
      if (!isnan(dbd)) s_bd += dbd;
      bad = bad || is_bad(bd);
      a.bd_new[at] = bd;
    }
    const float dck = ck - te[o_ck + o];
    if (!isnan(dck)) s_ck += dck;
    bad = bad || is_bad(ck);
    a.g[at] = gg;
    if (a.z != nullptr) a.zg[at] = a.z[(size_t)c * a.D + dpos];
    a.x_new[at] = xn;
    a.ck_new[at] = ck;
  }
  for (int j = lane; live && j < a.KN; j += width) {
    const size_t kk = (size_t)s * a.KN + j;
    const size_t at = cs * a.KN + j;
    if (!act || a.cal_t_rows[kk] < 0) {
      a.cal_new[at] = 0.f;
      continue;
    }
    const float cn = cal_term_local(f * h[a.cal_hsrc[kk]], a.height[c], a.cal_lo[kk],
                                    a.cal_lo_s[kk], a.cal_hi[kk], a.cal_hi_s[kk]);
    const float dc = cn - te[a.cal_t_rows[kk]];
    if (!isnan(dc)) s_cal += dc;
    bad = bad || is_bad(cn);
    a.cal_new[at] = cn;
  }
  s_bd = group_sum(s_bd, width);
  s_ck = group_sum(s_ck, width);
  s_cal = group_sum(s_cal, width);
  bad = group_any(bad, width);
  if (lane == 0 && live) {
    // The plain version's order: 0 + sum(bd) + sum(ck) + sum(cal).
    float dp = 0.f;
    if (!a.rate) dp = dp + s_bd;
    dp = dp + s_ck;
    if (a.KN > 0) dp = dp + s_cal;
    a.prop[cs] = prop;
    a.lq[cs] = lq;
    a.coef[cs] = act ? f - 1.0f : 0.f;
    a.d_pr[cs] = act ? dp : 0.f;
    a.lmhg[cs] = (bad || !act) ? -INFINITY : lq;
  }
}

struct EpilogueArgs {
  float* heights;  // [C, N]
  float* rates;    // [C, N]
  float* terms;    // [C, T]
  float* d;        // [C, D]
  float* q;        // [C]
  int* acc;        // [C, P]
  float* dacc;     // [C, S, RB]
  unsigned char* accept;        // [C, S] (written when u_acc is given)
  const float* dq;              // [C, S], null without a likelihood
  const float* u_acc;           // [C, S], null with a likelihood
  const float* d_pr;            // [C, S]
  const float* lmhg;            // [C, S]
  const float* coef;            // [C, S]
  const float* g;               // [C, S, RB]
  const float* x_new;           // [C, S, RB]
  const float* bd_new;          // [C, S, RB] (ultrametric only)
  const float* ck_new;          // [C, S, RB]
  const float* cal_new;         // [C, S, KN]
  const int* own;               // [S, RB]
  const int* d_flat;            // [S, RB]
  const int* rows;              // [S]
  const unsigned char* valid;   // [S]
  const int* cal_t_rows;        // [S, KN]
  int C, S, N, T, P, D, RB, KN, rate;
};

__global__ void __launch_bounds__(kThreads) range_lik_epilogue_kernel(EpilogueArgs a) {
  const int w = (blockIdx.x * blockDim.x + threadIdx.x) / 32;
  const int lane = threadIdx.x % 32;
  if (w >= a.C * a.S) return;  // whole warps
  const int c = w / a.S;
  const int s = w - c * a.S;
  const size_t cs = (size_t)c * a.S + s;
  float* te = a.terms + (size_t)c * a.T;
  float* x = (a.rate ? a.rates : a.heights) + (size_t)c * a.N;
  const int o_ck = 4 + a.N + 1;
  bool ok;
  if (a.u_acc != nullptr) {
    // The plain version's log u < (NaN ? -inf : d_pr + lmhg): a NaN
    // compares false as well.
    ok = logf(a.u_acc[cs]) < a.d_pr[cs] + a.lmhg[cs] && a.valid[s];
    if (lane == 0) a.accept[cs] = ok;
  } else {
    ok = a.accept[cs] && a.valid[s];
  }
  const float cf = a.coef[cs];
  for (int k = lane; k < a.RB; k += 32) {
    const size_t m = (size_t)s * a.RB + k;
    const size_t at = cs * a.RB + k;
    const int o = a.own[m];
    if (!ok || o < 0) {
      a.dacc[at] = 0.f;
      continue;
    }
    const float delta = cf * a.g[at];
    a.dacc[at] = delta;
    a.d[(size_t)c * a.D + a.d_flat[m]] += delta;
    x[o] = a.x_new[at];
    if (!a.rate) te[4 + o] = a.bd_new[at];
    te[o_ck + o] = a.ck_new[at];
  }
  if (ok) {
    for (int j = lane; j < a.KN; j += 32) {
      const int t = a.cal_t_rows[(size_t)s * a.KN + j];
      if (t >= 0) te[t] = a.cal_new[cs * a.KN + j];
    }
    if (lane == 0) a.acc[(size_t)c * a.P + a.rows[s]] += 1;
  }
  if (s == 0 && a.dq != nullptr) {
    // q += the chain's accepted dq, lanes over the tickets, in a fixed order.
    float q_acc = 0.f;
    for (int t = lane; t < a.S; t += 32) {
      const size_t ct = (size_t)c * a.S + t;
      if (a.accept[ct] && a.valid[t]) q_acc += a.dq[ct];
    }
    q_acc = warp_sum(q_acc);
    if (lane == 0) a.q[c] = a.q[c] + q_acc;
  }
}

int warp_blocks(long warps) { return (int)((warps + kWarpsPerBlock - 1) / kWarpsPerBlock); }

}  // namespace

extern "C" int mcmcdate_range_lik_prologue_f32(
    const float* heights, const float* rates, const float* terms, const float* d, const float* z,
    const float* tuning, const float* birth, const float* death, const float* rate_var,
    const float* height, const float* rate_mean, const int* node, const int* par,
    const int* own, const int* own_par, const int* d_flat, const int* rows,
    const unsigned char* valid, const float* sd, const int* n_inner, const int* n_nodes,
    const int* cal_t_rows, const int* cal_hsrc, const float* cal_lo, const float* cal_lo_s,
    const float* cal_hi, const float* cal_hi_s, const unsigned char* is_leaf, const float* draw,
    float* prop, float* lq, float* coef, float* d_pr, float* lmhg, float* g, float* zg,
    float* x_new, float* bd_new, float* ck_new, float* cal_new, int C, int S, int N, int T,
    int P, int D, int RB, int KN, int clock_model, int rate, void* stream) {
  if (!rate && bd_new == nullptr) return (int)cudaErrorInvalidValue;
  PrologueArgs a{heights,  rates,    terms,     d,       z,       tuning,     birth,
                 death,    rate_var, height,    rate_mean, node,  par,        own,
                 own_par,  d_flat,   rows,      valid,   sd,      n_inner,    n_nodes,
                 cal_t_rows, cal_hsrc, cal_lo,  cal_lo_s, cal_hi, cal_hi_s,   is_leaf,
                 draw,     prop,     lq,        coef,    d_pr,    lmhg,       g,
                 zg,       x_new,    bd_new,    ck_new,  cal_new, C,          S,
                 N,        T,        P,         D,       RB,      KN,         clock_model,
                 rate};
  // Lanes per (chain, ticket): the rows (or calibration slots) rounded up
  // to a power of 2, at most a warp.
  int width = 1;
  while (width < 32 && width < RB) width *= 2;
  while (width < 32 && width < KN) width *= 2;
  const long threads = (long)C * S * width;
  if (threads > 0) {
    range_lik_prologue_kernel<<<(int)((threads + kThreads - 1) / kThreads), kThreads, 0,
                                (cudaStream_t)stream>>>(a, width);
  }
  return (int)cudaGetLastError();
}

extern "C" int mcmcdate_range_lik_epilogue_f32(
    float* heights, float* rates, float* terms, float* d, float* q, int* acc, float* dacc,
    unsigned char* accept, const float* dq, const float* u_acc, const float* d_pr,
    const float* lmhg, const float* coef, const float* g, const float* x_new,
    const float* bd_new, const float* ck_new, const float* cal_new, const int* own,
    const int* d_flat, const int* rows, const unsigned char* valid, const int* cal_t_rows,
    int C, int S, int N, int T, int P, int D, int RB, int KN, int rate, void* stream) {
  if (!rate && bd_new == nullptr) return (int)cudaErrorInvalidValue;
  // With the decisions taken here, the sum of q would read other warps'.
  if (u_acc != nullptr && dq != nullptr) return (int)cudaErrorInvalidValue;
  EpilogueArgs a{heights, rates,  terms,  d,          q,      acc,    dacc,  accept,
                 dq,      u_acc,  d_pr,   lmhg,       coef,   g,      x_new, bd_new,
                 ck_new,  cal_new, own,   d_flat,     rows,   valid,  cal_t_rows,
                 C,       S,      N,      T,          P,      D,      RB,    KN,
                 rate};
  if ((long)C * S > 0) {
    range_lik_epilogue_kernel<<<warp_blocks((long)C * S), kThreads, 0, (cudaStream_t)stream>>>(
        a);
  }
  return (int)cudaGetLastError();
}
