// K6 contra_step: one mega-step of distance-invariant contrary moves.
//
// contra_slide_kernel replaces the XLA-compiled step of FastSweeps._mega_contra_slide
// (mcmcdate_tpu/engine/fast_sweep.py:1223-1322).  For chain c and ticket b
// (node i, parent p, children ch): draw h_i' from a truncated normal on
// (max child height, h_p) around h_i, rescale the stem rate by
// (h_p - h_i)/(h_p - h_i') and each child rate by (h_i - h_c)/(h_i' - h_c)
// (so every branch distance is unchanged), evaluate the touched birth-death,
// clock and calibration terms, accept on the prior ratio, the kernel ratio
// and the log-Jacobian, and write heights, rates, terms and the accept
// count back in place.  The planner puts no parent-child pair and no row
// twice into one step, so the (chain, ticket) pairs read and write
// disjoint entries and run as independent threads.
//
// contra_range_kernel replaces _mega_range_contra (fast_sweep.py:1566-1694): ticket
// s scales the subtree of node i (rows own[s, :], pre-order, disjoint from
// the other tickets' subtrees) by xi = h_i'/h_i, the rates inside by 1/xi
// and the stem rate by (h_p - h_i)/(h_p - h_i'), with every node's
// birth-death and clock term and the calibrations inside.
//
// What bounds them on the H100: special functions (erfc, erfcx, the inverse
// normal CDF, lgamma, and the birth-death exp/log in double), a few
// gathered floats per (chain, ticket) and touched node in and out.  The
// slide mode runs one thread per (chain, ticket), everything in registers.
// The range mode takes a group of `width` lanes per (chain, ticket), a
// power of 2 up to a warp that the wrapper picks for about 4 rows a lane
// (4 lanes for the 16-row bucket, 16 for the 64-row one, 32 for the
// 256-row one at 8 rows a lane): every lane evaluates the ticket's
// proposal, about 3 rows' work, so a narrower group repeats it fewer
// times, and 4 rows a lane measured faster than a lane per row.
// Every lane draws the proposal from the same uniform (the same bits, no
// broadcast); the lanes stride over the subtree's rows and calibration
// slots, keeping each row's new height, rate and terms in registers (at
// most 8 rows and 4 slots a lane), and shuffles within the group sum the
// prior delta and OR the invalid flags.
// Every lane reads all it reads before the warp synchronises and writes
// only after it, so a row is written after every read of its old height
// (its children's parent height): no order of the rows is needed, and no
// term is evaluated twice.  Besides the accept mask, each ticket writes its log
// acceptance ratio and the proposal it drew (h_i' and the log proposal
// ratio), so that a check can replay its proposals through the plain
// version.
//
// It mirrors its plain version (kernels/contra_step.py) operation by
// operation and is built with -fmad=false, so products round one by one as
// there; the normal CDF, its inverse and log are CUDA's, not PyTorch's, so
// a proposal may differ from the plain one in its last bits.

#include <cuda_runtime.h>
#include <math.h>

#include "device_math.cuh"
#include "lane_groups.cuh"

namespace {

using namespace mcmcdate;

constexpr int kKtMax = 64;
constexpr int kThreads = 256;
constexpr int kRowsPerLane = 8;  // range rows a lane holds: RB <= 8 * 32
constexpr int kCalPerLane = 4;   // range calibration slots a lane holds

struct SlideArgs {
  float* heights;  // [C, N]
  float* rates;    // [C, N]
  float* terms;    // [C, T]
  int* acc;        // [C, P]
  const float* tuning;  // [C, P]
  const float* birth;   // [C]
  const float* death;
  const float* rate_var;
  const float* height;
  const int* node;  // [B]
  const int* par;   // [B]
  const int* ch;    // [B, KC], -1 padding
  const int* t_rows;  // [B, KT], -1 padding
  const int* rows;    // [B]
  const unsigned char* valid;  // [B]
  const float* sd;             // [B]
  const float* cal_lo;  // [B, KN]
  const float* cal_lo_s;
  const float* cal_hi;
  const float* cal_hi_s;
  const unsigned char* is_leaf;  // [N]
  const float* u_prop;  // [C, B]
  const float* u_acc;   // [C, B]
  unsigned char* accept;  // [C, B]
  float* log_alpha;       // [C, B]
  float* h_prop;          // [C, B]
  float* lq;              // [C, B]
  int C, B, N, T, P, KC, KT, KN, clock_model;
};

// The outputs of a pad slot: rejected outright, no proposal.
__device__ __forceinline__ void reject_pad(unsigned char* accept, float* log_alpha,
                                           float* h_prop, float* lq, int idx) {
  accept[idx] = 0;
  log_alpha[idx] = -INFINITY;
  h_prop[idx] = NAN;
  lq[idx] = NAN;
}

__global__ void contra_slide_kernel(SlideArgs a) {
  const int idx = blockIdx.x * blockDim.x + threadIdx.x;
  if (idx >= a.C * a.B) return;
  const int c = idx / a.B;
  const int b = idx - c * a.B;
  if (!a.valid[b]) {
    reject_pad(a.accept, a.log_alpha, a.h_prop, a.lq, idx);
    return;
  }
  float* h = a.heights + (size_t)c * a.N;
  float* r = a.rates + (size_t)c * a.N;
  float* te = a.terms + (size_t)c * a.T;
  const int i = a.node[b];
  const int p = a.par[b];
  const int* ch = a.ch + (size_t)b * a.KC;
  const float hi = h[i];
  const float hp = h[p];
  float hc_max = -INFINITY;
  for (int j = 0; j < a.KC; ++j) {
    if (ch[j] >= 0) hc_max = fmaxf(hc_max, h[ch[j]]);
  }
  const int row = a.rows[b];
  float hnew, lq;
  truncnorm_sample(a.u_prop[idx], hi, a.sd[b], a.tuning[(size_t)c * a.P + row], hc_max, hp,
                   &hnew, &lq);
  const float xi_stem = (hp - hi) / (hp - hnew);
  float log_jac_ch = 0.f;
  const double la = a.birth[c], mu = a.death[c];
  const float var = a.rate_var[c];
  const float r_i_new = r[i] * xi_stem;
  float tn[kKtMax];
  float r_ch_new[kKtMax / 2];
  tn[0] = bd_term_local(hnew, hp, false, la, mu);
  tn[1] = clock_term_local(a.clock_model, r_i_new, hp - hnew, var);
  for (int j = 0; j < a.KC; ++j) {
    const int cj = ch[j];
    if (cj >= 0) {
      const float hc = h[cj];
      const float xi_ch = (hi - hc) / (hnew - hc);
      log_jac_ch += logf(xi_ch);
      r_ch_new[j] = r[cj] * xi_ch;
      tn[2 + j] = bd_term_local(hc, hnew, a.is_leaf[cj] != 0, la, mu);
      tn[2 + a.KC + j] = clock_term_local(a.clock_model, r_ch_new[j], hnew - hc, var);
    } else {
      r_ch_new[j] = 0.f;
      tn[2 + j] = 0.f;
      tn[2 + a.KC + j] = 0.f;
    }
  }
  const float log_jac = logf(xi_stem) + log_jac_ch;
  for (int j = 0; j < a.KN; ++j) {
    const size_t k = (size_t)b * a.KN + j;
    tn[2 * (1 + a.KC) + j] = cal_term_local(hnew, a.height[c], a.cal_lo[k], a.cal_lo_s[k],
                                            a.cal_hi[k], a.cal_hi_s[k]);
  }
  const int* tr = a.t_rows + (size_t)b * a.KT;
  float d_pr = 0.f;
  bool invalid = false;
  for (int k = 0; k < a.KT; ++k) {
    if (tr[k] < 0) continue;
    const float diff = tn[k] - te[tr[k]];
    if (!isnan(diff)) d_pr += diff;
    if (isnan(tn[k]) || tn[k] == -INFINITY) invalid = true;
  }
  float log_alpha = invalid ? -INFINITY : d_pr + lq + log_jac;
  if (isnan(log_alpha)) log_alpha = -INFINITY;
  const bool acc = logf(a.u_acc[idx]) < log_alpha;
  a.accept[idx] = acc;
  a.log_alpha[idx] = log_alpha;
  a.h_prop[idx] = hnew;
  a.lq[idx] = lq;
  if (!acc) return;
  h[i] = hnew;
  r[i] = r_i_new;
  for (int j = 0; j < a.KC; ++j) {
    if (ch[j] >= 0) r[ch[j]] = r_ch_new[j];
  }
  for (int k = 0; k < a.KT; ++k) {
    if (tr[k] >= 0) te[tr[k]] = tn[k];
  }
  a.acc[(size_t)c * a.P + row] += 1;
}

struct RangeArgs {
  float* heights;  // [C, N]
  float* rates;    // [C, N]
  float* terms;    // [C, T]
  int* acc;        // [C, P]
  const float* tuning;  // [C, P]
  const float* birth;   // [C]
  const float* death;
  const float* rate_var;
  const float* height;
  const int* node;     // [S]
  const int* par;      // [S]
  const int* own;      // [S, RB], -1 padding
  const int* own_par;  // [S, RB]
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
  const float* u_prop;  // [C, S]
  const float* u_acc;   // [C, S]
  unsigned char* accept;  // [C, S]
  float* log_alpha;       // [C, S]
  float* h_prop;          // [C, S]
  float* lq;              // [C, S]
  int C, S, N, T, P, RB, KN, clock_model;
};

// New height, rate and terms of subtree row k of ticket s (range mode).
struct RowNew {
  int o;
  float h, r, bd, ck;
};

__device__ __forceinline__ RowNew range_row(const RangeArgs& a, const float* h, const float* r,
                                            int s, int k, int i, float xi, float xi_stem,
                                            double la, double mu, float var) {
  RowNew out;
  const int o = a.own[(size_t)s * a.RB + k];
  out.o = o;
  if (o < 0) return out;
  const bool is_root = o == i;
  const float h_own = h[o];
  const float hpar_own = h[a.own_par[(size_t)s * a.RB + k]];
  const float r_own = r[o];
  out.h = xi * h_own;
  const float hpar_new = is_root ? hpar_own : xi * hpar_own;
  out.r = is_root ? r_own * xi_stem : r_own / xi;
  out.bd = bd_term_local(out.h, hpar_new, a.is_leaf[o] != 0, la, mu);
  out.ck = clock_term_local(a.clock_model, out.r, hpar_new - out.h, var);
  return out;
}

// One group of `width` lanes per (chain, ticket); the groups of a warp never
// return early, so that every lane takes part in the shuffles and the
// barrier.
__global__ void __launch_bounds__(kThreads) contra_range_kernel(RangeArgs a, int width) {
  const long gid = ((long)blockIdx.x * blockDim.x + threadIdx.x) / width;
  const int lane = threadIdx.x % width;
  const bool live = gid < (long)a.C * a.S;
  const int c = live ? (int)(gid / a.S) : 0;
  const int s = live ? (int)(gid - (long)c * a.S) : 0;
  const bool act = live && a.valid[s];
  const size_t cs = (size_t)c * a.S + s;
  float* h = a.heights + (size_t)c * a.N;
  float* r = a.rates + (size_t)c * a.N;
  float* te = a.terms + (size_t)c * a.T;
  const int i = a.node[s];
  const int row = a.rows[s];
  float hnew = NAN, lq = NAN, xi = NAN, xi_stem = NAN;
  if (act) {
    const float hi = h[i];
    const float hp = h[a.par[s]];
    truncnorm_sample(a.u_prop[cs], hi, a.sd[s], a.tuning[(size_t)c * a.P + row], 0.f, hp,
                     &hnew, &lq);
    xi = hnew / hi;
    xi_stem = (hp - hi) / (hp - hnew);
  }
  const double la = a.birth[c], mu = a.death[c];
  const float var = a.rate_var[c];
  const int o_ck = 4 + a.N + 1;
  float d_rows = 0.f, d_cal = 0.f;
  bool invalid = false;
  RowNew nr[kRowsPerLane];
#pragma unroll
  for (int j = 0; j < kRowsPerLane; ++j) {
    const int k = lane + j * width;
    nr[j].o = -1;
    if (!act || k >= a.RB) continue;
    nr[j] = range_row(a, h, r, s, k, i, xi, xi_stem, la, mu, var);
    if (nr[j].o < 0) continue;
    const float diff = (nr[j].bd - te[4 + nr[j].o]) + (nr[j].ck - te[o_ck + nr[j].o]);
    if (!isnan(diff)) d_rows += diff;
    invalid = invalid || is_bad(nr[j].bd) || is_bad(nr[j].ck);
  }
  int cal_t[kCalPerLane];
  float cal_v[kCalPerLane];
#pragma unroll
  for (int j = 0; j < kCalPerLane; ++j) {
    const int jj = lane + j * width;
    cal_t[j] = -1;
    if (!act || jj >= a.KN) continue;
    const size_t kk = (size_t)s * a.KN + jj;
    cal_t[j] = a.cal_t_rows[kk];
    if (cal_t[j] < 0) continue;
    cal_v[j] = cal_term_local(xi * h[a.cal_hsrc[kk]], a.height[c], a.cal_lo[kk], a.cal_lo_s[kk],
                              a.cal_hi[kk], a.cal_hi_s[kk]);
    const float dc = cal_v[j] - te[cal_t[j]];
    if (!isnan(dc)) d_cal += dc;
    invalid = invalid || is_bad(cal_v[j]);
  }
  d_rows = group_sum(d_rows, width);
  d_cal = group_sum(d_cal, width);
  invalid = group_any(invalid, width);
  const float d_pr = a.KN > 0 ? d_rows + d_cal : d_rows;
  const float log_jac = (float)(a.n_inner[s] - a.n_nodes[s]) * logf(xi) + logf(xi_stem);
  float log_alpha = d_pr + lq + log_jac;
  if (invalid || isnan(log_alpha)) log_alpha = -INFINITY;
  const bool acc = act && logf(a.u_acc[cs]) < log_alpha;
  if (lane == 0 && live) {
    if (act) {
      a.accept[cs] = acc;
      a.log_alpha[cs] = log_alpha;
      a.h_prop[cs] = hnew;
      a.lq[cs] = lq;
    } else {
      reject_pad(a.accept, a.log_alpha, a.h_prop, a.lq, cs);
    }
  }
  // Every lane of the group has read the old heights, rates and terms it
  // needs; from here on it only writes.
  __syncwarp();
  if (!acc) return;
#pragma unroll
  for (int j = 0; j < kRowsPerLane; ++j) {
    const int o = nr[j].o;
    if (o < 0) continue;
    te[4 + o] = nr[j].bd;
    te[o_ck + o] = nr[j].ck;
    h[o] = nr[j].h;
    r[o] = nr[j].r;
  }
#pragma unroll
  for (int j = 0; j < kCalPerLane; ++j) {
    if (cal_t[j] >= 0) te[cal_t[j]] = cal_v[j];
  }
  if (lane == 0) a.acc[(size_t)c * a.P + row] += 1;
}

}  // namespace

extern "C" int mcmcdate_contra_range_f32(
    float* heights, float* rates, float* terms, int* acc, const float* tuning,
    const float* birth, const float* death, const float* rate_var, const float* height,
    const int* node, const int* par, const int* own, const int* own_par, const int* rows,
    const unsigned char* valid, const float* sd, const int* n_inner, const int* n_nodes,
    const int* cal_t_rows, const int* cal_hsrc, const float* cal_lo, const float* cal_lo_s,
    const float* cal_hi, const float* cal_hi_s, const unsigned char* is_leaf,
    const float* u_prop, const float* u_acc, unsigned char* accept, float* log_alpha,
    float* h_prop, float* lq, int C, int S, int N, int T, int P, int RB, int KN,
    int clock_model, int width, void* stream) {
  RangeArgs a{heights, rates,   terms,      acc,      tuning,    birth,  death,    rate_var,
              height,  node,    par,        own,      own_par,   rows,   valid,    sd,
              n_inner, n_nodes, cal_t_rows, cal_hsrc, cal_lo,    cal_lo_s, cal_hi, cal_hi_s,
              is_leaf, u_prop,  u_acc,      accept,   log_alpha, h_prop, lq,       C,
              S,       N,       T,          P,        RB,        KN,     clock_model};
  // width: lanes per (chain, ticket), a power of 2 up to a warp.
  if (width < 1 || width > 32 || (width & (width - 1)) || RB > kRowsPerLane * width ||
      KN > kCalPerLane * width) {
    return (int)cudaErrorInvalidValue;
  }
  const long threads = (long)C * S * width;
  if (threads > 0) {
    contra_range_kernel<<<(int)((threads + kThreads - 1) / kThreads), kThreads, 0,
                          (cudaStream_t)stream>>>(a, width);
  }
  return (int)cudaGetLastError();
}

extern "C" int mcmcdate_contra_slide_f32(
    float* heights, float* rates, float* terms, int* acc, const float* tuning,
    const float* birth, const float* death, const float* rate_var, const float* height,
    const int* node, const int* par, const int* ch, const int* t_rows, const int* rows,
    const unsigned char* valid, const float* sd, const float* cal_lo, const float* cal_lo_s,
    const float* cal_hi, const float* cal_hi_s, const unsigned char* is_leaf,
    const float* u_prop, const float* u_acc, unsigned char* accept, float* log_alpha,
    float* h_prop, float* lq, int C, int B, int N, int T, int P, int KC, int KT, int KN,
    int clock_model, void* stream) {
  if (KT > kKtMax || 2 * (1 + KC) + KN != KT) return (int)cudaErrorInvalidValue;
  SlideArgs a{heights, rates,    terms,  acc,      tuning,  birth,  death,     rate_var,
              height,  node,     par,    ch,       t_rows,  rows,   valid,     sd,
              cal_lo,  cal_lo_s, cal_hi, cal_hi_s, is_leaf, u_prop, u_acc,     accept,
              log_alpha, h_prop, lq,     C,        B,       N,      T,         P,
              KC,      KT,       KN,     clock_model};
  const int n = C * B;
  if (n > 0) {
    contra_slide_kernel<<<(n + 255) / 256, 256, 0, (cudaStream_t)stream>>>(a);
  }
  return (int)cudaGetLastError();
}
