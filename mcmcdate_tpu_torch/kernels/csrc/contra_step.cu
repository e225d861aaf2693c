// K6 contra_step: one mega-step of distance-invariant contrary moves.
//
// contra_slide_kernel replaces the XLA-compiled step of FastSweeps._mega_contra_slide
// (mcmcdate_tpu/engine/fast_sweep.py:1223-1322).  For chain c and ticket b
// (node i, parent p, children ch): draw h_i' from a truncated normal on
// (max child height, h_p) around h_i, rescale the stem rate by
// (h_p - h_i)/(h_p - h_i') and each child rate by (h_i - h_c)/(h_i' - h_c)
// (so every branch distance is unchanged), evaluate the touched birth-death,
// clock and calibration terms, accept on the prior ratio (times the
// chain's prior temperature beta_prior: the JAX step's fast_sweep.py:
// 1302-1304, and 1674-1675 in the range mode), the kernel ratio and the
// log-Jacobian, and write heights, rates, terms and the accept
// count back in place.  The planner puts no parent-child pair and no row
// twice into one step, so the (chain, ticket) pairs read and write
// disjoint entries and run as independent threads.
//
// contra_range_kernel replaces _mega_range_contra (fast_sweep.py:1566-1694): ticket
// s scales the subtree of node i (rows own[s, :], pre-order, disjoint from
// the other tickets' subtrees) by xi = h_i'/h_i, the rates inside by 1/xi
// and the stem rate by (h_p - h_i)/(h_p - h_i'), with every node's
// birth-death and clock term and the calibrations inside.  With the bold
// mixture (a non-null u_bold), a ticket whose uniform is below bold_p draws
// from a bold_factor times wider kernel (fast_sweep.py:1599-1615); with
// u_bold null the kernel computes what it did without the mixture.
//
// What bounds them on the H100: special functions (erfc, erfcx, the inverse
// normal CDF, lgamma, and the birth-death exp/log in double), a few
// gathered floats per (chain, ticket) and touched node in and out.  The
// slide mode runs a thread per chain and tile of tickets, the tickets
// fastest, so that a warp's lanes take neighbouring tickets of one chain
// (its heights, rates and terms share cache lines); the tile is the
// fewest tickets that fit the step into one wave of resident CTAs (2 at
// 136 taxa x 1024 chains, 8 at 1000).  The chain's
// birth-death constants (BdConsts) and, under the UncorrelatedGamma
// clock, its clock constants (GammaClock) are formed once per tile, and
// every gather of a ticket is issued before the first one is used.  The
// kernel is instantiated for KC = 2 without calibrations (every binary
// tree the repo builds), so that its loops unroll and every array lives in
// registers; other steps take the generic instantiation.
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
constexpr int kThreads = 256;  // contra_range
// contra_slide: 128 threads a CTA, at most 128 registers a thread (4 CTAs an
// SM): the KC = 2 instantiation then keeps every value in registers (capped
// at 80 or 96 it spills, and ran slower at 1000 taxa x 1024 chains on an
// H100).
constexpr int kSlideThreads = 128;
constexpr int kSlideMinBlocks = 4;
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
  const float* beta_prior;  // [C] prior temperature
  unsigned char* accept;  // [C, B]
  float* log_alpha;       // [C, B]
  float* h_prop;          // [C, B]
  float* lq;              // [C, B]
  int C, B, N, T, P, KC, KT, KN, clock_model;
};

// The outputs of a pad slot: rejected outright, no proposal.
__device__ __forceinline__ void reject_pad(unsigned char* accept, float* log_alpha,
                                           float* h_prop, float* lq, size_t idx) {
  accept[idx] = 0;
  log_alpha[idx] = -INFINITY;
  h_prop[idx] = NAN;
  lq[idx] = NAN;
}

// A chain's constants of the slide's terms, formed once per thread: the
// birth-death rates' d, 2 log|d| and log la (BdConsts) and, under the
// UncorrelatedGamma clock, the clock density's shape terms (GammaClock).
// Each term is bitwise the one formed from the rates alone.
struct SlideChain {
  BdConsts bd;
  GammaClock gk;
  float var, height;
};

__device__ __forceinline__ float slide_clock(const SlideArgs& a, const SlideChain& k, float r,
                                             float tl) {
  return a.clock_model == 0 ? gamma_clock_term(k.gk, r)
                            : clock_term_local(a.clock_model, r, tl, k.var);
}

// Ticket b of chain c.  KCT > 0: the step's KC, known at compile time,
// and no calibration slot, so that every loop unrolls and every array
// lives in registers; KCT = 0: any KC and KN (runtime loops; the arrays
// may live in local memory).  The ticket's plan
// comes first, then every gather of the chain's state and the calibration
// bounds, all issued before the first use; the terms are then summed in
// t_rows order, as the plain version sums them.
template <int KCT>
__device__ __forceinline__ void slide_ticket(const SlideArgs& a, const SlideChain& k, int c,
                                             int b, float* h, float* r, float* te) {
  constexpr int kKc = KCT > 0 ? KCT : (kKtMax - 2) / 2;
  constexpr int kKt = KCT > 0 ? 2 * (1 + KCT) : kKtMax;
  // Loop bounds: constants in the KC instantiation (the loops unroll),
  // the step's own in the generic kernel.
  const int KC = KCT > 0 ? KCT : a.KC;
  const int KT = KCT > 0 ? kKt : a.KT;
  const int KB = 2 * (1 + KC);  // the slots before the calibrations
  const size_t cb = (size_t)c * a.B + b;
  if (!a.valid[b]) {
    reject_pad(a.accept, a.log_alpha, a.h_prop, a.lq, cb);
    return;
  }
  // The ticket's plan.
  const int i = a.node[b];
  const int p = a.par[b];
  const int row = a.rows[b];
  const float sd = a.sd[b];
  int chj[kKc];
  int tr[kKt];
  float clo[kKt], clo_s[kKt], chi[kKt], chi_s[kKt];
#pragma unroll
  for (int j = 0; j < KC; ++j) chj[j] = a.ch[(size_t)b * KC + j];
#pragma unroll
  for (int t = 0; t < KT; ++t) {
    tr[t] = a.t_rows[(size_t)b * KT + t];
    if (t >= KB) {
      const size_t q = (size_t)b * a.KN + (t - KB);
      clo[t] = a.cal_lo[q];
      clo_s[t] = a.cal_lo_s[q];
      chi[t] = a.cal_hi[q];
      chi_s[t] = a.cal_hi_s[q];
    }
  }
  // The chain's state the ticket reads, all at once.
  const float u_prop = a.u_prop[cb];
  const float u_acc = a.u_acc[cb];
  const float tune = a.tuning[(size_t)c * a.P + row];
  const float hi = h[i];
  const float hp = h[p];
  const float ri = r[i];
  float hch[kKc], rch[kKc], told[kKt];
#pragma unroll
  for (int j = 0; j < KC; ++j) {
    if (chj[j] >= 0) {
      hch[j] = h[chj[j]];
      rch[j] = r[chj[j]];
    }
  }
#pragma unroll
  for (int t = 0; t < KT; ++t)
    if (tr[t] >= 0) told[t] = te[tr[t]];
  float hc_max = -INFINITY;
#pragma unroll
  for (int j = 0; j < KC; ++j)
    if (chj[j] >= 0) hc_max = fmaxf(hc_max, hch[j]);
  float hnew, lq;
  truncnorm_sample(u_prop, hi, sd, tune, hc_max, hp, &hnew, &lq);
  const float xi_stem = (hp - hi) / (hp - hnew);
  float log_jac_ch = 0.f;
  const float r_i_new = ri * xi_stem;
  float tn[kKt];
  float r_ch_new[kKc];
  tn[0] = bd_term_local(hnew, hp, false, k.bd);
  tn[1] = slide_clock(a, k, r_i_new, hp - hnew);
#pragma unroll
  for (int j = 0; j < KC; ++j) {
    const int cj = chj[j];
    if (cj >= 0) {
      const float hc = hch[j];
      const float xi_ch = (hi - hc) / (hnew - hc);
      log_jac_ch += logf(xi_ch);
      r_ch_new[j] = rch[j] * xi_ch;
      tn[2 + j] = bd_term_local(hc, hnew, a.is_leaf[cj] != 0, k.bd);
      tn[2 + KC + j] = slide_clock(a, k, r_ch_new[j], hnew - hc);
    } else {
      r_ch_new[j] = 0.f;
      tn[2 + j] = 0.f;
      tn[2 + KC + j] = 0.f;
    }
  }
  const float log_jac = logf(xi_stem) + log_jac_ch;
#pragma unroll
  for (int t = KB; t < KT; ++t)
    tn[t] = cal_term_local(hnew, k.height, clo[t], clo_s[t], chi[t], chi_s[t]);
  float d_pr = 0.f;
  bool invalid = false;
#pragma unroll
  for (int t = 0; t < KT; ++t) {
    if (tr[t] < 0) continue;
    const float diff = tn[t] - told[t];
    if (!isnan(diff)) d_pr += diff;
    if (isnan(tn[t]) || tn[t] == -INFINITY) invalid = true;
  }
  float log_alpha = invalid ? -INFINITY : __fmul_rn(a.beta_prior[c], d_pr) + lq + log_jac;
  if (isnan(log_alpha)) log_alpha = -INFINITY;
  const bool acc = logf(u_acc) < log_alpha;
  a.accept[cb] = acc;
  a.log_alpha[cb] = log_alpha;
  a.h_prop[cb] = hnew;
  a.lq[cb] = lq;
  if (!acc) return;
  h[i] = hnew;
  r[i] = r_i_new;
#pragma unroll
  for (int j = 0; j < KC; ++j)
    if (chj[j] >= 0) r[chj[j]] = r_ch_new[j];
#pragma unroll
  for (int t = 0; t < KT; ++t)
    if (tr[t] >= 0) te[tr[t]] = tn[t];
  a.acc[(size_t)c * a.P + row] += 1;
}

// A thread per chain and tile of `per` tickets, the tickets fastest: thread
// j of chain c takes tickets j, j + nj, j + 2 nj, ... (nj threads a chain),
// so that a warp's lanes take neighbouring tickets of one chain, whose
// heights, rates and terms share cache lines; the chain's constants are
// formed once per thread.
template <int KCT>
__global__ void __launch_bounds__(kSlideThreads, kSlideMinBlocks)
    contra_slide_kernel(SlideArgs a, int per) {
  const int nj = (a.B + per - 1) / per;
  const long idx = (long)blockIdx.x * blockDim.x + threadIdx.x;
  if (idx >= (long)a.C * nj) return;
  const int c = (int)(idx / nj);
  const int j = (int)(idx - (long)c * nj);
  SlideChain k;
  k.bd = bd_consts((double)a.birth[c], (double)a.death[c]);
  k.var = a.rate_var[c];
  k.height = a.KN > 0 ? a.height[c] : 0.f;
  if (a.clock_model == 0) k.gk = gamma_clock(k.var);
  float* h = a.heights + (size_t)c * a.N;
  float* r = a.rates + (size_t)c * a.N;
  float* te = a.terms + (size_t)c * a.T;
  for (int b = j; b < a.B; b += nj) slide_ticket<KCT>(a, k, c, b, h, r, te);
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
  const float* beta_prior;  // [C] prior temperature
  unsigned char* accept;  // [C, S]
  float* log_alpha;       // [C, S]
  float* h_prop;          // [C, S]
  float* lq;              // [C, S]
  const float* u_bold;    // [C, S] the bold mixture's uniforms (null: off)
  float bold_p, bold_factor;
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
    // The bold mixture (the JAX step's fast_sweep.py:1599-1615): a ticket
    // whose uniform is below bold_p takes a bold_factor times wider kernel,
    // the same tuning forward and reverse.
    float tune = a.tuning[(size_t)c * a.P + row];
    if (a.u_bold != nullptr && a.u_bold[cs] < a.bold_p) tune = tune * a.bold_factor;
    truncnorm_sample(a.u_prop[cs], hi, a.sd[s], tune, 0.f, hp, &hnew, &lq);
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
  float log_alpha = __fmul_rn(a.beta_prior[c], d_pr) + lq + log_jac;
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
    const float* u_prop, const float* u_acc, const float* beta_prior, unsigned char* accept,
    float* log_alpha, float* h_prop, float* lq, const float* u_bold, float bold_p,
    float bold_factor, int C, int S, int N, int T, int P, int RB, int KN, int clock_model,
    int width, void* stream) {
  RangeArgs a{heights,    rates,   terms,      acc,       tuning,   birth,    death,
              rate_var,   height,  node,       par,       own,      own_par,  rows,
              valid,      sd,      n_inner,    n_nodes,   cal_t_rows, cal_hsrc, cal_lo,
              cal_lo_s,   cal_hi,  cal_hi_s,   is_leaf,   u_prop,   u_acc,    beta_prior,
              accept,     log_alpha, h_prop,   lq,        u_bold,   bold_p,   bold_factor,
              C,          S,       N,          T,         P,        RB,       KN,
              clock_model};
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

// contra_slide's instantiations: KC = 2 without calibrations (every binary
// tree the repo builds) and the generic kernel.
template <int KCT>
static cudaError_t launch_slide(const SlideArgs& a, cudaStream_t stream) {
  // Tickets per thread: the fewest that fit the (chain, ticket) pairs in one
  // wave of resident CTAs (the device's answer cached per kernel).
  static int dev_cached = -1, slots = 0;
  int dev = 0;
  cudaGetDevice(&dev);
  if (dev != dev_cached) {
    int n_sm = 1, per_sm = 1;
    cudaDeviceGetAttribute(&n_sm, cudaDevAttrMultiProcessorCount, dev);
    cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, contra_slide_kernel<KCT>,
                                                  kSlideThreads, 0);
    slots = n_sm * (per_sm > 0 ? per_sm : 1) * kSlideThreads;
    dev_cached = dev;
  }
  const long pairs = (long)a.C * a.B;
  const int per = (int)((pairs + slots - 1) / slots);
  const long threads = (long)a.C * ((a.B + per - 1) / per);
  contra_slide_kernel<KCT>
      <<<(int)((threads + kSlideThreads - 1) / kSlideThreads), kSlideThreads, 0, stream>>>(a,
                                                                                          per);
  return cudaGetLastError();
}

extern "C" int mcmcdate_contra_slide_f32(
    float* heights, float* rates, float* terms, int* acc, const float* tuning,
    const float* birth, const float* death, const float* rate_var, const float* height,
    const int* node, const int* par, const int* ch, const int* t_rows, const int* rows,
    const unsigned char* valid, const float* sd, const float* cal_lo, const float* cal_lo_s,
    const float* cal_hi, const float* cal_hi_s, const unsigned char* is_leaf,
    const float* u_prop, const float* u_acc, const float* beta_prior, unsigned char* accept,
    float* log_alpha, float* h_prop, float* lq, int C, int B, int N, int T, int P, int KC,
    int KT, int KN, int clock_model, void* stream) {
  if (KT > kKtMax || 2 * (1 + KC) + KN != KT) return (int)cudaErrorInvalidValue;
  SlideArgs a{heights, rates,    terms,  acc,      tuning,  birth,  death,      rate_var,
              height,  node,     par,    ch,       t_rows,  rows,   valid,      sd,
              cal_lo,  cal_lo_s, cal_hi, cal_hi_s, is_leaf, u_prop, u_acc,      beta_prior,
              accept,  log_alpha, h_prop, lq,      C,       B,      N,          T,
              P,       KC,       KT,     KN,       clock_model};
  if ((long)C * B == 0) return (int)cudaSuccess;
  const cudaStream_t st = (cudaStream_t)stream;
  if (KC == 2 && KN == 0) return (int)launch_slide<2>(a, st);
  return (int)launch_slide<0>(a, st);
}
