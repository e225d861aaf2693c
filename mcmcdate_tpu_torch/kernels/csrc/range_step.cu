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
// likelihood it also takes the decisions, log u < beta_prior d_pr + lmhg
// with the chain's prior temperature (u_acc not null, accept written).
//
// What bounds them on the H100: the prologue's special functions (the
// inverse normal CDF and erfc, or lgamma, per ticket; the birth-death exp,
// log and divisions in double and a gamma or log-normal density per row)
// and a few gathered floats per row; the epilogue's bytes.  The design:
// - The block's plan (kernels/range_step.py range_plan) lists its real
//   rows (own >= 0) ticket by ticket, then its pad slots, each row as one
//   16-byte entry (slot, ticket, subtree-root flag, node, parent, distance
//   row), and each ticket's first row and row count.
// - The prologue runs one CTA per tile of chains over the whole block.  The
//   CTA stages the rows' entries into shared memory (cp.async) while its
//   threads draw each (chain, ticket)'s proposal once, one pair a thread,
//   and form each chain's constants once (the birth-death factors' 2 log|la
//   - mu| and log la, the gamma clock density's shape terms: BdConsts and
//   GammaClock, device_math.cuh, the same operations in the same order as
//   the per-row forms, so every term is bitwise the same).  Then the
//   threads walk (chain, row) pairs over the real rows only, full warps of
//   double-precision work; a pad slot gets g = zg = 0 (what range_scan
//   reads) and nothing else.  Each row leaves its two term deltas in
//   shared memory and each ticket's sum is taken by a group of lanes in a
//   fixed order (strided lanes, then a butterfly).
// - The epilogue runs one thread per (chain, item), an item being a row
//   slot (its write-back, or dacc = 0 on a rejected or pad slot) or a
//   ticket (its calibration stores and accept count; its decision without
//   a likelihood), and one warp per chain for q (the accepted dq, lanes
//   over the tickets, then a butterfly): full warps whatever the bucket's
//   row count.
// - Each block's arguments are one RangeBlockArgs struct (mirrored by
//   kernels/range_step.py _BlockArgs, checked by size at first launch),
//   built once; a launch passes it with the chain state's pointers.
// Both mirror their plain versions (kernels/range_step.py) operation by
// operation and are built with -fmad=false; the normal CDF, its inverse and
// log are CUDA's, so a proposal may differ from the plain one in its last
// bits.

#include <cuda_runtime.h>
#include <math.h>

#include "async_copy.cuh"
#include "device_math.cuh"
#include "lane_groups.cuh"

namespace {

using namespace mcmcdate;

constexpr int kThreads = 256;
// The fields of a ticket's entry in the plan's tplan [S, kTicketFields].
enum { kRowStart, kRows, kNode, kPar, kTune, kInner, kNodes, kValid, kTicketFields };

struct RangeBlockArgs {
  const int4* rplan;      // [F]: (slot | s << 16 | root << 24, own, own_par, dpos); pads own -1
  const int* tplan;       // [S, kTicketFields]
  const float* sd;        // [S]
  const int* cal_t_rows;  // [S, KN], -1 padding
  const int* cal_hsrc;    // [S, KN]
  const float* cal_lo;    // [S, KN]
  const float* cal_lo_s;
  const float* cal_hi;
  const float* cal_hi_s;
  float* prop;     // [C, S]
  float* lq;       // [C, S]
  float* coef;     // [C, S]
  float* d_pr;     // [C, S]
  float* lmhg;     // [C, S]
  float* g;        // [C, F]
  float* zg;       // [C, F] (with a likelihood)
  float* x_new;    // [C, F]
  float* bd_new;   // [C, F] (ultrametric only)
  float* ck_new;   // [C, F]
  float* cal_new;  // [C, S, KN]
  float* dacc;     // [C, F]
  int C, S, RB, R, KN, N, T, P, D, clock_model, rate, tile;
};

struct PrologueState {
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
  const unsigned char* is_leaf;  // [N]
  const float* draw;             // [C, S]
};

struct EpilogueState {
  float* heights;  // [C, N]
  float* rates;    // [C, N]
  float* terms;    // [C, T]
  float* d;        // [C, D]
  float* q;        // [C]
  int* acc;        // [C, P]
  unsigned char* accept;  // [C, S] (written when u_acc is given)
  const float* dq;        // [C, S], null without a likelihood
  const float* u_acc;     // [C, S], null with a likelihood
  const float* beta_prior;  // [C] prior temperature of the decisions taken here
};

// A chain's constants, formed once per CTA.
struct alignas(16) ChainConsts {
  BdConsts bd;
  GammaClock gamma;
  float var, height, height_rm;
};

__device__ __forceinline__ float clock_term(const ChainConsts& k, int model, float r, float tl) {
  return model == 0 ? gamma_clock_term(k.gamma, r) : clock_term_local(model, r, tl, k.var);
}

// Shared memory of the prologue, in this order: the tile's chain constants,
// the rows' plan entries [F], each (chain, real row)'s term deltas [tile,
// R], each (chain, ticket)'s f, lq and bad flag [tile, S], each ticket's
// valid flag [S].
size_t prologue_smem(const RangeBlockArgs& a) {
  const size_t pairs = (size_t)a.tile * a.S;
  return sizeof(ChainConsts) * a.tile + sizeof(int4) * (size_t)a.S * a.RB +
         sizeof(float2) * (size_t)a.tile * a.R + 3 * sizeof(float) * pairs +
         sizeof(int) * (size_t)a.S;
}

__global__ void __launch_bounds__(kThreads) range_lik_prologue_kernel(RangeBlockArgs a,
                                                                      PrologueState st) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int S = a.S, F = a.S * a.RB, R = a.R, tile = a.tile;
  ChainConsts* chain = reinterpret_cast<ChainConsts*>(smem);
  int4* rp = reinterpret_cast<int4*>(chain + tile);
  float2* vals = reinterpret_cast<float2*>(rp + F);
  float* fs = reinterpret_cast<float*>(vals + (size_t)tile * R);
  float* lqs = fs + tile * S;
  int* bad = reinterpret_cast<int*>(lqs + tile * S);
  int* act = bad + tile * S;
  const int tid = threadIdx.x;
  const int c0 = blockIdx.x * tile;

  // The rows' plan entries land while the proposals are drawn.
  for (int k = tid; k < F; k += kThreads)
    cp_async_f32x4(reinterpret_cast<float*>(rp + k), reinterpret_cast<const float*>(a.rplan + k),
                   true);
  cp_async_commit();
  for (int s = tid; s < S; s += kThreads) act[s] = a.tplan[s * kTicketFields + kValid];
  // The chain constants on the last threads, the proposals on the first.
  if (const int cc = kThreads - 1 - tid; cc < tile) {
    const int c = min(c0 + cc, a.C - 1);  // chains past C are never stored
    ChainConsts k;
    k.bd = bd_consts(st.birth[c], st.death[c]);
    k.var = st.rate_var[c];
    k.gamma = gamma_clock(k.var);
    k.height = st.height[c];
    k.height_rm = st.height[c] * st.rate_mean[c];
    chain[cc] = k;
  }
  // Each (chain, ticket)'s proposal, one pair a thread.
  for (int i = tid; i < tile * S; i += kThreads) {
    const int cc = i / S, s = i - cc * S;
    const int c = c0 + cc;
    const int* tp = a.tplan + s * kTicketFields;
    const bool ok = tp[kValid] != 0;
    float prop = NAN, f = NAN, lq = NAN;
    bad[i] = 0;
    if (c < a.C) {
      const size_t cs = (size_t)c * S + s;
      if (ok) {
        const float tune = st.tuning[(size_t)c * a.P + tp[kTune]];
        const float sd = a.sd[s];
        const float dr = st.draw[cs];
        if (a.rate) {
          // gamma_scale_sample: u = g (tune / shape); gamma_scale_lq at u.
          f = dr * (tune / sd);
          prop = f;
          const float k = sd / tune;
          const float theta = tune / sd;
          const float logu = logf(f);
          const float base =
              gamma_logpdf(k, theta, 1.0f / f) - gamma_logpdf(k, theta, f) - 2.0f * logu;
          lq = base + (float)tp[kNodes] * logu;
        } else {
          const float* h = st.heights + (size_t)c * a.N;
          const float hi = h[tp[kNode]];
          truncnorm_sample(dr, hi, sd, tune, 0.f, h[tp[kPar]], &prop, &lq);
          f = prop / hi;
          lq = lq + (float)(tp[kInner] - 1) * logf(f);
        }
      }
      a.prop[cs] = prop;
      a.lq[cs] = lq;
      a.coef[cs] = ok ? f - 1.0f : 0.f;
    }
    fs[i] = f;
    lqs[i] = lq;
  }
  cp_async_wait<0>();
  __syncthreads();

  // (chain, row) pairs: the real rows first, then the pad slots.
  const int o_ck = 4 + a.N + 1;
  for (int i = tid; i < tile * F; i += kThreads) {
    const int cc = i / F, k = i - cc * F;
    const int c = c0 + cc;
    if (c >= a.C) break;  // cc only grows with i
    const int4 e = rp[k];
    const int slot = e.x & 0xffff, s = (e.x >> 16) & 0xff;
    const size_t at = (size_t)c * F + slot;
    const int o = e.y;
    if (o < 0 || !act[s]) {
      a.g[at] = 0.f;
      if (st.z != nullptr) a.zg[at] = 0.f;
      if (k < R) vals[(size_t)cc * R + k] = make_float2(0.f, 0.f);
      continue;
    }
    const ChainConsts& kc = chain[cc];
    const float f = fs[cc * S + s];
    const float* h = st.heights + (size_t)c * a.N;
    const float* te = st.terms + (size_t)c * a.T;
    const float d_old = st.d[(size_t)c * a.D + e.w];
    const float h_own = h[o];
    const float hpar_own = h[e.z];
    const float r_own = st.rates[(size_t)c * a.N + o];
    float xn, ck, gg, dbd = 0.f;
    bool b = false;
    if (a.rate) {
      xn = r_own * f;
      ck = clock_term(kc, a.clock_model, xn, hpar_own - h_own);
      gg = d_old;
    } else {
      const bool is_root = (e.x >> 24) & 1;
      xn = f * h_own;
      const float hpar_new = is_root ? hpar_own : f * hpar_own;
      const float bd = bd_term_local(xn, hpar_new, st.is_leaf[o] != 0, kc.bd);
      ck = clock_term(kc, a.clock_model, r_own, hpar_new - xn);
      gg = is_root ? -kc.height_rm * r_own * h_own : d_old;
      dbd = bd - te[4 + o];
      b = is_bad(bd);
      a.bd_new[at] = bd;
    }
    const float dck = ck - te[o_ck + o];
    b = b || is_bad(ck);
    a.g[at] = gg;
    if (st.z != nullptr) a.zg[at] = st.z[(size_t)c * a.D + e.w];
    a.x_new[at] = xn;
    a.ck_new[at] = ck;
    vals[(size_t)cc * R + k] = make_float2(isnan(dbd) ? 0.f : dbd, isnan(dck) ? 0.f : dck);
    if (b) atomicOr(&bad[cc * S + s], 1);
  }
  __syncthreads();

  // Each (chain, ticket)'s sums over its rows and calibration slots: a
  // group of w lanes (a power of 2, about 8 rows a lane, at most a warp).
  int w = 1;
  while (w < 32 && w * 8 < a.RB) w *= 2;
  const int groups = kThreads / w, lane = tid % w;
  for (int p0 = 0; p0 < tile * S; p0 += groups) {  // the same count on every thread
    const int pair = p0 + tid / w;
    const int cc = pair / S, s = pair - cc * S;
    const int c = c0 + cc;
    const bool live = pair < tile * S && c < a.C;
    float s_bd = 0.f, s_ck = 0.f, s_cal = 0.f;
    bool b = false;
    if (live && act[s]) {
      const int* tp = a.tplan + s * kTicketFields;
      const float2* v = vals + (size_t)cc * R + tp[kRowStart];
      const int n = tp[kRows];
      for (int k = lane; k < n; k += w) {
        s_bd += v[k].x;
        s_ck += v[k].y;
      }
      b = bad[pair] != 0;
      const float f = fs[pair];
      const float* h = st.heights + (size_t)c * a.N;
      const float* te = st.terms + (size_t)c * a.T;
      for (int j = lane; j < a.KN; j += w) {
        const size_t kk = (size_t)s * a.KN + j;
        if (a.cal_t_rows[kk] < 0) continue;
        const float cn = cal_term_local(f * h[a.cal_hsrc[kk]], chain[cc].height, a.cal_lo[kk],
                                        a.cal_lo_s[kk], a.cal_hi[kk], a.cal_hi_s[kk]);
        const float dc = cn - te[a.cal_t_rows[kk]];
        if (!isnan(dc)) s_cal += dc;
        b = b || is_bad(cn);
        a.cal_new[((size_t)c * S + s) * a.KN + j] = cn;
      }
    }
    s_bd = group_sum(s_bd, w);
    s_ck = group_sum(s_ck, w);
    s_cal = group_sum(s_cal, w);
    b = group_any(b, w);
    if (lane == 0 && live) {
      // The plain version's order: 0 + sum(bd) + sum(ck) + sum(cal).
      float dp = 0.f;
      if (!a.rate) dp = dp + s_bd;
      dp = dp + s_ck;
      if (a.KN > 0) dp = dp + s_cal;
      const size_t cs = (size_t)c * S + s;
      a.d_pr[cs] = act[s] ? dp : 0.f;
      a.lmhg[cs] = (b || !act[s]) ? -INFINITY : lqs[pair];
    }
  }
}

// Ticket s of chain c accepted: the scan's decision, or without a
// likelihood log u < bprior d_pr + lmhg with the chain's prior temperature
// (the JAX step's fast_sweep.py:1834; a NaN compares false as well).
__device__ __forceinline__ bool accepted(const RangeBlockArgs& a, const EpilogueState& st, int c,
                                         int s) {
  const size_t cs = (size_t)c * a.S + s;
  const bool valid = a.tplan[s * kTicketFields + kValid] != 0;
  if (st.u_acc != nullptr)
    return logf(st.u_acc[cs]) < __fmul_rn(st.beta_prior[c], a.d_pr[cs]) + a.lmhg[cs] && valid;
  return st.accept[cs] && valid;
}

// A chain's items: its F row slots, its S tickets, then (from a multiple of
// 32) one warp for its q.
__host__ __device__ __forceinline__ int epilogue_items(int S, int RB) {
  return (S * RB + S + 31) / 32 * 32 + 32;
}

// One thread per (chain, item).
__global__ void __launch_bounds__(kThreads) range_lik_epilogue_kernel(RangeBlockArgs a,
                                                                      EpilogueState st) {
  const int S = a.S, F = a.S * a.RB;
  const int W = epilogue_items(S, a.RB);
  const long i = (long)blockIdx.x * kThreads + threadIdx.x;
  if (i >= (long)a.C * W) return;
  const int c = (int)(i / W);
  const int k = (int)(i - (long)c * W);
  float* te = st.terms + (size_t)c * a.T;
  if (k < F) {
    const int4 e = a.rplan[k];
    const int slot = e.x & 0xffff, s = (e.x >> 16) & 0xff;
    const size_t at = (size_t)c * F + slot;
    if (e.y < 0 || !accepted(a, st, c, s)) {
      a.dacc[at] = 0.f;
      return;
    }
    const float delta = a.coef[(size_t)c * S + s] * a.g[at];
    a.dacc[at] = delta;
    st.d[(size_t)c * a.D + e.w] += delta;
    float* x = (a.rate ? st.rates : st.heights) + (size_t)c * a.N;
    x[e.y] = a.x_new[at];
    if (!a.rate) te[4 + e.y] = a.bd_new[at];
    te[4 + a.N + 1 + e.y] = a.ck_new[at];
    return;
  }
  if (k < F + S) {
    const int s = k - F;
    const size_t cs = (size_t)c * S + s;
    const bool ok = accepted(a, st, c, s);
    if (st.u_acc != nullptr) st.accept[cs] = ok;
    if (!ok) return;
    for (int j = 0; j < a.KN; ++j) {
      const int t = a.cal_t_rows[(size_t)s * a.KN + j];
      if (t >= 0) te[t] = a.cal_new[cs * a.KN + j];
    }
    st.acc[(size_t)c * a.P + a.tplan[s * kTicketFields + kTune]] += 1;
    return;
  }
  if (k < W - 32 || st.dq == nullptr) return;  // whole warps: W - 32 is a multiple of 32
  // q += the chain's accepted dq, lanes over the tickets, in a fixed order.
  const int lane = k - (W - 32);
  float q_acc = 0.f;
  for (int t = lane; t < S; t += 32) {
    const size_t ct = (size_t)c * S + t;
    if (st.accept[ct] && a.tplan[t * kTicketFields + kValid]) q_acc += st.dq[ct];
  }
  q_acc = warp_sum(q_acc);
  if (lane == 0) st.q[c] = st.q[c] + q_acc;
}

int check_args(const RangeBlockArgs& a) {
  if (!a.rate && a.bd_new == nullptr) return (int)cudaErrorInvalidValue;
  // The plan packs a slot in 16 bits and a ticket in 8.
  if (a.tile < 1 || a.tile > kThreads || a.S > 255 || a.S * a.RB > 65535 || a.R > a.S * a.RB)
    return (int)cudaErrorInvalidValue;
  return 0;
}

}  // namespace

extern "C" int mcmcdate_range_block_args_size() { return (int)sizeof(RangeBlockArgs); }

extern "C" int mcmcdate_range_lik_prologue_f32(
    const void* args, const float* heights, const float* rates, const float* terms,
    const float* d, const float* z, const float* tuning, const float* birth, const float* death,
    const float* rate_var, const float* height, const float* rate_mean,
    const unsigned char* is_leaf, const float* draw, void* stream) {
  const RangeBlockArgs& a = *static_cast<const RangeBlockArgs*>(args);
  if (const int err = check_args(a)) return err;
  if (z != nullptr && a.zg == nullptr) return (int)cudaErrorInvalidValue;
  const PrologueState st{heights, rates,  terms,     d,       z,     tuning, birth,
                         death,   rate_var, height, rate_mean, is_leaf, draw};
  const size_t smem = prologue_smem(a);
  static size_t smem_set = 48 * 1024;  // the largest dynamic size allowed so far
  if (smem > smem_set) {
    const cudaError_t err = cudaFuncSetAttribute(
        range_lik_prologue_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return (int)err;
    smem_set = smem;
  }
  if (a.C > 0 && a.S > 0) {
    range_lik_prologue_kernel<<<(a.C + a.tile - 1) / a.tile, kThreads, smem,
                                (cudaStream_t)stream>>>(a, st);
  }
  return (int)cudaGetLastError();
}

extern "C" int mcmcdate_range_lik_epilogue_f32(const void* args, float* heights, float* rates,
                                               float* terms, float* d, float* q, int* acc,
                                               unsigned char* accept, const float* dq,
                                               const float* u_acc, const float* beta_prior,
                                               void* stream) {
  const RangeBlockArgs& a = *static_cast<const RangeBlockArgs*>(args);
  if (const int err = check_args(a)) return err;
  // With the decisions taken here, the sum of q would read other threads'.
  if (u_acc != nullptr && dq != nullptr) return (int)cudaErrorInvalidValue;
  const EpilogueState st{heights, rates, terms, d, q, acc, accept, dq, u_acc, beta_prior};
  const long items = (long)a.C * epilogue_items(a.S, a.RB);
  if (a.C > 0 && a.S > 0) {
    range_lik_epilogue_kernel<<<(int)((items + kThreads - 1) / kThreads), kThreads, 0,
                                (cudaStream_t)stream>>>(a, st);
  }
  return (int)cudaGetLastError();
}
