// The global moves' proposals, as device functions shared by the glob
// kernels (csrc/glob_step.cu: G1, G2) and the sequential sweep's ticket
// kernels (csrc/ticket_step.cuh: T1, K3, T3), so that a proposal the ticket
// kernels draw is bitwise the one G2 draws from the same inputs.
//
// propose() forms one ticket's proposal on one chain from its injected
// draw (the plain versions: kernels/glob_step.py's _propose and the port's
// _k_* kernels of engine/proposals.py); new_height() and new_rate() give a
// node's proposed height and rate from its old ones.  Every thread of a
// chain's CTA computes the proposal alike from the same inputs; a node's
// new values read only that node's old ones (and the proposal), so any
// thread may write them.  Build with -fmad=false, as the plain versions
// round every product on its own.

#pragma once

#include <cuda_runtime.h>
#include <math.h>

#include "device_math.cuh"
#include "lane_groups.cuh"

namespace mcmcdate {

// Family codes: the index in kernels/glob_step.py's FAMILIES (GLOB_ORDER).
enum Family {
  BD_SCALE, RATE_MEAN, RATE_VAR, HEIGHT, HM_CONTRA, NORM_CONTRA, NORMH_CONTRA,
  VAR_TREE, VAR_AUTO, RATES_TIME, SLIDE_ROOT, SUB_CONTRA, SUB_ULTRA, SUB_RATE
};

// State fields a move changes.
enum Field {
  F_HEIGHTS = 1, F_RATES = 2, F_BIRTH = 4, F_DEATH = 8, F_HEIGHT = 16, F_RATE_MEAN = 32,
  F_RATE_VAR = 64
};

// Sums each of v[0..K) over the CTA of W warps (every thread gets the
// totals, summed in a fixed order) and ORs `flag`.  Synchronises once; the
// caller synchronises again before the next call reuses `red`.
template <int K, int W>
__device__ __forceinline__ void block_sums(float (&v)[K], float (*red)[W], bool& flag) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
#pragma unroll
  for (int k = 0; k < K; ++k) v[k] = warp_sum(v[k]);
  if (lane == 0) {
#pragma unroll
    for (int k = 0; k < K; ++k) red[k][warp] = v[k];
  }
  flag = __syncthreads_or(flag) != 0;
#pragma unroll
  for (int k = 0; k < K; ++k) {
    float t = 0.f;
    for (int w = 0; w < W; ++w) t += red[k][w];
    v[k] = t;
  }
}

// torch.amax semantics: NaN propagates.
__device__ __forceinline__ float max_nan(float m, float x) {
  return (isnan(x) || x > m) ? x : m;
}

struct Scalars {
  float birth, death, height, rate_mean, rate_var;
};

// One ticket's proposal on one chain, computed alike by every thread of
// the chain's CTA from the same inputs.
struct Ticket {
  float prop;   // the gamma factor u, or the truncated-normal value
  float lmhg;   // Hastings/Jacobian term, without lj
  float u;      // the gamma factor (slide_root: ht_new / ht)
  float xi;     // height factor (rates_time, sub_*)
  float xi_stem;
  float mean;   // var_tree: the non-root rates' mean
  int i, lo, hi;
  Scalars s;    // proposed scalars
};

// What the moves read of the model.
struct GlobModel {
  const int* parent;             // [N], root -1
  const unsigned char* is_leaf;  // [N]
  const int* root_ch;            // [n_root_ch] children of the root
  int N, n_root_ch, n_inner_total;
  int sc_birth, sc_death, sc_bd, sc_bdc;  // the scalar kernel's SC_* codes
};

// One ticket of a family: its parameters and, for the chain, its tuning
// and draw.
struct GlobDraw {
  int family;
  float sd, tune, draw;
  int aux, lo, hi, n_inner, n_nodes;
};

// The proposal of a ticket from its draw (the plain versions:
// kernels/glob_step.py's _propose, the port of FastSweeps._glob_step's
// per-family branches).
__device__ inline Ticket propose(const GlobModel& g, const GlobDraw& t, const float* h,
                                 const float* r, const Scalars& cur, float mean) {
  Ticket k;
  k.s = cur;
  k.mean = mean;
  k.u = k.xi = k.xi_stem = 1.0f;
  k.i = k.lo = k.hi = 0;
  const float sd = t.sd;
  const float tune = t.tune;
  const float dr = t.draw;
  const int n_br = g.N - 1;
  const int fam = t.family;
  float base = 0.f, logu = 0.f;
  const bool gamma = fam <= VAR_AUTO || fam == SUB_RATE;
  if (gamma) {
    // gamma_scale_sample: u = g (tune / shape); gamma_scale_lq at u.
    const float u = dr * (tune / sd);
    const float kk = sd / tune;
    const float theta = tune / sd;
    logu = logf(u);
    base = (gamma_logpdf(kk, theta, 1.0f / u) - gamma_logpdf(kk, theta, u)) - 2.0f * logu;
    k.u = u;
    k.prop = u;
  }
  switch (fam) {
    case BD_SCALE: {
      const int aux = t.aux;
      const bool joint = aux == g.sc_bd, con = aux == g.sc_bdc;
      const float coef = joint ? 2.0f : (con ? 0.0f : 1.0f);
      k.lmhg = base + coef * logu;
      if (aux == g.sc_birth || joint || con) k.s.birth = cur.birth * k.u;
      if (aux == g.sc_death || joint) k.s.death = cur.death * k.u;
      else if (con) k.s.death = cur.death * (1.0f / k.u);
      break;
    }
    case RATE_MEAN:
      k.lmhg = base + logu;
      k.s.rate_mean = cur.rate_mean * k.u;
      break;
    case RATE_VAR:
      k.lmhg = base + logu;
      k.s.rate_var = cur.rate_var * k.u;
      break;
    case HEIGHT:
      k.lmhg = base + logu;
      k.s.height = cur.height * k.u;
      break;
    case HM_CONTRA:
      k.lmhg = base;
      k.s.height = cur.height * k.u;
      k.s.rate_mean = cur.rate_mean / k.u;
      break;
    case NORM_CONTRA:
    case NORMH_CONTRA:
      k.lmhg = base + (float)(n_br - 1) * logu;
      if (fam == NORM_CONTRA) k.s.rate_mean = cur.rate_mean / k.u;
      else k.s.height = cur.height / k.u;
      break;
    case VAR_TREE:
    case VAR_AUTO:
      // The caller sets lmhg to -inf where a non-root rate would not stay
      // positive.
      k.lmhg = base + (float)(fam == VAR_TREE ? n_br + 1 : n_br + 2) * logu;
      k.s.rate_var = (cur.rate_var * k.u) * k.u;
      break;
    case RATES_TIME: {
      float h_mc = h[g.root_ch[0]];
      for (int j = 1; j < g.n_root_ch; ++j) h_mc = max_nan(h_mc, h[g.root_ch[j]]);
      float x, lq;
      truncnorm_sample(dr, h_mc, sd, tune, 0.f, h[0], &x, &lq);
      k.prop = x;
      k.xi = x / h_mc;
      k.lmhg = lq + (float)(g.n_inner_total - 1 - 1 - 2) * logf(k.xi);
      k.s.birth = cur.birth / k.xi;
      k.s.rate_mean = cur.rate_mean / k.xi;
      break;
    }
    case SLIDE_ROOT: {
      const float ht = cur.height;
      float hmax = h[g.root_ch[0]];
      for (int j = 1; j < g.n_root_ch; ++j) hmax = max_nan(hmax, h[g.root_ch[j]]);
      float x, lq;
      truncnorm_sample(dr, ht, sd, tune, ht * hmax, INFINITY, &x, &lq);
      k.prop = x;
      k.u = x / ht;
      float lsum = 0.f;
      for (int j = 0; j < g.n_root_ch; ++j) {
        const float hc = h[g.root_ch[j]];
        lsum += logf((1.0f - hc) / (k.u - hc));
      }
      k.lmhg = (lq - (float)(g.n_inner_total - 1) * logf(k.u)) + lsum;
      k.s.height = x;
      break;
    }
    case SUB_CONTRA:
    case SUB_ULTRA: {
      k.i = t.aux;
      k.lo = t.lo;
      k.hi = t.hi;
      const float hi_h = h[k.i];
      const float hp = h[g.parent[k.i]];
      float x, lq;
      truncnorm_sample(dr, hi_h, sd, tune, 0.f, hp, &x, &lq);
      k.prop = x;
      k.xi = x / hi_h;
      if (fam == SUB_ULTRA) {
        k.lmhg = lq + (float)(t.n_inner - 1) * logf(k.xi);
      } else {
        k.xi_stem = (hp - hi_h) / (hp - x);
        k.lmhg = (lq + (float)(t.n_inner - t.n_nodes) * logf(k.xi)) + logf(k.xi_stem);
      }
      break;
    }
    default:  // SUB_RATE
      k.lo = t.lo;
      k.hi = t.hi;
      k.lmhg = base + (float)t.n_nodes * logu;
      break;
  }
  return k;
}

// Node j's proposed height and rate.
__device__ __forceinline__ float new_height(const GlobModel& g, int family, const Ticket& k,
                                            const float* h, int j) {
  switch (family) {
    case RATES_TIME:
      return j != 0 ? h[j] * k.xi : h[j];
    case SLIDE_ROOT:
      return (!g.is_leaf[j] && j != 0) ? h[j] / k.u : h[j];
    case SUB_CONTRA:
    case SUB_ULTRA:
      return (j >= k.lo && j < k.hi) ? h[j] * k.xi : h[j];
    default:
      return h[j];
  }
}

__device__ __forceinline__ float new_rate(const GlobModel& g, int family, const Ticket& k,
                                          const float* h, const float* r, int j) {
  const bool non_root = g.parent[j] >= 0;
  switch (family) {
    case NORM_CONTRA:
    case NORMH_CONTRA:
      return non_root ? r[j] * k.u : r[j];
    case VAR_TREE:
      return non_root ? (r[j] - k.mean) * k.u + k.mean : r[j];
    case VAR_AUTO:
      return non_root ? k.s.rate_mean + k.u * (r[j] - k.s.rate_mean) : r[j];
    case SLIDE_ROOT:
      return g.parent[j] == 0 ? r[j] * ((1.0f - h[j]) / (k.u - h[j])) : r[j];
    case SUB_CONTRA:
      if (j == k.i) return r[j] * k.xi_stem;
      return (j > k.i && j < k.hi) ? r[j] / k.xi : r[j];
    case SUB_RATE:
      return (j >= k.lo && j < k.hi) ? r[j] * k.u : r[j];
    default:
      return r[j];
  }
}

// Internal-layout distance row j of the state (h, r) with scale = height
// * rate_mean: (h_p - h) r of the row's node, the root's second child's
// branch added to row 0 (ops/heights.py distances_internal).  h and r are
// indexed like arrays of float (a state row, or a view of a proposed one).
template <class HV, class RV>
__device__ __forceinline__ float distance_row(const int* parent, const int* dist_idx,
                                              int root_right, const HV& h, const RV& r,
                                              float scale, int j) {
  const int nd = dist_idx[j];
  float len = (h[parent[nd]] - h[nd]) * r[nd];
  if (j == 0) len = len + (h[parent[root_right]] - h[root_right]) * r[root_right];
  return len * scale;
}

}  // namespace mcmcdate
