// The entries of DatingModel's flat log-prior term vector, as device
// functions shared by K1 prior_terms (csrc/prior_terms.cu) and the
// global-move family kernels (csrc/glob_step.cu), so that a term the glob
// kernels evaluate is bitwise the one K1 evaluates for the same state.
//
// Layout per chain:
//   [4 scalars | N+1 birth-death | N+1 clock | cal, con, brace terms].
//
// Semantics kept exactly (build without fast-math, and with -fmad=false so
// each product rounds as in the op-by-op plain version): the root entries
// are exactly 0.0 and the root's parent (-1) is never read; +inf
// birth-death terms become -inf; NaN propagates as in jnp.where.  The
// birth-death terms are evaluated in double and rounded to float once, as
// the plain version (ops/birth_death.py) does: in float the standard D/E
// formula cancels catastrophically when |la - mu| is a few float ulps above
// the near-critical threshold, adding about +2 per inner node.

#pragma once

#include <cuda_runtime.h>
#include <math.h>

#include "device_math.cuh"

namespace mcmcdate {

// The model's static arrays and constants.
struct ModelArgs {
  const int* parent;             // [N], root -1
  const unsigned char* is_leaf;  // [N]
  int N;
  int clock_model;
  float mean_root_height, rho;
  const int* cal_node;
  const float* cal_lower;
  const float* cal_lower_pm;
  const float* cal_upper;
  const float* cal_upper_pm;
  int n_cal;
  const int* con_young;
  const int* con_old;
  const float* con_pm;
  int n_con;
  const int* br_node;  // [n_br, br_width], -1 padding
  const float* br_sd;
  int n_br, br_width;
};

__device__ __forceinline__ int off_bd(const ModelArgs&) { return 4; }
__device__ __forceinline__ int off_ck(const ModelArgs& m) { return 4 + m.N + 1; }
__device__ __forceinline__ int off_nd(const ModelArgs& m) { return 4 + 2 * (m.N + 1); }
__device__ __forceinline__ int n_node_terms(const ModelArgs& m) {
  return m.n_cal + m.n_con + m.n_br;
}

// Scalar term t (0..3): birth, death, rate_mean and rate_var priors.
__device__ __forceinline__ float scalar_term(const ModelArgs& m, int t, float la, float mu,
                                             float rate_mean, float rv) {
  if (t == 0) return exponential_logpdf(1.0f, la);
  if (t == 1) return exponential_logpdf(1.0f, mu);
  if (t == 2) return exponential_logpdf(m.mean_root_height, rate_mean);
  return gamma_logpdf(1.5f, (float)(1.0 / 6.0), rv);
}

// The height and rate arguments below are anything indexed like an array
// of float: a row of the state, or a view that forms a proposed state's
// values node by node (csrc/glob_step.cu).

// Birth-death term of node j < N (0 at the root), heights h, with the
// chain's rates as a BdRates (formed at each use) or a BdConsts (formed
// once per chain or ticket: bitwise the same term, device_math.cuh).
template <class HV, class K>
__device__ __forceinline__ float bd_term_k(const ModelArgs& m, const HV& h, int j, const K& k) {
  const int p = m.parent[j];
  if (p < 0) return 0.0f;
  const double rho = m.rho;
  const double hj = h[j];
  const double dt = (double)h[p] - hj;
  const bool leaf = m.is_leaf[j] != 0;
  double c, log_d, e;
  if (leaf) {
    c = 1.0 - rho;
  } else {
    de_factors(k, 1.0 - rho, hj, &log_d, &e);
    c = e;
  }
  de_factors(k, c, dt, &log_d, &e);
  if (!(dt > 0.0)) log_d = -INFINITY;
  const float v = (float)(log_d + (leaf ? log(rho) : k.log_la()));
  return v == INFINITY ? -INFINITY : v;
}

template <class HV>
__device__ __forceinline__ float bd_term(const ModelArgs& m, const HV& h, int j, float la_f,
                                         float mu_f) {
  return bd_term_k(m, h, j, BdRates{(double)la_f, (double)mu_f});
}

// Entry j of the birth-death block (j == N: the rates' validity term).
template <class HV>
__device__ __forceinline__ float bd_block_term(const ModelArgs& m, const HV& h, int j, float la,
                                               float mu) {
  if (j == m.N) {
    const bool valid = la >= 0.f && mu >= 0.f && m.rho > 0.f && m.rho <= 1.0f;
    return valid ? 0.0f : -INFINITY;
  }
  return bd_term(m, h, j, la, mu);
}

// Entry j of the clock block (j == N: the rate variance's validity term);
// r is the chain's rates row.
template <class HV, class RV>
__device__ __forceinline__ float clock_block_term(const ModelArgs& m, const HV& h, const RV& r,
                                                  int j, float rv) {
  if (j == m.N) return rv > 0.f ? 0.0f : -INFINITY;
  const int p = m.parent[j];
  if (p < 0) return 0.0f;
  return clock_term_local(m.clock_model, r[j], h[p] - h[j], rv);
}

// Node term k: calibrations, then constraints, then braces.
template <class HV>
__device__ __forceinline__ float node_term(const ModelArgs& m, const HV& h, int k, float H) {
  if (k < m.n_cal) {
    const float hk = h[m.cal_node[k]];
    const float lo = m.cal_lower[k] / H;
    const float hi = m.cal_upper[k] / H;
    const float s_lo = kSqrt2OverPi * m.cal_lower_pm[k];
    const float s_hi = kSqrt2OverPi * m.cal_upper_pm[k];
    const float below = clip0(lo - hk);
    const float above = clip0(hk - hi);
    const float b = below / (s_lo > 0.f ? s_lo : 1.0f);
    const float u = above / (s_hi > 0.f ? s_hi : 1.0f);
    const float lp = -0.5f * (b * b) - 0.5f * (isfinite(hi) ? u * u : 0.0f);
    return (H > 0.f && hk >= 0.f) ? lp : -INFINITY;
  }
  k -= m.n_cal;
  if (k < m.n_con) {
    const float s = kSqrt2OverPi * m.con_pm[k];
    const float v = clip0(h[m.con_young[k]] - h[m.con_old[k]]) / s;
    return -0.5f * (v * v);
  }
  k -= m.n_con;
  // One thread per brace, looping over its padded node list.
  const int* nodes = m.br_node + (size_t)k * m.br_width;
  float sum = 0.f;
  int count = 0;
  for (int w = 0; w < m.br_width; ++w) {
    if (nodes[w] >= 0) {
      sum += h[nodes[w]];
      ++count;
    }
  }
  const float hmean = sum / (float)count;
  const float s = m.br_sd[k];
  float lp = 0.f;
  for (int w = 0; w < m.br_width; ++w) {
    if (nodes[w] >= 0) {
      const float z = (h[nodes[w]] - hmean) / s;
      lp += -0.5f * (z * z);
    }
  }
  return lp;
}

// Entry t of the flat term vector of the state (h, r, la, mu, H,
// rate_mean, rv).
template <class HV, class RV>
__device__ __forceinline__ float prior_term(const ModelArgs& m, const HV& h, const RV& r, int t,
                                            float la, float mu, float H, float rate_mean,
                                            float rv) {
  if (t < 4) return scalar_term(m, t, la, mu, rate_mean, rv);
  if (t < off_ck(m)) return bd_block_term(m, h, t - 4, la, mu);
  if (t < off_nd(m)) return clock_block_term(m, h, r, t - off_ck(m), rv);
  return node_term(m, h, t - off_nd(m), H);
}

}  // namespace mcmcdate
