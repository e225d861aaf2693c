// K1 prior_terms: the flat log-prior term vector of DatingModel, fused.
//
// Replaces the XLA-compiled DatingModel.log_prior_terms of the JAX package
// (mcmcdate_tpu/models/dating.py:131), which concatenates term_scalars,
// birth_death_terms (ops/birth_death.py:89), relaxed_clock_terms
// (ops/clocks.py:100) and calibrate_constrain_brace_terms
// (ops/node_priors.py:153).  Output layout per chain:
//   [4 scalars | N+1 birth-death | N+1 clock | cal, con, brace terms].
//
// Layout: one block per chain, threads over the term index.  The chain's
// node heights are staged in shared memory because every birth-death and
// clock term reads its own and its parent's height.
//
// What bounds it on the H100: per node it does two closed-form D/E
// evaluations (an exp and up to five logs) and a gamma or log-normal
// density (lgammaf, logs); bytes are 2 floats in and 2 floats out per node
// and chain, so at 1024 chains x 2k nodes it is a few MB each way and the
// special functions dominate.  The design keeps everything in registers
// and shared memory: each output is written once, nothing intermediate
// reaches device memory.
//
// Semantics kept exactly (build without fast-math, and with -fmad=false so
// each product rounds as in the op-by-op plain version): the root entries
// are exactly 0.0 and the root's parent (-1) is never read; +inf
// birth-death terms become -inf; NaN propagates as in jnp.where.
//
// The birth-death terms are evaluated in double and rounded to float once,
// as the plain version (ops/birth_death.py) does: in float the standard
// D/E formula cancels catastrophically when |la - mu| is a few float ulps
// above the near-critical threshold, adding about +2 per inner node.

#include <cuda_runtime.h>
#include <math.h>

#include "device_math.cuh"

namespace {

struct PriorArgs {
  const float* heights;  // [C, N]
  const float* rates;    // [C, N]
  const float* birth;    // [C]
  const float* death;
  const float* height;
  const float* rate_mean;
  const float* rate_var;
  const int* parent;            // [N], root -1
  const unsigned char* is_leaf;  // [N]
  int C, N, T;
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
  float* terms;  // [C, T]
};

using namespace mcmcdate;

__device__ float bd_term(const PriorArgs& a, const float* h, int j, float la_f, float mu_f) {
  const int p = a.parent[j];
  if (p < 0) return 0.0f;
  const double la = la_f, mu = mu_f, rho = a.rho;
  const double hj = h[j];
  const double dt = (double)h[p] - hj;
  const bool leaf = a.is_leaf[j] != 0;
  double c, log_d, e;
  if (leaf) {
    c = 1.0 - rho;
  } else {
    de_factors(la, mu, 1.0 - rho, hj, &log_d, &e);
    c = e;
  }
  de_factors(la, mu, c, dt, &log_d, &e);
  if (!(dt > 0.0)) log_d = -INFINITY;
  const float v = (float)(log_d + (leaf ? log(rho) : log(la)));
  return v == INFINITY ? -INFINITY : v;
}

__device__ float clock_term(const PriorArgs& a, const float* h, int c, int j, float rv) {
  const int p = a.parent[j];
  if (p < 0) return 0.0f;
  return clock_term_local(a.clock_model, a.rates[(size_t)c * a.N + j], h[p] - h[j], rv);
}

__device__ float node_term(const PriorArgs& a, const float* h, int k, float H) {
  if (k < a.n_cal) {
    const float hk = h[a.cal_node[k]];
    const float lo = a.cal_lower[k] / H;
    const float hi = a.cal_upper[k] / H;
    const float s_lo = kSqrt2OverPi * a.cal_lower_pm[k];
    const float s_hi = kSqrt2OverPi * a.cal_upper_pm[k];
    const float below = clip0(lo - hk);
    const float above = clip0(hk - hi);
    const float b = below / (s_lo > 0.f ? s_lo : 1.0f);
    const float u = above / (s_hi > 0.f ? s_hi : 1.0f);
    const float lp = -0.5f * (b * b) - 0.5f * (isfinite(hi) ? u * u : 0.0f);
    return (H > 0.f && hk >= 0.f) ? lp : -INFINITY;
  }
  k -= a.n_cal;
  if (k < a.n_con) {
    const float s = kSqrt2OverPi * a.con_pm[k];
    const float v = clip0(h[a.con_young[k]] - h[a.con_old[k]]) / s;
    return -0.5f * (v * v);
  }
  k -= a.n_con;
  // One thread per brace, looping over its padded node list.
  const int* nodes = a.br_node + (size_t)k * a.br_width;
  float sum = 0.f;
  int count = 0;
  for (int w = 0; w < a.br_width; ++w) {
    if (nodes[w] >= 0) {
      sum += h[nodes[w]];
      ++count;
    }
  }
  const float hmean = sum / (float)count;
  const float s = a.br_sd[k];
  float lp = 0.f;
  for (int w = 0; w < a.br_width; ++w) {
    if (nodes[w] >= 0) {
      const float z = (h[nodes[w]] - hmean) / s;
      lp += -0.5f * (z * z);
    }
  }
  return lp;
}

__global__ void prior_terms_kernel(PriorArgs a) {
  extern __shared__ float h[];
  const int c = blockIdx.x;
  const float* hrow = a.heights + (size_t)c * a.N;
  for (int j = threadIdx.x; j < a.N; j += blockDim.x) h[j] = hrow[j];
  __syncthreads();
  const float la = a.birth[c];
  const float mu = a.death[c];
  const float H = a.height[c];
  const float rv = a.rate_var[c];
  const int off_ck = 4 + a.N + 1;
  const int off_nd = off_ck + a.N + 1;
  float* out = a.terms + (size_t)c * a.T;
  for (int t = threadIdx.x; t < a.T; t += blockDim.x) {
    float v;
    if (t < 4) {
      if (t == 0) v = exponential_logpdf(1.0f, la);
      else if (t == 1) v = exponential_logpdf(1.0f, mu);
      else if (t == 2) v = exponential_logpdf(a.mean_root_height, a.rate_mean[c]);
      else v = gamma_logpdf(1.5f, (float)(1.0 / 6.0), rv);
    } else if (t < off_ck) {
      const int j = t - 4;
      if (j == a.N) {
        const bool valid = la >= 0.f && mu >= 0.f && a.rho > 0.f && a.rho <= 1.0f;
        v = valid ? 0.0f : -INFINITY;
      } else {
        v = bd_term(a, h, j, la, mu);
      }
    } else if (t < off_nd) {
      const int j = t - off_ck;
      v = (j == a.N) ? (rv > 0.f ? 0.0f : -INFINITY) : clock_term(a, h, c, j, rv);
    } else {
      v = node_term(a, h, t - off_nd, H);
    }
    out[t] = v;
  }
}

}  // namespace

extern "C" int mcmcdate_prior_terms_f32(
    const float* heights, const float* rates, const float* birth, const float* death,
    const float* height, const float* rate_mean, const float* rate_var, const int* parent,
    const unsigned char* is_leaf, int C, int N, int T, int clock_model, float mean_root_height,
    float rho, const int* cal_node, const float* cal_lower, const float* cal_lower_pm,
    const float* cal_upper, const float* cal_upper_pm, int n_cal, const int* con_young,
    const int* con_old, const float* con_pm, int n_con, const int* br_node, const float* br_sd,
    int n_br, int br_width, float* terms, void* stream) {
  PriorArgs a{heights,   rates,      birth,        death,     height,       rate_mean,
              rate_var,  parent,     is_leaf,      C,         N,            T,
              clock_model, mean_root_height, rho,  cal_node,  cal_lower,    cal_lower_pm,
              cal_upper, cal_upper_pm, n_cal,      con_young, con_old,      con_pm,
              n_con,     br_node,    br_sd,        n_br,      br_width,     terms};
  const size_t smem = (size_t)N * sizeof(float);
  if (smem > 48 * 1024) {
    cudaError_t err = cudaFuncSetAttribute(
        prior_terms_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return (int)err;
  }
  if (C > 0) {
    prior_terms_kernel<<<C, 256, smem, (cudaStream_t)stream>>>(a);
  }
  return (int)cudaGetLastError();
}

extern "C" const char* mcmcdate_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}
