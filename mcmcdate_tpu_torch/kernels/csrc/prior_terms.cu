// K1 prior_terms: the flat log-prior term vector of DatingModel, fused.
//
// Replaces the XLA-compiled DatingModel.log_prior_terms of the JAX package
// (mcmcdate_tpu/models/dating.py:131), which concatenates term_scalars,
// birth_death_terms (ops/birth_death.py:89), relaxed_clock_terms
// (ops/clocks.py:100) and calibrate_constrain_brace_terms
// (ops/node_priors.py:153).  Output layout per chain:
//   [4 scalars | N+1 birth-death | N+1 clock | cal, con, brace terms].
//
// The terms themselves are prior_terms.cuh's device functions, which the
// global-move family kernels (glob_step.cu) share.
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

#include "prior_terms.cuh"

namespace {

using namespace mcmcdate;

struct PriorArgs {
  ModelArgs m;
  const float* heights;  // [C, N]
  const float* rates;    // [C, N]
  const float* birth;    // [C]
  const float* death;
  const float* height;
  const float* rate_mean;
  const float* rate_var;
  int C, T;
  float* terms;  // [C, T]
};

__global__ void prior_terms_kernel(PriorArgs a) {
  extern __shared__ float h[];
  const int N = a.m.N;
  const int c = blockIdx.x;
  const float* hrow = a.heights + (size_t)c * N;
  for (int j = threadIdx.x; j < N; j += blockDim.x) h[j] = hrow[j];
  __syncthreads();
  const float* r = a.rates + (size_t)c * N;
  const float la = a.birth[c];
  const float mu = a.death[c];
  const float H = a.height[c];
  const float rm = a.rate_mean[c];
  const float rv = a.rate_var[c];
  float* out = a.terms + (size_t)c * a.T;
  for (int t = threadIdx.x; t < a.T; t += blockDim.x) {
    out[t] = prior_term(a.m, h, r, t, la, mu, H, rm, rv);
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
  const ModelArgs m{parent,   is_leaf,   N,          clock_model, mean_root_height,
                    rho,      cal_node,  cal_lower,  cal_lower_pm, cal_upper,
                    cal_upper_pm, n_cal, con_young,  con_old,     con_pm,
                    n_con,    br_node,   br_sd,      n_br,        br_width};
  PriorArgs a{m, heights, rates, birth, death, height, rate_mean, rate_var, C, T, terms};
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
