// F2 fiber_de: one half-update of the red-black fiber differential evolution.
//
// Replaces the XLA-compiled half_update of the JAX make_fiber_de
// (mcmcdate_tpu/engine/ensemble.py:81-128).  CTA i takes chain c = act0 + i
// of the active half and its donors oth0 + a[i], oth0 + b[i] of the frozen
// half: the step g = (u_jump < jump_p ? gamma_jump : gamma_small)
// exp(gamma_jitter z), the proposal h' = h + g (h_a - h_b) node by node, the
// spans t_j = h_p(j) - h_j and t'_j, the rates r'_j = r_j t_j / t'_j (1 at
// the root and where t'_j <= eps), the proposal's validity (every non-root
// t'_j > eps) and log_jac = sum over non-root j of log(t_j / t'_j); then the
// whole log prior of the current and of the proposed state, as the JAX
// DatingModel.log_prior forms it from its blocks (birth-death with a NaN
// total as -inf, the clock's N branch terms, -inf where rate_var <= 0, the
// node priors), thread 0's decision log u_acc < lp' - lp + log_jac, and on
// accept the write-back of the chain's heights and rates.  The donors are in
// the other half, which the launch never writes.
//
// A thread takes nodes j = tid, tid + 256, ...: pass 1 forms h'_j (and its
// parent's h', the same operations, so the same bits), r'_j and the
// Jacobian and writes h' and r' to the h_prop, r_prop rows (outputs; the
// write-back copies them); after a barrier pass 2 evaluates each node's
// birth-death and clock terms and the node-prior terms of both states with
// prior_terms.cuh's device functions (K1's).  The block sums (block_sums of
// glob_moves.cuh) run in a fixed order, so a launch is deterministic.  What
// bounds it on the H100: per node two birth-death terms in double (each two
// exp/log pairs) and two clock terms, 2 (N + 1) + 2 N + 2 nn terms a chain;
// the bytes are the chain's and its donors' rows, 20 N bytes a chain, and
// m = C / 2 CTAs fill the card at 1024 chains.
//
// Built with -fmad=false, as the plain version (kernels/fiber_de.py)
// rounds each product on its own; its sums run in another order, and its
// exp is PyTorch's: the step g is an output, so a check can replay it.

#include <cuda_runtime.h>
#include <math.h>

#include "glob_moves.cuh"
#include "prior_terms.cuh"

namespace {

using namespace mcmcdate;

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;

// Mirrored field by field by kernels/fiber_de.py's _DEArgs: pointers, then
// ints, then floats.
struct DEArgs {
  // the model (ModelArgs)
  const int* parent;
  const unsigned char* is_leaf;
  const int* cal_node;
  const float* cal_lower;
  const float* cal_lower_pm;
  const float* cal_upper;
  const float* cal_upper_pm;
  const int* con_young;
  const int* con_old;
  const float* con_pm;
  const int* br_node;
  const float* br_sd;
  // the chains; the active half's heights and rates updated in place
  float* heights;  // [C, N]
  float* rates;    // [C, N]
  const float* birth;  // [C]
  const float* death;
  const float* height;
  const float* rate_mean;
  const float* rate_var;
  // draws [m]
  const int* a;
  const int* b;
  const float* u_jump;
  const float* z;
  const float* u_acc;
  // outputs
  unsigned char* accept;  // [m]
  float* g;               // [m]
  float* dlp;             // [m]
  float* log_jac;         // [m]
  float* h_prop;          // [m, N]
  float* r_prop;          // [m, N]
  int N, C, act0, m, oth0, clock_model, n_cal, n_con, n_br, br_width;
  float mean_root_height, rho, gamma_small, jump_p, gamma_jump, gamma_jitter, eps;
};

__device__ __forceinline__ ModelArgs model_of(const DEArgs& a) {
  return ModelArgs{a.parent,       a.is_leaf,  a.N,         a.clock_model, a.mean_root_height,
                   a.rho,          a.cal_node, a.cal_lower, a.cal_lower_pm, a.cal_upper,
                   a.cal_upper_pm, a.n_cal,    a.con_young, a.con_old,     a.con_pm,
                   a.n_con,        a.br_node,  a.br_sd,     a.n_br,        a.br_width};
}

// The log prior of DatingModel.log_prior from its block sums: node priors +
// (birth + death priors + birth-death total, NaN as -inf) + (rate-mean and
// rate-variance priors + clock total, -inf where rv <= 0).
__device__ __forceinline__ float log_prior(float s_nd, float s_bd, float s_ck, float sc01,
                                           float sc23, float rv) {
  const float bd = sc01 + (isnan(s_bd) ? -INFINITY : s_bd);
  const float ck = sc23 + (rv > 0.f ? s_ck : -INFINITY);
  return (s_nd + bd) + ck;
}

__global__ void __launch_bounds__(kThreads) fiber_de_kernel(DEArgs a) {
  __shared__ float red[7][kWarps];
  __shared__ bool take;
  const int i = blockIdx.x;
  const int tid = threadIdx.x;
  const int N = a.N;
  const ModelArgs md = model_of(a);
  const int c = a.act0 + i;
  const float* h0 = a.heights + (size_t)c * N;
  const float* r0 = a.rates + (size_t)c * N;
  const float* ha = a.heights + (size_t)(a.oth0 + a.a[i]) * N;
  const float* hb = a.heights + (size_t)(a.oth0 + a.b[i]) * N;
  float* hp = a.h_prop + (size_t)i * N;
  float* rp = a.r_prop + (size_t)i * N;
  const float g = (a.u_jump[i] < a.jump_p ? a.gamma_jump : a.gamma_small) *
                  expf(a.gamma_jitter * a.z[i]);
  const float la = a.birth[c], mu = a.death[c], H = a.height[c], rv = a.rate_var[c];
  // v: birth-death, clock and node-prior sums of the current state (0-2)
  // and of the proposed one (3-5), then log_jac (6).
  float v[7] = {0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f};
  bool bad = false;
  for (int j = tid; j < N; j += kThreads) {
    const float hj = h0[j] + g * (ha[j] - hb[j]);
    hp[j] = hj;
    float ratio = 1.0f;
    if (j > 0) {
      const int p = a.parent[j];
      const float hpp = h0[p] + g * (ha[p] - hb[p]);
      const float t0 = h0[p] - h0[j];
      const float t1 = hpp - hj;
      if (t1 > a.eps) {
        ratio = t0 / t1;
        v[6] += logf(ratio);
      } else {
        bad = true;
      }
    }
    rp[j] = r0[j] * ratio;
    v[0] += bd_block_term(md, h0, j, la, mu);
    v[1] += clock_block_term(md, h0, r0, j, rv);
  }
  // The proposal's rows are written: every thread may read them.
  __syncthreads();
  for (int j = tid; j < N; j += kThreads) {
    v[3] += bd_block_term(md, hp, j, la, mu);
    v[4] += clock_block_term(md, hp, rp, j, rv);
  }
  if (tid == 0) {
    // The birth-death block's validity entry (index N), alike in both.
    const float x = bd_block_term(md, h0, N, la, mu);
    v[0] += x;
    v[3] += x;
  }
  for (int k = tid; k < n_node_terms(md); k += kThreads) {
    v[2] += node_term(md, h0, k, H);
    v[5] += node_term(md, hp, k, H);
  }
  block_sums<7>(v, red, bad);
  if (tid == 0) {
    const float sc01 = scalar_term(md, 0, la, mu, a.rate_mean[c], rv) +
                       scalar_term(md, 1, la, mu, a.rate_mean[c], rv);
    const float sc23 = scalar_term(md, 2, la, mu, a.rate_mean[c], rv) +
                       scalar_term(md, 3, la, mu, a.rate_mean[c], rv);
    const float lp_cur = log_prior(v[2], v[0], v[1], sc01, sc23, rv);
    const float lp_new = log_prior(v[5], v[3], v[4], sc01, sc23, rv);
    const float dlp = (lp_new - lp_cur) + v[6];
    take = !bad && logf(a.u_acc[i]) < dlp;
    a.accept[i] = take;
    a.g[i] = g;
    a.dlp[i] = dlp;
    a.log_jac[i] = v[6];
  }
  __syncthreads();
  if (!take) return;
  float* h = a.heights + (size_t)c * N;
  float* r = a.rates + (size_t)c * N;
  for (int j = tid; j < N; j += kThreads) {
    h[j] = hp[j];
    r[j] = rp[j];
  }
}

}  // namespace

extern "C" int mcmcdate_de_args_size() { return (int)sizeof(DEArgs); }

extern "C" int mcmcdate_fiber_de_f32(const void* args, void* stream) {
  const DEArgs& a = *static_cast<const DEArgs*>(args);
  if (a.m == 0) return (int)cudaSuccess;
  fiber_de_kernel<<<a.m, kThreads, 0, (cudaStream_t)stream>>>(a);
  return (int)cudaGetLastError();
}
