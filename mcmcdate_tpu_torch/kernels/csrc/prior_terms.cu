// K1 prior_terms: the flat log-prior term vector of DatingModel, fused.
//
// Replaces the XLA-compiled DatingModel.log_prior_terms of the JAX package
// (mcmcdate_tpu/models/dating.py:131), which concatenates term_scalars,
// birth_death_terms (ops/birth_death.py:89), relaxed_clock_terms
// (ops/clocks.py:100) and calibrate_constrain_brace_terms
// (ops/node_priors.py:153).  Output layout per chain:
//   [4 scalars | N+1 birth-death | N+1 clock | cal, con, brace terms].
//
// The terms are prior_terms.cuh's device functions, which the global-move
// family kernels (glob_step.cu) share, with the chain's birth-death and
// clock constants formed once (BdConsts, GammaClock of device_math.cuh),
// and the birth-death term as bd_term_k's operations for a node whose kind
// and parent the pass knows (bd_node_term): the same operations, so every
// term is bitwise the one prior_term gives.
//
// What bounds it on the H100: per inner node two double-precision D/E
// evaluations (an exp and a log each) and a log, per leaf one, per node a
// clock density (a float log under UncorrelatedGamma with its constants
// hoisted, lgammaf and logs under the others); bytes are 2 floats in and 2
// out per node and chain.  At 1024 chains the special functions and the
// double-precision units set the time, then the bytes.
//
// Layout: a CTA of kThreads threads takes G consecutive chains, G the
// fewest that put the whole grid in one wave of resident CTAs (the host
// asks the occupancy API).  Thread g < G forms chain g's constants into
// shared memory; then the CTA walks one flat list of work items, pass by
// pass, each pass one code path:
//   fixed  8 a chain: the 4 scalar terms, the root's birth-death and clock
//          entries (0) and the two validity entries (index N);
//   inner  the non-root inner nodes' birth-death terms;
//   leaves the leaves' birth-death terms;
//   clock  the non-root nodes' clock terms;
//   nodes  the calibration, constraint and brace terms,
// chain-major within a pass, so a warp runs one pass's code (but at the
// few items where a pass ends) on neighbouring nodes of one chain.  The
// node lists are built once on the host (kernels/prior_terms.py,
// kernel_arrays), each node with its parent, so a birth-death item loads
// its pair and then both heights: two dependent loads.  Heights and rates
// are read through L1, not staged: at 10,000 taxa a chain's heights are 80
// KB, and staging them would hold the kernel to two CTAs an SM.  Each term
// goes straight to its place in device memory: the CTA's rows assembled in
// shared memory and stored as 16-byte words measured slower (about 3% at
// 1000 taxa: the barrier and the extra pass cost more than the wider
// stores save).
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

constexpr int kThreads = 256;
constexpr int kFixed = 8;  // fixed items a chain

struct PriorArgs {
  ModelArgs m;
  const float* heights;  // [C, N]
  const float* rates;    // [C, N]
  const float* birth;    // [C]
  const float* death;
  const float* height;
  const float* rate_mean;
  const float* rate_var;
  const int2* bd_nodes;  // (node, parent): [n_inner non-root inner nodes | n_leaf leaves]
  int n_inner, n_leaf;
  int C, T, G;  // chains, terms a chain, chains a CTA
  float* terms;  // [C, T]
};

// A chain's scalars and the constants formed from them.
struct ChainConsts {
  BdConsts bd;
  GammaClock gc;
  float la, mu, H, rm, rv;
};

// A row of the state read through the read-only (L1) path.
struct LdgRow {
  const float* p;
  __device__ __forceinline__ float operator[](int j) const { return __ldg(p + j); }
};

// bd_term_k of a non-root node whose kind (LEAF) and parent's height are
// known: the same operations in the same order, so the same bits, without
// reading the node's parent and leaf flag.
template <bool LEAF>
__device__ __forceinline__ float bd_node_term(const ModelArgs& m, float h_node, float h_parent,
                                              const BdConsts& k) {
  const double rho = m.rho;
  const double hj = h_node;
  const double dt = (double)h_parent - hj;
  double c, log_d, e;
  if (LEAF) {
    c = 1.0 - rho;
  } else {
    de_factors(k, 1.0 - rho, hj, &log_d, &e);
    c = e;
  }
  de_factors(k, c, dt, &log_d, &e);
  if (!(dt > 0.0)) log_d = -INFINITY;
  const float v = (float)(log_d + (LEAF ? log(rho) : k.log_la()));
  return v == INFINITY ? -INFINITY : v;
}

__global__ void __launch_bounds__(kThreads, 4) prior_terms_kernel(PriorArgs a) {
  extern __shared__ __align__(16) unsigned char smem[];
  ChainConsts* kc = reinterpret_cast<ChainConsts*>(smem);  // [G]
  const ModelArgs& m = a.m;
  const int N = m.N, T = a.T;
  const int c0 = blockIdx.x * a.G;
  const int ng = min(a.G, a.C - c0);
  if ((int)threadIdx.x < ng) {
    const int c = c0 + threadIdx.x;
    ChainConsts k;
    k.la = a.birth[c];
    k.mu = a.death[c];
    k.H = a.height[c];
    k.rm = a.rate_mean[c];
    k.rv = a.rate_var[c];
    k.bd = bd_consts((double)k.la, (double)k.mu);
    k.gc = gamma_clock(k.rv);
    kc[threadIdx.x] = k;
  }
  __syncthreads();
  float* out0 = a.terms + (size_t)c0 * T;
  const int o_ck = off_ck(m), o_nd = off_nd(m);
  const int n_cl = N - 1, n_nd = n_node_terms(m);
  const int e1 = kFixed * ng, e2 = e1 + a.n_inner * ng, e3 = e2 + a.n_leaf * ng;
  const int e4 = e3 + n_cl * ng, e5 = e4 + n_nd * ng;
  for (int i = threadIdx.x; i < e5; i += kThreads) {
    if (i < e1) {
      const int g = i / kFixed, e = i - g * kFixed;
      const ChainConsts& k = kc[g];
      const LdgRow h{a.heights + (size_t)(c0 + g) * N}, r{a.rates + (size_t)(c0 + g) * N};
      float* o = out0 + (size_t)g * T;
      if (e < 4) o[e] = scalar_term(m, e, k.la, k.mu, k.rm, k.rv);
      else if (e == 4) o[4] = 0.0f;  // the root's (node 0) birth-death entry
      else if (e == 5) o[4 + N] = bd_block_term(m, h, N, k.la, k.mu);
      else if (e == 6) o[o_ck] = 0.0f;  // the root's clock entry
      else o[o_ck + N] = clock_block_term(m, h, r, N, k.rv);
    } else if (i < e3) {
      // Birth-death terms: the inner nodes' pass, then the leaves'.
      const bool inner = i < e2;
      const int n = inner ? a.n_inner : a.n_leaf;
      const int q = i - (inner ? e1 : e2);
      const int g = q / n, e = q - g * n;
      const int2 jp = a.bd_nodes[inner ? e : a.n_inner + e];
      const LdgRow h{a.heights + (size_t)(c0 + g) * N};
      const float hj = h[jp.x], hp = h[jp.y];
      out0[(size_t)g * T + 4 + jp.x] = inner ? bd_node_term<false>(m, hj, hp, kc[g].bd)
                                             : bd_node_term<true>(m, hj, hp, kc[g].bd);
    } else if (i < e4) {
      const int q = i - e3;
      const int g = q / n_cl, j = q - g * n_cl + 1;  // the non-root nodes 1 .. N-1
      const LdgRow r{a.rates + (size_t)(c0 + g) * N};
      float v;
      if (m.clock_model == 0) {
        v = gamma_clock_term(kc[g].gc, r[j]);
      } else {
        const LdgRow h{a.heights + (size_t)(c0 + g) * N};
        v = clock_block_term(m, h, r, j, kc[g].rv);
      }
      out0[(size_t)g * T + o_ck + j] = v;
    } else {
      const int q = i - e4;
      const int g = q / n_nd, e = q - g * n_nd;
      const LdgRow h{a.heights + (size_t)(c0 + g) * N};
      out0[(size_t)g * T + o_nd + e] = node_term(m, h, e, kc[g].H);
    }
  }
}

}  // namespace

extern "C" int mcmcdate_prior_terms_f32(
    const float* heights, const float* rates, const float* birth, const float* death,
    const float* height, const float* rate_mean, const float* rate_var, const int* parent,
    const unsigned char* is_leaf, const int2* bd_nodes, int n_inner, int n_leaf, int C, int N,
    int T, int clock_model, float mean_root_height, float rho, const int* cal_node,
    const float* cal_lower, const float* cal_lower_pm, const float* cal_upper,
    const float* cal_upper_pm, int n_cal, const int* con_young, const int* con_old,
    const float* con_pm, int n_con, const int* br_node, const float* br_sd, int n_br,
    int br_width, float* terms, void* stream) {
  const ModelArgs m{parent,   is_leaf,   N,          clock_model, mean_root_height,
                    rho,      cal_node,  cal_lower,  cal_lower_pm, cal_upper,
                    cal_upper_pm, n_cal, con_young,  con_old,     con_pm,
                    n_con,    br_node,   br_sd,      n_br,        br_width};
  if (C <= 0) return (int)cudaSuccess;
  int dev = 0, sms = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess) err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err != cudaSuccess) return (int)err;
  // The fewest chains a CTA that fit the grid in one wave.
  int G = 1;
  size_t smem = 0;
  for (;; ++G) {
    smem = (size_t)G * sizeof(ChainConsts);
    int per_sm = 0;
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, prior_terms_kernel, kThreads,
                                                        smem);
    if (err != cudaSuccess) return (int)err;
    if ((long long)G * (per_sm > 0 ? per_sm : 1) * sms >= C || G >= C) break;
  }
  PriorArgs a{m, heights, rates, birth, death, height, rate_mean, rate_var, bd_nodes,
              n_inner, n_leaf, C, T, G, terms};
  prior_terms_kernel<<<(C + G - 1) / G, kThreads, smem, (cudaStream_t)stream>>>(a);
  return (int)cudaGetLastError();
}

extern "C" const char* mcmcdate_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}
