// F1 fiber_slide: one colour class of the fiber node-slide.
//
// Replaces the XLA-compiled class step of FastSweeps._fiber_slide_move
// (mcmcdate_tpu/engine/fast_sweep.py:2016-2113).  For chain c and class node
// v (parent p, children ch; no two nodes of a class tree-adjacent or in one
// constraint or brace): h_v' = lo + u (h_p - lo) with lo the oldest child's
// height (0 if none is higher), the stem rate times f_s = (h_p - h_v)/(h_p -
// h_v') and each child's rate times f_c = (h_v - h_c)/(h_v' - h_c), so that
// every branch distance stays; the owned terms' delta (a NaN delta counts as
// -inf), log alpha = beta_prior * delta + log f_s + sum log f_c, accepted
// when log u_acc < log alpha; on accept the height, the rates and the owned
// terms are written in place.  The owned terms are the class's owner map
// (engine/fast_sweep.py fiber_slide_plan) as a row list per node: the
// birth-death and clock entries of v and its children and the node priors
// v owns.  No two nodes of a class read or write a common entry, so every
// (chain, node) pair is an independent thread.
//
// A term is prior_terms.cuh's device function (K1's) evaluated through a
// view of the proposed state (SlideHeights, SlideRates: the old row with v's
// height and the rescaled rates formed on read), so it is bitwise K1's for
// that state.  What bounds it on the H100: the birth-death terms in double
// (two exp/log pairs for v, one or two for each child), then the gathers (a
// node's and its children's heights and rates, its owned terms: scattered
// 4-byte reads of the chain's rows).  Bytes are tens a (chain, node), so
// the kernel is latency- and double-bound: a thread per pair, 128 a CTA,
// the node fastest so that a warp reads one chain's rows.  The first kBuf
// owned terms stay in registers for the write-back; a node that owns more
// (a wide multifurcation or many node priors) evaluates the rest again on
// accept, with the same bits.
//
// Built with -fmad=false: every product rounds on its own, as in the
// op-by-op plain version (kernels/fiber_slide.py), whose proposal, factors
// and terms are then the same bits; its log is PyTorch's, the sums run in
// another order (index_add_ over the owner map), so log alpha may differ in
// its last bits.

#include <cuda_runtime.h>
#include <math.h>

#include "glob_moves.cuh"
#include "prior_terms.cuh"

namespace {

using namespace mcmcdate;

constexpr int kThreads = 128;
constexpr int kBuf = 16;

// Mirrored field by field by kernels/fiber_slide.py's _FiberArgs: pointers,
// then ints, then floats.
struct FiberArgs {
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
  // the chains, heights, rates and terms updated in place
  float* heights;  // [C, N]
  float* rates;    // [C, N]
  const float* birth;  // [C]
  const float* death;
  const float* height;
  const float* rate_mean;
  const float* rate_var;
  float* terms;  // [C, T]
  // the class
  const int* idx;       // [m]
  const int* par;       // [m]
  const int* ch;        // [m, KC], -1 padding
  const int* own_ptr;   // [m + 1]
  const int* own_rows;  // owned term rows, node by node, ascending
  // draws and outputs [C, m]
  const float* u;
  const float* u_acc;
  const float* beta_prior;  // [C]
  unsigned char* accept;
  float* log_alpha;
  float* h_new;
  int* count;  // [1] the class's accepts added (nullable)
  int N, C, T, m, KC, clock_model, n_cal, n_con, n_br, br_width;
  float mean_root_height, rho;
};

__device__ __forceinline__ ModelArgs model_of(const FiberArgs& a) {
  return ModelArgs{a.parent,       a.is_leaf,  a.N,         a.clock_model, a.mean_root_height,
                   a.rho,          a.cal_node, a.cal_lower, a.cal_lower_pm, a.cal_upper,
                   a.cal_upper_pm, a.n_cal,    a.con_young, a.con_old,     a.con_pm,
                   a.n_con,        a.br_node,  a.br_sd,     a.n_br,        a.br_width};
}

// The proposed heights: node v at hn, the others as they are.
struct SlideHeights {
  const float* h;
  int v;
  float hn;
  __device__ __forceinline__ float operator[](int j) const { return j == v ? hn : h[j]; }
};

// The proposed rates: v's times f_s, each child's times its f_c (the plain
// version's operations), the others as they are.
struct SlideRates {
  const float* h;
  const float* r;
  const int* parent;
  int v;
  float hv, hn, f_s;
  __device__ __forceinline__ float operator[](int j) const {
    if (j == v) return r[j] * f_s;
    if (parent[j] == v) {
      const float hc = h[j];
      return r[j] * ((hv - hc) / (hn - hc));
    }
    return r[j];
  }
};

// Node j of the class on chain c; returns the decision.
__device__ __forceinline__ bool slide_node(const FiberArgs& a, const ModelArgs& md, int c,
                                           int j) {
  const size_t cj = (size_t)c * a.m + j;
  float* h = a.heights + (size_t)c * a.N;
  float* r = a.rates + (size_t)c * a.N;
  float* te = a.terms + (size_t)c * a.T;
  const int v = a.idx[j];
  const int p = a.par[j];
  const float hv = h[v];
  const float hp = h[p];
  const int* chj = a.ch + (size_t)j * a.KC;
  float lo = 0.f;
  for (int k = 0; k < a.KC; ++k) lo = max_nan(lo, chj[k] >= 0 ? h[chj[k]] : 0.f);
  const float hn = lo + a.u[cj] * (hp - lo);
  const float f_s = (hp - hv) / (hp - hn);
  float lj_ch = 0.f;
  for (int k = 0; k < a.KC; ++k) {
    if (chj[k] < 0) continue;
    const float hc = h[chj[k]];
    lj_ch += logf((hv - hc) / (hn - hc));
  }
  const float log_jac = logf(f_s) + lj_ch;
  const SlideHeights hview{h, v, hn};
  const SlideRates rview{h, r, a.parent, v, hv, hn, f_s};
  const float la = a.birth[c], mu = a.death[c], H = a.height[c], rm = a.rate_mean[c],
              rv = a.rate_var[c];
  const int e0 = a.own_ptr[j], e1 = a.own_ptr[j + 1];
  float buf[kBuf];
  float dsum = 0.f;
  for (int e = e0; e < e1; ++e) {
    const int t = a.own_rows[e];
    const float x = prior_term(md, hview, rview, t, la, mu, H, rm, rv);
    if (e - e0 < kBuf) buf[e - e0] = x;
    float d = x - te[t];
    if (isnan(d)) d = -INFINITY;
    dsum += d;
  }
  const float log_alpha = __fmul_rn(a.beta_prior[c], dsum) + log_jac;
  const bool ok = logf(a.u_acc[cj]) < log_alpha;
  a.accept[cj] = ok;
  a.log_alpha[cj] = log_alpha;
  a.h_new[cj] = hn;
  if (!ok) return false;
  // The terms first (evaluated from the old rows through the views), then
  // the rates and the height.
  for (int e = e0; e < e1; ++e) {
    const int t = a.own_rows[e];
    te[t] = e - e0 < kBuf ? buf[e - e0] : prior_term(md, hview, rview, t, la, mu, H, rm, rv);
  }
  for (int k = 0; k < a.KC; ++k) {
    const int cc = chj[k];
    if (cc < 0) continue;
    const float hc = h[cc];
    r[cc] = r[cc] * ((hv - hc) / (hn - hc));
  }
  r[v] = r[v] * f_s;
  h[v] = hn;
  return true;
}

__global__ void __launch_bounds__(kThreads) fiber_slide_kernel(FiberArgs a) {
  __shared__ int n_acc;
  if (threadIdx.x == 0) n_acc = 0;
  __syncthreads();
  const ModelArgs md = model_of(a);
  const long gid = (long)blockIdx.x * blockDim.x + threadIdx.x;
  bool ok = false;
  if (gid < (long)a.C * a.m) {
    const int c = (int)(gid / a.m);
    ok = slide_node(a, md, c, (int)(gid - (long)c * a.m));
  }
  if (a.count == nullptr) return;
  const unsigned votes = __ballot_sync(0xffffffffu, ok);
  if ((threadIdx.x & 31) == 0 && votes) atomicAdd(&n_acc, __popc(votes));
  __syncthreads();
  if (threadIdx.x == 0 && n_acc) atomicAdd(a.count, n_acc);
}

}  // namespace

extern "C" int mcmcdate_fiber_args_size() { return (int)sizeof(FiberArgs); }

extern "C" int mcmcdate_fiber_slide_f32(const void* args, void* stream) {
  const FiberArgs& a = *static_cast<const FiberArgs*>(args);
  const long pairs = (long)a.C * a.m;
  if (pairs == 0) return (int)cudaSuccess;
  fiber_slide_kernel<<<(int)((pairs + kThreads - 1) / kThreads), kThreads, 0,
                       (cudaStream_t)stream>>>(a);
  return (int)cudaGetLastError();
}
