// The global-move families of FastSweeps: G1 glob_scan, G2
// glob_dense_prologue and G3 glob_dense_epilogue.
//
// Together with one product w = delta @ P between G2 and G3 they replace
// the XLA-compiled FastSweeps._glob_step of the JAX package
// (mcmcdate_tpu/engine/fast_sweep.py:878-1219), which the JAX sweep scans
// once per family (:2171-2186).  A family's tickets are serial within a
// chain (each proposes from the state the previous one left) and chains are
// independent, so every kernel runs one CTA per chain.
//
// G1 glob_scan_kernel: the eight families whose distances are untouched
// (bd_scale, rate_var, hm_contra, norm_contra, normh_contra, sub_contra) or
// scale uniformly (rate_mean, height: d' = u d, z' = u z + (u-1) P mu, dq in
// closed form from mu'z), one launch for the whole family: the CTA walks
// the family's tickets in order, and for each forms the proposal from the
// injected draw, writes the proposed heights or rates to scratch, evaluates
// the term blocks the family can change (prior_terms.cuh, as K1 does),
// reduces new - old under sum_valid's NaN rule, decides, and writes the
// accepted ticket back.
// G2 glob_dense_prologue_kernel (one ticket of var_tree, var_auto,
// rates_time, slide_root, sub_ultra or sub_rate): the proposal, the
// proposed state, its term blocks, d_new = distances_internal of it and
// delta = d_new - d, lmhg, the root-branch Jacobian lj, d_pr and the
// invalid flag.  G3 glob_dense_epilogue_kernel: dq = sum delta (2z + w),
// the decision, and the write-back of state, terms, d, z, q and the accept
// count.
//
// What bounds them on the H100: the term blocks' special functions (the
// birth-death block in double: two D/E evaluations per node), a few floats
// per node and chain in and out; and the serial walk over a family's
// tickets, which the host launch per ticket bounded before (about 140
// plain-torch launches a ticket).  The design: one launch per family for
// G1 and two per dense ticket, every intermediate of a ticket in registers
// or in per-chain scratch rows that stay in L2 (proposed heights, rates
// and terms: any N fits, no shared-memory limit), block reductions by warp
// shuffles.  Built with -fmad=false: the proposed state and its terms are
// bitwise the plain step's (which evaluates its terms with K1), given the
// same proposal; CUDA's normal CDF and its inverse may move a truncated-
// normal proposal in its last bits, so the checks on the card replay the
// kernels' proposals.

#include <cuda_runtime.h>
#include <math.h>

#include "glob_moves.cuh"
#include "lane_groups.cuh"
#include "prior_terms.cuh"

namespace {

using namespace mcmcdate;

enum Block { B_SC = 1, B_BD = 2, B_CK = 4, B_ND = 8 };
constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;

// Mirrored field by field by kernels/glob_step.py's _GlobArgs: pointers,
// then ints, then floats.
struct GlobArgs {
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
  // the carry, updated in place
  float* heights;  // [C, N]
  float* rates;    // [C, N]
  float* birth;    // [C]
  float* death;
  float* height;
  float* rate_mean;
  float* rate_var;
  float* terms;  // [C, T]
  float* d;      // [C, D]
  float* z;      // [C, D] (use_lik)
  float* q;      // [C]
  int* acc;      // [C, P]
  // likelihood constants and topology
  const float* mu;      // [D] (use_lik)
  const float* pmu;     // [D] P mu (use_lik)
  const int* dist_idx;  // [D] node of each internal-layout distance
  const int* root_ch;   // [n_root_ch] children of the root
  // the family's tickets [n]
  const int* rows;
  const float* sd;
  const int* aux;
  const int* lo;
  const int* hi;
  const int* n_inner;
  const int* n_nodes;
  const unsigned char* rj;
  // per chain and ticket [C, n]
  const float* tun;
  const float* draw;
  const float* u_acc;
  // outputs: G1 accept and prop [C, n]; G2 prop and mean [C]; G3 accept [C]
  unsigned char* accept;
  float* prop;
  float* mean;
  // scratch of the proposed ticket (G1: per chain; G2 -> G3)
  float* h_new;  // [C, N]
  float* r_new;  // [C, N]
  float* s_new;  // [C, 5] birth, death, height, rate_mean, rate_var
  float* t_new;  // [C, T] (the family's blocks)
  float* d_new;  // [C, D]
  float* delta;  // [C, D]
  float* lmhg;   // [C]
  float* lj;     // [C]
  float* d_pr;   // [C]
  unsigned char* invalid;  // [C]
  const float* w;          // [C, D] delta @ P (G3, use_lik)
  // ints
  int N, C, T, D, P, n, s, family, blocks, fields, use_lik, clock_model;
  int n_cal, n_con, n_br, br_width, n_root_ch, root_right, n_inner_total;
  int sc_birth, sc_death, sc_bd, sc_bdc;
  // floats
  float mean_root_height, rho, mPm;
};

__device__ __forceinline__ ModelArgs model_of(const GlobArgs& a) {
  return ModelArgs{a.parent,    a.is_leaf,      a.N,       a.clock_model, a.mean_root_height,
                   a.rho,       a.cal_node,     a.cal_lower, a.cal_lower_pm, a.cal_upper,
                   a.cal_upper_pm, a.n_cal,     a.con_young, a.con_old,   a.con_pm,
                   a.n_con,     a.br_node,      a.br_sd,   a.n_br,        a.br_width};
}

// The glob kernels' view of the moves' arguments (csrc/glob_moves.cuh).
__device__ __forceinline__ GlobModel gmodel_of(const GlobArgs& a) {
  return GlobModel{a.parent, a.is_leaf, a.root_ch, a.N, a.n_root_ch, a.n_inner_total,
                   a.sc_birth, a.sc_death, a.sc_bd, a.sc_bdc};
}

// Ticket s of the family, for chain c (cs = c n + s).
__device__ __forceinline__ Ticket propose(const GlobArgs& a, size_t cs, int s, const float* h,
                                          const float* r, const Scalars& cur, float mean) {
  const GlobDraw t{a.family, a.sd[s], a.tun[cs], a.draw[cs], a.aux[s],
                   a.lo[s],  a.hi[s], a.n_inner[s], a.n_nodes[s]};
  return mcmcdate::propose(gmodel_of(a), t, h, r, cur, mean);
}

__device__ __forceinline__ float new_height(const GlobArgs& a, const Ticket& k, const float* h,
                                            int j) {
  return mcmcdate::new_height(gmodel_of(a), a.family, k, h, j);
}

__device__ __forceinline__ float new_rate(const GlobArgs& a, const Ticket& k, const float* h,
                                          const float* r, int j) {
  return mcmcdate::new_rate(gmodel_of(a), a.family, k, h, r, j);
}

// Writes the chain's proposed heights and rates (the fields the family
// changes) to scratch; returns whether a non-root rate is not positive
// (var_tree, var_auto).
__device__ bool write_proposed(const GlobArgs& a, const Ticket& k, const float* h, const float* r,
                               float* hn, float* rn) {
  bool nonpos = false;
  for (int j = threadIdx.x; j < a.N; j += kThreads) {
    if (a.fields & F_HEIGHTS) hn[j] = new_height(a, k, h, j);
    if (a.fields & F_RATES) {
      const float x = new_rate(a, k, h, r, j);
      rn[j] = x;
      nonpos = nonpos || (a.parent[j] >= 0 && !(x > 0.f));
    }
  }
  return nonpos;
}

// The family's term blocks of the proposed state (hp, rp, k.s) into tn,
// with each block's sum of new - old over the non-NaN differences in
// part[0..3] (sc, bd, ck, nd) and `bad` set by a NaN or -inf new term.
__device__ void eval_blocks(const GlobArgs& a, const ModelArgs& m, const Ticket& k,
                            const float* hp, const float* rp, const float* te, float* tn,
                            float (&part)[4], bool& bad) {
  const Scalars& s = k.s;
  const int N = a.N;
  auto put = [&](int b, int idx, float v) {
    tn[idx] = v;
    const float diff = v - te[idx];
    if (!isnan(diff)) part[b] += diff;
    bad = bad || isnan(v) || v == -INFINITY;
  };
  if (a.blocks & B_SC) {
    for (int t = threadIdx.x; t < 4; t += kThreads)
      put(0, t, scalar_term(m, t, s.birth, s.death, s.rate_mean, s.rate_var));
  }
  if (a.blocks & B_BD) {
    for (int j = threadIdx.x; j <= N; j += kThreads)
      put(1, 4 + j, bd_block_term(m, hp, j, s.birth, s.death));
  }
  if (a.blocks & B_CK) {
    const int o = off_ck(m);
    for (int j = threadIdx.x; j <= N; j += kThreads)
      put(2, o + j, clock_block_term(m, hp, rp, j, s.rate_var));
  }
  if (a.blocks & B_ND) {
    const int o = off_nd(m), nn = n_node_terms(m);
    for (int j = threadIdx.x; j < nn; j += kThreads) put(3, o + j, node_term(m, hp, j, s.height));
  }
}

// Copies the family's blocks from tn to te (the same index sets as
// eval_blocks).
__device__ void store_blocks(const GlobArgs& a, const ModelArgs& m, const float* tn, float* te) {
  const int N = a.N;
  if (a.blocks & B_SC)
    for (int t = threadIdx.x; t < 4; t += kThreads) te[t] = tn[t];
  if (a.blocks & B_BD)
    for (int j = threadIdx.x; j <= N; j += kThreads) te[4 + j] = tn[4 + j];
  if (a.blocks & B_CK) {
    const int o = off_ck(m);
    for (int j = threadIdx.x; j <= N; j += kThreads) te[o + j] = tn[o + j];
  }
  if (a.blocks & B_ND) {
    const int o = off_nd(m), nn = n_node_terms(m);
    for (int j = threadIdx.x; j < nn; j += kThreads) te[o + j] = tn[o + j];
  }
}

// The plain version's order: 0 + sum(sc) + sum(bd) + sum(ck) + sum(nd)
// over the family's blocks.
__device__ __forceinline__ float prior_delta(int blocks, const float (&part)[4]) {
  float dp = 0.f;
  for (int b = 0; b < 4; ++b)
    if (blocks & (1 << b)) dp = dp + part[b];
  return dp;
}

// The accepted ticket's scalars (thread 0).
__device__ __forceinline__ void store_scalars(const GlobArgs& a, int c, const Scalars& s) {
  if (a.fields & F_BIRTH) a.birth[c] = s.birth;
  if (a.fields & F_DEATH) a.death[c] = s.death;
  if (a.fields & F_HEIGHT) a.height[c] = s.height;
  if (a.fields & F_RATE_MEAN) a.rate_mean[c] = s.rate_mean;
  if (a.fields & F_RATE_VAR) a.rate_var[c] = s.rate_var;
}

__device__ __forceinline__ void store_nodes(const GlobArgs& a, const float* hn, const float* rn,
                                            float* h, float* r) {
  for (int j = threadIdx.x; j < a.N; j += kThreads) {
    if (a.fields & F_HEIGHTS) h[j] = hn[j];
    if (a.fields & F_RATES) r[j] = rn[j];
  }
}

__device__ __forceinline__ Scalars scalars_of(const GlobArgs& a, int c) {
  return Scalars{a.birth[c], a.death[c], a.height[c], a.rate_mean[c], a.rate_var[c]};
}

// G1: one CTA per chain walks all n tickets of a family whose d/z/q are
// untouched or scale uniformly.
__global__ void __launch_bounds__(kThreads) glob_scan_kernel(GlobArgs a) {
  __shared__ float red[5][kWarps];
  const int c = blockIdx.x;
  const ModelArgs m = model_of(a);
  float* h = a.heights + (size_t)c * a.N;
  float* r = a.rates + (size_t)c * a.N;
  float* te = a.terms + (size_t)c * a.T;
  float* d = a.d + (size_t)c * a.D;
  float* z = a.use_lik ? a.z + (size_t)c * a.D : nullptr;
  float* hn = a.h_new ? a.h_new + (size_t)c * a.N : nullptr;
  float* rn = a.r_new ? a.r_new + (size_t)c * a.N : nullptr;
  float* tn = a.t_new + (size_t)c * a.T;
  const bool uniform = a.family == RATE_MEAN || a.family == HEIGHT;
  const bool nodes = (a.fields & (F_HEIGHTS | F_RATES)) != 0;
  for (int s = 0; s < a.n; ++s) {
    const size_t cs = (size_t)c * a.n + s;
    // Everything the decision reads is read before the first write-back
    // below (which follows block_sums' barrier).
    const Scalars cur = scalars_of(a, c);
    const float d0 = d[0];
    const float q0 = a.use_lik ? a.q[c] : 0.f;
    const float logu_acc = logf(a.u_acc[cs]);
    const Ticket k = propose(a, cs, s, h, r, cur, 0.f);
    if (nodes) {
      write_proposed(a, k, h, r, hn, rn);
      __syncthreads();
    }
    const float* hp = (a.fields & F_HEIGHTS) ? hn : h;
    const float* rp = (a.fields & F_RATES) ? rn : r;
    float part[4] = {0.f, 0.f, 0.f, 0.f};
    bool bad = false;
    eval_blocks(a, m, k, hp, rp, te, tn, part, bad);
    float sums[5] = {part[0], part[1], part[2], part[3], 0.f};
    if (uniform && a.use_lik) {
      for (int j = threadIdx.x; j < a.D; j += kThreads) sums[4] += a.mu[j] * z[j];
    }
    block_sums<5>(sums, red, bad);
    const float tot[4] = {sums[0], sums[1], sums[2], sums[3]};
    float dq = 0.f, lj = 0.f;
    const float um1 = k.u - 1.0f;
    if (uniform) {
      // uniform_scale_lik: d' = u d, z' = u z + (u-1) P mu.
      if (a.use_lik)
        dq = ((k.u * k.u - 1.0f) * q0 + ((2.0f * k.u) * um1) * sums[4]) + (um1 * um1) * a.mPm;
      if (a.rj[s]) lj = logf(d0) - logf(k.u * d0);
    }
    float la = ((prior_delta(a.blocks, tot) - 0.5f * dq) + k.lmhg) + lj;
    if (bad || isnan(la)) la = -INFINITY;
    const bool acc = logu_acc < la;
    if (acc) {
      store_blocks(a, m, tn, te);
      if (nodes) store_nodes(a, hn, rn, h, r);
      if (uniform) {
        for (int j = threadIdx.x; j < a.D; j += kThreads) {
          d[j] = k.u * d[j];
          if (a.use_lik) z[j] = k.u * z[j] + um1 * a.pmu[j];
        }
      }
    }
    if (threadIdx.x == 0) {
      if (acc) {
        store_scalars(a, c, k.s);
        if (uniform && a.use_lik) a.q[c] = q0 + dq;
        a.acc[(size_t)c * a.P + a.rows[s]] += 1;
      }
      a.accept[cs] = acc;
      a.prop[cs] = k.prop;
    }
    __syncthreads();
  }
}

// G2: ticket s of a dense family, one CTA per chain.
__global__ void __launch_bounds__(kThreads) glob_dense_prologue_kernel(GlobArgs a) {
  __shared__ float red[4][kWarps];
  const int c = blockIdx.x;
  const int s = a.s;
  const size_t cs = (size_t)c * a.n + s;
  const ModelArgs m = model_of(a);
  const float* h = a.heights + (size_t)c * a.N;
  const float* r = a.rates + (size_t)c * a.N;
  const float* te = a.terms + (size_t)c * a.T;
  const float* d = a.d + (size_t)c * a.D;
  float* hn = a.h_new ? a.h_new + (size_t)c * a.N : nullptr;
  float* rn = a.r_new ? a.r_new + (size_t)c * a.N : nullptr;
  float* tn = a.t_new + (size_t)c * a.T;
  float* dn = a.d_new + (size_t)c * a.D;
  float* dl = a.delta + (size_t)c * a.D;
  float mean = 0.f;
  if (a.family == VAR_TREE) {
    float v[1] = {0.f};
    for (int j = threadIdx.x; j < a.N; j += kThreads)
      if (a.parent[j] >= 0) v[0] += r[j];
    bool none = false;
    block_sums<1>(v, red, none);
    mean = v[0] / (float)(a.N - 1);
  }
  const Ticket k = propose(a, cs, s, h, r, scalars_of(a, c), mean);
  bool nonpos = write_proposed(a, k, h, r, hn, rn);
  if (threadIdx.x == 0) {
    float* sn = a.s_new + (size_t)c * 5;
    sn[0] = k.s.birth;
    sn[1] = k.s.death;
    sn[2] = k.s.height;
    sn[3] = k.s.rate_mean;
    sn[4] = k.s.rate_var;
  }
  nonpos = __syncthreads_or(nonpos) != 0;
  const float* hp = (a.fields & F_HEIGHTS) ? hn : h;
  const float* rp = (a.fields & F_RATES) ? rn : r;
  float part[4] = {0.f, 0.f, 0.f, 0.f};
  bool bad = false;
  eval_blocks(a, m, k, hp, rp, te, tn, part, bad);
  // distances_internal of the proposed state: (h_p - h) r, the root's
  // second child's branch added to entry 0, times height * rate_mean.
  const float scale = k.s.height * k.s.rate_mean;
  float dn0 = 0.f;
  for (int j = threadIdx.x; j < a.D; j += kThreads) {
    const float x = distance_row(a.parent, a.dist_idx, a.root_right, hp, rp, scale, j);
    dn[j] = x;
    dl[j] = x - d[j];
    if (j == 0) dn0 = x;
  }
  block_sums<4>(part, red, bad);
  if (threadIdx.x == 0) {
    const bool var = a.family == VAR_TREE || a.family == VAR_AUTO;
    a.lmhg[c] = (var && nonpos) ? -INFINITY : k.lmhg;
    a.lj[c] = a.rj[s] ? logf(d[0]) - logf(dn0) : 0.f;
    a.d_pr[c] = prior_delta(a.blocks, part);
    a.invalid[c] = bad;
    a.prop[c] = k.prop;
    a.mean[c] = mean;
  }
}

// G3: the decision and write-back of ticket s of a dense family.
__global__ void __launch_bounds__(kThreads) glob_dense_epilogue_kernel(GlobArgs a) {
  __shared__ float red[1][kWarps];
  const int c = blockIdx.x;
  const int s = a.s;
  const ModelArgs m = model_of(a);
  float* h = a.heights + (size_t)c * a.N;
  float* r = a.rates + (size_t)c * a.N;
  float* te = a.terms + (size_t)c * a.T;
  float* d = a.d + (size_t)c * a.D;
  float* z = a.use_lik ? a.z + (size_t)c * a.D : nullptr;
  const float* w = a.use_lik ? a.w + (size_t)c * a.D : nullptr;
  const float* hn = a.h_new ? a.h_new + (size_t)c * a.N : nullptr;
  const float* rn = a.r_new ? a.r_new + (size_t)c * a.N : nullptr;
  const float* tn = a.t_new + (size_t)c * a.T;
  const float* dn = a.d_new + (size_t)c * a.D;
  const float* dl = a.delta + (size_t)c * a.D;
  const float q0 = a.q[c];
  const float logu_acc = logf(a.u_acc[(size_t)c * a.n + s]);
  float v[1] = {0.f};
  if (a.use_lik) {
    for (int j = threadIdx.x; j < a.D; j += kThreads) v[0] += dl[j] * (2.0f * z[j] + w[j]);
  }
  bool none = false;
  block_sums<1>(v, red, none);
  const float dq = v[0];
  float la = ((a.d_pr[c] - 0.5f * dq) + a.lmhg[c]) + a.lj[c];
  if (a.invalid[c] || isnan(la)) la = -INFINITY;
  const bool acc = logu_acc < la;
  if (acc) {
    store_blocks(a, m, tn, te);
    store_nodes(a, hn, rn, h, r);
    for (int j = threadIdx.x; j < a.D; j += kThreads) {
      d[j] = dn[j];
      if (a.use_lik) z[j] = z[j] + w[j];
    }
  }
  if (threadIdx.x == 0) {
    if (acc) {
      const float* sn = a.s_new + (size_t)c * 5;
      store_scalars(a, c, Scalars{sn[0], sn[1], sn[2], sn[3], sn[4]});
      if (a.use_lik) a.q[c] = q0 + dq;
      a.acc[(size_t)c * a.P + a.rows[s]] += 1;
    }
    a.accept[c] = acc;
  }
}

}  // namespace

// The entry points take the arguments as a plain pointer: a parameter of a
// type with internal linkage would keep them from being exported.
extern "C" int mcmcdate_glob_args_size() { return (int)sizeof(GlobArgs); }

extern "C" int mcmcdate_glob_scan_f32(const void* args, void* stream) {
  const GlobArgs& a = *static_cast<const GlobArgs*>(args);
  if (a.C > 0 && a.n > 0) glob_scan_kernel<<<a.C, kThreads, 0, (cudaStream_t)stream>>>(a);
  return (int)cudaGetLastError();
}

extern "C" int mcmcdate_glob_dense_prologue_f32(const void* args, void* stream) {
  const GlobArgs& a = *static_cast<const GlobArgs*>(args);
  if (a.C > 0) glob_dense_prologue_kernel<<<a.C, kThreads, 0, (cudaStream_t)stream>>>(a);
  return (int)cudaGetLastError();
}

extern "C" int mcmcdate_glob_dense_epilogue_f32(const void* args, void* stream) {
  const GlobArgs& a = *static_cast<const GlobArgs*>(args);
  if (a.C > 0) glob_dense_epilogue_kernel<<<a.C, kThreads, 0, (cudaStream_t)stream>>>(a);
  return (int)cudaGetLastError();
}
