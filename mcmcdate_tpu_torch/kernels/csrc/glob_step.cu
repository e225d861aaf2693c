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
// G1 and G3 decide with log alpha = beta_prior d_pr - (beta dq) / 2 + lmhg
// + lj, beta and beta_prior the chain's likelihood and prior temperatures
// (the JAX step's fast_sweep.py:1194-1195).
//
// G1 glob_scan_kernel: the eight families whose distances are untouched
// (bd_scale, rate_var, hm_contra, norm_contra, normh_contra, sub_contra) or
// scale uniformly (rate_mean, height: d' = u d, z' = u z + (u-1) P mu, dq in
// closed form from mu'z), one launch for the whole family.  The chain stays
// on chip for the whole family: its arrays (heights, the old and the new
// terms of the family's blocks, rates, d and z) live in shared memory as
// far as a budget allows (the rest in place in global memory: at large N
// the same kernel reads everything from there), each entry owned by one
// thread (entry j by thread j mod 128).  Every ticket forms its proposal
// from the injected draw (every thread alike), evaluates the owned entries
// the family can change from views of the proposed state (a node's
// proposed height or rate is a function of its old one: no scratch copy,
// no barrier), reduces new - old under sum_valid's NaN rule with one
// barrier, decides in every thread alike and, on accept, lets each thread
// move its own entries; sub_contra, whose proposal reads other nodes'
// heights, adds a barrier after an accept.  State and terms go back to
// global memory once, at the family's end.  sub_contra evaluates only its
// subtree's pre-order range [lo, hi) of the birth-death and clock blocks;
// the chain's count of NaN or -inf entries in those blocks, taken once at
// the start, keeps the invalid rule of the whole new blocks exact.
// G2 glob_dense_prologue_kernel (one ticket of var_tree, var_auto,
// rates_time, slide_root, sub_ultra or sub_rate): the proposal, the
// proposed state, its term blocks, d_new = distances_internal of it and
// delta = d_new - d, lmhg, the root-branch Jacobian lj, d_pr and the
// invalid flag, read from views of the proposed state as in G1 with one
// reduction barrier (var_tree: two, its rate mean first).  A subtree
// ticket (sub_ultra, sub_rate) evaluates its terms and distances only on
// its subtree's nodes and support rows (the rows of its branches, row 0
// where it hangs from the root), copies d and zeroes delta elsewhere, and
// also writes delta_S, delta on the support rows in order, for the product
// delta_S @ P[S]; its invalid rule takes the count of bad entries of the
// family's blocks that the family's first G2 launch takes and G3 keeps.
// G3 glob_dense_epilogue_kernel: dq = sum delta (2z + w) (a subtree
// ticket's over its support rows only), the decision, and the write-back
// of state, terms (a subtree ticket's range), d (its support rows), z, q
// and the accept count.
//
// What bounds them on the H100: the term blocks' special functions (the
// birth-death block in double: two D/E evaluations per node), a few floats
// per node and chain in and out, and the serial walk over a family's
// tickets.  G1, G2 and G3 run 128 threads a CTA with at most 64 registers a
// thread, so that 8 CTAs fit an SM and 1,024 chains one wave.  Built with
// -fmad=false: the proposed state and its terms are bitwise the plain
// step's (which evaluates its terms with K1), given the same proposal;
// CUDA's normal CDF and its inverse may move a truncated-normal proposal
// in its last bits, so the checks on the card replay the kernels'
// proposals.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "glob_moves.cuh"
#include "lane_groups.cuh"
#include "prior_terms.cuh"

namespace {

using namespace mcmcdate;

enum Block { B_SC = 1, B_BD = 2, B_CK = 4, B_ND = 8 };
constexpr int kThreads = 128;  // G1, G2
constexpr int kWarps = kThreads / 32;
constexpr int kMinBlocks = 8;
// G3: 128 threads a CTA, at most 64 registers a thread (8 CTAs an SM: 1,024
// chains in one wave); up to 14 write-back segments, kEpiUnroll entries a
// thread in flight.
constexpr int kEpiThreads = 128;
constexpr int kEpiWarps = kEpiThreads / 32;
constexpr int kEpiMinBlocks = 8;
constexpr int kEpiSegs = 16;
constexpr int kEpiUnroll = 8;
constexpr int kEpiLong = 4 * kEpiThreads;

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
  const int* srow;  // [n, 2] a subtree ticket's first support row, then the rest's first
  // per chain and ticket [C, n]
  const float* tun;
  const float* draw;
  const float* u_acc;
  // outputs: G1 accept and prop [C, n]; G2 prop and mean [C]; G3 accept [C]
  unsigned char* accept;
  float* prop;
  float* mean;
  // the proposed ticket (G1: new terms not in shared memory; G2 -> G3)
  float* h_new;  // [C, N]
  float* r_new;  // [C, N]
  float* s_new;  // [C, 5] birth, death, height, rate_mean, rate_var
  float* t_new;  // [C, T] (the family's blocks)
  float* d_new;  // [C, D]
  float* delta;  // [C, D]
  float* delta_s;  // [C, hi - lo] delta on a subtree ticket's support rows
  float* lmhg;   // [C]
  float* lj;     // [C]
  float* d_pr;   // [C]
  unsigned char* invalid;  // [C]
  int* nbad;     // [C] NaN or -inf old entries of a subtree family's bd and ck blocks
  const float* w;          // [C, D] delta @ P (G3, use_lik)
  const float* beta;       // [C] likelihood temperature (G1, G3)
  const float* beta_prior; // [C] prior temperature (G1, G3)
  const float* u_bold;     // [C, n] G1 sub_contra's bold mixture uniforms (null: off)
  // ints
  int N, C, T, D, P, n, s, family, blocks, fields, use_lik, clock_model;
  int n_cal, n_con, n_br, br_width, n_root_ch, root_right, n_inner_total;
  int sc_birth, sc_death, sc_bd, sc_bdc;
  int smem_budget;  // G1: bytes of shared memory a CTA may take for the chain
  int count_bad;    // G2: take nbad from the blocks (a family's first ticket)
  // floats
  float mean_root_height, rho, mPm;
  float bold_p, bold_factor;  // the bold mixture (with u_bold)
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

// Ticket s of the family, for chain c (cs = c n + s).  With the bold mixture
// (G1's sub_contra, a non-null u_bold: the JAX _glob_step's fast_sweep.py:
// 1123-1134), a ticket whose uniform is below bold_p takes a bold_factor
// times wider kernel, the same tuning forward and reverse.
__device__ __forceinline__ Ticket propose(const GlobArgs& a, size_t cs, int s, const float* h,
                                          const float* r, const Scalars& cur, float mean) {
  float tune = a.tun[cs];
  if (a.u_bold != nullptr && a.family == SUB_CONTRA && a.u_bold[cs] < a.bold_p)
    tune = tune * a.bold_factor;
  const GlobDraw t{a.family, a.sd[s], tune,       a.draw[cs], a.aux[s],
                   a.lo[s],  a.hi[s], a.n_inner[s], a.n_nodes[s]};
  return mcmcdate::propose(gmodel_of(a), t, h, r, cur, mean);
}

// The proposed state's heights and rates, node by node from the old ones.
struct NewHeights {
  const GlobModel* g;
  int family;
  const Ticket* k;
  const float* h;
  __device__ __forceinline__ float operator[](int j) const {
    return new_height(*g, family, *k, h, j);
  }
};

struct NewRates {
  const GlobModel* g;
  int family;
  const Ticket* k;
  const float* h;
  const float* r;
  __device__ __forceinline__ float operator[](int j) const {
    return new_rate(*g, family, *k, h, r, j);
  }
};

// The first entry in [lo, ...) that this thread owns (entry j: thread j mod
// kThreads).
__device__ __forceinline__ int first_owned(int lo) {
  int j = lo - lo % kThreads + (int)threadIdx.x;
  return j < lo ? j + kThreads : j;
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

__device__ __forceinline__ Scalars scalars_of(const GlobArgs& a, int c) {
  return Scalars{a.birth[c], a.death[c], a.height[c], a.rate_mean[c], a.rate_var[c]};
}

__host__ __device__ __forceinline__ bool is_subtree(int family) {
  return family == SUB_CONTRA || family == SUB_ULTRA || family == SUB_RATE;
}

// ---------------------------------------------------------------------------
// G1's chain arrays, in the order they claim shared memory.
// ---------------------------------------------------------------------------

enum Array { A_H, A_TBD, A_TCK, A_NBD, A_NCK, A_TND, A_NND, A_R, A_D, A_Z, kArrays };
// The arrays that hold state (loaded at the start); the new-term arrays are
// scratch.
constexpr int kStateArrays = ~((1 << A_NBD) | (1 << A_NCK) | (1 << A_NND));

__host__ __device__ __forceinline__ int array_len(const GlobArgs& a, int i) {
  switch (i) {
    case A_H:
    case A_R:
      return a.N;
    case A_TBD:
    case A_TCK:
    case A_NBD:
    case A_NCK:
      return a.N + 1;
    case A_TND:
    case A_NND:
      return a.n_cal + a.n_con + a.n_br;
    default:  // A_D, A_Z
      return a.D;
  }
}

__host__ __device__ __forceinline__ bool uniform_family(int family) {
  return family == RATE_MEAN || family == HEIGHT;
}

// The arrays family a.family reads.
__host__ __device__ __forceinline__ int needed_arrays(const GlobArgs& a) {
  const int nn = a.n_cal + a.n_con + a.n_br;
  const bool nd = (a.blocks & B_ND) && nn > 0;
  int need = 0;
  if ((a.blocks & (B_BD | B_CK)) || nd || a.family == SUB_CONTRA) need |= 1 << A_H;
  if (a.blocks & B_BD) need |= (1 << A_TBD) | (1 << A_NBD);
  if (a.blocks & B_CK) need |= (1 << A_TCK) | (1 << A_NCK) | (1 << A_R);
  if (a.fields & F_RATES) need |= 1 << A_R;
  if (nd) need |= (1 << A_TND) | (1 << A_NND);
  if (uniform_family(a.family)) {
    need |= 1 << A_D;
    if (a.use_lik) need |= 1 << A_Z;
  }
  return need;
}

// Which needed arrays go to shared memory: in Array order, each that still
// fits the budget.
__host__ __device__ __forceinline__ int smem_arrays(const GlobArgs& a) {
  const int need = needed_arrays(a);
  int mask = 0, left = a.smem_budget;
  for (int i = 0; i < kArrays; ++i) {
    const int bytes = array_len(a, i) * (int)sizeof(float);
    if ((need >> i & 1) && bytes <= left) {
      mask |= 1 << i;
      left -= bytes;
    }
  }
  return mask;
}

__host__ __device__ __forceinline__ int smem_bytes(const GlobArgs& a, int mask) {
  int bytes = 0;
  for (int i = 0; i < kArrays; ++i)
    if (mask >> i & 1) bytes += array_len(a, i) * (int)sizeof(float);
  return bytes;
}

// Chain c's row of array i in global memory (the new terms: its t_new row).
__device__ __forceinline__ float* global_row(const GlobArgs& a, int c, int i) {
  const size_t cT = (size_t)c * a.T;
  const int o_ck = 4 + a.N + 1, o_nd = 4 + 2 * (a.N + 1);
  switch (i) {
    case A_H:
      return a.heights + (size_t)c * a.N;
    case A_R:
      return a.rates + (size_t)c * a.N;
    case A_TBD:
      return a.terms + cT + 4;
    case A_TCK:
      return a.terms + cT + o_ck;
    case A_TND:
      return a.terms + cT + o_nd;
    case A_NBD:
      return a.t_new + cT + 4;
    case A_NCK:
      return a.t_new + cT + o_ck;
    case A_NND:
      return a.t_new + cT + o_nd;
    case A_D:
      return a.d + (size_t)c * a.D;
    default:  // A_Z
      return a.z ? a.z + (size_t)c * a.D : nullptr;
  }
}

// G1: one CTA per chain walks all n tickets of a family whose d/z/q are
// untouched or scale uniformly.
__global__ void __launch_bounds__(kThreads, kMinBlocks) glob_scan_kernel(GlobArgs a) {
  extern __shared__ float smem[];
  __shared__ float* base[kArrays];
  __shared__ float red[3][5][kWarps];
  const int c = blockIdx.x;
  const int tid = threadIdx.x;
  const ModelArgs m = model_of(a);
  const GlobModel g = gmodel_of(a);
  const int N = a.N, nn = n_node_terms(m);
  const bool uniform = uniform_family(a.family);
  const bool lik = uniform && a.use_lik;
  const bool sub = a.family == SUB_CONTRA;
  const float beta = a.beta[c];  // the chain's likelihood temperature
  const float bprior = a.beta_prior[c];  // and its prior temperature
  const int need = needed_arrays(a);
  const int mask = smem_arrays(a);
  if (tid == 0) {
    float* sp = smem;
    for (int i = 0; i < kArrays; ++i) {
      base[i] = nullptr;
      if (mask >> i & 1) {
        base[i] = sp;
        sp += array_len(a, i);
      } else if (need >> i & 1) {
        base[i] = global_row(a, c, i);
      }
    }
  }
  __syncthreads();
  for (int i = 0; i < kArrays; ++i) {
    if (!((mask & kStateArrays) >> i & 1)) continue;
    const float* src = global_row(a, c, i);
    float* dst = base[i];
    for (int j = tid; j < array_len(a, i); j += kThreads) dst[j] = src[j];
  }
  __syncthreads();
  float* const h = base[A_H];
  float* const r = base[A_R];
  float* const tbd = base[A_TBD];
  float* const tck = base[A_TCK];
  float* const tnd = base[A_TND];
  // The count of bad old entries of sub_contra's birth-death and clock
  // blocks (its node-prior block is evaluated whole).
  float nbad = 0.f;
  if (sub) {
    float v[1] = {0.f};
    for (int j = tid; j <= N; j += kThreads) {
      if (a.blocks & B_BD) v[0] += is_bad(tbd[j]) ? 1.f : 0.f;
      if (a.blocks & B_CK) v[0] += is_bad(tck[j]) ? 1.f : 0.f;
    }
    bool none = false;
    block_sums<1>(v, red[2], none);
    nbad = v[0];
  }
  float sc_old[4] = {0.f, 0.f, 0.f, 0.f};
  if (a.blocks & B_SC)
    for (int t = 0; t < 4; ++t) sc_old[t] = a.terms[(size_t)c * a.T + t];
  Scalars cur = scalars_of(a, c);
  float q0 = lik ? a.q[c] : 0.f;
  float d0 = uniform ? a.d[(size_t)c * a.D] : 0.f;
  const bool reduce = (a.blocks & (B_BD | B_CK)) || ((a.blocks & B_ND) && nn > 0) || lik;
  bool any = false;
  for (int s = 0; s < a.n; ++s) {
    const size_t cs = (size_t)c * a.n + s;
    const Ticket k = propose(a, cs, s, h, r, cur, 0.f);
    const NewHeights hp{&g, a.family, &k, h};
    const NewRates rp{&g, a.family, &k, h, r};
    // The birth-death and clock entries the ticket can change.
    const int lo = sub ? k.lo : 0, hi = sub ? k.hi : N + 1;
    bool bad = false;
    float sc_new[4] = {0.f, 0.f, 0.f, 0.f};
    float sc_sum = 0.f;
    if (a.blocks & B_SC) {
      for (int t = 0; t < 4; ++t) {
        const float x = scalar_term(m, t, k.s.birth, k.s.death, k.s.rate_mean, k.s.rate_var);
        sc_new[t] = x;
        const float diff = x - sc_old[t];
        if (!isnan(diff)) sc_sum += diff;
        bad = bad || is_bad(x);
      }
    }
    // bd, ck, nd sums of new - old, mu'z, bad old entries in [lo, hi).
    float v[5] = {0.f, 0.f, 0.f, 0.f, 0.f};
    if (a.blocks & B_BD) {
      float* tn = base[A_NBD];
      for (int j = first_owned(lo); j < hi; j += kThreads) {
        const float x = bd_block_term(m, hp, j, k.s.birth, k.s.death);
        const float o = tbd[j];
        tn[j] = x;
        const float diff = x - o;
        if (!isnan(diff)) v[0] += diff;
        bad = bad || is_bad(x);
        if (is_bad(o)) v[4] += 1.f;
      }
    }
    if (a.blocks & B_CK) {
      float* tn = base[A_NCK];
      for (int j = first_owned(lo); j < hi; j += kThreads) {
        const float x = clock_block_term(m, hp, rp, j, k.s.rate_var);
        const float o = tck[j];
        tn[j] = x;
        const float diff = x - o;
        if (!isnan(diff)) v[1] += diff;
        bad = bad || is_bad(x);
        if (is_bad(o)) v[4] += 1.f;
      }
    }
    if ((a.blocks & B_ND) && nn > 0) {
      float* tn = base[A_NND];
      for (int j = tid; j < nn; j += kThreads) {
        const float x = node_term(m, hp, j, k.s.height);
        tn[j] = x;
        const float diff = x - tnd[j];
        if (!isnan(diff)) v[2] += diff;
        bad = bad || is_bad(x);
      }
    }
    if (lik) {
      const float* z = base[A_Z];
      for (int j = tid; j < a.D; j += kThreads) v[3] += a.mu[j] * z[j];
    }
    if (reduce) block_sums<5>(v, red[s & 1], bad);
    float dq = 0.f, lj = 0.f;
    const float um1 = k.u - 1.0f;
    if (uniform) {
      // uniform_scale_lik: d' = u d, z' = u z + (u-1) P mu.
      if (a.use_lik)
        dq = ((k.u * k.u - 1.0f) * q0 + ((2.0f * k.u) * um1) * v[3]) + (um1 * um1) * a.mPm;
      if (a.rj[s]) lj = logf(d0) - logf(k.u * d0);
    }
    const float part[4] = {sc_sum, v[0], v[1], v[2]};
    float la = ((__fmul_rn(bprior, prior_delta(a.blocks, part)) - 0.5f * (beta * dq)) + k.lmhg)
               + lj;
    // A bad entry outside [lo, hi) stays in the new blocks.
    if (bad || (sub && nbad > v[4]) || isnan(la)) la = -INFINITY;
    const bool acc = logf(a.u_acc[cs]) < la;
    if (acc) {
      any = true;
      cur = k.s;
      for (int t = 0; t < 4; ++t) sc_old[t] = sc_new[t];
      if (a.blocks & B_BD) {
        const float* tn = base[A_NBD];
        for (int j = first_owned(lo); j < hi; j += kThreads) tbd[j] = tn[j];
      }
      if (a.blocks & B_CK) {
        const float* tn = base[A_NCK];
        for (int j = first_owned(lo); j < hi; j += kThreads) tck[j] = tn[j];
      }
      if ((a.blocks & B_ND) && nn > 0) {
        const float* tn = base[A_NND];
        for (int j = tid; j < nn; j += kThreads) tnd[j] = tn[j];
      }
      // A node's new values read only its own old ones (rates first:
      // nothing here reads a new height).
      const int nlo = sub ? k.lo : 0, nhi = sub ? k.hi : N;
      if (a.fields & F_RATES)
        for (int j = first_owned(nlo); j < nhi; j += kThreads) r[j] = rp[j];
      if (a.fields & F_HEIGHTS)
        for (int j = first_owned(nlo); j < nhi; j += kThreads) h[j] = hp[j];
      if (uniform) {
        float* d = base[A_D];
        float* z = base[A_Z];
        for (int j = tid; j < a.D; j += kThreads) {
          d[j] = k.u * d[j];
          if (lik) z[j] = k.u * z[j] + um1 * a.pmu[j];
        }
        d0 = k.u * d0;
        q0 = q0 + dq;
      }
      nbad = 0.f;
    }
    if (tid == 0) {
      if (acc) a.acc[(size_t)c * a.P + a.rows[s]] += 1;
      a.accept[cs] = acc;
      a.prop[cs] = k.prop;
    }
    // The next proposal reads other nodes' heights.
    if (acc && (a.fields & F_HEIGHTS)) __syncthreads();
  }
  if (!any) return;
  // Write back what the family changed and shared memory held; each thread
  // its own entries.
  int out = 0;
  if (a.fields & F_HEIGHTS) out |= 1 << A_H;
  if (a.fields & F_RATES) out |= 1 << A_R;
  out |= need & ((1 << A_TBD) | (1 << A_TCK) | (1 << A_TND) | (1 << A_D) | (1 << A_Z));
  for (int i = 0; i < kArrays; ++i) {
    if (!((mask & out) >> i & 1)) continue;
    float* dst = global_row(a, c, i);
    const float* src = base[i];
    for (int j = tid; j < array_len(a, i); j += kThreads) dst[j] = src[j];
  }
  if (tid == 0) {
    store_scalars(a, c, cur);
    if (a.blocks & B_SC)
      for (int t = 0; t < 4; ++t) a.terms[(size_t)c * a.T + t] = sc_old[t];
    if (lik) a.q[c] = q0;
  }
}

// G2: ticket s of a dense family, one CTA per chain.
__global__ void __launch_bounds__(kThreads, kMinBlocks) glob_dense_prologue_kernel(GlobArgs a) {
  __shared__ float red[2][7][kWarps];
  const int c = blockIdx.x;
  const int s = a.s;
  const int tid = threadIdx.x;
  const size_t cs = (size_t)c * a.n + s;
  const ModelArgs m = model_of(a);
  const GlobModel g = gmodel_of(a);
  const int N = a.N;
  const float* h = a.heights + (size_t)c * N;
  const float* r = a.rates + (size_t)c * N;
  const float* te = a.terms + (size_t)c * a.T;
  const float* d = a.d + (size_t)c * a.D;
  float* hn = a.h_new ? a.h_new + (size_t)c * N : nullptr;
  float* rn = a.r_new ? a.r_new + (size_t)c * N : nullptr;
  float* tn = a.t_new + (size_t)c * a.T;
  float* dn = a.d_new + (size_t)c * a.D;
  float* dl = a.delta + (size_t)c * a.D;
  const bool sub = is_subtree(a.family);
  float mean = 0.f;
  if (a.family == VAR_TREE) {
    float v[1] = {0.f};
    for (int j = tid; j < N; j += kThreads)
      if (a.parent[j] >= 0) v[0] += r[j];
    bool none = false;
    block_sums<1>(v, red[1], none);
    mean = v[0] / (float)(N - 1);
  }
  const Ticket k = propose(a, cs, s, h, r, scalars_of(a, c), mean);
  const NewHeights hp{&g, a.family, &k, h};
  const NewRates rp{&g, a.family, &k, h, r};
  // The nodes the ticket moves, and the birth-death and clock entries it
  // can change.
  const int nlo = sub ? k.lo : 0, nhi = sub ? k.hi : N;
  const int bhi = sub ? k.hi : N + 1;
  // sc, bd, ck, nd sums of new - old, bad old entries in [nlo, bhi),
  // non-positive non-root rates, bad old entries of the bd and ck blocks.
  float v[7] = {0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f};
  bool bad = false;
  for (int j = first_owned(nlo); j < nhi; j += kThreads) {
    if (a.fields & F_HEIGHTS) hn[j] = hp[j];
    if (a.fields & F_RATES) {
      const float x = rp[j];
      rn[j] = x;
      if (a.parent[j] >= 0 && !(x > 0.f)) v[5] = 1.f;
    }
  }
  auto put = [&](int b, int idx, float x, bool ranged) {
    tn[idx] = x;
    const float o = te[idx];
    const float diff = x - o;
    if (!isnan(diff)) v[b] += diff;
    bad = bad || is_bad(x);
    if (ranged && is_bad(o)) v[4] += 1.f;
  };
  if (a.blocks & B_SC) {
    for (int t = tid; t < 4; t += kThreads)
      put(0, t, scalar_term(m, t, k.s.birth, k.s.death, k.s.rate_mean, k.s.rate_var), false);
  }
  if (a.blocks & B_BD) {
    for (int j = first_owned(nlo); j < bhi; j += kThreads)
      put(1, 4 + j, bd_block_term(m, hp, j, k.s.birth, k.s.death), sub);
  }
  if (a.blocks & B_CK) {
    const int o = off_ck(m);
    for (int j = first_owned(nlo); j < bhi; j += kThreads)
      put(2, o + j, clock_block_term(m, hp, rp, j, k.s.rate_var), sub);
  }
  if (a.blocks & B_ND) {
    const int o = off_nd(m), nn = n_node_terms(m);
    for (int j = tid; j < nn; j += kThreads) put(3, o + j, node_term(m, hp, j, k.s.height), false);
  }
  if (sub && a.count_bad) {
    for (int j = tid; j <= N; j += kThreads) {
      if ((a.blocks & B_BD) && is_bad(te[4 + j])) v[6] += 1.f;
      if ((a.blocks & B_CK) && is_bad(te[off_ck(m) + j])) v[6] += 1.f;
    }
  }
  // distances_internal of the proposed state on the rows the ticket moves:
  // (h_p - h) r, the root's second child's branch added to row 0, times
  // height * rate_mean.  A subtree ticket's rows are its nodes' branches
  // (row 0 stands for the root child it hangs from); delta_S takes them in
  // node order, which is row order.
  const float scale = k.s.height * k.s.rate_mean;
  const int rr = a.root_right;
  float* ds = sub ? a.delta_s + (size_t)c * (k.hi - k.lo) : nullptr;
  float dn0 = 0.f;
  for (int j = tid; j < a.D; j += kThreads) {
    const float old = d[j];
    float x = old, dx = 0.f;
    int node = a.dist_idx[j];
    if (sub && j == 0 && rr >= k.lo && rr < k.hi) node = rr;
    if (!sub || (node >= k.lo && node < k.hi)) {
      x = distance_row(a.parent, a.dist_idx, rr, hp, rp, scale, j);
      dx = x - old;
      if (sub) ds[node - k.lo] = dx;
    }
    dn[j] = x;
    dl[j] = dx;
    if (j == 0) dn0 = x;
  }
  block_sums<7>(v, red[0], bad);
  if (tid == 0) {
    float* sn = a.s_new + (size_t)c * 5;
    sn[0] = k.s.birth;
    sn[1] = k.s.death;
    sn[2] = k.s.height;
    sn[3] = k.s.rate_mean;
    sn[4] = k.s.rate_var;
    const bool var = a.family == VAR_TREE || a.family == VAR_AUTO;
    a.lmhg[c] = (var && v[5] > 0.f) ? -INFINITY : k.lmhg;
    a.lj[c] = a.rj[s] ? logf(d[0]) - logf(dn0) : 0.f;
    const float part[4] = {v[0], v[1], v[2], v[3]};
    a.d_pr[c] = prior_delta(a.blocks, part);
    // A bad entry outside the subtree's range stays in the new blocks.
    bool invalid = bad;
    if (sub) {
      if (a.count_bad) a.nbad[c] = (int)v[6];
      invalid = invalid || (float)(a.count_bad ? (int)v[6] : a.nbad[c]) > v[4];
    }
    a.invalid[c] = invalid;
    a.prop[c] = k.prop;
    a.mean[c] = mean;
  }
}

// G3: the decision and write-back of ticket s of a dense family, one CTA
// per chain.
//
// The per-chain scalars are loaded first, so that their loads overlap the
// sum's.  dq = sum delta (2 z + w): a whole-distance family's over all D
// rows, in 16-byte loads where the rows' alignment allows; a subtree
// ticket's over its support rows only, from delta_S (delta is exactly 0
// elsewhere): row srow[s, 0] for its first node, then srow[s, 1] onwards
// for the others.  One warp-shuffle reduction and one cross-warp step
// give every thread the sum, and each thread decides alike.  An accepted
// chain's write-back is one list of segments (dst, src, optional add),
// built by thread 0 before the reduction's barrier: the family's scalars,
// term blocks (a subtree ticket's bd and ck range only), heights or rates
// (its range), d (a subtree ticket's support rows: elsewhere d_new is d)
// and z += w over all D.  The short segments form one flat list that each
// thread walks kEpiUnroll entries at a time, all their loads issued before
// their stores (at 136 taxa one or two rounds for the whole write-back);
// a long one (kEpiLong entries or more: z, and the whole-D arrays at 1000
// taxa) goes in 16-byte loads and stores where its rows align.
struct EpiSeg {
  float* dst;
  const float* src;
  const float* add;  // z's segment: w, added to src
  int off;           // short: the first entry in the flat list; long: the length
};

// A long segment (at least kEpiLong entries): 16-byte loads and stores
// where dst, src and add share their alignment, kEpiUnroll / 2 of them a
// thread in flight, the entries before the first 16-byte boundary and
// after the last one alone.
__device__ __forceinline__ void copy_long(const EpiSeg& g, int tid) {
  const int len = g.off;
  int h = (int)(((16 - ((uintptr_t)g.dst & 15)) & 15) >> 2);
  h = h < len ? h : len;
  const uintptr_t phase = (uintptr_t)(g.dst + h) | (uintptr_t)(g.src + h) |
                          (g.add ? (uintptr_t)(g.add + h) : (uintptr_t)0);
  if (phase & 15) h = len;  // no common alignment: entry by entry
  for (int j = tid; j < h; j += kEpiThreads) g.dst[j] = g.add ? g.src[j] + g.add[j] : g.src[j];
  const int nv = (len - h) >> 2;
  float4* d4 = reinterpret_cast<float4*>(g.dst + h);
  const float4* s4 = reinterpret_cast<const float4*>(g.src + h);
  const float4* a4 = reinterpret_cast<const float4*>(g.add + h);
  constexpr int U = kEpiUnroll / 2;
  for (int q0 = tid; q0 < nv; q0 += U * kEpiThreads) {
    float4 x[U], y[U];
#pragma unroll
    for (int u = 0; u < U; ++u) {
      const int q = q0 + u * kEpiThreads;
      if (q < nv) {
        x[u] = s4[q];
        if (g.add) y[u] = a4[q];
      }
    }
#pragma unroll
    for (int u = 0; u < U; ++u) {
      const int q = q0 + u * kEpiThreads;
      if (q >= nv) continue;
      float4 v = x[u];
      if (g.add) {
        v.x = v.x + y[u].x;
        v.y = v.y + y[u].y;
        v.z = v.z + y[u].z;
        v.w = v.w + y[u].w;
      }
      d4[q] = v;
    }
  }
  const int j = h + 4 * nv + tid;
  if (j < len) g.dst[j] = g.add ? g.src[j] + g.add[j] : g.src[j];
}

__device__ __forceinline__ float dq_term(float dl, float z, float w) {
  return dl * (2.0f * z + w);
}

// A whole-distance family's dq on this thread's rows.
__device__ __forceinline__ float dq_dense(const float* dl, const float* z, const float* w,
                                          int D, int tid) {
  float v = 0.f;
  // Entries before the first 16-byte boundary of delta's row; the three
  // rows share their layout, so one test says whether all align there.
  int j0 = (int)(((16 - ((uintptr_t)dl & 15)) & 15) >> 2);
  j0 = j0 < D ? j0 : D;
  const bool vec = ((((uintptr_t)(dl + j0)) | ((uintptr_t)(z + j0)) | ((uintptr_t)(w + j0))) &
                    15) == 0;
  if (!vec) {
#pragma unroll 4
    for (int j = tid; j < D; j += kEpiThreads) v += dq_term(dl[j], z[j], w[j]);
    return v;
  }
  if (tid < j0) v += dq_term(dl[tid], z[tid], w[tid]);
  const int nv = (D - j0) >> 2;
  const float4* dl4 = reinterpret_cast<const float4*>(dl + j0);
  const float4* z4 = reinterpret_cast<const float4*>(z + j0);
  const float4* w4 = reinterpret_cast<const float4*>(w + j0);
#pragma unroll 2
  for (int q = tid; q < nv; q += kEpiThreads) {
    const float4 x = dl4[q], zz = z4[q], ww = w4[q];
    v += dq_term(x.x, zz.x, ww.x);
    v += dq_term(x.y, zz.y, ww.y);
    v += dq_term(x.z, zz.z, ww.z);
    v += dq_term(x.w, zz.w, ww.w);
  }
  const int j = j0 + 4 * nv + tid;
  if (j < D) v += dq_term(dl[j], z[j], w[j]);
  return v;
}

__global__ void __launch_bounds__(kEpiThreads, kEpiMinBlocks)
    glob_dense_epilogue_kernel(GlobArgs a) {
  __shared__ float red[1][kEpiWarps];
  __shared__ EpiSeg seg[kEpiSegs + 1];  // short segments, then the end of their list
  __shared__ EpiSeg lseg[kEpiSegs];     // long segments
  __shared__ int n_seg, n_long;
  const int c = blockIdx.x;
  const int s = a.s;
  const int tid = threadIdx.x;
  const bool sub = is_subtree(a.family);
  float* d = a.d + (size_t)c * a.D;
  float* z = a.use_lik ? a.z + (size_t)c * a.D : nullptr;
  const float* w = a.use_lik ? a.w + (size_t)c * a.D : nullptr;
  const float* dn = a.d_new + (size_t)c * a.D;
  // The per-chain scalars, before the sum.
  const float u_acc = a.u_acc[(size_t)c * a.n + s];
  const float d_pr = a.d_pr[c];
  const float lmhg = a.lmhg[c];
  const float lj = a.lj[c];
  const bool invalid = a.invalid[c];
  const float beta = a.beta[c];  // the chain's likelihood temperature
  const float bprior = a.beta_prior[c];  // and its prior temperature
  const float q0 = a.use_lik ? a.q[c] : 0.f;
  int* acc_at = a.acc + (size_t)c * a.P + a.rows[s];
  const int acc0 = tid == 0 ? *acc_at : 0;
  // A subtree ticket's nodes [lo, hi) and support rows.
  const int lo = sub ? a.lo[s] : 0;
  const int K = sub ? a.hi[s] - lo : 0;
  const int r0 = sub ? a.srow[2 * s] : 0;
  const int r1 = sub ? a.srow[2 * s + 1] : 0;
  float v = 0.f;
  if (a.use_lik) {
    if (sub) {
      const float* ds = a.delta_s + (size_t)c * K;
      if (tid == 0 && K > 0) v = dq_term(ds[0], z[r0], w[r0]);
#pragma unroll 4
      for (int k = 1 + tid; k < K; k += kEpiThreads) {
        const int j = r1 + k - 1;
        v += dq_term(ds[k], z[j], w[j]);
      }
    } else {
      v = dq_dense(a.delta + (size_t)c * a.D, z, w, a.D, tid);
    }
  }
  if (tid == 0) {
    // The write-back's segments, in the flat list's order.
    const ModelArgs m = model_of(a);
    const int nhi = sub ? lo + K : a.N, bhi = sub ? lo + K : a.N + 1;
    int n = 0, nl = 0, off = 0;
    auto put = [&](float* dst, const float* src, const float* add, int len) {
      if (len >= kEpiLong) {
        lseg[nl++] = EpiSeg{dst, src, add, len};
      } else if (len > 0) {
        seg[n++] = EpiSeg{dst, src, add, off};
        off += len;
      }
    };
    const float* sn = a.s_new + (size_t)c * 5;
    if (a.fields & F_BIRTH) put(a.birth + c, sn + 0, nullptr, 1);
    if (a.fields & F_DEATH) put(a.death + c, sn + 1, nullptr, 1);
    if (a.fields & F_HEIGHT) put(a.height + c, sn + 2, nullptr, 1);
    if (a.fields & F_RATE_MEAN) put(a.rate_mean + c, sn + 3, nullptr, 1);
    if (a.fields & F_RATE_VAR) put(a.rate_var + c, sn + 4, nullptr, 1);
    float* te = a.terms + (size_t)c * a.T;
    const float* tn = a.t_new + (size_t)c * a.T;
    if (a.blocks & B_SC) put(te, tn, nullptr, 4);
    if (a.blocks & B_BD) put(te + 4 + lo, tn + 4 + lo, nullptr, bhi - lo);
    if (a.blocks & B_CK) put(te + off_ck(m) + lo, tn + off_ck(m) + lo, nullptr, bhi - lo);
    if (a.blocks & B_ND) put(te + off_nd(m), tn + off_nd(m), nullptr, n_node_terms(m));
    if (a.fields & F_HEIGHTS)
      put(a.heights + (size_t)c * a.N + lo, a.h_new + (size_t)c * a.N + lo, nullptr, nhi - lo);
    if (a.fields & F_RATES)
      put(a.rates + (size_t)c * a.N + lo, a.r_new + (size_t)c * a.N + lo, nullptr, nhi - lo);
    if (sub) {
      put(d + r0, dn + r0, nullptr, K > 0 ? 1 : 0);
      put(d + r1, dn + r1, nullptr, K - 1);
    } else {
      put(d, dn, nullptr, a.D);
    }
    if (a.use_lik) put(z, z, w, a.D);
    seg[n].off = off;  // the end of the list
    n_seg = n;
    n_long = nl;
  }
  bool none = false;
  float sum[1] = {v};
  block_sums<1>(sum, red, none);
  const float dq = sum[0];
  float la = ((__fmul_rn(bprior, d_pr) - 0.5f * (beta * dq)) + lmhg) + lj;
  if (invalid || isnan(la)) la = -INFINITY;
  const bool acc = logf(u_acc) < la;
  if (acc) {
    const int total = seg[n_seg].off;
    int q = 0;
    for (int base = tid; base < total; base += kEpiThreads * kEpiUnroll) {
      float x[kEpiUnroll], y[kEpiUnroll];
      float* dst[kEpiUnroll];
      bool add[kEpiUnroll];
#pragma unroll
      for (int u = 0; u < kEpiUnroll; ++u) {
        const int i = base + u * kEpiThreads;
        dst[u] = nullptr;
        if (i >= total) continue;
        while (i >= seg[q + 1].off) ++q;
        const int k = i - seg[q].off;
        const float* ad = seg[q].add;
        dst[u] = seg[q].dst + k;
        x[u] = seg[q].src[k];
        add[u] = ad != nullptr;
        y[u] = add[u] ? ad[k] : 0.f;
      }
#pragma unroll
      for (int u = 0; u < kEpiUnroll; ++u)
        if (dst[u]) *dst[u] = add[u] ? x[u] + y[u] : x[u];
    }
    for (int l = 0; l < n_long; ++l) copy_long(lseg[l], tid);
  }
  if (tid == 0) {
    if (acc) {
      if (a.use_lik) a.q[c] = q0 + dq;
      *acc_at = acc0 + 1;
      // The accepted blocks hold no bad entry.
      if (a.nbad) a.nbad[c] = 0;
    }
    a.accept[c] = acc;
  }
}

}  // namespace

// The entry points take the arguments as a plain pointer: a parameter of a
// type with internal linkage would keep them from being exported.
extern "C" int mcmcdate_glob_args_size() { return (int)sizeof(GlobArgs); }

// G1's arguments with a negative smem_budget replaced by the default: the
// shared memory that lets ceil(C / SMs) CTAs (at most kMinBlocks) share an
// SM, less the 1 KB the system keeps per CTA and the kernel's static arrays.
static GlobArgs with_budget(const GlobArgs& in) {
  GlobArgs a = in;
  if (a.smem_budget >= 0) return a;
  // The last answer, for the same device and chain count.
  static int last_dev = -1, last_C = -1, last_budget = 0;
  int dev = 0, n_sm = 1, smem_sm = 0, optin = 0;
  cudaGetDevice(&dev);
  if (dev == last_dev && a.C == last_C) {
    a.smem_budget = last_budget;
    return a;
  }
  cudaDeviceGetAttribute(&n_sm, cudaDevAttrMultiProcessorCount, dev);
  cudaDeviceGetAttribute(&smem_sm, cudaDevAttrMaxSharedMemoryPerMultiprocessor, dev);
  cudaDeviceGetAttribute(&optin, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
  cudaFuncAttributes attr;
  cudaFuncGetAttributes(&attr, glob_scan_kernel);
  int per_sm = (a.C + n_sm - 1) / n_sm;
  per_sm = per_sm < 1 ? 1 : (per_sm > kMinBlocks ? kMinBlocks : per_sm);
  const int fixed = (int)attr.sharedSizeBytes;
  const int b = smem_sm / per_sm - 1024 - fixed;
  a.smem_budget = b < optin - fixed ? b : optin - fixed;
  if (a.smem_budget < 0) a.smem_budget = 0;
  last_dev = dev;
  last_C = a.C;
  last_budget = a.smem_budget;
  return a;
}

// The bytes of shared memory G1 takes for a family (and, in *mask, which
// arrays it holds there).
extern "C" int mcmcdate_glob_scan_smem(const void* args, int* mask) {
  const GlobArgs a = with_budget(*static_cast<const GlobArgs*>(args));
  *mask = smem_arrays(a);
  return smem_bytes(a, *mask);
}

extern "C" int mcmcdate_glob_scan_f32(const void* args, void* stream) {
  const GlobArgs a = with_budget(*static_cast<const GlobArgs*>(args));
  const int bytes = smem_bytes(a, smem_arrays(a));
  if (bytes > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        glob_scan_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
    if (err != cudaSuccess) return (int)err;
  }
  if (a.C > 0 && a.n > 0)
    glob_scan_kernel<<<a.C, kThreads, bytes, (cudaStream_t)stream>>>(a);
  return (int)cudaGetLastError();
}

extern "C" int mcmcdate_glob_dense_prologue_f32(const void* args, void* stream) {
  const GlobArgs& a = *static_cast<const GlobArgs*>(args);
  if (a.C > 0) glob_dense_prologue_kernel<<<a.C, kThreads, 0, (cudaStream_t)stream>>>(a);
  return (int)cudaGetLastError();
}

extern "C" int mcmcdate_glob_dense_epilogue_f32(const void* args, void* stream) {
  const GlobArgs& a = *static_cast<const GlobArgs*>(args);
  if (a.C > 0) glob_dense_epilogue_kernel<<<a.C, kEpiThreads, 0, (cudaStream_t)stream>>>(a);
  return (int)cudaGetLastError();
}
