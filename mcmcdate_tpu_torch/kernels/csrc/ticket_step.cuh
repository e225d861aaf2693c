// The sequential sweep's ticket step as device functions: the prologue
// (kernel T1 ticket_prologue, csrc/ticket_step.cu), the likelihood deltas
// and the epilogue, all three chained ticket after ticket by T3
// ticket_scan (csrc/ticket_step.cu).  Kernel K3 accept_select
// (csrc/accept_select.cu) ends T1's tickets with the epilogue's semantics
// in a body of its own, and shares diag_lik_dev.
//
// Together they replace the XLA-compiled MHKernel._ticket_step of the JAX
// package (mcmcdate_tpu/engine/mh.py:52-210: the 17 proposal kernels _k_*
// of engine/proposals.py:388-706, the prior terms, distances, root-branch
// Jacobian, accept and select) and its scan over a sweep's tickets
// (lax.scan(step, c, perm), engine/mh.py:269-271).  One CTA per chain
// applies one ticket (a row of the proposal table) to its chain:
//
// prologue: the proposal from the injected draw (the global moves through
//   G2's propose, csrc/glob_moves.cuh; the node slides, the pulley and the
//   braced slides here), written into the carried state in place with the
//   old values kept in per-chain scratch (hs, rs, ss); the term entries
//   the row can change (whole blocks, or the row's explicit entries: O(1)
//   for a node-local ticket) through prior_terms.cuh, K1's own device
//   functions, into tn; d_pr = sum of new - old over them, NaN differences
//   counted as 0; invalid = a new entry NaN or -inf, or a bad carried entry
//   left untouched (the carried count nbad exceeds the bad old entries);
//   lmhg; lj, the root-branch Jacobian ratio; and on the row's likelihood
//   class rows the new distances dn and delta dl = dn - d.
// likelihood: under the univariate kind dy = delta inv_sd on the class
//   rows; under a full MVN for the gather class dy = delta[rows] @ L[rows,:]
//   (at most KG rows of L, read from L2 by the chain's CTA; T3 only); K2's
//   dy for the dense and range classes (T1, K2, K3); d_lik = -0.5 sum dy
//   (2 y + dy).
// epilogue: log alpha = d_pr + d_lik + lmhg + lj (NaN -> -inf), the
//   decision log u < log alpha; an accepted chain takes the new term
//   entries, d on the class rows, y + dy, its accept count and nbad = 0; a
//   rejected one gets its old heights, rates and scalars back.
//
// What bounds them on the H100: a node-local ticket is a chain of
// dependent steps (the row's parameters, the node's heights, a truncated-
// normal or gamma proposal, a few double-precision birth-death terms, two
// block reductions), so T3's run of tickets is bound by latency per
// ticket, with every chain's CTA resident at once (128 threads: 1,024
// CTAs in one wave on 132 SMs); a global ticket by its O(N) term blocks.
// The design: one launch per run of tickets instead of about 116 plain
// launches a ticket and K1's O(N) recompute; every intermediate in
// registers or in per-chain scratch rows that stay in L2.  Built with
// -fmad=false: the proposed state, its terms and distances are bitwise the
// plain version's given the same proposal (kernels/ticket_step.py; CUDA's
// normal CDF and its inverse may move a truncated-normal proposal in its
// last bits, so the checks on the card replay the kernels' proposals).

#pragma once

#include <cuda_runtime.h>
#include <math.h>

#include "async_copy.cuh"
#include "glob_moves.cuh"
#include "lane_groups.cuh"
#include "prior_terms.cuh"

namespace mcmcdate {

constexpr int kTicketThreads = 128;
constexpr int kTicketWarps = kTicketThreads / 32;
constexpr int kBraceMax = 16;  // braced nodes a brace may hold
constexpr int kTicketSums = 4;  // values a team sums at once (rows of CtaTeam's red)

// Proposal modes past G2's families (kernels/ticket_step.py).
enum TicketMode { SLIDE_ULTRA = SUB_RATE + 1, SLIDE_CONTRA, PULLEY, BRACED_ULTRA, BRACED_CONTRA };
enum TicketField { F_HLOC = 128, F_RLOC = 256 };
enum TermBlock { TB_SC = 1, TB_BD = 2, TB_CK = 4, TB_ND = 8 };
enum LikKind { LIK_NONE, LIK_DIAG, LIK_FULL };
enum DClass { DC_INV, DC_FULL, DC_GATHER, DC_B64, DC_B256, DC_B1024, DC_RANGE };

// The packed record of a table row, word for word kernels/ticket_step.py's
// REC_WORDS (TicketTable.rec): kRecWords int32 words, 512 bytes, holding
// everything a ticket of the row reads that does not depend on the chain.
// R_DN is the count of the row's likelihood class rows (R_ROW0: row 0
// first, then R_DLO on for the ranges); R_PARENT and
// R_KIDS the row's node's parent and children (-1 padding); where
// R_INLINE is 1 the lists follow from R_LIST: the node set (R_NCNT
// words), the explicit term entries (R_TCNT) and, for DC_GATHER, the KG
// gather rows; else they are read from n_idx, t_idx and didx.
constexpr int kRecWords = 128;
constexpr int kRecKids = 4;
enum RecWord {
  R_ROW, R_MODE, R_FIELDS, R_TBLOCKS, R_NODE, R_AUX, R_LO, R_HI, R_N_INNER, R_N_NODES, R_LO2,
  R_HI2, R_N2, R_SD, R_RJ, R_DCLASS, R_DLO, R_DN, R_ROW0, R_TOFF, R_TCNT, R_NOFF, R_NCNT,
  R_PARENT, R_INLINE, R_KIDS, R_LIST = R_KIDS + kRecKids
};

// Mirrored field by field by kernels/ticket_step.py's _TicketArgs:
// pointers, then ints, then floats.
struct TicketArgs {
  // the model
  const int* parent;             // [N], root -1
  const unsigned char* is_leaf;  // [N]
  const int* children;           // [N, KC], -1 padding
  const int* cal_node;
  const float* cal_lower;
  const float* cal_lower_pm;
  const float* cal_upper;
  const float* cal_upper_pm;
  const int* con_young;
  const int* con_old;
  const float* con_pm;
  const int* br_node;  // [n_br, br_width], -1 padding
  const float* br_sd;
  const int* root_ch;   // [2]
  const int* dist_idx;  // [D] node of each internal-layout distance
  const float* inv_sd;  // [D] (univariate)
  const float* L;       // [D, D] (full MVN)
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
  float* y;      // [C, D]
  int* acc;      // [C, P]
  int* nbad;     // [C] NaN or -inf terms
  const float* beta;  // [C] likelihood temperature of every decision
  const float* beta_prior;  // [C] prior temperature of every decision
  // the table
  const int* rec;    // [P, kRecWords] packed records
  const int* didx;   // [P, KG], D padding
  const int* t_idx;  // explicit term entries (CSR, offsets in the records)
  const int* n_idx;  // node sets (CSR)
  const float* tuning;  // [C, P]
  // the tickets [n] and their draws
  const int* order;     // [n] row of each ticket (null: `row`, one ticket)
  const float* draw;    // [C, n] uniforms, or every ticket's draw
  const float* gdraw;   // [C, ng] standard-gamma draws (nullable)
  const int* gidx;      // [n] column in gdraw, -1: uniform (nullable)
  const float* u_acc;   // [C, n]
  const int* lead;      // [n] 1: ticket starts a window of T3's light runs (nullable)
  // per-chain scratch
  float* hs;  // [C, N] old heights
  float* rs;  // [C, N] old rates
  float* ss;  // [C, 5] old scalars
  float* tn;  // [C, T] new terms
  float* dn;  // [C, D] new distances
  float* dl;  // [C, D] delta
  float* dys;  // [C, D] dy (univariate, gather)
  float* lmhg;  // [C] T1 -> K3
  float* lj;
  float* d_pr;
  unsigned char* invalid;
  float* sprop;  // [C] T1's proposal
  float* smean;  // [C] T1's var_tree rate mean
  const float* dy_in;    // [C, D] K2's dy (K3, full MVN)
  const float* dlik_in;  // [C] K2's d_lik
  // optional outputs: K3 [C]; T3 [C, n]
  unsigned char* accept_out;
  float* prop_out;
  float* mean_out;
  float* la_out;
  // ints
  int N, C, T, D, P, n, ng, j0, nj, row, KC, KG, lik, clock_model;
  int n_cal, n_con, n_br, br_width, root_right, n_inner_total;
  int sc_birth, sc_death, sc_bd, sc_bdc;
  // floats
  float mean_root_height, rho;
};

__device__ __forceinline__ ModelArgs ticket_model(const TicketArgs& a) {
  return ModelArgs{a.parent,    a.is_leaf,      a.N,       a.clock_model, a.mean_root_height,
                   a.rho,       a.cal_node,     a.cal_lower, a.cal_lower_pm, a.cal_upper,
                   a.cal_upper_pm, a.n_cal,     a.con_young, a.con_old,   a.con_pm,
                   a.n_con,     a.br_node,      a.br_sd,   a.n_br,        a.br_width};
}

__device__ __forceinline__ GlobModel ticket_gmodel(const TicketArgs& a) {
  return GlobModel{a.parent, a.is_leaf, a.root_ch, a.N, 2, a.n_inner_total,
                   a.sc_birth, a.sc_death, a.sc_bd, a.sc_bdc};
}

// A ticket's row as its record gives it (in shared memory in T3's light
// runs, in global memory elsewhere).
struct Row {
  const int* w;
  __device__ __forceinline__ int operator[](int k) const { return w[k]; }
  __device__ __forceinline__ int p() const { return w[R_ROW]; }
  __device__ __forceinline__ float sd() const { return __int_as_float(w[R_SD]); }
  __device__ __forceinline__ const int* nodes(const TicketArgs& a) const {
    return w[R_INLINE] ? w + R_LIST : a.n_idx + w[R_NOFF];
  }
  __device__ __forceinline__ const int* terms(const TicketArgs& a) const {
    return w[R_INLINE] ? w + R_LIST + w[R_NCNT] : a.t_idx + w[R_TOFF];
  }
  __device__ __forceinline__ const int* grows(const TicketArgs& a) const {
    return w[R_INLINE] ? w + R_LIST + w[R_NCNT] + w[R_TCNT] : a.didx + (size_t)p() * a.KG;
  }
  // Child q of node i and i's parent (the record holds the row's node's).
  __device__ __forceinline__ int kid(const TicketArgs& a, int i, int q) const {
    return (i == w[R_NODE] && a.KC <= kRecKids) ? w[R_KIDS + q]
                                                : a.children[(size_t)i * a.KC + q];
  }
  __device__ __forceinline__ int parent_of(const TicketArgs& a, int i) const {
    return i == w[R_NODE] ? w[R_PARENT] : a.parent[i];
  }
};

__device__ __forceinline__ Row row_rec(const TicketArgs& a, int p) {
  return Row{a.rec + (size_t)p * kRecWords};
}

// The threads that apply a ticket to one chain: a CTA (T1, K3 and T3's
// heavy tickets) or a warp (T3's light runs).  sums() leaves every thread
// with the totals, summed in a fixed order, and ends with the team
// synchronised; sync_or() synchronises and ORs a flag.
struct CtaTeam {
  float (*red)[kTicketWarps];
  static constexpr int size = kTicketThreads;
  __device__ __forceinline__ int rank() const { return threadIdx.x; }
  __device__ __forceinline__ void sync() const { __syncthreads(); }
  __device__ __forceinline__ bool sync_or(bool b) const { return __syncthreads_or(b) != 0; }
  template <int K>
  __device__ __forceinline__ void sums(float (&v)[K]) const {
    static_assert(K <= kTicketSums, "red holds kTicketSums rows");
    bool none = false;
    block_sums<K>(v, red, none);
    __syncthreads();  // every thread has read the sums: `red` is free
  }
};

struct WarpTeam {
  static constexpr int size = 32;
  __device__ __forceinline__ int rank() const { return threadIdx.x & 31; }
  __device__ __forceinline__ void sync() const { __syncwarp(); }
  __device__ __forceinline__ bool sync_or(bool b) const {
    __syncwarp();
    return __any_sync(0xffffffffu, b) != 0;
  }
  template <int K>
  __device__ __forceinline__ void sums(float (&v)[K]) const {
#pragma unroll
    for (int k = 0; k < K; ++k) v[k] = warp_sum(v[k]);
    __syncwarp();
  }
};

// torch.minimum semantics: NaN propagates.
__device__ __forceinline__ float min_nan(float a, float b) {
  return (isnan(a) || a < b) ? a : b;
}

// One ticket's proposal on one chain.
struct Move {
  Ticket k;       // G2's families; the other modes fill prop, lmhg and s
  int mode, node;
  float hi;       // slides: the node's old height
  float x;        // slides: the new height; pulley: the shift; braced: delta
  float xi_stem;  // slide contra
  float xil, xir;  // pulley
  int l_lo, l_hi, r_lo, r_hi;  // pulley: the two root subtrees
  int nb;                      // braced: the brace's nodes
  int bn[kBraceMax];
  float bh[kBraceMax], bxs[kBraceMax];  // their old heights and stem factors
};

__device__ __forceinline__ Scalars scalars_at(const TicketArgs& a, int c) {
  return Scalars{a.birth[c], a.death[c], a.height[c], a.rate_mean[c], a.rate_var[c]};
}

// Node i's oldest child (amax over its children, -inf without any).
__device__ __forceinline__ float max_child(const TicketArgs& a, const Row& rw, const float* h,
                                           int i) {
  float m = -INFINITY;
  for (int q = 0; q < a.KC; ++q) {
    const int cq = rw.kid(a, i, q);
    if (cq >= 0) m = max_nan(m, h[cq]);
  }
  return m;
}

// The proposal of row rw on the chain (h, r, cur) from its draw dr and
// tuning tune (the plain versions: the _k_* kernels of
// engine/proposals.py), into mv (shared memory: the struct and its brace
// arrays never pass through local memory).  Reads the state only.
__device__ inline void propose_move(const TicketArgs& a, const Row& rw, float tune, float dr,
                                    const float* h, const float* r, const Scalars& cur,
                                    float mean, Move& mv) {
  mv.mode = rw[R_MODE];
  mv.node = rw[R_NODE];
  mv.hi = mv.x = 0.f;
  mv.xi_stem = mv.xil = mv.xir = 1.0f;
  mv.l_lo = mv.l_hi = mv.r_lo = mv.r_hi = 0;
  mv.nb = 0;
  const float sd = rw.sd();
  if (mv.mode <= SUB_RATE) {
    const GlobDraw t{mv.mode, sd, tune, dr, rw[R_AUX], rw[R_LO], rw[R_HI], rw[R_N_INNER],
                     rw[R_N_NODES]};
    mv.k = propose(ticket_gmodel(a), t, h, r, cur, mean);
    return;
  }
  Ticket& k = mv.k;
  k.s = cur;
  k.mean = 0.f;
  k.u = k.xi = k.xi_stem = 1.0f;
  k.i = k.lo = k.hi = 0;
  float x, lq;
  switch (mv.mode) {
    case SLIDE_ULTRA:
    case SLIDE_CONTRA: {
      // Truncated-normal slide of node i between its oldest child and its
      // parent; the contrary slide rescales the stem rate by
      // (h_p - h_i) / (h_p - h_i') and each child's by (h_i - h_c) /
      // (h_i' - h_c).
      const int i = mv.node;
      const float hi = h[i];
      const float hp = h[rw.parent_of(a, i)];
      truncnorm_sample(dr, hi, sd, tune, max_child(a, rw, h, i), hp, &x, &lq);
      mv.hi = hi;
      mv.x = x;
      k.lmhg = lq;
      if (mv.mode == SLIDE_CONTRA) {
        mv.xi_stem = (hp - hi) / (hp - x);
        float lch = 0.f;
        for (int q = 0; q < a.KC; ++q) {
          const int cq = rw.kid(a, i, q);
          if (cq >= 0) lch += logf((hi - h[cq]) / (x - h[cq]));
        }
        k.lmhg = lq + (logf(mv.xi_stem) + lch);
      }
      break;
    }
    case PULLEY: {
      // One root subtree moves up by u, the other down: heights scale by
      // (h_l - u) / h_l and (h_r + u) / h_r.
      mv.l_lo = rw[R_LO];
      mv.l_hi = rw[R_HI];
      mv.r_lo = rw[R_LO2];
      mv.r_hi = rw[R_HI2];
      const float ht = h[0], hl = h[mv.l_lo], hr = h[mv.r_lo];
      const float lo = -min_nan(ht - hl, hr);
      const float hi = min_nan(ht - hr, hl);
      truncnorm_sample(dr, 0.f, sd, tune, lo, hi, &x, &lq);
      mv.x = x;
      mv.xil = (hl - x) / hl;
      mv.xir = (hr + x) / hr;
      k.lmhg = lq + ((float)(rw[R_N_INNER] - 1) * logf(mv.xil) +
                     (float)(rw[R_N2] - 1) * logf(mv.xir));
      break;
    }
    default: {
      // Braced slides: one common delta for the brace's nodes, inside the
      // intersection of their intervals; the contrary one rescales each
      // node's stem rate and its children's, node by node.
      const int* nodes = a.br_node + (size_t)rw[R_AUX] * a.br_width;
      float lo = -INFINITY, hi = INFINITY;
      for (int w = 0; w < a.br_width; ++w) {
        const int b = nodes[w];
        if (b < 0) continue;
        const float hb = h[b];
        lo = max_nan(lo, max_child(a, rw, h, b) - hb);
        hi = min_nan(hi, h[a.parent[b]] - hb);
        mv.bn[mv.nb] = b;
        mv.bh[mv.nb] = hb;
        ++mv.nb;
      }
      truncnorm_sample(dr, 0.f, sd, tune, lo, hi, &x, &lq);
      mv.x = x;
      k.lmhg = lq;
      if (mv.mode == BRACED_CONTRA) {
        float lj = 0.f;
        for (int q = 0; q < mv.nb; ++q) {
          const int b = mv.bn[q];
          const float hb = mv.bh[q];
          const float hp = h[a.parent[b]];
          mv.bxs[q] = (hp - hb) / ((hp - hb) - x);
          float lch = 0.f;
          for (int w = 0; w < a.KC; ++w) {
            const int cq = rw.kid(a, b, w);
            if (cq >= 0) lch += logf((hb - h[cq]) / ((hb + x) - h[cq]));
          }
          lj = (lj + logf(mv.bxs[q])) + lch;
        }
        k.lmhg = lq + lj;
      }
      break;
    }
  }
  k.prop = x;
}

// Node j's proposed height and rate from its old ones (hj, rj) alone.
__device__ __forceinline__ float move_height(const TicketArgs& a, const Move& mv, const float* h,
                                             int j) {
  switch (mv.mode) {
    case SLIDE_ULTRA:
    case SLIDE_CONTRA:
      return j == mv.node ? mv.x : h[j];
    case PULLEY:
      if (j >= mv.l_lo && j < mv.l_hi) return h[j] * mv.xil;
      return (j >= mv.r_lo && j < mv.r_hi) ? h[j] * mv.xir : h[j];
    case BRACED_ULTRA:
    case BRACED_CONTRA:
      for (int q = 0; q < mv.nb; ++q)
        if (mv.bn[q] == j) return h[j] + mv.x;
      return h[j];
    default:
      return new_height(ticket_gmodel(a), mv.mode, mv.k, h, j);
  }
}

__device__ __forceinline__ float move_rate(const TicketArgs& a, const Move& mv, const float* h,
                                           const float* r, int j) {
  switch (mv.mode) {
    case SLIDE_CONTRA:
      if (j == mv.node) return r[j] * mv.xi_stem;
      return a.parent[j] == mv.node ? r[j] * ((mv.hi - h[j]) / (mv.x - h[j])) : r[j];
    case BRACED_CONTRA: {
      float x = r[j];
      for (int q = 0; q < mv.nb; ++q) {
        if (mv.bn[q] == j) x = x * mv.bxs[q];
        else if (a.parent[j] == mv.bn[q]) x = x * ((mv.bh[q] - h[j]) / ((mv.bh[q] + mv.x) - h[j]));
      }
      return x;
    }
    case SLIDE_ULTRA:
    case PULLEY:
    case BRACED_ULTRA:
      return r[j];
    default:
      return new_rate(ticket_gmodel(a), mv.mode, mv.k, h, r, j);
  }
}

// The root branch of the unrooted tree: height rate_mean ((h_0 - h_l) r_l
// + (h_0 - h_r) r_r) (ops/heights.py root_branch).
__device__ __forceinline__ float root_branch(const TicketArgs& a, const float* h,
                                             const float* r, float H, float rm) {
  const int l = a.root_ch[0], rr = a.root_right;
  return (H * rm) * ((h[0] - h[l]) * r[l] + (h[0] - h[rr]) * r[rr]);
}


// The likelihood class rows (rw[R_DN] of them): row k (-1: past the end);
// g is the gather rows (DC_GATHER only).
__device__ __forceinline__ int class_row(const TicketArgs& a, const Row& rw, const int* g,
                                         int k) {
  const int dc = rw[R_DCLASS];
  int row;
  if (dc == DC_FULL) row = k;
  else if (dc == DC_GATHER) row = g[k];
  else row = k < rw[R_ROW0] ? 0 : rw[R_DLO] + k - rw[R_ROW0];
  return row < a.D ? row : -1;
}

__device__ __forceinline__ int row_of(const TicketArgs& a, int j) {
  return a.order != nullptr ? a.order[j] : a.row;
}

__device__ __forceinline__ int gi_of(const TicketArgs& a, int j) {
  return a.gidx != nullptr ? a.gidx[j] : -1;
}

// Ticket j's draw on chain c (gi: its column in gdraw, -1 for a uniform).
__device__ __forceinline__ float draw_at(const TicketArgs& a, int c, int j, int gi) {
  return gi >= 0 ? a.gdraw[(size_t)c * a.ng + gi] : a.draw[(size_t)c * a.n + j];
}

struct TicketOut {
  float lmhg, lj, d_pr, prop, mean;
  float d_lik;  // the univariate d_lik where the prologue formed it
  bool invalid;
};

// The proposed scalars' birth-death and clock constants, formed once a
// ticket (BdConsts and GammaClock, device_math.cuh): every term bitwise
// K1's (prior_terms.cuh's prior_term).
struct TermConsts {
  BdConsts bd;
  GammaClock gc;
};

// A warp's TermConsts kept across its tickets, with the scalars they were
// formed from (in shared memory; T3's light runs).
struct TermCache {
  TermConsts k;
  float birth, death, rate_var;
};

__device__ __forceinline__ TermConsts term_consts(const Scalars& s) {
  return TermConsts{bd_consts((double)s.birth, (double)s.death), gamma_clock(s.rate_var)};
}

// Entry t of the flat term vector of the proposed state (h, r, s), as
// prior_term with the constants k.
template <class HV, class RV>
__device__ __forceinline__ float ticket_term(const ModelArgs& m, const HV& h, const RV& r, int t,
                                             const Scalars& s, const TermConsts& k) {
  if (t < 4) return scalar_term(m, t, s.birth, s.death, s.rate_mean, s.rate_var);
  if (t < off_ck(m)) {
    const int j = t - 4;
    return j == m.N ? bd_block_term(m, h, j, s.birth, s.death) : bd_term_k(m, h, j, k.bd);
  }
  if (t < off_nd(m)) {
    const int j = t - off_ck(m);
    if (m.clock_model != 0 || j == m.N) return clock_block_term(m, h, r, j, s.rate_var);
    return m.parent[j] < 0 ? 0.0f : gamma_clock_term(k.gc, r[j]);
  }
  return node_term(m, h, t - off_nd(m), s.height);
}

// Calls f(t) for every term entry row rw can change, spread over the team.
template <class Team, typename F>
__device__ __forceinline__ void for_terms(const TicketArgs& a, const Row& rw, const Team& tm,
                                          F f) {
  const int tb = rw[R_TBLOCKS];
  const int o_ck = 4 + a.N + 1, o_nd = 4 + 2 * (a.N + 1);
  if (tb & TB_SC)
    for (int t = tm.rank(); t < 4; t += Team::size) f(t);
  if (tb & TB_BD)
    for (int t = 4 + tm.rank(); t < o_ck; t += Team::size) f(t);
  if (tb & TB_CK)
    for (int t = o_ck + tm.rank(); t < o_nd; t += Team::size) f(t);
  if (tb & TB_ND)
    for (int t = o_nd + tm.rank(); t < a.T; t += Team::size) f(t);
  const int* tl = rw.terms(a);
  for (int q = tm.rank(); q < rw[R_TCNT]; q += Team::size) f(tl[q]);
}

// Calls f(j, heights, rates) for every node whose height or rate row rw
// writes (all N for the global fields, else the row's node set).
template <class Team, typename F>
__device__ __forceinline__ void for_nodes(const TicketArgs& a, const Row& rw, const Team& tm,
                                          F f) {
  const int fl = rw[R_FIELDS];
  if (fl & (F_HEIGHTS | F_RATES)) {
    for (int j = tm.rank(); j < a.N; j += Team::size)
      f(j, (fl & F_HEIGHTS) != 0, (fl & F_RATES) != 0);
  } else if (fl & (F_HLOC | F_RLOC)) {
    const int* nl = rw.nodes(a);
    for (int q = tm.rank(); q < rw[R_NCNT]; q += Team::size)
      f(nl[q], (fl & F_HLOC) != 0, (fl & F_RLOC) != 0);
  }
}

// The prologue of ticket j (row rw, gamma column gi) on chain c, by the
// team tm; s_mv and s_rb are the team's shared slots for the proposal and
// the old root branch.  With a cache (T3's light runs) the term constants
// come from it where the proposed scalars are those it was formed from,
// and under the univariate kind the likelihood delta is formed with the
// distances (o.d_lik; else diag_lik_dev follows).  Ends with the team
// synchronised.
template <class Team>
__device__ inline TicketOut ticket_prologue_dev(const TicketArgs& a, const Team& tm, int c, int j,
                                                int gi, const Row& rw, Move* s_mv, float* s_rb,
                                                TermCache* cache = nullptr) {
  const ModelArgs m = ticket_model(a);
  const int p = rw.p();
  float* h = a.heights + (size_t)c * a.N;
  float* r = a.rates + (size_t)c * a.N;
  const float* te = a.terms + (size_t)c * a.T;
  float* tn = a.tn + (size_t)c * a.T;
  float* hs = a.hs + (size_t)c * a.N;
  float* rs = a.rs + (size_t)c * a.N;
  const Scalars cur = scalars_at(a, c);
  const int mode = rw[R_MODE];
  float mean = 0.f;
  if (mode == VAR_TREE) {
    float v[1] = {0.f};
    for (int q = tm.rank(); q < a.N; q += Team::size)
      if (a.parent[q] >= 0) v[0] += r[q];
    tm.sums(v);
    mean = v[0] / (float)(a.N - 1);
  }
  // One thread draws the proposal into shared memory (the other threads
  // would repeat it, and each thread's copy of it would live in local
  // memory).
  const bool rj = rw[R_RJ] != 0;
  if (tm.rank() == 0) {
    propose_move(a, rw, a.tuning[(size_t)c * a.P + p], draw_at(a, c, j, gi), h, r, cur, mean,
                 *s_mv);
    *s_rb = rj ? root_branch(a, h, r, cur.height, cur.rate_mean) : 0.f;
  }
  tm.sync();  // the proposal is shared; every read of the old state is done
  const Move& mv = *s_mv;
  const float rb_old = *s_rb;
  // The proposal, in place; a node's new values read its old ones only.
  bool nonpos = false;
  for_nodes(a, rw, tm, [&](int q, bool dh, bool drt) {
    const float hq = h[q], rq = r[q];
    const float nh = dh ? move_height(a, mv, h, q) : hq;
    const float nr = drt ? move_rate(a, mv, h, r, q) : rq;
    if (dh) {
      hs[q] = hq;
      h[q] = nh;
    }
    if (drt) {
      rs[q] = rq;
      r[q] = nr;
      nonpos = nonpos || (a.parent[q] >= 0 && !(nr > 0.f));
    }
  });
  const Scalars s = mv.k.s;
  if (tm.rank() == 0) {
    const int fl = rw[R_FIELDS];
    if (fl & (F_BIRTH | F_DEATH | F_HEIGHT | F_RATE_MEAN | F_RATE_VAR)) {
      float* ss = a.ss + (size_t)c * 5;
      ss[0] = cur.birth;
      ss[1] = cur.death;
      ss[2] = cur.height;
      ss[3] = cur.rate_mean;
      ss[4] = cur.rate_var;
    }
    if (fl & F_BIRTH) a.birth[c] = s.birth;
    if (fl & F_DEATH) a.death[c] = s.death;
    if (fl & F_HEIGHT) a.height[c] = s.height;
    if (fl & F_RATE_MEAN) a.rate_mean[c] = s.rate_mean;
    if (fl & F_RATE_VAR) a.rate_var[c] = s.rate_var;
  }
  nonpos = tm.sync_or(nonpos);
  // The row's term entries of the proposed state, with the chain's
  // birth-death and clock constants formed once where they pay: kept
  // across a warp's tickets, or for more entries than the team has threads
  // (each forms them in about the time of one entry).
  TermConsts tk;
  const bool hoist = cache != nullptr
                         ? rw[R_TBLOCKS] != 0 || rw[R_TCNT] > 0
                         : (rw[R_TBLOCKS] & (TB_BD | TB_CK)) || rw[R_TCNT] > Team::size;
  if (hoist) {
    if (cache != nullptr && cache->birth == s.birth && cache->death == s.death &&
        cache->rate_var == s.rate_var) {
      tk = cache->k;
    } else {
      tk = term_consts(s);
      if (cache != nullptr) {
        tm.sync();  // every thread has read the old key
        if (tm.rank() == 0) *cache = TermCache{tk, s.birth, s.death, s.rate_var};
      }
    }
  }
  float v[4] = {0.f, 0.f, 0.f, 0.f};  // d_pr, new bad, old bad, fused d_lik sum
  for_terms(a, rw, tm, [&](int t) {
    const float x = hoist ? ticket_term(m, h, r, t, s, tk)
                          : prior_term(m, h, r, t, s.birth, s.death, s.height, s.rate_mean,
                                       s.rate_var);
    const float o = te[t];
    tn[t] = x;
    const float diff = x - o;
    if (!isnan(diff)) v[0] += diff;
    if (is_bad(x)) v[1] += 1.0f;
    if (is_bad(o)) v[2] += 1.0f;
  });
  // The new distances on the class rows.
  const int dc = rw[R_DCLASS];
  const bool fuse = cache != nullptr && a.lik == LIK_DIAG;
  if (a.lik != LIK_NONE && dc != DC_INV) {
    const float scale = s.height * s.rate_mean;
    const float* d = a.d + (size_t)c * a.D;
    const float* y = a.y + (size_t)c * a.D;
    float* dn = a.dn + (size_t)c * a.D;
    float* dl = a.dl + (size_t)c * a.D;
    float* dys = a.dys + (size_t)c * a.D;
    const int* g = dc == DC_GATHER ? rw.grows(a) : nullptr;
    for (int k = tm.rank(); k < rw[R_DN]; k += Team::size) {
      const int row = class_row(a, rw, g, k);
      if (row < 0) continue;
      const float x = distance_row(a.parent, a.dist_idx, a.root_right, h, r, scale, row);
      const float delta = x - d[row];
      dn[row] = x;
      dl[row] = delta;
      if (fuse) {  // diag_lik_dev's terms, each on the thread diag_lik_dev gives it
        const float dy = delta * a.inv_sd[row];
        dys[row] = dy;
        v[3] += dy * (2.0f * y[row] + dy);
      }
    }
  }
  const float rb_new = rj ? root_branch(a, h, r, s.height, s.rate_mean) : 0.f;
  tm.sums(v);
  TicketOut o;
  const bool var = mode == VAR_TREE || mode == VAR_AUTO;
  o.lmhg = (var && nonpos) ? -INFINITY : mv.k.lmhg;
  o.lj = rj ? (-logf(rb_new)) - (-logf(rb_old)) : 0.f;
  o.d_pr = v[0];
  o.invalid = v[1] > 0.f || (float)a.nbad[c] > v[2];
  o.prop = mv.k.prop;
  o.mean = mean;
  o.d_lik = -0.5f * v[3];
  return o;
}

// Under the univariate kind: dy = delta inv_sd on the class rows (into
// dys) and d_lik.  After the prologue; ends with the team synchronised.
template <class Team>
__device__ inline float diag_lik_dev(const TicketArgs& a, const Team& tm, int c, const Row& rw) {
  const int dc = rw[R_DCLASS];
  float v[1] = {0.f};
  if (dc != DC_INV) {
    const float* y = a.y + (size_t)c * a.D;
    const float* dl = a.dl + (size_t)c * a.D;
    float* dys = a.dys + (size_t)c * a.D;
    const int* g = dc == DC_GATHER ? rw.grows(a) : nullptr;
    for (int k = tm.rank(); k < rw[R_DN]; k += Team::size) {
      const int row = class_row(a, rw, g, k);
      if (row < 0) continue;
      const float dy = dl[row] * a.inv_sd[row];
      dys[row] = dy;
      v[0] += dy * (2.0f * y[row] + dy);
    }
  }
  tm.sums(v);
  return -0.5f * v[0];
}

// Under a full MVN, a gather ticket: dy = delta[rows] @ L[rows, :] over all
// D columns (into dys) and d_lik.  After the prologue; ends with the team
// synchronised.
template <class Team>
__device__ inline float gather_lik_dev(const TicketArgs& a, const Team& tm, int c, const Row& rw) {
  const float* y = a.y + (size_t)c * a.D;
  const float* dl = a.dl + (size_t)c * a.D;
  float* dys = a.dys + (size_t)c * a.D;
  const int* rows = rw.grows(a);
  float v[1] = {0.f};
  for (int col = tm.rank(); col < a.D; col += Team::size) {
    float x = 0.f;
    for (int k = 0; k < a.KG; ++k) {
      const int row = rows[k];
      if (row < a.D) x += dl[row] * a.L[(size_t)row * a.D + col];
    }
    dys[col] = x;
    v[0] += x * (2.0f * y[col] + x);
  }
  tm.sums(v);
  return -0.5f * v[0];
}

// The decision and write-back of ticket j (row rw) on chain c, d_lik
// tempered by the chain's likelihood temperature and d_pr by its prior
// temperature (the JAX step's beta_prior * d_pr + beta * d_lik,
// engine/mh.py:194; __fmul_rn, so that a temperature of 1 gives d_pr's own
// bits whatever the compiler fuses); dy is the
// chain's full dy row (K2's or the gather's, all D), or null (the class
// rows of dys under the univariate kind; no y change otherwise).  `oi` is
// the index of the optional outputs.  Ends with the team synchronised.
template <class Team>
__device__ inline bool ticket_epilogue_dev(const TicketArgs& a, const Team& tm, int c, int j,
                                           const Row& rw, const TicketOut& o, float d_lik,
                                           const float* dy, size_t oi) {
  const float d_pr = __fmul_rn(a.beta_prior[c], o.d_pr);
  float la = (((o.invalid ? -INFINITY : d_pr) + d_lik) + o.lmhg) + o.lj;
  if (isnan(la)) la = -INFINITY;
  const bool acc = logf(a.u_acc[(size_t)c * a.n + j]) < la;
  float* h = a.heights + (size_t)c * a.N;
  float* r = a.rates + (size_t)c * a.N;
  if (acc) {
    float* te = a.terms + (size_t)c * a.T;
    const float* tn = a.tn + (size_t)c * a.T;
    for_terms(a, rw, tm, [&](int t) { te[t] = tn[t]; });
    const int dc = rw[R_DCLASS];
    if (a.lik != LIK_NONE && dc != DC_INV) {
      float* d = a.d + (size_t)c * a.D;
      float* y = a.y + (size_t)c * a.D;
      const float* dn = a.dn + (size_t)c * a.D;
      const float* dys = a.dys + (size_t)c * a.D;
      const int* g = dc == DC_GATHER ? rw.grows(a) : nullptr;
      for (int k = tm.rank(); k < rw[R_DN]; k += Team::size) {
        const int row = class_row(a, rw, g, k);
        if (row < 0) continue;
        d[row] = dn[row];
        if (dy == nullptr && a.lik == LIK_DIAG) y[row] = y[row] + dys[row];
      }
      if (dy != nullptr)
        for (int col = tm.rank(); col < a.D; col += Team::size) y[col] = y[col] + dy[col];
    }
    if (tm.rank() == 0) {
      a.acc[(size_t)c * a.P + rw.p()] += 1;
      a.nbad[c] = 0;
    }
  } else {
    const float* hs = a.hs + (size_t)c * a.N;
    const float* rs = a.rs + (size_t)c * a.N;
    for_nodes(a, rw, tm, [&](int q, bool dh, bool drt) {
      if (dh) h[q] = hs[q];
      if (drt) r[q] = rs[q];
    });
    if (tm.rank() == 0) {
      const float* ss = a.ss + (size_t)c * 5;
      const int fl = rw[R_FIELDS];
      if (fl & F_BIRTH) a.birth[c] = ss[0];
      if (fl & F_DEATH) a.death[c] = ss[1];
      if (fl & F_HEIGHT) a.height[c] = ss[2];
      if (fl & F_RATE_MEAN) a.rate_mean[c] = ss[3];
      if (fl & F_RATE_VAR) a.rate_var[c] = ss[4];
    }
  }
  if (tm.rank() == 0) {
    if (a.accept_out != nullptr) a.accept_out[oi] = acc;
    if (a.la_out != nullptr) a.la_out[oi] = la;
  }
  tm.sync();
  return acc;
}

// Whether a light ticket takes ticket_fast_dev: node-local (no whole
// block, no global or scalar field, not var_tree), at most one node, term
// entry and class row a lane, and a likelihood delta on its class rows
// only (none, DC_INV, or the univariate kind).
__device__ __forceinline__ bool fast_ticket(const TicketArgs& a, const Row& rw) {
  const int dc = rw[R_DCLASS];
  return rw[R_TBLOCKS] == 0 && (rw[R_FIELDS] & ~(F_HLOC | F_RLOC)) == 0 && rw[R_NCNT] <= 32 &&
         rw[R_TCNT] <= 32 && rw[R_MODE] != VAR_TREE &&
         (a.lik == LIK_NONE || dc == DC_INV || (a.lik == LIK_DIAG && rw[R_DN] <= 32));
}

// A whole light ticket (fast_ticket) on chain c by its warp, the same
// arithmetic as ticket_prologue_dev and ticket_finish in the same order
// (state, terms, d and y bitwise theirs), but every value a lane reads of
// its node, term entry and class row loaded in one round at the start, and
// every value it writes kept in registers until the decision: no scratch
// row is written or read back.  Returns the decision.
__device__ inline bool ticket_fast_dev(const TicketArgs& a, int c, int j, int gi, const Row& rw,
                                       Move* s_mv, float* s_rb, TermCache* cache) {
  const ModelArgs m = ticket_model(a);
  const int lane = threadIdx.x & 31;
  const int p = rw.p();
  float* h = a.heights + (size_t)c * a.N;
  float* r = a.rates + (size_t)c * a.N;
  float* te = a.terms + (size_t)c * a.T;
  float* d = a.d + (size_t)c * a.D;
  float* y = a.y + (size_t)c * a.D;
  const int fl = rw[R_FIELDS], dc = rw[R_DCLASS];
  const bool dh = (fl & F_HLOC) != 0, drt = (fl & F_RLOC) != 0;
  const int q = lane < rw[R_NCNT] ? rw.nodes(a)[lane] : -1;
  const int t = lane < rw[R_TCNT] ? rw.terms(a)[lane] : -1;
  const int row = (a.lik == LIK_DIAG && dc != DC_INV && lane < rw[R_DN])
                      ? class_row(a, rw, dc == DC_GATHER ? rw.grows(a) : nullptr, lane)
                      : -1;
  // One round of independent loads.
  const Scalars cur = scalars_at(a, c);
  const float u = a.u_acc[(size_t)c * a.n + j];
  const int nbad = a.nbad[c];
  const float beta = a.beta[c];
  const float bprior = a.beta_prior[c];
  const float hq = q >= 0 ? h[q] : 0.f, rq = q >= 0 ? r[q] : 0.f;
  const float to = t >= 0 ? te[t] : 0.f;
  const float dold = row >= 0 ? d[row] : 0.f, yold = row >= 0 ? y[row] : 0.f;
  const float isd = row >= 0 ? a.inv_sd[row] : 0.f;
  const bool rj = rw[R_RJ] != 0;
  if (lane == 0) {
    propose_move(a, rw, a.tuning[(size_t)c * a.P + p], draw_at(a, c, j, gi), h, r, cur, 0.f,
                 *s_mv);
    *s_rb = rj ? root_branch(a, h, r, cur.height, cur.rate_mean) : 0.f;
  }
  __syncwarp();  // the proposal is shared; every read of the old state is done
  const Move& mv = *s_mv;
  const float rb_old = *s_rb;
  bool nonpos = false;
  if (q >= 0) {
    const float nh = dh ? move_height(a, mv, h, q) : hq;
    const float nr = drt ? move_rate(a, mv, h, r, q) : rq;
    if (dh) h[q] = nh;
    if (drt) {
      r[q] = nr;
      nonpos = a.parent[q] >= 0 && !(nr > 0.f);
    }
  }
  __syncwarp();
  nonpos = __any_sync(0xffffffffu, nonpos) != 0;
  const Scalars s = mv.k.s;
  TermConsts tk;
  if (rw[R_TCNT] > 0) {
    if (cache->birth == s.birth && cache->death == s.death && cache->rate_var == s.rate_var) {
      tk = cache->k;
    } else {
      tk = term_consts(s);
      __syncwarp();  // every lane has read the old key
      if (lane == 0) *cache = TermCache{tk, s.birth, s.death, s.rate_var};
    }
  }
  float v[4] = {0.f, 0.f, 0.f, 0.f};  // d_pr, new bad, old bad, d_lik sum
  float tnew = 0.f;
  if (t >= 0) {
    tnew = ticket_term(m, h, r, t, s, tk);
    const float diff = tnew - to;
    if (!isnan(diff)) v[0] += diff;
    if (is_bad(tnew)) v[1] += 1.0f;
    if (is_bad(to)) v[2] += 1.0f;
  }
  float dn = 0.f, dy = 0.f;
  if (row >= 0) {
    dn = distance_row(a.parent, a.dist_idx, a.root_right, h, r, s.height * s.rate_mean, row);
    dy = (dn - dold) * isd;
    v[3] += dy * (2.0f * yold + dy);
  }
  const float rb_new = rj ? root_branch(a, h, r, s.height, s.rate_mean) : 0.f;
#pragma unroll
  for (int k = 0; k < 4; ++k) v[k] = warp_sum(v[k]);
  const bool var = rw[R_MODE] == VAR_AUTO;
  const float lmhg = (var && nonpos) ? -INFINITY : mv.k.lmhg;
  const float lj = rj ? (-logf(rb_new)) - (-logf(rb_old)) : 0.f;
  const bool invalid = v[1] > 0.f || (float)nbad > v[2];
  float la = (((invalid ? -INFINITY : __fmul_rn(bprior, v[0])) + beta * (-0.5f * v[3])) + lmhg)
             + lj;
  if (isnan(la)) la = -INFINITY;
  const bool acc = logf(u) < la;
  if (acc) {
    if (t >= 0) te[t] = tnew;
    if (row >= 0) {
      d[row] = dn;
      y[row] = yold + dy;
    }
    if (lane == 0) {
      a.acc[(size_t)c * a.P + p] += 1;
      a.nbad[c] = 0;
    }
  } else if (q >= 0) {
    if (dh) h[q] = hq;
    if (drt) r[q] = rq;
  }
  if (lane == 0) {
    const size_t oi = (size_t)c * a.n + j;
    if (a.accept_out != nullptr) a.accept_out[oi] = acc;
    if (a.la_out != nullptr) a.la_out[oi] = la;
    if (a.prop_out != nullptr) a.prop_out[oi] = mv.k.prop;
  }
  __syncwarp();
  return acc;
}

// A T3 ticket after its prologue: the likelihood delta (univariate, or a
// full MVN's gather), the optional outputs and the epilogue.  Returns the
// decision.
template <class Team>
__device__ inline bool ticket_finish(const TicketArgs& a, const Team& tm, int c, int j,
                                     const Row& rw, const TicketOut& o, bool fused = false) {
  float d_lik = 0.f;
  const float* dy = nullptr;
  if (a.lik == LIK_DIAG) {
    d_lik = fused ? o.d_lik : diag_lik_dev(a, tm, c, rw);
  } else if (a.lik == LIK_FULL && rw[R_DCLASS] == DC_GATHER) {
    d_lik = gather_lik_dev(a, tm, c, rw);
    dy = a.dys + (size_t)c * a.D;
  }
  const size_t oi = (size_t)c * a.n + j;
  if (tm.rank() == 0) {
    if (a.prop_out != nullptr) a.prop_out[oi] = o.prop;
    if (a.mean_out != nullptr && rw[R_MODE] == VAR_TREE) a.mean_out[oi] = o.mean;
  }
  return ticket_epilogue_dev(a, tm, c, j, rw, o, a.beta[c] * d_lik, dy, oi);
}

}  // namespace mcmcdate
