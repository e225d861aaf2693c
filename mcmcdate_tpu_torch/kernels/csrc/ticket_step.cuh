// The sequential sweep's ticket step as device functions: the prologue
// (kernel T1 ticket_prologue, csrc/ticket_step.cu), the likelihood deltas
// and the epilogue (kernel K3 accept_select, csrc/accept_select.cu), all
// three chained ticket after ticket by T3 ticket_scan (csrc/ticket_step.cu).
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

#include "glob_moves.cuh"
#include "lane_groups.cuh"
#include "prior_terms.cuh"

namespace mcmcdate {

constexpr int kTicketThreads = 128;
constexpr int kTicketWarps = kTicketThreads / 32;
constexpr int kBraceMax = 16;  // braced nodes a brace may hold

// Proposal modes past G2's families (kernels/ticket_step.py).
enum TicketMode { SLIDE_ULTRA = SUB_RATE + 1, SLIDE_CONTRA, PULLEY, BRACED_ULTRA, BRACED_CONTRA };
enum TicketField { F_HLOC = 128, F_RLOC = 256 };
enum TermBlock { TB_SC = 1, TB_BD = 2, TB_CK = 4, TB_ND = 8 };
enum LikKind { LIK_NONE, LIK_DIAG, LIK_FULL };
enum DClass { DC_INV, DC_FULL, DC_GATHER, DC_B64, DC_B256, DC_B1024 };

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
  // the table, per row [P]
  const int* mode;
  const int* fields;
  const int* tblocks;
  const int* node;
  const int* aux;
  const int* lo;
  const int* hi;
  const int* n_inner;
  const int* n_nodes;
  const int* lo2;
  const int* hi2;
  const int* n2;
  const float* sd;
  const unsigned char* rj;
  const int* d_class;
  const int* d_lo;
  const int* didx;   // [P, KG], D padding
  const int* t_off;  // [P + 1] explicit term entries (CSR)
  const int* t_idx;
  const int* n_off;  // [P + 1] node set (CSR)
  const int* n_idx;
  const float* tuning;  // [C, P]
  // the tickets [n] and their draws
  const int* order;     // [n] row of each ticket (null: `row`, one ticket)
  const float* draw;    // [C, n] uniforms, or every ticket's draw
  const float* gdraw;   // [C, ng] standard-gamma draws (nullable)
  const int* gidx;      // [n] column in gdraw, -1: uniform (nullable)
  const float* u_acc;   // [C, n]
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
__device__ __forceinline__ float max_child(const TicketArgs& a, const float* h, int i) {
  float m = -INFINITY;
  for (int q = 0; q < a.KC; ++q) {
    const int cq = a.children[(size_t)i * a.KC + q];
    if (cq >= 0) m = max_nan(m, h[cq]);
  }
  return m;
}

// The proposal of row p on the chain (h, r, cur) from its draw dr and
// tuning tune (the plain versions: the _k_* kernels of
// engine/proposals.py).  Reads only.
__device__ inline Move propose_move(const TicketArgs& a, int p, float tune, float dr,
                                    const float* h, const float* r, const Scalars& cur,
                                    float mean) {
  Move mv;
  mv.mode = a.mode[p];
  mv.node = a.node[p];
  mv.hi = mv.x = 0.f;
  mv.xi_stem = mv.xil = mv.xir = 1.0f;
  mv.l_lo = mv.l_hi = mv.r_lo = mv.r_hi = 0;
  mv.nb = 0;
  const float sd = a.sd[p];
  if (mv.mode <= SUB_RATE) {
    const GlobDraw t{mv.mode, sd, tune, dr, a.aux[p], a.lo[p], a.hi[p], a.n_inner[p],
                     a.n_nodes[p]};
    mv.k = propose(ticket_gmodel(a), t, h, r, cur, mean);
    return mv;
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
      const float hp = h[a.parent[i]];
      truncnorm_sample(dr, hi, sd, tune, max_child(a, h, i), hp, &x, &lq);
      mv.hi = hi;
      mv.x = x;
      k.lmhg = lq;
      if (mv.mode == SLIDE_CONTRA) {
        mv.xi_stem = (hp - hi) / (hp - x);
        float lch = 0.f;
        for (int q = 0; q < a.KC; ++q) {
          const int cq = a.children[(size_t)i * a.KC + q];
          if (cq >= 0) lch += logf((hi - h[cq]) / (x - h[cq]));
        }
        k.lmhg = lq + (logf(mv.xi_stem) + lch);
      }
      break;
    }
    case PULLEY: {
      // One root subtree moves up by u, the other down: heights scale by
      // (h_l - u) / h_l and (h_r + u) / h_r.
      mv.l_lo = a.lo[p];
      mv.l_hi = a.hi[p];
      mv.r_lo = a.lo2[p];
      mv.r_hi = a.hi2[p];
      const float ht = h[0], hl = h[mv.l_lo], hr = h[mv.r_lo];
      const float lo = -min_nan(ht - hl, hr);
      const float hi = min_nan(ht - hr, hl);
      truncnorm_sample(dr, 0.f, sd, tune, lo, hi, &x, &lq);
      mv.x = x;
      mv.xil = (hl - x) / hl;
      mv.xir = (hr + x) / hr;
      k.lmhg = lq + ((float)(a.n_inner[p] - 1) * logf(mv.xil) +
                     (float)(a.n2[p] - 1) * logf(mv.xir));
      break;
    }
    default: {
      // Braced slides: one common delta for the brace's nodes, inside the
      // intersection of their intervals; the contrary one rescales each
      // node's stem rate and its children's, node by node.
      const int* nodes = a.br_node + (size_t)a.aux[p] * a.br_width;
      float lo = -INFINITY, hi = INFINITY;
      for (int w = 0; w < a.br_width; ++w) {
        const int b = nodes[w];
        if (b < 0) continue;
        const float hb = h[b];
        lo = max_nan(lo, max_child(a, h, b) - hb);
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
            const int cq = a.children[(size_t)b * a.KC + w];
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
  return mv;
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

// The likelihood class rows: count, and row k (-1: past the end).
__device__ __forceinline__ int class_count(const TicketArgs& a, int dc) {
  switch (dc) {
    case DC_FULL: return a.D;
    case DC_GATHER: return a.KG;
    case DC_B64: return 65;
    case DC_B256: return 257;
    case DC_B1024: return 1025;
    default: return 0;
  }
}

__device__ __forceinline__ int class_row(const TicketArgs& a, int p, int dc, int k) {
  int row;
  if (dc == DC_FULL) row = k;
  else if (dc == DC_GATHER) row = a.didx[(size_t)p * a.KG + k];
  else row = k == 0 ? 0 : a.d_lo[p] + k - 1;
  return row < a.D ? row : -1;
}

__device__ __forceinline__ int row_of(const TicketArgs& a, int j) {
  return a.order != nullptr ? a.order[j] : a.row;
}

__device__ __forceinline__ float draw_of(const TicketArgs& a, int c, int j) {
  const int gi = a.gidx != nullptr ? a.gidx[j] : -1;
  return gi >= 0 ? a.gdraw[(size_t)c * a.ng + gi] : a.draw[(size_t)c * a.n + j];
}

struct TicketOut {
  float lmhg, lj, d_pr, prop, mean;
  bool invalid;
};

// Calls f(t) for every term entry row p can change, spread over the CTA.
template <typename F>
__device__ __forceinline__ void for_terms(const TicketArgs& a, int p, F f) {
  const int tb = a.tblocks[p];
  const int o_ck = 4 + a.N + 1, o_nd = 4 + 2 * (a.N + 1);
  if (tb & TB_SC)
    for (int t = threadIdx.x; t < 4; t += kTicketThreads) f(t);
  if (tb & TB_BD)
    for (int t = 4 + threadIdx.x; t < o_ck; t += kTicketThreads) f(t);
  if (tb & TB_CK)
    for (int t = o_ck + threadIdx.x; t < o_nd; t += kTicketThreads) f(t);
  if (tb & TB_ND)
    for (int t = o_nd + threadIdx.x; t < a.T; t += kTicketThreads) f(t);
  for (int q = a.t_off[p] + threadIdx.x; q < a.t_off[p + 1]; q += kTicketThreads) f(a.t_idx[q]);
}

// Calls f(j, heights, rates) for every node whose height or rate row p
// writes (all N for the global fields, else the row's node set).
template <typename F>
__device__ __forceinline__ void for_nodes(const TicketArgs& a, int p, F f) {
  const int fl = a.fields[p];
  if (fl & (F_HEIGHTS | F_RATES)) {
    for (int j = threadIdx.x; j < a.N; j += kTicketThreads)
      f(j, (fl & F_HEIGHTS) != 0, (fl & F_RATES) != 0);
  } else if (fl & (F_HLOC | F_RLOC)) {
    for (int q = a.n_off[p] + threadIdx.x; q < a.n_off[p + 1]; q += kTicketThreads)
      f(a.n_idx[q], (fl & F_HLOC) != 0, (fl & F_RLOC) != 0);
  }
}

// The prologue of ticket j (row p) on chain c.  Ends with a barrier.
__device__ inline TicketOut ticket_prologue_dev(const TicketArgs& a, int c, int j, int p,
                                                float (*red)[kTicketWarps]) {
  const ModelArgs m = ticket_model(a);
  float* h = a.heights + (size_t)c * a.N;
  float* r = a.rates + (size_t)c * a.N;
  const float* te = a.terms + (size_t)c * a.T;
  float* tn = a.tn + (size_t)c * a.T;
  float* hs = a.hs + (size_t)c * a.N;
  float* rs = a.rs + (size_t)c * a.N;
  const Scalars cur = scalars_at(a, c);
  const int mode = a.mode[p];
  bool none = false;
  float mean = 0.f;
  if (mode == VAR_TREE) {
    float v[1] = {0.f};
    for (int q = threadIdx.x; q < a.N; q += kTicketThreads)
      if (a.parent[q] >= 0) v[0] += r[q];
    block_sums<1>(v, red, none);
    mean = v[0] / (float)(a.N - 1);
  }
  // One thread draws the proposal into shared memory (the other threads
  // would repeat it, and each thread's copy of it would live in local
  // memory).
  __shared__ Move s_mv;
  __shared__ float s_rb_old;
  const bool rj = a.rj[p] != 0;
  if (threadIdx.x == 0) {
    s_mv = propose_move(a, p, a.tuning[(size_t)c * a.P + p], draw_of(a, c, j), h, r, cur, mean);
    s_rb_old = rj ? root_branch(a, h, r, cur.height, cur.rate_mean) : 0.f;
  }
  __syncthreads();  // the proposal is shared; every read of the old state is done
  const Move& mv = s_mv;
  const float rb_old = s_rb_old;
  // The proposal, in place; a node's new values read its old ones only.
  bool nonpos = false;
  for_nodes(a, p, [&](int q, bool dh, bool drt) {
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
  const Scalars& s = mv.k.s;
  if (threadIdx.x == 0) {
    float* ss = a.ss + (size_t)c * 5;
    ss[0] = cur.birth;
    ss[1] = cur.death;
    ss[2] = cur.height;
    ss[3] = cur.rate_mean;
    ss[4] = cur.rate_var;
    const int fl = a.fields[p];
    if (fl & F_BIRTH) a.birth[c] = s.birth;
    if (fl & F_DEATH) a.death[c] = s.death;
    if (fl & F_HEIGHT) a.height[c] = s.height;
    if (fl & F_RATE_MEAN) a.rate_mean[c] = s.rate_mean;
    if (fl & F_RATE_VAR) a.rate_var[c] = s.rate_var;
  }
  nonpos = __syncthreads_or(nonpos) != 0;
  // The row's term entries of the proposed state.
  float v[3] = {0.f, 0.f, 0.f};  // d_pr, new bad, old bad
  for_terms(a, p, [&](int t) {
    const float x = prior_term(m, h, r, t, s.birth, s.death, s.height, s.rate_mean, s.rate_var);
    const float o = te[t];
    tn[t] = x;
    const float diff = x - o;
    if (!isnan(diff)) v[0] += diff;
    if (is_bad(x)) v[1] += 1.0f;
    if (is_bad(o)) v[2] += 1.0f;
  });
  // The new distances on the class rows.
  const int dc = a.d_class[p];
  if (a.lik != LIK_NONE && dc != DC_INV) {
    const float scale = s.height * s.rate_mean;
    const float* d = a.d + (size_t)c * a.D;
    float* dn = a.dn + (size_t)c * a.D;
    float* dl = a.dl + (size_t)c * a.D;
    const int cnt = class_count(a, dc);
    for (int k = threadIdx.x; k < cnt; k += kTicketThreads) {
      const int row = class_row(a, p, dc, k);
      if (row < 0) continue;
      const float x = distance_row(a.parent, a.dist_idx, a.root_right, h, r, scale, row);
      dn[row] = x;
      dl[row] = x - d[row];
    }
  }
  const float rb_new = rj ? root_branch(a, h, r, s.height, s.rate_mean) : 0.f;
  block_sums<3>(v, red, none);
  TicketOut o;
  const bool var = mode == VAR_TREE || mode == VAR_AUTO;
  o.lmhg = (var && nonpos) ? -INFINITY : mv.k.lmhg;
  o.lj = rj ? (-logf(rb_new)) - (-logf(rb_old)) : 0.f;
  o.d_pr = v[0];
  o.invalid = v[1] > 0.f || (float)a.nbad[c] > v[2];
  o.prop = mv.k.prop;
  o.mean = mean;
  __syncthreads();  // every thread has read the sums: `red` is free
  return o;
}

// Under the univariate kind: dy = delta inv_sd on the class rows (into
// dys) and d_lik.  After the prologue's barrier; ends with one.
__device__ inline float diag_lik_dev(const TicketArgs& a, int c, int p,
                                     float (*red)[kTicketWarps]) {
  const int dc = a.d_class[p];
  float v[1] = {0.f};
  bool none = false;
  if (dc != DC_INV) {
    const float* y = a.y + (size_t)c * a.D;
    const float* dl = a.dl + (size_t)c * a.D;
    float* dys = a.dys + (size_t)c * a.D;
    const int cnt = class_count(a, dc);
    for (int k = threadIdx.x; k < cnt; k += kTicketThreads) {
      const int row = class_row(a, p, dc, k);
      if (row < 0) continue;
      const float dy = dl[row] * a.inv_sd[row];
      dys[row] = dy;
      v[0] += dy * (2.0f * y[row] + dy);
    }
  }
  block_sums<1>(v, red, none);
  return -0.5f * v[0];
}

// Under a full MVN, a gather ticket: dy = delta[rows] @ L[rows, :] over all
// D columns (into dys) and d_lik.  After the prologue's barrier; ends with
// one.
__device__ inline float gather_lik_dev(const TicketArgs& a, int c, int p,
                                       float (*red)[kTicketWarps]) {
  const float* y = a.y + (size_t)c * a.D;
  const float* dl = a.dl + (size_t)c * a.D;
  float* dys = a.dys + (size_t)c * a.D;
  const int* rows = a.didx + (size_t)p * a.KG;
  float v[1] = {0.f};
  bool none = false;
  for (int col = threadIdx.x; col < a.D; col += kTicketThreads) {
    float x = 0.f;
    for (int k = 0; k < a.KG; ++k) {
      const int row = rows[k];
      if (row < a.D) x += dl[row] * a.L[(size_t)row * a.D + col];
    }
    dys[col] = x;
    v[0] += x * (2.0f * y[col] + x);
  }
  block_sums<1>(v, red, none);
  return -0.5f * v[0];
}

// The decision and write-back of ticket j (row p) on chain c; dy is the
// chain's full dy row (K2's or the gather's, all D), or null (the class
// rows of dys under the univariate kind; no y change otherwise).  `oi` is
// the index of the optional outputs.  Ends with a barrier.
__device__ inline bool ticket_epilogue_dev(const TicketArgs& a, int c, int j, int p,
                                           const TicketOut& o, float d_lik, const float* dy,
                                           size_t oi) {
  float la = (((o.invalid ? -INFINITY : o.d_pr) + d_lik) + o.lmhg) + o.lj;
  if (isnan(la)) la = -INFINITY;
  const bool acc = logf(a.u_acc[(size_t)c * a.n + j]) < la;
  float* h = a.heights + (size_t)c * a.N;
  float* r = a.rates + (size_t)c * a.N;
  if (acc) {
    float* te = a.terms + (size_t)c * a.T;
    const float* tn = a.tn + (size_t)c * a.T;
    for_terms(a, p, [&](int t) { te[t] = tn[t]; });
    const int dc = a.d_class[p];
    if (a.lik != LIK_NONE && dc != DC_INV) {
      float* d = a.d + (size_t)c * a.D;
      float* y = a.y + (size_t)c * a.D;
      const float* dn = a.dn + (size_t)c * a.D;
      const float* dys = a.dys + (size_t)c * a.D;
      const int cnt = class_count(a, dc);
      for (int k = threadIdx.x; k < cnt; k += kTicketThreads) {
        const int row = class_row(a, p, dc, k);
        if (row < 0) continue;
        d[row] = dn[row];
        if (dy == nullptr && a.lik == LIK_DIAG) y[row] = y[row] + dys[row];
      }
      if (dy != nullptr)
        for (int col = threadIdx.x; col < a.D; col += kTicketThreads) y[col] = y[col] + dy[col];
    }
    if (threadIdx.x == 0) {
      a.acc[(size_t)c * a.P + p] += 1;
      a.nbad[c] = 0;
    }
  } else {
    const float* hs = a.hs + (size_t)c * a.N;
    const float* rs = a.rs + (size_t)c * a.N;
    for_nodes(a, p, [&](int q, bool dh, bool drt) {
      if (dh) h[q] = hs[q];
      if (drt) r[q] = rs[q];
    });
    if (threadIdx.x == 0) {
      const float* ss = a.ss + (size_t)c * 5;
      const int fl = a.fields[p];
      if (fl & F_BIRTH) a.birth[c] = ss[0];
      if (fl & F_DEATH) a.death[c] = ss[1];
      if (fl & F_HEIGHT) a.height[c] = ss[2];
      if (fl & F_RATE_MEAN) a.rate_mean[c] = ss[3];
      if (fl & F_RATE_VAR) a.rate_var[c] = ss[4];
    }
  }
  if (threadIdx.x == 0) {
    if (a.accept_out != nullptr) a.accept_out[oi] = acc;
    if (a.la_out != nullptr) a.la_out[oi] = la;
  }
  __syncthreads();
  return acc;
}

}  // namespace mcmcdate
