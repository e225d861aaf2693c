// K4's point mega-step around point_scan: its prologue and epilogue.
//
// Together with point_scan_kernel (csrc/point_scan.cu) and the product
// z += dacc @ Prow they replace the XLA-compiled FastSweeps._mega_point_lik
// (mcmcdate_tpu/engine/fast_sweep.py:1324-1565).  A step holds B tickets on
// nodes with no parent-child pair among them: the node kind slides node i's
// height from a truncated normal between its oldest child and its parent,
// the branch kind scales i's rate by a gamma factor.  Each ticket touches
// the distance rows d_rows[b, :KD] (i's branch, and for a slide its
// children's) and the term rows t_rows[b, :KT].
//
// point_lik_prologue_kernel: from the injected draw, the proposal (the new
// height, or the rate factor) and its log ratio lq, the new birth-death (in
// double), clock and calibration terms tn, the distance deltas
// delta = d_new - d_old, d_pr, lmhg = (invalid or pad) ? -inf : lq, and,
// with a likelihood (z not null), the carried z at the distance rows (zG).
// point_lik_epilogue_kernel: for the accepted tickets, the stores of the new
// height or rate and terms, d += delta (rows are disjoint within a step, so
// plain stores suffice), the accept counts, q += the accepted dq (summed
// in a fixed order; skipped without a likelihood, dq null), and dacc (delta
// where accepted, else 0) for the z update.  Without a likelihood it also
// takes the decisions, log u < beta_prior d_pr + lmhg with the chain's
// prior temperature (u_acc not null, accept written).
//
// What bounds them on the H100.  The prologue: its instructions and a long
// dependent path per (chain, ticket) pair: its plan, one round of gathers
// from the chain's rows, then special functions (the normal CDFs and their
// inverse, or lgamma, and the birth-death exp/log in double for up to
// 1 + KC nodes); its bytes are a few gathered floats per pair in and out.
// The epilogue: a few dependent rounds of scattered reads and writes in
// each chain's rows.  The design:
// - Each step's plan is packed once, when FastSweeps is built, into one
//   record of W int32 words a ticket (kernels/point_step.py point_plan):
//   node, parent, tuning row, flags (valid, each child's leaf bit), sd's
//   bits, then ch[KC], t_rows[KT], d_rows[KD] and each distance slot's
//   owner (0 the node's own branch, 1 + j child j's, -1 none), so no
//   thread matches d_rows against gathered branch positions.  A pair reads
//   its ticket's record through L1 (the step's records, at most 40 KB, are
//   shared by every chain): staged whole in shared memory they held the
//   prologue to 4 CTAs an SM at 1000 taxa and measured slower.
// - The prologue is instantiated for the main path's shapes with their
//   sizes known at compile time, so that its loops unroll and every term,
//   delta and gathered value stays in registers: the binary slide (KC = 2,
//   KT = 6, KD = 3) and the branch scale (KT = 6, KD = 1), neither with a
//   calibration slot.  A generic instantiation (runtime sizes, its arrays
//   in local memory, its outputs stored in place) takes every other step:
//   multifurcating trees and calibrated slides.  At most 64 registers a
//   thread (8 CTAs an SM; the binary slide then spills 16 bytes and still
//   measured faster than at its own 78 registers, PERF.md).
// - A CTA of 128 threads takes a contiguous range of (chain, ticket) pairs
//   in the chain-major order of the outputs, a pair a thread per round, the
//   fewest rounds that fit the step into one wave of resident CTAs.  So a
//   warp's lanes take neighbouring tickets of one chain, whose heights,
//   rates, terms and distances share that chain's rows in the cache.  The
//   CTA first forms each of its chains' constants once (BdConsts and
//   GammaClock of device_math.cuh, and the scalars, by the same operations
//   as the per-term forms, so every term is bitwise the one the plain
//   version gives); then each pair issues all its gathers before the first
//   use.
// - The fixed instantiations stage each round's tn, delta and zG in shared
//   memory and each warp stores its 32 pairs' span of [C, B KT] and
//   [C, B KD] as 16-byte words (scalars up to the first 16-byte boundary
//   and after the last); prop, lq, d_pr and lmhg are a float a lane.
// - The epilogue takes a CTA per chain and a thread per ticket in whole
//   warps: its decision, its KD distance slots (dacc, d), its height or
//   rate, terms and accept count, and its part of q, the parts summed by a
//   warp sum and then the warps' sums in order after the one barrier (no
//   second read of accept and dq).  Threads over the flat B KD slots (one
//   round, or B threads walking them) measured slower at 136 taxa: more
//   threads than one wave holds, or more rounds a thread.
// Both mirror their plain versions (kernels/point_step.py) operation by
// operation and are built with -fmad=false; the normal CDF, its inverse and
// log are CUDA's, so a slide's proposal may differ from the plain one in
// its last bits.

#include <cuda_runtime.h>
#include <math.h>

#include "device_math.cuh"
#include "lane_groups.cuh"

namespace {

using namespace mcmcdate;

constexpr int kThreads = 128;  // prologue
constexpr int kMinBlocks = 8;  // prologue CTAs an SM: at most 64 registers a thread
constexpr int kWarps = kThreads / 32;
constexpr int kEpiThreads = 512;  // epilogue: a thread per ticket, B <= 512 (BATCH_MAX)
constexpr int kKtMax = 64;            // touched terms per ticket
constexpr int kKcMax = (kKtMax - 2) / 2;  // children per ticket (a flag bit each)
constexpr int kKdMax = 1 + kKcMax;    // distance rows per ticket
constexpr size_t kSmemMax = 48 * 1024;  // without the opt-in to more

// The fields of a ticket's plan record, then ch[KC], t_rows[KT], d_rows[KD]
// and the distance slots' owners [KD]; W, a multiple of 4 words.
enum { kNode, kPar, kRow, kFlags, kSd, kHead };

// The prologue's instantiations: the step's sizes at compile time (0: the
// step's own), and the kind (-1: the step's own).
enum Variant { kGeneric, kSlideBinary, kBranchScale };
template <int V>
struct Shape {
  static constexpr int KC = 0, KT = 0, KD = 0, branch = -1;
};
template <>
struct Shape<kSlideBinary> {
  static constexpr int KC = 2, KT = 6, KD = 3, branch = 0;
};
template <>
struct Shape<kBranchScale> {
  static constexpr int KC = 2, KT = 6, KD = 1, branch = 1;
};

struct PrologueArgs {
  const float* heights;  // [C, N]
  const float* rates;    // [C, N]
  const float* terms;    // [C, T]
  const float* d;        // [C, D]
  const float* z;        // [C, D], null without a likelihood
  const float* tuning;   // [C, P]
  const float* birth;    // [C]
  const float* death;
  const float* rate_var;
  const float* height;
  const float* rate_mean;
  const int* plan;       // [B, W]
  const float* cal_lo;   // [B, KN]
  const float* cal_lo_s;
  const float* cal_hi;
  const float* cal_hi_s;
  const float* draw;     // [C, B]
  float* prop;   // [C, B]
  float* lq;     // [C, B]
  float* tn;     // [C, B, KT]
  float* delta;  // [C, B, KD]
  float* d_pr;   // [C, B]
  float* lmhg;   // [C, B]
  float* zG;     // [C, B, KD] (with z)
  int C, B, N, T, P, D, KC, KT, KD, KN, W, clock_model, branch;
};

// A chain's constants, formed once per CTA.
struct alignas(16) ChainConsts {
  BdConsts bd;
  GammaClock gk;
  float var, height, sc;
};

__device__ __forceinline__ ChainConsts chain_consts(const PrologueArgs& a, int c, bool branch) {
  ChainConsts k;
  if (!branch) k.bd = bd_consts((double)a.birth[c], (double)a.death[c]);
  k.var = a.rate_var[c];
  if (a.clock_model == 0) k.gk = gamma_clock(k.var);
  k.height = a.height[c];
  k.sc = a.height[c] * a.rate_mean[c];
  return k;
}

__device__ __forceinline__ float clock_of(const PrologueArgs& a, const ChainConsts& k, float r,
                                          float tl) {
  return a.clock_model == 0 ? gamma_clock_term(k.gk, r)
                            : clock_term_local(a.clock_model, r, tl, k.var);
}

// The prologue's shared memory, in bytes: the chains' constants, then
// (fixed instantiations) each warp's staged outputs (tn, delta, zG, each
// with room for its 16-byte head).
struct Layout {
  size_t stage, total;
  int stage_floats;  // per warp
};

__host__ __device__ __forceinline__ Layout prologue_layout(int B, int KT, int KD, int per,
                                                           bool staged) {
  const long span = (long)kThreads * per;
  const int chains = (int)(span / B) + 2;
  Layout l;
  l.stage = sizeof(ChainConsts) * (size_t)chains;
  l.stage_floats = staged ? 32 * KT + 4 + 2 * (32 * KD + 4) : 0;
  l.total = l.stage + sizeof(float) * (size_t)kWarps * l.stage_floats;
  return l;
}

// A warp stores n floats to dst, staged at buf[head ...] with head = dst's
// float offset past a 16-byte boundary (buf 16-byte aligned): scalars up to
// the first boundary, 16-byte words, scalars after the last.
__device__ __forceinline__ void warp_store(float* dst, const float* buf, int head, int n,
                                           int lane) {
  const int pre = min(n, (4 - head) & 3);
  if (lane < pre) dst[lane] = buf[head + lane];
  const int nv = (n - pre) >> 2;
  float4* dv = reinterpret_cast<float4*>(dst + pre);
  const float4* bv = reinterpret_cast<const float4*>(buf + head + pre);
  for (int v = lane; v < nv; v += 32) dv[v] = bv[v];
  const int done = pre + 4 * nv;
  if (lane < n - done) dst[done + lane] = buf[head + done + lane];
}

// A thread per (chain, ticket) pair and round: CTA x takes pairs [x span,
// (x + 1) span), span = kThreads per, in rounds of kThreads.
template <int V>
__global__ void __launch_bounds__(kThreads, kMinBlocks)
    point_lik_prologue_kernel(PrologueArgs a, int per) {
  using S = Shape<V>;
  constexpr bool kStaged = V != kGeneric;  // outputs staged in shared memory
  // Array sizes, and the loop bounds: constants in the fixed instantiations
  // (the loops unroll), the step's own in the generic kernel.
  constexpr int kKc = S::KC ? S::KC : kKcMax;
  constexpr int kKt = S::KT ? S::KT : kKtMax;
  constexpr int kKd = S::KD ? S::KD : kKdMax;
  const int KC = S::KC ? S::KC : a.KC;
  const int KT = S::KT ? S::KT : a.KT;
  const int KD = S::KD ? S::KD : a.KD;
  const bool branch = S::branch >= 0 ? S::branch != 0 : a.branch != 0;
  const int B = a.B, W = a.W;
  extern __shared__ __align__(16) unsigned char smem[];
  const Layout lay = prologue_layout(B, KT, KD, per, kStaged);
  ChainConsts* chain = reinterpret_cast<ChainConsts*>(smem);
  const long span = (long)kThreads * per;
  const long p0 = (long)blockIdx.x * span;
  const long p1 = min(p0 + span, (long)a.C * B);
  const int c_first = (int)(p0 / B);
  const int n_chain = (int)((p1 - 1) / B) - c_first + 1;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;

  for (int cc = tid; cc < n_chain; cc += kThreads)
    chain[cc] = chain_consts(a, c_first + cc, branch);
  __syncthreads();

  float* st_tn = reinterpret_cast<float*>(smem + lay.stage) + warp * lay.stage_floats;
  float* st_dl = st_tn + 32 * KT + 4;
  float* st_zg = st_dl + 32 * KD + 4;
  for (int it = 0; it < per; ++it) {
    const long w0 = p0 + (long)it * kThreads + warp * 32;  // the warp's first pair
    if (w0 >= p1) break;                                   // the same on every lane
    const long pr = w0 + lane;
    const int h_tn = (int)((w0 * KT) & 3), h_dl = (int)((w0 * KD) & 3);
    if (pr < p1) {
      const int c = (int)(pr / B);
      const int b = (int)(pr - (long)c * B);
      const ChainConsts& k = chain[c - c_first];
      const int* rec = a.plan + (size_t)b * W;
      const int i = rec[kNode], p = rec[kPar];
      const unsigned flags = (unsigned)rec[kFlags];
      const float sd = __int_as_float(rec[kSd]);
      const int* rch = rec + kHead;
      const int* rtr = rch + KC;
      const int* rdr = rtr + KT;
      const int* rown = rdr + KD;
      const float* h = a.heights + (size_t)c * a.N;
      const float* r = a.rates + (size_t)c * a.N;
      const float* te = a.terms + (size_t)c * a.T;
      const float* dc = a.d + (size_t)c * a.D;
      // Every gather of the pair, issued before the first use.
      int tr[kKt], dr[kKd], chj[kKc];
#pragma unroll
      for (int t = 0; t < KT; ++t) tr[t] = rtr[t];
#pragma unroll
      for (int s = 0; s < KD; ++s) dr[s] = rdr[s];
      const float tune = a.tuning[(size_t)c * a.P + rec[kRow]];
      const float dw = a.draw[pr];
      const float hi = h[i];
      const float hp = h[p];
      const float ri = r[i];
      float told[kKt], dold[kKd], hch[kKc], rch_v[kKc];
#pragma unroll
      for (int t = 0; t < KT; ++t) told[t] = tr[t] >= 0 ? te[tr[t]] : 0.f;
#pragma unroll
      for (int s = 0; s < KD; ++s) dold[s] = dr[s] >= 0 ? dc[dr[s]] : 0.f;
      if (!branch) {
#pragma unroll
        for (int j = 0; j < KC; ++j) {
          chj[j] = rch[j];
          hch[j] = chj[j] >= 0 ? h[chj[j]] : 0.f;
          rch_v[j] = chj[j] >= 0 ? r[chj[j]] : 0.f;
        }
      }
      if (a.z != nullptr) {
        const float* zc = a.z + (size_t)c * a.D;
#pragma unroll
        for (int s = 0; s < KD; ++s) {
          const float zv = dr[s] >= 0 ? zc[dr[s]] : 0.f;
          if (kStaged) {
            st_zg[h_dl + lane * KD + s] = zv;
          } else {
            a.zG[(size_t)pr * KD + s] = zv;
          }
        }
      }
      float prop, lq;
      float tv[kKt], dl[kKd];
      if (branch) {
        // gamma_scale_sample: u = g (tune / shape); gamma_scale_lq at u.
        prop = dw * (tune / sd);
        const float kk = sd / tune;
        const float theta = tune / sd;
        const float logu = logf(prop);
        const float base =
            gamma_logpdf(kk, theta, 1.0f / prop) - gamma_logpdf(kk, theta, prop) - 2.0f * logu;
        lq = base + logu;
        tv[0] = clock_of(a, k, ri * prop, hp - hi);
#pragma unroll
        for (int t = 1; t < KT; ++t) tv[t] = 0.f;
#pragma unroll
        for (int s = 0; s < KD; ++s) dl[s] = dr[s] >= 0 ? dold[s] * prop - dold[s] : 0.f;
      } else {
        float hc_max = -INFINITY;
#pragma unroll
        for (int j = 0; j < KC; ++j)
          if (chj[j] >= 0) hc_max = fmaxf(hc_max, hch[j]);
        truncnorm_sample(dw, hi, sd, tune, hc_max, hp, &prop, &lq);
        const float hnew = prop;
        tv[0] = bd_term_local(hnew, hp, false, k.bd);
        tv[1] = clock_of(a, k, ri, hp - hnew);
#pragma unroll
        for (int j = 0; j < KC; ++j) {
          if (chj[j] >= 0) {
            tv[2 + j] = bd_term_local(hch[j], hnew, (flags >> (1 + j)) & 1u, k.bd);
            tv[2 + KC + j] = clock_of(a, k, rch_v[j], hnew - hch[j]);
          } else {
            tv[2 + j] = 0.f;
            tv[2 + KC + j] = 0.f;
          }
        }
        if constexpr (!kStaged) {  // no calibration slot in the fixed instantiations
          for (int j = 0; j < a.KN; ++j) {
            const size_t q = (size_t)b * a.KN + j;
            tv[2 * (1 + KC) + j] = cal_term_local(hnew, k.height, a.cal_lo[q], a.cal_lo_s[q],
                                                  a.cal_hi[q], a.cal_hi_s[q]);
          }
        }
        // The node's own branch gets t = hp - hnew, a child's t = hnew - h_c;
        // d = (height rate_mean) t r.
#pragma unroll
        for (int s = 0; s < KD; ++s) {
          const int o = rown[s];
          float t_val = o == 0 ? hp - hnew : 0.f;
          float r_val = o == 0 ? ri : 0.f;
#pragma unroll
          for (int j = 0; j < KC; ++j) {
            if (o == 1 + j) {
              t_val = hnew - hch[j];
              r_val = rch_v[j];
            }
          }
          dl[s] = dr[s] >= 0 ? k.sc * t_val * r_val - dold[s] : 0.f;
        }
      }
      float dp = 0.f;
      bool bad = false;
#pragma unroll
      for (int t = 0; t < KT; ++t) {
        if (tr[t] < 0) continue;
        const float diff = tv[t] - told[t];
        if (!isnan(diff)) dp += diff;
        bad = bad || is_bad(tv[t]);
      }
      a.prop[pr] = prop;
      a.lq[pr] = lq;
      a.d_pr[pr] = dp;
      a.lmhg[pr] = (bad || !(flags & 1u)) ? -INFINITY : lq;
      if (kStaged) {
#pragma unroll
        for (int t = 0; t < KT; ++t) st_tn[h_tn + lane * KT + t] = tv[t];
#pragma unroll
        for (int s = 0; s < KD; ++s) st_dl[h_dl + lane * KD + s] = dl[s];
      } else {
        for (int t = 0; t < KT; ++t) a.tn[(size_t)pr * KT + t] = tv[t];
        for (int s = 0; s < KD; ++s) a.delta[(size_t)pr * KD + s] = dl[s];
      }
    }
    if (kStaged) {
      const int nw = (int)min(32L, p1 - w0);
      __syncwarp();
      warp_store(a.tn + w0 * KT, st_tn, h_tn, nw * KT, lane);
      warp_store(a.delta + w0 * KD, st_dl, h_dl, nw * KD, lane);
      if (a.z != nullptr) warp_store(a.zG + w0 * KD, st_zg, h_dl, nw * KD, lane);
      __syncwarp();
    }
  }
}

struct EpilogueArgs {
  float* heights;  // [C, N]
  float* rates;    // [C, N]
  float* terms;    // [C, T]
  float* d;        // [C, D]
  float* q;        // [C]
  int* acc;        // [C, P]
  float* dacc;     // [C, B, KD]
  unsigned char* accept;        // [C, B] (written when u_acc is given)
  const float* dq;              // [C, B], null without a likelihood
  const float* u_acc;           // [C, B], null with a likelihood
  const float* beta_prior;      // [C] prior temperature of the decisions taken here
  const float* d_pr;            // [C, B]
  const float* lmhg;            // [C, B]
  const float* prop;            // [C, B]
  const float* tn;              // [C, B, KT]
  const float* delta;           // [C, B, KD]
  const int* node;              // [B]
  const int* t_rows;            // [B, KT]
  const int* d_rows;            // [B, KD]
  const int* rows;              // [B]
  const unsigned char* valid;   // [B]
  int C, B, N, T, P, D, KT, KD, branch;
};

// Ticket b of chain c accepted: the scan's decision, or without a
// likelihood log u < bprior d_pr + lmhg with the chain's prior temperature
// (the JAX step's fast_sweep.py:1471; the plain version's log u < (NaN ?
// -inf : bprior d_pr + lmhg): a NaN compares false as well).
__device__ __forceinline__ bool accepted(const EpilogueArgs& a, size_t cb, int c, int b) {
  if (a.u_acc != nullptr)
    return logf(a.u_acc[cb]) < __fmul_rn(a.beta_prior[c], a.d_pr[cb]) + a.lmhg[cb] && a.valid[b];
  return a.accept[cb] && a.valid[b];
}

// A CTA per chain, a thread per ticket with its KD distance slots.
__global__ void __launch_bounds__(kEpiThreads) point_lik_epilogue_kernel(EpilogueArgs a) {
  __shared__ float q_w[kEpiThreads / 32];
  const int c = blockIdx.x;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int B = a.B, KT = a.KT, KD = a.KD;
  float q_part = 0.f;
  const int k = tid;
  if (k < B) {
    const size_t cb = (size_t)c * B + k;
    const bool ok = accepted(a, cb, c, k);
    if (a.u_acc != nullptr) a.accept[cb] = ok;
    const int* dr = a.d_rows + (size_t)k * KD;
    float* dc = a.d + (size_t)c * a.D;
    for (int s = 0; s < KD; ++s) {
      const int r = dr[s];
      const bool w = ok && r >= 0;
      const float dl = w ? a.delta[cb * KD + s] : 0.f;
      a.dacc[cb * KD + s] = dl;
      if (w) dc[r] += dl;
    }
    if (ok) {
      const int* tr = a.t_rows + (size_t)k * KT;
      const float* tn = a.tn + cb * KT;
      float* te = a.terms + (size_t)c * a.T;
      for (int t = 0; t < KT; ++t) {
        if (tr[t] >= 0) te[tr[t]] = tn[t];
      }
      const int i = a.node[k];
      if (a.branch) {
        float* r = a.rates + (size_t)c * a.N;
        r[i] = r[i] * a.prop[cb];
      } else {
        a.heights[(size_t)c * a.N + i] = a.prop[cb];
      }
      a.acc[(size_t)c * a.P + a.rows[k]] += 1;
      if (a.dq != nullptr) q_part = a.dq[cb];
    }
  }
  if (a.dq == nullptr) return;  // the same on every thread
  // q += the accepted dq: a warp sum, then the warps' sums in order.
  q_part = warp_sum(q_part);
  if (lane == 0) q_w[warp] = q_part;
  __syncthreads();
  if (tid == 0) {
    float s = 0.f;
    for (int w = 0; w < (int)blockDim.x / 32; ++w) s += q_w[w];
    a.q[c] = a.q[c] + s;
  }
}

// A prologue instantiation's launch: the fewest rounds a thread that fit
// the step's pairs into one wave of resident CTAs (the device's answer
// cached per shared-memory size).
template <int V>
cudaError_t launch_prologue(const PrologueArgs& a, cudaStream_t stream) {
  constexpr bool staged = V != kGeneric;
  static int dev_cached = -1, n_sm = 1;
  static size_t smem_cached = 0;
  static int per_sm = 1;
  int dev = 0;
  cudaGetDevice(&dev);
  if (dev != dev_cached) {
    cudaDeviceGetAttribute(&n_sm, cudaDevAttrMultiProcessorCount, dev);
    dev_cached = dev;
    smem_cached = 0;
  }
  const long pairs = (long)a.C * a.B;
  const size_t smem1 = prologue_layout(a.B, a.KT, a.KD, 1, staged).total;
  if (smem1 != smem_cached) {
    cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, point_lik_prologue_kernel<V>,
                                                  kThreads, smem1);
    if (per_sm < 1) per_sm = 1;
    smem_cached = smem1;
  }
  const long slots = (long)n_sm * per_sm * kThreads;
  const int per = (int)((pairs + slots - 1) / slots);
  const size_t smem = prologue_layout(a.B, a.KT, a.KD, per, staged).total;
  if (smem > kSmemMax) return cudaErrorInvalidValue;
  const long span = (long)kThreads * per;
  point_lik_prologue_kernel<V>
      <<<(int)((pairs + span - 1) / span), kThreads, smem, stream>>>(a, per);
  return cudaGetLastError();
}

}  // namespace

extern "C" int mcmcdate_point_lik_prologue_f32(
    const float* heights, const float* rates, const float* terms, const float* d, const float* z,
    const float* tuning, const float* birth, const float* death, const float* rate_var,
    const float* height, const float* rate_mean, const int* plan, const float* cal_lo,
    const float* cal_lo_s, const float* cal_hi, const float* cal_hi_s, const float* draw,
    float* prop, float* lq, float* tn, float* delta, float* d_pr, float* lmhg, float* zG, int C,
    int B, int N, int T, int P, int D, int KC, int KT, int KD, int KN, int W, int clock_model,
    int branch, void* stream) {
  if (KT > kKtMax || KC > kKcMax || KD > kKdMax || (!branch && 2 * (1 + KC) + KN != KT) ||
      W % 4 != 0 || W < kHead + KC + KT + 2 * KD) {
    return (int)cudaErrorInvalidValue;
  }
  PrologueArgs a{heights,  rates,  terms,     d,      z,        tuning,  birth,    death,
                 rate_var, height, rate_mean, plan,   cal_lo,   cal_lo_s, cal_hi,  cal_hi_s,
                 draw,     prop,   lq,        tn,     delta,    d_pr,    lmhg,     zG,
                 C,        B,      N,         T,      P,        D,       KC,       KT,
                 KD,       KN,     W,         clock_model, branch};
  if ((long)C * B == 0) return (int)cudaSuccess;
  const cudaStream_t st = (cudaStream_t)stream;
  using Slide = Shape<kSlideBinary>;
  using Branch = Shape<kBranchScale>;
  if (!branch && KC == Slide::KC && KT == Slide::KT && KD == Slide::KD && KN == 0)
    return (int)launch_prologue<kSlideBinary>(a, st);
  if (branch && KC == Branch::KC && KT == Branch::KT && KD == Branch::KD)
    return (int)launch_prologue<kBranchScale>(a, st);
  return (int)launch_prologue<kGeneric>(a, st);
}

extern "C" int mcmcdate_point_lik_epilogue_f32(
    float* heights, float* rates, float* terms, float* d, float* q, int* acc, float* dacc,
    unsigned char* accept, const float* dq, const float* u_acc, const float* beta_prior,
    const float* d_pr, const float* lmhg, const float* prop, const float* tn, const float* delta,
    const int* node, const int* t_rows, const int* d_rows, const int* rows,
    const unsigned char* valid, int C, int B, int N, int T, int P, int D, int KT, int KD,
    int branch, void* stream) {
  // With the decisions taken here, q is left as it is.
  if (u_acc != nullptr && dq != nullptr) return (int)cudaErrorInvalidValue;
  EpilogueArgs a{heights, rates,      terms, d,    q,  acc,   dacc,   accept, dq,
                 u_acc,   beta_prior, d_pr,  lmhg, prop, tn, delta,  node,   t_rows,
                 d_rows,  rows,       valid, C,    B,  N,  T,      P,      D,
                 KT,      KD,         branch};
  // A thread per ticket, in whole warps.
  if (B > kEpiThreads) return (int)cudaErrorInvalidValue;
  const int threads = (B + 31) / 32 * 32;
  if (C > 0 && B > 0) {
    point_lik_epilogue_kernel<<<C, threads, 0, (cudaStream_t)stream>>>(a);
  }
  return (int)cudaGetLastError();
}
