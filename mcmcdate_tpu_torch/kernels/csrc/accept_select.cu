// K3 accept_select: the epilogue of one ticket of the sequential sweep, on
// every chain, one CTA per chain, after T1 ticket_prologue
// (csrc/ticket_step.cu) and, for a full-MVN ticket of the dense or range
// classes, K2's dy (csrc/whiten.cu).
//
// Replaces the accept-and-select part of the XLA-compiled
// MHKernel._ticket_step (mcmcdate_tpu/engine/mh.py:120-128 and 180-207):
//   d_lik   = K2's (full MVN), -0.5 sum dy (2 y + dy) with dy = delta
//             inv_sd on the class rows (univariate), or 0
//   alpha   = beta_prior d_pr + beta d_lik + lmhg + lj   (beta and
//             beta_prior the chain's likelihood and prior temperatures,
//             mh.py:194; d_pr -inf where T1 found the new
//             term vector invalid; NaN -> -inf)
//   accept  = log(u) < alpha
// then, for accepted chains, the ticket's term entries, d on its class
// rows, y + dy (all D after K2, the class rows under the univariate kind),
// acc[c, row] += 1 and the bad-term count 0; for rejected chains the old
// heights, rates and scalars T1 kept.  T3's tickets end in the same
// semantics through ticket_epilogue_dev (csrc/ticket_step.cuh); this
// kernel has a body of its own.
//
// What bounds it on the H100: bytes, and at 136 taxa latency.  On the
// sweep's tickets (the pulley, a range class's subtree scale) an accepted
// chain copies whole term blocks and d's class rows and adds K2's dy to all
// D columns of y: about 70 KB a chain at 1000 taxa.  Written as loops of
// one load and one store through pointers that may alias, each entry
// waited for its load (the parent kernel: 42% of the bytes bound).  Here:
//   - one round loads the row's record into shared memory (once a CTA) and,
//     beside it, every input of the decision (lmhg, lj, d_pr, invalid,
//     u_acc, K2's d_lik) and the chain's accept count and kept scalars;
//   - every thread takes the decision alike; thread 0 writes the chosen
//     write-back (the accepted chain's, or the rejected one's restore) as
//     one list of segments, as G3 does (csrc/glob_step.cu), with index
//     lists for explicit term entries, a gather's rows and a node set;
//   - the CTA copies it: short segments in one flat walk, all of a
//     thread's loads before its stores, long ones (a whole term block, d
//     and y at 1000 taxa) in 16-byte words.  The copy is G3's with index
//     lists; one copy shared by both measured 3-10% slower for G3 (more
//     spills), so each kernel keeps its own.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "ticket_step.cuh"

namespace {

using namespace mcmcdate;

constexpr int kThreads = kTicketThreads;
constexpr int kUnroll = 8;
constexpr int kLong = 512;
constexpr int kSegs = 12;
static_assert(kRecWords == kThreads, "a thread stages one word of the record");

// A write-back segment: dst[pos] = src[pos] (+ add[pos]) for its entries,
// pos = k or, with an index list, idx[k] (kept where 0 <= pos < lim).
struct Seg {
  float* dst;
  const float* src;
  const float* add;
  const int* idx;
  int off;  // short: its first entry in the flat list; long: its length
  int lim;
};

struct SegList {
  Seg seg[kSegs + 1];  // short segments, then the end of their list
  Seg lseg[kSegs];     // long segments (contiguous)
  int n, nl, off;

  __device__ __forceinline__ void put(float* dst, const float* src, const float* add,
                                      const int* idx, int len, int lim) {
    if (len <= 0) return;
    if (idx == nullptr && len >= kLong) {
      lseg[nl++] = Seg{dst, src, add, nullptr, len, lim};
    } else {
      seg[n++] = Seg{dst, src, add, idx, off, lim};
      off += len;
    }
  }
  // Rows [lo, hi) of the three arrays, hi clipped to lim.
  __device__ __forceinline__ void range(float* dst, const float* src, const float* add, int lo,
                                        int hi, int lim) {
    hi = hi < lim ? hi : lim;
    if (lo < hi) put(dst + lo, src + lo, add ? add + lo : nullptr, nullptr, hi - lo, lim);
  }
};

// The class rows (rw[R_DN] of them, class_row's order) of arrays whose
// chain rows are dst, src and add.
__device__ __forceinline__ void class_rows(SegList& sl, const TicketArgs& a, const Row& rw,
                                           float* dst, const float* src, const float* add) {
  const int dc = rw[R_DCLASS], n = rw[R_DN];
  if (dc == DC_FULL) {
    sl.range(dst, src, add, 0, n, a.D);
  } else if (dc == DC_GATHER) {
    sl.put(dst, src, add, rw.grows(a), n, a.D);
  } else {
    const int r0 = rw[R_ROW0] < n ? rw[R_ROW0] : n;
    if (r0 > 0) sl.range(dst, src, add, 0, 1, a.D);
    sl.range(dst, src, add, rw[R_DLO], rw[R_DLO] + n - r0, a.D);
  }
}

// The write-back of chain c: the accepted chain's new term entries, d on
// the class rows and y + dy (dy: K2's full row, or the class rows of dys
// under the univariate kind); or the rejected chain's old heights and
// rates.
__device__ void build(SegList& sl, const TicketArgs& a, const Row& rw, int c, bool acc,
                      bool full_dy) {
  sl.n = sl.nl = sl.off = 0;
  const int N = a.N, T = a.T, D = a.D;
  if (acc) {
    float* te = a.terms + (size_t)c * T;
    const float* tn = a.tn + (size_t)c * T;
    const int tb = rw[R_TBLOCKS];
    const int o_ck = 4 + N + 1, o_nd = 4 + 2 * (N + 1);
    // Adjacent blocks as one range.
    const int lo[4] = {0, 4, o_ck, o_nd}, hi[4] = {4, o_ck, o_nd, T};
    for (int b = 0; b < 4;) {
      if (!(tb & (1 << b))) {
        ++b;
        continue;
      }
      int e = b;
      while (e + 1 < 4 && (tb & (1 << (e + 1)))) ++e;
      sl.range(te, tn, nullptr, lo[b], hi[e], T);
      b = e + 1;
    }
    sl.put(te, tn, nullptr, rw.terms(a), rw[R_TCNT], T);
    if (a.lik != LIK_NONE && rw[R_DCLASS] != DC_INV) {
      float* d = a.d + (size_t)c * D;
      float* y = a.y + (size_t)c * D;
      class_rows(sl, a, rw, d, a.dn + (size_t)c * D, nullptr);
      if (!full_dy && a.lik == LIK_DIAG) class_rows(sl, a, rw, y, y, a.dys + (size_t)c * D);
      if (full_dy) sl.range(y, y, a.dy_in + (size_t)c * D, 0, D, D);
    }
  } else {
    const int fl = rw[R_FIELDS];
    float* h = a.heights + (size_t)c * N;
    float* r = a.rates + (size_t)c * N;
    const float* hs = a.hs + (size_t)c * N;
    const float* rs = a.rs + (size_t)c * N;
    if (fl & (F_HEIGHTS | F_RATES)) {
      if (fl & F_HEIGHTS) sl.range(h, hs, nullptr, 0, N, N);
      if (fl & F_RATES) sl.range(r, rs, nullptr, 0, N, N);
    } else {
      const int* nl = rw.nodes(a);
      if (fl & F_HLOC) sl.put(h, hs, nullptr, nl, rw[R_NCNT], N);
      if (fl & F_RLOC) sl.put(r, rs, nullptr, nl, rw[R_NCNT], N);
    }
  }
  sl.seg[sl.n].off = sl.off;
}

// A long segment: 16-byte loads and stores where dst, src and add share
// their alignment, kUnroll / 2 of them a thread in flight, the entries
// before the first 16-byte boundary and after the last one alone.  A
// thread's loads are written before its stores: y = y + dy reads and
// writes one array, so only add is declared not to alias.
__device__ __forceinline__ void copy_long(const Seg& g, int tid) {
  const int len = g.off;
  float* dst = g.dst;
  const float* src = g.src;
  const float* __restrict__ add = g.add;
  int h = (int)(((16 - ((uintptr_t)dst & 15)) & 15) >> 2);
  h = h < len ? h : len;
  const uintptr_t phase = (uintptr_t)(dst + h) | (uintptr_t)(src + h) |
                          (add ? (uintptr_t)(add + h) : (uintptr_t)0);
  if (phase & 15) h = len;  // no common alignment: entry by entry
  for (int j = tid; j < h; j += kThreads) dst[j] = add ? src[j] + add[j] : src[j];
  const int nv = (len - h) >> 2;
  float4* d4 = reinterpret_cast<float4*>(dst + h);
  const float4* s4 = reinterpret_cast<const float4*>(src + h);
  const float4* a4 = reinterpret_cast<const float4*>(add + h);
  constexpr int U = kUnroll / 2;
  for (int q0 = tid; q0 < nv; q0 += U * kThreads) {
    float4 x[U], y[U];
#pragma unroll
    for (int u = 0; u < U; ++u) {
      const int q = q0 + u * kThreads;
      if (q < nv) {
        x[u] = s4[q];
        if (add) y[u] = a4[q];
      }
    }
#pragma unroll
    for (int u = 0; u < U; ++u) {
      const int q = q0 + u * kThreads;
      if (q >= nv) continue;
      float4 v = x[u];
      if (add) {
        v.x = v.x + y[u].x;
        v.y = v.y + y[u].y;
        v.z = v.z + y[u].z;
        v.w = v.w + y[u].w;
      }
      d4[q] = v;
    }
  }
  for (int j = h + 4 * nv + tid; j < len; j += kThreads) dst[j] = add ? src[j] + add[j] : src[j];
}

// The whole list by the CTA: the short segments in one flat walk, kUnroll
// entries a thread with all their loads before their stores, then the
// long ones.
__device__ __forceinline__ void copy_list(const SegList& l, int tid) {
  const int total = l.seg[l.n].off;
  int q = 0;
  for (int base = tid; base < total; base += kThreads * kUnroll) {
    float x[kUnroll], y[kUnroll];
    float* dst[kUnroll];
    bool add[kUnroll];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const int i = base + u * kThreads;
      dst[u] = nullptr;
      if (i >= total) continue;
      while (i >= l.seg[q + 1].off) ++q;
      const Seg& g = l.seg[q];
      int k = i - g.off;
      if (g.idx != nullptr) {
        k = g.idx[k];
        if (k < 0 || k >= g.lim) continue;
      }
      dst[u] = g.dst + k;
      x[u] = g.src[k];
      add[u] = g.add != nullptr;
      y[u] = add[u] ? g.add[k] : 0.f;
    }
#pragma unroll
    for (int u = 0; u < kUnroll; ++u)
      if (dst[u]) *dst[u] = add[u] ? x[u] + y[u] : x[u];
  }
  for (int s = 0; s < l.nl; ++s) copy_long(l.lseg[s], tid);
}

__global__ void __launch_bounds__(kThreads) accept_select_kernel(TicketArgs a) {
  __shared__ int rec[kRecWords];
  __shared__ float red[kTicketSums][kTicketWarps];
  __shared__ SegList sl;
  const int tid = threadIdx.x;
  const int c = blockIdx.x;
  const int j = a.j0;
  const int p = row_of(a, j);
  // One round: the record, every input of the decision, and thread 0's
  // accept count and kept scalars.
  rec[tid] = a.rec[(size_t)p * kRecWords + tid];
  int* acc_at = a.acc + (size_t)c * a.P + p;
  const float* ss = a.ss + (size_t)c * 5;
  int acc0 = 0;
  float s0[5];
  if (tid == 0) {
    acc0 = *acc_at;
#pragma unroll
    for (int k = 0; k < 5; ++k) s0[k] = ss[k];
  }
  const float u = a.u_acc[(size_t)c * a.n + j];
  const float lmhg = a.lmhg[c];
  const float lj = a.lj[c];
  const float d_pr = a.d_pr[c];
  const float beta = a.beta[c];
  const float bprior = a.beta_prior[c];
  const bool invalid = a.invalid[c] != 0;
  const bool full_dy = a.lik == LIK_FULL && a.dy_in != nullptr;
  float d_lik = full_dy ? a.dlik_in[c] : 0.f;
  __syncthreads();
  const Row rw{rec};
  if (a.lik == LIK_DIAG) d_lik = diag_lik_dev(a, CtaTeam{red}, c, rw);
  float la = (((invalid ? -INFINITY : __fmul_rn(bprior, d_pr)) + beta * d_lik) + lmhg) + lj;
  if (isnan(la)) la = -INFINITY;
  const bool acc = logf(u) < la;
  if (tid == 0) build(sl, a, rw, c, acc, full_dy);
  __syncthreads();
  copy_list(sl, tid);
  if (tid == 0) {
    if (acc) {
      *acc_at = acc0 + 1;
      a.nbad[c] = 0;
    } else {
      const int fl = rw[R_FIELDS];
      if (fl & F_BIRTH) a.birth[c] = s0[0];
      if (fl & F_DEATH) a.death[c] = s0[1];
      if (fl & F_HEIGHT) a.height[c] = s0[2];
      if (fl & F_RATE_MEAN) a.rate_mean[c] = s0[3];
      if (fl & F_RATE_VAR) a.rate_var[c] = s0[4];
    }
    if (a.accept_out != nullptr) a.accept_out[c] = acc;
    if (a.la_out != nullptr) a.la_out[c] = la;
  }
}

}  // namespace

extern "C" int mcmcdate_accept_select_f32(const void* args, void* stream) {
  const TicketArgs& a = *static_cast<const TicketArgs*>(args);
  if (a.C > 0) accept_select_kernel<<<a.C, kThreads, 0, (cudaStream_t)stream>>>(a);
  return (int)cudaGetLastError();
}
