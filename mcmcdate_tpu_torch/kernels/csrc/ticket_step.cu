// T1 ticket_prologue and T3 ticket_scan, the sequential sweep's ticket
// kernels (with K3 accept_select, csrc/accept_select.cu).  The device code
// and what it replaces: csrc/ticket_step.cuh.
//
// T1 ticket_prologue_kernel: one ticket on every chain, one CTA per chain:
// the prologue, its per-chain results (lmhg, lj, d_pr, invalid, the
// proposal) stored for K3, after K2 where the row's class needs it.
// T3, a run of consecutive tickets, each chain walking them in order:
// prologue, likelihood (univariate or gather), epilogue, ticket after
// ticket, the chain's state coherent between them.  Two kernels:
// - ticket_run_kernel, the light runs (no ticket's work above
//   kernels/ticket_step.py's HEAVY).  A light ticket is a chain of
//   dependent steps over O(1)-O(100) items, so its time is the latency of
//   one warp's instruction path, not bytes.  The design: a warp per ticket;
//   the tickets in windows of up to S whose touched state is disjoint
//   (TicketTable.windows on the host), applied to a chain at once by its S
//   warps; one CTA of K chains an SM, one barrier a window, so that the
//   SM's chains run the same ticket, and the same code, together (chains
//   that drift apart through a long run thrash the instruction cache, twice
//   as slow); the packed records of the next kRunBatch tickets staged into
//   shared memory with cp.async while the current batch runs, so no ticket
//   waits on table data; a ticket with at most one node, term entry and
//   class row a lane (most of them) loads its chain state in one round of
//   independent loads and keeps what it writes in registers until the
//   decision (ticket_fast_dev), the others run the shared prologue and
//   epilogue with the univariate likelihood formed with the distances; the
//   term constants kept across tickets; shuffles in place of block sums.
// - ticket_scan_kernel, a heavy ticket alone (whole term blocks, big
//   subtrees): a CTA of 128 threads per chain, all 1,024 chains' CTAs
//   resident at once, the birth-death and clock constants formed once a
//   ticket.

#include <cuda_runtime.h>
#include <math.h>

#include "ticket_step.cuh"

namespace {

using namespace mcmcdate;

constexpr int kRunBatch = 16;   // tickets whose records are staged at once
constexpr int kRunChains = 8;   // chains a CTA of ticket_run_kernel: one CTA an SM
constexpr int kRunSlots = 2;    // warps a chain: tickets of a window at once (RUN_SLOTS)
constexpr int kRecChunks = kRecWords / 4;  // 16-byte pieces of a record

__global__ void __launch_bounds__(kTicketThreads) ticket_prologue_kernel(TicketArgs a) {
  __shared__ float red[kTicketSums][kTicketWarps];
  __shared__ Move s_mv;
  __shared__ float s_rb;
  const CtaTeam tm{red};
  const int c = blockIdx.x;
  const int j = a.j0;
  const TicketOut o =
      ticket_prologue_dev(a, tm, c, j, gi_of(a, j), row_rec(a, row_of(a, j)), &s_mv, &s_rb);
  if (threadIdx.x == 0) {
    a.lmhg[c] = o.lmhg;
    a.lj[c] = o.lj;
    a.d_pr[c] = o.d_pr;
    a.invalid[c] = o.invalid;
    a.sprop[c] = o.prop;
    a.smean[c] = o.mean;
  }
}

// At most 64 registers a thread, so that 8 CTAs fit on an SM: 1,024
// chains' CTAs resident in one wave on 132 SMs.
__global__ void __launch_bounds__(kTicketThreads, 8) ticket_scan_kernel(TicketArgs a) {
  __shared__ float red[kTicketSums][kTicketWarps];
  __shared__ Move s_mv;
  __shared__ float s_rb;
  const CtaTeam tm{red};
  const int c = blockIdx.x;
  for (int j = a.j0; j < a.j0 + a.nj; ++j) {
    const Row rw = row_rec(a, row_of(a, j));
    const TicketOut o = ticket_prologue_dev(a, tm, c, j, gi_of(a, j), rw, &s_mv, &s_rb);
    ticket_finish(a, tm, c, j, rw, o);
  }
}

// Stages the records, gamma columns and window starts of tickets j ..
// j+nt of the run into one buffer, every thread of the CTA a share of the
// 16-byte pieces.
__device__ __forceinline__ void stage_records(const TicketArgs& a, int (*rec)[kRecWords], int* gi,
                                              int* lead, int j, int nt) {
  for (int i = threadIdx.x; i < nt * kRecChunks; i += blockDim.x) {
    const int q = i / kRecChunks, w = i % kRecChunks;
    const int p = a.order[j + q];
    cp_async_f32x4(reinterpret_cast<float*>(&rec[q][4 * w]),
                   reinterpret_cast<const float*>(a.rec + (size_t)p * kRecWords + 4 * w), true);
    if (w == 0) {
      gi[q] = gi_of(a, j + q);
      lead[q] = a.lead != nullptr ? a.lead[j + q] : 1;
    }
  }
}

// A light run on K chains a CTA, S warps a chain: the tickets in windows of
// up to S (a.lead; a window never spans a staged batch), warp k of a chain
// applying ticket k of the window, one barrier a window for the whole CTA.
// A window's tickets touch disjoint state (kernels/ticket_step.py's
// TicketTable.windows), so each reads what it would read in order; while a
// chain carries a bad term (nbad > 0, which an accept zeroes) it applies
// them one at a time.  One CTA an SM (K = 8: 1,024 chains on 128 SMs), so
// that the SM's chains run the same ticket, and the same code, at once:
// chains drifting apart through a long run thrash the instruction cache.
template <int K, int S>
__global__ void __launch_bounds__(K * S * 32, 1) ticket_run_kernel(TicketArgs a) {
  __shared__ __align__(16) int s_rec[2][kRunBatch][kRecWords];
  __shared__ int s_gi[2][kRunBatch];
  __shared__ int s_lead[2][kRunBatch];
  __shared__ Move s_mv[K * S];
  __shared__ float s_rb[K * S];
  __shared__ int s_acc[2][K * S];  // by window parity: one barrier a window
  __shared__ TermCache s_tc[K * S];
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int slot = warp % S, chain = warp / S;
  const int c = blockIdx.x * K + chain;
  const bool live = c < a.C;
  const WarpTeam tm;
  const int end = a.j0 + a.nj;
  int nbad = live ? a.nbad[c] : 0;
  if (lane == 0) s_tc[warp].birth = NAN;  // no constants formed yet
  stage_records(a, s_rec[0], s_gi[0], s_lead[0], a.j0, min(kRunBatch, a.nj));
  cp_async_commit();
  int win = 0;
  for (int jb = a.j0, b = 0; jb < end; jb += kRunBatch, ++b) {
    const int nxt = jb + kRunBatch;
    const int buf = b & 1;
    if (nxt < end)
      stage_records(a, s_rec[buf ^ 1], s_gi[buf ^ 1], s_lead[buf ^ 1], nxt,
                    min(kRunBatch, end - nxt));
    cp_async_commit();
    cp_async_wait<1>();
    __syncthreads();  // batch b has landed, from every thread's copies
    const int nt = min(kRunBatch, end - jb);
    for (int q = 0; q < nt; ++win) {
      int w = 1;
      while (w < S && q + w < nt && s_lead[buf][q + w] == 0) ++w;
      // A chain with a bad term applies the window's tickets in turn, on
      // its first warp.
      const int first = nbad == 0 ? slot : (slot == 0 ? 0 : w), step = nbad == 0 ? S : 1;
      bool acc = false;
      if (live)
        for (int k = first; k < w; k += step) {
          const int j = jb + q + k;
          const Row rw{s_rec[buf][q + k]};
          const int gi = s_gi[buf][q + k];
          if (fast_ticket(a, rw)) {
            acc = ticket_fast_dev(a, c, j, gi, rw, &s_mv[warp], &s_rb[warp], &s_tc[warp]) || acc;
          } else {
            const TicketOut o =
                ticket_prologue_dev(a, tm, c, j, gi, rw, &s_mv[warp], &s_rb[warp], &s_tc[warp]);
            acc = ticket_finish(a, tm, c, j, rw, o, true) || acc;
          }
        }
      if (lane == 0) s_acc[win & 1][warp] = acc;
      __syncthreads();  // the window is done on every chain
      bool any = false;
#pragma unroll
      for (int k = 0; k < S; ++k) any = any || s_acc[win & 1][chain * S + k] != 0;
      if (any) nbad = 0;  // an accept zeroed the chain's bad-term count
      q += w;
    }
    __syncthreads();  // every warp is done with the buffer before it is staged again
  }
}

}  // namespace

// The entry points take the arguments as a plain pointer: a parameter of a
// type with internal linkage would keep them from being exported.
extern "C" int mcmcdate_ticket_args_size() { return (int)sizeof(TicketArgs); }

extern "C" int mcmcdate_ticket_rec_words() { return kRecWords; }

extern "C" int mcmcdate_ticket_prologue_f32(const void* args, void* stream) {
  const TicketArgs& a = *static_cast<const TicketArgs*>(args);
  if (a.C > 0) ticket_prologue_kernel<<<a.C, kTicketThreads, 0, (cudaStream_t)stream>>>(a);
  return (int)cudaGetLastError();
}

extern "C" int mcmcdate_ticket_scan_f32(const void* args, void* stream) {
  const TicketArgs& a = *static_cast<const TicketArgs*>(args);
  if (a.C > 0 && a.nj > 0)
    ticket_scan_kernel<<<a.C, kTicketThreads, 0, (cudaStream_t)stream>>>(a);
  return (int)cudaGetLastError();
}

extern "C" int mcmcdate_ticket_run_slots() { return kRunSlots; }

extern "C" int mcmcdate_ticket_run_f32(const void* args, void* stream) {
  const TicketArgs& a = *static_cast<const TicketArgs*>(args);
  if (a.C > 0 && a.nj > 0)
    ticket_run_kernel<kRunChains, kRunSlots>
        <<<(a.C + kRunChains - 1) / kRunChains, kRunChains * kRunSlots * 32, 0,
           (cudaStream_t)stream>>>(a);
  return (int)cudaGetLastError();
}
