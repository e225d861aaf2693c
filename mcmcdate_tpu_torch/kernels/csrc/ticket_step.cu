// T1 ticket_prologue and T3 ticket_scan, the sequential sweep's ticket
// kernels (with K3 accept_select, csrc/accept_select.cu).  The device code
// and what it replaces: csrc/ticket_step.cuh.
//
// T1 ticket_prologue_kernel: one ticket on every chain, one CTA per chain:
// the prologue, its per-chain results (lmhg, lj, d_pr, invalid, the
// proposal) stored for K3, after K2 where the row's class needs it.
// T3 ticket_scan_kernel: a run of consecutive tickets, each chain's CTA
// walking them in order: prologue, likelihood (univariate or gather),
// epilogue, ticket after ticket, the chain's state coherent between them.

#include <cuda_runtime.h>
#include <math.h>

#include "ticket_step.cuh"

namespace {

using namespace mcmcdate;

__global__ void __launch_bounds__(kTicketThreads) ticket_prologue_kernel(TicketArgs a) {
  __shared__ float red[3][kTicketWarps];
  const int c = blockIdx.x;
  const int j = a.j0;
  const TicketOut o = ticket_prologue_dev(a, c, j, row_of(a, j), red);
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
  __shared__ float red[3][kTicketWarps];
  const int c = blockIdx.x;
  for (int j = a.j0; j < a.j0 + a.nj; ++j) {
    const int p = row_of(a, j);
    const TicketOut o = ticket_prologue_dev(a, c, j, p, red);
    float d_lik = 0.f;
    const float* dy = nullptr;
    if (a.lik == LIK_DIAG) {
      d_lik = diag_lik_dev(a, c, p, red);
    } else if (a.lik == LIK_FULL && a.d_class[p] == DC_GATHER) {
      d_lik = gather_lik_dev(a, c, p, red);
      dy = a.dys + (size_t)c * a.D;
    }
    const size_t oi = (size_t)c * a.n + j;
    if (threadIdx.x == 0) {
      if (a.prop_out != nullptr) a.prop_out[oi] = o.prop;
      if (a.mean_out != nullptr && a.mode[p] == VAR_TREE) a.mean_out[oi] = o.mean;
    }
    ticket_epilogue_dev(a, c, j, p, o, d_lik, dy, oi);
  }
}

}  // namespace

// The entry points take the arguments as a plain pointer: a parameter of a
// type with internal linkage would keep them from being exported.
extern "C" int mcmcdate_ticket_args_size() { return (int)sizeof(TicketArgs); }

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
