// K3 accept_select: the epilogue of one ticket of the sequential sweep, on
// every chain, one CTA per chain, after T1 ticket_prologue
// (csrc/ticket_step.cu) and, for a full-MVN ticket of the dense or range
// classes, K2's dy (csrc/whiten.cu).
//
// Replaces the accept-and-select part of the XLA-compiled
// MHKernel._ticket_step (mcmcdate_tpu/engine/mh.py:120-128 and 180-207):
//   d_lik   = K2's (full MVN), -0.5 sum dy (2 y + dy) with dy = delta
//             inv_sd on the class rows (univariate), or 0
//   alpha   = d_pr + d_lik + lmhg + lj   (d_pr -inf where T1 found the new
//             term vector invalid; NaN -> -inf)
//   accept  = log(u) < alpha
// then, for accepted chains, the ticket's term entries, d on its class
// rows, y + dy (all D after K2, the class rows under the univariate kind),
// acc[c, row] += 1 and the bad-term count 0; for rejected chains the old
// heights, rates and scalars T1 kept.
//
// What bounds it on the H100: latency and bytes: a few per-chain values,
// the ticket's touched entries (O(1) for a node-local ticket) and, after
// K2, D floats of y per accepted chain.  It writes back only what the
// ticket touched, not every carried quantity of an accepted chain.  The device code (ticket_epilogue_dev,
// diag_lik_dev) is shared with T3: csrc/ticket_step.cuh.

#include <cuda_runtime.h>
#include <math.h>

#include "ticket_step.cuh"

namespace {

using namespace mcmcdate;

__global__ void __launch_bounds__(kTicketThreads) accept_select_kernel(TicketArgs a) {
  __shared__ float red[kTicketSums][kTicketWarps];
  const CtaTeam tm{red};
  const int c = blockIdx.x;
  const int j = a.j0;
  const Row rw = row_rec(a, row_of(a, j));
  TicketOut o;
  o.lmhg = a.lmhg[c];
  o.lj = a.lj[c];
  o.d_pr = a.d_pr[c];
  o.invalid = a.invalid[c] != 0;
  o.prop = o.mean = 0.f;
  float d_lik = 0.f;
  const float* dy = nullptr;
  if (a.lik == LIK_DIAG) {
    d_lik = diag_lik_dev(a, tm, c, rw);
  } else if (a.lik == LIK_FULL && a.dy_in != nullptr) {
    d_lik = a.dlik_in[c];
    dy = a.dy_in + (size_t)c * a.D;
  }
  ticket_epilogue_dev(a, tm, c, j, rw, o, d_lik, dy, (size_t)c);
}

}  // namespace

extern "C" int mcmcdate_accept_select_f32(const void* args, void* stream) {
  const TicketArgs& a = *static_cast<const TicketArgs*>(args);
  if (a.C > 0) accept_select_kernel<<<a.C, kTicketThreads, 0, (cudaStream_t)stream>>>(a);
  return (int)cudaGetLastError();
}
