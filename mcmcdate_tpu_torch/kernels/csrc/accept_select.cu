// K3 accept_select: the Metropolis-Hastings-Green accept and the in-place
// select of every carried quantity, for one ticket and all chains.
//
// Replaces the accept-and-select part of the XLA-compiled
// MHKernel._ticket_step (mcmcdate_tpu/engine/mh.py:120-128 and 180-207):
//   d_pr    = sum_t where(isnan(terms2 - terms), 0, terms2 - terms)
//             (-inf when any new term is -inf or NaN)
//   alpha   = d_pr + d_lik + log_mhg + lj   (NaN -> -inf)
//   accept  = log(u) < alpha
// then, for accepted chains, state <- state_new, terms <- terms2,
// d <- d_new, y <- y + dy, and acc[c, pidx] += 1.
//
// What bounds it on the H100: bytes.  It reads two [C, T] term rows and,
// for accepted chains, copies up to 2N + T + 2D floats per chain; there
// is no data reuse.  The design: one block per chain; a fixed-order block
// reduction over T (deterministic), the decision in shared memory, then
// coalesced masked copies.  Null "new" pointers mark quantities the
// proposal left unchanged, which are neither read nor written.  Built
// without fast-math so isnan/isinf/-inf behave exactly.

#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int THREADS = 128;

struct AcceptArgs {
  int C, T, N, D, P, pidx;
  float* terms;
  const float* terms2;
  const float* d_lik;  // nullable: no likelihood
  const float* log_mhg;
  const float* lj;  // nullable: no root Jacobian
  const float* u;
  float* heights;
  const float* heights_new;  // nullable: unchanged
  float* rates;
  const float* rates_new;
  float* scal[5];  // birth, death, height, rate_mean, rate_var
  const float* scal_new[5];
  float* d;
  const float* d_new;  // nullable
  float* y;
  const float* dy;  // nullable
  int* acc;         // [C, P]
  unsigned char* accept_out;  // [C]
};

__global__ void __launch_bounds__(THREADS) accept_select_kernel(AcceptArgs a) {
  __shared__ float s_sum[THREADS / 32];
  __shared__ int s_bad[THREADS / 32];
  __shared__ int s_accept;
  const int c = blockIdx.x;
  const size_t rowT = (size_t)c * a.T;
  float sum = 0.f;
  int bad = 0;
  for (int t = threadIdx.x; t < a.T; t += THREADS) {
    const float n = a.terms2[rowT + t];
    const float dd = n - a.terms[rowT + t];
    sum += isnan(dd) ? 0.f : dd;
    bad |= (!isfinite(n) && !(isinf(n) && n > 0.f)) ? 1 : 0;
  }
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    sum += __shfl_xor_sync(0xffffffffu, sum, off);
    bad |= __shfl_xor_sync(0xffffffffu, bad, off);
  }
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  if (lane == 0) {
    s_sum[warp] = sum;
    s_bad[warp] = bad;
  }
  __syncthreads();
  if (threadIdx.x == 0) {
    float total = 0.f;
    int any_bad = 0;
    for (int w = 0; w < THREADS / 32; ++w) {
      total += s_sum[w];
      any_bad |= s_bad[w];
    }
    const float d_pr = any_bad ? -INFINITY : total;
    float alpha = d_pr + (a.d_lik != nullptr ? a.d_lik[c] : 0.f);
    alpha = alpha + a.log_mhg[c];
    alpha = alpha + (a.lj != nullptr ? a.lj[c] : 0.f);
    if (isnan(alpha)) alpha = -INFINITY;
    const int accept = logf(a.u[c]) < alpha ? 1 : 0;
    s_accept = accept;
    a.accept_out[c] = (unsigned char)accept;
    if (accept) a.acc[(size_t)c * a.P + a.pidx] += 1;
  }
  __syncthreads();
  if (!s_accept) return;
  const size_t rowN = (size_t)c * a.N;
  const size_t rowD = (size_t)c * a.D;
  for (int j = threadIdx.x; j < a.N; j += THREADS) {
    if (a.heights_new != nullptr) a.heights[rowN + j] = a.heights_new[rowN + j];
    if (a.rates_new != nullptr) a.rates[rowN + j] = a.rates_new[rowN + j];
  }
  if (threadIdx.x < 5 && a.scal_new[threadIdx.x] != nullptr)
    a.scal[threadIdx.x][c] = a.scal_new[threadIdx.x][c];
  for (int t = threadIdx.x; t < a.T; t += THREADS) a.terms[rowT + t] = a.terms2[rowT + t];
  for (int j = threadIdx.x; j < a.D; j += THREADS) {
    if (a.d_new != nullptr) a.d[rowD + j] = a.d_new[rowD + j];
    if (a.dy != nullptr) a.y[rowD + j] = a.y[rowD + j] + a.dy[rowD + j];
  }
}

}  // namespace

extern "C" int mcmcdate_accept_select_f32(
    int C, int T, int N, int D, int P, int pidx, float* terms, const float* terms2,
    const float* d_lik, const float* log_mhg, const float* lj, const float* u,
    float* heights, const float* heights_new, float* rates,
    const float* rates_new, float* birth, const float* birth_new, float* death,
    const float* death_new, float* height, const float* height_new, float* rate_mean,
    const float* rate_mean_new, float* rate_var, const float* rate_var_new, float* d,
    const float* d_new, float* y, const float* dy, int* acc, unsigned char* accept_out,
    void* stream) {
  AcceptArgs a;
  a.C = C;
  a.T = T;
  a.N = N;
  a.D = D;
  a.P = P;
  a.pidx = pidx;
  a.terms = terms;
  a.terms2 = terms2;
  a.d_lik = d_lik;
  a.log_mhg = log_mhg;
  a.lj = lj;
  a.u = u;
  a.heights = heights;
  a.heights_new = heights_new;
  a.rates = rates;
  a.rates_new = rates_new;
  a.scal[0] = birth;
  a.scal_new[0] = birth_new;
  a.scal[1] = death;
  a.scal_new[1] = death_new;
  a.scal[2] = height;
  a.scal_new[2] = height_new;
  a.scal[3] = rate_mean;
  a.scal_new[3] = rate_mean_new;
  a.scal[4] = rate_var;
  a.scal_new[4] = rate_var_new;
  a.d = d;
  a.d_new = d_new;
  a.y = y;
  a.dy = dy;
  a.acc = acc;
  a.accept_out = accept_out;
  if (C > 0) {
    accept_select_kernel<<<C, THREADS, 0, (cudaStream_t)stream>>>(a);
  }
  return (int)cudaGetLastError();
}
