// M1 mc3_swap: one MC3 swap move, every group's n_swaps exchange decisions
// and the permutation of its temperature slots' states, in one launch.
//
// Replaces the body of the JAX package's make_swap_fn
// (mcmcdate_tpu/engine/mc3.py:46-84): the chain batch is laid out
// [g * T + k] (T temperature slots a group); per group a lax.scan over
// n_swaps draws, each picking an adjacent pair (p, p + 1) and accepting
// where log u < (beta_p - beta_{p+1}) (U_{p+1} - U_p), U the untempered
// log posterior, which swaps perm[p], perm[p + 1] and U[p], U[p + 1]; then
// every State leaf is gathered by flat = g * T + perm.  Tuning stays with
// its slot: only the state moves.
//
// What bounds it on the H100: bytes.  Each moved group reads and writes its
// T rows of every field (heights and rates are [C, N], 2 N floats a chain:
// about 16.4 MB each way at 1000 taxa x 1024 chains if every group moves,
// 0.01 ms at 3.35 TB/s); the decisions are 3 dependent steps a group.
// The design: a CTA a group.  Thread 0 walks the group's draws (the pair
// and the uniform of each, the group's U in registers), writes each
// decision and U permuted, and leaves perm in shared memory.  A group
// whose perm is the identity writes nothing more.  Otherwise each thread
// takes columns of each field in turn: it reads the column's T values (one
// per slot) and writes them back permuted, so every value a thread writes
// it read itself and no CTA touches another group's rows: the permutation
// is in place without a barrier between reads and writes.  The per-pair
// accept and attempt counts are integers summed by the last CTA to finish
// (a ticket counter it resets) in a fixed order: per thread a stride of
// the draws, then a tree over the threads.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 128;
constexpr int kMaxFields = 8;
constexpr int kMaxTemps = 8;

struct SwapArgs {
  char* base[kMaxFields];          // row 0 of each field, rows contiguous
  long long row_bytes[kMaxFields]; // a multiple of 4
  float* U;                        // [G T] untempered log posterior, permuted in place
  const int* pair;                 // [S, G] the lower slot p of each draw's pair
  const float* u;                  // [S, G] accept uniforms
  const float* betas;              // [T] the ladder
  unsigned char* accept;           // [S, G]
  int* pair_acc;                   // [T - 1] accepted swaps per pair
  int* pair_tot;                   // [T - 1] attempted swaps per pair
  unsigned int* ticket;            // [1] 0 between launches
  int n_fields, G, T, S;
};

__global__ void __launch_bounds__(kThreads) mc3_swap_kernel(SwapArgs a) {
  __shared__ int perm[kMaxTemps];
  __shared__ int moved;
  __shared__ bool last;
  __shared__ int red[2 * (kMaxTemps - 1)][kThreads];
  const int g = blockIdx.x;
  const int tid = threadIdx.x;
  const int T = a.T;
  if (tid == 0) {
    float U[kMaxTemps];
    int pm[kMaxTemps];
    for (int k = 0; k < T; ++k) {
      U[k] = a.U[(size_t)g * T + k];
      pm[k] = k;
    }
    for (int s = 0; s < a.S; ++s) {
      const size_t o = (size_t)s * a.G + g;
      const int p = a.pair[o];
      const float ui = U[p], uj = U[p + 1];
      const float log_alpha = (a.betas[p] - a.betas[p + 1]) * (uj - ui);
      const bool acc = logf(a.u[o]) < log_alpha;
      if (acc) {
        const int t = pm[p];
        pm[p] = pm[p + 1];
        pm[p + 1] = t;
        U[p] = uj;
        U[p + 1] = ui;
      }
      a.accept[o] = acc;
    }
    int m = 0;
    for (int k = 0; k < T; ++k) {
      a.U[(size_t)g * T + k] = U[k];
      perm[k] = pm[k];
      m |= pm[k] != k;
    }
    moved = m;
  }
  __syncthreads();
  if (moved) {
    for (int f = 0; f < a.n_fields; ++f) {
      const long long words = a.row_bytes[f] / 4;
      uint32_t* rows = reinterpret_cast<uint32_t*>(a.base[f]) + (size_t)g * T * words;
      for (long long w = tid; w < words; w += kThreads) {
        uint32_t col[kMaxTemps];
        for (int k = 0; k < T; ++k) col[k] = rows[k * words + w];
        for (int k = 0; k < T; ++k) rows[k * words + w] = col[perm[k]];
      }
    }
  }
  // The per-pair counts: the last CTA to get here sums every group's draws.
  if (tid == 0) {
    __threadfence();  // this CTA's decisions are visible before its ticket
    last = atomicAdd(a.ticket, 1u) == (unsigned int)(a.G - 1);
  }
  __syncthreads();
  if (!last) return;
  __threadfence();
  int acc_n[kMaxTemps - 1], tot_n[kMaxTemps - 1];
  for (int q = 0; q < T - 1; ++q) acc_n[q] = tot_n[q] = 0;
  const int n = a.S * a.G;
  for (int i = tid; i < n; i += kThreads) {
    const int p = __ldcg(a.pair + i);
    const bool acc = __ldcg(a.accept + i) != 0;
    for (int q = 0; q < T - 1; ++q) {
      tot_n[q] += p == q;
      acc_n[q] += (p == q) && acc;
    }
  }
  for (int q = 0; q < T - 1; ++q) {
    red[q][tid] = acc_n[q];
    red[kMaxTemps - 1 + q][tid] = tot_n[q];
  }
  __syncthreads();
  for (int h = kThreads / 2; h > 0; h /= 2) {
    if (tid < h) {
      for (int q = 0; q < T - 1; ++q) {
        red[q][tid] += red[q][tid + h];
        red[kMaxTemps - 1 + q][tid] += red[kMaxTemps - 1 + q][tid + h];
      }
    }
    __syncthreads();
  }
  if (tid < T - 1) {
    a.pair_acc[tid] = red[tid][0];
    a.pair_tot[tid] = red[kMaxTemps - 1 + tid][0];
  }
  if (tid == 0) *a.ticket = 0;
}

}  // namespace

// bases[i] and row_bytes[i] describe field i of n (each [G T] rows); U [G
// T]; pair and u [S, G]; betas [T]; accept [S, G]; pair_acc and pair_tot
// [T - 1]; ticket one zeroed unsigned int, left zeroed.
extern "C" int mcmcdate_mc3_swap_f32(void* const* bases, const long long* row_bytes,
                                     int n_fields, float* U, const int* pair, const float* u,
                                     const float* betas, unsigned char* accept, int* pair_acc,
                                     int* pair_tot, unsigned int* ticket, int G, int T, int S,
                                     void* stream) {
  if (n_fields < 0 || n_fields > kMaxFields || T < 2 || T > kMaxTemps || G < 0 || S < 0)
    return (int)cudaErrorInvalidValue;
  SwapArgs a{};
  for (int i = 0; i < n_fields; ++i) {
    if (row_bytes[i] % 4 != 0 || (uintptr_t)bases[i] % 4 != 0) return (int)cudaErrorInvalidValue;
    a.base[i] = static_cast<char*>(bases[i]);
    a.row_bytes[i] = row_bytes[i];
  }
  a.U = U;
  a.pair = pair;
  a.u = u;
  a.betas = betas;
  a.accept = accept;
  a.pair_acc = pair_acc;
  a.pair_tot = pair_tot;
  a.ticket = ticket;
  a.n_fields = n_fields;
  a.G = G;
  a.T = T;
  a.S = S;
  if (G > 0) mc3_swap_kernel<<<G, kThreads, 0, (cudaStream_t)stream>>>(a);
  return (int)cudaGetLastError();
}
