// Reductions over a warp and over aligned groups of its lanes, shared by
// the kernels that give a group of lanes to each (chain, ticket) (K5's
// range_lik_prologue, K6's contra_range) or sum over a warp (K4, K5, the
// glob kernels).  The butterflies (xor shuffles) leave every lane of the
// group with the same bits: each level adds the same two partial sums on
// both sides, and float addition commutes.

#pragma once

#include <cuda_runtime.h>
#include <math.h>

namespace mcmcdate {

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) v += __shfl_xor_sync(0xffffffffu, v, off);
  return v;
}

// Sum over the aligned group of `width` lanes (a power of 2 up to 32); every
// lane of the warp takes part.
__device__ __forceinline__ float group_sum(float v, int width) {
  for (int off = width / 2; off > 0; off >>= 1) v += __shfl_xor_sync(0xffffffffu, v, off);
  return v;
}

__device__ __forceinline__ bool group_any(bool b, int width) {
  int v = b;
  for (int off = width / 2; off > 0; off >>= 1) v |= __shfl_xor_sync(0xffffffffu, v, off);
  return v != 0;
}

// NaN or -inf: a term that rejects the proposal.
__device__ __forceinline__ bool is_bad(float x) { return isnan(x) || x == -INFINITY; }

}  // namespace mcmcdate
