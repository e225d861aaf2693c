// cascade_seed: one rung of the stepping-stone cascade's seeding, chain j's
// row copied to chain j + 1 in every field of the chain state, one launch.
//
// Replaces the re-seeding step of the JAX package's annealed_cascade
// (mcmcdate_tpu/engine/stepping_stone.py:66-94): after each rung's sweeps,
// jax.tree.map(lambda x: x.at[j + 1].set(x[j]), batch) over the State
// leaves, which XLA lowers to one dynamic-update-slice per leaf.
//
// What bounds it on the H100: bytes, and far more the launch and the
// rounds to memory.  A rung moves one chain's row of each field, (2 N + 5)
// floats read and written (about 2.2 KB at 136 taxa, 16 KB at 1000), so
// the bytes bound is a few nanoseconds; the launch costs microseconds, and
// each dependent load-then-store round to memory about one more.  The
// design: one launch for all fields (not one copy per field), a grid of
// (chunk, field): each thread takes kWords words of one field's row, 16
// bytes where the row's start, its next row's start and its length allow
// (a row of 4k floats), else 4 bytes, issues all its loads before any
// store (the two rows through __restrict__ views), so a rung is one round
// trip to memory.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 128;
constexpr int kWords = 4;  // words a thread
constexpr int kMaxFields = 16;

struct SeedField {
  char* base;       // row 0 of the field, rows of row_bytes, contiguous
  long long row_bytes;
};

struct SeedArgs {
  SeedField f[kMaxFields];  // grid.y: a field
  int j;                    // the source row; the destination is row j + 1
};

template <typename W>
__device__ __forceinline__ void copy_words(const W* __restrict__ src, W* __restrict__ dst,
                                           long long n) {
  const long long k0 = ((long long)blockIdx.x * kThreads) * kWords + threadIdx.x;
  W v[kWords];
#pragma unroll
  for (int u = 0; u < kWords; ++u) {
    const long long k = k0 + (long long)u * kThreads;
    if (k < n) v[u] = src[k];
  }
#pragma unroll
  for (int u = 0; u < kWords; ++u) {
    const long long k = k0 + (long long)u * kThreads;
    if (k < n) dst[k] = v[u];
  }
}

__global__ void __launch_bounds__(kThreads) cascade_seed_kernel(SeedArgs a) {
  const SeedField fd = a.f[blockIdx.y];
  const long long rb = fd.row_bytes;
  const char* src = fd.base + (long long)a.j * rb;
  char* dst = fd.base + (long long)(a.j + 1) * rb;
  if ((((uintptr_t)src | (uintptr_t)dst | (uintptr_t)rb) & 15) == 0) {
    copy_words(reinterpret_cast<const uint4*>(src), reinterpret_cast<uint4*>(dst), rb / 16);
  } else {
    copy_words(reinterpret_cast<const uint32_t*>(src), reinterpret_cast<uint32_t*>(dst), rb / 4);
  }
}

}  // namespace

// bases[i] and row_bytes[i] (a multiple of 4) describe field i of n; row j
// is copied to row j + 1 in each.
extern "C" int mcmcdate_cascade_seed_f32(void* const* bases, const long long* row_bytes,
                                         int n, int j, void* stream) {
  if (n < 0 || n > kMaxFields || j < 0) return (int)cudaErrorInvalidValue;
  SeedArgs a{};
  long long most = 0;  // 4-byte words of the longest row (the grid's width)
  for (int i = 0; i < n; ++i) {
    if (row_bytes[i] % 4 != 0 || (uintptr_t)bases[i] % 4 != 0) return (int)cudaErrorInvalidValue;
    a.f[i] = SeedField{static_cast<char*>(bases[i]), row_bytes[i]};
    most = row_bytes[i] / 4 > most ? row_bytes[i] / 4 : most;
  }
  a.j = j;
  const long long chunks = (most + kThreads * kWords - 1) / (kThreads * kWords);
  if (n > 0 && chunks > 0) {
    cascade_seed_kernel<<<dim3((unsigned)chunks, n), kThreads, 0, (cudaStream_t)stream>>>(a);
  }
  return (int)cudaGetLastError();
}
