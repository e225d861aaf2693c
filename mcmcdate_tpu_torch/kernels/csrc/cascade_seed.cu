// cascade_seed: one rung of the stepping-stone cascade's seeding, chain j's
// row copied to chain j + 1 in every field of the chain state, one launch.
//
// Replaces the re-seeding step of the JAX package's annealed_cascade
// (mcmcdate_tpu/engine/stepping_stone.py:66-94): after each rung's sweeps,
// jax.tree.map(lambda x: x.at[j + 1].set(x[j]), batch) over the State
// leaves, which XLA lowers to one dynamic-update-slice per leaf.
//
// What bounds it on the H100: bytes, and far more the launch.  A rung moves
// one chain's row of each field, (2 N + 5) floats read and written (about
// 2.2 KB at 136 taxa), so the bytes bound is about a nanosecond; the launch
// costs microseconds.  The design: one launch for all fields (not one copy
// per field), a CTA per field, each thread copying 16-byte words where the
// field's row start, its next row's start and its length allow (a row of
// 4k floats), else 4-byte words.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 128;
constexpr int kMaxFields = 16;

struct SeedField {
  char* base;       // row 0 of the field, rows of row_bytes, contiguous
  long long row_bytes;
};

struct SeedArgs {
  SeedField f[kMaxFields];  // a CTA a field
  int j;                    // the source row; the destination is row j + 1
};

__global__ void __launch_bounds__(kThreads) cascade_seed_kernel(SeedArgs a) {
  const SeedField fd = a.f[blockIdx.x];
  const long long rb = fd.row_bytes;
  const char* src = fd.base + (long long)a.j * rb;
  char* dst = fd.base + (long long)(a.j + 1) * rb;
  if ((((uintptr_t)src | (uintptr_t)dst | (uintptr_t)rb) & 15) == 0) {
    const uint4* s4 = reinterpret_cast<const uint4*>(src);
    uint4* d4 = reinterpret_cast<uint4*>(dst);
    for (long long k = threadIdx.x; k < rb / 16; k += kThreads) d4[k] = s4[k];
  } else {
    const uint32_t* s1 = reinterpret_cast<const uint32_t*>(src);
    uint32_t* d1 = reinterpret_cast<uint32_t*>(dst);
    for (long long k = threadIdx.x; k < rb / 4; k += kThreads) d1[k] = s1[k];
  }
}

}  // namespace

// bases[i] and row_bytes[i] (a multiple of 4) describe field i of n; row j
// is copied to row j + 1 in each.
extern "C" int mcmcdate_cascade_seed_f32(void* const* bases, const long long* row_bytes,
                                         int n, int j, void* stream) {
  if (n < 0 || n > kMaxFields || j < 0) return (int)cudaErrorInvalidValue;
  SeedArgs a{};
  for (int i = 0; i < n; ++i) {
    if (row_bytes[i] % 4 != 0 || (uintptr_t)bases[i] % 4 != 0) return (int)cudaErrorInvalidValue;
    a.f[i] = SeedField{static_cast<char*>(bases[i]), row_bytes[i]};
  }
  a.j = j;
  if (n > 0) cascade_seed_kernel<<<n, kThreads, 0, (cudaStream_t)stream>>>(a);
  return (int)cudaGetLastError();
}
