// A measurement kernel, on no path of the port: the latency of one
// dependent global load on the card, for the latency floors of the
// sequential sweep's ticket kernels (tools/seq_time.py --latency).  One
// thread follows `steps` links of a cyclic permutation `next` (4 bytes a
// link, each link on a line of its own); the array's size decides whether
// the links hit L2 (a few MB) or go to device memory (a GB).

#include <cuda_runtime.h>

namespace {

__global__ void chase_kernel(const int* next, int steps, int* out) {
  int j = 0;
  for (int s = 0; s < steps; ++s) j = __ldcg(next + j);  // bypass L1: L2 or memory
  *out = j;
}

}  // namespace

extern "C" int mcmcdate_chase(const int* next, int steps, int* out, void* stream) {
  chase_kernel<<<1, 1, 0, (cudaStream_t)stream>>>(next, steps, out);
  return (int)cudaGetLastError();
}
