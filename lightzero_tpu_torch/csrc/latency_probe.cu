// Latency probe: one thread follows a chain of dependent loads through a
// buffer that stays in the L2 cache, each load bypassing L1 (ld.global.cg),
// so that every load waits for the one before it.
//
// Not a port of a TPU kernel and not on any path of the port. chip_smoke.py
// times it to give the latency of one link of fused_traverse's chain (one
// dependent row read per depth level), which it reports beside that
// kernel's bytes bound, labelled as latency.
#include <cuda_runtime.h>

namespace {

__global__ void chase_kernel(const int* __restrict__ next, int steps,
                             int* __restrict__ out) {
  int i = 0;
  for (int s = 0; s < steps; ++s) i = __ldcg(next + i);
  *out = i;  // keeps the chain live
}

}  // namespace

extern "C" int latency_probe_launch(const void* next, int steps, void* out,
                                    void* stream) {
  chase_kernel<<<1, 1, 0, (cudaStream_t)stream>>>((const int*)next, steps,
                                                  (int*)out);
  return (int)cudaGetLastError();
}
