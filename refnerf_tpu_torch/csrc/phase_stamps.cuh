// The phase stamps of the trunk kernels (trunk_fwd.cu, trunk_fwd_tma.cu,
// trunk_bwd.cu, trunk_bwd_tma.cu).
//
// The phase-breakdown build (-DREFNERF_PHASES, tools/bwd_phases.py; never
// loaded on the main path): thread 0 of each CTA adds the clock64() cycles
// of each segment of the per-tile kernel, closed by the barrier PHASE_SYNC()
// that each kernel's file defines, to g_phase_cycles[phase][kind], kind 0
// products, 1 scalar passes, 2 stores (the backward's scratch, the
// forward's outputs). Backward phases: 0 input and K6, 1 recompute, 2
// heads, 3 inner chain, 4 head backward, 5 first-order reverse with dx, 6
// tangent. Forward phases: 0 input (K7, K8), 1 layers, 2 heads (K10, the
// bottleneck), 3 inner chain and its fold (K3), 4 K6's scan. Without
// REFNERF_PHASES every stamp is empty and the kernels compile as if it
// were not there. PHASE_PARAM / PHASE_ARG hand the running stamp to a
// function that marks segments of its own.

#pragma once

#include <cuda_runtime.h>

namespace {

#ifdef REFNERF_PHASES
__device__ unsigned long long g_phase_cycles[7][3];
#define PHASE_START long long ph_t = clock64()
#define PHASE_MARK(ph, kind)                                                   \
  do {                                                                         \
    PHASE_SYNC();                                                              \
    if (threadIdx.x == 0) {                                                    \
      const long long t_ = clock64();                                          \
      atomicAdd(&g_phase_cycles[ph][kind], static_cast<unsigned long long>(t_ - ph_t)); \
      ph_t = t_;                                                               \
    }                                                                          \
  } while (0)
#define PHASE_PARAM , long long& ph_t
#define PHASE_ARG , ph_t
#else
#define PHASE_START do {} while (0)
#define PHASE_MARK(ph, kind) do {} while (0)
#define PHASE_PARAM
#define PHASE_ARG
#endif
enum { kProd = 0, kScal = 1, kStore = 2 };

}  // namespace

#ifdef REFNERF_PHASES
// The phase build's cycle sums [7][3] into out, then zeroed when `reset`.
extern "C" int refnerf_phase_cycles(unsigned long long* out, int reset) {
  cudaError_t err = cudaMemcpyFromSymbol(out, g_phase_cycles, sizeof(g_phase_cycles));
  if (err == cudaSuccess && reset) {
    static const unsigned long long zero[7][3] = {};
    err = cudaMemcpyToSymbol(g_phase_cycles, zero, sizeof(zero));
  }
  return static_cast<int>(err);
}
#endif
