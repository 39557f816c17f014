// Fused transit absorption, K = 1, for Hopper (sm_90a): the entry point
// of the kernel in fused_transit.cuh that replaces the Pallas TPU kernel
// bart_tpu/rt/fused.py:_tkernel (design and bound: see the header).

#include "fused_transit.cuh"

// Plain C entry point (bound with ctypes).  tab [R, L, Wp], wrows
// [C, L, R] and G [C, L, Lp] with R, Wp = W rounded up to 4 and Lp = L
// rounded up to 4 (zero padding).  Returns the cudaError_t of the
// launch: 0 when the kernel was queued on ``stream``.
extern "C" int bart_fused_transit(const float* tab, const float* wrows,
                                  const float* G, const float* wgt,
                                  float* out, int R, int L, int W, int C,
                                  cudaStream_t stream) {
  return launch_transit<float>(tab, wrows, G, wgt, out, R, R, L, W,
                               (W + 3) & ~3, C, 1, stream);
}
