// Folded transit absorption (K sub-samples per output bin), for Hopper
// (sm_90a): the entry point of the kernel in fused_transit.cuh that
// replaces the Pallas TPU kernel bart_tpu/rt/fused.py:_ftkernel (design
// and bound: see the header).  The mean over the K sub-samples and the
// bfloat16 read happen inside the kernel.
//
// Bound on the H100.  Per 512-chain batch at R = 41 (44 padded),
// L = 100, 1,125 fine bins, K = 32: 81 G FMAs for ext and 93 G for the
// slant triangle, 5.2 ms at the card's float32 peak; the bf16 table
// (0.3 GB) takes 0.1 ms of HBM time.  Operations bound it.

#include "fused_transit.cuh"

// Plain C entry point (bound with ctypes).  tab [Rt, L, Fp] is the
// bin-major fine table, float32 or (bf16 != 0) bfloat16, zero-padded
// along wn to Fp, a multiple of 16 bytes; its first W K columns are in
// use.  wrows [C, L, R] with R = Rt rounded up to 4 and G [C, L, Lp]
// with Lp = L rounded up to 4 (zero padding); out [C, W].  K is a power
// of two in 2..32.  Returns the cudaError_t of the launch.
extern "C" int bart_fused_transit_folded(const void* tab, const float* wrows,
                                         const float* G, const float* wgt,
                                         float* out, int Rt, int R, int L,
                                         int W, int Fp, int C, int K,
                                         int bf16, cudaStream_t stream) {
  if (K < 2 || W < 1 || (long long)W * K > Fp)
    return (int)cudaErrorInvalidValue;
  return bf16 ? launch_transit<__nv_bfloat16>(tab, wrows, G, wgt, out, Rt, R,
                                              L, W * K, Fp, C, K, stream)
              : launch_transit<float>(tab, wrows, G, wgt, out, Rt, R, L,
                                      W * K, Fp, C, K, stream);
}
