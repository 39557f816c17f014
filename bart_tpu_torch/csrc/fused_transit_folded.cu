// Folded transit absorption (K sub-samples per output bin), for Hopper
// (sm_90a): the entry point of the tensor-core kernel in
// fused_transit_mma.cuh that replaces the Pallas TPU kernel
// bart_tpu/rt/fused.py:_ftkernel, which _ftpallas_batch dispatches for
// fused_transit_folded (design and bound: see the header).  A bfloat16
// table (the publication path) takes the exact bfloat16 fill, a float32
// table (tests and comparisons only) the 3xTF32 fill.

#include "fused_transit_mma.cuh"

// Plain C entry point (bound with ctypes).  tab [Rt, L, Fp] is the
// bin-major fine table, zero-padded along wn to Fp, a multiple of 16
// bytes; its first W K columns are in use; wrows [C, L, R] float32,
// zero-padded to R rows; out [C, W].  K is a power of two in 2..32.
// R = Rt rounded up to 16 (bfloat16 table) or 8 (float32 table, bf16 ==
// 0); G in tiles [C, Lk / 8, Lm, 8] (tile s holds G[c, :, 8 s : 8 s + 8];
// Lk, Lm = L rounded up to 8, 16; lower-triangular, zero padding).
// Above 112 layers ext_g is the streamed kernel's scratch, nslot x 8 x Lk
// x 32 float32 for nslot blocks (else unused).  Returns the cudaError_t
// of the launch.
extern "C" int bart_fused_transit_folded(const void* tab, const float* wrows,
                                         const float* G, const float* wgt,
                                         float* out, float* ext_g, int Rt,
                                         int R, int L, int W, int Fp, int C,
                                         int K, int bf16, int nslot,
                                         cudaStream_t stream) {
  if (K < 2 || K > 32 || (K & (K - 1)) != 0 || W < 1 ||
      (long long)W * K > Fp)
    return (int)cudaErrorInvalidValue;
  return bf16 ? launch_transit_mma<__nv_bfloat16>(tab, wrows, G, wgt, out,
                                                  ext_g, Rt, R, L, W * K, Fp,
                                                  C, K, nslot, stream)
              : launch_transit_mma<float>(tab, wrows, G, wgt, out, ext_g, Rt,
                                          R, L, W * K, Fp, C, K, nslot,
                                          stream);
}
