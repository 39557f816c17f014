// Fused transit absorption, K = 1, for Hopper (sm_90a): the entry point
// of the tensor-core kernel in fused_transit_mma.cuh, on a float32 table,
// that replaces the Pallas TPU kernel bart_tpu/rt/fused.py:_tkernel
// (design and bound: see the header).

#include "fused_transit_mma.cuh"

// Plain C entry point (bound with ctypes).  tab [Rt, L, Wp] is the table
// with its wavenumber axis zero-padded to Wp, W rounded up to 4 (16
// bytes: bart_tpu_torch.rt.fused.rows_table), below 2^31 - 64; wrows [C, L, R] the
// weights zero-padded to R rows, Rt rounded up to 8; G in tiles
// [C, Lk / 8, Lm, 8] (tile s holds G[c, :, 8 s : 8 s + 8]; Lk, Lm = L
// rounded up to 8, 16; lower-triangular, zero padding); out [C, W].
// Above 112 layers ext_g is the streamed kernel's scratch, nslot x 32 x
// Lk x 32 float32 for nslot blocks (else unused).  Returns the cudaError_t
// of the launch: 0 when the kernel was queued on ``stream``.
extern "C" int bart_fused_transit(const float* tab, const float* wrows,
                                  const float* G, const float* wgt,
                                  float* out, float* ext_g, int Rt, int R,
                                  int L, int W, int Wp, int C, int nslot,
                                  cudaStream_t stream) {
  return launch_transit_mma<float>(tab, wrows, G, wgt, out, ext_g, nullptr,
                                   Rt, R, L, W, Wp, C, 1, nslot, stream);
}
