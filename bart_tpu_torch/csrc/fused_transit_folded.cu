// Folded transit absorption (K sub-samples per output bin), for Hopper
// (sm_90a): the entry point of the tensor-core kernel in
// fused_transit_mma.cuh that replaces the Pallas TPU kernel
// bart_tpu/rt/fused.py:_ftkernel, which _ftpallas_batch dispatches for
// fused_transit_folded (design and bound: see the header).  Any K >= 2:
// where K does not divide the kernel's 32-point fine tile, a bin cut by
// a tile is summed tile by tile in the order of its fine points and the
// partial sums are added in tile order by a second launch
// (fold_straddle.cuh).  A bfloat16
// table (the publication path) takes the exact bfloat16 fill, a float32
// table (tests and comparisons only) the 3xTF32 fill.

#include "fused_transit_mma.cuh"

// Plain C entry point (bound with ctypes).  tab [Rt, L, Fp] is the
// bin-major fine table, zero-padded along wn to Fp, a multiple of 16
// bytes below 2^31 - 64; its first W K columns are in use; wrows [C, L, R] float32,
// zero-padded to R rows; out [C, W].  K >= 2 sub-samples a bin.
// R = Rt rounded up to 16 (bfloat16 table) or 8 (float32 table, bf16 ==
// 0); G in tiles [C, Lk / 8, Lm, 8] (tile s holds G[c, :, 8 s : 8 s + 8];
// Lk, Lm = L rounded up to 8, 16; lower-triangular, zero padding).
// Above 112 layers ext_g is the streamed kernel's scratch, nslot x 32 x
// Lk x 32 float32 for nslot blocks (else unused).  Where K does not divide
// the 32-point tile, part is the straddling bins' partial sums,
// [C, ceil(W K / 32), 2] float32, added by a second launch in tile order
// (fold_straddle.cuh; else unused, may be null).  Returns the
// cudaError_t of the launches.
extern "C" int bart_fused_transit_folded(const void* tab, const float* wrows,
                                         const float* G, const float* wgt,
                                         float* out, float* ext_g,
                                         float* part, int Rt, int R, int L,
                                         int W, int Fp, int C, int K,
                                         int bf16, int nslot,
                                         cudaStream_t stream) {
  if (K < 2 || W < 1 || (long long)W * K > Fp)
    return (int)cudaErrorInvalidValue;
  return bf16 ? launch_transit_mma<__nv_bfloat16>(tab, wrows, G, wgt, out,
                                                  ext_g, part, Rt, R, L,
                                                  W * K, Fp, C, K, nslot,
                                                  stream)
              : launch_transit_mma<float>(tab, wrows, G, wgt, out, ext_g,
                                          part, Rt, R, L, W * K, Fp, C, K,
                                          nslot, stream);
}

// The resident kernel's cluster shape and cudaOccupancyMaxActiveClusters
// at L layers on a bfloat16 (bf16 != 0) or float32 table: info[4] =
// {cluster chain blocks, cluster tiles, clusters, shared bytes a block}.
// Returns the cudaError_t.
extern "C" int bart_transit_cluster_info(int L, int bf16, int* info) {
  if (L < 1 || L > 16 * FT_MT || info == nullptr)
    return (int)cudaErrorInvalidValue;
  return bf16 ? transit_cluster_info<__nv_bfloat16>(L, info)
              : transit_cluster_info<float>(L, info);
}
