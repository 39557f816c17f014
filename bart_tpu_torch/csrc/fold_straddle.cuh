// The output bins of a folded kernel that straddle its fine tiles, shared
// by fused_eclipse_folded.cu and fused_transit_mma.cuh.
//
// A folded kernel's block covers TW fine points (a tile), aligned to fine
// points: the 16-byte cp.async copies of the table need sources aligned
// to 8 bfloat16 (or 4 float32) points, which a tile that started at b K
// would not be for every K.  Where K divides TW every bin lies inside one
// tile.  Else a bin may straddle two tiles (K < TW) or span several
// (K > TW).  Each tile then sums, for every bin it touches, the
// sub-samples it holds, in the order of their fine points: a bin wholly
// inside the tile is written directly; the sum of a bin that runs past
// the tile's end goes to part[c][tile][1], that of a bin that started
// before the tile and ends inside it to part[c][tile][0].  This second
// launch adds each straddling bin's partial sums in tile order,
//
//   out[c, b] = (part[c][ta][1] + ... + part[c][tb - 1][1] + part[c][tb][0])
//               * mul / div,
//
// ta and tb the bin's first and last tiles, with the folded kernel's own
// scale (eclipse: mul = 2 pi / K, div = 1; transit: mul = 1, div = K).  No
// atomics: the order of every sum is fixed, so a replayed graph and an
// eager launch give the same bits, and so does every run.

#pragma once

#include <cuda_runtime.h>

namespace {

// whether a folded launch of TW-point tiles leaves bins for the second
// launch (and needs its scratch part[C][ntile][2])
template <int TW>
__host__ __device__ constexpr bool fold_straddles(int K) {
  return TW % K != 0;
}

template <int TW>
__global__ void __launch_bounds__(256)
fold_straddle_kernel(const float* __restrict__ part,  // [C, ntile, 2]
                     float* __restrict__ out,         // [C, W]
                     int C, int W, int K, int ntile, float mul, float div) {
  const long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= (long long)C * W) return;
  const int c = (int)(i / W), b = (int)(i % W);
  const int ta = b * K / TW, tb = ((b + 1) * K - 1) / TW;
  if (ta == tb) return;  // written by its tile
  const float* p = part + (size_t)c * ntile * 2;
  float v = p[2 * ta + 1];
  for (int t = ta + 1; t < tb; ++t) v += p[2 * t + 1];
  v += p[2 * tb];
  out[(size_t)c * W + b] = v * mul / div;
}

// The second launch on ``stream``; returns its cudaError_t.
template <int TW>
cudaError_t launch_fold_straddle(const float* part, float* out, int C, int W,
                                 int K, int ntile, float mul, float div,
                                 cudaStream_t stream) {
  const long long n = (long long)C * W;
  fold_straddle_kernel<TW><<<(unsigned)((n + 255) / 256), 256, 0, stream>>>(
      part, out, C, W, K, ntile, mul, div);
  return cudaGetLastError();
}

}  // namespace
