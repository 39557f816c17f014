// Fused transit absorption for Hopper (sm_90a): the float32-pipe device
// code shared by the K = 1 kernel (fused_transit.cu) and the folded
// kernel on float32 tables (fused_transit_folded.cu, which holds a
// tensor-core kernel of its own for bfloat16 tables).
//
// Replaces the Pallas TPU kernels bart_tpu/rt/fused.py:_tkernel (which
// _tpallas_batch dispatches for fused_transit) and :_ftkernel (which
// _ftpallas_batch dispatches for fused_transit_folded).  Same math as
// the plain torch versions bart_tpu_torch/rt/fused.py:transit_plain and
// transit_folded_plain: for every chain c and (fine) wavenumber w,
//
//   ext[l]  = sum_r wrows[c, l, r] tab[r, l, w]              (all layers)
//   tau[b]  = sum_{l <= b} G[c, b, l] ext[l]                 (slant path)
//   out     = sum_b wgt[c, b] (1 - exp(-min(tau[b], 88)))   (annuli)
//
// in plain f32 FMAs (no tensor cores, no TF32), as Precision.HIGHEST; a
// bfloat16 table element is widened to f32 first.  Folded (K > 1): the
// table's wn axis is the bin-major fine grid (fine point w = bin K + k),
// and the kernel writes the mean of ``out`` over the K sub-samples of
// each output bin.  The TPU kernel made K an inner grid axis and summed
// the absorption of all layers in a VMEM scratch between grid steps;
// here the K sub-samples of a bin are K neighbouring lanes of the warp
// that is a block's wn tile (K a power of two up to 32), ``out`` is
// linear in the absorption, and the mean is one shuffle reduction of the
// per-lane annulus sums.
// G comes from slant_geometry and is exactly lower-triangular, so the
// terms l > b are zero and skipped: half of the tau work.
//
// Design.  tau couples every layer of a chain, so ext must exist for
// all L layers before the first tau.  The TPU program kept a
// [64 chains, Lp, 256 wn] ext scratch in VMEM (6.5 MB); a Hopper block
// has 227 KB.  Here a block takes TILE_W = 32 wavenumbers (one warp
// wide) x CB = 8 chains (one warp per chain) and keeps ext[CB][Lp][32]
// in shared memory (100 KB at L = 100).  Both phases stream their
// operands through a double-buffered shared-memory stage filled with
// 16-byte cp.async copies, so the next stage's L2 reads are in flight
// while the warps compute on the current one (one block of 8 warps
// fits an SM, too few to hide L2 latency by switching warps).  16-byte
// copies need 16-byte aligned rows: the wrapper pads the row axis of
// wrows (R) and the last axis of G (Lp) to multiples of 4 and the wn
// axis of tab (Fp) to a multiple of 16 bytes, with zeros.  208,000 B of shared memory at
// L = 100; the wrapper raises beyond 227 KB (L > 108).  blockIdx.x
// walks the chain blocks, so the blocks resident at once share one or
// two wn tiles of the table.
//
//  1. Fill, in stages of (CB layers x RC table rows).  Warp ty owns
//     layer g + ty of the group, lane tx wavenumber w0 + tx: per 4 rows,
//     4 conflict-free table words, reused for the 8 chains whose
//     weights are one float4 broadcast each.
//  2. Slant path, in passes of NB = 16 impact parameters.  Warp ty owns
//     chain c0 + ty: per 4 layers, 4 conflict-free ext words and one
//     float4 broadcast of G[c, b, l:l+4] for each of the 16 rows b give
//     64 FMAs into 16 register accumulators.  out accumulates in a
//     register over b and is written once.
//
// Bound on the H100.  Per 512-chain batch at R = 41 (44 padded),
// L = 100, W = 2501: 5.6 G FMAs for ext and 8.9 G for tau (the triangle
// in passes of 16 rows), 0.44 ms at the card's float32 FMA peak.  Both
// inner loops issue 3 shared loads per 8 FMAs, through one block of 8
// warps per SM with two barriers per stage: the fill took 1.76 ms and
// the slant path 1.20 ms of 2.94 ms in a version with NB = 8, RC = 16
// (PERF.md).  The next step is register tiling (several wavenumbers
// per thread) to raise the FMAs per shared load.  expf is the accurate
// library version (no --use_fast_math).

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include "hopper.cuh"   // cp_async16, cp_async_commit, cp_async_wait

#define TILE_W 32    // wavenumbers per block (threadIdx.x, one warp)
#define CB 8         // chains per block (threadIdx.y, one warp each)
#define NB 16        // impact parameters per pass of the slant loop
#define RC 24        // table rows per fill stage

namespace {

constexpr float kTauClamp = 88.0f;
constexpr unsigned kFullMask = 0xffffffffu;

__device__ __forceinline__ float tab_f32(float v) { return v; }
__device__ __forceinline__ float tab_f32(__nv_bfloat16 v) {
  return __bfloat162float(v);
}

static_assert(CB == 8 && TILE_W == 32 && NB % 4 == 0 && RC % 4 == 0,
              "the index arithmetic below assumes these");

// tab holds Rt <= R rows (the rows Rt..R-1 of wrows are zero padding);
// F of its Fp columns are in use, K of them to an output bin
// One block per SM is all its shared memory allows at any useful L, so
// ptxas is told so and may spend registers freely: without the 1 it
// chose 77 for the float instance and ran 15% slower (PERF.md).
template <typename TabT>
__global__ void __launch_bounds__(TILE_W * CB, 1)
fused_transit_kernel(const TabT* __restrict__ tab,      // [Rt, L, Fp]
                     const float* __restrict__ wrows,   // [C, L, R]
                     const float* __restrict__ G,       // [C, L, Lp]
                     const float* __restrict__ wgt,     // [C, L]
                     float* __restrict__ out,           // [C, F / K]
                     int Rt, int R, int L, int F, int Fp, int C, int K) {
  constexpr int EPV = 16 / sizeof(TabT);   // table elements per 16 bytes
  const int Lp = (L + 3) & ~3;
  // shared memory, every part 16-byte aligned: ext_s [CB][Lp][TILE_W],
  // wgt_s [CB][L], then two stage buffers used first by the fill
  // (table [CB][RC][TILE_W] and weights [CB layers][CB chains][RC]
  // each) and then by the slant loop (G [CB][NB][Lp] each)
  extern __shared__ float4 smem4[];
  float* ext_s = reinterpret_cast<float*>(smem4);
  float* wgt_s = ext_s + (size_t)CB * Lp * TILE_W;
  float* scr = wgt_s + ((CB * L + 3) & ~3);
  const int fill_buf = CB * RC * (TILE_W + CB);
  const int g_buf = CB * NB * Lp;

  const int tx = threadIdx.x, ty = threadIdx.y;
  const int tid = ty * TILE_W + tx;
  const int nthreads = TILE_W * CB;
  const int c0 = blockIdx.x * CB;
  const int w0 = blockIdx.y * TILE_W;

  for (int i = tid; i < CB * L; i += nthreads) {
    const int c = c0 + i / L;
    wgt_s[i] = (c < C) ? wgt[(size_t)c * L + i % L] : 0.0f;
  }

  // ---- 1. ext for every layer and chain of the block ----------------
  const int nchunk = (R + RC - 1) / RC;
  const int nstage = ((Lp + CB - 1) / CB) * nchunk;
  // stage st = (layer group st / nchunk, row chunk st % nchunk); rows,
  // layers and wavenumbers beyond Rt, L and Fp are zero-filled and add
  // nothing (layers L..Lp-1 of ext_s come out 0).  The table part of a
  // stage buffer, [CB][RC][TILE_W] of TabT, is sized for f32.
  auto issue_fill = [&](int st) {
    TabT* tb = reinterpret_cast<TabT*>(scr + (st & 1) * fill_buf);
    float* wb = scr + (st & 1) * fill_buf + CB * RC * TILE_W;
    const int g = (st / nchunk) * CB, r0 = (st % nchunk) * RC;
    for (int i = tid; i < CB * RC * TILE_W / EPV; i += nthreads) {
      const int q = i % (TILE_W / EPV), rr = (i / (TILE_W / EPV)) % RC;
      const int j = i / (TILE_W / EPV * RC);
      const int l = g + j, r = r0 + rr, w = w0 + EPV * q;
      const bool ok = l < L && r < Rt && w < Fp;
      cp_async16(tb + EPV * i, ok ? tab + ((size_t)r * L + l) * Fp + w : tab,
                 ok);
    }
    for (int i = tid; i < CB * CB * RC / 4; i += nthreads) {
      const int q = i % (RC / 4), cc = (i / (RC / 4)) % CB;
      const int j = i / (RC / 4 * CB);
      const int c = c0 + cc, l = g + j, r = r0 + 4 * q;
      const bool ok = c < C && l < L && r < R;
      cp_async16(wb + 4 * i, ok ? wrows + ((size_t)c * L + l) * R + r : wrows,
                 ok);
    }
    cp_async_commit();
  };

  float acc[CB];
#pragma unroll
  for (int cc = 0; cc < CB; ++cc) acc[cc] = 0.0f;
  issue_fill(0);
  for (int st = 0; st < nstage; ++st) {
    if (st + 1 < nstage) {
      issue_fill(st + 1);
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();  // stage st has landed for every thread
    const float* sb = scr + (st & 1) * fill_buf;
    const TabT* tcol =
        reinterpret_cast<const TabT*>(sb) + ty * RC * TILE_W + tx;
    const float4* wr4 = reinterpret_cast<const float4*>(
        sb + CB * RC * TILE_W + ty * CB * RC);       // [cc][RC / 4]
#pragma unroll
    for (int rq = 0; rq < RC / 4; ++rq) {
      const float t0 = tab_f32(tcol[(4 * rq) * TILE_W]);
      const float t1 = tab_f32(tcol[(4 * rq + 1) * TILE_W]);
      const float t2 = tab_f32(tcol[(4 * rq + 2) * TILE_W]);
      const float t3 = tab_f32(tcol[(4 * rq + 3) * TILE_W]);
#pragma unroll
      for (int cc = 0; cc < CB; ++cc) {
        const float4 a = wr4[cc * (RC / 4) + rq];
        acc[cc] = fmaf(a.w, t3, fmaf(a.z, t2, fmaf(a.y, t1,
                                                   fmaf(a.x, t0, acc[cc]))));
      }
    }
    if (st % nchunk == nchunk - 1) {  // the group's last rows: store ext
      const int l = (st / nchunk) * CB + ty;
#pragma unroll
      for (int cc = 0; cc < CB; ++cc) {
        if (l < Lp) ext_s[((size_t)cc * Lp + l) * TILE_W + tx] = acc[cc];
        acc[cc] = 0.0f;
      }
    }
    __syncthreads();  // buffer st & 1 is free for stage st + 2
  }

  // ---- 2. slant optical depth and the annulus sum -------------------
  const int npass = (L + NB - 1) / NB;
  // pass p stages G[c0 + cc, p NB + k, 0:l4] as [cc][k][Lp], where l4
  // (a multiple of 4) covers l <= b for the pass's rows; G[b, l] == 0
  // for l > b, so the rest is skipped
  auto issue_g = [&](int p) {
    float* gb = scr + (p & 1) * g_buf;
    const int b0 = p * NB, q4 = (min(b0 + NB, L) + 3) / 4;
    for (int i = tid; i < CB * NB * q4; i += nthreads) {
      const int q = i % q4, k = (i / q4) % NB, cc = i / (q4 * NB);
      const int c = c0 + cc, b = b0 + k;
      const bool ok = c < C && b < L;
      cp_async16(gb + (cc * NB + k) * Lp + 4 * q,
                 ok ? G + ((size_t)c * L + b) * Lp + 4 * q : G, ok);
    }
    cp_async_commit();
  };

  const float* e = ext_s + (size_t)ty * Lp * TILE_W + tx;
  float acc_out = 0.0f;
  issue_g(0);
  for (int p = 0; p < npass; ++p) {
    if (p + 1 < npass) {
      issue_g(p + 1);
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();  // pass p's G has landed (and, at p = 0, all of ext)
    const int b0 = p * NB, q4 = (min(b0 + NB, L) + 3) / 4;
    const float4* g4 = reinterpret_cast<const float4*>(
        scr + (p & 1) * g_buf + (size_t)ty * NB * Lp);   // [k][Lp / 4]
    float tau[NB];
#pragma unroll
    for (int k = 0; k < NB; ++k) tau[k] = 0.0f;
#pragma unroll 2
    for (int lq = 0; lq < q4; ++lq) {
      const float x0 = e[(4 * lq) * TILE_W], x1 = e[(4 * lq + 1) * TILE_W];
      const float x2 = e[(4 * lq + 2) * TILE_W], x3 = e[(4 * lq + 3) * TILE_W];
#pragma unroll
      for (int k = 0; k < NB; ++k) {
        const float4 a = g4[k * (Lp / 4) + lq];
        tau[k] = fmaf(a.w, x3, fmaf(a.z, x2, fmaf(a.y, x1,
                                                  fmaf(a.x, x0, tau[k]))));
      }
    }
#pragma unroll
    for (int k = 0; k < NB; ++k) {
      const float wk = (b0 + k < L) ? wgt_s[ty * L + b0 + k] : 0.0f;
      acc_out = fmaf(wk, 1.0f - expf(-fminf(tau[k], kTauClamp)), acc_out);
    }
    __syncthreads();  // buffer p & 1 is free for pass p + 2
  }
  const int w = w0 + tx, c = c0 + ty;
  if (K == 1) {
    if (w < F && c < C) out[(size_t)c * F + w] = acc_out;
    return;
  }
  // folded: lane tx is sub-sample tx % K of bin w / K (w0 and TILE_W are
  // multiples of K); columns F..Fp-1 are zero and their groups not written
  float v = acc_out;
  for (int o = K >> 1; o > 0; o >>= 1) v += __shfl_xor_sync(kFullMask, v, o);
  if ((tx & (K - 1)) == 0 && w < F && c < C)
    out[(size_t)c * (F / K) + w / K] = v / (float)K;
}

// Launch on ``stream``; returns the cudaError_t of the launch.
template <typename TabT>
int launch_transit(const void* tab, const float* wrows, const float* G,
                   const float* wgt, float* out, int Rt, int R, int L, int F,
                   int Fp, int C, int K, cudaStream_t stream) {
  constexpr int EPV = 16 / sizeof(TabT);
  if (Rt < 1 || Rt > R || R % 4 != 0 || L < 1 || F < 1 || C < 1 || F > Fp ||
      Fp % EPV != 0 || K < 1 || K > 32 || (K & (K - 1)) != 0 || F % K != 0 ||
      (F + TILE_W - 1) / TILE_W > 65535)
    return (int)cudaErrorInvalidValue;
  const size_t Lp = (L + 3) & ~3;
  const size_t fill = 2 * (size_t)CB * RC * (TILE_W + CB);
  const size_t slant = 2 * (size_t)CB * NB * Lp;
  const size_t smem =
      sizeof(float) * ((size_t)CB * Lp * TILE_W + ((CB * L + 3) & ~3) +
                       (fill > slant ? fill : slant));
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        fused_transit_kernel<TabT>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  const dim3 block(TILE_W, CB);
  const dim3 grid((C + CB - 1) / CB, (F + TILE_W - 1) / TILE_W);
  fused_transit_kernel<TabT><<<grid, block, smem, stream>>>(
      static_cast<const TabT*>(tab), wrows, G, wgt, out, Rt, R, L, F, Fp, C,
      K);
  return (int)cudaGetLastError();
}

}  // namespace
