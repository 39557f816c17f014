// Fused transit absorption on tensor cores, for Hopper (sm_90a): the
// kernel shared by the K = 1 entry (fused_transit.cu) and the folded
// entry (fused_transit_folded.cu).
//
// Replaces the Pallas TPU kernels bart_tpu/rt/fused.py:_tkernel (which
// _tpallas_batch dispatches for fused_transit) and :_ftkernel (which
// _ftpallas_batch dispatches for fused_transit_folded).  Same math as the
// plain torch versions bart_tpu_torch/rt/fused.py:transit_plain and
// transit_folded_plain: for every chain c and (fine) wavenumber w,
//
//   ext[l]  = sum_r wrows[c, l, r] tab[r, l, w]              (all layers)
//   tau[b]  = sum_{l <= b} G[c, b, l] ext[l]                 (slant path)
//   a       = sum_b wgt[c, b] (1 - exp(-min(tau[b], 88)))   (annuli)
//
// and out[c, bin] is the mean of a over the bin's K sub-samples (fine
// point w = bin K + k; K = 1: out = a), for any K >= 1.  G comes from
// slant_geometry and is exactly lower-triangular, so the terms l > b are
// skipped.
//
// Design.  tau couples every layer of a chain, so ext of all layers stays
// in shared memory in float32: a block is FT_W = 32 (fine) wavenumbers x
// FT_CB = 8 chains, 8 warps, one block per SM.
//
//  1. Fill, on tensor cores.  Per layer the product is [32 wavenumbers x
//     Rp rows] x [Rp x 8 chains].  Warp j takes the layers j, j + 8, ...
//     in units of one k-step of table rows: it copies the unit's table
//     tile and float32 weights into its own ring of FT_NS = 5 units
//     (cp.async, four units in flight while one is multiplied), keeps
//     independent accumulators (2 m-tiles x the passes) and writes the
//     layer's row of ext_s.  No block barrier in this phase; a lane's
//     copies differ from unit to unit by an offset only, so no division
//     is left in the loop (a first version spent more time on the copies'
//     index arithmetic than on anything else).
//     bfloat16 table (the publication path): exactly.  A table element
//     has 8 significant bits and each float32 weight is split in
//     registers into three bfloat16 parts that sum to it bit for bit (the
//     rule of bart_tpu_torch.rt.fused.split_bf16), so every product is
//     exact in float32 and three mma.sync.m16n8k16 passes per 16 rows
//     give the float32 contraction.
//     float32 table (every K = 1 launch; bart_tpu's Precision.HIGHEST
//     path): in 3xTF32, as the slant product below: table and weights are
//     split in registers into big + small and small x big + big x small +
//     big x big on mma.sync.m16n8k8 per 8 rows keeps every product to
//     2^-21 of the float32 one; the A fragment is read with plain loads
//     from a tile whose row stride is 8 mod 32 words (lane (g, t) ->
//     bank 8 t + g).  One pass would be 2^-11 off.
//  2. Slant path in 3xTF32: G and ext are float32; each is split in
//     registers into big = tf32(x) and small = x - big, and
//     small x big + big x small + big x big on mma.sync.m16n8k8 keeps the
//     product to 2^-21.  Warp c owns chain c: tau[b, w] for all b and
//     its 32 wavenumbers accumulates in registers (7 x 4 fragments)
//     while the warp walks l in steps of 8, streaming G[c, :, l:l+8]
//     through its own two shared-memory buffers (cp.async; no block
//     barrier in this phase either).  The wrapper lays G out in tiles
//     [C, Lk / 8, Lm, 8], so a step's rows are one contiguous piece and
//     every request a full line.  G is lower-triangular, so the 16-row
//     blocks above the diagonal are neither copied nor multiplied.  The
//     exponential, the annulus weights and the sum over b run on the
//     accumulator fragments; shuffles and 32 words of shared memory
//     finish the sum over b and the mean over k.  Where K divides the
//     32-point tile lane j adds bin j's K sub-samples.  For any other K
//     the tiles stay aligned to fine points (their 16-byte cp.async
//     copies) and a bin may straddle two tiles or span several: lane j
//     adds the sub-samples of the tile's j-th bin that the tile holds, in
//     the order of their fine points, writes a bin that lies in the tile
//     and leaves the sum of a cut bin in a scratch [C][ntile][2], which a
//     second launch adds in tile order (fold_straddle.cuh; no atomics).
//  Shared-memory words are swizzled, not padded, where padding would cost
//  the room for the stages: ext_s rows by their layer, G rows by their
//  row (conflict-free fragment loads, checked in the comments below).
//  The chain blocks are the grid's x and the wavenumber tiles its y, and
//  past 65,535 tiles its y and z (kTiled; hopper.cuh: tile_grid), so any
//  fine axis below 2^31 - 64 points fits; the table, the weights, G and
//  the outputs are read and written through 64-bit offsets, so a table
//  may hold any number of elements.  Two resident instances, not one
//  index for both: read through grid_tile at every size, the tile cost
//  the folded launches 1-2.5% at K = 2-8 (ab_kernels.py on an NVIDIA
//  H100 80GB HBM3 at 700 W).
//
// Many layers (L > 16 FT_MT = 112: the streamed variant,
// fused_transit_stream_kernel).  Then neither ext of all layers (1 KB a
// layer of 8 chains) fits shared memory nor tau of all annuli a warp's
// registers, so ext makes a round trip through a global scratch, and
// nothing ties an item to 8 chains or one tile any more.  What bound the
// resident tile's reuse no longer binds, and the design is the copies':
// each byte copied into shared memory serves as many products as the
// registers allow.
//  - An item is FT_SG x FT_CB = 32 chains x FT_SW = 2 tiles (64 points),
//    walked by persistent blocks (one an SM; chain blocks fastest, so the
//    blocks in flight share a few tiles in L2), and warp pair p (warps
//    2 p, 2 p + 1) works as one: warp h of the pair takes the item's tile
//    h.  Fill: pair p takes the layers p, p + 4, ... in units of one
//    k-step: the table rows of both tiles and the weights of all 32
//    chains, each warp copying half through the pair's ring of FT_SNS
//    units (a named barrier of the pair, bar.sync 1 + p, a unit); a warp
//    multiplies its tile's columns by the FT_SG chain groups' weights
//    (FT_SG x 2 m-tiles of accumulators a pass).  So the table is copied
//    once per 32 chains and the weights once per 64 points: what a
//    cluster of blocks with multicast loads would save, without a
//    cluster or a tensor map.  A bfloat16 table's weight rows are 16
//    floats with their 8-float halves swapped by bit 1 of the chain
//    (swizzle, not padding).
//  - ext goes to the block's scratch [FT_SW][32][Lk][FT_W] (nslot x 8 KB
//    a layer), and the slant product takes the item's chains in rounds,
//    pair p chain 4 s + p in round s, warp h its tile h, each as the
//    resident kernel's warp does, in groups of at most FT_MT 16-row
//    blocks of annuli: per group the pair walks l up to the group's last
//    row, staging the group's rows of the G tile once for both warps
//    (each copies half; the pair's barrier a step) and each warp its
//    tile's 8 ext rows of the step (cp.async, two stages), and adds the
//    group's annuli into the sum before the next group.  So G is copied
//    once per 64 points.  A round copies its chain's annulus weights into
//    the pair's row of shared memory, 16 bytes a layer in all.
// Every ext, tau and sum takes its terms in the order the resident kernel
// takes them (each accumulator sees the same products in the same
// order; the chain groups and the pairs only interleave independent
// accumulators), so the results are those a block with unbounded
// registers would give.  Shared memory is the annulus weights and the
// larger of the fill rings and the slant stages (68 / 60 KB): any L up to
// 10,176 fits on a bfloat16 table, 10,688 on a float32 one.
//
// Bound on the H100.  Folded, per 512-chain batch at R = 41, L = 100,
// 1,064 fine bins, K = 32: 71.5 G FMAs of fill (three bfloat16 passes:
// 0.43 ms at the dense bfloat16 peak) and 88.0 G of slant triangle (three
// TF32 passes on 16-row blocks: 1.2 ms at the dense TF32 peak); one
// exponential and one FMA per (chain, annulus, fine point) stay on the
// float32 pipes (1.7 G exponentials: 0.42 ms).  Shared-memory traffic
// from L2 at this tile: the table (279 MB) once per chain block, 64 x
// 279 MB = 17.9 GB; per tile of 32 fine points the weights (9.8 MB) and
// the lower blocks of G (14.4 MB): 1,064 x 24.2 MB = 25.8 GB; 43.7 GB
// per launch, which the tile (8 chains x 32 points, set by ext's 107 KB
// of shared memory and tau's 112 registers a thread) does not lower.
// Copies and compute each take about 10 ms alone and run mostly one
// after the other: the fill is copy-bound, the slant compute-bound.
// K = 1, at W = 2501 on a float32 table: 6.1 G FMAs of fill over 48
// padded rows and 6.5 G of slant triangle, three TF32 passes each:
// 0.15 ms at the dense TF32 peak; from L2 the table (41 MB) 64 times and
// weights and G 79 times: 4.5 GB.  Measured on an NVIDIA H100 80GB HBM3
// at 700 W: 1.70 ms a launch at K = 1 (2.82 ms for the float32-pipe
// version), the copies alone 1.07 ms (4.3 TB/s from L2), compute alone
// 0.91; folded, 14.6 ms a launch (PERF.md has the ablations).  expf is
// the accurate library version (no --use_fast_math).

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include "fold_straddle.cuh"
#include "hopper.cuh"

#define FT_W 32      // (fine) wavenumbers per block
#define FT_CB 8      // chains per block, one warp each
#define FT_NS 5      // units (one k-step of table rows of one layer) in a
                     // warp's ring (3 to 8 units time the same at K = 1)
#define FT_MT 7      // 16-row blocks of tau a warp holds: L <= 112 keeps
                     // them all (above, the streamed variant's group)
#define FT_SG 4      // streamed variant: chain groups of FT_CB an item
#define FT_SW 2      // streamed variant: tiles an item, one a warp of a pair
#define FT_SNS 4     // streamed variant: units in a warp pair's ring

// Timing aid (ablate_folded.py, with --k1 for K = 1): -DBART_ABLATE=<bits>
// builds the kernel without 1 its global -> shared copies, 2 its fill
// products, 4 its exponentials, 8 with the wavenumber tiles, not the
// chain blocks, on the grid's fast axis (the streamed variant: its items
// tile-major), 16 without its slant products, 32, 64, 128 with zeros in
// place of the table, the weights, G.  All but 8 give wrong results.
#ifndef BART_ABLATE
#define BART_ABLATE 0
#endif

namespace {

constexpr float kTauClamp = 88.0f;
constexpr unsigned kFullMask = 0xffffffffu;

constexpr int kES = FT_W;       // row stride of ext_s; the 8-column groups
                                // of row l are swapped by l & 3 (swizzle)
constexpr int kTS = FT_W + 8;   // row stride of a table tile, in elements:
                                // bfloat16, 16-byte rows 80 bytes apart hit
                                // all banks; float32, 40 = 8 mod 32 words
constexpr int kGS = 8;          // row stride of a G stage; the two 16-byte
                                // halves of row b are swapped by (b >> 2) & 1
constexpr int kWF = 16 + 8;     // bfloat16 table: row stride of a unit's
                                // weights, in floats: a half-warp's 8-byte
                                // loads hit all banks
constexpr int kWF32 = 8 + 4;    // float32 table: lane (g, t) -> bank
                                // 12 g + t (+ 4), all different
// a fill unit of a bfloat16 table: rows [16][kTS] bfloat16, weights
// [FT_CB][kWF] float32; of a float32 table: rows [8][kTS] float32,
// weights [FT_CB][kWF32] float32
constexpr int kUnitBytes = 2 * 16 * kTS + 4 * FT_CB * kWF;
constexpr int kUnitBytes32 = 4 * 8 * kTS + 4 * FT_CB * kWF32;
// the streamed variant's items: kSCB chains x FT_SW tiles; its units hold
// the table rows of the FT_SW tiles, row stride kTS2 (bfloat16: 16-byte
// rows 144 bytes apart hit all banks; float32: 72 = 8 mod 32 words), and
// the weights of all kSCB chains: bfloat16 table, [kSCB][kSWF] float32,
// the two 8-float halves of chain q's row swapped by (q >> 1) & 1 (a
// half-warp's 8-byte loads hit all banks); float32 table, [kSCB][kWF32]
constexpr int kSCB = FT_SG * FT_CB;
constexpr int kTS2 = FT_SW * FT_W + 8;
constexpr int kSWF = 16;
constexpr int kSUnitBytes = 2 * 16 * kTS2 + 4 * kSCB * kSWF;
constexpr int kSUnitBytes32 = 4 * 8 * kTS2 + 4 * kSCB * kWF32;
static_assert(FT_W == 32 && FT_CB == 8 && FT_SG == 4 && FT_SW == 2,
              "the warp tiling and the streamed units' copies assume these");
static_assert(kUnitBytes % 16 == 0 && kUnitBytes32 % 16 == 0 &&
                  kSUnitBytes % 16 == 0 && kSUnitBytes32 % 16 == 0,
              "units keep the ring's 16-byte alignment");

// Bytes of shared memory for L layers: ext_s [FT_CB][Lk kES + 4], wgt_s
// [FT_CB][Lm], then the larger of the warps' fill rings (FT_NS units
// each) and their G stages (2 x [Lm][kGS] float32 each); Lk, Lm = L
// rounded up to 8, 16.  The row count does not enter.
__host__ __device__ constexpr size_t ft_ext_bytes(int L) {
  return 4 * ((size_t)FT_CB * ((size_t)((L + 7) & ~7) * kES + 4) +
              (size_t)FT_CB * ((L + 15) & ~15));
}
__host__ __device__ constexpr size_t ft_slant_bytes(int L) {
  return (size_t)FT_CB * 2 * ((L + 15) & ~15) * kGS * 4;
}
__host__ __device__ constexpr size_t ft_smem_bytes(int L, int unit_bytes) {
  const size_t fill = (size_t)FT_CB * FT_NS * unit_bytes;
  const size_t slant = ft_slant_bytes(L);
  return ft_ext_bytes(L) + (fill > slant ? fill : slant);
}
// The streamed variant: wgt_s [FT_CB / FT_SW][Lm] float32 (the annulus
// weights of each warp pair's chain of the round), then the larger of the
// pairs' fill rings (FT_SNS streamed units each) and the slant's stages:
// each pair's two of a group's G rows [16 FT_MT][kGS] and each warp's two
// of ext's rows of a step [8][kES], float32.
__host__ __device__ constexpr size_t ft_wgt_bytes(int L) {
  return 4 * (size_t)(FT_CB / FT_SW) * ((L + 15) & ~15);
}
__host__ __device__ constexpr size_t ft_stream_stage_words() {
  return (size_t)(FT_CB / FT_SW) * 2 * 16 * FT_MT * kGS + FT_CB * 2 * 8 * kES;
}
__host__ __device__ constexpr size_t ft_stream_smem_bytes(int L,
                                                          int unit_bytes) {
  const size_t fill = (size_t)(FT_CB / FT_SW) * FT_SNS * unit_bytes;
  const size_t slant = 4 * ft_stream_stage_words();
  return ft_wgt_bytes(L) + (fill > slant ? fill : slant);
}

// (x0, x1) -> the three bfloat16 parts of each, packed x0 low, x1 high
// as a B fragment wants them: hi = bf16(x), mid = bf16(x - hi),
// lo = bf16(x - hi - mid), round to nearest even, as
// bart_tpu_torch.rt.fused.split_bf16 states the rule
__device__ __forceinline__ void split_bf16x2(float x0, float x1, uint32_t& lo,
                                             uint32_t& mid, uint32_t& hi) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(x0, x1);
  const float r0 = x0 - __low2float(h), r1 = x1 - __high2float(h);
  const __nv_bfloat162 m = __floats2bfloat162_rn(r0, r1);
  const __nv_bfloat162 l =
      __floats2bfloat162_rn(r0 - __low2float(m), r1 - __high2float(m));
  hi = *reinterpret_cast<const uint32_t*>(&h);
  mid = *reinterpret_cast<const uint32_t*>(&m);
  lo = *reinterpret_cast<const uint32_t*>(&l);
}

// The end of a warp's chain c on its tile at w0: col[2 nt + j], this
// lane's sum over its rows b of wgt (1 - e^-tau) at wavenumber
// 8 nt + 2 t + j, summed over the warp's rows and then over each output
// bin's sub-samples into out, or, for a bin the tile cuts, into part
// (fold_straddle.cuh).  col_s: 32 words of the warp's own shared memory,
// which no lane reads or writes any more.
__device__ __forceinline__ void ft_store_bins(
    float (&col)[8], float* col_s, int lane, int t, int g, int c, int w0,
    int C, int F, int K, int ntile, float* __restrict__ out,
    float* __restrict__ part) {
#pragma unroll
  for (int k = 0; k < 8; ++k) {
    col[k] += __shfl_xor_sync(kFullMask, col[k], 4);
    col[k] += __shfl_xor_sync(kFullMask, col[k], 8);
    col[k] += __shfl_xor_sync(kFullMask, col[k], 16);
  }
  __syncwarp();          // every lane is done with the G stages
  if (g == 0) {
#pragma unroll
    for (int k = 0; k < 8; ++k) col_s[8 * (k >> 1) + 2 * t + (k & 1)] = col[k];
  }
  __syncwarp();
  if (FT_W % K == 0) {
    // the tile holds whole bins: lane j sums bin j's K sub-samples
    if (lane < FT_W / K) {
      float v = 0.0f;
      for (int k = 0; k < K; ++k) v += col_s[lane * K + k];
      const int w = w0 + lane * K;
      if (w < F && c < C) out[(size_t)c * (F / K) + w / K] = v / (float)K;
    }
  } else {
    // any other K: lane j sums the sub-samples of the tile's j-th bin
    // that the tile holds, in the order of their fine points (at most
    // (FT_W - 1) / K + 2 <= 12 bins); a bin cut by the tile leaves its
    // sum in part for the second launch (fold_straddle.cuh)
    const int W = F / K, b0 = w0 / K, we = w0 + FT_W;
    const int b = b0 + lane;
    if (b <= (we - 1) / K && b < W && c < C) {
      const int lo = max(b * K, w0), hi = min((b + 1) * K, we);
      float v = 0.0f;
      for (int w = lo; w < hi; ++w) v += col_s[w - w0];
      if (b * K >= w0 && (b + 1) * K <= we)
        out[(size_t)c * W + b] = v / (float)K;
      else
        part[((size_t)c * ntile + w0 / FT_W) * 2 + ((b + 1) * K > we)] = v;
    }
  }
}

// TabT: __nv_bfloat16 or float.  tab holds Rt <= Rp rows (the rows
// Rt..Rp-1 of wrows are zero padding); F of its Fp columns are in use, K
// of them to an output bin.  The resident kernel, L <= 16 FT_MT.  part:
// the partial sums of the bins that straddle the FT_W-point tiles,
// [C][ntile][2] (K not dividing FT_W; fold_straddle.cuh).  kTiled: past
// 65,535 tiles, its tile read through grid_tile (else blockIdx.y).
template <typename TabT, bool kTiled>
__global__ void __launch_bounds__(32 * FT_CB, 1)
fused_transit_mma_kernel(
    const TabT* __restrict__ tab,              // [Rt, L, Fp]
    const float* __restrict__ wrows,           // [C, L, Rp]
    const float* __restrict__ Gt,              // [C, Lk / 8, Lm, 8] tiles
    const float* __restrict__ wgt,             // [C, L]
    float* __restrict__ out,                   // [C, F / K]
    float* __restrict__ part,
    int Rt, int Rp, int L, int F, int Fp, int C, int K, int ntile) {
  constexpr bool kBf16 = sizeof(TabT) == 2;
  constexpr int NT = 32 * FT_CB;
  constexpr int UR = kBf16 ? 16 : 8;            // table rows of a unit
  constexpr int UB = kBf16 ? kUnitBytes : kUnitBytes32;
  const int Lk = (L + 7) & ~7, Lm = (L + 15) & ~15;
  const int CS = Lk * kES + 4;                   // chain stride of ext_s
  const int KS = Rp / UR;
  extern __shared__ float4 smem4[];
  float* ext_s = reinterpret_cast<float*>(smem4);          // [FT_CB][CS]
  float* wgt_s = ext_s + (size_t)FT_CB * CS;               // [FT_CB][Lm]
  unsigned char* scr = reinterpret_cast<unsigned char*>(wgt_s + FT_CB * Lm);

  const int tid = threadIdx.x;
  const int lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, t = lane & 3;
  // past 65,535 tiles a block past the last one returns
  const int tile = kTiled ? grid_tile()
                   : (BART_ABLATE & 8) ? (int)blockIdx.x : (int)blockIdx.y;
  if (kTiled && tile >= ntile) return;
  const int c0 = ((BART_ABLATE & 8) ? blockIdx.y : blockIdx.x) * FT_CB;
  const int w0 = tile * FT_W;

  for (int i = tid; i < FT_CB * Lm; i += NT) {
    const int c = c0 + i / Lm, b = i % Lm;
    wgt_s[i] = (c < C && b < L) ? wgt[(size_t)c * L + b] : 0.0f;
  }

  // ---- 1. ext for every layer and chain of the block -------------------
  // Warp j takes the layers j, j + 8, ... < Lk in units of UR table rows
  // (one k-step), each through its own ring of FT_NS units, so this
  // phase has no block barrier.  Rows beyond Rt, layers beyond L, columns
  // beyond Fp and chains beyond C are zero-filled, so layers L..Lk-1 of
  // ext_s come out 0.  A lane's copies differ from unit to unit by an
  // offset only.  The weights come as float32 and are split in registers.
  {
    unsigned char* ring = scr + (size_t)warp * FT_NS * UB;
    // table: 16-byte chunk tq of rows tr, tr + UR / 2; weights: chunk wq
    // of chain wc (a float32 table's 16 chunks take half the lanes)
    const int tq = kBf16 ? lane & 3 : lane & 7;
    const int tr = kBf16 ? lane >> 2 : lane >> 3;
    const int wq = kBf16 ? lane & 3 : lane & 1;
    const int wc = kBf16 ? lane >> 2 : (lane >> 1) & 7;
    constexpr int EPC = 16 / sizeof(TabT);    // table elements per chunk
    const bool t_ok = w0 + EPC * tq < Fp && !(BART_ABLATE & 32);
    const bool w_ok = c0 + wc < C && !(BART_ABLATE & 64);
    const TabT* t_src = tab + (size_t)tr * L * Fp + w0 + EPC * tq;
    const float* w_src =
        wrows + (size_t)(w_ok ? c0 + wc : 0) * L * Rp + 4 * wq;
    // unit (layer l, k-step ks) into ring slot ``slot``
    auto copy_unit = [&](int l, int ks, int slot) {
      if (BART_ABLATE & 1) return;
      TabT* tb = reinterpret_cast<TabT*>(ring + slot * UB);
      float* wf = reinterpret_cast<float*>(tb + UR * kTS);
      const bool lok = l < L;
#pragma unroll
      for (int k = 0; k < 2; ++k) {
        const int r = UR * ks + tr + (UR / 2) * k;
        const bool ok = lok && t_ok && r < Rt;
        cp_async16(tb + (tr + (UR / 2) * k) * kTS + EPC * tq,
                   ok ? t_src + ((size_t)(r - tr) * L + l) * Fp : tab, ok);
      }
      if (kBf16 || lane < 16) {
        const bool ok = lok && w_ok;
        cp_async16(wf + wc * (kBf16 ? kWF : kWF32) + 4 * wq,
                   ok ? w_src + (size_t)l * Rp + UR * ks : wrows, ok);
      }
    };

    int nunit = 0;                           // this warp's units
    for (int l = warp; l < Lk; l += FT_CB) nunit += KS;
    int il = warp, iks = 0, islot = 0;       // the next unit to copy
    auto copy_next = [&]() {
      copy_unit(il, iks, islot);
      if (++iks == KS) { iks = 0; il += FT_CB; }
      if (++islot == FT_NS) islot = 0;
    };
    for (int u = 0; u < FT_NS - 1; ++u) {
      if (u < nunit) copy_next();
      cp_async_commit();
    }
    int slot = 0;
    for (int l = warp, u = 0; l < Lk; l += FT_CB) {
      // acc[m][p]: 16 wavenumbers m x 8 chains; bfloat16 table: weight
      // part p; float32 table: p = 0 the two small products, 1 the big one
      float acc[2][3][4];
#pragma unroll
      for (int m = 0; m < 2; ++m)
#pragma unroll
        for (int p = 0; p < 3; ++p)
#pragma unroll
          for (int i = 0; i < 4; ++i) acc[m][p][i] = 0.0f;
      for (int ks = 0; ks < KS; ++ks, ++u) {
        cp_async_wait<FT_NS - 2>();
        __syncwarp();  // unit u has landed; every lane is done with u - 1
        if (u + FT_NS - 1 < nunit) copy_next();
        cp_async_commit();
        const TabT* tb = reinterpret_cast<const TabT*>(ring + slot * UB);
        const float* wf = reinterpret_cast<const float*>(tb + UR * kTS);
        if (++slot == FT_NS) slot = 0;
        if (BART_ABLATE & 2) continue;
        if constexpr (kBf16) {
          // B fragments: (rows 2 t, 2 t + 1 | 2 t + 8, 2 t + 9, chain g)
          const float2 x0 =
              *reinterpret_cast<const float2*>(wf + g * kWF + 2 * t);
          const float2 x1 =
              *reinterpret_cast<const float2*>(wf + g * kWF + 2 * t + 8);
          uint32_t b[3][2];
          split_bf16x2(x0.x, x0.y, b[0][0], b[1][0], b[2][0]);
          split_bf16x2(x1.x, x1.y, b[0][1], b[1][1], b[2][1]);
          uint32_t a[2][4];
#pragma unroll
          for (int m = 0; m < 2; ++m)
            ldmatrix_x4_trans(a[m],
                              tb + ((lane & 7) + ((lane >> 4) << 3)) * kTS +
                                  16 * m + (((lane >> 3) & 1) << 3));
#pragma unroll
          for (int p = 0; p < 3; ++p) {
            mma_bf16(acc[0][p], a[0], b[p]);
            mma_bf16(acc[1][p], a[1], b[p]);
          }
        } else {
          // B fragment: (row t (+ 4), chain g)
          uint32_t bb[2], bs[2];
          split_tf32(wf[g * kWF32 + t], bb[0], bs[0]);
          split_tf32(wf[g * kWF32 + t + 4], bb[1], bs[1]);
#pragma unroll
          for (int m = 0; m < 2; ++m) {
            // A fragment: (wavenumber 16 m + g (+ 8), row t (+ 4))
            const TabT* ta = tb + t * kTS + 16 * m + g;
            uint32_t ab[4], as[4];
            split_tf32(ta[0], ab[0], as[0]);
            split_tf32(ta[8], ab[1], as[1]);
            split_tf32(ta[4 * kTS], ab[2], as[2]);
            split_tf32(ta[4 * kTS + 8], ab[3], as[3]);
            mma_tf32(acc[m][0], as, bb);
            mma_tf32(acc[m][0], ab, bs);
            mma_tf32(acc[m][1], ab, bb);
          }
        }
      }
      // fragment (wavenumber 16 m + g (+ 8), chains 2 t, 2 t + 1); parts
      // summed smallest first
      const int swz = 8 * (l & 3);
      float* e = ext_s + (size_t)(2 * t) * CS + l * kES;
#pragma unroll
      for (int m = 0; m < 2; ++m) {
        float v[4];
#pragma unroll
        for (int i = 0; i < 4; ++i)
          v[i] = (acc[m][0][i] + acc[m][1][i]) + acc[m][2][i];
        const int lo = (16 * m + g) ^ swz, hi = (16 * m + g + 8) ^ swz;
        e[lo] = v[0];
        e[CS + lo] = v[1];
        e[hi] = v[2];
        e[CS + hi] = v[3];
      }
    }
  }
  cp_async_wait<0>();
  __syncthreads();  // ext is complete and the fill rings are free

  // ---- 2. slant optical depth and the annulus sum: warp = chain --------
  const int c = c0 + warp;
  const int nks = Lk / 8, nmt = Lm / 16;
  // a G stage holds the tile's rows [Lm][kGS]
  const int GW = Lm * kGS;
  float* gbuf = reinterpret_cast<float*>(scr) + (size_t)warp * 2 * GW;
  const float* ew = ext_s + (size_t)warp * CS;    // the warp's chain's ext
  // the two 16-byte halves of this lane's rows g, g + 8 of a G stage
  const int h0 = 4 * ((g >> 2) & 1), h1 = 4 - h0;
  // col[2 nt + j]: the sum over this lane's rows b of wgt (1 - e^-tau) at
  // wavenumber 8 nt + 2 t + j
  float col[8];
#pragma unroll
  for (int k = 0; k < 8; ++k) col[k] = 0.0f;
  const float* wg = wgt_s + warp * Lm;

  // step ks stages the tile G[c, b, 8 ks : 8 ks + 8] for the rows b of
  // the 16-row blocks that reach the diagonal (b >= 16 (ks / 2)): one
  // contiguous piece of Gt
  auto copy_g = [&](int ks) {
    if (BART_ABLATE & 1) return;
    float* gb = gbuf + (size_t)(ks & 1) * GW;
    const int b_lo = 16 * (ks >> 1);
    const float* src = Gt + (((size_t)c * nks + ks) * Lm + b_lo) * kGS;
    const bool ok = c < C && !(BART_ABLATE & 128);
    for (int i = lane; i < (Lm - b_lo) * 2; i += 32) {
      const int b = b_lo + (i >> 1), h = (i & 1) ^ ((b >> 2) & 1);
      cp_async16(gb + b * kGS + 4 * h, ok ? src + 4 * i : Gt, ok);
    }
  };

  float tau[FT_MT][4][4];
#pragma unroll
  for (int mt = 0; mt < FT_MT; ++mt)
#pragma unroll
    for (int nt = 0; nt < 4; ++nt)
#pragma unroll
      for (int i = 0; i < 4; ++i) tau[mt][nt][i] = 0.0f;

  copy_g(0);
  cp_async_commit();
  for (int ks = 0; ks < nks; ++ks) {
    cp_async_wait<0>();
    __syncwarp();  // step ks has landed; every lane is done with ks - 1
    if (ks + 1 < nks) copy_g(ks + 1);
    cp_async_commit();
    const float* gb = gbuf + (size_t)(ks & 1) * GW;
    const float* er = ew + (size_t)8 * ks * kES;   // ext's rows 8 ks ..
    uint32_t bb[4][2], bs[4][2];
#pragma unroll
    for (int nt = 0; nt < 4; ++nt) {
      // rows 8 ks + t and + 4 share (l & 3) == t
      const int cw = (8 * nt + g) ^ (8 * t);
      split_tf32(er[t * kES + cw], bb[nt][0], bs[nt][0]);
      split_tf32(er[(t + 4) * kES + cw], bb[nt][1], bs[nt][1]);
    }
#pragma unroll
    for (int mt = 0; mt < FT_MT; ++mt) {
      if (mt >= (ks >> 1) && mt < nmt && !(BART_ABLATE & 16)) {
        // rows 16 mt + g and + 8 share ((b >> 2) & 1)
        const float* ga = gb + (16 * mt + g) * kGS + t;
        uint32_t ab[4], as[4];
        split_tf32(ga[h0], ab[0], as[0]);
        split_tf32(ga[8 * kGS + h0], ab[1], as[1]);
        split_tf32(ga[h1], ab[2], as[2]);
        split_tf32(ga[8 * kGS + h1], ab[3], as[3]);
#pragma unroll
        for (int nt = 0; nt < 4; ++nt) {
          mma_tf32(tau[mt][nt], as, bb[nt]);
          mma_tf32(tau[mt][nt], ab, bs[nt]);
          mma_tf32(tau[mt][nt], ab, bb[nt]);
        }
      }
    }
  }

  // the annuli into the sums, block by block
#pragma unroll
  for (int mt = 0; mt < FT_MT; ++mt) {
    if (mt < nmt) {
      const float w_lo = wg[16 * mt + g], w_hi = wg[16 * mt + g + 8];
#pragma unroll
      for (int nt = 0; nt < 4; ++nt) {
#pragma unroll
        for (int i = 0; i < 4; ++i) {
#if BART_ABLATE & 4
          const float a = fminf(tau[mt][nt][i], kTauClamp);
#else
          const float a = 1.0f - expf(-fminf(tau[mt][nt][i], kTauClamp));
#endif
          col[2 * nt + (i & 1)] =
              fmaf((i & 2) ? w_hi : w_lo, a, col[2 * nt + (i & 1)]);
        }
      }
    }
  }
  ft_store_bins(col, gbuf, lane, t, g, c, w0, C, F, K, ntile, out, part);
}

// The 64 threads of warp pair ``pair`` (warps 2 pair, 2 pair + 1) wait
// for each other; shared-memory writes before it, and asynchronous copies
// each thread waited for, are seen by both warps after it (named barrier
// 1 + pair; 0 is __syncthreads')
__device__ __forceinline__ void pair_sync(int pair) {
  asm volatile("bar.sync %0, 64;\n" ::"r"(1 + pair) : "memory");
}

// The streamed variant, L > 16 FT_MT (design: the header).  ext_g, the
// blocks' scratch [gridDim.x][FT_SW][kSCB][Lk][kES] float32; the other
// arguments as the resident kernel's.  Items (kSCB chains, FT_SW tiles),
// chain blocks fastest (fewer than 2^31: the launcher's check).  Warp
// pair p = warp / 2 shares a fill ring and the slant's G stages; warp h =
// warp % 2 of the pair takes the item's tile h.
template <typename TabT>
__global__ void __launch_bounds__(32 * FT_CB, 1)
fused_transit_stream_kernel(
    const TabT* __restrict__ tab,              // [Rt, L, Fp]
    const float* __restrict__ wrows,           // [C, L, Rp]
    const float* __restrict__ Gt,              // [C, Lk / 8, Lm, 8] tiles
    const float* __restrict__ wgt,             // [C, L]
    float* __restrict__ out,                   // [C, F / K]
    float* __restrict__ ext_g,
    float* __restrict__ part,
    int Rt, int Rp, int L, int F, int Fp, int C, int K, int ntile) {
  constexpr bool kBf16 = sizeof(TabT) == 2;
  constexpr int NP = FT_CB / FT_SW;             // warp pairs
  constexpr int UR = kBf16 ? 16 : 8;            // table rows of a unit
  constexpr int UB = kBf16 ? kSUnitBytes : kSUnitBytes32;
  constexpr int WS = kBf16 ? kSWF : kWF32;      // a chain's weights' stride
  const int Lk = (L + 7) & ~7, Lm = (L + 15) & ~15;
  const int CS = Lk * kES;                       // chain stride of ext
  const int KS = Rp / UR;
  extern __shared__ float4 smem4[];
  float* wgt_s = reinterpret_cast<float*>(smem4);          // [NP][Lm]
  unsigned char* scr = reinterpret_cast<unsigned char*>(wgt_s + NP * Lm);

  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int pair = warp >> 1, h = warp & 1;
  const int g = lane >> 2, t = lane & 3;
  // this warp's tile's ext in the block's scratch, [kSCB][Lk][kES]
  float* ext = ext_g + ((size_t)blockIdx.x * FT_SW + h) * kSCB * CS;
  const int ncb = (C + kSCB - 1) / kSCB;
  const int nwt = (ntile + FT_SW - 1) / FT_SW;  // the items' tiles
  const int nitem = ncb * nwt;
  for (int item = blockIdx.x; item < nitem; item += gridDim.x) {
  const int c0 = ((BART_ABLATE & 8) ? item / nwt : item % ncb) * kSCB;
  // the item's first point, and this warp's tile's
  const int i0 = ((BART_ABLATE & 8) ? item % nwt : item / ncb) * FT_SW * FT_W;
  const int w0 = i0 + h * FT_W;
  if (item != (int)blockIdx.x)
    __syncthreads();  // every warp is done with the previous item

  // ---- 1. ext for every layer and chain of the item --------------------
  // The resident kernel's fill, by warp pairs: pair p takes the layers p,
  // p + NP, ... in units of UR table rows (the rows of the item's FT_SW
  // tiles and the weights of its kSCB chains), through its own ring of
  // FT_SNS units; each warp copies half of a unit, and multiplies its
  // tile's columns by the weights of the FT_SG chain groups.
  {
    unsigned char* ring = scr + (size_t)pair * FT_SNS * UB;
    // table: 16-byte chunk tq of rows tr, tr + UR / 2 of this warp's
    // columns; weights: chunk wq of the chains q_k = 16 h + wc + 8 k of
    // this warp's half, k < NWC
    const int tq = kBf16 ? lane & 3 : lane & 7;
    const int tr = kBf16 ? lane >> 2 : lane >> 3;
    const int wq = kBf16 ? lane & 3 : lane & 1;
    const int wc = kBf16 ? lane >> 2 : lane >> 1;
    constexpr int NWC = kBf16 ? 2 : 1;
    constexpr int EPC = 16 / sizeof(TabT);    // table elements per chunk
    const bool t_ok = w0 + EPC * tq < Fp && !(BART_ABLATE & 32);
    const TabT* t_src = tab + (size_t)tr * L * Fp + w0 + EPC * tq;
    const int t_dst = tr * kTS2 + h * FT_W + EPC * tq;
    const float* w_src[NWC];
    bool w_ok[NWC];
    int w_dst[NWC];
#pragma unroll
    for (int k = 0; k < NWC; ++k) {
      const int q = (kSCB / FT_SW) * h + wc + 8 * k;
      w_ok[k] = c0 + q < C && !(BART_ABLATE & 64);
      w_src[k] = wrows + (size_t)(w_ok[k] ? c0 + q : 0) * L * Rp + 4 * wq;
      // bfloat16: the halves of chain q's row swapped by (q >> 1) & 1
      w_dst[k] = q * WS + 4 * (kBf16 ? wq ^ (((q >> 1) & 1) << 1) : wq);
    }
    auto copy_unit = [&](int l, int ks, int slot) {
      if (BART_ABLATE & 1) return;
      TabT* tb = reinterpret_cast<TabT*>(ring + slot * UB);
      float* wf = reinterpret_cast<float*>(tb + UR * kTS2);
      const bool lok = l < L;
#pragma unroll
      for (int k = 0; k < 2; ++k) {
        const int r = UR * ks + tr + (UR / 2) * k;
        const bool ok = lok && t_ok && r < Rt;
        cp_async16(tb + t_dst + (UR / 2) * k * kTS2,
                   ok ? t_src + ((size_t)(r - tr) * L + l) * Fp : tab, ok);
      }
      const size_t wo = (size_t)l * Rp + UR * ks;
#pragma unroll
      for (int k = 0; k < NWC; ++k) {
        const bool ok = lok && w_ok[k];
        cp_async16(wf + w_dst[k], ok ? w_src[k] + wo : wrows, ok);
      }
    };

    int nunit = 0;                           // the pair's units
    for (int l = pair; l < Lk; l += NP) nunit += KS;
    int il = pair, iks = 0, islot = 0;       // the next unit to copy
    auto copy_next = [&]() {
      copy_unit(il, iks, islot);
      if (++iks == KS) { iks = 0; il += NP; }
      if (++islot == FT_SNS) islot = 0;
    };
    for (int u = 0; u < FT_SNS - 1; ++u) {
      if (u < nunit) copy_next();
      cp_async_commit();
    }
    int slot = 0;
    for (int l = pair, u = 0; l < Lk; l += NP) {
      // acc[s][m][p]: 16 wavenumbers m x the 8 chains of group s; p as
      // the resident kernel's
      float acc[FT_SG][2][3][4];
#pragma unroll
      for (int s = 0; s < FT_SG; ++s)
#pragma unroll
        for (int m = 0; m < 2; ++m)
#pragma unroll
          for (int p = 0; p < 3; ++p)
#pragma unroll
            for (int i = 0; i < 4; ++i) acc[s][m][p][i] = 0.0f;
      for (int ks = 0; ks < KS; ++ks, ++u) {
        cp_async_wait<FT_SNS - 2>();
        // unit u has landed, both halves; both warps are done with u - 1
        pair_sync(pair);
        if (u + FT_SNS - 1 < nunit) copy_next();
        cp_async_commit();
        const TabT* tb =
            reinterpret_cast<const TabT*>(ring + slot * UB) + h * FT_W;
        const float* wf = reinterpret_cast<const float*>(
            reinterpret_cast<const TabT*>(ring + slot * UB) + UR * kTS2);
        if (++slot == FT_SNS) slot = 0;
        if (BART_ABLATE & 2) continue;
        if constexpr (kBf16) {
          uint32_t a[2][4];
#pragma unroll
          for (int m = 0; m < 2; ++m)
            ldmatrix_x4_trans(a[m],
                              tb + ((lane & 7) + ((lane >> 4) << 3)) * kTS2 +
                                  16 * m + (((lane >> 3) & 1) << 3));
          // chain 8 s + g's row: bit 1 of g swaps its halves
          const float* wr = wf + g * kSWF + 2 * t;
          const int sw = ((g >> 1) & 1) << 3;
#pragma unroll
          for (int s = 0; s < FT_SG; ++s) {
            // B fragments: (rows 2 t, 2 t + 1 | 2 t + 8, 2 t + 9, chain
            // 8 s + g)
            const float2 x0 =
                *reinterpret_cast<const float2*>(wr + 8 * s * kSWF + sw);
            const float2 x1 =
                *reinterpret_cast<const float2*>(wr + 8 * s * kSWF + 8 - sw);
            uint32_t b[3][2];
            split_bf16x2(x0.x, x0.y, b[0][0], b[1][0], b[2][0]);
            split_bf16x2(x1.x, x1.y, b[0][1], b[1][1], b[2][1]);
#pragma unroll
            for (int p = 0; p < 3; ++p) {
              mma_bf16(acc[s][0][p], a[0], b[p]);
              mma_bf16(acc[s][1][p], a[1], b[p]);
            }
          }
        } else {
          // A fragments: (wavenumber 16 m + g (+ 8), row t (+ 4))
          uint32_t ab[2][4], as[2][4];
#pragma unroll
          for (int m = 0; m < 2; ++m) {
            const TabT* ta = tb + t * kTS2 + 16 * m + g;
            split_tf32(ta[0], ab[m][0], as[m][0]);
            split_tf32(ta[8], ab[m][1], as[m][1]);
            split_tf32(ta[4 * kTS2], ab[m][2], as[m][2]);
            split_tf32(ta[4 * kTS2 + 8], ab[m][3], as[m][3]);
          }
#pragma unroll
          for (int s = 0; s < FT_SG; ++s) {
            // B fragment: (row t (+ 4), chain 8 s + g)
            uint32_t bb[2], bs[2];
            split_tf32(wf[(8 * s + g) * kWF32 + t], bb[0], bs[0]);
            split_tf32(wf[(8 * s + g) * kWF32 + t + 4], bb[1], bs[1]);
#pragma unroll
            for (int m = 0; m < 2; ++m) {
              mma_tf32(acc[s][m][0], as[m], bb);
              mma_tf32(acc[s][m][0], ab[m], bs);
              mma_tf32(acc[s][m][1], ab[m], bb);
            }
          }
        }
      }
      // fragment (wavenumber 16 m + g (+ 8), chains 8 s + 2 t, + 1);
      // parts summed smallest first
      const int swz = 8 * (l & 3);
#pragma unroll
      for (int s = 0; s < FT_SG; ++s) {
        float* e = ext + (size_t)(8 * s + 2 * t) * CS + l * kES;
#pragma unroll
        for (int m = 0; m < 2; ++m) {
          float v[4];
#pragma unroll
          for (int i = 0; i < 4; ++i)
            v[i] = (acc[s][m][0][i] + acc[s][m][1][i]) + acc[s][m][2][i];
          const int lo = (16 * m + g) ^ swz, hi = (16 * m + g + 8) ^ swz;
          e[lo] = v[0];
          e[CS + lo] = v[1];
          e[hi] = v[2];
          e[CS + hi] = v[3];
        }
      }
    }
  }
  cp_async_wait<0>();
  __syncthreads();  // ext is complete and the fill rings are free

  // ---- 2. slant optical depth and the annulus sum: round s, warp pair p
  // takes chain NP s + p of the item, warp h of the pair its tile h; the
  // pair shares the G stages, each warp has its own stages of ext
  const int nks = Lk / 8, nmt = Lm / 16;
  constexpr int GW = 16 * FT_MT * kGS;           // floats of a G stage
  float* gbuf = reinterpret_cast<float*>(scr) + (size_t)pair * 2 * GW;
  // this warp's two stages of ext's rows of a step, [8][kES] each
  float* ebuf =
      reinterpret_cast<float*>(scr) + (size_t)NP * 2 * GW + warp * 2 * 8 * kES;
  float* wg = wgt_s + pair * Lm;                 // the chain's annulus weights
  // the two 16-byte halves of this lane's rows g, g + 8 of a G stage
  const int h0 = 4 * ((g >> 2) & 1), h1 = 4 - h0;
  for (int s = 0; s < kSCB / NP; ++s) {
    const int q = NP * s + pair, c = c0 + q;
    if (c >= C) break;   // the chains of the later rounds are past C too
    const float* ew = ext + (size_t)q * CS;        // the chain's ext
    pair_sync(pair);     // both warps are done with the last chain
    for (int b = lane + 32 * h; b < Lm; b += 64)
      wg[b] = b < L ? wgt[(size_t)c * L + b] : 0.0f;
    // col[2 nt + j]: the sum over this lane's rows b of wgt (1 - e^-tau)
    // at wavenumber 8 nt + 2 t + j
    float col[8];
#pragma unroll
    for (int k = 0; k < 8; ++k) col[k] = 0.0f;

    // the annuli in groups of FT_MT 16-row blocks mt0 .. mt1 - 1; a group
    // takes the steps that reach its last row
    for (int mt0 = 0; mt0 < nmt; mt0 += FT_MT) {
      const int mt1 = nmt < mt0 + FT_MT ? nmt : mt0 + FT_MT;
      const int nksg = 2 * mt1 < nks ? 2 * mt1 : nks;
      // step ks stages the tile G[c, b, 8 ks : 8 ks + 8] for the rows b of
      // the group's 16-row blocks that reach the diagonal
      // (b >= 16 (ks / 2)), one contiguous piece of Gt, half of it by
      // each warp of the pair; then this warp's ext rows 8 ks .. 8 ks + 7
      auto copy_g = [&](int ks) {
        if (BART_ABLATE & 1) return;
        float* gb = gbuf + (size_t)(ks & 1) * GW;
        const int b_lo = 16 * ((ks >> 1) > mt0 ? (ks >> 1) : mt0);
        const float* src = Gt + (((size_t)c * nks + ks) * Lm + b_lo) * kGS;
        const bool ok = !(BART_ABLATE & 128);
        for (int i = lane + 32 * h; i < (16 * mt1 - b_lo) * 2; i += 64) {
          const int b = b_lo + (i >> 1), hh = (i & 1) ^ ((b >> 2) & 1);
          cp_async16(gb + (b - 16 * mt0) * kGS + 4 * hh,
                     ok ? src + 4 * i : Gt, ok);
        }
        float* es = ebuf + (size_t)(ks & 1) * 8 * kES;
        for (int i = lane; i < 2 * kES; i += 32)
          cp_async16(es + 4 * i, ew + (size_t)8 * ks * kES + 4 * i, true);
      };

      float tau[FT_MT][4][4];
#pragma unroll
      for (int mt = 0; mt < FT_MT; ++mt)
#pragma unroll
        for (int nt = 0; nt < 4; ++nt)
#pragma unroll
          for (int i = 0; i < 4; ++i) tau[mt][nt][i] = 0.0f;

      pair_sync(pair);  // both warps are done with the last group's stages
      copy_g(0);
      cp_async_commit();
      for (int ks = 0; ks < nksg; ++ks) {
        cp_async_wait<0>();
        // step ks has landed, both halves; both warps are done with ks - 1
        pair_sync(pair);
        if (ks + 1 < nksg) copy_g(ks + 1);
        cp_async_commit();
        const float* gb = gbuf + (size_t)(ks & 1) * GW;
        const float* er = ebuf + (size_t)(ks & 1) * 8 * kES;
        uint32_t bb[4][2], bs[4][2];
#pragma unroll
        for (int nt = 0; nt < 4; ++nt) {
          // rows 8 ks + t and + 4 share (l & 3) == t
          const int cw = (8 * nt + g) ^ (8 * t);
          split_tf32(er[t * kES + cw], bb[nt][0], bs[nt][0]);
          split_tf32(er[(t + 4) * kES + cw], bb[nt][1], bs[nt][1]);
        }
#pragma unroll
        for (int mt = 0; mt < FT_MT; ++mt) {
          const int m = mt0 + mt;
          if (m >= (ks >> 1) && m < mt1 && !(BART_ABLATE & 16)) {
            // rows 16 m + g and + 8 share ((b >> 2) & 1)
            const float* ga = gb + (16 * mt + g) * kGS + t;
            uint32_t ab[4], as[4];
            split_tf32(ga[h0], ab[0], as[0]);
            split_tf32(ga[8 * kGS + h0], ab[1], as[1]);
            split_tf32(ga[h1], ab[2], as[2]);
            split_tf32(ga[8 * kGS + h1], ab[3], as[3]);
#pragma unroll
            for (int nt = 0; nt < 4; ++nt) {
              mma_tf32(tau[mt][nt], as, bb[nt]);
              mma_tf32(tau[mt][nt], ab, bs[nt]);
              mma_tf32(tau[mt][nt], ab, bb[nt]);
            }
          }
        }
      }

      // the group's annuli into the sums, block by block
#pragma unroll
      for (int mt = 0; mt < FT_MT; ++mt) {
        const int m = mt0 + mt;
        if (m < mt1) {
          const float w_lo = wg[16 * m + g], w_hi = wg[16 * m + g + 8];
#pragma unroll
          for (int nt = 0; nt < 4; ++nt) {
#pragma unroll
            for (int i = 0; i < 4; ++i) {
#if BART_ABLATE & 4
              const float a = fminf(tau[mt][nt][i], kTauClamp);
#else
              const float a = 1.0f - expf(-fminf(tau[mt][nt][i], kTauClamp));
#endif
              col[2 * nt + (i & 1)] =
                  fmaf((i & 2) ? w_hi : w_lo, a, col[2 * nt + (i & 1)]);
            }
          }
        }
      }
    }
    // the bins, through this warp's own stage of ext (its 32 words)
    ft_store_bins(col, ebuf, lane, t, g, c, w0, C, F, K, ntile, out, part);
  }
  }  // item
}

// Launch on ``stream``; returns the cudaError_t of the launches.  Rp is
// Rt rounded up to the rows of a unit (16 for a bfloat16 table, 8 for a
// float32 one); Fp a multiple of 16 bytes of TabT, below 2^31 - 64.  Up
// to 16 FT_MT layers the resident kernel runs, one block an item (the
// tiles over the grid's y and z: tile_grid); above, the streamed one on
// min(items, nslot) blocks, with ext_g [nslot][FT_SW][kSCB][Lk][kES]
// float32 (fewer than 2^31 (kSCB-chain block, tile) pairs: the item index
// is an int).
// Where K does not divide FT_W, part [C][ntile][2] float32 takes the
// straddling bins' partial sums and a second launch adds them
// (fold_straddle.cuh).
template <typename TabT>
int launch_transit_mma(const void* tab, const float* wrows, const float* Gt,
                       const float* wgt, float* out, float* ext_g,
                       float* part, int Rt, int Rp, int L, int F, int Fp,
                       int C, int K, int nslot, cudaStream_t stream) {
  constexpr bool kBf16 = sizeof(TabT) == 2;
  const bool stream_ext = L > 16 * FT_MT;
  const bool straddles = K >= 1 && fold_straddles<FT_W>(K);
  if (Rt < 1 || Rp < Rt || Rp % (kBf16 ? 16 : 8) != 0 || L < 1 ||
      Fp % (16 / (int)sizeof(TabT)) != 0 || Fp >= kMaxRow || F < 1 ||
      F > Fp || K < 1 || F % K != 0 || C < 1 ||
      (stream_ext && (ext_g == nullptr || nslot < 1)) ||
      (straddles && part == nullptr))
    return (int)cudaErrorInvalidValue;
  const int ntile = (F + FT_W - 1) / FT_W;
  // chain blocks: of FT_CB chains (resident), of kSCB (streamed)
  const int cb = stream_ext ? kSCB : FT_CB;
  const int ncb = (C + cb - 1) / cb;
  if (stream_ext && (long long)ncb * ntile >= (1ll << 31))
    return (int)cudaErrorInvalidValue;
  const TabT* t = static_cast<const TabT*>(tab);
  if (!stream_ext) {
    const size_t smem =
        ft_smem_bytes(L, kBf16 ? kUnitBytes : kUnitBytes32);
    const bool tiled = ntile > kMaxGridYZ;
    const auto kernel = tiled ? fused_transit_mma_kernel<TabT, true>
                              : fused_transit_mma_kernel<TabT, false>;
    const cudaError_t e = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return (int)e;
    const dim3 grid = tiled               ? tile_grid(ncb, ntile)
                      : (BART_ABLATE & 8) ? dim3(ntile, ncb)
                                          : dim3(ncb, ntile);
    kernel<<<grid, 32 * FT_CB, smem, stream>>>(
        t, wrows, Gt, wgt, out, part, Rt, Rp, L, F, Fp, C, K, ntile);
  } else {
    const size_t smem =
        ft_stream_smem_bytes(L, kBf16 ? kSUnitBytes : kSUnitBytes32);
    const cudaError_t e = cudaFuncSetAttribute(
        fused_transit_stream_kernel<TabT>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return (int)e;
    const long long nitem = (long long)ncb * ((ntile + FT_SW - 1) / FT_SW);
    const int nblock = nitem < nslot ? (int)nitem : nslot;
    fused_transit_stream_kernel<TabT><<<nblock, 32 * FT_CB, smem, stream>>>(
        t, wrows, Gt, wgt, out, ext_g, part, Rt, Rp, L, F, Fp, C, K, ntile);
  }
  const cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess || !straddles) return (int)e;
  return (int)launch_fold_straddle<FT_W>(part, out, C, F / K, K, ntile, 1.0f,
                                         (float)K, stream);
}

}  // namespace
