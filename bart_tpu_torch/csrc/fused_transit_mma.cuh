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
// The resident kernel (L <= 16 FT_MT = 112).  A block computes items of
// FT_W = 32 (fine) wavenumbers x FT_CB = 8 chains, one block an SM
// (222,352 bytes of shared memory on a bfloat16 table, 216,208 on a
// float32 one).  Blocks run as persistent thread-block clusters of FT_CX
// = 2 (cudaLaunchKernelEx with a cluster dimension; as many clusters as
// cudaOccupancyMaxActiveClusters gives, 66 on the H100): cluster k walks
// the items k, k + ncl, ... of npair x ntile items (a pair of chain
// blocks, a tile; pairs fastest), block cx of the pair taking chain block
// 2 pair + cx.  A block's 12 warps split the work:
//  - The producer warp issues the fill units through the Tensor Memory
//    Accelerator: a unit is a layer pair x FT_UR = 32 table rows, one box
//    of a tensor map a copy.  Each block copies its half of the rows (16)
//    of the item's tile and multicasts it to both blocks of the cluster,
//    and copies its own 8 chains' weights (one box).  A box lands with
//    the map's swizzle (64-byte for bfloat16 rows of 32 points, 128-byte
//    for float32 rows and the weights; fill_tab_at, fill_wgt_off), is zero
//    where it lies outside the tensor (rows past Rt, points past Fp, chains
//    past C, layers past L) and completes on the unit's full mbarrier with
//    its byte count.  One lane issues each copy; lane fw + 3 jj feeds
//    units jj, jj + JB, ... of fill warp fw's ring, each lane on its own,
//    and runs on into the next items, so their copies overlap the current
//    item's products.
//  - FT_NF = 3 fill warps take the layer pairs fw, fw + 3, ... of each
//    item and multiply each unit as the parent design's warps did
//    (bfloat16 table: the weights split into three exact bfloat16 parts,
//    three mma.sync.m16n8k16 passes; float32 table: 3xTF32 on m16n8k8).
//    The fragment loads follow the swizzles: ldmatrix rows (r, chunk
//    c ^ ((r >> 1) & 3)); the float32 table's mma row g + 8 h of m-tile m
//    is wavenumber ft_col32(m, h, g) and the weights' mma column n is
//    chain sig(n) = 2 (n & 3) + n / 4, so that every load hits all banks
//    without padding (the TMA cannot pad).  A consumed unit is released
//    by an mbarrier arrival in each block that sent it bytes (the
//    cluster's two blocks for the table, its own for the weights), so a
//    slot is refilled only when both blocks are done with it; every such
//    block always sends bytes (whole boxes), so no release can land in a
//    phase it does not belong to.  A finished layer goes to the ext ring.
//  - The ext ring holds FT_NE = 4 steps of 8 layers (a step's slot [8
//    chains][8 rows][32], rows swizzled by their layer as before): the 8
//    layers' arrivals complete a step's full mbarrier, the 8 slant warps'
//    arrivals its empty one; the steps count on across items.  So the
//    slant product of a step starts as soon as its 8 layers are filled,
//    while the fill goes on with the next steps and items (the parent
//    handed over with one block barrier after all layers).
//  - 8 slant warps, one a chain: tau[b, w] for all b and 32 wavenumbers
//    in registers (7 x 4 fragments), 3xTF32 on mma.sync.m16n8k8 as the
//    parent did, per step the tile G[c, :, 8 ks : 8 ks + 8] from the rows
//    that reach the diagonal: one bulk copy of the TMA (cp.async.bulk) of
//    that contiguous piece of Gt, issued a step ahead (into the next
//    item too), into two stages with full / empty mbarriers.  G rows are
//    dense; a lane reads its rows' halves in the order that hits all
//    banks.  Then the exponential, the annulus weights and the sums over
//    b and k as before: ft_store_bins through the warp's own 32 words,
//    and fold_straddle.cuh for a K that does not divide the 32-point tile.
//    A chain past C takes part in the hand-offs and computes nothing.
// Every ext, tau and sum takes its terms in the parent's order (k-steps
// past Rp are not taken, a row past Rt is a zero of the box as it was a
// zero of the copy), so the outputs equal the parent's bit for bit.  No
// atomics: a graph replay equals an eager launch.
//
// Where the trouble was, and what the design does about it (found on an
// NVIDIA H100 80GB HBM3 at 700 W while the design took shape; PERF.md
// has the measurements).
//  - Per-copy and per-block costs, not bytes, bound the first designs:
//    bulk copies of single table rows cost a share of the SM's issue each,
//    one producer thread issuing unit after unit could not keep three fill
//    warps fed, and a cluster launched a block an item paid its set-up and
//    its pipeline's ramp once an item (twice the parent's time on the
//    tables of 16 layers and 8 rows).  So units are a layer pair of 32-row
//    boxes, lanes issue side by side, and the clusters are persistent; the
//    item and slot counters run without 64-bit division, which cost as
//    much again.
//  - A block never returns early: every block of a cluster reaches its
//    barriers and is a multicast target (a chain block past the last chain
//    copies its part, computes nothing, writes nothing).
//  - Tables of any size: the tensor maps' dimensions and strides are
//    64-bit, items and steps are counted in 64 bits, a box's coordinates
//    are ints (points below 2^31 - 64, layers, rows, chains).  A map is
//    encoded on the host at each launch (cuTensorMapEncodeTiled through
//    cudaGetDriverEntryPoint, so the library needs no link flag), which a
//    CUDA graph capture allows.
//  - The cluster's size: 2 x 4 (the weights and G multicast to 4 tiles as
//    well) leaves SMs idle (cudaOccupancyMaxActiveClusters holds fewer
//    than 132 / 8 clusters) and couples 8 blocks; it ran slower than
//    pairs, as did 2 x 2, 4 x 1 and 4 x 2 (a block an item then; there a
//    cluster of one block ran as fast as pairs: the table's multicast
//    halves its L2 reads and moved no time).
//  - Registers: 12 warps put 3 on each SM sub-partition, so a thread gets
//    at most 168 registers (the slant warps use them); 13 warps spill, and
//    setmaxnreg does not raise what ptxas allocates at the launch bound.
//    So 3 fill warps.
//  - wgmma (not taken): its B operand (ext) comes from shared memory, so
//    3xTF32 needs ext's big and small parts staged (2 x 33 KB of the ext
//    ring), and A (G) either from shared memory as well (big and small, 2
//    x 57 KB of stages at L = 112: 180 KB with the fill rings' 111-123 KB
//    makes more than the 227 KB a block has) or from registers, where the
//    per-element load and split that dominate the slant's instructions
//    stay as they are.
//
// Bound on the H100.  Folded, per 512-chain batch at R = 41, L = 100,
// 1,064 fine bins, K = 32: 71.5 G FMAs of fill (three bfloat16 passes:
// 0.43 ms at the dense bfloat16 peak) and 88.0 G of slant triangle (three
// TF32 passes on 16-row blocks: 1.2 ms at the dense TF32 peak); one
// exponential and one FMA per (chain, annulus, fine point) stay on the
// float32 pipes (1.7 G exponentials: 0.42 ms).  Global -> shared bytes:
// the table (279 MB) once per cluster of 2 chain blocks, 32 x 279 MB =
// 8.9 GB (the parent: 17.9 GB); per tile of 32 fine points the weights
// (9.8 MB) and the lower blocks of G (14.4 MB), 25.8 GB as before: 34.7
// GB per launch (the parent: 43.7).  A block still receives its 686 KB an
// item (table 307, weights 154, G 225).  K = 1, at W = 2501 on a float32
// table: 6.1 G FMAs of fill over 48 padded rows and 6.5 G of slant
// triangle, three TF32 passes each: 0.15 ms at the dense TF32 peak; from
// L2 the table (41 MB) 32 times and weights and G 79 times: 3.2 GB (the
// parent: 4.5).  expf is the accurate library version (no
// --use_fast_math).
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

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include "cluster.cuh"
#include "fold_straddle.cuh"
#include "hopper.cuh"

#define FT_W 32      // (fine) wavenumbers per block
#define FT_CB 8      // chains per block, one slant warp each
#define FT_NF 3      // fill warps of a block
#define FT_NS 7      // units in a fill warp's ring, bfloat16 table
#define FT_NS32 4    // the same, float32 table
#define FT_UR 32     // table rows of a fill unit (of a layer pair)
#define FT_NE 4      // steps of 8 layers in the ext ring
#define FT_CX 2      // cluster: chain blocks (the table tile's multicast)
#define FT_MT 7      // 16-row blocks of tau a warp holds: L <= 112 keeps
                     // them all (above, the streamed variant's group)
#define FT_SG 4      // streamed variant: chain groups of FT_CB an item
#define FT_SW 2      // streamed variant: tiles an item, one a warp of a pair
#define FT_SNS 4     // streamed variant: units in a warp pair's ring

// Timing aid (ablate_folded.py, with --k1 for K = 1): -DBART_ABLATE=<bits>
// builds the kernel without 1 its global -> shared copies, 2 its fill
// products, 4 its exponentials, 16 its slant products; the streamed
// variant also takes 8 (its items tile-major) and 32, 64, 128 (zeros in
// place of the table, the weights, G).  All but 8 give wrong results.
#ifndef BART_ABLATE
#define BART_ABLATE 0
#endif

namespace {

constexpr float kTauClamp = 88.0f;
constexpr unsigned kFullMask = 0xffffffffu;

constexpr int kES = FT_W;       // row stride of ext; the 8-column groups
                                // of row l are swapped by l & 3 (swizzle)
constexpr int kGS = 8;          // row stride of a G stage: dense in the
                                // resident kernel (bulk copies); in the
                                // streamed variant the two 16-byte halves
                                // of row b are swapped by (b >> 2) & 1
constexpr int kWF32 = 8 + 4;    // the streamed variant, float32 table:
                                // lane (g, t) -> bank 12 g + t (+ 4)
// a fill unit of the resident kernel: a layer pair's FT_UR table rows of
// the tile, the halves of FT_UR / FT_CX rows from each chain block of the
// cluster, each [2 layers][FT_UR / FT_CX][FT_W] TabT, then their
// weights for the block's chains, [2 layers][FT_CB][FT_UR] float32; all
// as the TMA writes a box with its swizzle (fill_tab_at, fill_wgt_off)
constexpr int kUnitBytes = 2 * (2 * FT_UR * FT_W + 4 * FT_CB * FT_UR);
constexpr int kUnitBytes32 = 2 * (4 * FT_UR * FT_W + 4 * FT_CB * FT_UR);
// the ext ring's chain stride (a step's 8 rows, 4 words apart per chain)
// and a step's slot, in floats
constexpr int kECS = 8 * kES + 4;
constexpr int kEStep = FT_CB * kECS;
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
static_assert(kUnitBytes % 1024 == 0 && kUnitBytes32 % 1024 == 0 &&
                  kSUnitBytes % 16 == 0 && kSUnitBytes32 % 16 == 0,
              "resident units keep the swizzle's 1024-byte alignment, "
              "streamed ones the ring's 16 bytes");

// The resident kernel's threads: FT_CB slant warps (a chain each),
// FT_NF fill warps and the producer warp.  Its mbarriers: each fill
// warp's ring's full and empty [FT_NF][FT_NS], the ext ring's full and
// empty [FT_NE] each, the G stages' full and empty [FT_CB][2] each.
constexpr int kNT = 32 * (FT_CB + FT_NF + 1);
constexpr int kNBar = 2 * FT_NF * FT_NS + 2 * FT_NE + 4 * FT_CB;
static_assert(FT_CX == 2 && FT_UR == 32 && FT_NS >= FT_NS32 &&
                  FT_NF * FT_NS <= 32 && (8 * kNBar) % 16 == 0,
              "a cluster's table halves, the boxes, the producer's lanes "
              "and the barriers' room");

// Bytes of shared memory for L layers: 1024 to align the fill rings
// (FT_NF x ns units), the barriers, the G stages (2 x [Lm][kGS] float32 a
// slant warp), the ext ring [FT_NE][FT_CB][8 kES + 4] and the slant
// warps' 32 words each for the bins, in float32; Lm = L rounded up to 16.
// The row count does not enter.
__host__ __device__ constexpr size_t ft_ext_bytes() {
  return 4 * ((size_t)FT_NE * kEStep + (size_t)FT_CB * FT_W);
}
__host__ __device__ constexpr size_t ft_slant_bytes(int L) {
  return (size_t)FT_CB * 2 * ((L + 15) & ~15) * kGS * 4;
}
__host__ __device__ constexpr size_t ft_smem_bytes(int L, int unit_bytes,
                                                   int ns) {
  return 1024 + (size_t)FT_NF * ns * unit_bytes + 8 * (size_t)kNBar +
         ft_slant_bytes(L) + ft_ext_bytes();
}

// Byte offsets in a fill unit of the TMA's swizzled boxes (the swizzle
// XORs a row's 16-byte chunk index with bits of its row, so that the
// fragment loads below hit every bank).  Table, bfloat16: row r of 64
// bytes, chunk c (8 wavenumbers), SWIZZLE_64B; float32: rows of 128 bytes,
// chunk c (4 wavenumbers), SWIZZLE_128B.  Weights: chain q's 32 rows
// (128 bytes), chunk c (4 rows), SWIZZLE_128B, after the table.
// The float32 fill's mma row g + 8 h of m-tile m is wavenumber
// ft_col32(m, h, g) of the tile (a bijection of the 32), so that its A
// fragment's loads from the 128-byte swizzle hit all banks
__host__ __device__ constexpr int ft_col32(int m, int h, int g) {
  return 16 * (g >> 2) + 8 * m + 4 * h + (g & 3);
}
template <bool kBf16>
__device__ __forceinline__ int fill_tab_off(int r, int c) {
  return kBf16 ? 64 * r + 16 * (c ^ ((r >> 1) & 3)) : 128 * r + 16 * (c ^ (r & 7));
}
// layer h of the pair, row r < FT_UR of the unit: chain block r / RH's
// box [2][RH][FT_W] (RH = FT_UR / FT_CX rows, a multiple of 8), whose row
// index RH h + r % RH swizzles as r does
template <bool kBf16>
__device__ __forceinline__ int fill_tab_at(int h, int r, int c) {
  constexpr int RB = kBf16 ? 64 : 128, RH = FT_UR / FT_CX;
  return (r / RH) * (2 * RH * RB) + h * (RH * RB) + fill_tab_off<kBf16>(r % RH, c);
}
__device__ __forceinline__ int fill_wgt_off(int q, int c) {
  return 128 * q + 16 * (c ^ (q & 7));
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
// of them to an output bin.  The resident kernel, L <= 16 FT_MT: persistent
// clusters of FT_CX blocks (gridDim.x / FT_CX clusters), cluster k taking
// the items k, k + ncl, ... of the npair x ntile items (pair of chain
// blocks, tile), pairs fastest; block cx of the cluster takes chain block
// FT_CX pair + cx of its items.  tmap_t: the table [Rt][L][Fp] as a
// tensor map of dims (Fp, Rt, L), boxes of FT_W points x FT_UR / FT_CX
// rows x 2 layers; tmap_w: the weights [C][L][Rp] as dims (Rp, C, L),
// boxes of FT_UR rows x FT_CB chains x 2 layers (both zero outside the
// tensor).  part: the partial sums of the bins that straddle the
// FT_W-point tiles, [C][ntile][2] (K not dividing FT_W; fold_straddle.cuh).
template <typename TabT>
__global__ void __launch_bounds__(kNT, 1)
fused_transit_mma_kernel(
    const __grid_constant__ CUtensorMap tmap_t,
    const __grid_constant__ CUtensorMap tmap_w,
    const float* __restrict__ Gt,              // [C, Lk / 8, Lm, 8] tiles
    const float* __restrict__ wgt,             // [C, L]
    float* __restrict__ out,                   // [C, F / K]
    float* __restrict__ part,
    int Rt, int Rp, int L, int F, int Fp, int C, int K, int ntile,
    int npair, long long nitem) {
  constexpr bool kBf16 = sizeof(TabT) == 2;
  constexpr int UB = kBf16 ? kUnitBytes : kUnitBytes32;
  constexpr int NS = kBf16 ? FT_NS : FT_NS32;   // units a fill warp's ring
  constexpr int RB = FT_W * (int)sizeof(TabT);  // bytes of a table row
  constexpr int TB = 2 * FT_UR * RB;            // a unit's table
  constexpr int HB = TB / FT_CX;                // a chain block's half
  constexpr int KR = kBf16 ? 16 : 8;            // rows of a k-step
  const int Lk = (L + 7) & ~7, Lm = (L + 15) & ~15;
  const int NCH = (Rp + FT_UR - 1) / FT_UR;      // units of a layer pair
  const int LP = (L + 1) / 2;                    // layer pairs with a unit
  const int nks = Lk / 8, nmt = Lm / 16;
  const int GW = Lm * kGS;                       // floats of a G stage
  extern __shared__ float4 smem4[];
  // the rings first, on a 1024-byte boundary (the swizzle's period); the
  // same offset in every block of the cluster (no static shared memory)
  unsigned char* ring = reinterpret_cast<unsigned char*>(smem4) +
                        ((1024 - (smem_u32(smem4) & 1023)) & 1023);
  uint64_t* full_f =
      reinterpret_cast<uint64_t*>(ring + (size_t)FT_NF * NS * UB);
  uint64_t* empty_f = full_f + FT_NF * FT_NS;              // [FT_NF][FT_NS]
  uint64_t* full_e = empty_f + FT_NF * FT_NS;              // [FT_NE]
  uint64_t* empty_e = full_e + FT_NE;                      // [FT_NE]
  uint64_t* full_g = empty_e + FT_NE;                      // [FT_CB][2]
  uint64_t* empty_g = full_g + 2 * FT_CB;                  // [FT_CB][2]
  float* gbuf = reinterpret_cast<float*>(full_f + kNBar);  // [FT_CB][2][GW]
  float* ext_r = gbuf + (size_t)FT_CB * 2 * GW;            // [FT_NE][kEStep]
  float* col_r = ext_r + (size_t)FT_NE * kEStep;           // [FT_CB][FT_W]

  const int tid = threadIdx.x;
  const int lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, t = lane & 3;
  // the cluster's items: n-th = k0 + n ncl; block cx's chain block and the
  // tile of an item
  const int cx = (int)cluster_ctaid_x();
  const long long ncl = gridDim.x / FT_CX, k0 = blockIdx.x / FT_CX;
  const long long nit = (nitem - 1 - k0) / ncl + 1;  // at least one
  auto item_c0 = [&](long long n) {
    return (int)(((k0 + n * ncl) % npair) * FT_CX + cx) * FT_CB;
  };
  auto item_tile = [&](long long n) {
    return (int)((k0 + n * ncl) / npair);
  };
  const uint16_t col_mask = (uint16_t)((1u << FT_CX) - 1);
  const uint16_t own_mask = (uint16_t)(1u << cx);

  if (tid == 0) {
    if ((int)cluster_ctarank() != cx) __trap();
    // a unit's slot is released by the cluster's blocks (the table's
    // halves) and by its own block once more (the weights); a step of ext
    // is filled by its 8 layers and released by the 8 slant warps; a G
    // stage is filled and released by its warp
    for (int i = 0; i < FT_NF * FT_NS; ++i) {
      mbar_init(full_f + i, 1);
      mbar_init(empty_f + i, FT_CX + 1);
    }
    for (int i = 0; i < FT_NE; ++i) {
      mbar_init(full_e + i, 8);
      mbar_init(empty_e + i, FT_CB);
    }
    for (int i = 0; i < 2 * FT_CB; ++i) {
      mbar_init(full_g + i, 1);
      mbar_init(empty_g + i, 1);
    }
    mbar_init_fence();
  }
  cluster_sync();  // every barrier of the cluster is set up

  if (warp >= FT_CB + FT_NF) {
    // ---- the producer: fill warp fw's units are, item after item, (layer
    // pair lp, rows FT_UR j ..) for lp = fw, fw + FT_NF, ... < LP and
    // j < NCH, through its ring of NS slots.  This block copies rows
    // FT_UR j + FT_UR / FT_CX cx .. of the item's tile's table for the pair
    // (one TMA box) to the cluster, and its own chain block's weights of the
    // pair (one box) to itself: each table byte leaves L2 once per
    // cluster.  Boxes are whole, zero outside the tensors (rows past Rt,
    // points past Fp, chains past C, layers past L), so every block that
    // releases a slot sent bytes to it for that unit.  Lane fw + FT_NF jj
    // takes the units jj, jj + JB, ... of ring fw (JB <= NS: the lanes of a
    // ring wait on different slots), each lane on its own: no lane waits
    // for another's ring, which a full ring of a fill warp that waits for
    // the ext ring could otherwise stop; a lane runs on into the next
    // items, so their copies overlap the current item's products.  Under
    // BART_ABLATE & 1, 16-byte copies in place of the boxes keep the
    // hand-offs.
    if (lane == 0) {
      asm volatile("prefetch.tensormap [%0];" ::"l"(&tmap_t) : "memory");
      asm volatile("prefetch.tensormap [%0];" ::"l"(&tmap_w) : "memory");
    }
    const int JB = min(NS, NCH);
    const int fw = lane % FT_NF, jj = lane / FT_NF;
    const int nu = jj < JB && LP > fw ? ((LP - fw + FT_NF - 1) / FT_NF) * NCH
                                      : 0;
    const unsigned ubytes = (BART_ABLATE & 1)
                                ? 16u * (FT_CX + 1)
                                : (unsigned)(TB + 8 * FT_CB * FT_UR);
    // unit gi = nu n + i of the ring, in slot sm of use sd (gi = NS sd +
    // sm), all kept without a division; the item's chain block and tile
    long long n = 0, sd = 0;
    int i = jj, sm = jj, c0 = item_c0(0), w0 = item_tile(0) * FT_W;
    for (long long gi = jj; gi < nit * nu; gi += JB) {
      while (i >= nu) {
        i -= nu;
        ++n;
        c0 = item_c0(n);
        w0 = item_tile(n) * FT_W;
      }
      const int s = fw * FT_NS + sm;
      mbar_wait<true>(empty_f + s, (unsigned)(sd & 1) ^ 1);
      const int lp = fw + FT_NF * (i / NCH), j = i % NCH;
      mbar_arrive_expect_tx(full_f + s, ubytes);
      unsigned char* u = ring + (size_t)(fw * NS + sm) * UB;
      i += JB;
      sm += JB;
      if (sm >= NS) {
        sm -= NS;
        ++sd;
      }
      if (BART_ABLATE & 1) {
        bulk_copy_multicast(u + 16 * cx, Gt, 16u, full_f + s, col_mask);
        bulk_copy_multicast(u + 16 * FT_CX, Gt, 16u, full_f + s, own_mask);
      } else {
        tma_load_3d_multicast(u + cx * HB, &tmap_t, w0,
                              FT_UR * j + (FT_UR / FT_CX) * cx, 2 * lp,
                              full_f + s, col_mask);
        tma_load_3d_multicast(u + TB, &tmap_w, FT_UR * j, c0, 2 * lp,
                              full_f + s, own_mask);
      }
    }
    __syncwarp();
  } else if (warp >= FT_CB) {
    // ---- the fill: warp fw takes, item after item, the layer pairs fw,
    // fw + FT_NF, ..., each unit's k-steps as a warp of the parent design
    // did for one layer (the pair's two layers side by side; k-steps past
    // Rp are not taken), and hands each finished layer to the slant warps
    // through the ext ring (full_e of its step of 8 layers, once the step's
    // slot is free; the steps count on across items).  Layers L..Lk-1 of
    // ext are 0.  A released unit is announced to the blocks that sent it:
    // the cluster's blocks (the table) and its own (the weights).
    const int fw = warp - FT_CB;
    const unsigned rel_rank = lane < FT_CX ? lane : cx;
    // B fragments: mma column (chain) n holds chain sig(n), so that the
    // weights' loads hit all banks; the D fragment's columns 2 t, 2 t + 1
    // are chains q0, q1
    const int qg = ((g & 3) << 1) | (g >> 2);
    const int q0 = ((2 * t & 3) << 1) | (2 * t >> 2);
    const int q1 = (((2 * t + 1) & 3) << 1) | ((2 * t + 1) >> 2);
    int sm = 0;               // the ring's slot of the warp's next unit
    unsigned sp = 0;          // and the parity of its use
    for (long long n = 0; n < nit; ++n) {
      for (int lp = fw; 2 * lp < Lk; lp += FT_NF) {
        // acc[h][m][p]: layer 2 lp + h, 16 wavenumbers m x 8 chains;
        // bfloat16 table: weight part p; float32 table: p = 0 the two
        // small products, 1 the big one
        float acc[2][2][3][4];
#pragma unroll
        for (int h = 0; h < 2; ++h)
#pragma unroll
          for (int m = 0; m < 2; ++m)
#pragma unroll
            for (int p = 0; p < 3; ++p)
#pragma unroll
              for (int k = 0; k < 4; ++k) acc[h][m][p][k] = 0.0f;
        for (int j = 0; lp < LP && j < NCH; ++j) {
          const int s = fw * FT_NS + sm;
          mbar_wait(full_f + s, sp);
          __syncwarp();
          const unsigned char* u = ring + (size_t)(fw * NS + sm) * UB;
          if (++sm == NS) {
            sm = 0;
            sp ^= 1;
          }
          const unsigned char* wf = u + TB;
          const int nk = min(FT_UR, Rp - FT_UR * j) / KR;  // below Rp
#pragma unroll
          for (int kk = 0; kk < FT_UR / KR; ++kk) {
            if (kk >= nk || (BART_ABLATE & 2)) continue;
#pragma unroll
            for (int h = 0; h < 2; ++h) {
              if constexpr (kBf16) {
                // B fragments: (rows 2 t, 2 t + 1 | 2 t + 8, 2 t + 9,
                // chain qg) of the k-step
                const int k0r = 16 * kk + 2 * t;
                const float2 x0 = *reinterpret_cast<const float2*>(
                    wf + 1024 * h + fill_wgt_off(qg, k0r >> 2) +
                    4 * (k0r & 3));
                const float2 x1 = *reinterpret_cast<const float2*>(
                    wf + 1024 * h + fill_wgt_off(qg, (k0r + 8) >> 2) +
                    4 * (k0r & 3));
                uint32_t b[3][2];
                split_bf16x2(x0.x, x0.y, b[0][0], b[1][0], b[2][0]);
                split_bf16x2(x1.x, x1.y, b[0][1], b[1][1], b[2][1]);
                uint32_t a[2][4];
                const int r = 16 * kk + (lane & 7) + ((lane >> 4) << 3);
#pragma unroll
                for (int m = 0; m < 2; ++m)
                  ldmatrix_x4_trans(
                      a[m], u + fill_tab_at<true>(
                                    h, r, 2 * m + ((lane >> 3) & 1)));
#pragma unroll
                for (int p = 0; p < 3; ++p) {
                  mma_bf16(acc[h][0][p], a[0], b[p]);
                  mma_bf16(acc[h][1][p], a[1], b[p]);
                }
              } else {
                // B fragment: (row t (+ 4) of the k-step, chain qg)
                const int k0r = 8 * kk + t;
                uint32_t bb[2], bs[2];
                split_tf32(*reinterpret_cast<const float*>(
                               wf + 1024 * h + fill_wgt_off(qg, k0r >> 2) +
                               4 * (k0r & 3)),
                           bb[0], bs[0]);
                split_tf32(*reinterpret_cast<const float*>(
                               wf + 1024 * h +
                               fill_wgt_off(qg, (k0r + 4) >> 2) +
                               4 * (k0r & 3)),
                           bb[1], bs[1]);
#pragma unroll
                for (int m = 0; m < 2; ++m) {
                  // A fragment: (mma row g (+ 8), row t (+ 4)); mma row
                  // g + 8 e of m-tile m is wavenumber ft_col32(m, e, g),
                  // so that the loads hit all banks
                  const int cl = ft_col32(m, 0, g), ch = ft_col32(m, 1, g);
                  auto ta = [&](int row, int col) {
                    return *reinterpret_cast<const float*>(
                        u + fill_tab_at<false>(h, row, col >> 2) +
                        4 * (col & 3));
                  };
                  uint32_t ab[4], as[4];
                  split_tf32(ta(k0r, cl), ab[0], as[0]);
                  split_tf32(ta(k0r, ch), ab[1], as[1]);
                  split_tf32(ta(k0r + 4, cl), ab[2], as[2]);
                  split_tf32(ta(k0r + 4, ch), ab[3], as[3]);
                  mma_tf32(acc[h][m][0], as, bb);
                  mma_tf32(acc[h][m][0], ab, bs);
                  mma_tf32(acc[h][m][1], ab, bb);
                }
              }
            }
          }
          __syncwarp();  // every lane has read the unit
          if (lane <= FT_CX) mbar_arrive_cluster(empty_f + s, rel_rank);
        }
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int l = 2 * lp + h;
          const long long gs = n * nks + (l >> 3);   // the global step
          const int es = (int)(gs % FT_NE);
          // the step's slot is free once the slant warps released step
          // gs - FT_NE
          mbar_wait(empty_e + es, (unsigned)((gs / FT_NE) & 1) ^ 1);
          __syncwarp();
          // fragment (mma rows g, g + 8 of m-tile m, chains q0, q1); parts
          // summed smallest first
          const int swz = 8 * (l & 3);
          float* e0 = ext_r + (size_t)es * kEStep + q0 * kECS + (l & 7) * kES;
          float* e1 = ext_r + (size_t)es * kEStep + q1 * kECS + (l & 7) * kES;
#pragma unroll
          for (int m = 0; m < 2; ++m) {
            float v[4];
#pragma unroll
            for (int k = 0; k < 4; ++k)
              v[k] = (acc[h][m][0][k] + acc[h][m][1][k]) + acc[h][m][2][k];
            const int lo = (kBf16 ? 16 * m + g : ft_col32(m, 0, g)) ^ swz;
            const int hi = (kBf16 ? 16 * m + g + 8 : ft_col32(m, 1, g)) ^ swz;
            e0[lo] = v[0];
            e1[lo] = v[1];
            e0[hi] = v[2];
            e1[hi] = v[3];
          }
          __syncwarp();  // every lane has written its part of layer l
          if (lane == 0) mbar_arrive(full_e + es);
        }
      }
    }
  } else {
    // ---- the slant optical depth and the annulus sum: warp q takes chain
    // c0 + q of each item.  Global step gg (item gg / nks, step ks =
    // gg % nks) takes ext's rows 8 ks .. 8 ks + 7 as soon as the fill has
    // handed them over, and the tile G[c, b, 8 ks : 8 ks + 8] for the rows
    // b of the 16-row blocks that reach the diagonal (b >= 16 (ks / 2)),
    // one contiguous piece of Gt (a bulk copy of the TMA, issued a step
    // ahead, into two stages).  A chain past C takes part in the hand-offs
    // and computes nothing.
    const int q = warp;
    float* gq = gbuf + (size_t)q * 2 * GW;         // the warp's two stages
    // this lane reads its rows' k = t + h0 first, then t + h1: the G rows
    // are dense, and rows g, g + 8 read their halves in this order hit all
    // banks (a0 / a1 are k = t, a2 / a3 are k = t + 4)
    const int h0 = 4 * ((g >> 2) & 1), h1 = 4 - h0;
    const bool hsw = (g & 4) != 0;
    // G of step ks of chain c (0 bytes for a chain past C) into stage st
    auto issue_g = [&](int c, int ks, int st) {
      const unsigned bytes =
          (c >= C || (BART_ABLATE & 1))
              ? 0u
              : (unsigned)((Lm - 16 * (ks >> 1)) * kGS * 4);
      mbar_arrive_expect_tx(full_g + 2 * q + st, bytes);
      if (bytes == 0) return;
      const int b_lo = 16 * (ks >> 1);
      bulk_copy_multicast(gq + (size_t)st * GW + b_lo * kGS,
                          Gt + (((size_t)c * nks + ks) * Lm + b_lo) * kGS,
                          bytes, full_g + 2 * q + st, own_mask);
    };
    // the chain of the item after the current one (for its first steps'
    // G, issued a step ahead)
    int c_now = item_c0(0) + q;
    int c_next = nit > 1 ? item_c0(1) + q : C;
    if (lane == 0) {
      issue_g(c_now, 0, 0);
      if (nks > 1)
        issue_g(c_now, 1, 1);
      else if (nit > 1)
        issue_g(c_next, 0, 1);
    }
    // col[2 nt + j]: the sum over this lane's rows b of wgt (1 - e^-tau) at
    // wavenumber 8 nt + 2 t + j
    float col[8];
    float tau[FT_MT][4][4];
    long long gg = 0;                              // the global step
    for (long long n = 0; n < nit; ++n) {
      const int c = c_now;
      const bool valid = c < C;
#pragma unroll
      for (int k = 0; k < 8; ++k) col[k] = 0.0f;
#pragma unroll
      for (int mt = 0; mt < FT_MT; ++mt)
#pragma unroll
        for (int nt = 0; nt < 4; ++nt)
#pragma unroll
          for (int i = 0; i < 4; ++i) tau[mt][nt][i] = 0.0f;
      for (int ks = 0; ks < nks; ++ks, ++gg) {
        if (gg >= 1 && lane == 0) {
          // step gg + 1 goes to the stage of step gg - 1, which this
          // warp has released: step ks + 1 of this item or the next
          // item's first
          const int st = (int)((gg + 1) & 1);
          if (ks + 1 < nks || n + 1 < nit) {
            mbar_wait(empty_g + 2 * q + st,
                      (unsigned)(((gg + 1) >> 1) & 1) ^ 1);
            if (ks + 1 < nks)
              issue_g(c, ks + 1, st);
            else
              issue_g(c_next, 0, st);
          }
        }
        const int es = (int)(gg % FT_NE);
        mbar_wait(full_e + es, (unsigned)((gg / FT_NE) & 1));
        mbar_wait(full_g + 2 * q + (int)(gg & 1), (unsigned)((gg >> 1) & 1));
        __syncwarp();
        if (valid) {
          const float* gb = gq + (size_t)(gg & 1) * GW;
          // ext's rows 8 ks .. 8 ks + 7 of the chain, in the step's slot
          const float* er = ext_r + (size_t)es * kEStep + q * kECS;
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
              const float* ga = gb + (16 * mt + g) * kGS + t;
              const float x0 = ga[h0], x1 = ga[8 * kGS + h0];
              const float y0 = ga[h1], y1 = ga[8 * kGS + h1];
              uint32_t ab[4], as[4];
              split_tf32(hsw ? y0 : x0, ab[0], as[0]);
              split_tf32(hsw ? y1 : x1, ab[1], as[1]);
              split_tf32(hsw ? x0 : y0, ab[2], as[2]);
              split_tf32(hsw ? x1 : y1, ab[3], as[3]);
#pragma unroll
              for (int nt = 0; nt < 4; ++nt) {
                mma_tf32(tau[mt][nt], as, bb[nt]);
                mma_tf32(tau[mt][nt], ab, bs[nt]);
                mma_tf32(tau[mt][nt], ab, bb[nt]);
              }
            }
          }
        }
        __syncwarp();  // every lane has read the stage and the step of ext
        if (lane == 0) {
          mbar_arrive(empty_g + 2 * q + (int)(gg & 1));
          mbar_arrive(empty_e + es);
        }
      }
      if (valid) {
        // the annuli into the sums, block by block
#pragma unroll
        for (int mt = 0; mt < FT_MT; ++mt) {
          if (mt < nmt) {
            const int b_lo = 16 * mt + g, b_hi = b_lo + 8;
            const float w_lo = b_lo < L ? wgt[(size_t)c * L + b_lo] : 0.0f;
            const float w_hi = b_hi < L ? wgt[(size_t)c * L + b_hi] : 0.0f;
#pragma unroll
            for (int nt = 0; nt < 4; ++nt) {
#pragma unroll
              for (int i = 0; i < 4; ++i) {
#if BART_ABLATE & 4
                const float a = fminf(tau[mt][nt][i], kTauClamp);
#else
                const float a =
                    1.0f - expf(-fminf(tau[mt][nt][i], kTauClamp));
#endif
                col[2 * nt + (i & 1)] =
                    fmaf((i & 2) ? w_hi : w_lo, a, col[2 * nt + (i & 1)]);
              }
            }
          }
        }
        // the bins, through the warp's own 32 words
        ft_store_bins(col, col_r + q * FT_W, lane, t, g, c,
                      item_tile(n) * FT_W, C, F, K, ntile, out, part);
      }
      c_now = c_next;
      c_next = n + 2 < nit ? item_c0(n + 2) + q : C;
    }
  }
  __syncwarp();
  // no block leaves while a block of its cluster may still copy into its
  // shared memory or arrive on its barriers
  cluster_sync();
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

// A launch of the resident kernel: kNT threads, clusters of FT_CX blocks
// (attr holds the attribute the configuration points to)
inline cudaLaunchConfig_t transit_cluster_config(dim3 grid, size_t smem,
                                                 cudaStream_t stream,
                                                 cudaLaunchAttribute* attr) {
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = grid;
  cfg.blockDim = dim3(kNT);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = stream;
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = FT_CX;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  return cfg;
}

template <typename TabT>
size_t ft_smem_bytes_for(int L) {
  return sizeof(TabT) == 2 ? ft_smem_bytes(L, kUnitBytes, FT_NS)
                           : ft_smem_bytes(L, kUnitBytes32, FT_NS32);
}

// The clusters of the resident kernel the card holds at once at L layers
// (cudaOccupancyMaxActiveClusters, after the shared-memory attribute), in
// *n; returns the cudaError_t.
template <typename TabT>
cudaError_t transit_clusters(int L, cudaStream_t stream, int* n) {
  const size_t smem = ft_smem_bytes_for<TabT>(L);
  const auto kernel = fused_transit_mma_kernel<TabT>;
  const cudaError_t e = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e != cudaSuccess) return e;
  cudaLaunchAttribute attr[1];
  cudaLaunchConfig_t cfg =
      transit_cluster_config(dim3(FT_CX), smem, stream, attr);
  *n = 0;
  return cudaOccupancyMaxActiveClusters(n, kernel, &cfg);
}

// The cluster shape and cudaOccupancyMaxActiveClusters of the resident
// kernel at L layers: info = {FT_CX, 1, clusters, shared bytes a block};
// returns the cudaError_t.
template <typename TabT>
int transit_cluster_info(int L, int* info) {
  int n = 0;
  const cudaError_t e = transit_clusters<TabT>(L, 0, &n);
  info[0] = FT_CX;
  info[1] = 1;
  info[2] = n;
  info[3] = (int)ft_smem_bytes_for<TabT>(L);
  return (int)e;
}

// Launch on ``stream``; returns the cudaError_t of the launches.  Rp is
// Rt rounded up to the rows of a unit (16 for a bfloat16 table, 8 for a
// float32 one); Fp a multiple of 16 bytes of TabT, below 2^31 - 64.  Up
// to 16 FT_MT layers the resident kernel runs, on persistent clusters of
// FT_CX blocks (cudaLaunchKernelEx), as many as the card holds at once;
// a refused cluster launch returns its error.  Above, the streamed one on
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
  if (!stream_ext) {
    // the table [Rt][L][Fp] as dims (Fp, Rt, L), boxes of FT_W points x
    // FT_UR / FT_CX rows x 2 layers; the weights [C][L][Rp] as (Rp, C, L),
    // boxes of FT_UR rows x FT_CB chains x 2 layers; rows of 64 (bfloat16)
    // or 128 bytes, each with the swizzle of its width
    CUtensorMap tmap_t, tmap_w;
    const cuuint64_t es = sizeof(TabT);
    if (!encode_map<3>(&tmap_t,
                   kBf16 ? CU_TENSOR_MAP_DATA_TYPE_BFLOAT16
                         : CU_TENSOR_MAP_DATA_TYPE_FLOAT32,
                   tab, {(cuuint64_t)Fp, (cuuint64_t)Rt, (cuuint64_t)L},
                   {(cuuint64_t)L * Fp * es, (cuuint64_t)Fp * es},
                   {FT_W, FT_UR / FT_CX, 2},
                   kBf16 ? CU_TENSOR_MAP_SWIZZLE_64B
                         : CU_TENSOR_MAP_SWIZZLE_128B) ||
        !encode_map<3>(&tmap_w, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, wrows,
                   {(cuuint64_t)Rp, (cuuint64_t)C, (cuuint64_t)L},
                   {(cuuint64_t)L * Rp * 4, (cuuint64_t)Rp * 4},
                   {FT_UR, FT_CB, 2}, CU_TENSOR_MAP_SWIZZLE_128B))
      return (int)cudaErrorInvalidValue;
    // persistent clusters: as many as the card holds at once, or fewer
    // when the items are fewer; npair x ntile items (int64)
    int nmax = 0;
    const cudaError_t eo = transit_clusters<TabT>(L, stream, &nmax);
    if (eo != cudaSuccess) return (int)eo;
    if (nmax < 1) return (int)cudaErrorInvalidConfiguration;
    const int npair = (ncb + FT_CX - 1) / FT_CX;
    const long long nitem = (long long)npair * ntile;
    const int ncl = nitem < nmax ? (int)nitem : nmax;
    cudaLaunchAttribute attr[1];
    cudaLaunchConfig_t cfg = transit_cluster_config(
        dim3((unsigned)(FT_CX * ncl)), ft_smem_bytes_for<TabT>(L), stream,
        attr);
    const cudaError_t el = cudaLaunchKernelEx(
        &cfg, fused_transit_mma_kernel<TabT>, tmap_t, tmap_w, Gt, wgt, out,
        part, Rt, Rp, L, F, Fp, C, K, ntile, npair, nitem);
    if (el != cudaSuccess) return (int)el;
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
        static_cast<const TabT*>(tab), wrows, Gt, wgt, out, ext_g, part, Rt, Rp, L, F, Fp, C, K, ntile);
  }
  const cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess || !straddles) return (int)e;
  return (int)launch_fold_straddle<FT_W>(part, out, C, F / K, K, ntile, 1.0f,
                                         (float)K, stream);
}

}  // namespace
