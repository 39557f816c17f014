// Folded eclipse emergent flux (K sub-samples per output bin), for
// Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel bart_tpu/rt/fused.py:_fkernel, which
// _fpallas_batch dispatches for fused_eclipse_folded.  Same math as the
// plain torch version bart_tpu_torch/rt/fused.py:eclipse_folded_plain.
// The fine table is bin-major: fine point f = b K + k is sub-sample k of
// output bin b.  For every (chain c, fine point f), walking the layers,
//
//   ext_l = sum_r wrows[c, l, r] tab[r, l, f]
//   tau_l = tau_{l-1} + 0.5 (ext_{l-1} + ext_l) drp[c, l]
//   S_l   = sum_q wmu_q exp(-min(tau_l, 88) minv_q)      (raygrid)
//         | Horner sum_q wmu_q u^(q+1), u = exp(-min(tau_l, 88)) (powers)
//   F_f  += 0.5 (B_{l-1} + B_l) (S_{l-1} - S_l),  B_l = Planck(wn_b, T[c, l])
//
// and out[c, b] = 2 pi mean_k (F_f + B_{L-1} S_{L-1}).  B is taken at the
// bin centre, so the flux is linear in S and the mean over k of the
// per-fine-point flux equals the flux of the k-averaged source function
// that the plain version and the TPU kernel form.  Any K >= 2 and any
// number of quadrature nodes.
//
// The fill on tensor cores.  Per layer the fill is the product [MTILE_F
// fine points x Rp rows] x [Rp x CBM chains]: A the table tile, staged
// [row][fine point] as it lies in memory; B the weights, staged
// [chain][row].
//  - bfloat16 table (foldtable16 = True): exactly.  A table element has
//    8 significant bits; each float32 weight arrives as three bfloat16
//    parts hi + mid + lo that sum to it bit for bit
//    (bart_tpu_torch.rt.fused.split_bf16, made once per launch), so every
//    part x element product is exact in float32, and three products per
//    16 rows, summed in float32 by the unit, give the float32 contraction.
//  - float32 table (the reference's default, foldtable16 = False): in
//    3xTF32.  Table element and weight are each split in registers into
//    big = tf32(x) and small = x - big (hopper.cuh: split_tf32), and
//    small x big + big x small (one accumulator) and big x big (another)
//    on mma.sync.m16n8k8 per 8 rows keep every product to 2^-21 of the
//    float32 one; one pass would be 2^-11 off.
//
// Design.  A block is a tile of MTILE_F = 64 fine points x CBM = 32
// chains, 8 warps, two blocks an SM, and walks the layers of its tile; a
// thread carries (ext, tau, S, flux) of 8 (fine point, chain) pairs in
// registers, as the design before did.  What changed:
//  - Copies on the Tensor Memory Accelerator.  Thread 0 sends the row
//    axis's stages (layer, chunk of RS rows) into a ring of NSTAGE slots:
//    the table tile one TMA box (bfloat16: [RS][64] points; float32: two
//    [RS][32] boxes), the weights one box of the three parts of the 32
//    chains (float32: one or two boxes of 32 rows), whole boxes, zero
//    outside the tensors (rows past R, points past Fp, weight rows past
//    Rp, chains past C: padded chains take zero weights and write
//    nothing), completing on the slot's mbarrier with their byte count.
//    The threads wait on that mbarrier; the block's barrier after it
//    tells thread 0 that every thread is done with the slot it refills.
//    No other thread spends an instruction on a copy (the design before:
//    every thread's cp.async index arithmetic, ~1.5 ms of 6.4 at the demo
//    shape, by ablate_folded.py).
//  - bfloat16: the fill on wgmma, a layer ahead.  Each warpgroup (warps
//    0-3: chains 0-15, 4-7: chains 16-31) issues the products of layer
//    l + 1 (m64n16k16: A the table tile read transposed from the
//    swizzled box, B its chains' weight part, three products a k-step,
//    smallest part first, into one accumulator) before it computes the
//    recurrence of layer l, so the tensor cores run under the float32
//    work; the ring holds NSTAGE / nch layers and thread 0 refills layer
//    l's slots once the barrier of layer l shows every warpgroup's
//    products of it complete.  The accumulator's fragment is mma.sync's:
//    thread (g, t) of warp w holds (fine point 16 w + g (+ 8), chains
//    8 j + 2 t (+ 1)), the design before's 8 pairs.  Past 128 rows (more
//    than two chunks a layer, which would not fit the ring twice) a stage
//    at a time: its products issued and complete before the recurrence.
//  - float32: the fill on mma.sync (3xTF32) as before, a stage at a time;
//    the warp's m-tile rows g + 8 h are fine points col32(m, h, g) of its
//    warp pair's 32-point box (below).
//  - The chains' layer steps 0.5 drp go through shared memory, written a
//    layer ahead by the last warp from values it loaded a layer before:
//    no thread holds them in registers or waits for their loads.
// The Planck means, the recurrence, the quadrature, the flux and the
// epilogue (a butterfly where K is a power of two up to 32, else each bin
// in fine-point order and a bin the tile cuts into part for
// fold_straddle.cuh's second launch) are the design before's.  Every
// product, ext, tau, S and flux takes its terms in the order the design
// before took them (wgmma's sums of a k-step equal mma.sync's: the outputs
// are the design before's bit for bit on both table types); no atomics,
// so a graph replay equals an eager launch.
//
// Where the trouble was, and what the design does about it.
//  - The TMA cannot pad rows, and the design before padded its rows
//    (TS = MTILE_F + 8, WS = Rs + 16 / eb) to spread ldmatrix and the
//    float32 fragment loads over the banks.  The boxes land swizzled
//    instead: the table's 128-byte rows with the 128-byte swizzle (a
//    16-byte chunk c of row r lands at c ^ (r & 7)), the weights' rows of
//    RS elements (RS a power of two: 32, 64 or 128 bytes) with the
//    swizzle of their width; these are the canonical layouts wgmma reads
//    (descriptors: 8-row groups 1024 bytes apart for the table, 16 RS
//    bytes for the weights).  The float32 fill's A fragment (row t or
//    t + 4, fine point of lane g) would meet 2-way conflicts in 16
//    consecutive points, so the two warps of a pair split their 32-point
//    box by col32 (a bijection: the products are the same, only a pair's
//    fine point moves).  tests/test_torch_eclipse_ws.py checks the loads'
//    banks and the descriptors against the boxes.
//  - The hand-offs of a warp-specialised plan cost more than
//    they saved here (PERF.md has the ablations).  Two designs split the
//    roles over warps (a producer, fill warps handing ext to 8 recurrence
//    warps through a ring on mbarriers, one block an SM): at R = 27 they
//    ran 4-10% slower than the design before, because 8 recurrence warps
//    an SM cannot hide the float32 work's latencies that 16 hid and the
//    registers allow no more next to the fill warps' accumulators; their
//    mbarrier skeleton alone took 1.9-2.3 ms.  A third kept 16 warps an
//    SM with per-warp Planck means and no block barrier: 7.1 ms, the
//    per-warp Planck means alone ~1 ms.  wgmma's asynchrony gives the
//    overlap without taking warps from the recurrence.
//  - The weights' multicast to a cluster (built and measured slower, not
//    kept).  At the flagship's 122 rows (2,088 bins x 32) a launch copies
//    67 GB from L2: the weights 41 GB (once per tile), the table 26 GB
//    (once per chain block).  Clusters of 2 or 4 tiles of one chain
//    block, each block sending its CBM / 2 or CBM / 4 chains of every
//    stage's weights to all of them (a multicast box a part) and
//    releasing a slot to all of them on an empty mbarrier, cut the
//    weights to a half or a quarter (67 -> 46.5 GB, 36.3).  Bit for bit,
//    and slower (ablate_folded.py --eclipse, ms): bfloat16 17.0-17.1 ->
//    23.8 (2), 25.4 (4); float32 31.4 -> 37.3 (2); 512 rows, 1,125 bins,
//    bfloat16 27.8 -> 34.7 (2).  A block refills a slot only once every
//    block of its cluster is done with it, so each stage waits for the
//    cluster's slowest block, and the ring (two layers of two chunks at
//    two blocks an SM) has no room to hide that wait; the cluster's code
//    also spilled 20-32 B in three instances.
//  - wgmma on float32 tables (not taken): TF32 wgmma reads both operands
//    K-major from shared memory, and the table tile lies M-major as the
//    TMA copies it.
//  - Registers: 128 a thread at two blocks an SM, as before.

// Bound on the H100.  Per 512-chain batch at R = 27, L = 100, 1,064 fine
// bins, K = 32: 47 G FMAs of fill (three passes: 0.29 ms at the dense
// bfloat16 peak, 0.57 ms at the dense TF32 peak) and, on the float32
// pipes, 12 FMAs and one exponential per (chain, layer, fine point): 21 G
// FMAs (0.62 ms) and 1.7 G exponentials (0.42 ms).  From L2 into shared
// memory: the table once per chain block, 16 x 184 MB = 2.9 GB in
// bfloat16 (5.9 GB in float32), and the weights once per tile, 532 x 9.8
// MB of bfloat16 parts = 5.2 GB (532 x 6.6 MB of float32 = 3.5 GB).  At
// the flagship's 122 rows (2,088 bins x 32): 26 GB of table and 41 GB of
// weights.  expf and expm1f are the accurate library versions (no
// --use_fast_math).
//
// Measured on an NVIDIA H100 80GB HBM3 at 700 W (ab_kernels.py against
// the design before, best of two runs each, ms per 512-chain launch):
// 1,125 bins x 32, R = 27: bfloat16 5.684 (6.365 before) expsum, 7.818
// (8.610) raygrid; float32 7.303 (7.624) expsum, 9.622 (10.005) raygrid;
// 1,064 bins, bfloat16 expsum 5.319 (5.948).  The flagship's 122 rows at
// 2,088 bins x 32: bfloat16 16.995 (21.809), float32 30.607 (32.496).
// 512 rows, 1,125 bins: 27.643 (37.461).  PERF.md has the rest and the
// ablations (ablate_folded.py --eclipse).

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include "cluster.cuh"
#include "fold_straddle.cuh"
#include "hopper.cuh"

#define MTILE_F 64   // fine points per block
#define CBM 32       // chains per block
#define NSTAGE 4     // stages in the shared-memory ring
#define MTHREADS 256 // threads per block (8 warps), two blocks an SM
#define RCH 64       // table rows a stage holds at most: the chunk

// Timing aid (ablate_folded.py): -DBART_ABLATE=<bits> builds the kernel
// without 1 its copies (thread 0 arrives without bytes: the hand-offs
// stay), 2 its tensor-core products, 4 its exponentials, 16 its
// recurrence, quadrature and flux (the Planck means, the layer steps and
// the barriers stay); 8 leaves the weights of a float32 table unsplit
// (the word as its big part, no small part).  22: copies, Planck means
// and barriers only; 23: Planck means and barriers only.  The results
// are then wrong.
#ifndef BART_ABLATE
#define BART_ABLATE 0
#endif
#if BART_ABLATE & 4
#define BART_EXPF(x) (1.0f + (x))
#else
#define BART_EXPF(x) expf(x)
#endif

namespace {

static_assert(MTILE_F % 32 == 0 && CBM % 16 == 0 &&
                  MTHREADS == 32 * (MTILE_F / 16) * (CBM / 16),
              "the warp tiling: a warp per 16 fine points x 16 chains");

// 2 h c^2 and h c / k from bart_tpu_torch.constants (cgs; the CPU tests
// check these literals against the Python constants)
constexpr float kC1 = 1.1910439340652298e-05f;
constexpr float kC2 = 1.4387686603333911f;
constexpr float kTwoPi = 6.2831853071795865f;
constexpr float kTauClamp = 88.0f;
constexpr unsigned kFullMask = 0xffffffffu;

// The most output bins a tile of MTILE_F fine points touches: MTILE_F / K
// where K divides the tile (the tiles start on bin boundaries), else
// (MTILE_F - 1) / K + 2 (a bin cut at each end); at most MTILE_F / 2.
__host__ __device__ constexpr int fold_bins(int K) {
  return MTILE_F % K == 0 ? MTILE_F / K : (MTILE_F - 1) / K + 2;
}

// The rows a stage holds: RCH when the row axis is chunked (Rp > RCH),
// else Rp rounded up to a power of two (at least one k-step: 16 rows of
// a bfloat16 table, 8 of a float32 one), so that a weight row is 32, 64
// or 128 bytes, a swizzle's width.  The rows past Rp are zeros of the
// box.  (A float32 table's 33-48 rows, the reference's R = 41, were
// tried in stages of 48, the weights in three boxes of 16-row rows: they
// ran slower than in 64.)
__host__ __device__ constexpr int stage_rows(int Rp, int eb) {
  return Rp > RCH ? RCH
         : Rp <= 32 / eb ? 32 / eb
         : Rp <= 64 / eb ? 64 / eb
         : Rp <= 128 / eb ? 128 / eb
                          : RCH;
}

// Bytes of a stage of RS rows, a table of eb bytes an element whose
// weights come in np parts of that type (bfloat16: eb = 2, np = 3;
// float32: eb = 4, np = 1): the table tile [RS][MTILE_F] and the weights
// [np][CBM][RS], each a whole number of the swizzle's 1024-byte periods,
// as the TMA writes them (no padding).
__host__ __device__ constexpr size_t mma_stage_bytes(int RS, int eb, int np) {
  return (size_t)eb * RS * (MTILE_F + np * CBM);
}
// Shared memory, in bytes, for stages of RS rows and K sub-samples: 1024
// to align the ring (the swizzle's period), NSTAGE stages, the Planck
// means (two buffers [fold_bins(K)][CBM] of float32), then the stages'
// mbarriers (8 bytes each).  The epilogue reuses the ring for
// [CBM][MTILE_F + 4] sums.
__host__ __device__ constexpr size_t mma_smem_bytes(int RS, int K, int eb,
                                                    int np) {
  return 1024 + NSTAGE * mma_stage_bytes(RS, eb, np) +
         2 * 4 * (size_t)fold_bins(K) * CBM + 8 * NSTAGE;
}
static_assert(RCH == 64, "a chunk's weight rows are 128 bytes of bfloat16");
static_assert(NSTAGE * mma_stage_bytes(16, 2, 3) >= 4 * CBM * (MTILE_F + 4) &&
                  NSTAGE * mma_stage_bytes(8, 4, 1) >= 4 * CBM * (MTILE_F + 4),
              "the epilogue's sums must fit the ring");
static_assert(2 * (mma_smem_bytes(RCH, 2, 4, 1) + 1024) <= 233472 &&
                  2 * (mma_smem_bytes(RCH, 2, 2, 3) + 1024) <= 233472,
              "two blocks an SM at the largest stages and K = 2");

// A byte offset o into a buffer written by the TMA with the swizzle of
// rows of 16 (m + 1) bytes (m = 1, 3, 7: 32, 64, 128 bytes): the 16-byte
// chunk bits 4.. of o XORed with bits 7.. (CUTLASS's Swizzle<1|2|3, 4, 3>)
__device__ __forceinline__ int swz(int o, int m) {
  return o ^ (((o >> 7) & m) << 4);
}

// The float32 fill's mma row g + 8 h of m-tile m is fine point
// col32(m, h, g) of the 32 of the warp pair (warps 2 i and 2 i + 1 of a
// chain half take m = 0 and 1), a bijection, so that its A fragment's
// loads from the 128-byte swizzle hit all banks
__host__ __device__ constexpr int col32(int m, int h, int g) {
  return 16 * (g >> 2) + 8 * m + 4 * h + (g & 3);
}

// ---- wgmma (sm_90a): the bfloat16 fill of a warpgroup, asynchronous.
// A shared-memory matrix descriptor: start address, leading and stride
// byte offsets (16-byte units), swizzle (1: 128-byte, 2: 64, 3: 32).
__device__ __forceinline__ uint64_t gmma_desc(const void* p, unsigned lbo,
                                              unsigned sbo, unsigned swizzle) {
  return (uint64_t)((smem_u32(p) & 0x3FFFF) >> 4) |
         ((uint64_t)((lbo >> 4) & 0x3FFF) << 16) |
         ((uint64_t)((sbo >> 4) & 0x3FFF) << 32) | ((uint64_t)swizzle << 62);
}
// d += A B over 16 rows: A [64 fine points x 16 rows] from the table
// tile (M-major: transposed), B [16 rows x 16 chains] from the weights
// (K-major); d is the m64n16 fragment: d[4 j + i] of lane 4 g + t of warp
// w of the warpgroup is (point 16 w + g + 8 (i / 2), chain
// 8 j + 2 t + (i & 1)), the fragment of mma.sync's two n-tiles
__device__ __forceinline__ void wgmma_bf16(float (&d)[2][4], uint64_t da,
                                           uint64_t db) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %10, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n16k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7}, %8, %9, p, 1, 1, 1, 0;\n"
      "}\n"
      : "+f"(d[0][0]), "+f"(d[0][1]), "+f"(d[0][2]), "+f"(d[0][3]),
        "+f"(d[1][0]), "+f"(d[1][1]), "+f"(d[1][2]), "+f"(d[1][3])
      : "l"(da), "l"(db), "r"(1));
}
__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_wait0() {
  asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
}
// keeps the compiler from moving accesses to d across an asynchronous
// product's issue or wait
__device__ __forceinline__ void fence_acc(float (&d)[2][4]) {
#pragma unroll
  for (int nt = 0; nt < 2; ++nt)
#pragma unroll
    for (int i = 0; i < 4; ++i) asm volatile("" : "+f"(d[nt][i])::"memory");
}

// TabT: __nv_bfloat16 or float; the weights are staged in the same type
// (bfloat16: split_bf16's three parts, lo, mid, hi; float32: as given).
// NMU > 0: the quadrature has exactly NMU nodes, held in shared memory,
// and its loops unroll; NMU == 0: any number of nodes, read through the
// read-only cache (no bound but the loop's length).  CHUNKED (Rp > RCH):
// a layer is ceil(Rp / RCH) stages of RCH rows; else one stage.  LANES
// (K a power of two up to 32): a bin's sub-samples are K neighbouring
// lanes of the sums, added by a butterfly; else any K, each bin summed in
// fine-point order and the bins the tile cuts left in ``part``.  Two
// instances, not a branch: both epilogues in one kernel cost registers at
// the 128-register cap.  tmap_t: the table [R][L][Fp] as dims (Fp, L, R),
// boxes of 64 (bfloat16) or 32 (float32) points x 1 layer x RS rows,
// 128-byte swizzle; tmap_w: the weights [NP][C][L][Rp] as dims
// (Rp, L, C, NP), boxes of RS (float32: at most 32) rows x 1 layer x CBM
// chains x NP parts, the swizzle of their rows' width (zero outside both
// tensors).
template <typename TabT, bool POWERS, int NMU, bool CHUNKED, bool LANES>
__global__ void __launch_bounds__(MTHREADS, 512 / MTHREADS)
fused_eclipse_folded_mma_kernel(
    const __grid_constant__ CUtensorMap tmap_t,
    const __grid_constant__ CUtensorMap tmap_w,
    const float* __restrict__ T,       // [C, L]
    const float* __restrict__ drp,     // [C, L]
    const float* __restrict__ wn,      // [W] bin centres
    const float* __restrict__ minv,    // [nmu]
    const float* __restrict__ wmu,     // [nmu]
    float* __restrict__ out,           // [C, W]
    float* __restrict__ part,          // [C, ntile, 2] (straddling K)
    int Rp, int L, int W, int C, int K, int nmu_any, int ntile) {
  const int tile = grid_tile();
  if (tile >= ntile) return;        // past the last tile (tile_grid)
  constexpr bool kBf16 = sizeof(TabT) == 2;
  constexpr int EB = sizeof(TabT);
  constexpr int NP = kBf16 ? 3 : 1;       // parts of the weights
  constexpr int UR = kBf16 ? 16 : 8;      // rows of one product (k-step)
  const int nmu = NMU ? NMU : nmu_any;
  constexpr int VS = MTILE_F + 4;     // row stride of the epilogue's sums
  constexpr int PP = CBM * (MTILE_F / 2) / MTHREADS;  // Planck pairs a thread
  const int RS = CHUNKED ? RCH : stage_rows(Rp, EB);   // rows a stage holds
  const int SB = (int)mma_stage_bytes(RS, EB, NP);
  const int TB = RS * MTILE_F * EB;        // a stage's table tile
  // the weights' rows: RSI = 1 << RSH elements (float32: two boxes of 32
  // rows at RS = 64), WM the swizzle's mask
  const int RSI = (RS * EB > 128) ? 128 / EB : RS;
  const int RSH = 31 - __clz(RSI);
  const int WM = RSI * EB / 16 - 1;
  extern __shared__ float4 smem4[];
  unsigned char* ring = reinterpret_cast<unsigned char*>(smem4) +
                        ((1024 - (smem_u32(smem4) & 1023)) & 1023);
  float* bmid_s = reinterpret_cast<float*>(ring + NSTAGE * (size_t)SB);
  uint64_t* full = reinterpret_cast<uint64_t*>(bmid_s +
                                               2 * fold_bins(K) * CBM);
  __shared__ float minv_s[NMU ? NMU : 1], wmu_s[NMU ? NMU : 1];
  __shared__ float wn_s[MTILE_F / 2];
  __shared__ __align__(8) float hdr_s[2][CBM];
  // the tile's first bin, read back by the epilogue (LANES false), so
  // that no register holds it through the layer loop, whose live values
  // fill the 128-register cap
  __shared__ int b0_s;
  // quadrature node q: NMU > 0 from shared memory, else from the
  // read-only cache
  auto wmu_q = [&](int q) { return NMU ? wmu_s[q] : __ldg(wmu + q); };
  auto minv_q = [&](int q) { return NMU ? minv_s[q] : __ldg(minv + q); };

  const int tid = threadIdx.x;
  const int lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, t = lane & 3;
  const int wp = warp % (MTILE_F / 16);          // the warp's m-tile
  const int ch = (warp / (MTILE_F / 16)) * 16;   // and chains, 16 of each
  const int F = W * K;
  const int c0 = blockIdx.x * CBM;
  const int f0 = tile * MTILE_F;
  // the thread's two fine points (mma rows g and g + 8 of the warp's
  // m-tile): bfloat16 16 wp + g (+ 8); float32, whose table tile lies in
  // two 32-point boxes, 32 (wp / 2) + col32(wp % 2, 0 | 1, g)
  const int pt_lo = kBf16 ? 16 * wp + g : 32 * (wp >> 1) + col32(wp & 1, 0, g);
  const int pt_hi = kBf16 ? 16 * wp + g + 8
                          : 32 * (wp >> 1) + col32(wp & 1, 1, g);
  // the output bins the tile touches, b0 .. b0 + nb - 1 (those from W on
  // are padding): K divides MTILE_F, then nb = MTILE_F / K; else the
  // tile's first and last bins may be cut (fold_straddle.cuh)
  const int b0 = f0 / K;
  const int nb = LANES ? MTILE_F / K : (f0 + MTILE_F - 1) / K - b0 + 1;

  if (NMU && tid < NMU) {
    minv_s[tid] = minv[tid];
    wmu_s[tid] = wmu[tid];
  }
  if (tid < nb) wn_s[tid] = b0 + tid < W ? wn[b0 + tid] : 1.0f;
  if (!LANES && tid == 0) b0_s = b0;
  if (tid == 0) {
    for (int i = 0; i < NSTAGE; ++i) mbar_init(full + i, 1);
    mbar_init_fence();
    asm volatile("prefetch.tensormap [%0];" ::"l"(&tmap_t) : "memory");
    asm volatile("prefetch.tensormap [%0];" ::"l"(&tmap_w) : "memory");
  }
  __syncthreads();  // the barriers are set up

  // stage ``s`` of the ring, rows r0 .. r0 + RS - 1 of layer l, sent by
  // thread 0 through the Tensor Memory Accelerator: the table tile (one
  // box of 64 bfloat16 points, two of 32 float32 ones) and the weight
  // parts of those rows of the block's chains (one box; float32, one or
  // two of 32 rows), whole boxes, zero outside the tensors (rows past R,
  // points past Fp, weight rows past Rp, chains past C), completing on the
  // slot's mbarrier with their byte count.  No other thread spends an
  // instruction on the copies.
  auto copy_stage = [&](int s, int l, int r0) {
    uint64_t* bar = full + s % NSTAGE;
    if (BART_ABLATE & 1) {
      mbar_arrive(bar);
      return;
    }
    unsigned char* st = ring + (size_t)(s % NSTAGE) * SB;
    mbar_arrive_expect_tx(bar, (unsigned)SB);
    tma_load_3d(st, &tmap_t, f0, l, r0, bar);
    if (kBf16) {
      tma_load_4d(st + TB, &tmap_w, r0, l, c0, 0, bar);
    } else {
      tma_load_3d(st + TB / 2, &tmap_t, f0 + 32, l, r0, bar);
      for (int h = 0; h < RS >> RSH; ++h)
        tma_load_4d(st + TB + h * (CBM * RSI * EB), &tmap_w, r0 + (h << RSH),
                    l, c0, 0, bar);
    }
  };
  // wait for stage s, then the block's barrier: every thread is done with
  // stage s - 1 (whose slot thread 0 refills next) and the Planck means
  auto stage_ready = [&](int s) {
    mbar_wait(full + s % NSTAGE, (unsigned)(s / NSTAGE) & 1);
    __syncthreads();
  };

  // The Planck pairs (chain c0 + p % CBM, bin b0 + p / CBM), p < CBM nb
  // <= CBM MTILE_F / 2: thread tid takes the pairs p = tid + j MTHREADS,
  // so with few pairs (K = 32: CBM 4) only the first warps spend
  // instructions on them.  pl_T holds T of the layer whose B comes next;
  // the bins' wavenumbers are read from wn_s in the layer loop.
  const int npair = CBM * nb;
  float pl_prev[PP], pl_T[PP];
#pragma unroll
  for (int j = 0; j < PP; ++j) {
    const int p = tid + j * MTHREADS;
    const int bin = b0 + p / CBM, c = c0 + p % CBM;
    const float wnv = (p < npair && bin < W) ? wn[bin] : 1.0f;
    const float T0 = (p < npair && c < C) ? T[(size_t)c * L] : 1000.0f;
    pl_prev[j] = kC1 * (wnv * wnv * wnv) / expm1f(kC2 * wnv / T0);  // layer 0
    pl_T[j] = (p < npair && c < C && L > 1) ? T[(size_t)c * L + 1] : 1000.0f;
  }

  // this thread's 8 (fine point, chain) pairs: e = 4 nt + i is fine point
  // pt_lo (i < 2) or pt_hi, chain ch + 8 nt + 2 t + (i & 1)
  float ext_p[8], tau[8], S_p[8], flux[8];
#pragma unroll
  for (int e = 0; e < 8; ++e) ext_p[e] = tau[e] = S_p[e] = flux[e] = 0.0f;
  // the bins (relative to b0) of the thread's two fine points
  const int bin_lo = (f0 + pt_lo) / K - b0;
  const int bin_hi = (f0 + pt_hi) / K - b0;
  // half the layer step of the block's chains: the last warp's lane c
  // writes 0.5 drp[c0 + c, l] into hdr_s[l & 1][c] a layer ahead, from a
  // value it loaded a layer before that (zero past C), so that no thread
  // holds the layer steps of its chains in registers or waits for their
  // loads
  const bool hdr_lane = warp == MTHREADS / 32 - 1;
  const int hc = c0 + lane;
  float dnext = (hdr_lane && hc < C && L > 1) ? drp[(size_t)hc * L + 1]
                                              : 0.0f;

  // at a layer's first stage: the Planck means of layer l + 1, for after
  // the next barrier, and the chains' layer step
  auto layer_start = [&](int l) {
    if (l + 1 < L) {
      float* bn = bmid_s + ((l + 1) & 1) * npair;
#pragma unroll
      for (int j = 0; j < PP; ++j) {
        const int p = tid + j * MTHREADS;
        if (p < npair) {
          const float wnv = wn_s[p / CBM];
          const float B =
              kC1 * (wnv * wnv * wnv) / expm1f(kC2 * wnv / pl_T[j]);
          bn[p] = 0.5f * (pl_prev[j] + B);
          pl_prev[j] = B;
          const int c = c0 + p % CBM;
          if (c < C && l + 2 < L) pl_T[j] = T[(size_t)c * L + l + 2];
        }
      }
    }
    if (hdr_lane && l + 1 < L) {
      hdr_s[(l + 1) & 1][lane] = 0.5f * dnext;
      if (hc < C && l + 2 < L) dnext = drp[(size_t)hc * L + l + 2];
    }
  };

  // ---- ext of a layer: per k-step three bfloat16 passes (the weight
  // parts, smallest first, into acc) or three TF32 ones (the two small
  // products into acc, the big one into accb), as the design before took
  // them; the fragments come from the swizzled boxes
  float acc[2][4], accb[2][4];
  auto clear = [&]() {
#pragma unroll
    for (int nt = 0; nt < 2; ++nt)
#pragma unroll
      for (int i = 0; i < 4; ++i) acc[nt][i] = accb[nt][i] = 0.0f;
  };
  // the KS k-steps of the rows staged in slot ``s``
  // bfloat16: the warpgroup's k-steps of the rows staged in slot ``s``
  // on wgmma (asynchronous: the caller commits and waits), three products
  // a k-step, the weight parts smallest first, into the one accumulator
  const int wg = warp >> 2;
  const unsigned wsw = RS == 64 ? 1u : RS == 32 ? 2u : 3u;
  auto issue_bf16 = [&](int s, int KS) {
    if constexpr (kBf16) {
      const unsigned char* st = ring + (size_t)(s % NSTAGE) * SB;
      const unsigned char* wb = st + TB;
      for (int ks = 0; ks < ((BART_ABLATE & 2) ? 0 : KS); ++ks) {
        // A: the tile's rows 16 ks .. + 15, 128-byte rows, 8-row groups
        // 1024 bytes apart (both offsets: M is one swizzle atom)
        const uint64_t da = gmma_desc(st + 2048 * ks, 1024, 1024, 1);
#pragma unroll
        for (int p = 0; p < 3; ++p) {
          // B: part p's chains 16 wg .. + 15, rows 16 ks .., K-major rows
          // of RS bfloat16, 8-row groups 16 RS bytes apart
          const uint64_t db =
              gmma_desc(wb + 2 * (((p * CBM + 16 * wg) << RSH) + 16 * ks),
                        16, 16 * RS, wsw);
          wgmma_bf16(acc, da, db);
        }
      }
    }
  };
  // float32: the warp's k-steps of the rows staged in slot ``s``, 3xTF32
  // on mma.sync (the two small products into acc, the big one into accb)
  auto fill_f32 = [&](int s, int KS) {
    if constexpr (!kBf16) {
      const unsigned char* st = ring + (size_t)(s % NSTAGE) * SB;
      const unsigned char* wb = st + TB;
      // A: (mma row g (+ 8), row 8 ks + t (+ 4)) of the warp's 32-point
      // box: rows 8 ks .. of 128 bytes are 1024 ks on, and the swizzle
      // does not see ks
      const int cl = col32(wp & 1, 0, g), chh = col32(wp & 1, 1, g);
      const unsigned char* th0 = st + (wp >> 1) * (TB / 2);
      const int a00 = swz(128 * t + 4 * cl, 7), a01 = swz(128 * t + 4 * chh, 7);
      const int a10 = swz(128 * (t + 4) + 4 * cl, 7);
      const int a11 = swz(128 * (t + 4) + 4 * chh, 7);
      // B: (row k, chain q = ch + 8 nt + g): the box of 32 rows k >> RSH,
      // the row's 4 (q RSI + k % RSI) bytes, whose swizzle bits are q's
      int qo[2], xq[2];
#pragma unroll
      for (int nt = 0; nt < 2; ++nt) {
        qo[nt] = 4 * ((ch + 8 * nt + g) << RSH);
        xq[nt] = ((qo[nt] >> 7) & WM) << 4;
      }
      for (int ks = 0; ks < ((BART_ABLATE & 2) ? 0 : KS); ++ks) {
        const unsigned char* th = th0 + 1024 * ks;
        uint32_t ab[4], as[4];
        split_tf32(*reinterpret_cast<const float*>(th + a00), ab[0], as[0]);
        split_tf32(*reinterpret_cast<const float*>(th + a01), ab[1], as[1]);
        split_tf32(*reinterpret_cast<const float*>(th + a10), ab[2], as[2]);
        split_tf32(*reinterpret_cast<const float*>(th + a11), ab[3], as[3]);
        const int k0 = 8 * ks + t, k1 = k0 + 4;
        const int kb0 = (k0 >> RSH) * (CBM * RSI * 4);
        const int kb1 = (k1 >> RSH) * (CBM * RSI * 4);
        const int kk0 = 4 * (k0 & (RSI - 1)), kk1 = 4 * (k1 & (RSI - 1));
#pragma unroll
        for (int nt = 0; nt < 2; ++nt) {
          const float w0 = *reinterpret_cast<const float*>(
              wb + kb0 + ((qo[nt] + kk0) ^ xq[nt]));
          const float w1 = *reinterpret_cast<const float*>(
              wb + kb1 + ((qo[nt] + kk1) ^ xq[nt]));
          uint32_t bb[2], bs[2];
#if BART_ABLATE & 8
          bb[0] = __float_as_uint(w0);
          bb[1] = __float_as_uint(w1);
          bs[0] = bs[1] = 0u;
#else
          split_tf32(w0, bb[0], bs[0]);
          split_tf32(w1, bb[1], bs[1]);
#endif
          mma_tf32(acc[nt], as, bb);
          mma_tf32(acc[nt], ab, bs);
          mma_tf32(accb[nt], ab, bb);
        }
      }
    }
  };

  // ---- recurrence, quadrature and flux of layer l on the accumulator
  // fragments ------------------------------------------------------------
  // ext of pair e = 4 nt + i from the accumulators; float32 table: the
  // small products first
  auto take_ext = [&](float (&ext)[8]) {
#pragma unroll
    for (int e = 0; e < 8; ++e)
      ext[e] = kBf16 ? acc[e >> 2][e & 3]
                     : acc[e >> 2][e & 3] + accb[e >> 2][e & 3];
  };
  auto layer_step = [&](int l, const float (&ext)[8]) {
    if (BART_ABLATE & 16) return;
    const float* bm = bmid_s + (l & 1) * npair;   // 0.5 (B_{l-1} + B_l)
    float S[8];
    if (l > 0) {
      // half the layer step of the thread's chains ch + 8 nt + 2 t (+ 1)
      float hdr[4];
#pragma unroll
      for (int nt = 0; nt < 2; ++nt) {
        const float2 h = *reinterpret_cast<const float2*>(
            &hdr_s[l & 1][ch + 8 * nt + 2 * t]);
        hdr[2 * nt] = h.x;
        hdr[2 * nt + 1] = h.y;
      }
#pragma unroll
      for (int e = 0; e < 8; ++e) {
        tau[e] = tau[e] + (ext_p[e] + ext[e]) * hdr[2 * (e >> 2) + (e & 1)];
        ext_p[e] = ext[e];
      }
    } else {
#pragma unroll
      for (int e = 0; e < 8; ++e) ext_p[e] = ext[e];
    }
    if (POWERS) {
      float u[8];
#pragma unroll
      for (int e = 0; e < 8; ++e) {
        u[e] = BART_EXPF(-fminf(tau[e], kTauClamp));
        S[e] = wmu_q(nmu - 1);
      }
#pragma unroll
      for (int q = nmu - 2; q >= 0; --q) {
        const float aq = wmu_q(q);
#pragma unroll
        for (int e = 0; e < 8; ++e) S[e] = fmaf(u[e], S[e], aq);
      }
#pragma unroll
      for (int e = 0; e < 8; ++e) S[e] = u[e] * S[e];
    } else {
      float tc[8];
#pragma unroll
      for (int e = 0; e < 8; ++e) {
        tc[e] = -fminf(tau[e], kTauClamp);
        S[e] = 0.0f;
      }
#pragma unroll
      for (int q = 0; q < nmu; ++q) {
        const float aq = wmu_q(q), mq = minv_q(q);
#pragma unroll
        for (int e = 0; e < 8; ++e) S[e] = S[e] + aq * BART_EXPF(tc[e] * mq);
      }
    }
    if (l > 0) {
#pragma unroll
      for (int nt = 0; nt < 2; ++nt) {
        const int cc = ch + 8 * nt + 2 * t;
        const float2 blo =
            *reinterpret_cast<const float2*>(bm + bin_lo * CBM + cc);
        const float2 bhi =
            *reinterpret_cast<const float2*>(bm + bin_hi * CBM + cc);
        const int e = 4 * nt;
        flux[e] = flux[e] + blo.x * (S_p[e] - S[e]);
        flux[e + 1] = flux[e + 1] + blo.y * (S_p[e + 1] - S[e + 1]);
        flux[e + 2] = flux[e + 2] + bhi.x * (S_p[e + 2] - S[e + 2]);
        flux[e + 3] = flux[e + 3] + bhi.y * (S_p[e + 3] - S[e + 3]);
      }
    }
#pragma unroll
    for (int e = 0; e < 8; ++e) S_p[e] = S[e];
  };

  // a stage is (layer, chunk of RS rows); the last chunk of a layer
  // takes the rest of its k-steps
  const int nch = (Rp + RS - 1) / RS;
  const int nstage = L * nch;
  auto ksteps = [&](int k) {
    return k < nch - 1 ? RS / UR : (Rp - (nch - 1) * RS) / UR;
  };
  if (kBf16 && 2 * nch <= NSTAGE) {
    // ---- bfloat16, a layer ahead: the products of layer l + 1 run on the
    // tensor cores while the threads compute the recurrence of layer l.
    // The ring holds LA = NSTAGE / nch layers; at layer l, once every
    // warpgroup's products of layer l are complete (the barrier), thread
    // 0 refills layer l's slots with layer l + LA's stages.
    const int LA = NSTAGE / nch;
    if (tid == 0)
      for (int s = 0; s < NSTAGE && s < nstage; ++s)
        copy_stage(s, s / nch, (s % nch) * RS);
    // the products of layer ln into acc, issued without waiting
    auto issue_layer = [&](int ln) {
      clear();
      for (int k = 0; k < nch; ++k) {
        const int s = ln * nch + k;
        mbar_wait(full + s % NSTAGE, (unsigned)(s / NSTAGE) & 1);
      }
      fence_acc(acc);
      wgmma_fence();
      for (int k = 0; k < nch; ++k) issue_bf16(ln * nch + k, ksteps(k));
      wgmma_commit();
      fence_acc(acc);
    };
    issue_layer(0);
    for (int l = 0; l < L; ++l) {
      wgmma_wait0();
      fence_acc(acc);
      float ext[8];
      take_ext(ext);
      __syncthreads();  // layer l's products are complete in every
                        // warpgroup; every thread is done with the means
                        // of layer l - 1
      if (tid == 0 && l + LA < L)
        for (int k = 0; k < nch; ++k)
          copy_stage((l + LA) * nch + k, l + LA, k * RS);
      layer_start(l);
      if (l + 1 < L) issue_layer(l + 1);
      layer_step(l, ext);
    }
  } else {
    // ---- a stage at a time (float32; bfloat16 past 128 rows, where two
    // layers' stages would not fit the ring): thread 0 sends stage
    // s + NSTAGE - 1 once every thread is past the barrier of stage s
    // (its slot held stage s - 1)
    int cl = 0, ck = 0;      // the next stage to send: chunk ck of layer cl
    auto send_next = [&](int s) {
      if (s < nstage) copy_stage(s, cl, ck * RS);
      if (++ck == nch) {
        ck = 0;
        ++cl;
      }
    };
    if (tid == 0)
      for (int s = 0; s < NSTAGE - 1; ++s) send_next(s);
    for (int l = 0, s = 0; l < L; ++l) {
      clear();
      for (int k = 0; k < nch; ++k, ++s) {
        stage_ready(s);
        if (tid == 0) send_next(s + NSTAGE - 1);
        if (k == 0) layer_start(l);
        if constexpr (kBf16) {
          fence_acc(acc);
          wgmma_fence();
          issue_bf16(s, ksteps(k));
          wgmma_commit();
          wgmma_wait0();
          fence_acc(acc);
        } else {
          fill_f32(s, ksteps(k));
        }
      }
      float ext[8];
      take_ext(ext);
      layer_step(l, ext);
    }
  }

  // ---- close with B_{L-1} S_{L-1}, then the sum over k ----------------
  __syncthreads();  // every thread is done with the ring and the means
#pragma unroll
  for (int j = 0; j < PP; ++j) {
    const int p = tid + j * MTHREADS;
    if (p < npair) bmid_s[p] = pl_prev[j];
  }
  __syncthreads();
  float* v_s = reinterpret_cast<float*>(ring);     // [CBM][VS]
#pragma unroll
  for (int e = 0; e < 8; ++e) {
    const int cc = ch + 8 * (e >> 2) + 2 * t + (e & 1);
    const int bin = (e & 2) ? bin_hi : bin_lo;
    v_s[cc * VS + ((e & 2) ? pt_hi : pt_lo)] =
        flux[e] + bmid_s[bin * CBM + cc] * S_p[e];
  }
  __syncthreads();
  const float scale = kTwoPi / (float)K;
  if constexpr (LANES) {
    // a bin's sub-samples are K neighbouring lanes: a butterfly
    for (int i = tid; i < CBM * MTILE_F; i += MTHREADS) {
      const int cc = i / MTILE_F, fl = i % MTILE_F;
      float v = v_s[cc * VS + fl];
      for (int o = K >> 1; o > 0; o >>= 1)
        v += __shfl_xor_sync(kFullMask, v, o);
      const int c = c0 + cc, f = f0 + fl;
      if ((fl & (K - 1)) == 0 && f < F && c < C)
        out[(size_t)c * W + f / K] = scale * v;
    }
  } else {
    // any other K: a thread a (bin, chain) sums the bin's sub-samples in
    // this tile in the order of their fine points; a bin cut by the tile
    // leaves its sum in part for the second launch (fold_straddle.cuh)
    const int fe = f0 + MTILE_F, b0e = b0_s;
    for (int i = tid; i < npair; i += MTHREADS) {
      const int j = i / CBM, cc = i % CBM;
      const int b = b0e + j, c = c0 + cc;
      if (b >= W || c >= C) continue;
      const int lo = max(b * K, f0), hi = min((b + 1) * K, fe);
      float v = 0.0f;
      for (int f = lo; f < hi; ++f) v += v_s[cc * VS + f - f0];
      if (b * K >= f0 && (b + 1) * K <= fe)
        out[(size_t)c * W + b] = scale * v;
      else
        part[((size_t)c * ntile + f0 / MTILE_F) * 2 + ((b + 1) * K > fe)] =
            v;
    }
  }
}

template <typename TabT, bool POWERS, int NMU, bool CHUNKED, bool LANES>
cudaError_t launch_mma(const void* tab, const void* wparts, const float* T,
                       const float* drp, const float* wn, const float* minv,
                       const float* wmu, float* out, float* part, int R,
                       int Rp, int L, int W, int Fp, int C, int K, int nmu,
                       cudaStream_t stream) {
  constexpr bool kBf16 = sizeof(TabT) == 2;
  constexpr int EB = sizeof(TabT);
  constexpr int NP = kBf16 ? 3 : 1;
  const bool straddles = fold_straddles<MTILE_F>(K);
  if (Rp % (kBf16 ? 16 : 8) != 0 || Rp < R || Fp % 8 != 0 ||
      Fp >= kMaxRow || (long long)NP * C * L * Rp >= (1ll << 31) ||
      (straddles && part == nullptr))
    return cudaErrorInvalidValue;
  const int RS = CHUNKED ? RCH : stage_rows(Rp, EB);
  const int RSI = (RS * EB > 128) ? 128 / EB : RS;
  const size_t smem = mma_smem_bytes(RS, K, EB, NP);
  // the table [R][L][Fp] as dims (Fp, L, R); the weights [NP][C][L][Rp] as
  // (Rp, L, C, NP); zero outside both
  const CUtensorMapDataType dt = kBf16 ? CU_TENSOR_MAP_DATA_TYPE_BFLOAT16
                                       : CU_TENSOR_MAP_DATA_TYPE_FLOAT32;
  const cuuint64_t es = EB;
  const int wrow = RSI * EB;
  CUtensorMap tmap_t, tmap_w;
  if (!encode_map<3>(&tmap_t, dt, tab,
                     {(cuuint64_t)Fp, (cuuint64_t)L, (cuuint64_t)R},
                     {(cuuint64_t)Fp * es, (cuuint64_t)L * Fp * es},
                     {(cuuint32_t)(128 / EB), 1, (cuuint32_t)RS},
                     CU_TENSOR_MAP_SWIZZLE_128B) ||
      !encode_map<4>(&tmap_w, dt, wparts,
                     {(cuuint64_t)Rp, (cuuint64_t)L, (cuuint64_t)C,
                      (cuuint64_t)NP},
                     {(cuuint64_t)Rp * es, (cuuint64_t)L * Rp * es,
                      (cuuint64_t)C * L * Rp * es},
                     {(cuuint32_t)RSI, 1, CBM, (cuuint32_t)NP},
                     wrow == 32   ? CU_TENSOR_MAP_SWIZZLE_32B
                     : wrow == 64 ? CU_TENSOR_MAP_SWIZZLE_64B
                                  : CU_TENSOR_MAP_SWIZZLE_128B))
    return cudaErrorInvalidValue;
  const cudaError_t e = cudaFuncSetAttribute(
      fused_eclipse_folded_mma_kernel<TabT, POWERS, NMU, CHUNKED, LANES>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e != cudaSuccess) return e;
  const int ntile = (W * K + MTILE_F - 1) / MTILE_F;
  fused_eclipse_folded_mma_kernel<TabT, POWERS, NMU, CHUNKED, LANES>
      <<<tile_grid((C + CBM - 1) / CBM, ntile), MTHREADS, smem, stream>>>(
          tmap_t, tmap_w, T, drp, wn, minv, wmu, out, part, Rp, L, W, C, K,
          nmu, ntile);
  const cudaError_t e2 = cudaGetLastError();
  if (e2 != cudaSuccess || !straddles) return e2;
  return launch_fold_straddle<MTILE_F>(part, out, C, W, K, ntile,
                                       kTwoPi / (float)K, 1.0f, stream);
}

// the row chunks (CHUNKED) and the epilogue (LANES) of one quadrature
template <typename TabT, bool POWERS, int NMU>
cudaError_t launch_rows(const void* tab, const void* wparts, const float* T,
                        const float* drp, const float* wn, const float* minv,
                        const float* wmu, float* out, float* part, int R,
                        int Rp, int L, int W, int Fp, int C, int K, int nmu,
                        cudaStream_t stream) {
  const bool lanes = K <= 32 && (K & (K - 1)) == 0;
#define BART_MMA(CHUNKED, LANES)                                              \
  launch_mma<TabT, POWERS, NMU, CHUNKED, LANES>(tab, wparts, T, drp, wn,      \
                                                minv, wmu, out, part, R, Rp,  \
                                                L, W, Fp, C, K, nmu, stream)
  return Rp > RCH ? (lanes ? BART_MMA(true, true) : BART_MMA(true, false))
                  : (lanes ? BART_MMA(false, true) : BART_MMA(false, false));
#undef BART_MMA
}

// the quadratures in use get unrolled instances: expsum's 8 powers,
// raygrid's 5 angles
template <typename TabT>
cudaError_t launch_quad(const void* tab, const void* wparts, const float* T,
                        const float* drp, const float* wn, const float* minv,
                        const float* wmu, float* out, float* part, int R,
                        int Rp, int L, int W, int Fp, int C, int K, int nmu,
                        int powers, cudaStream_t stream) {
#define BART_Q(POWERS, NMU)                                                   \
  launch_rows<TabT, POWERS, NMU>(tab, wparts, T, drp, wn, minv, wmu, out,     \
                                 part, R, Rp, L, W, Fp, C, K, nmu, stream)
  return powers ? (nmu == 8 ? BART_Q(true, 8) : BART_Q(true, 0))
                : (nmu == 5 ? BART_Q(false, 5) : BART_Q(false, 0));
#undef BART_Q
}

}  // namespace

// Plain C entry point (bound with ctypes).  tab [R, L, Fp] is the
// bin-major fine table whose first W K columns are in use, Fp a multiple
// of 8 below 2^31 - 64; K >= 2 sub-samples a bin, nmu >= 1 quadrature nodes.  The
// weights w as the kernel reads them, zero-padded to Rp rows: for a
// bfloat16 table (bf16 != 0) the three bfloat16 parts [3, C, L, Rp],
// smallest first, Rp = R rounded up to 16; for a float32 table
// [C, L, Rp] float32, Rp = R rounded up to 8 (NP C L Rp < 2^31: the
// weights are indexed in 32 bits).  part: where K does not
// divide the 64-point tile, the straddling bins' partial sums,
// [C, ceil(W K / 64), 2] float32 (fold_straddle.cuh; else unused, may be
// null).  Returns the cudaError_t of the launches: 0 when the kernel
// (and, for a straddling K, the second launch that adds the partial
// sums) was queued on ``stream``.
extern "C" int bart_fused_eclipse_folded(
    const void* tab, const void* w, const float* T, const float* drp,
    const float* wn, const float* minv, const float* wmu, float* out,
    float* part, int R, int Rp, int L, int W, int Fp, int C, int K, int nmu,
    int powers, int bf16, cudaStream_t stream) {
  if (nmu < 1 || R < 1 || L < 1 || W < 1 || C < 1 || K < 2 ||
      (long long)W * K > Fp)
    return (int)cudaErrorInvalidValue;
  const cudaError_t e =
      bf16 ? launch_quad<__nv_bfloat16>(tab, w, T, drp, wn, minv, wmu, out,
                                        part, R, Rp, L, W, Fp, C, K, nmu,
                                        powers, stream)
           : launch_quad<float>(tab, w, T, drp, wn, minv, wmu, out, part, R,
                                Rp, L, W, Fp, C, K, nmu, powers, stream);
  return (int)e;
}
