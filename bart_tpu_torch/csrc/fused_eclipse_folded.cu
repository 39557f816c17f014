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
// that the plain version and the TPU kernel form.
//
// Design: one kernel, a template on the table's type, the fill on
// tensor cores.  Per layer the fill is the product [MTILE_F fine points
// x Rp rows] x [Rp x CBM chains]: A the table tile, staged [row][fine
// point] as it lies in memory; B the weights, staged [chain][row].
//
//  - bfloat16 table (foldtable16 = True): exactly.  A table element has
//    8 significant bits; each float32 weight arrives as three bfloat16
//    parts hi + mid + lo that sum to it bit for bit
//    (bart_tpu_torch.rt.fused.split_bf16, made once per launch), so every
//    part x element product is exact in float32 and three
//    mma.sync.m16n8k16 passes per 16 rows, summed in float32 by the unit,
//    give the float32 contraction.  ldmatrix transposes A.
//  - float32 table (the reference's default, foldtable16 = False): in
//    3xTF32.  Table element and weight are each split in registers into
//    big = tf32(x) and small = x - big (hopper.cuh: split_tf32), and
//    small x big + big x small (one accumulator) and big x big (another)
//    on mma.sync.m16n8k8 per 8 rows keep every product to 2^-21 of the
//    float32 one; one pass would be 2^-11 off.  ldmatrix moves 16-bit
//    elements, so A is read with plain 32-bit loads: the tile's row
//    stride of MTILE_F + 8 words (8 mod 32) puts lane (g, t) on bank
//    8 t + g, the weights' stride of Rp + 4 on bank 4 g + t (mod 32): no
//    conflict.  The weights come as float32 and are split in registers:
//    leaving their split out saves 0.4% of a launch (ablation bit 8),
//    less than a split made once per launch could save, which would
//    double their bytes in every stage.
//
// A block covers MTILE_F = 64 fine points x CBM = 32 chains with 8 warps,
// each a 16-point m-tile x two 8-chain n-tiles, so a thread carries (ext,
// tau, S, flux) of 8 (fine point, chain) pairs in registers, fed from the
// accumulator fragments; two blocks fit an SM (128 registers a thread, no
// spills; 49.7 KB of shared memory at R = 27 in bfloat16, 55.8 KB in
// float32, 82.4 KB at R = 41), so one computes while the other waits at
// its barrier.  The table tile and the weights of layer l + 3 are in
// flight (cp.async, a ring of NSTAGE = 4) while layer l is computed: one
// barrier per layer.  The Planck function depends on (chain, layer, bin)
// only: during layer l the block's first threads evaluate it for layer
// l + 1's CBM x MTILE_F / K pairs, one exponential each, and leave
// 0.5 (B_l + B_{l+1}) in shared memory for after the next barrier.  The
// mean over k goes through shared memory at the end (a bin's sub-samples
// sit in different lanes, registers and, for K = 32, warps).  blockIdx.x
// walks the chain blocks, so the blocks resident at once share a few
// table tiles and the table leaves HBM once.
//
// Bound on the H100.  Per 512-chain batch at R = 27, L = 100, 1,064 fine
// bins, K = 32: 47 G FMAs of fill (three passes: 0.29 ms at the dense
// bfloat16 peak, 0.57 ms at the dense TF32 peak) and, on the float32
// pipes, 12 FMAs and one exponential per (chain, layer, fine point): 21 G
// FMAs (0.62 ms) and 1.7 G exponentials (0.42 ms).  Shared-memory traffic
// from L2: the table once per chain block, 16 x 184 MB = 2.9 GB in
// bfloat16 (16 x 368 MB = 5.9 GB in float32), and the weights once per
// tile: 532 x 9.8 MB of bfloat16 parts = 5.2 GB (532 x 6.6 MB of float32 =
// 3.5 GB): 8.2 GB per launch (9.4 GB on a float32 table).  What binds the
// bfloat16 instance is the float32 pipes' instruction rate: the accurate
// expf alone is about a dozen instructions (PERF.md has the ablation); the
// float32 instance adds the splits of the fill's operands, three
// instructions each.  expf and expm1f are the accurate library versions
// (no --use_fast_math).  Measured on an NVIDIA H100 80GB HBM3 at 700 W,
// 1,125 fine bins x 32 (chip_smoke.py --kernels): bfloat16 6.38 ms
// (expsum) and 8.63 (raygrid); float32 7.76 and 10.13 (PERF.md has the
// ablations).

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include "hopper.cuh"

#define MAX_NMU 16   // quadrature nodes held in shared memory
#define MTILE_F 64   // fine points per block
#define CBM 32       // chains per block
#define NSTAGE 4     // layers in the shared-memory ring
#define MTHREADS 256 // threads per block (8 warps)

// Timing aid (ablate_folded.py): -DBART_ABLATE=<bits> builds the kernel
// without 1 its global -> shared copies, 2 its tensor-core products, 4 its
// exponentials; 8 leaves the weights of a float32 table unsplit (the
// word as its big part, no small part: what a split made once per launch
// would save at most).  The results are then wrong.
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

// Shared memory, in bytes, for Rp rows, K sub-samples and a table of eb
// bytes an element whose weights come in np parts of that type
// (bfloat16: eb = 2, np = 3, Rp a multiple of 16; float32: eb = 4,
// np = 1, Rp a multiple of 8): NSTAGE stages of the table tile
// [Rp][MTILE_F + 8] and the weights [np][CBM][Rp + 16 / eb] (the
// padding spreads the rows that one ldmatrix or one fragment load reads
// over all banks), then the Planck means, two buffers [MTILE_F / K][CBM]
// of float32.  The epilogue reuses the ring for [CBM][MTILE_F + 4] sums.
__host__ __device__ constexpr size_t mma_stage_bytes(int Rp, int eb, int np) {
  return eb * ((size_t)Rp * (MTILE_F + 8) + (size_t)np * CBM * (Rp + 16 / eb));
}
__host__ __device__ constexpr size_t mma_smem_bytes(int Rp, int K, int eb,
                                                    int np) {
  return NSTAGE * mma_stage_bytes(Rp, eb, np) +
         2 * 4 * (size_t)(MTILE_F / K) * CBM;
}
static_assert(NSTAGE * mma_stage_bytes(16, 2, 3) >= 4 * CBM * (MTILE_F + 4) &&
                  NSTAGE * mma_stage_bytes(8, 4, 1) >= 4 * CBM * (MTILE_F + 4),
              "the epilogue's sums must fit the ring");

// TabT: __nv_bfloat16 or float; the weights are staged in the same type
// (bfloat16: split_bf16's three parts, lo, mid, hi; float32: as given).
// NMU > 0: the quadrature has exactly NMU nodes and its loops unroll;
// NMU == 0: any 1..MAX_NMU nodes.
template <typename TabT, bool POWERS, int NMU>
__global__ void __launch_bounds__(MTHREADS, 512 / MTHREADS)
fused_eclipse_folded_mma_kernel(
    const TabT* __restrict__ tab,      // [R, L, Fp]
    const TabT* __restrict__ wparts,   // [NP, C, L, Rp]
    const float* __restrict__ T,       // [C, L]
    const float* __restrict__ drp,     // [C, L]
    const float* __restrict__ wn,      // [W] bin centres
    const float* __restrict__ minv,    // [nmu]
    const float* __restrict__ wmu,     // [nmu]
    float* __restrict__ out,           // [C, W]
    int R, int Rp, int L, int W, int Fp, int C, int K, int nmu_any) {
  constexpr bool kBf16 = sizeof(TabT) == 2;
  constexpr int EPC = 16 / sizeof(TabT);  // elements per 16-byte copy
  constexpr int NP = kBf16 ? 3 : 1;       // parts of the weights
  constexpr int UR = kBf16 ? 16 : 8;      // rows of one product (k-step)
  const int nmu = NMU ? NMU : nmu_any;
  constexpr int TS = MTILE_F + 8;     // row stride of the table tile
  constexpr int VS = MTILE_F + 4;     // row stride of the epilogue's sums
  constexpr int PP = CBM * (MTILE_F / 2) / MTHREADS;  // Planck pairs a thread
  extern __shared__ float4 smem4[];
  unsigned char* ring = reinterpret_cast<unsigned char*>(smem4);
  const size_t stage_bytes = mma_stage_bytes(Rp, sizeof(TabT), NP);
  float* bmid_s = reinterpret_cast<float*>(ring + NSTAGE * stage_bytes);
  __shared__ float minv_s[MAX_NMU], wmu_s[MAX_NMU], wn_s[MTILE_F / 2];

  const int WS = Rp + EPC;           // row stride of the weights
  const int KS = Rp / UR;            // k-steps of the fill
  const int nb = MTILE_F / K;         // output bins of the block
  const int tid = threadIdx.x;
  const int lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, t = lane & 3;
  const int fw = (warp % (MTILE_F / 16)) * 16;   // the warp's fine points
  const int ch = (warp / (MTILE_F / 16)) * 16;   // and chains, 16 of each
  const int F = W * K;
  const int c0 = blockIdx.x * CBM;
  const int f0 = blockIdx.y * MTILE_F;
  const size_t CLR = (size_t)C * L * Rp;

  if (tid < nmu) {
    minv_s[tid] = minv[tid];
    wmu_s[tid] = wmu[tid];
  }
  if (tid < nb) wn_s[tid] = f0 / K + tid < W ? wn[f0 / K + tid] : 1.0f;

  // This thread's first two weight copies of a stage (task i = tid + j
  // MTHREADS is 16 bytes q of part p, chain cc), reckoned once: the
  // divisions by a run-time row count stay out of the layer loop.
  const int rq = Rp / EPC, nwtask = NP * CBM * rq;
  int w_dst[2], w_src[2];
#pragma unroll
  for (int j = 0; j < 2; ++j) {
    const int i = tid + j * MTHREADS;
    const int q = i % rq, cc = (i / rq) % CBM, p = i / (rq * CBM);
    const int c = c0 + cc;
    w_dst[j] = (p * CBM + cc) * WS + EPC * q;
    // -1: nothing to copy (beyond the tasks); -2: zero-fill (beyond C)
    w_src[j] = i >= nwtask ? -1
               : c >= C    ? -2
                           : (int)(p * CLR + (size_t)c * L * Rp + EPC * q);
  }

  // stage ``l`` of the ring: the table tile tab[:, l, f0 : f0 + MTILE_F]
  // (rows R..Rp-1 and columns beyond Fp zero-filled) and the weight
  // parts of the block's chains (chains beyond C zero-filled)
  auto copy_stage = [&](int l) {
    if (BART_ABLATE & 1) return;
    unsigned char* st = ring + (size_t)(l % NSTAGE) * stage_bytes;
    TabT* tb = reinterpret_cast<TabT*>(st);
    TabT* wb = tb + (size_t)Rp * TS;
    for (int i = tid; i < Rp * (MTILE_F / EPC); i += MTHREADS) {
      const int r = i / (MTILE_F / EPC), q = i % (MTILE_F / EPC);
      const int f = f0 + EPC * q;
      const bool ok = r < R && f < Fp;
      cp_async16(tb + r * TS + EPC * q,
                 ok ? tab + ((size_t)r * L + l) * Fp + f : tab, ok);
    }
#pragma unroll
    for (int j = 0; j < 2; ++j) {
      if (w_src[j] != -1)
        cp_async16(wb + w_dst[j],
                   wparts + (w_src[j] < 0 ? 0 : w_src[j] + l * Rp),
                   w_src[j] >= 0);
    }
    for (int i = tid + 2 * MTHREADS; i < nwtask; i += MTHREADS) {
      const int q = i % rq, cc = (i / rq) % CBM, p = i / (rq * CBM);
      const int c = c0 + cc;
      const bool ok = c < C;
      cp_async16(wb + (p * CBM + cc) * WS + EPC * q,
                 ok ? wparts + p * CLR + ((size_t)c * L + l) * Rp + EPC * q
                    : wparts,
                 ok);
    }
  };

  // The Planck pairs (chain c0 + p % CBM, bin f0 / K + p / CBM), p <
  // CBM nb: thread tid takes the pairs p = tid + j MTHREADS, so with few
  // pairs (K = 32: CBM 4) only the first warps spend instructions on
  // them.  pl_T holds T of the layer whose B comes next; the bins'
  // wavenumbers are read from wn_s in the layer loop, not held in
  // registers, which the float32 table's fill needs.
  const int npair = CBM * nb;
  float pl_prev[PP], pl_T[PP];
#pragma unroll
  for (int j = 0; j < PP; ++j) {
    const int p = tid + j * MTHREADS;
    const int bin = f0 / K + p / CBM, c = c0 + p % CBM;
    const float wnv = (p < npair && bin < W) ? wn[bin] : 1.0f;
    const float T0 = (p < npair && c < C) ? T[(size_t)c * L] : 1000.0f;
    pl_prev[j] = kC1 * (wnv * wnv * wnv) / expm1f(kC2 * wnv / T0);  // layer 0
    pl_T[j] = (p < npair && c < C && L > 1) ? T[(size_t)c * L + 1] : 1000.0f;
  }

  // this thread's 8 (fine point, chain) pairs: e = 4 nt + i is fine point
  // fw + g + 8 (i / 2), chain ch + 8 nt + 2 t + (i & 1)
  float ext_p[8], tau[8], S_p[8], flux[8];
#pragma unroll
  for (int e = 0; e < 8; ++e) ext_p[e] = tau[e] = S_p[e] = flux[e] = 0.0f;
  const int bin_lo = (fw + g) / K, bin_hi = (fw + g + 8) / K;
  // half the layer step of the thread's 4 chains, a layer ahead
  float hdr[4], hdr_next[4];
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    const int c = c0 + ch + 8 * (j >> 1) + 2 * t + (j & 1);
    hdr[j] = 0.0f;
    hdr_next[j] = (c < C) ? 0.5f * drp[(size_t)c * L] : 0.0f;
  }

  for (int l = 0; l < NSTAGE - 1; ++l) {
    if (l < L) copy_stage(l);
    cp_async_commit();
  }

  for (int l = 0; l < L; ++l) {
    const float* bm = bmid_s + (l & 1) * npair;   // 0.5 (B_{l-1} + B_l)
    cp_async_wait<NSTAGE - 2>();
    __syncthreads();  // stage l and its Planck means are there; every
                      // thread is done with stage l - 1
    if (l + NSTAGE - 1 < L) copy_stage(l + NSTAGE - 1);
    cp_async_commit();

    // the Planck means of layer l + 1, for after the next barrier
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

#pragma unroll
    for (int j = 0; j < 4; ++j) {
      hdr[j] = hdr_next[j];
      const int c = c0 + ch + 8 * (j >> 1) + 2 * t + (j & 1);
      if (c < C && l + 1 < L) hdr_next[j] = 0.5f * drp[(size_t)c * L + l + 1];
    }

    // ---- ext of layer l: per k-step three bfloat16 passes (the weight
    // parts, smallest first, into acc) or three TF32 ones (the two small
    // products into acc, the big one into accb) ---------------------------
    const unsigned char* st = ring + (size_t)(l % NSTAGE) * stage_bytes;
    const TabT* tb = reinterpret_cast<const TabT*>(st);
    const TabT* wb = tb + (size_t)Rp * TS;
    float acc[2][4], accb[2][4];
#pragma unroll
    for (int nt = 0; nt < 2; ++nt)
#pragma unroll
      for (int i = 0; i < 4; ++i) acc[nt][i] = accb[nt][i] = 0.0f;
    for (int ks = 0; ks < ((BART_ABLATE & 2) ? 0 : KS); ++ks) {
      if constexpr (kBf16) {
        uint32_t a[4];
        ldmatrix_x4_trans(a, tb + (16 * ks + (lane & 7) + ((lane >> 4) << 3))
                                      * TS
                                 + fw + (((lane >> 3) & 1) << 3));
#pragma unroll
        for (int nt = 0; nt < 2; ++nt) {
#pragma unroll
          for (int p = 0; p < 3; ++p) {      // lo, mid, hi: small parts first
            uint32_t b[2];
            ldmatrix_x2(b, wb + (p * CBM + ch + 8 * nt + (lane & 7)) * WS
                               + 16 * ks + (((lane >> 3) & 1) << 3));
            mma_bf16(acc[nt], a, b);
          }
        }
      } else {
        // A: (fine point fw + g (+ 8), row 8 ks + t (+ 4))
        const TabT* ta = tb + (8 * ks + t) * TS + fw + g;
        uint32_t ab[4], as[4];
        split_tf32(ta[0], ab[0], as[0]);
        split_tf32(ta[8], ab[1], as[1]);
        split_tf32(ta[4 * TS], ab[2], as[2]);
        split_tf32(ta[4 * TS + 8], ab[3], as[3]);
#pragma unroll
        for (int nt = 0; nt < 2; ++nt) {
          // B: (row 8 ks + t (+ 4), chain ch + 8 nt + g)
          const TabT* wa = wb + (ch + 8 * nt + g) * WS + 8 * ks + t;
          uint32_t bb[2], bs[2];
#if BART_ABLATE & 8
          bb[0] = __float_as_uint(wa[0]);
          bb[1] = __float_as_uint(wa[4]);
          bs[0] = bs[1] = 0u;
#else
          split_tf32(wa[0], bb[0], bs[0]);
          split_tf32(wa[4], bb[1], bs[1]);
#endif
          mma_tf32(acc[nt], as, bb);
          mma_tf32(acc[nt], ab, bs);
          mma_tf32(accb[nt], ab, bb);
        }
      }
    }
    // ext of pair e = 4 nt + i; float32 table: the small products first
#pragma unroll
    for (int nt = 0; nt < 2; ++nt)
#pragma unroll
      for (int i = 0; i < 4; ++i)
        if (!kBf16) acc[nt][i] = acc[nt][i] + accb[nt][i];

    // ---- recurrence, quadrature and flux on the accumulator fragments --
    float S[8];
    if (l > 0) {
#pragma unroll
      for (int e = 0; e < 8; ++e) {
        const float ext = acc[e >> 2][e & 3];
        tau[e] = tau[e] + (ext_p[e] + ext) * hdr[2 * (e >> 2) + (e & 1)];
        ext_p[e] = ext;
      }
    } else {
#pragma unroll
      for (int e = 0; e < 8; ++e) ext_p[e] = acc[e >> 2][e & 3];
    }
    if (POWERS) {
      float u[8];
#pragma unroll
      for (int e = 0; e < 8; ++e) {
        u[e] = BART_EXPF(-fminf(tau[e], kTauClamp));
        S[e] = wmu_s[nmu - 1];
      }
#pragma unroll
      for (int q = nmu - 2; q >= 0; --q) {
        const float aq = wmu_s[q];
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
        const float aq = wmu_s[q], mq = minv_s[q];
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
  }

  // ---- close with B_{L-1} S_{L-1}, then the mean over k ----------------
  cp_async_wait<0>();
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
    v_s[cc * VS + fw + g + 8 * ((e >> 1) & 1)] =
        flux[e] + bmid_s[bin * CBM + cc] * S_p[e];
  }
  __syncthreads();
  const float scale = kTwoPi / (float)K;
  for (int i = tid; i < CBM * MTILE_F; i += MTHREADS) {
    const int cc = i / MTILE_F, fl = i % MTILE_F;
    float v = v_s[cc * VS + fl];
    for (int o = K >> 1; o > 0; o >>= 1) v += __shfl_xor_sync(kFullMask, v, o);
    const int c = c0 + cc, f = f0 + fl;
    if ((fl & (K - 1)) == 0 && f < F && c < C)
      out[(size_t)c * W + f / K] = scale * v;
  }
}

template <typename TabT, bool POWERS, int NMU>
cudaError_t launch_mma(const void* tab, const void* wparts, const float* T,
                       const float* drp, const float* wn, const float* minv,
                       const float* wmu, float* out, int R, int Rp, int L,
                       int W, int Fp, int C, int K, int nmu,
                       cudaStream_t stream) {
  constexpr bool kBf16 = sizeof(TabT) == 2;
  constexpr int NP = kBf16 ? 3 : 1;
  const int ntile = (W * K + MTILE_F - 1) / MTILE_F;
  if (Rp % (kBf16 ? 16 : 8) != 0 || Rp < R || Fp % 8 != 0 ||
      ntile > 65535 || (long long)NP * C * L * Rp >= (1ll << 31))
    return cudaErrorInvalidValue;
  const size_t smem = mma_smem_bytes(Rp, K, sizeof(TabT), NP);
  const cudaError_t e = cudaFuncSetAttribute(
      fused_eclipse_folded_mma_kernel<TabT, POWERS, NMU>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e != cudaSuccess) return e;
  const dim3 grid((C + CBM - 1) / CBM, ntile);
  fused_eclipse_folded_mma_kernel<TabT, POWERS, NMU>
      <<<grid, MTHREADS, smem, stream>>>(
          static_cast<const TabT*>(tab), static_cast<const TabT*>(wparts), T,
          drp, wn, minv, wmu, out, R, Rp, L, W, Fp, C, K, nmu);
  return cudaGetLastError();
}

// the quadratures in use get unrolled instances: expsum's 8 powers,
// raygrid's 5 angles
template <typename TabT>
cudaError_t launch_quad(const void* tab, const void* wparts, const float* T,
                        const float* drp, const float* wn, const float* minv,
                        const float* wmu, float* out, int R, int Rp, int L,
                        int W, int Fp, int C, int K, int nmu, int powers,
                        cudaStream_t stream) {
#define BART_MMA(POWERS, NMU)                                               \
  launch_mma<TabT, POWERS, NMU>(tab, wparts, T, drp, wn, minv, wmu, out, R, \
                                Rp, L, W, Fp, C, K, nmu, stream)
  return powers ? (nmu == 8 ? BART_MMA(true, 8) : BART_MMA(true, 0))
                : (nmu == 5 ? BART_MMA(false, 5) : BART_MMA(false, 0));
#undef BART_MMA
}

}  // namespace

// Plain C entry point (bound with ctypes).  tab [R, L, Fp] is the
// bin-major fine table whose first W K columns are in use, Fp a multiple
// of 8; K is a power of two in 2..32.  The weights w as the kernel reads
// them, zero-padded to Rp rows: for a bfloat16 table (bf16 != 0) the
// three bfloat16 parts [3, C, L, Rp], smallest first, Rp = R rounded up
// to 16; for a float32 table [C, L, Rp] float32, Rp = R rounded up to 8.
// Returns the cudaError_t of the launch: 0 when the kernel was queued on
// ``stream``.
extern "C" int bart_fused_eclipse_folded(
    const void* tab, const void* w, const float* T, const float* drp,
    const float* wn, const float* minv, const float* wmu, float* out, int R,
    int Rp, int L, int W, int Fp, int C, int K, int nmu, int powers,
    int bf16, cudaStream_t stream) {
  if (nmu < 1 || nmu > MAX_NMU || R < 1 || L < 1 || W < 1 || C < 1 || K < 2 ||
      K > 32 || (K & (K - 1)) != 0 || (long long)W * K > Fp)
    return (int)cudaErrorInvalidValue;
  const cudaError_t e =
      bf16 ? launch_quad<__nv_bfloat16>(tab, w, T, drp, wn, minv, wmu, out, R,
                                        Rp, L, W, Fp, C, K, nmu, powers,
                                        stream)
           : launch_quad<float>(tab, w, T, drp, wn, minv, wmu, out, R, Rp, L,
                                W, Fp, C, K, nmu, powers, stream);
  return (int)e;
}
