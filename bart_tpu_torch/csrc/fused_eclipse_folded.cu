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
// Two kernels.
//
// bfloat16 table (the publication path): the fill on tensor cores,
// exactly.  A bfloat16 table element has 8 significant bits; each
// float32 weight arrives as three bfloat16 parts hi + mid + lo that sum
// to it bit for bit (bart_tpu_torch.rt.fused.split_bf16, made once per
// launch), so every part x element product is exact in float32 and three
// mma.sync.m16n8k16 passes per 16 rows, summed in float32 by the unit,
// give the float32 contraction.  Per layer the product is
// [MTILE_F fine points x Rp rows] x [Rp x CBM chains]: A is the table
// tile, staged [row][fine point] as it lies in memory and transposed by
// ldmatrix; B the weight parts, staged [chain][row].  A block covers
// MTILE_F = 64 fine points x CBM = 32 chains with 8 warps, each a
// 16-point m-tile x two 8-chain n-tiles, so a thread carries
// (ext, tau, S, flux) of 8 (fine point, chain) pairs in registers, fed
// from the accumulator fragments; two blocks fit an SM (128 registers a
// thread, 44 KB of shared memory at R = 27), so one computes while the
// other waits at its barrier.  The table tile and the weights of layer
// l + 3 are in flight (cp.async, a ring of NSTAGE = 4) while layer l is
// computed: one barrier per layer.  The Planck function depends on
// (chain, layer, bin) only: during layer l the block's first threads
// evaluate it for layer l + 1's CBM x MTILE_F / K pairs, one exponential
// each, and leave 0.5 (B_l + B_{l+1}) in shared memory for after the
// next barrier.  The mean over k goes through shared memory at the end
// (a bin's sub-samples sit in different lanes, registers and, for
// K = 32, warps).  blockIdx.x walks the chain blocks, so the blocks
// resident at once share a few table tiles and the table leaves HBM
// once.
//
// float32 table (tests and comparisons only): the float32-pipe kernel,
// a thread per fine point x CPT = 4 chains, a block of TILE_F x 8 chains
// that stages one layer's table slice per step.
//
// Bound on the H100.  Per 512-chain batch at R = 27, L = 100, 1,064 fine
// bins, K = 32: 47 G FMAs of fill (three bfloat16 passes: 0.29 ms at the
// dense bfloat16 peak) and, on the float32 pipes, 12 FMAs and one
// exponential per (chain, layer, fine point): 21 G FMAs (0.62 ms) and
// 1.7 G exponentials (0.42 ms).  Shared-memory traffic from L2: the table
// (184 MB in bf16) once per chain block, 16 x 184 MB = 2.9 GB, and the
// weight parts (9.8 MB) once per tile, 532 x 9.8 MB = 5.2 GB: 8.2 GB per
// launch (11.8 + 1.5 GB in the float32-pipe design).  What binds it is
// the float32 pipes' instruction rate: the accurate expf alone is about
// a dozen instructions (PERF.md has the ablation).  expf and expm1f are
// the accurate library versions (no --use_fast_math).

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include "hopper.cuh"

#define TILE_F 128   // fine points per block
#define TY 2         // float32 kernel: thread rows per block (threadIdx.y)
#define CPT 4        // float32 kernel: chains per thread
#define MAX_NMU 16   // quadrature nodes held in shared memory
#define MTILE_F 64   // bfloat16 kernel: fine points per block
#define CBM 32       // bfloat16 kernel: chains per block
#define NSTAGE 4     // bfloat16 kernel: layers in the shared-memory ring
#define MTHREADS 256 // bfloat16 kernel: threads per block (8 warps)

// Timing aid (ablate_folded.py): -DBART_ABLATE=<bits> builds the bfloat16
// kernel without 1 its global -> shared copies, 2 its tensor-core
// products, 4 its exponentials.  The results are then wrong.
#ifndef BART_ABLATE
#define BART_ABLATE 0
#endif
#if BART_ABLATE & 4
#define BART_EXPF(x) (1.0f + (x))
#else
#define BART_EXPF(x) expf(x)
#endif

namespace {

constexpr int CB = TY * CPT;   // chains per block of the float32 kernel
static_assert(CPT == 4, "the weights are read as one float4 per row");
static_assert(MTILE_F % 32 == 0 && CBM % 16 == 0 &&
                  MTHREADS == 32 * (MTILE_F / 16) * (CBM / 16),
              "the warp tiling of the bfloat16 kernel: a warp per 16 fine "
              "points x 16 chains");

// 2 h c^2 and h c / k from bart_tpu_torch.constants (cgs; the CPU tests
// check these literals against the Python constants)
constexpr float kC1 = 1.1910439340652298e-05f;
constexpr float kC2 = 1.4387686603333911f;
constexpr float kTwoPi = 6.2831853071795865f;
constexpr float kTauClamp = 88.0f;
constexpr unsigned kFullMask = 0xffffffffu;

template <bool POWERS>
__device__ __forceinline__ float smix(float tau, const float* minv,
                                      const float* wmu, int nmu) {
  const float tau_c = fminf(tau, kTauClamp);
  float acc = 0.0f;
  if (POWERS) {
    const float u = expf(-tau_c);
    for (int q = nmu - 1; q >= 0; --q) acc = u * (wmu[q] + acc);
  } else {
    for (int q = 0; q < nmu; ++q) acc = acc + wmu[q] * expf(-tau_c * minv[q]);
  }
  return acc;
}

// ---------------------------------------------------------------------
// float32 table, float32 pipes

template <bool POWERS>
__global__ void __launch_bounds__(TILE_F * TY)
fused_eclipse_folded_f32_kernel(const float* __restrict__ tab,   // [R, L, Fp]
                                const float* __restrict__ wrows, // [C, L, R]
                                const float* __restrict__ T,     // [C, L]
                                const float* __restrict__ drp,   // [C, L]
                                const float* __restrict__ wn,    // [W] centres
                                const float* __restrict__ minv,  // [nmu]
                                const float* __restrict__ wmu,   // [nmu]
                                float* __restrict__ out,         // [C, W]
                                int R, int L, int W, int Fp, int C, int K,
                                int nmu) {
  extern __shared__ float4 smem4[];
  float* tab_s = reinterpret_cast<float*>(smem4);   // [R][TILE_F]
  float* wr_s = tab_s + (size_t)R * TILE_F;         // [TY][R][CPT]
  __shared__ float dr_s[CB];
  __shared__ float minv_s[MAX_NMU], wmu_s[MAX_NMU];

  const int tx = threadIdx.x, ty = threadIdx.y;
  const int tid = ty * TILE_F + tx;
  const int nthreads = TILE_F * TY;
  const int F = W * K;                      // fine points in use
  const int f0 = blockIdx.x * TILE_F;
  const int c0 = blockIdx.y * CB;
  const int f = f0 + tx;
  const int b = f / K;                      // the thread's output bin
  const int kk = tx & (K - 1);              // its sub-sample: lane in group
  const bool live = f < F;                  // whole groups are live or not

  if (tid < nmu) {
    minv_s[tid] = minv[tid];
    wmu_s[tid] = wmu[tid];
  }
  const float wnv = live ? wn[b] : 1.0f;
  const float wn3 = kC1 * (wnv * wnv * wnv);
  const float c2wn = kC2 * wnv;

  float ext_p[CPT], tau[CPT], B_p[CPT], S_p[CPT], flux[CPT], B_grp[CPT];
#pragma unroll
  for (int cc = 0; cc < CPT; ++cc) {
    ext_p[cc] = tau[cc] = B_p[cc] = S_p[cc] = flux[cc] = B_grp[cc] = 0.0f;
  }

  for (int l = 0; l < L; ++l) {
    __syncthreads();  // every thread is done reading the last layer
    for (int i = tid; i < R * TILE_F; i += nthreads) {
      const int r = i / TILE_F, ff = f0 + i % TILE_F;
      tab_s[i] = (ff < F) ? tab[((size_t)r * L + l) * Fp + ff] : 0.0f;
    }
    for (int i = tid; i < CB * R; i += nthreads) {
      const int cb = i / R, r = i % R, c = c0 + cb;
      wr_s[((cb / CPT) * R + r) * CPT + cb % CPT] =
          (c < C) ? wrows[((size_t)c * L + l) * R + r] : 0.0f;
    }
    if (tid < CB) {
      const int c = c0 + tid;
      dr_s[tid] = (c < C) ? drp[(size_t)c * L + l] : 0.0f;
    }
    if ((l & (K - 1)) == 0) {
      // Planck for the next K layers: lane kk of the group takes l + kk
      const int lj = min(l + kk, L - 1);
#pragma unroll
      for (int cc = 0; cc < CPT; ++cc) {
        const int c = c0 + ty * CPT + cc;
        const float Tv = (c < C) ? T[(size_t)c * L + lj] : 1000.0f;
        B_grp[cc] = wn3 / expm1f(c2wn / Tv);
      }
    }
    __syncthreads();

    const float4* wr4 = reinterpret_cast<const float4*>(wr_s) + ty * R;
    float ext[CPT] = {0.0f, 0.0f, 0.0f, 0.0f};
    for (int r = 0; r < R; ++r) {
      const float t = tab_s[r * TILE_F + tx];
      const float4 a = wr4[r];
      ext[0] = fmaf(a.x, t, ext[0]);
      ext[1] = fmaf(a.y, t, ext[1]);
      ext[2] = fmaf(a.z, t, ext[2]);
      ext[3] = fmaf(a.w, t, ext[3]);
    }
#pragma unroll
    for (int cc = 0; cc < CPT; ++cc) {
      const float B = __shfl_sync(kFullMask, B_grp[cc], l & (K - 1), K);
      if (l > 0)
        tau[cc] = tau[cc] + 0.5f * (ext_p[cc] + ext[cc]) * dr_s[ty * CPT + cc];
      const float S = smix<POWERS>(tau[cc], minv_s, wmu_s, nmu);
      if (l > 0) flux[cc] = flux[cc] + 0.5f * (B_p[cc] + B) * (S_p[cc] - S);
      ext_p[cc] = ext[cc];
      B_p[cc] = B;
      S_p[cc] = S;
    }
  }

  const float scale = kTwoPi / (float)K;
#pragma unroll
  for (int cc = 0; cc < CPT; ++cc) {
    float v = flux[cc] + B_p[cc] * S_p[cc];
    for (int o = K >> 1; o > 0; o >>= 1) v += __shfl_xor_sync(kFullMask, v, o);
    const int c = c0 + ty * CPT + cc;
    if (kk == 0 && live && c < C) out[(size_t)c * W + b] = scale * v;
  }
}

template <bool POWERS>
cudaError_t launch_f32(const float* tab, const float* wrows, const float* T,
                       const float* drp, const float* wn, const float* minv,
                       const float* wmu, float* out, int R, int L, int W,
                       int Fp, int C, int K, int nmu, cudaStream_t stream) {
  if ((C + CB - 1) / CB > 65535) return cudaErrorInvalidValue;
  const size_t smem = sizeof(float) * ((size_t)R * TILE_F + (size_t)CB * R);
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        fused_eclipse_folded_f32_kernel<POWERS>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return e;
  }
  const dim3 block(TILE_F, TY);
  const dim3 grid((W * K + TILE_F - 1) / TILE_F, (C + CB - 1) / CB);
  fused_eclipse_folded_f32_kernel<POWERS><<<grid, block, smem, stream>>>(
      tab, wrows, T, drp, wn, minv, wmu, out, R, L, W, Fp, C, K, nmu);
  return cudaGetLastError();
}

// ---------------------------------------------------------------------
// bfloat16 table, the fill on tensor cores

// Shared memory of the bfloat16 kernel, in bytes, for Rp rows (a
// multiple of 16) and K sub-samples: NSTAGE stages of the table tile
// [Rp][MTILE_F + 8] and the weight parts [3][CBM][Rp + 8] in bfloat16 (the
// 8 elements of padding spread the 16-byte rows that one ldmatrix reads
// over all banks), then the Planck means, two buffers [MTILE_F / K][CBM]
// of float32.  The epilogue reuses the ring for [CBM][MTILE_F + 4] sums.
__host__ __device__ constexpr size_t mma_stage_bytes(int Rp) {
  return 2 * ((size_t)Rp * (MTILE_F + 8) + 3 * (size_t)CBM * (Rp + 8));
}
__host__ __device__ constexpr size_t mma_smem_bytes(int Rp, int K) {
  return NSTAGE * mma_stage_bytes(Rp) + 2 * 4 * (size_t)(MTILE_F / K) * CBM;
}
static_assert(NSTAGE * mma_stage_bytes(16) >= 4 * CBM * (MTILE_F + 4),
              "the epilogue's sums must fit the ring");

// NMU > 0: the quadrature has exactly NMU nodes and its loops unroll;
// NMU == 0: any 1..MAX_NMU nodes.
template <bool POWERS, int NMU>
__global__ void __launch_bounds__(MTHREADS, 512 / MTHREADS)
fused_eclipse_folded_mma_kernel(
    const __nv_bfloat16* __restrict__ tab,     // [R, L, Fp]
    const __nv_bfloat16* __restrict__ wparts,  // [3, C, L, Rp]: lo, mid, hi
    const float* __restrict__ T,               // [C, L]
    const float* __restrict__ drp,             // [C, L]
    const float* __restrict__ wn,              // [W] bin centres
    const float* __restrict__ minv,            // [nmu]
    const float* __restrict__ wmu,             // [nmu]
    float* __restrict__ out,                   // [C, W]
    int R, int Rp, int L, int W, int Fp, int C, int K, int nmu_any) {
  const int nmu = NMU ? NMU : nmu_any;
  constexpr int TS = MTILE_F + 8;     // row stride of the table tile
  constexpr int VS = MTILE_F + 4;     // row stride of the epilogue's sums
  constexpr int PP = CBM * (MTILE_F / 2) / MTHREADS;  // Planck pairs a thread
  extern __shared__ float4 smem4[];
  unsigned char* ring = reinterpret_cast<unsigned char*>(smem4);
  const size_t stage_bytes = mma_stage_bytes(Rp);
  float* bmid_s = reinterpret_cast<float*>(ring + NSTAGE * stage_bytes);
  __shared__ float minv_s[MAX_NMU], wmu_s[MAX_NMU];

  const int WS = Rp + 8;             // row stride of the weight parts
  const int KS = Rp / 16;            // k-steps of the fill
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

  // This thread's first two weight copies of a stage (task i = tid + j
  // MTHREADS is 16 bytes q of part p, chain cc), reckoned once: the
  // divisions by a run-time row count stay out of the layer loop.
  const int rq = Rp / 8, nwtask = 3 * CBM * rq;
  int w_dst[2], w_src[2];
#pragma unroll
  for (int j = 0; j < 2; ++j) {
    const int i = tid + j * MTHREADS;
    const int q = i % rq, cc = (i / rq) % CBM, p = i / (rq * CBM);
    const int c = c0 + cc;
    w_dst[j] = (p * CBM + cc) * WS + 8 * q;
    // -1: nothing to copy (beyond the tasks); -2: zero-fill (beyond C)
    w_src[j] = i >= nwtask ? -1
               : c >= C    ? -2
                           : (int)(p * CLR + (size_t)c * L * Rp + 8 * q);
  }

  // stage ``l`` of the ring: the table tile tab[:, l, f0 : f0 + MTILE_F]
  // (rows R..Rp-1 and columns beyond Fp zero-filled) and the three weight
  // parts of the block's chains (chains beyond C zero-filled)
  auto copy_stage = [&](int l) {
    if (BART_ABLATE & 1) return;
    unsigned char* st = ring + (size_t)(l % NSTAGE) * stage_bytes;
    __nv_bfloat16* tb = reinterpret_cast<__nv_bfloat16*>(st);
    __nv_bfloat16* wb = tb + (size_t)Rp * TS;
    for (int i = tid; i < Rp * (MTILE_F / 8); i += MTHREADS) {
      const int r = i / (MTILE_F / 8), q = i % (MTILE_F / 8);
      const int f = f0 + 8 * q;
      const bool ok = r < R && f < Fp;
      cp_async16(tb + r * TS + 8 * q,
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
      cp_async16(wb + (p * CBM + cc) * WS + 8 * q,
                 ok ? wparts + p * CLR + ((size_t)c * L + l) * Rp + 8 * q
                    : wparts,
                 ok);
    }
  };

  // The Planck pairs (chain c0 + p % CBM, bin f0 / K + p / CBM), p <
  // CBM nb: thread tid takes the pairs tid + j MTHREADS, so with few
  // pairs (K = 32: CBM 4) only the first warps spend instructions on
  // them.  pl_T holds T of the layer whose B comes next.
  const int npair = CBM * nb;
  float pl_c1[PP], pl_c2[PP], pl_prev[PP], pl_T[PP];
  int pl_p[PP];
#pragma unroll
  for (int j = 0; j < PP; ++j) {
    const int p = tid + j * MTHREADS;
    pl_p[j] = p < npair ? p : -1;
    const int bin = f0 / K + p / CBM, c = c0 + p % CBM;
    const float wnv = (pl_p[j] >= 0 && bin < W) ? wn[bin] : 1.0f;
    pl_c1[j] = kC1 * (wnv * wnv * wnv);
    pl_c2[j] = kC2 * wnv;
    const float T0 = (pl_p[j] >= 0 && c < C) ? T[(size_t)c * L] : 1000.0f;
    pl_prev[j] = pl_c1[j] / expm1f(pl_c2[j] / T0);          // B of layer 0
    pl_T[j] = (pl_p[j] >= 0 && c < C && L > 1) ? T[(size_t)c * L + 1]
                                               : 1000.0f;
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
        if (pl_p[j] >= 0) {
          const float B = pl_c1[j] / expm1f(pl_c2[j] / pl_T[j]);
          bn[pl_p[j]] = 0.5f * (pl_prev[j] + B);
          pl_prev[j] = B;
          const int c = c0 + pl_p[j] % CBM;
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

    // ---- ext of layer l: three bfloat16 passes per 16 rows -------------
    const unsigned char* st = ring + (size_t)(l % NSTAGE) * stage_bytes;
    const __nv_bfloat16* tb = reinterpret_cast<const __nv_bfloat16*>(st);
    const __nv_bfloat16* wb = tb + (size_t)Rp * TS;
    float acc[2][4];
#pragma unroll
    for (int nt = 0; nt < 2; ++nt)
#pragma unroll
      for (int i = 0; i < 4; ++i) acc[nt][i] = 0.0f;
    for (int ks = 0; ks < ((BART_ABLATE & 2) ? 0 : KS); ++ks) {
      uint32_t a[4];
      ldmatrix_x4_trans(a, tb + (16 * ks + (lane & 7) + ((lane >> 4) << 3)) * TS
                               + fw + (((lane >> 3) & 1) << 3));
#pragma unroll
      for (int nt = 0; nt < 2; ++nt) {
#pragma unroll
        for (int p = 0; p < 3; ++p) {        // lo, mid, hi: small parts first
          uint32_t b[2];
          ldmatrix_x2(b, wb + (p * CBM + ch + 8 * nt + (lane & 7)) * WS
                             + 16 * ks + (((lane >> 3) & 1) << 3));
          mma_bf16(acc[nt], a, b);
        }
      }
    }

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
    if (pl_p[j] >= 0) bmid_s[pl_p[j]] = pl_prev[j];
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

template <bool POWERS, int NMU>
cudaError_t launch_mma(const void* tab, const void* wparts, const float* T,
                       const float* drp, const float* wn, const float* minv,
                       const float* wmu, float* out, int R, int Rp, int L,
                       int W, int Fp, int C, int K, int nmu,
                       cudaStream_t stream) {
  const int ntile = (W * K + MTILE_F - 1) / MTILE_F;
  if (Rp % 16 != 0 || Rp < R || Fp % 8 != 0 || ntile > 65535 ||
      3ll * C * L * Rp >= (1ll << 31))
    return cudaErrorInvalidValue;
  const size_t smem = mma_smem_bytes(Rp, K);
  const cudaError_t e = cudaFuncSetAttribute(
      fused_eclipse_folded_mma_kernel<POWERS, NMU>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e != cudaSuccess) return e;
  const dim3 grid((C + CBM - 1) / CBM, ntile);
  fused_eclipse_folded_mma_kernel<POWERS, NMU>
      <<<grid, MTHREADS, smem, stream>>>(
          static_cast<const __nv_bfloat16*>(tab),
          static_cast<const __nv_bfloat16*>(wparts), T, drp, wn, minv, wmu,
          out, R, Rp, L, W, Fp, C, K, nmu);
  return cudaGetLastError();
}

}  // namespace

// Plain C entry point (bound with ctypes).  tab [R, L, Fp] is the
// bin-major fine table whose first W K columns are in use; K is a power
// of two in 2..32.  float32 table (bf16 == 0): wrows [C, L, R] float32,
// wparts unused.  bfloat16 table: wparts [3, C, L, Rp], the weights'
// three bfloat16 parts, smallest first, zero-padded to Rp rows (R
// rounded up to 16), and Fp a multiple of 8; wrows unused.  Returns the
// cudaError_t of the launch: 0 when the kernel was queued on ``stream``.
extern "C" int bart_fused_eclipse_folded(
    const void* tab, const float* wrows, const void* wparts, const float* T,
    const float* drp, const float* wn, const float* minv, const float* wmu,
    float* out, int R, int Rp, int L, int W, int Fp, int C, int K, int nmu,
    int powers, int bf16, cudaStream_t stream) {
  if (nmu < 1 || nmu > MAX_NMU || R < 1 || L < 1 || W < 1 || C < 1 || K < 2 ||
      K > 32 || (K & (K - 1)) != 0 || (long long)W * K > Fp)
    return (int)cudaErrorInvalidValue;
  cudaError_t e;
  if (bf16) {
    // the quadratures in use get unrolled instances: expsum's 8 powers,
    // raygrid's 5 angles
#define BART_MMA(POWERS, NMU)                                                \
  launch_mma<POWERS, NMU>(tab, wparts, T, drp, wn, minv, wmu, out, R, Rp, L, \
                          W, Fp, C, K, nmu, stream)
    e = powers ? (nmu == 8 ? BART_MMA(true, 8) : BART_MMA(true, 0))
               : (nmu == 5 ? BART_MMA(false, 5) : BART_MMA(false, 0));
#undef BART_MMA
  } else {
    const float* tf = static_cast<const float*>(tab);
    e = powers ? launch_f32<true>(tf, wrows, T, drp, wn, minv, wmu, out, R, L,
                                  W, Fp, C, K, nmu, stream)
               : launch_f32<false>(tf, wrows, T, drp, wn, minv, wmu, out, R,
                                   L, W, Fp, C, K, nmu, stream);
  }
  return (int)e;
}
