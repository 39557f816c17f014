// Fused eclipse emergent flux, K = 1, for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel bart_tpu/rt/fused.py:_kernel, which
// _pallas_batch dispatches for fused_eclipse.  Same math as the plain
// torch version bart_tpu_torch/rt/fused.py:eclipse_plain: for every
// (chain c, wavenumber w), walking the layers l = 0 .. L-1,
//
//   ext_l = sum_r wrows[c, l, r] tab[r, l, w]
//   tau_l = tau_{l-1} + 0.5 (ext_{l-1} + ext_l) drp[c, l]
//   B_l   = C1 wn^3 / expm1(C2 wn / T[c, l])
//   S_l   = sum_q wmu_q exp(-min(tau_l, 88) minv_q)    (raygrid)
//         | Horner sum_q wmu_q u^(q+1), u = exp(-min(tau_l, 88)) (powers)
//   F    += 0.5 (B_{l-1} + B_l) (S_{l-1} - S_l)
//
// and out[c, w] = 2 pi (F + B_{L-1} S_{L-1}).
//
// Design.  The contraction runs on tensor cores in 3xTF32: the table
// and the weights are float32 (this is bart_tpu's Precision.HIGHEST
// path, not the bfloat16 publication table), so each operand is split in
// registers into big = tf32(x) and small = x - big (hopper.cuh:
// split_tf32; bart_tpu_torch.rt.fused.split_tf32 states the rule) and
// small x big + big x small + big x big on mma.sync.m16n8k8 keeps every
// product to 2^-21 of the float32 one; the sums are float32.  One pass
// (plain TF32) would be 2^-11 off, beyond every tolerance; the table's
// bytes stay as they are.  Per layer the product is [TILE_W wavenumbers
// x Rp rows] x [Rp x CB chains]: A is the table tile, staged
// [row][wavenumber] as it lies in memory with a row stride of TILE_W + 8
// words, so that the fragment's plain loads (lane (g, t) reads row t,
// column g) fall on bank 8 t + g: no conflict; B the weights, staged
// [chain][row] with a stride of Rp + 4 (bank 4 g + t).  A block covers
// TILE_W = 64 wavenumbers x CB = 32 chains with 8 warps, each a
// 16-wavenumber m-tile x two 8-chain n-tiles, so a thread carries
// (ext, tau, B, S, flux) of 8 (wavenumber, chain) pairs in registers,
// fed from the accumulator fragments; two blocks fit an SM (128
// registers a thread, 55 KB of shared memory at R = 27, 110 KB at most),
// so one computes while the other waits at its barrier.  The row axis
// streams through a ring of NSTAGE = 4 stages in chunks of RCH = 64 rows:
// a stage is (layer, chunk), the chunks of a layer add into the same
// accumulators in the order of their rows, and the layer's recurrence
// runs after its last chunk.  So shared memory does not grow with R, any
// row count fits, and the fill sums the rows in the order one stage of
// all Rp rows would (the same bits); at R <= RCH a layer is one stage.
// The table tile, the weights and the chains' (C2 / T, drp / 2) of stage
// s + 3 are in flight (cp.async; the two scalars through registers,
// loaded a layer earlier still) while stage s is computed: one barrier a
// stage, and a thread's copies differ from layer to layer by a constant
// offset (no division in the loop).  With 32 chains a block the table is read
// from L2 16 times per launch (0.43 GB at R = 27, L = 100, W = 2501; the
// 4-chain blocks of the first version read it 128 times, 3.5 GB).
// blockIdx.x walks the chain blocks, so the blocks resident at once
// share a few table tiles; the wavenumber tiles are spread over the
// grid's y and z (hopper.cuh: tile_grid), so any W below 2^31 - 64 fits,
// and the table is read through 64-bit offsets, so it may hold any number
// of elements.  Only the weights are indexed in 32 bits: C L Rp < 2^31.  Any number of quadrature nodes: the unrolled
// instances (raygrid's 5, expsum's 8) hold them in shared memory, the
// runtime-count one reads any count through the read-only cache.
//
// Bound on the H100.  Per 512-chain batch at R = 27, L = 100, W = 2501:
// 128 M (chain, layer, wavenumber) points, each 27 FMAs of fill (three
// TF32 passes over 32 padded rows: 0.05 ms at the dense TF32 peak) and,
// on the float32 pipes, the recurrence, one Planck exponential and
// division, and 5 exponentials (raygrid) or one and an 8-term Horner
// polynomial (expsum).  What binds it is the float32 pipes' instruction
// rate: expf and expm1f are the accurate library versions (no
// --use_fast_math), about a dozen instructions each.  Measured on an
// NVIDIA H100 80GB HBM3 at 700 W: 0.91 ms a launch (raygrid; 3.02 ms for
// the float32-pipe version with 4-chain blocks), of which, by leaving
// parts out, the Planck function 0.22, the quadrature 0.22, the fill
// 0.28 and the copies 0.11 ms: the parts add up (PERF.md has the table).

#include <cuda_runtime.h>

#include "hopper.cuh"

#define TILE_W 64    // wavenumbers per block
#define CB 32        // chains per block
#define NSTAGE 4     // layers in the shared-memory ring
#define NTHREADS 256 // threads per block (8 warps)
#define RCH 64       // table rows a stage holds: the chunk of the row axis

// Timing aid (ablate_folded.py --k1): -DBART_ABLATE=<bits> builds the kernel
// without 1 its global -> shared copies of the table and the weights, 2
// its tensor-core products, 4 its quadrature exponentials, 8 its Planck
// exponential and division; 16 takes the fast __expf in the quadrature
// (the result is then nearly right; all others give wrong results).
#ifndef BART_ABLATE
#define BART_ABLATE 0
#endif
#if BART_ABLATE & 4
#define BART_EXPF(x) (1.0f + (x))
#elif BART_ABLATE & 16
#define BART_EXPF(x) __expf(x)
#else
#define BART_EXPF(x) expf(x)
#endif

namespace {

static_assert(TILE_W % 16 == 0 && CB % 16 == 0 &&
                  NTHREADS == 32 * (TILE_W / 16) * (CB / 16),
              "the warp tiling: a warp per 16 wavenumbers x 16 chains");
static_assert((NSTAGE & (NSTAGE - 1)) == 0, "the ring index is s & (NSTAGE - 1)");
static_assert(RCH % 8 == 0 && CB * (RCH / 4) <= 2 * NTHREADS,
              "a chunk is whole k-steps, its weights two 16-byte copies a "
              "thread at most");

// 2 h c^2 and h c / k of bart_tpu_torch.constants (cgs; the CPU tests
// check these literals against the Python constants)
constexpr float kC1 = 1.1910439340652298e-05f;
constexpr float kC2 = 1.4387686603333911f;
constexpr float kTwoPi = 6.2831853071795865f;
constexpr float kTauClamp = 88.0f;

constexpr int kTS = TILE_W + 8;   // row stride of the table tile, in words

// Words of one stage of the ring for a chunk of Rs rows (Rs = min(Rp,
// RCH), a multiple of 8): the table tile [Rs][kTS], the weights
// [CB][Rs + 4] and the chains' C2 / T and drp / 2, [2][CB].  Every part is
// a multiple of 16 bytes.
__host__ __device__ constexpr size_t stage_words(int Rs) {
  return (size_t)Rs * kTS + (size_t)CB * (Rs + 4) + 2 * CB;
}
__host__ __device__ constexpr size_t smem_bytes(int Rs) {
  return 4 * NSTAGE * stage_words(Rs);
}

// NMU > 0: the quadrature has exactly NMU nodes, held in shared memory,
// and its loops unroll; NMU == 0: any number of nodes, read through the
// read-only cache (no bound but the loop's length).  CHUNKED (Rp > RCH): a layer is
// ceil(Rp / RCH) stages of RCH rows; else one stage of all Rp rows.
template <bool POWERS, int NMU, bool CHUNKED>
__global__ void __launch_bounds__(NTHREADS, 512 / NTHREADS)
fused_eclipse_kernel(const float* __restrict__ tab,     // [R, L, Wp]
                     const float* __restrict__ wrows,   // [C, L, Rp]
                     const float* __restrict__ T,       // [C, L]
                     const float* __restrict__ drp,     // [C, L]
                     const float* __restrict__ wn,      // [W]
                     const float* __restrict__ minv,    // [nmu]
                     const float* __restrict__ wmu,     // [nmu]
                     float* __restrict__ out,           // [C, W]
                     int R, int Rp, int L, int W, int Wp, int C,
                     int nmu_any, int ntile) {
  const int tile = grid_tile();
  if (tile >= ntile) return;        // past the last tile (tile_grid)
  const int nmu = NMU ? NMU : nmu_any;
  extern __shared__ float4 smem4[];
  float* ring = reinterpret_cast<float*>(smem4);
  __shared__ float minv_s[NMU ? NMU : 1], wmu_s[NMU ? NMU : 1];
  // quadrature node q: NMU > 0 from shared memory, else from the
  // read-only cache
  auto wmu_q = [&](int q) { return NMU ? wmu_s[q] : __ldg(wmu + q); };
  auto minv_q = [&](int q) { return NMU ? minv_s[q] : __ldg(minv + q); };

  const int Rs = CHUNKED ? RCH : Rp;     // rows a stage holds
  const int WS = Rs + 4;                 // row stride of the weights
  const size_t stage = stage_words(Rs);
  const int tid = threadIdx.x;
  const int lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, t = lane & 3;
  const int fw = (warp % (TILE_W / 16)) * 16;   // the warp's wavenumbers
  const int ch = (warp / (TILE_W / 16)) * 16;   // and chains, 16 of each
  const int c0 = blockIdx.x * CB;
  const int w0 = tile * TILE_W;

  if (NMU && tid < NMU) {
    minv_s[tid] = minv[tid];
    wmu_s[tid] = wmu[tid];
  }
#if BART_ABLATE & 1
  for (size_t i = tid; i < NSTAGE * stage; i += NTHREADS) ring[i] = 0.0f;
  __syncthreads();
#endif

  // Unchunked: this thread's weight copies of a stage (task i = tid + j
  // NTHREADS is 16 bytes q of chain cc; CB Rp / 4 <= 2 NTHREADS tasks),
  // reckoned once: the divisions by a run-time row count stay out of the
  // layer loop.  Chunked: a chunk's RCH / 4 copies a chain divide by a
  // constant.
  const int rq = Rp / 4, nwtask = CB * rq;
  int w_dst[2], w_src[2];
  if (!CHUNKED) {
#pragma unroll
    for (int j = 0; j < 2; ++j) {
      const int i = tid + j * NTHREADS;
      const int q = i % rq, cc = i / rq;
      const int c = c0 + cc;
      w_dst[j] = cc * WS + 4 * q;
      // -1: nothing to copy (beyond the tasks); -2: zero-fill (beyond C)
      w_src[j] = i >= nwtask ? -1 : c >= C ? -2 : (int)((size_t)c * L * Rp + 4 * q);
    }
  }
  // the chain whose (T, drp) this thread stages, a layer ahead of the copy
  const int ac = (tid < CB && c0 + tid < C) ? c0 + tid : -1;
  float a_T = 1000.0f, a_dr = 0.0f;
  auto load_aux = [&](int l) {
    if (ac >= 0 && l < L) {
      a_T = T[(size_t)ac * L + l];
      a_dr = drp[(size_t)ac * L + l];
    }
  };

  // stage ``s`` of the ring, rows r0 .. r0 + Rs - 1 of layer l: the table
  // tile tab[r0 : r0 + Rs, l, w0 : w0 + TILE_W] (rows from R on and
  // columns beyond Wp zero-filled), the weights of those rows of the
  // block's chains (rows from Rp on and chains beyond C zero-filled) and
  // their C2 / T, drp / 2 from the registers load_aux(l) filled
  auto copy_stage = [&](int s, int l, int r0) {
    float* tb = ring + (size_t)(s & (NSTAGE - 1)) * stage;
    float* wb = tb + (size_t)Rs * kTS;
    if (tid < CB) {
      float* ax = wb + (size_t)CB * WS;
      ax[tid] = kC2 / a_T;
      ax[CB + tid] = 0.5f * a_dr;
    }
    if (BART_ABLATE & 1) return;
    const float* src = tab + ((size_t)r0 * L + l) * Wp + w0;
    for (int i = tid; i < Rs * (TILE_W / 4); i += NTHREADS) {
      const int r = i / (TILE_W / 4), q = i % (TILE_W / 4);
      const bool ok = r0 + r < R && w0 + 4 * q < Wp;
      cp_async16(tb + r * kTS + 4 * q,
                 ok ? src + (size_t)r * L * Wp + 4 * q : tab, ok);
    }
    if (CHUNKED) {
#pragma unroll
      for (int j = 0; j < CB * (RCH / 4) / NTHREADS; ++j) {
        const int i = tid + j * NTHREADS;
        const int q = i % (RCH / 4), cc = i / (RCH / 4);
        const int c = c0 + cc;
        const bool ok = c < C && r0 + 4 * q < Rp;
        cp_async16(wb + cc * WS + 4 * q,
                   ok ? wrows + ((size_t)c * L + l) * Rp + r0 + 4 * q : wrows,
                   ok);
      }
    } else {
#pragma unroll
      for (int j = 0; j < 2; ++j) {
        if (w_src[j] != -1)
          cp_async16(wb + w_dst[j],
                     wrows + (w_src[j] < 0 ? 0 : w_src[j] + l * Rp),
                     w_src[j] >= 0);
      }
    }
  };

  // this thread's 8 (wavenumber, chain) pairs: e = 4 nt + i is wavenumber
  // w0 + fw + g + 8 (i / 2), chain c0 + ch + 8 nt + 2 t + (i & 1)
  float wnv[2], wn3[2];
#pragma unroll
  for (int k = 0; k < 2; ++k) {
    const int w = w0 + fw + g + 8 * k;
    wnv[k] = (w < W) ? wn[w] : 1.0f;
    wn3[k] = kC1 * (wnv[k] * wnv[k] * wnv[k]);
  }
  float ext_p[8], tau[8], B_p[8], S_p[8], flux[8];
#pragma unroll
  for (int e = 0; e < 8; ++e)
    ext_p[e] = tau[e] = B_p[e] = S_p[e] = flux[e] = 0.0f;

  // ---- ext of a layer: three TF32 passes per 8 rows; the two small
  // products and the big one in accumulators of their own ---------------
  float acc_s[2][4], acc_b[2][4];
  auto clear = [&]() {
#pragma unroll
    for (int nt = 0; nt < 2; ++nt)
#pragma unroll
      for (int i = 0; i < 4; ++i) acc_s[nt][i] = acc_b[nt][i] = 0.0f;
  };
  // the KS k-steps of the rows staged in slot ``s``
  auto fill = [&](int s, int KS) {
    const float* tb = ring + (size_t)(s & (NSTAGE - 1)) * stage;
    const float* wb = tb + (size_t)Rs * kTS;
    for (int ks = 0; ks < ((BART_ABLATE & 2) ? 0 : KS); ++ks) {
      // A: (wavenumber fw + g (+ 8), row 8 ks + t (+ 4))
      const float* ta = tb + (8 * ks + t) * kTS + fw + g;
      uint32_t ab[4], as[4];
      split_tf32(ta[0], ab[0], as[0]);
      split_tf32(ta[8], ab[1], as[1]);
      split_tf32(ta[4 * kTS], ab[2], as[2]);
      split_tf32(ta[4 * kTS + 8], ab[3], as[3]);
#pragma unroll
      for (int nt = 0; nt < 2; ++nt) {
        // B: (row 8 ks + t (+ 4), chain ch + 8 nt + g)
        const float* wa = wb + (ch + 8 * nt + g) * WS + 8 * ks + t;
        uint32_t bb[2], bs[2];
        split_tf32(wa[0], bb[0], bs[0]);
        split_tf32(wa[4], bb[1], bs[1]);
        mma_tf32(acc_s[nt], as, bb);
        mma_tf32(acc_s[nt], ab, bs);
        mma_tf32(acc_b[nt], ab, bb);
      }
    }
  };

  // ---- recurrence, Planck, quadrature and flux of layer l on the
  // fragments, with the chains' scalars staged in slot ``s`` -------------
  auto layer_step = [&](int l, int s) {
    const float* ax = ring + (size_t)(s & (NSTAGE - 1)) * stage +
                      (size_t)Rs * kTS + (size_t)CB * WS;
    // C2 / T and drp / 2 of the thread's 4 chains, j = 2 nt + (i & 1)
    float c2T[4], hdr[4];
#pragma unroll
    for (int nt = 0; nt < 2; ++nt) {
      const float2 a = *reinterpret_cast<const float2*>(ax + ch + 8 * nt + 2 * t);
      const float2 d =
          *reinterpret_cast<const float2*>(ax + CB + ch + 8 * nt + 2 * t);
      c2T[2 * nt] = a.x;
      c2T[2 * nt + 1] = a.y;
      hdr[2 * nt] = d.x;
      hdr[2 * nt + 1] = d.y;
    }
    float S[8], B[8];
#pragma unroll
    for (int e = 0; e < 8; ++e) {
      const int j = 2 * (e >> 2) + (e & 1), k = (e >> 1) & 1;
      const float ext = acc_s[e >> 2][e & 3] + acc_b[e >> 2][e & 3];
      if (l > 0) tau[e] = tau[e] + (ext_p[e] + ext) * hdr[j];
      ext_p[e] = ext;
#if BART_ABLATE & 8
      B[e] = wn3[k] * (c2T[j] * wnv[k]);
#else
      B[e] = wn3[k] / expm1f(c2T[j] * wnv[k]);
#endif
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
#pragma unroll
    for (int e = 0; e < 8; ++e) {
      if (l > 0)
        flux[e] = flux[e] + (0.5f * (B_p[e] + B[e])) * (S_p[e] - S[e]);
      B_p[e] = B[e];
      S_p[e] = S[e];
    }
  };

  if (!CHUNKED) {
    // a stage a layer
    for (int l = 0; l < NSTAGE - 1; ++l) {
      load_aux(l);
      if (l < L) copy_stage(l, l, 0);
      cp_async_commit();
    }
    load_aux(NSTAGE - 1);

    for (int l = 0; l < L; ++l) {
      cp_async_wait<NSTAGE - 2>();
      __syncthreads();  // stage l is there; every thread is done with l - 1
      if (l + NSTAGE - 1 < L) copy_stage(l + NSTAGE - 1, l + NSTAGE - 1, 0);
      cp_async_commit();
      load_aux(l + NSTAGE);
      clear();
      fill(l, Rp / 8);
      layer_step(l, l);
    }
  } else {
    // a stage a chunk; the last chunk of a layer takes the rest of its
    // k-steps.  The next stage to copy is chunk ck of layer cl, and the
    // registers of load_aux hold layer cl's.
    const int nch = (Rp + RCH - 1) / RCH;
    int cl = 0, ck = 0;
    auto copy_next = [&](int s) {
      copy_stage(s, cl, ck * RCH);
      if (++ck == nch) {
        ck = 0;
        load_aux(++cl);
      }
    };
    load_aux(0);
    for (int s = 0; s < NSTAGE - 1; ++s) {
      if (cl < L) copy_next(s);
      cp_async_commit();
    }
    for (int l = 0, s = 0; l < L; ++l) {
      clear();
      for (int k = 0; k < nch; ++k, ++s) {
        cp_async_wait<NSTAGE - 2>();
        __syncthreads();  // stage s is there; every thread is done with s - 1
        if (cl < L) copy_next(s + NSTAGE - 1);
        cp_async_commit();
        fill(s, k < nch - 1 ? RCH / 8 : (Rp - (nch - 1) * RCH) / 8);
      }
      layer_step(l, s - 1);
    }
  }
  cp_async_wait<0>();

  // ---- close with B_{L-1} S_{L-1} --------------------------------------
#pragma unroll
  for (int e = 0; e < 8; ++e) {
    const int c = c0 + ch + 8 * (e >> 2) + 2 * t + (e & 1);
    const int w = w0 + fw + g + 8 * ((e >> 1) & 1);
    if (c < C && w < W)
      out[(size_t)c * W + w] = kTwoPi * (flux[e] + B_p[e] * S_p[e]);
  }
}

template <bool POWERS, int NMU, bool CHUNKED>
cudaError_t launch(const float* tab, const float* wrows, const float* T,
                   const float* drp, const float* wn, const float* minv,
                   const float* wmu, float* out, int R, int Rp, int L, int W,
                   int Wp, int C, int nmu, cudaStream_t stream) {
  if (Rp % 8 != 0 || Rp < R || Wp % 4 != 0 || Wp < W || Wp >= kMaxRow ||
      (long long)C * L * Rp >= (1ll << 31))
    return cudaErrorInvalidValue;
  const int ntile = (W + TILE_W - 1) / TILE_W;
  const size_t smem = smem_bytes(CHUNKED ? RCH : Rp);
  const cudaError_t e = cudaFuncSetAttribute(
      fused_eclipse_kernel<POWERS, NMU, CHUNKED>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e != cudaSuccess) return e;
  fused_eclipse_kernel<POWERS, NMU, CHUNKED>
      <<<tile_grid((C + CB - 1) / CB, ntile), NTHREADS, smem, stream>>>(
          tab, wrows, T, drp, wn, minv, wmu, out, R, Rp, L, W, Wp, C, nmu,
          ntile);
  return cudaGetLastError();
}

}  // namespace

// Plain C entry point (bound with ctypes).  tab [R, L, Wp] is the table
// with its wavenumber axis zero-padded to Wp, W rounded up to 4 (16
// bytes: bart_tpu_torch.rt.fused.rows_table); wrows [C, L, Rp] the
// weights zero-padded to Rp rows, R rounded up to 8 (C L Rp < 2^31: the
// weights are indexed in 32 bits); Wp < 2^31 - 64; nmu >= 1 quadrature
// nodes.  Returns the cudaError_t of the launch: 0 when the kernel was
// queued on ``stream``.
extern "C" int bart_fused_eclipse(const float* tab, const float* wrows,
                                  const float* T, const float* drp,
                                  const float* wn, const float* minv,
                                  const float* wmu, float* out, int R, int Rp,
                                  int L, int W, int Wp, int C, int nmu,
                                  int powers, cudaStream_t stream) {
  if (nmu < 1 || R < 1 || L < 1 || W < 1 || C < 1)
    return (int)cudaErrorInvalidValue;
  // the quadratures in use get unrolled instances: expsum's 8 powers,
  // raygrid's 5 angles
#define BART_K1(POWERS, NMU)                                                \
  (Rp > RCH ? launch<POWERS, NMU, true>(tab, wrows, T, drp, wn, minv, wmu,   \
                                        out, R, Rp, L, W, Wp, C, nmu, stream) \
            : launch<POWERS, NMU, false>(tab, wrows, T, drp, wn, minv, wmu,  \
                                         out, R, Rp, L, W, Wp, C, nmu,       \
                                         stream))
  const cudaError_t e =
      powers ? (nmu == 8 ? BART_K1(true, 8) : BART_K1(true, 0))
             : (nmu == 5 ? BART_K1(false, 5) : BART_K1(false, 0));
#undef BART_K1
  return (int)e;
}
