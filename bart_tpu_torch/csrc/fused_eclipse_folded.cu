// Folded eclipse emergent flux (K sub-samples per output bin), for
// Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel bart_tpu/rt/fused.py:_fkernel, which
// _fpallas_batch dispatches for fused_eclipse_folded.  Same math as the
// plain torch version bart_tpu_torch/rt/fused.py:eclipse_folded_plain.
// The fine table is bin-major: fine point f = b K + k is sub-sample k of
// output bin b.  For every (chain c, fine point f), walking the layers,
//
//   ext_l = sum_r wrows[c, l, r] tab[r, l, f]    (f32 FMAs; a bf16 table
//                                                 element is widened first)
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
// Design.  The TPU kernel made K an inner grid axis and kept the partial
// mean of S for every layer in a VMEM scratch between grid steps.  Here
// the K sub-samples of a bin are K neighbouring lanes of one warp (K a
// power of two up to 32), so nothing is carried between blocks and the
// mean is one shuffle reduction at the end.  A thread owns one fine
// point and CPT = 4 chains: every table word it reads from shared memory
// feeds 4 FMAs, the 4 chains' weights arriving as one float4 broadcast.
// A block covers TILE_F = 128 fine points x CB = 8 chains and stages
// tab[:, l, tile] and its chains' wrows[c, l, :] per layer, as the K = 1
// kernel does.  The Planck function depends on (chain, layer, bin) only:
// every K layers, lane k of a bin's group evaluates it for layer l0 + k,
// and each layer's value is broadcast with a shuffle, so there is one
// Planck exponential per (chain, layer, bin), as in the TPU kernel, and
// not one per fine point.
//
// Bound on the H100.  Per 512-chain batch at R = 27, L = 100, 1,125 fine
// bins, K = 32: 50 G FMAs for ext (1.5 ms at the float32 peak) and one
// exponential per (chain, layer, fine point) in powers mode (5 in
// raygrid).  The table (97 MB in bf16) is read once per chain block from
// L2 or HBM; operations bound it, not bytes.  expf and expm1f are the
// accurate library versions (no --use_fast_math).

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#define TILE_F 128   // fine points per block (threadIdx.x)
#define TY 2         // thread rows per block (threadIdx.y)
#define CPT 4        // chains per thread
#define MAX_NMU 16   // quadrature nodes held in shared memory

namespace {

constexpr int CB = TY * CPT;   // chains per block
static_assert(CPT == 4, "the weights are read as one float4 per row");

// 2 h c^2 and h c / k from bart_tpu_torch.constants (cgs; the CPU tests
// check these literals against the Python constants)
constexpr float kC1 = 1.1910439340652298e-05f;
constexpr float kC2 = 1.4387686603333911f;
constexpr float kTwoPi = 6.2831853071795865f;
constexpr float kTauClamp = 88.0f;
constexpr unsigned kFullMask = 0xffffffffu;

__device__ __forceinline__ float tab_f32(float v) { return v; }
__device__ __forceinline__ float tab_f32(__nv_bfloat16 v) {
  return __bfloat162float(v);
}

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

template <typename TabT, bool POWERS>
__global__ void __launch_bounds__(TILE_F * TY)
fused_eclipse_folded_kernel(const TabT* __restrict__ tab,    // [R, L, Fp]
                            const float* __restrict__ wrows, // [C, L, R]
                            const float* __restrict__ T,     // [C, L]
                            const float* __restrict__ drp,   // [C, L]
                            const float* __restrict__ wn,    // [W] bin centres
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
      tab_s[i] = (ff < F) ? tab_f32(tab[((size_t)r * L + l) * Fp + ff]) : 0.0f;
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

template <typename TabT, bool POWERS>
cudaError_t launch(const void* tab, const float* wrows, const float* T,
                   const float* drp, const float* wn, const float* minv,
                   const float* wmu, float* out, int R, int L, int W, int Fp,
                   int C, int K, int nmu, cudaStream_t stream) {
  const size_t smem = sizeof(float) * ((size_t)R * TILE_F + (size_t)CB * R);
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        fused_eclipse_folded_kernel<TabT, POWERS>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return e;
  }
  const dim3 block(TILE_F, TY);
  const dim3 grid((W * K + TILE_F - 1) / TILE_F, (C + CB - 1) / CB);
  fused_eclipse_folded_kernel<TabT, POWERS><<<grid, block, smem, stream>>>(
      static_cast<const TabT*>(tab), wrows, T, drp, wn, minv, wmu, out, R, L,
      W, Fp, C, K, nmu);
  return cudaGetLastError();
}

}  // namespace

// Plain C entry point (bound with ctypes).  tab [R, L, Fp] is the
// bin-major fine table, float32 or (bf16 != 0) bfloat16, whose first W K
// columns are in use; K is a power of two in 2..32.  Returns the
// cudaError_t of the launch: 0 when the kernel was queued on ``stream``.
extern "C" int bart_fused_eclipse_folded(
    const void* tab, const float* wrows, const float* T, const float* drp,
    const float* wn, const float* minv, const float* wmu, float* out, int R,
    int L, int W, int Fp, int C, int K, int nmu, int powers, int bf16,
    cudaStream_t stream) {
  if (nmu < 1 || nmu > MAX_NMU || R < 1 || L < 1 || W < 1 || C < 1 || K < 2 ||
      K > 32 || (K & (K - 1)) != 0 || (long long)W * K > Fp ||
      (C + CB - 1) / CB > 65535)
    return (int)cudaErrorInvalidValue;
#define BART_LAUNCH(TabT, POWERS)                                             \
  launch<TabT, POWERS>(tab, wrows, T, drp, wn, minv, wmu, out, R, L, W, Fp, \
                       C, K, nmu, stream)
  const cudaError_t e =
      bf16 ? (powers ? BART_LAUNCH(__nv_bfloat16, true)
                     : BART_LAUNCH(__nv_bfloat16, false))
           : (powers ? BART_LAUNCH(float, true) : BART_LAUNCH(float, false));
#undef BART_LAUNCH
  return (int)e;
}
