// Hopper (sm_90) helpers for thread-block clusters: mbarriers (local and
// remote arrivals, transaction counts, waits on a phase), the cluster
// barrier, and the bulk copy global -> shared memory of the Tensor Memory
// Accelerator with multicast to several blocks of the cluster, which
// completes on an mbarrier, and the tensor maps it reads.  Used by the
// resident transit kernel (fused_transit_mma.cuh) and the folded eclipse
// kernel (fused_eclipse_folded.cu).
//
// A bulk copy (cp.async.bulk, the TMA's non-tensor mode) moves one
// contiguous run of bytes: its size and both addresses are multiples of 16
// bytes; a tensor copy (cp.async.bulk.tensor) one box of a tensor map.
// With a multicast mask either writes the same bytes at the same
// shared-memory offset in every block of the mask and adds them to the
// transaction count of the mbarrier at the same offset in each.  A phase of
// an mbarrier completes when its pending arrivals reach zero and its
// transaction count is back at zero; bytes may land before the local
// arrival that expects them (the count is signed).
//
// A wait that does not end within kWaitLimitCycles (about 4 s) traps, so
// that a fault in the hand-offs ends the launch with an error rather than
// hanging the card.

#pragma once

#include <cuda.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr long long kWaitLimitCycles = 1ll << 33;

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ unsigned cluster_ctarank() {
  unsigned r;
  asm volatile("mov.u32 %0, %%cluster_ctarank;\n" : "=r"(r));
  return r;
}
__device__ __forceinline__ unsigned cluster_ctaid_x() {
  unsigned r;
  asm volatile("mov.u32 %0, %%cluster_ctaid.x;\n" : "=r"(r));
  return r;
}

// every thread of every block of the cluster: writes before it (shared
// memory and mbarrier initialisation included) are seen after it
__device__ __forceinline__ void cluster_sync() {
  asm volatile(
      "barrier.cluster.arrive.release;\n"
      "barrier.cluster.wait.acquire;\n" ::
          : "memory");
}

__device__ __forceinline__ void mbar_init(uint64_t* bar, unsigned count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(
                   smem_u32(bar)),
               "r"(count)
               : "memory");
}

// the initialisations of this thread, seen by the cluster's blocks and by
// the asynchronous copies (before the cluster barrier that follows)
__device__ __forceinline__ void mbar_init_fence() {
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
}

// one arrival on this block's barrier
__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(
                   smem_u32(bar))
               : "memory");
}

// one arrival on this block's barrier that also expects ``bytes`` more of
// asynchronous copies in the current phase
__device__ __forceinline__ void mbar_arrive_expect_tx(uint64_t* bar,
                                                      unsigned bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::
                   "r"(smem_u32(bar)),
               "r"(bytes)
               : "memory");
}

// one arrival on the barrier at ``bar``'s offset in the cluster's block of
// rank ``rank`` (this block's own included).  It releases at the block's
// scope, as a consumer's release of a stage does in CUTLASS's pipelines:
// the stage's reads are done (their values in registers) before it
__device__ __forceinline__ void mbar_arrive_cluster(uint64_t* bar,
                                                    unsigned rank) {
  asm volatile(
      "{\n"
      ".reg .b32 ra;\n"
      "mapa.shared::cluster.u32 ra, %0, %1;\n"
      "mbarrier.arrive.shared::cluster.b64 _, [ra];\n"
      "}\n" ::"r"(smem_u32(bar)),
      "r"(rank)
      : "memory");
}

__device__ __forceinline__ bool mbar_try_wait(uint32_t bar, unsigned parity) {
  unsigned ok;
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
      "selp.u32 %0, 1, 0, p;\n"
      "}\n"
      : "=r"(ok)
      : "r"(bar), "r"(parity)
      : "memory");
  return ok != 0;
}

__device__ __forceinline__ bool mbar_try_wait_cluster(uint32_t bar,
                                                      unsigned parity) {
  unsigned ok;
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "mbarrier.try_wait.parity.acquire.cluster.shared::cta.b64 p, [%1], "
      "%2;\n"
      "selp.u32 %0, 1, 0, p;\n"
      "}\n"
      : "=r"(ok)
      : "r"(bar), "r"(parity)
      : "memory");
  return ok != 0;
}

// Wait until the phase of parity ``parity`` of this block's barrier has
// completed (a fresh barrier counts its phase before the first as
// completed: parity 1 passes at once).  kCluster: the arrivals came from
// other blocks of the cluster (acquire at cluster scope).
template <bool kCluster = false>
__device__ __forceinline__ void mbar_wait(uint64_t* bar, unsigned parity) {
  const uint32_t a = smem_u32(bar);
  if (kCluster ? mbar_try_wait_cluster(a, parity) : mbar_try_wait(a, parity))
    return;
  const long long t0 = clock64();
  while (!(kCluster ? mbar_try_wait_cluster(a, parity)
                    : mbar_try_wait(a, parity))) {
    if (clock64() - t0 > kWaitLimitCycles) __trap();
  }
}

// bytes [src, src + bytes) of global memory to dst in every block of the
// cluster whose rank's bit is set in ``mask``, completing on the barrier at
// ``bar``'s offset in each (16-byte multiples and alignment)
__device__ __forceinline__ void bulk_copy_multicast(void* dst, const void* src,
                                                    unsigned bytes,
                                                    uint64_t* bar,
                                                    uint16_t mask) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes."
      "multicast::cluster [%0], [%1], %2, [%3], %4;\n" ::"r"(smem_u32(dst)),
      "l"(src), "r"(bytes), "r"(smem_u32(bar)), "h"(mask)
      : "memory");
}

// The box of ``map`` at (x0, x1, x2) (innermost first) to dst in every
// block of the cluster whose rank's bit is set in ``mask``, completing on
// the barrier at ``bar``'s offset in each; the TMA writes the box with the
// map's swizzle, zero where it lies outside the tensor, and counts every
// byte of the box (dst: 1024-byte aligned for the swizzles used here)
__device__ __forceinline__ void tma_load_3d_multicast(void* dst,
                                                      const CUtensorMap* map,
                                                      int x0, int x1, int x2,
                                                      uint64_t* bar,
                                                      uint16_t mask) {
  asm volatile(
      "cp.async.bulk.tensor.3d.shared::cluster.global.mbarrier::complete_tx::"
      "bytes.multicast::cluster [%0], [%1, {%2, %3, %4}], [%5], %6;\n" ::"r"(
          smem_u32(dst)),
      "l"(map), "r"(x0), "r"(x1), "r"(x2), "r"(smem_u32(bar)), "h"(mask)
      : "memory");
}

// The box of ``map`` at (x0, x1, x2) (innermost first), or (x0, .., x3),
// to dst in this block only, completing on ``bar``
__device__ __forceinline__ void tma_load_3d(void* dst, const CUtensorMap* map,
                                            int x0, int x1, int x2,
                                            uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.tensor.3d.shared::cluster.global.mbarrier::complete_tx::"
      "bytes [%0], [%1, {%2, %3, %4}], [%5];\n" ::"r"(smem_u32(dst)),
      "l"(map), "r"(x0), "r"(x1), "r"(x2), "r"(smem_u32(bar))
      : "memory");
}
__device__ __forceinline__ void tma_load_4d(void* dst, const CUtensorMap* map,
                                            int x0, int x1, int x2, int x3,
                                            uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx::"
      "bytes [%0], [%1, {%2, %3, %4, %5}], [%6];\n" ::"r"(smem_u32(dst)),
      "l"(map), "r"(x0), "r"(x1), "r"(x2), "r"(x3), "r"(smem_u32(bar))
      : "memory");
}

// cuTensorMapEncodeTiled of the driver, found through the runtime (so the
// library needs no link flag of its own); null if the driver has none
typedef CUresult (*EncodeTiledFn)(CUtensorMap*, CUtensorMapDataType,
                                  cuuint32_t, void*, const cuuint64_t*,
                                  const cuuint64_t*, const cuuint32_t*,
                                  const cuuint32_t*, CUtensorMapInterleave,
                                  CUtensorMapSwizzle, CUtensorMapL2promotion,
                                  CUtensorMapFloatOOBfill);
inline EncodeTiledFn encode_tiled_fn() {
  static EncodeTiledFn fn = []() -> EncodeTiledFn {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult q;
#if CUDART_VERSION >= 12050
    if (cudaGetDriverEntryPointByVersion("cuTensorMapEncodeTiled", &p, 12000,
                                         cudaEnableDefault, &q) != cudaSuccess)
      return nullptr;
#else
    if (cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p,
                                cudaEnableDefault, &q) != cudaSuccess)
      return nullptr;
#endif
    return q == cudaDriverEntryPointSuccess ? (EncodeTiledFn)p : nullptr;
  }();
  return fn;
}

// An N-d tensor map of ``base`` (dims innermost first, strides in bytes
// of dims 1 .. N - 1), boxes of ``box``, zero fill outside, L2 promotion
// of 128 bytes; false on failure
template <int N>
inline bool encode_map(CUtensorMap* map, CUtensorMapDataType type,
                       const void* base, const cuuint64_t (&dims)[N],
                       const cuuint64_t (&strides)[N - 1],
                       const cuuint32_t (&box)[N],
                       CUtensorMapSwizzle swizzle) {
  const EncodeTiledFn fn = encode_tiled_fn();
  if (fn == nullptr) return false;
  cuuint32_t one[N];
  for (int i = 0; i < N; ++i) one[i] = 1;
  return fn(map, type, N, const_cast<void*>(base), dims, strides, box, one,
            CU_TENSOR_MAP_INTERLEAVE_NONE, swizzle,
            CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
            CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

}  // namespace
