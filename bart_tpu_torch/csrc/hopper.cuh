// Small device helpers shared by the kernels of this directory (sm_80 and
// later; built for sm_90a): 16-byte asynchronous copies into shared
// memory, ldmatrix fragment loads, the warp-level tensor-core products
// mma.sync m16n8k16 (bf16 x bf16 -> f32) and m16n8k8 (tf32 x tf32 -> f32),
// the TF32 split of a float32 operand, and the tile axis of the kernels'
// grids.
//
// Fragment layouts (PTX ISA, "Matrix fragments for mma.m16n8k16" and
// "... m16n8k8"), with lane = 4 g + t (g = 0..7, t = 0..3):
//   bf16 A [16 x 16], four 32-bit registers of two neighbouring k each:
//     a0 (row g, k 2t..2t+1)      a1 (row g + 8, k 2t..2t+1)
//     a2 (row g, k 2t+8..2t+9)    a3 (row g + 8, k 2t+8..2t+9)
//   bf16 B [16 x 8]: b0 (k 2t..2t+1, col g), b1 (k 2t+8..2t+9, col g)
//   tf32 A [16 x 8]: a0 (row g, k t), a1 (row g + 8, k t),
//                    a2 (row g, k t + 4), a3 (row g + 8, k t + 4)
//   tf32 B [8 x 8]:  b0 (k t, col g), b1 (k t + 4, col g)
//   C/D [16 x 8] f32: c0, c1 (row g, cols 2t, 2t + 1),
//                     c2, c3 (row g + 8, cols 2t, 2t + 1)

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

// 16-byte asynchronous copy global -> shared; when !valid nothing is
// read and the 16 bytes are zero-filled (src-size 0)
__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           bool valid) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(d),
               "l"(src), "r"(valid ? 16 : 0)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

// wait until at most N of this thread's committed groups are pending
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// Four 8 x 8 matrices of 16-bit elements from shared memory, transposed:
// lanes 8 j .. 8 j + 7 give the addresses of the eight 16-byte rows of
// matrix j, and r[j] of lane 4 g + t holds the elements (row 2t, col g)
// and (row 2t + 1, col g) of matrix j.  A table tile staged [k][m] (m
// contiguous) thereby becomes the A operand of m16n8k16.
__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t (&r)[4],
                                                  const void* row) {
  const unsigned a = static_cast<unsigned>(__cvta_generic_to_shared(row));
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, "
      "[%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(a)
      : "memory");
}

// Two 8 x 8 matrices, not transposed: lanes 0..7 and 8..15 give the row
// addresses, and r[j] of lane 4 g + t holds (row g, cols 2t, 2t + 1) of
// matrix j: the B operand of m16n8k16 from weights staged [n][k] (k
// contiguous).  Lanes 16..31 pass any valid address.
__device__ __forceinline__ void ldmatrix_x2(uint32_t (&r)[2],
                                            const void* row) {
  const unsigned a = static_cast<unsigned>(__cvta_generic_to_shared(row));
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x2.shared.b16 {%0, %1}, [%2];\n"
      : "=r"(r[0]), "=r"(r[1])
      : "r"(a)
      : "memory");
}

// d += A B, A [16 x 16] and B [16 x 8] in bfloat16, d in float32
__device__ __forceinline__ void mma_bf16(float (&d)[4],
                                         const uint32_t (&a)[4],
                                         const uint32_t (&b)[2]) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// d += A B, A [16 x 8] and B [8 x 8] in tf32 (the upper 19 bits of a
// float32 word; the unit ignores the lower 13), d in float32
__device__ __forceinline__ void mma_tf32(float (&d)[4],
                                         const uint32_t (&a)[4],
                                         const uint32_t (&b)[2]) {
  asm volatile(
      "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// x = big + small with big = x rounded to tf32's 10 mantissa bits (to
// nearest, ties away from zero) and small = x - big exactly; the unit
// truncates small to tf32 itself, so big + tf32(small) is within 2^-21
// of x (bart_tpu_torch.rt.fused.split_tf32 states the same rule).
__device__ __forceinline__ void split_tf32(float x, uint32_t& big,
                                           uint32_t& small) {
  big = (__float_as_uint(x) + 0x1000u) & 0xffffe000u;
  small = __float_as_uint(x - __uint_as_float(big));
}

// The tile axis of a grid.  A kernel's (fine) wavenumber tiles are
// numbered tile = blockIdx.y + gridDim.y blockIdx.z: y and z each take at
// most 65,535 blocks, so one of them alone would bound the axis at 65,535
// tiles (4.19 M points at 64 a tile, 2.10 M at 32).  tile_grid spreads
// ntile tiles over gridDim.z = ceil(ntile / 65535) and gridDim.y =
// ceil(ntile / gridDim.z); the few blocks past the last tile return before
// their first copy.  Up to 65,535 tiles gridDim.z is 1: the grid, the
// order of its blocks and every result are those of a y-only grid.
constexpr int kMaxGridYZ = 65535;
inline dim3 tile_grid(unsigned nx, int ntile) {
  const int nz = (ntile + kMaxGridYZ - 1) / kMaxGridYZ;
  return dim3(nx, (ntile + nz - 1) / nz, nz);
}
__device__ __forceinline__ int grid_tile() {
  return (int)(blockIdx.y + gridDim.y * blockIdx.z);
}

// Points a row (W, Wp, F = W K, Fp) travel as int: a row takes fewer than
// 2^31 - 64, so that a tile's end, up to 64 points past the row's last
// tile start, stays an int (bart_tpu_torch.rt.fused._MAX_ROW).  Table and
// output offsets are 64-bit: a table of any size within this is taken.
constexpr int kMaxRow = 2147483647 - 63;

}  // namespace
