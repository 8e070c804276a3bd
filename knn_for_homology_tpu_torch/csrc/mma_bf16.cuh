// bf16 tensor-core helpers for kernel G (csrc/ffn_fused.cu):
// mma.sync.m16n8k16 with fp32 accumulators, and the fragment loads.
//
// Fragment layouts (PTX ISA, mma.m16n8k16 with .bf16), g = lane / 4,
// t = lane % 4; a 32-bit register holds two bf16, the lower index in the
// low half:
//   A 16x16 (row-major):  a[0] = A[g][2t..2t+1]     a[1] = A[g+8][2t..2t+1]
//                         a[2] = A[g][2t+8..2t+9]   a[3] = A[g+8][2t+8..2t+9]
//   B 16x8  (k x n):      b0 = B[2t..2t+1][g]       b1 = B[2t+8..2t+9][g]
//   C 16x8  (fp32):       c[0..1] = C[g][2t..2t+1]  c[2..3] = C[g+8][2t..2t+1]

#pragma once

#include <cuda_bf16.h>
#include <stdint.h>

namespace knn_mma {

using bf16 = __nv_bfloat16;

__device__ __forceinline__ void mma(float (&c)[4], const uint32_t (&a)[4],
                                    uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// two floats → bf16 pair (round to nearest even), `lo` in the low half
__device__ __forceinline__ uint32_t pack(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

// two neighbouring bf16 (4-byte aligned) as one register
__device__ __forceinline__ uint32_t ld_pair(const bf16* p) {
  return *reinterpret_cast<const uint32_t*>(p);
}

// two bf16 from anywhere: `lo` in the low half
__device__ __forceinline__ uint32_t ld_two(const bf16* lo, const bf16* hi) {
  const uint32_t l = *reinterpret_cast<const uint16_t*>(lo);
  const uint32_t h = *reinterpret_cast<const uint16_t*>(hi);
  return l | (h << 16);
}

// A fragment of a row-major bf16 tile: rows r..r+15, cols c..c+15
__device__ __forceinline__ void ld_a(uint32_t (&a)[4], const bf16* tile,
                                     int ld, int g, int t) {
  const bf16* p = tile + g * ld + 2 * t;
  a[0] = ld_pair(p);
  a[1] = ld_pair(p + 8 * ld);
  a[2] = ld_pair(p + 8);
  a[3] = ld_pair(p + 8 * ld + 8);
}

// B fragment (k x n = 16 x 8) of a row-major [k][n] bf16 tile
__device__ __forceinline__ void ld_b_kn(uint32_t& b0, uint32_t& b1,
                                        const bf16* tile, int ld, int g,
                                        int t) {
  const bf16* p = tile + (2 * t) * ld + g;
  b0 = ld_two(p, p + ld);
  b1 = ld_two(p + 8 * ld, p + 9 * ld);
}

// cooperative copy of a [ROWS][COLS] bf16 tile by NTHREADS threads, 16
// bytes per thread step, every load issued before the first store; both
// row pitches keep 16-byte alignment. Rows at or past `valid` are zeros.
template <int ROWS, int COLS, int NTHREADS>
__device__ __forceinline__ void copy_tile(bf16* dst, int ld_dst,
                                          const bf16* src, size_t ld_src,
                                          int valid) {
  constexpr int PER_ROW = COLS / 8, STEPS = ROWS * PER_ROW / NTHREADS;
  static_assert(COLS % 8 == 0 && (ROWS * PER_ROW) % NTHREADS == 0,
                "the tile must split evenly over the threads");
  uint4 v[STEPS];
#pragma unroll
  for (int s = 0; s < STEPS; ++s) {
    const int i = threadIdx.x + s * NTHREADS;
    const int r = i / PER_ROW, c = (i % PER_ROW) * 8;
    v[s] = r < valid ? __ldg(reinterpret_cast<const uint4*>(
                           src + (size_t)r * ld_src + c))
                     : make_uint4(0u, 0u, 0u, 0u);
  }
#pragma unroll
  for (int s = 0; s < STEPS; ++s) {
    const int i = threadIdx.x + s * NTHREADS;
    const int r = i / PER_ROW, c = (i % PER_ROW) * 8;
    *reinterpret_cast<uint4*>(dst + r * ld_dst + c) = v[s];
  }
}

}  // namespace knn_mma
