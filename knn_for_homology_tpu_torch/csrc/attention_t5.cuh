// T5 attention on Hopper's machinery, shared by kernel H (flash, any L)
// and kernel I (short, L <= 512): q.k + bias(k_pos - q_pos), the mask, the
// softmax and p.v, with q, k, v bf16 [B, H, L, 128], the fp32 [H, 2L-1]
// offset table of ops/flash_attention.py:offset_bias_table and a bool mask
// [B, L]. T5 has no 1/sqrt(d_kv) scale.
//
// Block layout. A block takes BQ = 64 * NWG queries of one (batch row,
// head): NWG consumer warpgroups of 64 rows each and a producer warp (H:
// NWG = 2; I: NWG = 1, two blocks per SM). Blocks are numbered query tile
// first, so the blocks resident at once share one head's k and v in L2;
// each block starts its key sweeps at its own tile and wraps around.
//   * Copies: the producer warp's lane 0 loads q once and then every
//     64-key tile of k and
//     v by TMA (cp.async.bulk.tensor; 4-d maps {64 cols, L rows, 2 halves
//     of d_kv, B*H}, one 16 KB box per tile, 128-byte swizzle; rows past L
//     arrive as zeros) into a k ring of 3 slots and a v ring of 3 (H) or
//     2 (I), each slot with a "full" mbarrier (TMA bytes) and an "empty"
//     one (one arrival per consumer warp).
//   * Products: S = Q.K^T is wgmma m64n64k16 with q and k in shared
//     memory (K-major); P.V is wgmma m64n128k16 with p in registers (the
//     accumulator layout of S is the A-fragment layout of P) and v in
//     shared memory read MN-major through the descriptor's transpose.
//   * Softmax in registers: each lane holds two rows of a warp's 16, the
//     4 lanes of a row reduce with two shuffles. A warpgroup issues S(i)
//     and then PV(i - 1), and runs the softmax of tile i while the tensor
//     cores sum PV(i - 1) (FlashAttention-3's order).
//   * Bias: the block stages the window of its head's table row that its
//     queries reach (L + BQ + 63 floats), pre-multiplied by log2(e), so a
//     score's bias is one shared load at an offset fixed per row and step
//     (no clamps); exp is exp2 of scores in that scale. Key-mask bits are
//     staged as one 64-bit word per tile.
//
// The two kernels differ in two places (template parameter SHORT):
//   * H (SHORT false), the Pallas flash kernel's numerics: one sweep; the
//     running max starts at -1e9; masked keys get the -1e9 fill AND p = 0
//     (a row with no real key ends at 0); l sums the fp32 p; p is cast to
//     bf16 unnormalised; out = bf16(acc / max(l, 1e-30)).
//   * I (SHORT true), models/t5.py:_attention's numerics: sweep 1 over the
//     keys keeps the row max and sum online (from -inf; the first rescale's
//     exp(-inf - m) is 0, and a max of -inf is guarded); sweep 2 recomputes
//     S and forms p = exp(s - m) / l in fp32 before the bf16 cast. Masked
//     keys get the -1e9 fill with p NOT zeroed (an all-masked row averages
//     over its L keys); keys past L score -inf.

#pragma once

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "hopper.cuh"

namespace knn_attn {

using namespace knn_sm90;  // mbarriers, TMA, wgmma fences and descriptors

using bf16 = __nv_bfloat16;

constexpr int DK = 128;
constexpr int BK = 64;                   // keys per tile
constexpr int BOX = 64 * 64;             // one TMA box: 64 rows x 64 bf16
constexpr int BOX_BYTES = BOX * 2;       // 8 KB, eight 1024-byte swizzle atoms
constexpr float LOG2E = 1.4426950408889634f;
constexpr float NEG2 = -1e9f * LOG2E;    // the -1e9 fill, in exp2's scale

// ------------------------------------------------------------ PTX helpers
__device__ __forceinline__ float lds_f32(uint32_t addr) {
  float v;
  asm volatile("ld.shared.f32 %0, [%1];\n" : "=f"(v) : "r"(addr));
  return v;
}

__device__ __forceinline__ uint64_t lds_u64(uint32_t addr) {
  uint64_t v;
  asm volatile("ld.shared.u64 %0, [%1];\n" : "=l"(v) : "r"(addr));
  return v;
}

// one 64-row tile of a 4-d map {64 cols, L rows, 2 halves, B*H heads}:
// both d_kv halves, [half][row][64] in shared memory
__device__ __forceinline__ void tma_load(void* dst, const CUtensorMap* map,
                                         uint64_t* bar, int row, int bh) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%3, %4, %5, %6}], [%2];\n"
      :: "r"(smem_u32(dst)), "l"(reinterpret_cast<uint64_t>(map)),
         "r"(smem_u32(bar)), "r"(0), "r"(row), "r"(0), "r"(bh)
      : "memory");
}

// d[64 x 64] (+)= A[64 x 16] . B[16 x 64], both K-major in shared memory
__device__ __forceinline__ void wgmma_qk(float (&d)[32], uint64_t desc_a,
                                         uint64_t desc_b, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, "
      "%30, %31}, %32, %33, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31])
      : "l"(desc_a), "l"(desc_b), "r"(scale_d));
}

// d[64 x 128] += A[64 x 16] (registers) . B[16 x 128] (MN-major, shared)
__device__ __forceinline__ void wgmma_pv(float (&d)[64], const uint32_t (&a)[4],
                                         uint64_t desc_b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, "
      "%30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, "
      "%44, %45, %46, %47, %48, %49, %50, %51, %52, %53, %54, %55, %56, %57, "
      "%58, %59, %60, %61, %62, %63}, {%64, %65, %66, %67}, %68, p, 1, 1, 1;"
      "\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]),
        "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]),
        "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]), "+f"(d[49]),
        "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]),
        "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc_b), "r"(1));
}

// 2^x, one MUFU op (subnormal results flush to 0; exp2(-inf) = 0)
__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

// sum of 8 values as a tree; overwrites them
__device__ __forceinline__ float tree_sum(float (&v)[8]) {
#pragma unroll
  for (int w = 4; w >= 1; w /= 2)
#pragma unroll
    for (int j = 0; j < w; ++j) v[j] += v[j + w];
  return v[0];
}

__device__ __forceinline__ float quad_max(float v) {  // the 4 lanes of a row
  v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, 1));
  return fmaxf(v, __shfl_xor_sync(0xffffffffu, v, 2));
}

__device__ __forceinline__ float quad_sum(float v) {
  v += __shfl_xor_sync(0xffffffffu, v, 1);
  return v + __shfl_xor_sync(0xffffffffu, v, 2);
}

// ------------------------------------------------------------ the kernel
// Shared memory, from a 1024-byte aligned base: the k and v rings
// [slots][2 halves][64][64], their barriers (k full, k empty, v full,
// v empty), the key bits [n_tiles] and the scaled table window. A ring
// slot of 16 KB per tile; copies run up to `slots` tiles ahead.
template <int NWG>
__host__ __device__ constexpr int k_slots() {
  return 3;
}

template <int NWG>  // I: two blocks per SM must fit in shared memory
__host__ __device__ constexpr int v_slots() {
  return NWG == 2 ? 3 : 2;
}

template <int NWG>
__host__ __device__ constexpr int n_bars() {
  return 1 + 2 * k_slots<NWG>() + 2 * v_slots<NWG>();
}

template <int NWG>
__host__ __device__ constexpr int tiles_bytes() {
  return (NWG + k_slots<NWG>() + v_slots<NWG>()) * 2 * BOX_BYTES;
}

template <int NWG>
__host__ __device__ constexpr int window_len(int n_tiles) {
  return n_tiles * BK + 64 * NWG;
}

template <int NWG>
size_t smem_bytes(int l) {
  const int n_tiles = (l + BK - 1) / BK;
  return 1024 + tiles_bytes<NWG>() + 8 * n_bars<NWG>() + 8 * (size_t)n_tiles +
         4 * (size_t)window_len<NWG>(n_tiles);
}

// Steps: H takes one per key tile; I takes n_tiles of sweep 1 (k only),
// then n_tiles of sweep 2. Every step reads a k tile; a "PV step" (all of
// H's, I's sweep 2) also reads the v tile of the same key tile.
// A block starts its sweeps at key tile `rot` and wraps around: the blocks
// of one head then read different tiles at a time instead of all hitting
// the same lines of L2 together.
template <bool SHORT>
struct Steps {
  int n_tiles, count, rot;
  __device__ __forceinline__ int seq(int it) const {  // position in its sweep
    return SHORT && it >= n_tiles ? it - n_tiles : it;
  }
  __device__ __forceinline__ int tile(int it) const {
    const int i = seq(it) + rot;
    return i >= n_tiles ? i - n_tiles : i;
  }
  __device__ __forceinline__ bool pv(int it) const {
    return !SHORT || it >= n_tiles;
  }
};

// One consumer warpgroup's state: its 64 rows' output accumulator, row
// max (in exp2's scale) and sum, O's pending rescale and the bf16 P of the
// pending PV product; a lane holds rows rr0 and rr0 + 8.
template <int NWG, bool SHORT>
struct Consumer {
  Steps<SHORT> steps;
  uint32_t q_addr, k_base, v_base;
  // shared-memory addresses, 32 bits each
  uint32_t k_full, v_full, bits, tab;
  int l, t, rr0;
  float o[64];
  float m0, m1, l0, l1, c0, c1;
  uint32_t pa[BK / 16][4];

  // S(it) = Q.K^T over d_kv in 16-wide steps, q and k in shared memory; a
  // step's descriptors point 32 bytes further into the 128-byte swizzled
  // rows, 8 KB per d_kv half
  __device__ __forceinline__ void issue_qk(float (&s)[32], int it) {
    constexpr int KST = k_slots<NWG>();
    const int slot = it % KST;
    mbar_wait(k_full + 8 * slot, (it / KST) & 1);
    const uint32_t k_addr = k_base + slot * 2 * BOX_BYTES;
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < DK / 16; ++kk) {
      const uint32_t off = (kk / 4) * BOX_BYTES + (kk % 4) * 32;
      wgmma_qk(s, sw128_desc(q_addr + off, 16, 1024),
               sw128_desc(k_addr + off, 16, 1024), kk > 0);
    }
    wgmma_commit();
  }

  // O = c * O + bf16(P).V for step `it` (H rescales; I's p is final). v's
  // descriptor: 8-key groups 1024 bytes apart, d_kv halves 8 KB apart
  // (MN-major, transposed by the instruction).
  __device__ __forceinline__ void issue_pv(int it) {
    if (!SHORT) {
#pragma unroll
      for (int n = 0; n < DK / 8; ++n) {
        o[4 * n] *= c0;
        o[4 * n + 1] *= c0;
        o[4 * n + 2] *= c1;
        o[4 * n + 3] *= c1;
      }
    }
    constexpr int VST = v_slots<NWG>();
    const int j = steps.seq(it), slot = j % VST;
    mbar_wait(v_full + 8 * slot, (j / VST) & 1);
    const uint32_t v_addr = v_base + slot * 2 * BOX_BYTES;
    fence_regs(o);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < BK / 16; ++kk)
      wgmma_pv(o, pa[kk], sw128_desc(v_addr + kk * 2048, BOX_BYTES, 1024));
    wgmma_commit();
  }

  // The softmax of step `it` on its finished scores s: I's sweep 1 updates
  // the row max and sum; a PV step leaves fp32 p in s (and, for H, O's
  // rescale in c0, c1).
  __device__ __forceinline__ void softmax(int it, float (&s)[32]) {
    const bool pv = steps.pv(it);
    const int tile = steps.tile(it), k0 = tile * BK;
    // bias and mask, in exp2's scale: s * log2(e) + table, or the fill
    const uint64_t word = lds_u64(bits + 8 * tile);
    const bool full = word == ~0ull;  // every key of the tile real, kept
    const uint64_t mine = word >> (2 * t);
    const uint32_t bits_lo = static_cast<uint32_t>(mine);
    const uint32_t bits_hi = static_cast<uint32_t>(mine >> 32);
    const uint32_t tb0 = tab + 4 * (k0 + 2 * t - rr0 + 64 * NWG - 1);
    const int live = l - k0 - 2 * t;  // I: key offsets at or past it are > L
    if (full) {
#pragma unroll
      for (int j = 0; j < BK / 8; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int kl = 8 * j + (e & 1);
          s[4 * j + e] =
              fmaf(s[4 * j + e], LOG2E, lds_f32(tb0 + 4 * (kl - (e < 2 ? 0 : 8))));
        }
    } else {
#pragma unroll
      for (int j = 0; j < BK / 8; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int kl = 8 * j + (e & 1);
          const bool keep = ((j < 4 ? bits_lo : bits_hi) >> (kl & 31)) & 1u;
          float val =
              keep ? fmaf(s[4 * j + e], LOG2E,
                          lds_f32(tb0 + 4 * (kl - (e < 2 ? 0 : 8))))
                   : NEG2;
          if (SHORT && kl >= live) val = -INFINITY;
          s[4 * j + e] = val;
        }
    }
    // row maxima as trees (short dependency chains); I's sweep 2 takes
    // sweep 1's
    float r0[BK / 8], r1[BK / 8];
    if (SHORT && pv) {
      const float inv0 = 1.0f / l0, inv1 = 1.0f / l1;
#pragma unroll
      for (int j = 0; j < BK / 8; ++j) {
        s[4 * j] = ex2(s[4 * j] - m0) * inv0;
        s[4 * j + 1] = ex2(s[4 * j + 1] - m0) * inv0;
        s[4 * j + 2] = ex2(s[4 * j + 2] - m1) * inv1;
        s[4 * j + 3] = ex2(s[4 * j + 3] - m1) * inv1;
      }
      return;
    }
#pragma unroll
    for (int j = 0; j < BK / 8; ++j) {
      r0[j] = fmaxf(s[4 * j], s[4 * j + 1]);
      r1[j] = fmaxf(s[4 * j + 2], s[4 * j + 3]);
    }
#pragma unroll
    for (int w = BK / 16; w >= 1; w /= 2)
#pragma unroll
      for (int j = 0; j < w; ++j) {
        r0[j] = fmaxf(r0[j], r0[j + w]);
        r1[j] = fmaxf(r1[j], r1[j + w]);
      }
    float mx0 = fmaxf(m0, r0[0]), mx1 = fmaxf(m1, r1[0]);

    mx0 = quad_max(mx0);
    mx1 = quad_max(mx1);
    if (SHORT) {
      // I, sweep 1: online row max and sum. A max still at -inf would make
      // the rescale exp2(-inf + inf); the first rescale is exp2(-inf) = 0.
#pragma unroll
      for (int j = 0; j < BK / 8; ++j) {
        r0[j] = ex2(s[4 * j] - mx0) + ex2(s[4 * j + 1] - mx0);
        r1[j] = ex2(s[4 * j + 2] - mx1) + ex2(s[4 * j + 3] - mx1);
      }
      const float sum0 = tree_sum(r0), sum1 = tree_sum(r1);
      l0 = l0 * (mx0 == -INFINITY ? 1.0f : ex2(m0 - mx0)) + quad_sum(sum0);
      l1 = l1 * (mx1 == -INFINITY ? 1.0f : ex2(m1 - mx1)) + quad_sum(sum1);
    } else {
      // H: online softmax; a masked key's p is 0
      c0 = ex2(m0 - mx0);
      c1 = ex2(m1 - mx1);
#pragma unroll
      for (int j = 0; j < BK / 8; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int kl = 8 * j + (e & 1);
          const bool keep =
              full || (((j < 4 ? bits_lo : bits_hi) >> (kl & 31)) & 1u);
          s[4 * j + e] = keep ? ex2(s[4 * j + e] - (e < 2 ? mx0 : mx1)) : 0.0f;
        }
#pragma unroll
      for (int j = 0; j < BK / 8; ++j) {
        r0[j] = s[4 * j] + s[4 * j + 1];
        r1[j] = s[4 * j + 2] + s[4 * j + 3];
      }
      l0 = l0 * c0 + quad_sum(tree_sum(r0));
      l1 = l1 * c1 + quad_sum(tree_sum(r1));
    }
    m0 = mx0;
    m1 = mx1;
  }

  // p's C fragments are the A fragments of PV, 16 keys per step
  __device__ __forceinline__ void pack(const float (&s)[32]) {
#pragma unroll
    for (int kk = 0; kk < BK / 16; ++kk) {
      pa[kk][0] = pack_bf16(s[8 * kk], s[8 * kk + 1]);
      pa[kk][1] = pack_bf16(s[8 * kk + 2], s[8 * kk + 3]);
      pa[kk][2] = pack_bf16(s[8 * kk + 4], s[8 * kk + 5]);
      pa[kk][3] = pack_bf16(s[8 * kk + 6], s[8 * kk + 7]);
    }
  }
};

// Warp specialisation: NWG consumer warpgroups and one producer warp,
// whose lane 0 keeps q and the k and v rings loaded in the order the
// consumers need them, never holding up a consumer. The card charges a
// block registers by whole warpgroups, so a block of NWG * 128 + 32
// threads is charged as (NWG + 1) * 128: H (288 threads) gets 168
// registers a thread and one block per SM; I (160 threads) is capped at
// 128, so that two blocks fit per SM. A register cap, not launch bounds:
// __launch_bounds__(160, 2) would allow 204, and then one block fits.
template <int NWG, bool SHORT>
__global__ void __maxnreg__(SHORT ? 128 : 168)
attention_t5_kernel(const __grid_constant__ CUtensorMap q_map,
                    const __grid_constant__ CUtensorMap k_map,
                    const __grid_constant__ CUtensorMap v_map,
                    const uint8_t* __restrict__ mask,
                    const float* __restrict__ table, bf16* __restrict__ out,
                    int h_n, int l) {
  constexpr int BQ = 64 * NWG;
  constexpr int KST = k_slots<NWG>(), VST = v_slots<NWG>();
  extern __shared__ unsigned char smem_raw[];
  unsigned char* base =
      smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) & 1023);
  bf16* s_q = reinterpret_cast<bf16*>(base);
  bf16* s_k = s_q + NWG * 2 * BOX;
  bf16* s_v = s_k + KST * 2 * BOX;
  uint64_t* q_full = reinterpret_cast<uint64_t*>(base + tiles_bytes<NWG>());
  uint64_t* k_full = q_full + 1;
  uint64_t* k_empty = k_full + KST;
  uint64_t* v_full = k_empty + KST;
  uint64_t* v_empty = v_full + VST;
  const int n_tiles = (l + BK - 1) / BK;
  uint64_t* s_bits = q_full + n_bars<NWG>();
  float* s_tab = reinterpret_cast<float*>(s_bits + n_tiles);

  const int q0 = blockIdx.x * BQ, head = blockIdx.y, b = blockIdx.z;
  const int bh = b * h_n + head;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const Steps<SHORT> steps{n_tiles, SHORT ? 2 * n_tiles : n_tiles,
                           (int)(blockIdx.x * n_tiles / gridDim.x)};

  if (threadIdx.x == 0) {
    mbar_init(q_full, 1);
    for (int i = 0; i < KST; ++i) {
      mbar_init(&k_full[i], 1);
      mbar_init(&k_empty[i], 4 * NWG);
    }
    for (int i = 0; i < VST; ++i) {
      mbar_init(&v_full[i], 1);
      mbar_init(&v_empty[i], 4 * NWG);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (warp == 4 * NWG) {
    // ---- producer: q once, then k(it) for step it and the v of step
    // it - 1, in the order the consumers need them, each into its ring
    // slot once every consumer warp has released the slot's previous tile
    if (lane == 0) {
      tma_prefetch(&q_map);
      tma_prefetch(&k_map);
      tma_prefetch(&v_map);
      mbar_expect_tx(q_full, NWG * 2 * BOX_BYTES);
      for (int w = 0; w < NWG; ++w)
        tma_load(s_q + w * 2 * BOX, &q_map, q_full, q0 + 64 * w, bh);
      int v_next = 0;  // v tiles are counted in the order of the PV steps
      for (int it = 0; it <= steps.count; ++it) {
        if (it < steps.count) {
          const int slot = it % KST;
          mbar_wait(&k_empty[slot], ((it / KST) & 1) ^ 1);
          mbar_expect_tx(&k_full[slot], 2 * BOX_BYTES);
          tma_load(s_k + slot * 2 * BOX, &k_map, &k_full[slot],
                   steps.tile(it) * BK, bh);
        }
        if (it > 0 && steps.pv(it - 1)) {
          const int slot = v_next % VST;
          mbar_wait(&v_empty[slot], ((v_next / VST) & 1) ^ 1);
          mbar_expect_tx(&v_full[slot], 2 * BOX_BYTES);
          tma_load(s_v + slot * 2 * BOX, &v_map, &v_full[slot],
                   steps.tile(it - 1) * BK, bh);
          ++v_next;
        }
      }
    }
    return;
  }

  // ---- consumers: the table window and the key bits. s_tab[i] =
  // table[head, i + l - q0 - BQ] * log2(e); the score of (query r, key k)
  // takes s_tab[k - (r - q0) + BQ - 1]
  {
    const int win0 = l - q0 - BQ;
    const float* tb = table + (size_t)head * (2 * l - 1);
    const int n_win = window_len<NWG>(n_tiles);
#pragma unroll 4
    for (int i = threadIdx.x; i < n_win; i += NWG * 128) {
      const int j = win0 + i;
      s_tab[i] = (j >= 0 && j < 2 * l - 1) ? tb[j] * LOG2E : 0.0f;
    }
    const uint8_t* mb = mask + (size_t)b * l;
#pragma unroll 2
    for (int i = warp; i < n_tiles; i += 4 * NWG) {
      const int k_lo = i * BK + lane, k_hi = k_lo + 32;
      const uint32_t lo = __ballot_sync(0xffffffffu, k_lo < l && mb[k_lo]);
      const uint32_t hi = __ballot_sync(0xffffffffu, k_hi < l && mb[k_hi]);
      if (lane == 0) s_bits[i] = lo | (static_cast<uint64_t>(hi) << 32);
    }
    asm volatile("bar.sync 1, %0;\n" :: "n"(NWG * 128) : "memory");
  }

  const int wg = warp / 4;
  Consumer<NWG, SHORT> c;
  c.steps = steps;
  c.q_addr = smem_u32(s_q + wg * 2 * BOX);
  c.k_base = smem_u32(s_k);
  c.v_base = smem_u32(s_v);
  c.k_full = smem_u32(k_full);
  c.v_full = smem_u32(v_full);
  c.bits = smem_u32(s_bits);
  c.tab = smem_u32(s_tab);
  c.l = l;
  c.t = lane & 3;
  c.rr0 = 64 * wg + 16 * (warp % 4) + (lane >> 2);
#pragma unroll
  for (int i = 0; i < 64; ++i) c.o[i] = 0.0f;
  c.m0 = c.m1 = SHORT ? -INFINITY : NEG2;
  c.l0 = c.l1 = 0.0f;

  // Step it issues S(it), then PV(it - 1), and runs the softmax of S(it)
  // while the tensor cores sum PV(it - 1): FlashAttention-3's order, with
  // one score buffer.
  float s[32];
  mbar_wait(q_full, 0);
  for (int it = 0; it < steps.count; ++it) {
    const bool prev_pv = it > 0 && steps.pv(it - 1);
    c.issue_qk(s, it);
    if (prev_pv) {
      c.issue_pv(it - 1);
      wgmma_wait<1>();
    } else {
      wgmma_wait<0>();
    }
    fence_regs(s);
    if (lane == 0) mbar_arrive(&k_empty[it % KST]);  // k(it) is read
    c.softmax(it, s);
    if (prev_pv) {
      wgmma_wait<0>();
      fence_regs(c.o);
      if (lane == 0) mbar_arrive(&v_empty[steps.seq(it - 1) % VST]);
    }
    if (steps.pv(it)) c.pack(s);
  }
  c.issue_pv(steps.count - 1);  // the last step is always a PV step
  wgmma_wait<0>();
  fence_regs(c.o);

  const float d0 = SHORT ? 1.0f : fmaxf(c.l0, 1e-30f);
  const float d1 = SHORT ? 1.0f : fmaxf(c.l1, 1e-30f);
  const int r0 = q0 + c.rr0, r1 = r0 + 8;
  bf16* ob = out + (size_t)bh * l * DK;
#pragma unroll
  for (int n = 0; n < DK / 8; ++n) {
    const int col = 8 * n + 2 * c.t;
    if (r0 < l)
      *reinterpret_cast<uint32_t*>(ob + (size_t)r0 * DK + col) =
          pack_bf16(c.o[4 * n] / d0, c.o[4 * n + 1] / d0);
    if (r1 < l)
      *reinterpret_cast<uint32_t*>(ob + (size_t)r1 * DK + col) =
          pack_bf16(c.o[4 * n + 2] / d1, c.o[4 * n + 3] / d1);
  }
}

// ------------------------------------------------------------ host side
// A 4-d TMA map of a contiguous bf16 [B*H, L, 128] tensor seen as {64
// cols, L rows, 2 halves of d_kv, B*H}: one box is a 64-row tile, both
// halves, laid out [half][row][64] with the 128-byte swizzle; rows past L
// read as zeros.
inline bool make_map(CUtensorMap* map, const void* ptr, int l, int heads) {
  cuuint64_t dims[4] = {64, (cuuint64_t)l, 2, (cuuint64_t)heads};
  cuuint64_t strides[3] = {(cuuint64_t)DK * 2, 128, (cuuint64_t)l * DK * 2};
  cuuint32_t box[4] = {64, 64, 2, 1};
  cuuint32_t elem[4] = {1, 1, 1, 1};
  return cuTensorMapEncodeTiled(
             map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4, const_cast<void*>(ptr),
             dims, strides, box, elem, CU_TENSOR_MAP_INTERLEAVE_NONE,
             CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
             CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

// blocks of the kernel that fit on one SM at length l, or -1
template <int NWG, bool SHORT>
int blocks_per_sm(int l) {
  auto kernel = attention_t5_kernel<NWG, SHORT>;
  const size_t smem = smem_bytes<NWG>(l);
  int blocks = -1;
  if (cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                           (int)smem) != cudaSuccess ||
      cudaOccupancyMaxActiveBlocksPerMultiprocessor(
          &blocks, kernel, NWG * 128 + 32, smem) != cudaSuccess)
    return -1;
  return blocks;
}

template <int NWG, bool SHORT>
int launch(const void* q, const void* k, const void* v, const void* mask,
           const void* table, void* out, int b_n, int h_n, int l,
           cudaStream_t stream) {
  CUtensorMap maps[3];
  const void* ptrs[3] = {q, k, v};
  for (int i = 0; i < 3; ++i)
    if (reinterpret_cast<uintptr_t>(ptrs[i]) % 16 ||
        !make_map(&maps[i], ptrs[i], l, b_n * h_n))
      return (int)cudaErrorInvalidValue;
  auto kernel = attention_t5_kernel<NWG, SHORT>;
  const size_t smem = smem_bytes<NWG>(l);
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((l + 64 * NWG - 1) / (64 * NWG), h_n, b_n);
  kernel<<<grid, NWG * 128 + 32, smem, stream>>>(
      maps[0], maps[1], maps[2], static_cast<const uint8_t*>(mask),
      static_cast<const float*>(table), static_cast<bf16*>(out), h_n, l);
  return (int)cudaGetLastError();
}

}  // namespace knn_attn
