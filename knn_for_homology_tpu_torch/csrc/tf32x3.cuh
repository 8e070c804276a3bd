// The fp32-accurate tensor-core product of kernel B (segment_topr.cu):
// 3xTF32 wgmma on fp32 rows, sm_90a only.
//
// The reference computes these dots at Precision.HIGHEST, so a single TF32
// product (10 explicit mantissa bits) is out. Each operand is split as
// x = big + small, big = tf32_rna(x), small = tf32_rna(x - big), and a dot
// is big.big + big.small + small.big (small.small, ~2^-22 of |x||y|, is
// dropped) with fp32 accumulators: about fp32's own rounding at d = 1024,
// on the tensor cores at a third of the TF32 rate. Data with at most 11
// significant bits (small integers, bf16 rows) has small = 0, and its
// products are exact. (Kernel A keeps an FFMA product: flat_topk.cu says
// why.)
//
// One consumer warpgroup computes a 64-query x 64-row tile of q . db^T,
// wgmma m64n64k8 .tf32 -> f32. Query rows do not stay in shared memory (64
// rows x d = 1024 fp32 = 256 KB), so every stage of the ring carries one
// 32-column chunk of the block's query rows and of the tile's db rows,
// 128-byte swizzled TMA boxes; a producer warp's lane 0 keeps the ring
// full. The tile's 64 db rows may come from several row ranges (B: the
// same lanes in several passes), so that each query chunk serves them all.
//
// Where the split happens. A wrapper pre-pass writing big / small copies
// of both operands would cost two more database copies per call (2 x 537
// MB at 131072 x 1024) and twice the bytes each stage brings in. So the
// consumer warpgroup splits each stage as it lands. The query chunk (the
// wgmma A operand, 64 rows) goes to registers, in wgmma's A fragment
// layout, and is split there: no shared-memory copy of it is written or
// read back by the tensor cores (split in shared memory, it tripled a
// stage's shared traffic). The db chunk (operand B, which wgmma reads from
// shared memory) is split in place: big over the TMA data, small behind it
// at the same offsets (the split is elementwise, so it keeps the swizzle).
//
// Order of the products: a stage's four k steps (32 columns) add
// big.small, small.big, big.big of each to a register tile that the
// stage's first product starts afresh; the tile joins the fp32
// accumulator with one rounded add (tile_products says why).
#pragma once

#include <cuda.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "hopper.cuh"

namespace knn_tf32 {

using namespace knn_sm90;

constexpr int BM = 64;             // query rows of a tile: one warpgroup
constexpr int BOX = 128;           // bytes of a box row: 32 fp32 columns
constexpr int COLS = BOX / 4;      // columns a stage
constexpr int THREADS = 128 + 32;  // the consumer warpgroup + producer warp
constexpr int MAX_STAGES = 8;
constexpr int SMEM_LIMIT = 227 * 1024;
constexpr int Q_BOX = BM * BOX;    // one chunk of the query rows, 8 KB
// the 1024-byte alignment slack and the ring's full / empty barriers
constexpr int RING_FIXED = 1024 + 2 * 8 * MAX_STAGES;

constexpr int TILE_ROWS = 64;      // db rows of a tile: wgmma N
constexpr int DB_BOX = TILE_ROWS * BOX;
constexpr int RAW = Q_BOX + DB_BOX;  // TMA bytes a stage
// a stage: [q raw][db raw -> big][db small]
constexpr int STAGE_BYTES = RAW + DB_BOX;

__host__ __device__ constexpr size_t ring_bytes(int stages) {
  return RING_FIXED + (size_t)stages * STAGE_BYTES;
}

// the 128 consumer threads only (the producer warp has returned)
__device__ __forceinline__ void consumer_sync() {
  asm volatile("bar.sync 1, 128;\n" ::: "memory");
}

// x rounded to tf32 (10 explicit mantissa bits), to nearest, ties away
// from zero: cvt.rna.tf32.f32 for finite x, in two integer operations
// (type conversions run at a quarter of the integer rate on sm_90, and
// through them the split held B back more than its products did)
__device__ __forceinline__ float tf32_rna(float x) {
  return __uint_as_float((__float_as_uint(x) + 0x1000u) & 0xFFFFE000u);
}

// x -> big in place; returns small
__device__ __forceinline__ float4 split4(float4& x) {
  float4 s;
  float* v = reinterpret_cast<float*>(&x);
  float* o = reinterpret_cast<float*>(&s);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float big = tf32_rna(v[i]);
    o[i] = tf32_rna(__fsub_rn(v[i], big));
    v[i] = big;
  }
  return s;
}

// d[64 x N] += A[64 x 8] . B[8 x N]: A tf32 in registers (a[i] holds row
// 16 warp + lane / 4 + 8 (i % 2), column lane % 4 + 4 (i / 2)), B tf32
// K-major in shared memory (one 32-byte k step of the swizzled 128-byte
// rows)
__device__ __forceinline__ void wgmma_tf32(float (&d)[32],
                                           const uint32_t (&a)[4],
                                           uint64_t b, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k8.f32.tf32.tf32 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, "
      "%12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31}, "
      "{%32, %33, %34, %35}, %36, p, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(scale_d));
}

// the query fragments of one stage: [big, small][k step][a0 .. a3]
using Frags = uint32_t[2][4][4];

// keeps the compiler from reusing a fragment's registers while the wgmma
// that reads them may still run
__device__ __forceinline__ void fence_frags(Frags& f) {
#pragma unroll
  for (int h = 0; h < 2; ++h)
#pragma unroll
    for (int kk = 0; kk < 4; ++kk)
#pragma unroll
      for (int i = 0; i < 4; ++i) asm volatile("" : "+r"(f[h][kk][i])::"memory");
}

struct Ring {
  unsigned char* ptr;  // stage 0, 1024-byte aligned
  uint64_t* full;
  uint64_t* empty;
  int stages, s, phase;

  __device__ __forceinline__ void advance() {
    if (++s == stages) {
      s = 0;
      phase ^= 1;
    }
  }
};

// Lays the ring out from the dynamic shared memory; returns the first byte
// after it (the kernel's own data). Thread 0 initialises the barriers; the
// caller's __syncthreads() publishes them.
__device__ __forceinline__ unsigned char* ring_setup(unsigned char* smem_raw,
                                                     int stages, Ring& r) {
  r.ptr = smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) & 1023);
  r.full = reinterpret_cast<uint64_t*>(r.ptr + stages * STAGE_BYTES);
  r.empty = r.full + stages;
  r.stages = stages;
  r.s = r.phase = 0;
  if (threadIdx.x == 0) {
    for (int i = 0; i < stages; ++i) {
      mbar_init(&r.full[i], 1);
      mbar_init(&r.empty[i], 4);  // one arrival per consumer warp
    }
    mbar_init_fence();
  }
  return reinterpret_cast<unsigned char*>(r.empty + stages);
}

// Producer (one thread): for tile t = 0 .. tiles-1, the chunks of the
// block's query rows (from row a0) and of PB boxes of 64 / PB db rows, box
// b from row first_row + t * step + b * box_step. Maps: q {d, q_n} and db
// {d, rows}, boxes of 32 columns x 64 / (64 / PB) rows; rows and columns
// past either edge arrive as zeros.
template <int PB>
__device__ __forceinline__ void produce(const CUtensorMap* q_map,
                                        const CUtensorMap* db_map, Ring& r,
                                        int a0, int tiles, int chunks,
                                        int first_row, int step,
                                        int box_step) {
  tma_prefetch(q_map);
  tma_prefetch(db_map);
  for (int t = 0; t < tiles; ++t) {
    const int row0 = first_row + t * step;
    for (int j = 0; j < chunks; ++j) {
      mbar_wait(&r.empty[r.s], r.phase ^ 1);
      mbar_expect_tx(&r.full[r.s], RAW);
      unsigned char* st = r.ptr + r.s * STAGE_BYTES;
      tma_load_2d(st, q_map, &r.full[r.s], j * COLS, a0);
#pragma unroll
      for (int b = 0; b < PB; ++b)
        tma_load_2d(st + Q_BOX + b * (TILE_ROWS / PB) * BOX, db_map,
                    &r.full[r.s], j * COLS, row0 + b * box_step);
      r.advance();
    }
  }
}

constexpr int ACC = TILE_ROWS / 2;  // accumulators a thread

// One stage of tile_products, its query fragments in set F (the other set
// may still be read by the previous stage's products).
template <int F>
__device__ __forceinline__ void product_stage(Ring& r, int j, int& prev,
                                              Frags (&fr)[2],
                                              float (&acc)[ACC],
                                              float (&part)[ACC]) {
  const int lane = threadIdx.x % 32, g = lane >> 2, t = lane & 3;
  const int row = 16 * (threadIdx.x / 32) + g;  // and row + 8; row % 8 == g
  mbar_wait(smem_u32(&r.full[r.s]), r.phase);
  unsigned char* st = r.ptr + r.s * STAGE_BYTES;
  // db rows: big in place, small behind them
  float4* raw = reinterpret_cast<float4*>(st + Q_BOX);
  float4* small = reinterpret_cast<float4*>(st + RAW);
#pragma unroll
  for (int i = threadIdx.x; i < DB_BOX / 16; i += 128) {
    float4 x = raw[i];
    small[i] = split4(x);
    raw[i] = x;
  }
  // query fragments: element (row, c) of the swizzled box sits at byte
  // row * 128 + (((c / 4) ^ (row % 8)) * 16) + (c % 4) * 4
#pragma unroll
  for (int kk = 0; kk < 4; ++kk)
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int off = (row + 8 * (i & 1)) * BOX +
                      (((2 * kk + (i >> 1)) ^ g) << 4) + 4 * t;
      const float x = *reinterpret_cast<const float*>(st + off);
      const float big = tf32_rna(x);
      fr[F][0][kk][i] = __float_as_uint(big);
      fr[F][1][kk][i] = __float_as_uint(tf32_rna(__fsub_rn(x, big)));
    }
  fence_async_shared();  // the db split is read by wgmma (the async proxy)
  consumer_sync();
  if (j > 0) {  // the previous stage's products are done: add, release
    wgmma_wait<0>();
    fence_regs(part);
    fence_frags(fr[F ^ 1]);
#pragma unroll
    for (int i = 0; i < ACC; ++i) acc[i] = __fadd_rn(acc[i], part[i]);
    if (lane == 0) mbar_arrive(&r.empty[prev]);
  }
  fence_regs(part);
  wgmma_fence();
  const uint32_t db = smem_u32(st + Q_BOX);
#pragma unroll
  for (int kk = 0; kk < 4; ++kk) {
    wgmma_tf32(part, fr[F][0][kk], sw128_desc(db + DB_BOX + kk * 32, 16, 1024),
               kk > 0);
    wgmma_tf32(part, fr[F][1][kk], sw128_desc(db + kk * 32, 16, 1024), 1);
    wgmma_tf32(part, fr[F][0][kk], sw128_desc(db + kk * 32, 16, 1024), 1);
  }
  wgmma_commit();
  prev = r.s;
  r.advance();
}

// Consumer warpgroup: one tile's dots over `chunks` stages into acc. A lane
// holds rows il0 and il0 + 8 of the tile (il0 = 16 warp + lane / 4) and
// columns 8 j + 2 (lane % 4) (+1): acc[4 j + e] is row il0 + 8 (e / 2),
// column 8 j + 2 (lane % 4) + e % 2.
//
// The tensor cores' fp32 accumulation aligns its addends to the largest
// and truncates, so a long wgmma chain drifts towards zero by up to an ulp
// of the running sum a product. Each stage's
// products therefore start afresh in a register tile (scale-d 0), and the
// tile joins acc with one rounded fp32 add. Stage j's products run while
// stage j+1 is split (its query fragments in the other register set); the
// add waits for them. (Adding stage j's tile only after issuing stage
// j+1's, from a second tile, makes ptxas serialise every wgmma, C7514.)
__device__ __forceinline__ void tile_products(Ring& r, int chunks,
                                              float (&acc)[ACC]) {
  float part[ACC];
  Frags fr[2];
#pragma unroll
  for (int i = 0; i < ACC; ++i) acc[i] = 0.f;
  int prev = 0, j = 0;
  for (; j + 1 < chunks; j += 2) {
    product_stage<0>(r, j, prev, fr, acc, part);
    product_stage<1>(r, j + 1, prev, fr, acc, part);
  }
  if (j < chunks) product_stage<0>(r, j, prev, fr, acc, part);
  wgmma_wait<0>();
  fence_regs(part);
  fence_frags(fr[0]);
  fence_frags(fr[1]);
#pragma unroll
  for (int i = 0; i < ACC; ++i) acc[i] = __fadd_rn(acc[i], part[i]);
  if (threadIdx.x % 32 == 0) mbar_arrive(&r.empty[prev]);
}

// A 2-d TMA map of a row-major fp32 [rows, cols] matrix in boxes of 32
// columns x box_rows (cols % 4 == 0: rows of whole 16 bytes)
inline bool make_f32_map(CUtensorMap* map, const float* ptr, int rows,
                         int cols, int box_rows) {
  return make_map_2d(map, ptr, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, 4, rows, cols,
                     COLS, box_rows);
}

}  // namespace knn_tf32
