// Kernels D, E, F, J: packed segment-top-R candidates for approx top-k.
//
// Replace, in knn_for_homology_tpu/ops/exact_pallas.py (entries
// _packed_candidates_topk and _packed_candidates_topk_sq8, before their
// _decode_packed epilogue):
//   D  _segment_packed_kernel        q . db^T, fp32 or bf16 operands, fp32
//                                    sums (l2 as 2qd - |q|^2 - |d|^2);
//   E  _segment_packed_sq8_kernel    bf16 q . int8 db (widened exactly),
//                                    times the db row's scale; l2 as
//                                    2*s - |q|^2 - (sum(db^2) * sc) * sc;
//   F  _segment_packed_sq8sym_kernel int8 q . int8 db -> int32; sym2 adds
//                                    the residual query's dot:
//                                    (float(hi) + float(lo) * (1/128)) * sc.
//
// All three fill the same [Q, R*W] int32 buffer. Column c of the database
// belongs to lane c mod W and pass c / W. Each candidate is packed into one
// int32: (ordered_int(sim) & ~jmax) | (jmax - pass), jmax = 2^jbits - 1, so
// one compare orders by the truncated value and then by the earlier pass.
// Every lane keeps its R largest packed values, sorted descending; slot r
// of lane w sits at column r*W + w; empty slots hold INT_MIN and columns
// >= n never enter. Packed values are unique within a lane (distinct pass
// bits), so the insert needs no tie rule.
//
// J replaces knn_for_homology_tpu/ops/ivf_pallas.py:_indirect_sq8sym_kernel
// (entry _indirect_candidates, from ivf_union_topk): F over the IVF union
// without gathering it. Its database is virtual: column c is row c % 128 of
// cell cells[c / 128] of the packed slab table pv [C*128, d], and a column
// whose packed id is -1 (capacity padding) never enters. J is F's kernel
// with a row table (the template flag kInd), so the two cannot drift.
//
// F and J are bit-exact: |dot| <= d * 127^2 < 2^24 for d <= 1024, so int32
// -> f32 is exact, and lo * (1/128) is exact; the combine
// (hi + lo * (1/128)) * sc is written with _rn intrinsics, so no FMA
// contraction can reorder it. Int32 sums are exact in any order.
//
// What bounds them here: the products (2*Q*N*d operations; the [Q, N]
// similarity block never reaches device memory): FFMA for D and E, int8
// tensor cores for F and J. On the TPU the slots lived in VMEM across a
// sequential pass axis. Here a block owns BM queries x BN lanes and loops
// over ALL passes itself, so no cross-block merge is needed, and its slots
// live in shared memory (4 bytes each, BM*BN*R*4 bytes). Each thread keeps
// the R-th kept value of its (query, lane) pairs in registers, so a
// candidate costs one compare and only winners pay the insertion. When the
// slots do not fit (R > 25 for D and E; no workload plans it, but the
// recall bound and the R*W >= k doubling can) they move to the output
// buffer in device memory, as in kernel B.
//
// D and E (segment_packed): 32 queries x 64 lanes, 256 threads, register-
// tiled FFMA products staged 16 columns at a time.
//
// F and J (segment_packed_sym), on Hopper's int8 tensor cores: one
// consumer warpgroup computes a 64-query x BN-lane tile of int32 dots per
// pass with wgmma m64nBNk32 s8.s8 -> s32 (sym2: a second accumulator for
// the residual rows against the same db tile), both operands K-major rows
// (as int8 operands must be) in 128-byte-swizzled TMA boxes of 128
// columns. A producer warp's lane 0 keeps a ring of stages in flight.
// The block's query rows (and residuals) load once and stay in shared
// memory, and the ring streams only db rows, 8 KB a stage, as deep
// as the slots leave room for (BN = 32, or 16 where the slots of 32 leave
// fewer than 4 stages: sym2 at R = 9); 32-lane tiles also give a
// 1024-query block 128 blocks for the card's 132 SMs. Where resident rows
// do not fit (large d or R), each stage carries a box of query rows too
// (BN = 64). J's BN columns of a pass lie in one cell (BN divides 128), so
// one box at the cell's row covers them. Each thread owns the same
// accumulator positions on every pass: its kept minima stay in registers,
// and the scales and validity of its columns are loaded while the
// products run. The insert follows the products (see the kernel).

#include <cuda.h>
#include <limits.h>
#include <stdint.h>

#include <algorithm>

#include "hopper.cuh"
#include "knn_common.cuh"

namespace {

enum Variant { kF32 = 0, kBF16 = 1, kSQ8 = 2, kSym = 3, kSym2 = 4 };

// Insert `cand` (> slots[(r-1)*stride]) into a descending list of r slots;
// returns the new r-th value.
template <typename Ptr>
__device__ __forceinline__ int insert_slot(Ptr slots, size_t stride, int r,
                                           int cand) {
  int p = r - 1;
  while (p > 0) {
    const int pv = slots[(size_t)(p - 1) * stride];
    if (pv >= cand) break;
    slots[(size_t)p * stride] = pv;
    --p;
  }
  slots[(size_t)p * stride] = cand;
  return slots[(size_t)(r - 1) * stride];
}

// ------------------------------------------------------------ D and E
// shared memory for the slots of one block; a block's tiles add < 8 KB,
// inside the card's 227 KB per block
constexpr int kSlotSmemBytes = 200 * 1024;
// one block shape at every R: 32 queries (ops/exact_cuda.py:
// SEGMENT_PACKED_QUERIES) x 64 lanes, 2 x 4 (query, lane) pairs per thread
constexpr int kTM = 2, kTN = 4;

struct Params {
  const void* q;
  const void* db;
  const float* scales;
  int* buf;
  int q_n, n, d, w, r, jbits;
  bool l2, global_slots;
};

// sim[i][j] for the block's queries a0.. against db columns b0.. (the
// reference kernels' arithmetic, in their order of operations)
template <int TM, int TN, int V>
__device__ __forceinline__ void tile_sims(const Params& p, int a0, int b0,
                                          knn::TileSmem<TM, TN>& s,
                                          float (&sim)[TM][TN]) {
  const int tid = threadIdx.x;
  const int ty = tid / 16, tx = tid % 16;
  float acc[TM][TN];
  if constexpr (V == kF32) {
    knn::tile_dots<TM, TN>(static_cast<const float*>(p.q), p.q_n, a0,
                           static_cast<const float*>(p.db), p.n, b0, p.d,
                           p.l2, s, acc);
  } else if constexpr (V == kBF16) {
    knn::tile_dots<TM, TN>(static_cast<const __nv_bfloat16*>(p.q), p.q_n, a0,
                           static_cast<const __nv_bfloat16*>(p.db), p.n, b0,
                           p.d, p.l2, s, acc);
  } else {
    knn::tile_dots<TM, TN>(static_cast<const __nv_bfloat16*>(p.q), p.q_n, a0,
                           static_cast<const int8_t*>(p.db), p.n, b0, p.d,
                           p.l2, s, acc);
  }
#pragma unroll
  for (int i = 0; i < TM; ++i) {
    const int il = ty * TM + i;
#pragma unroll
    for (int j = 0; j < TN; ++j) {
      const int jl = tx * TN + j;
      if constexpr (V == kSQ8) {
        const int col = b0 + jl;
        const float sc = col < p.n ? p.scales[col] : 1.f;
        // _rn intrinsics: no FMA contraction, each step rounds as the
        // reference's separate f32 ops do
        float v = __fmul_rn(acc[i][j], sc);
        if (p.l2) {
          const float d_sq = __fmul_rn(__fmul_rn(s.b_sq[jl], sc), sc);
          v = __fsub_rn(__fsub_rn(2.f * v, s.a_sq[il]), d_sq);
        }
        sim[i][j] = v;
      } else {
        sim[i][j] = knn::tile_sim<TM, TN>(s, acc[i][j], il, jl, p.l2);
      }
    }
  }
}

template <int V>
__global__ void __launch_bounds__(knn::kThreads)
segment_packed(const Params p) {
  constexpr int TM = kTM, TN = kTN, BM = 16 * TM, BN = 16 * TN;
  extern __shared__ int slot_smem[];  // [R][BM][BN] unless global_slots
  __shared__ knn::TileSmem<TM, TN> s;
  const int tid = threadIdx.x;
  const int ty = tid / 16, tx = tid % 16;
  const int a0 = blockIdx.x * BM;
  const int lane0 = blockIdx.y * BN;
  const size_t width = (size_t)p.r * p.w;
  const int jmax = (int)((1u << p.jbits) - 1u);

  int kept_min[TM][TN];
#pragma unroll
  for (int i = 0; i < TM; ++i)
#pragma unroll
    for (int j = 0; j < TN; ++j) {
      kept_min[i][j] = INT_MIN;
      const int qi = a0 + ty * TM + i;
      if (p.global_slots && qi < p.q_n) {
        int* g = p.buf + (size_t)qi * width + lane0 + tx * TN + j;
        for (int r = 0; r < p.r; ++r) g[(size_t)r * p.w] = INT_MIN;
      }
    }
  if (!p.global_slots)
    for (int e = tid; e < BM * BN * p.r; e += knn::kThreads)
      slot_smem[e] = INT_MIN;
  __syncthreads();

  const int passes = (p.n + p.w - 1) / p.w;
  for (int pass = 0; pass < passes; ++pass) {
    const int b0 = pass * p.w + lane0;
    float sim[TM][TN];
    tile_sims<TM, TN, V>(p, a0, b0, s, sim);
#pragma unroll
    for (int i = 0; i < TM; ++i) {
      const int il = ty * TM + i;
      if (a0 + il >= p.q_n) continue;
#pragma unroll
      for (int j = 0; j < TN; ++j) {
        const int jl = tx * TN + j;
        if (b0 + jl >= p.n) continue;  // columns past n never enter
        const int cand =
            (knn::ordered_int(sim[i][j]) & ~jmax) | (jmax - pass);
        if (cand <= kept_min[i][j]) continue;
        if (p.global_slots) {
          kept_min[i][j] = insert_slot(
              p.buf + (size_t)(a0 + il) * width + lane0 + jl, (size_t)p.w,
              p.r, cand);
        } else {
          kept_min[i][j] = insert_slot(slot_smem + il * BN + jl,
                                       (size_t)(BM * BN), p.r, cand);
        }
      }
    }
  }
  if (p.global_slots) return;
  __syncthreads();
  // coalesced copy-out: consecutive threads write consecutive lanes
  for (int e = tid; e < BM * BN * p.r; e += knn::kThreads) {
    const int jl = e % BN, il = (e / BN) % BM, r = e / (BM * BN);
    if (a0 + il < p.q_n)
      p.buf[(size_t)(a0 + il) * width + (size_t)r * p.w + lane0 + jl] =
          slot_smem[e];
  }
}

// The slot route by R: shared memory while a block's slots fit
// kSlotSmemBytes (R <= 25), else the output buffer in device memory.
template <int V>
cudaError_t launch(Params p, cudaStream_t stream) {
  constexpr int BM = 16 * kTM, BN = 16 * kTN;
  p.global_slots = (size_t)BM * BN * p.r * sizeof(int) > kSlotSmemBytes;
  const size_t smem = p.global_slots ? 0 : (size_t)BM * BN * p.r * sizeof(int);
  auto kernel = segment_packed<V>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  const dim3 grid((p.q_n + BM - 1) / BM, p.w / BN);
  kernel<<<grid, knn::kThreads, smem, stream>>>(p);
  return cudaGetLastError();
}

// ------------------------------------------------------------ F and J
namespace sym {

using namespace knn_sm90;

constexpr int BM = 64;             // queries per block: one warpgroup
constexpr int KC = 128;            // int8 columns a box: one swizzled row
constexpr int THREADS = 128 + 32;  // the consumer warpgroup + producer warp
constexpr int MAX_STAGES = 16;
constexpr int RESIDENT_STAGE = 8192;  // db bytes a stage, resident route
constexpr int MIN_RESIDENT_STAGES = 4;
constexpr size_t SMEM_LIMIT = 227 * 1024;
constexpr int A_BYTES = BM * KC;   // one box of query rows, 8 KB
// a warp's winners held before an insert round: up to 31 left over and 32
// more from one accumulator position
constexpr int QUEUE = 64;

struct SymParams {
  const float* scales;  // F: [n]; J: [C*128], per packed row
  const int* cells;     // J: [n / 128] the cell of each slot
  const int* ids;       // J: [C*128] packed ids, -1 padding
  int* buf;
  int q_n, n, d, w, r, jbits;
  // the launch's plan (plan_for): boxes of 128 columns a pass, ring
  // stages and their bytes, bytes of the resident query rows, slots in
  // device memory
  int chunks, stages, stage_bytes, a_bytes;
  bool global_slots;
};

// F's and J's similarity: (hi + lo / 128) * sc in this order, each step
// rounded on its own.
template <bool kTwo>
__device__ __forceinline__ float sym_sim(int hi, int lo, float sc) {
  float v = (float)hi;
  if (kTwo) v = __fadd_rn(v, __fmul_rn((float)lo, 1.f / 128.f));
  return __fmul_rn(v, sc);
}

// d[64 x BN] += A[64 x 32] . B[32 x BN], int8 -> int32, both K-major in
// shared memory; BN = 16, 32 or 64
__device__ __forceinline__ void wgmma_s8(int (&d)[8], uint64_t desc_a,
                                         uint64_t desc_b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %10, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n16k32.s32.s8.s8 "
      "{%0, %1, %2, %3, %4, %5, %6, %7}, %8, %9, p;\n}\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3]), "+r"(d[4]),
        "+r"(d[5]), "+r"(d[6]), "+r"(d[7])
      : "l"(desc_a), "l"(desc_b), "r"(1));
}

__device__ __forceinline__ void wgmma_s8(int (&d)[16], uint64_t desc_a,
                                         uint64_t desc_b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %18, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k32.s32.s8.s8 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, "
      "%15}, %16, %17, p;\n}\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3]), "+r"(d[4]),
        "+r"(d[5]), "+r"(d[6]), "+r"(d[7]), "+r"(d[8]), "+r"(d[9]),
        "+r"(d[10]), "+r"(d[11]), "+r"(d[12]), "+r"(d[13]), "+r"(d[14]),
        "+r"(d[15])
      : "l"(desc_a), "l"(desc_b), "r"(1));
}

__device__ __forceinline__ void wgmma_s8(int (&d)[32], uint64_t desc_a,
                                         uint64_t desc_b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k32.s32.s8.s8 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, "
      "%30, %31}, %32, %33, p;\n}\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3]), "+r"(d[4]),
        "+r"(d[5]), "+r"(d[6]), "+r"(d[7]), "+r"(d[8]), "+r"(d[9]),
        "+r"(d[10]), "+r"(d[11]), "+r"(d[12]), "+r"(d[13]), "+r"(d[14]),
        "+r"(d[15]), "+r"(d[16]), "+r"(d[17]), "+r"(d[18]), "+r"(d[19]),
        "+r"(d[20]), "+r"(d[21]), "+r"(d[22]), "+r"(d[23]), "+r"(d[24]),
        "+r"(d[25]), "+r"(d[26]), "+r"(d[27]), "+r"(d[28]), "+r"(d[29]),
        "+r"(d[30]), "+r"(d[31])
      : "l"(desc_a), "l"(desc_b), "r"(1));
}

// first db row of pass `pass`'s BN columns (F: the column itself; J: its
// row in the slab table, all BN in one cell)
template <bool kInd>
__device__ __forceinline__ int tile_row(const SymParams& p, int c0) {
  return kInd ? p.cells[c0 >> 7] * 128 + (c0 & 127) : c0;
}

// Insert one queued winner: `key` = il * BN + jl of the tile, into the
// block's shared slots or its rows of the output buffer.
template <int BN>
__device__ __forceinline__ void insert_winner(const SymParams& p, int* slots,
                                              int a0, int lane0, int key,
                                              int cand) {
  if (p.global_slots)
    insert_slot(p.buf + (size_t)(a0 + key / BN) * p.r * p.w + lane0 + key % BN,
                (size_t)p.w, p.r, cand);
  else
    insert_slot(slots + key, (size_t)(BM * BN), p.r, cand);
}

// Shared memory, from a 1024-byte aligned base: the resident query rows
// [chunks][q | q_lo] (BN < 64), the ring [stages] of stage_bytes (BN < 64:
// 64 / BN db boxes; BN = 64: one box each of q, q_lo and db), the full and
// empty barriers of the ring and the resident rows' barrier, each consumer
// warp's queue of winners [4][keys, values][QUEUE], then the slots
// [R][BM][BN] unless global_slots. Maps: q (and q_lo) {d, q_n} in 128 x 64
// boxes, db {d, rows} in 128 x BN boxes; boxes past d (the resident route
// rounds a pass's boxes up to whole stages) and rows past the tables
// arrive as zeros.
//
// The insert. A pass's winners (candidates above their pair's R-th kept
// value) are rare after the first passes but spread over the warp: one
// per-thread insert loop would cost the whole warp R steps for each of its
// pairs that any lane wins. Each (query, lane) pair gets one candidate a
// pass, so a pass's winners touch distinct slot lists: a warp compacts
// them into its queue (ballot + prefix count) and inserts 32 at a time,
// one per lane; then each owner re-reads the R-th value of the pairs it
// won.
template <int BN, bool kTwo, bool kInd>
__global__ void __launch_bounds__(THREADS)
segment_packed_sym(const __grid_constant__ CUtensorMap q_map,
                   const __grid_constant__ CUtensorMap lo_map,
                   const __grid_constant__ CUtensorMap db_map,
                   const SymParams p) {
  constexpr bool RESIDENT = BN < 64;
  constexpr int SB = RESIDENT ? RESIDENT_STAGE / (BN * KC) : 1;  // db boxes
  constexpr int NJ = BN / 8;  // 8-column groups of the accumulator
  constexpr int A_STRIDE = A_BYTES * (kTwo ? 2 : 1);
  constexpr int B_BOX = BN * KC;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* base =
      smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) & 1023);
  const int S = p.stages;
  unsigned char* ring_p = base + p.a_bytes;
  uint64_t* full = reinterpret_cast<uint64_t*>(ring_p + S * p.stage_bytes);
  uint64_t* empty = full + S;
  uint64_t* a_full = empty + S;
  int* queues = reinterpret_cast<int*>(a_full + 1);
  int* slots = queues + 4 * 2 * QUEUE;

  const int a0 = blockIdx.x * BM, lane0 = blockIdx.y * BN;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int passes = (p.n + p.w - 1) / p.w;
  const int steps = p.chunks / SB;  // ring stages a pass

  if (threadIdx.x == 0) {
    for (int i = 0; i < S; ++i) {
      mbar_init(&full[i], 1);
      mbar_init(&empty[i], 4);  // one arrival per consumer warp
    }
    mbar_init(a_full, 1);
    mbar_init_fence();
  }
  __syncthreads();

  if (warp == 4) {
    // ---- producer: the resident query rows once, then every pass's
    // stages in order, each into the next ring slot once the consumers
    // have released the slot's previous stage
    if (lane == 0) {
      tma_prefetch(&q_map);
      if (kTwo) tma_prefetch(&lo_map);
      tma_prefetch(&db_map);
      if (RESIDENT) {
        mbar_expect_tx(a_full, p.a_bytes);
        for (int kc = 0; kc < p.chunks; ++kc) {
          tma_load_2d(base + kc * A_STRIDE, &q_map, a_full, kc * KC, a0);
          if (kTwo)
            tma_load_2d(base + kc * A_STRIDE + A_BYTES, &lo_map, a_full,
                        kc * KC, a0);
        }
      }
      int s = 0, phase = 0;
      for (int pass = 0; pass < passes; ++pass) {
        const int row0 = tile_row<kInd>(p, pass * p.w + lane0);
        for (int j = 0; j < steps; ++j) {
          mbar_wait(&empty[s], phase ^ 1);
          mbar_expect_tx(&full[s], p.stage_bytes);
          unsigned char* stage = ring_p + s * p.stage_bytes;
          if (RESIDENT) {
#pragma unroll
            for (int b = 0; b < SB; ++b)
              tma_load_2d(stage + b * B_BOX, &db_map, &full[s],
                          (j * SB + b) * KC, row0);
          } else {
            tma_load_2d(stage, &q_map, &full[s], j * KC, a0);
            if (kTwo)
              tma_load_2d(stage + A_BYTES, &lo_map, &full[s], j * KC, a0);
            tma_load_2d(stage + A_STRIDE, &db_map, &full[s], j * KC, row0);
          }
          if (++s == S) {
            s = 0;
            phase ^= 1;
          }
        }
      }
    }
    return;
  }

  // ---- the consumer warpgroup. A lane holds rows il0 and il0 + 8 of the
  // tile, columns 8 j + 2 t (+1): acc[4 j + e] is row il0 + 8 (e / 2),
  // column 8 j + 2 t + e % 2.
  const int t = lane & 3;
  const int il0 = 16 * warp + (lane >> 2);
  const bool live[2] = {a0 + il0 < p.q_n, a0 + il0 + 8 < p.q_n};
  const size_t width = (size_t)p.r * p.w;
  const int jmax = (int)((1u << p.jbits) - 1u);
  const unsigned below = (1u << lane) - 1u;  // lanes before this one
  int* q_key = queues + warp * 2 * QUEUE;
  int* q_val = q_key + QUEUE;

  int kept[NJ][4];
#pragma unroll
  for (int j = 0; j < NJ; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      kept[j][e] = INT_MIN;
      const int il = il0 + 8 * (e >> 1), jl = 8 * j + 2 * t + (e & 1);
      if (p.global_slots) {
        if (live[e >> 1])
          for (int r = 0; r < p.r; ++r)
            p.buf[(size_t)(a0 + il) * width + (size_t)r * p.w + lane0 + jl] =
                INT_MIN;
      } else {
        for (int r = 0; r < p.r; ++r) slots[(r * BM + il) * BN + jl] = INT_MIN;
      }
    }

  const uint32_t a_base = smem_u32(base), ring = smem_u32(ring_p);
  if (RESIDENT) mbar_wait(a_full, 0);
  int s = 0, phase = 0;
  for (int pass = 0; pass < passes; ++pass) {
    const int c0 = pass * p.w + lane0;
    // this pass's scales and validity of the thread's columns, in flight
    // while the products run
    float sc[NJ][2];
    bool ok[NJ][2];
    const int row0 = tile_row<kInd>(p, c0);
#pragma unroll
    for (int j = 0; j < NJ; ++j)
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int jl = 8 * j + 2 * t + h;
        if (kInd) {
          sc[j][h] = p.scales[row0 + jl];
          ok[j][h] = p.ids[row0 + jl] >= 0;
        } else {
          ok[j][h] = c0 + jl < p.n;
          sc[j][h] = ok[j][h] ? p.scales[c0 + jl] : 1.f;
        }
      }

    int acc[BN / 2], lo[BN / 2];
#pragma unroll
    for (int i = 0; i < BN / 2; ++i) acc[i] = lo[i] = 0;
    int prev = 0;
    for (int j = 0; j < steps; ++j) {
      mbar_wait(smem_u32(&full[s]), phase);
      const uint32_t st = ring + s * p.stage_bytes;
      fence_regs(acc);
      if (kTwo) fence_regs(lo);
      wgmma_fence();
#pragma unroll
      for (int b = 0; b < SB; ++b) {
        const uint32_t qa = RESIDENT ? a_base + (j * SB + b) * A_STRIDE : st;
        const uint32_t da = RESIDENT ? st + b * B_BOX : st + A_STRIDE;
        // a k32 step moves 32 bytes into the swizzled 128-byte rows
#pragma unroll
        for (int kk = 0; kk < KC / 32; ++kk) {
          const uint64_t db_desc = sw128_desc(da + kk * 32, 16, 1024);
          wgmma_s8(acc, sw128_desc(qa + kk * 32, 16, 1024), db_desc);
          if (kTwo)
            wgmma_s8(lo, sw128_desc(qa + A_BYTES + kk * 32, 16, 1024),
                     db_desc);
        }
      }
      wgmma_commit();
      wgmma_wait<1>();  // the previous stage's products are done
      fence_regs(acc);
      if (kTwo) fence_regs(lo);
      if (j > 0 && lane == 0) mbar_arrive(&empty[prev]);
      prev = s;
      if (++s == S) {
        s = 0;
        phase ^= 1;
      }
    }
    wgmma_wait<0>();
    fence_regs(acc);
    if (kTwo) fence_regs(lo);
    if (lane == 0) mbar_arrive(&empty[prev]);

    // this pass's winners through the warp's queue (n entries, warp-wide)
    int n = 0;
    unsigned won = 0;  // bit 4 j + e: this thread's pair (j, e) won
#pragma unroll
    for (int j = 0; j < NJ; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        // rows past q_n and masked columns (past n, J's padding) never enter
        int cand = INT_MIN;
        if (live[e >> 1] && ok[j][e & 1])
          cand = (knn::ordered_int(sym_sim<kTwo>(acc[4 * j + e],
                                                 lo[4 * j + e],
                                                 sc[j][e & 1])) &
                  ~jmax) |
                 (jmax - pass);
        const bool win = cand > kept[j][e];
        const unsigned mask = __ballot_sync(0xffffffffu, win);
        if (win) {
          const int at = n + __popc(mask & below);
          q_key[at] = (il0 + 8 * (e >> 1)) * BN + 8 * j + 2 * t + (e & 1);
          q_val[at] = cand;
          won |= 1u << (4 * j + e);
        }
        n += __popc(mask);
        if (n >= 32) {  // a full queue: one insert per lane
          __syncwarp();
          n -= 32;
          insert_winner<BN>(p, slots, a0, lane0, q_key[n + lane],
                            q_val[n + lane]);
          __syncwarp();
        }
      }
    __syncwarp();
    if (lane < n)
      insert_winner<BN>(p, slots, a0, lane0, q_key[lane], q_val[lane]);
    __syncwarp();
    // the new R-th kept value of each pair this thread won
#pragma unroll
    for (int j = 0; j < NJ; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        if (!((won >> (4 * j + e)) & 1u)) continue;
        const int il = il0 + 8 * (e >> 1), jl = 8 * j + 2 * t + (e & 1);
        kept[j][e] =
            p.global_slots
                ? p.buf[(size_t)(a0 + il) * width + (size_t)(p.r - 1) * p.w +
                        lane0 + jl]
                : slots[((p.r - 1) * BM + il) * BN + jl];
      }
  }
  if (p.global_slots) return;
  asm volatile("bar.sync 1, 128;\n" ::: "memory");  // the consumers only
  // coalesced copy-out: consecutive threads write consecutive lanes
  for (int e = threadIdx.x; e < BM * BN * p.r; e += 128) {
    const int jl = e % BN, il = (e / BN) % BM, r = e / (BM * BN);
    if (a0 + il < p.q_n)
      p.buf[(size_t)(a0 + il) * width + (size_t)r * p.w + lane0 + jl] =
          slots[e];
  }
}

// bytes of a launch's shared memory beside its ring: the alignment slack,
// the barriers, the queues, the resident rows and the slots
size_t fixed_bytes(const SymParams& p, int bn) {
  return 1024 + 16 * MAX_STAGES + 8 + 4 * 2 * QUEUE * sizeof(int) + p.a_bytes +
         (p.global_slots ? 0 : (size_t)BM * bn * p.r * sizeof(int));
}

// The launch's plan, filled into p; returns the lane tile BN.
//   * Resident (BN = 32, or 16 when the slots of 32 leave fewer than 4
//     stages): the block's query rows (and residuals) load once and stay
//     in shared memory, and the ring streams 8 KB stages of db rows only,
//     as deep as the rest of the 227 KB allows.
//   * Streamed (BN = 64), where resident rows do not fit (large d or R):
//     each stage is one box of query rows, residuals and db rows; slots in
//     device memory when two stages do not fit beside them.
int plan_for(SymParams& p, bool two) {
  const int boxes = (p.d + KC - 1) / KC;
  const int a_stride = A_BYTES * (two ? 2 : 1);
  p.global_slots = false;
  for (int bn : {32, 16}) {
    const int sb = RESIDENT_STAGE / (bn * KC);
    p.chunks = (boxes + sb - 1) / sb * sb;
    p.a_bytes = p.chunks * a_stride;
    p.stage_bytes = RESIDENT_STAGE;
    const size_t fixed = fixed_bytes(p, bn);
    if (fixed + (size_t)MIN_RESIDENT_STAGES * RESIDENT_STAGE <= SMEM_LIMIT) {
      p.stages = (int)std::min<size_t>(MAX_STAGES,
                                       (SMEM_LIMIT - fixed) / RESIDENT_STAGE);
      return bn;
    }
  }
  p.chunks = boxes;
  p.a_bytes = 0;
  p.stage_bytes = a_stride + 64 * KC;
  if (fixed_bytes(p, 64) + 2 * (size_t)p.stage_bytes > SMEM_LIMIT)
    p.global_slots = true;
  p.stages = (int)std::min<size_t>(
      MAX_STAGES, (SMEM_LIMIT - fixed_bytes(p, 64)) / p.stage_bytes);
  return 64;
}

template <int BN, bool kTwo, bool kInd>
cudaError_t launch(const CUtensorMap (&maps)[3], const SymParams& p,
                   cudaStream_t stream) {
  const size_t smem = fixed_bytes(p, BN) + (size_t)p.stages * p.stage_bytes;
  auto kernel = segment_packed_sym<BN, kTwo, kInd>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  const dim3 grid((p.q_n + BM - 1) / BM, p.w / BN);
  kernel<<<grid, THREADS, smem, stream>>>(maps[0], maps[1], maps[2], p);
  return cudaGetLastError();
}

template <bool kTwo, bool kInd>
cudaError_t launch_any(const void* q, const void* q_lo, const void* db,
                       int db_rows, SymParams p, cudaStream_t stream) {
  const int bn = plan_for(p, kTwo);
  CUtensorMap maps[3];
  const CUtensorMapDataType u8 = CU_TENSOR_MAP_DATA_TYPE_UINT8;
  if (!make_map_2d(&maps[0], q, u8, 1, p.q_n, p.d, KC, BM) ||
      (kTwo && !make_map_2d(&maps[1], q_lo, u8, 1, p.q_n, p.d, KC, BM)) ||
      !make_map_2d(&maps[2], db, u8, 1, db_rows, p.d, KC, bn))
    return cudaErrorInvalidValue;
  if (!kTwo) maps[1] = maps[0];
  switch (bn) {
    case 16: return launch<16, kTwo, kInd>(maps, p, stream);
    case 32: return launch<32, kTwo, kInd>(maps, p, stream);
    default: return launch<64, kTwo, kInd>(maps, p, stream);
  }
}

}  // namespace sym

}  // namespace

// variant: 0 D fp32, 1 D bf16, 2 E (bf16 q, int8 db), 3 F sym, 4 F sym2.
// d counts columns; F needs d % 16 == 0 (TMA rows of whole 16 bytes).
extern "C" int knn_segment_packed(const void* q, const void* q_lo,
                                  const void* db, const float* scales,
                                  int* buf, int q_n, int n, int d, int w,
                                  int r, int jbits, int variant, int l2,
                                  cudaStream_t stream) {
  const bool sq8 = variant >= kSQ8, sym = variant >= kSym;
  if (w < 64 || w % 64 != 0 || r < 1 || q_n < 1 || n < 1 || d < 1 ||
      jbits < 1 || jbits > 30 || variant < kF32 || variant > kSym2 ||
      (sq8 && scales == nullptr) || (variant == kSym2 && q_lo == nullptr) ||
      (sym && (l2 || d % 16 != 0)))
    return (int)cudaErrorInvalidValue;
  if (sym) {
    sym::SymParams p{};
    p.scales = scales;
    p.buf = buf;
    p.q_n = q_n, p.n = n, p.d = d, p.w = w, p.r = r, p.jbits = jbits;
    return variant == kSym2
               ? (int)sym::launch_any<true, false>(q, q_lo, db, n, p, stream)
               : (int)sym::launch_any<false, false>(q, q_lo, db, n, p, stream);
  }
  Params p{q, db, scales, buf, q_n, n, d, w, r, jbits, l2 != 0, false};
  switch (variant) {
    case kF32: return (int)launch<kF32>(p, stream);
    case kBF16: return (int)launch<kBF16>(p, stream);
    default: return (int)launch<kSQ8>(p, stream);
  }
}

// Kernel J. pv [table_rows = C*128, d] int8 slabs, scales and ids
// [C*128] (per packed row), cells [budget] the cell of each slot; the
// virtual database has n = budget * 128 columns, W = e * 128 lanes and
// budget / e passes. Cell ids must lie in [0, C). q (and q_lo when
// two_level) int8 [q_n, d], d % 16 == 0.
extern "C" int knn_ivf_indirect(const void* q, const void* q_lo,
                                const void* pv, const float* scales,
                                const int* ids, const int* cells, int* buf,
                                int q_n, int budget, int table_rows, int d,
                                int w, int r, int jbits, int two_level,
                                cudaStream_t stream) {
  if (w < 128 || w % 128 != 0 || budget < 1 || (budget * 128) % w != 0 ||
      r < 1 || q_n < 1 || d < 16 || d % 16 != 0 || jbits < 1 || jbits > 30 ||
      table_rows < 128 || (two_level && q_lo == nullptr) ||
      cells == nullptr || ids == nullptr)
    return (int)cudaErrorInvalidValue;
  sym::SymParams p{};
  p.scales = scales;
  p.cells = cells;
  p.ids = ids;
  p.buf = buf;
  p.q_n = q_n, p.n = budget * 128, p.d = d, p.w = w, p.r = r;
  p.jbits = jbits;
  return two_level
             ? (int)sym::launch_any<true, true>(q, q_lo, pv, table_rows, p,
                                                stream)
             : (int)sym::launch_any<false, true>(q, q_lo, pv, table_rows, p,
                                                 stream);
}
