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
// contraction can reorder it. Int32 sums are exact in any order. D and E
// sum fp32 in another order than the reference (bit-equal where the dots
// are exact, as on small-integer data); their epilogues (l2's
// 2qd - |q|^2 - |d|^2, E's scale) keep the reference's order of _rn steps.
//
// What bounds them: the products (2*Q*N*d operations; the [Q, N]
// similarity block never reaches device memory), and for F and J the
// insert as much (see below). On the TPU the slots
// lived in VMEM across a sequential pass axis. Here a block owns BM
// queries x BN lanes and loops over ALL passes itself, so no cross-block
// merge is needed, and its slots live in shared memory (4 bytes each,
// BM*BN*R*4 bytes). Each thread keeps the R-th kept value of its (query,
// lane) pairs in registers, so a candidate costs one compare and only
// winners pay the insertion. When the slots do not fit (large R; no
// workload plans it, but the recall bound and the R*W >= k doubling can)
// they move to the output buffer in device memory, as in kernel B.
//
// D with fp32 operands (segment_packed): 32 queries x 64 lanes, 256
// threads, register-tiled FFMA products staged 16 columns at a time. It
// stays on FFMA: TF32 products would change fp32 results (the reference
// sums these at Precision.HIGHEST), as for kernel A.
//
// D bf16, E, F and J (segment_packed_mma), on Hopper's tensor cores: one
// consumer warpgroup computes a 64-query x BN-lane tile of dots per pass
// with wgmma m64nBNk16 bf16.bf16 -> f32 (D, E) or m64nBNk32 s8.s8 -> s32
// (F, J; sym2: a second accumulator for the residual rows against the
// same db tile), both operands K-major rows in 128-byte-swizzled TMA boxes
// (64 bf16 or 128 int8 columns). A producer warp's lane 0 keeps a ring of
// stages in flight. The block's query rows (and residuals) load once and
// stay in shared memory, and the ring streams only db rows, 8 KB a stage,
// as deep as the slots leave room for (BN = 32, or 16 where the slots of
// 32 leave fewer than 4 stages); 32-lane tiles also give a 1024-query
// block 128 blocks for the card's 132 SMs. Where resident rows do not fit
// (large d or R), each stage carries the chunk's query rows too (BN =
// 64). J's BN columns of a pass lie in one cell (BN divides 128), so one
// box at the cell's row covers them. Each thread owns the same
// accumulator positions on every pass: its kept minima stay in registers,
// and the scales, norms and validity of its columns are loaded while the
// products run. The insert follows the products (see the kernel).
//
// F and J, several passes a product (the plan's P, plan_group; P = 1 is
// the schedule above, which D and E always keep). Timed with scratch
// builds at F's all-vs-all shape [1024 x 131072 x 1024, W 256, R 7], one
// pass took 3.9 us: the products and the ring 0.66, the insert the rest,
// one warp per SM partition running a dependent chain (16 ballots, then
// per-lane walks of up to R shared-memory steps) that nothing hid. So:
//   * Two consumer warpgroups, each owning BN / 2 of the block's lanes
//     (twice the warps to hide latency, half the candidates each).
//   * P consecutive passes of a warpgroup's lanes are one B operand: the
//     stage holds, for each box along d, its P boxes of BN / 2 db rows
//     stacked, and one chain of wgmma m64n(P*BN/2)k32 computes P passes;
//     pass i owns accumulator columns [i BN/2, (i + 1) BN/2).
//   * Two accumulator sets: group h's products go into one, stage by
//     stage, while after each stage the warps enter the next pass of group
//     h - 1 from the other (its products retired with all but the last
//     stage), in pass order. Only wgmma defines the sets (a group's first
//     k step sets scale_d = 0) and no divergent branch reads them, else
//     ptxas serialises the products.
//   * The insert (enter_grouped): all candidates scored and compared
//     first, one prefix count of the warp's winners, queue rounds in which
//     a lane rewrites a whole list of 8 or 16 slots with min/max (no
//     predicate chains), the owner re-reading the R-th value it won.
// A pass's packed values are those of one pass a product, and int32 sums
// are exact in any order, so F's and J's buffers are the same bits at any
// P.
//
// E's int8 db rows widen to bf16 exactly (|x| <= 127). Of the two ways to
// feed them to a bf16 wgmma (a bf16 copy of each stage in shared memory,
// or db rows as the register operand A with the queries as B), E takes
// the copy: the register route would swap the tile's roles (db rows on
// the 64 accumulator rows), and with them the insert's layout, the slot
// routing and the resident query rows that D, F and J share. The consumer
// warpgroup widens each 128-column int8 box into two swizzled bf16 boxes
// (three such buffers, so one barrier a box orders the copy against the
// products still reading the buffer two boxes back), then runs the
// products on them; the ring stage is released as soon as it is copied.

#include <cuda.h>
#include <cuda_bf16.h>
#include <limits.h>
#include <stdint.h>

#include <algorithm>
#include <type_traits>

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

// ------------------------------------------------------------ D (fp32)
// shared memory for the slots of one block; a block's tiles add < 8 KB,
// inside the card's 227 KB per block
constexpr int kSlotSmemBytes = 200 * 1024;
// one block shape at every R: 32 queries (ops/exact_cuda.py:
// F32_PACKED_QUERIES) x 64 lanes, 2 x 4 (query, lane) pairs per thread
constexpr int kTM = 2, kTN = 4;

struct Params {
  const float* q;
  const float* db;
  int* buf;
  int q_n, n, d, w, r, jbits;
  int nv;  // columns >= nv never enter (min(n, n_valid)); passes are n's
  bool l2, global_slots;
};

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
    float acc[TM][TN];
    knn::tile_dots<TM, TN>(p.q, p.q_n, a0, p.db, p.n, b0, p.d, p.l2, s, acc);
#pragma unroll
    for (int i = 0; i < TM; ++i) {
      const int il = ty * TM + i;
      if (a0 + il >= p.q_n) continue;
#pragma unroll
      for (int j = 0; j < TN; ++j) {
        const int jl = tx * TN + j;
        if (b0 + jl >= p.nv) continue;  // columns past nv never enter
        const float sim = knn::tile_sim<TM, TN>(s, acc[i][j], il, jl, p.l2);
        const int cand = (knn::ordered_int(sim) & ~jmax) | (jmax - pass);
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
cudaError_t launch_f32(Params p, cudaStream_t stream) {
  constexpr int BM = 16 * kTM, BN = 16 * kTN;
  p.global_slots = (size_t)BM * BN * p.r * sizeof(int) > kSlotSmemBytes;
  const size_t smem = p.global_slots ? 0 : (size_t)BM * BN * p.r * sizeof(int);
  cudaError_t err = cudaFuncSetAttribute(
      segment_packed, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  const dim3 grid((p.q_n + BM - 1) / BM, p.w / BN);
  segment_packed<<<grid, knn::kThreads, smem, stream>>>(p);
  return cudaGetLastError();
}

// ------------------------------------------------ D bf16, E, F and J
namespace mma {

using namespace knn_sm90;

constexpr int BM = 64;             // queries per block: one warpgroup
constexpr int BOX = 128;           // bytes of a box row: one swizzled row
// the consumer warpgroups (P passes a product: two, each owning half the
// block's lanes) and the producer warp
__host__ __device__ constexpr int consumer_groups(int P) {
  return P > 1 ? 2 : 1;
}
__host__ __device__ constexpr int threads_of(int P) {
  return 128 * consumer_groups(P) + 32;
}
constexpr int MAX_STAGES = 16;
constexpr int RESIDENT_STAGE = 8192;  // db bytes a stage, resident route
constexpr int MIN_RESIDENT_STAGES = 4;
constexpr size_t SMEM_LIMIT = 227 * 1024;
constexpr int A_BYTES = BM * BOX;  // one box of query rows, 8 KB
// a warp's winners held before an insert round: up to 31 left over and 32
// more from one accumulator position (P passes a product: a window of the
// pass's winners)
constexpr int QUEUE = 64;
constexpr int CONV_BUFS = 3;       // E's widened boxes in flight
// several passes a product (F and J on resident rows): at most MAX_GROUP
// passes, as many as two sets of GROUP_ACC accumulator registers a thread
// allow (one set takes the next group's products while the thread enters
// the other's passes), MIN_GROUP_STAGES stages in the ring, R <= MAX_FAST_R
// (a list holds 8 or MAX_FAST_R slots, each insert rewrites all of them)
constexpr int MAX_GROUP = 4;
constexpr int GROUP_ACC = 32;
constexpr int MIN_GROUP_STAGES = 3;
constexpr int MAX_FAST_R = 16;

// the operands of a variant: bytes of a query and of a db element, query
// boxes per db box (E: two bf16 boxes cover one 128-column int8 box), the
// sym2 residual operand, E's widening copy, integer accumulators
__host__ __device__ constexpr int q_elem(int v) {
  return v == kBF16 || v == kSQ8 ? 2 : 1;
}
__host__ __device__ constexpr int db_elem(int v) { return v == kBF16 ? 2 : 1; }
__host__ __device__ constexpr int q_boxes(int v) {
  return q_elem(v) / db_elem(v);
}
__host__ __device__ constexpr bool two(int v) { return v == kSym2; }
__host__ __device__ constexpr bool widens(int v) { return v == kSQ8; }
__host__ __device__ constexpr int a_stride(int v) {
  return A_BYTES * q_boxes(v) * (two(v) ? 2 : 1);
}
// E's buffers of widened db boxes: CONV_BUFS x two bf16 boxes of bn rows
__host__ __device__ constexpr int conv_bytes(int v, int bn) {
  return widens(v) ? CONV_BUFS * q_boxes(v) * bn * BOX : 0;
}
// passes a product a variant takes at lane tile bn on resident rows: int8
// only (D's and E's fp32 sums keep one pass a product), as many as
// GROUP_ACC registers of a warpgroup's bn / 2 lanes hold (sym2 holds a
// residual set beside each)
__host__ __device__ constexpr int max_group(int v, int bn) {
  return v < kSym || bn == 64 ? 1
         : GROUP_ACC / (bn / 4 * (two(v) ? 2 : 1)) < MAX_GROUP
             ? GROUP_ACC / (bn / 4 * (two(v) ? 2 : 1))
             : MAX_GROUP;
}

struct MmaParams {
  const float* scales;  // E, F: [n]; J: [C*128], per packed row
  const float* q_sq;    // D, E l2: [q_n] squared query norms
  const float* d_sq;    // D, E l2: [n] squared db row norms (E: of codes)
  const int* cells;     // J: [n / 128] the cell of each slot
  const int* ids;       // J: [C*128] packed ids, -1 padding
  int* buf;
  int q_n, n, d, w, r, jbits;
  int nv;  // D, E, F: columns >= nv never enter (J: nv = n)
  bool l2;
  // the launch's plan (plan_for): db boxes along d a pass, ring stages and
  // their bytes, bytes of the resident query rows, slots in device memory;
  // passes a product and, when that is more than one, db boxes along d a
  // stage; slots a list holds in shared memory (R, or with several passes
  // a product 8 or MAX_FAST_R, of which the first R are read)
  int chunks, stages, stage_bytes, a_bytes;
  bool global_slots;
  int group, sb, rb;
};

// F's and J's similarity: (hi + lo / 128) * sc in this order, each step
// rounded on its own.
template <bool kTwo>
__device__ __forceinline__ float sym_sim(int hi, int lo, float sc) {
  float v = (float)hi;
  if (kTwo) v = __fadd_rn(v, __fmul_rn((float)lo, 1.f / 128.f));
  return __fmul_rn(v, sc);
}

// D's and E's similarity, in the reference kernels' order of operations:
// D dot, or 2 dot - |q|^2 - |d|^2; E dot * sc, or 2 (dot * sc) - |q|^2 -
// (sum(db^2) * sc) * sc
template <int V>
__device__ __forceinline__ float float_sim(float dot, float sc, float q_sq,
                                           float d_sq, bool l2) {
  float v = V == kSQ8 ? __fmul_rn(dot, sc) : dot;
  if (l2) {
    const float dn = V == kSQ8 ? __fmul_rn(__fmul_rn(d_sq, sc), sc) : d_sq;
    v = __fsub_rn(__fsub_rn(2.f * v, q_sq), dn);
  }
  return v;
}

// d[64 x N] += A[64 x k] . B[k x N], both K-major in shared memory, one
// 32-byte k step: int8 -> int32 (k32) or bf16 -> f32 (k16); N = 16, 32
// or 64. int8 with scale_d = 0: d = A . B, the old sums ignored.
__device__ __forceinline__ void wgmma(int (&d)[8], uint64_t a, uint64_t b,
                                      int scale_d = 1) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %10, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n16k32.s32.s8.s8 "
      "{%0, %1, %2, %3, %4, %5, %6, %7}, %8, %9, p;\n}\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3]), "+r"(d[4]),
        "+r"(d[5]), "+r"(d[6]), "+r"(d[7])
      : "l"(a), "l"(b), "r"(scale_d));
}

__device__ __forceinline__ void wgmma(int (&d)[16], uint64_t a, uint64_t b,
                                      int scale_d = 1) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %18, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k32.s32.s8.s8 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, "
      "%15}, %16, %17, p;\n}\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3]), "+r"(d[4]),
        "+r"(d[5]), "+r"(d[6]), "+r"(d[7]), "+r"(d[8]), "+r"(d[9]),
        "+r"(d[10]), "+r"(d[11]), "+r"(d[12]), "+r"(d[13]), "+r"(d[14]),
        "+r"(d[15])
      : "l"(a), "l"(b), "r"(scale_d));
}

__device__ __forceinline__ void wgmma(int (&d)[32], uint64_t a, uint64_t b,
                                      int scale_d = 1) {
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
      : "l"(a), "l"(b), "r"(scale_d));
}

__device__ __forceinline__ void wgmma(float (&d)[8], uint64_t a, uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %10, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n16k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7}, %8, %9, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7])
      : "l"(a), "l"(b), "r"(1));
}

__device__ __forceinline__ void wgmma(float (&d)[16], uint64_t a, uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %18, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, "
      "%15}, %16, %17, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15])
      : "l"(a), "l"(b), "r"(1));
}

__device__ __forceinline__ void wgmma(float (&d)[32], uint64_t a, uint64_t b) {
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
      : "l"(a), "l"(b), "r"(1));
}

// the N consumer threads only (the producer warp has returned)
template <int N>
__device__ __forceinline__ void consumer_sync() {
  asm volatile("bar.sync 1, %0;\n" :: "n"(N) : "memory");
}

// E: one int8 box [BN rows][128 columns] of the ring -> two bf16 boxes
// [BN rows][64 columns] in `dst`, exactly, in the 128-byte swizzle (16-byte
// chunk c of row r sits at chunk c ^ (r % 8)) that both TMA and the wgmma
// descriptors use; by the 128 consumer threads.
template <int BN>
__device__ __forceinline__ void widen_box(const unsigned char* src,
                                          unsigned char* dst, int tid) {
#pragma unroll
  for (int i = 0; i < BN * 8 / 128; ++i) {
    const int u = tid + 128 * i;
    const int r = u >> 3, c = u & 7, x = r & 7;
    const int4 v = *reinterpret_cast<const int4*>(src + r * BOX + ((c ^ x) << 4));
    const int8_t* b = reinterpret_cast<const int8_t*>(&v);
    uint32_t w[8];
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      const __nv_bfloat162 h =
          __floats2bfloat162_rn((float)b[2 * i], (float)b[2 * i + 1]);
      w[i] = *reinterpret_cast<const uint32_t*>(&h);
    }
    unsigned char* row = dst + (c >> 2) * (BN * BOX) + r * BOX;
    const int lc = 2 * (c & 3);  // the two 8-column bf16 chunks of chunk c
    *reinterpret_cast<int4*>(row + ((lc ^ x) << 4)) =
        make_int4(w[0], w[1], w[2], w[3]);
    *reinterpret_cast<int4*>(row + (((lc + 1) ^ x) << 4)) =
        make_int4(w[4], w[5], w[6], w[7]);
  }
}

// first db row of the BN columns from column c0 (F: the column itself; J:
// its row in the slab table, all BN in one cell)
template <bool kInd>
__device__ __forceinline__ int tile_row(const MmaParams& p, int c0) {
  return kInd ? p.cells[c0 >> 7] * 128 + (c0 & 127) : c0;
}

// Insert one queued winner: `key` = il * BN + jl of the tile, into the
// block's shared slots or its rows of the output buffer.
template <int BN>
__device__ __forceinline__ void insert_winner(const MmaParams& p, int* slots,
                                              int a0, int lane0, int key,
                                              int cand) {
  if (p.global_slots)
    insert_slot(p.buf + (size_t)(a0 + key / BN) * p.r * p.w + lane0 + key % BN,
                (size_t)p.w, p.r, cand);
  else
    insert_slot(slots + key, (size_t)(BM * BN), p.r, cand);
}

// Insert `cand` into the descending list of RB shared slots from `list`
// (its smallest value drops out): slot r takes max(v[r], min(v[r - 1],
// cand)). No predicate and no chain from slot to slot: every slot is
// loaded and stored at once.
template <int BN, int RB>
__device__ __forceinline__ void insert_minmax(int* list, int cand) {
  int v[RB];
#pragma unroll
  for (int r = 0; r < RB; ++r) v[r] = list[r * BM * BN];
#pragma unroll
  for (int r = 0; r < RB; ++r)
    list[r * BM * BN] = max(v[r], r == 0 ? cand : min(v[r - 1], cand));
}

// One pass of a product group into the shared slots (P > 1). All the
// thread's candidates are scored and held against their pair's R-th value
// first (rows past q_n hold INT_MAX there and never win); one prefix count
// over the warp (a ballot per bit of each lane's count) places its winners
// in lane order, QUEUE at a time in the warp's queue, one insert_minmax
// per entry; each owner then re-reads the R-th value of the pairs it won.
// No branch but the uniform ones: a divergent one around a read of the
// sums would make ptxas serialise the products in flight, and around the
// queue's stores it costs the warp a reconvergence each. hi (sym2: and
// lo): the pass's sums over the warpgroup's TN lanes from cw0 of the
// block's BN, in the accumulator's order; sc_l, id_l: the pass's scale
// (J: and packed id) of the warpgroup's column lane, read through the
// warp; c0: the pass's first column of the warpgroup.
template <int BN, int TN, bool kTwo, bool kInd>
__device__ __forceinline__ void enter_grouped(
    const MmaParams& p, int* slots, int* q_key, int* q_val,
    int (&kept)[TN / 8][4], const int (&hi)[TN / 2], const int (&lo)[TN / 2],
    float sc_l, int id_l, int pass, int c0, int cw0, int il0, int t,
    int lane, int jmax) {
  constexpr int NJ = TN / 8;
  int cand[NJ][4];
  unsigned m = 0;  // bit 4 j + e: this thread's pair (j, e) wins
#pragma unroll
  for (int j = 0; j < NJ; ++j)
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int jl = 8 * j + 2 * t + h;
      const float sc = __shfl_sync(0xffffffffu, sc_l, jl);
      // masked columns (past n, J's padding) never enter
      const bool ok = kInd ? __shfl_sync(0xffffffffu, id_l, jl) >= 0
                           : c0 + jl < p.nv;
#pragma unroll
      for (int e = h; e < 4; e += 2) {
        const int a = 4 * j + e;
        cand[j][e] =
            (knn::ordered_int(sym_sim<kTwo>(hi[a], lo[a], sc)) & ~jmax) |
            (jmax - pass);
        m |= (unsigned)(ok && cand[j][e] > kept[j][e]) << a;
      }
    }
  // the warp's winners before this lane's and in all (counts <= 16)
  const int count = __popc(m);
  const unsigned below = (1u << lane) - 1u;
  int first = 0, total = 0;
#pragma unroll
  for (int b = 0; b < 5; ++b) {
    const unsigned bits = __ballot_sync(0xffffffffu, (count >> b) & 1);
    first += __popc(bits & below) << b;
    total += __popc(bits) << b;
  }
  for (int w0 = 0; w0 < total; w0 += QUEUE) {
    int at = first - w0;
#pragma unroll
    for (int j = 0; j < NJ; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const unsigned win = (m >> (4 * j + e)) & 1u;
        if (win && (unsigned)at < (unsigned)QUEUE) {
          q_key[at] =
              (il0 + 8 * (e >> 1)) * BN + cw0 + 8 * j + 2 * t + (e & 1);
          q_val[at] = cand[j][e];
        }
        at += win;
      }
    __syncwarp();
    const int n = min(QUEUE, total - w0);
    for (int k = lane; k < n; k += 32) {
      if (p.rb == 8)
        insert_minmax<BN, 8>(slots + q_key[k], q_val[k]);
      else
        insert_minmax<BN, MAX_FAST_R>(slots + q_key[k], q_val[k]);
    }
    __syncwarp();
  }
#pragma unroll
  for (int j = 0; j < NJ; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e)
      if ((m >> (4 * j + e)) & 1u)
        kept[j][e] = slots[((p.r - 1) * BM + il0 + 8 * (e >> 1)) * BN + cw0 +
                           8 * j + 2 * t + (e & 1)];
}

// product groups the grouped loop issues: one a group of P passes, and one
// past the last (it issues a group ahead of the one it enters)
__host__ __device__ __forceinline__ int issued_groups(int passes, int P) {
  return (passes + P - 1) / P + 1;
}

// Shared memory, from a 1024-byte aligned base: the resident query rows
// [chunks][q boxes | q_lo] (BN < 64), E's widened boxes [CONV_BUFS][2][BN
// rows x 128 bytes], the ring [stages] of stage_bytes (BN < 64, one pass a
// product: 8 KB of db boxes; P passes a product: [sb boxes along d][2
// warpgroups][P passes][BN / 2 rows x 128 bytes], a warpgroup's P boxes
// one B tile; BN = 64: one chunk's query boxes, residuals and db box), the
// full and empty barriers of the ring and the resident rows' barrier, each
// consumer warp's queue of winners [warps][keys, values][QUEUE], then the
// slots [rb][BM][BN] unless global_slots. Maps: q (and q_lo) {d, q_n} in
// boxes of 128 bytes x 64 rows, db {d, rows} in boxes of 128 bytes x BN
// rows (P passes a product: BN / 2); boxes past d (the resident route
// rounds a pass's boxes up to whole stages) and rows past the tables
// arrive as zeros.
//
// The insert, one pass a product (D, E; F and J where the plan takes P =
// 1). A pass's winners (candidates above their pair's R-th kept value) are
// rare after the first passes but spread over the warp: one per-thread
// insert loop would cost the whole warp R steps for each of its pairs that
// any lane wins. Each (query, lane) pair gets one candidate a pass, so a
// pass's winners touch distinct slot lists: a warp compacts them into its
// queue (ballot + prefix count) and inserts 32 at a time, one per lane;
// then each owner re-reads the R-th value of the pairs it won.
//
// P passes a product (F, J; two consumer warpgroups, each of TN = BN / 2
// lanes): group h's products go into accumulator set h % 2 stage by
// stage, and after each stage the warps enter the passes of group h - 1
// due by then (set (h - 1) % 2, complete once the stage is issued and all
// but it retired), in pass order, each through enter_grouped. The tensor
// cores work on group h while the warps insert.
template <int BN, int V, bool kInd, int P>
__global__ void __launch_bounds__(threads_of(P), 1)
segment_packed_mma(const __grid_constant__ CUtensorMap q_map,
                   const __grid_constant__ CUtensorMap lo_map,
                   const __grid_constant__ CUtensorMap db_map,
                   const MmaParams p) {
  constexpr bool RESIDENT = BN < 64;
  constexpr bool kTwo = two(V), WIDEN = widens(V);
  static_assert(P == 1 || (V >= kSym && RESIDENT), "P > 1: int8, resident");
  constexpr int QB = q_boxes(V);
  constexpr int DB_COLS = BOX / db_elem(V);  // db columns a box
  constexpr int Q_COLS = BOX / q_elem(V);    // query columns a box
  constexpr int B_BOX = BN * BOX;
  constexpr int SB = RESIDENT ? RESIDENT_STAGE / B_BOX : 1;  // db boxes
  constexpr int WGS = consumer_groups(P);
  constexpr int TN = BN / WGS;  // lanes a consumer warpgroup owns
  constexpr int T_BOX = TN * BOX;
  constexpr int NJ = TN / 8;  // 8-column groups of the accumulator
  constexpr int A_STRIDE = a_stride(V);
  using Acc = typename std::conditional<(V >= kSym), int, float>::type;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* base =
      smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) & 1023);
  const int S = p.stages;
  unsigned char* conv_p = base + p.a_bytes;
  unsigned char* ring_p = conv_p + conv_bytes(V, BN);
  uint64_t* full = reinterpret_cast<uint64_t*>(ring_p + S * p.stage_bytes);
  uint64_t* empty = full + S;
  uint64_t* a_full = empty + S;
  int* queues = reinterpret_cast<int*>(a_full + 1);
  int* slots = queues + 4 * WGS * 2 * QUEUE;

  const int a0 = blockIdx.x * BM, lane0 = blockIdx.y * BN;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int passes = (p.n + p.w - 1) / p.w;
  // ring stages a product (a pass, or a group of P passes)
  const int steps = p.chunks / (P == 1 ? SB : p.sb);

  if (threadIdx.x == 0) {
    for (int i = 0; i < S; ++i) {
      mbar_init(&full[i], 1);
      mbar_init(&empty[i], 4 * WGS);  // one arrival per consumer warp
    }
    mbar_init(a_full, 1);
    mbar_init_fence();
  }
  __syncthreads();

  if (warp == 4 * WGS) {
    // ---- producer: the resident query rows once, then every product's
    // stages in order, each into the next ring slot once the consumers
    // have released the slot's previous stage
    if (lane == 0) {
      tma_prefetch(&q_map);
      if (kTwo) tma_prefetch(&lo_map);
      tma_prefetch(&db_map);
      if (RESIDENT) {
        mbar_expect_tx(a_full, p.a_bytes);
        for (int kc = 0; kc < p.chunks; ++kc) {
          for (int h = 0; h < QB; ++h)
            tma_load_2d(base + kc * A_STRIDE + h * A_BYTES, &q_map, a_full,
                        kc * DB_COLS + h * Q_COLS, a0);
          if (kTwo)
            tma_load_2d(base + kc * A_STRIDE + A_BYTES, &lo_map, a_full,
                        kc * DB_COLS, a0);
        }
      }
      const int products = P == 1 ? passes : issued_groups(passes, P);
      int s = 0, phase = 0;
      for (int g = 0; g < products; ++g) {
        // P > 1: the group's passes that exist (none past the last group)
        const int n_live = P == 1 ? 1 : max(0, min(P, passes - g * P));
        for (int j = 0; j < steps; ++j) {
          mbar_wait(&empty[s], phase ^ 1);
          unsigned char* stage = ring_p + s * p.stage_bytes;
          if (P > 1) {
            // box b along d: each warpgroup's P boxes of TN rows, stacked
            mbar_expect_tx(&full[s], n_live * p.sb * B_BOX);
            for (int b = 0; b < p.sb; ++b)
              for (int w = 0; w < WGS; ++w)
                for (int i = 0; i < n_live; ++i)
                  tma_load_2d(stage + ((b * WGS + w) * P + i) * T_BOX, &db_map,
                              &full[s], (j * p.sb + b) * DB_COLS,
                              tile_row<kInd>(p, (g * P + i) * p.w + lane0) +
                                  w * TN);
          } else {
            mbar_expect_tx(&full[s], p.stage_bytes);
            const int row0 = tile_row<kInd>(p, g * p.w + lane0);
            if (RESIDENT) {
#pragma unroll
              for (int b = 0; b < SB; ++b)
                tma_load_2d(stage + b * B_BOX, &db_map, &full[s],
                            (j * SB + b) * DB_COLS, row0);
            } else {
              for (int h = 0; h < QB; ++h)
                tma_load_2d(stage + h * A_BYTES, &q_map, &full[s],
                            j * DB_COLS + h * Q_COLS, a0);
              if (kTwo)
                tma_load_2d(stage + A_BYTES, &lo_map, &full[s], j * DB_COLS,
                            a0);
              tma_load_2d(stage + A_STRIDE, &db_map, &full[s], j * DB_COLS,
                          row0);
            }
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

  // ---- the consumer warpgroups, each of TN lanes from cw0. A lane holds
  // rows il0 and il0 + 8 of the tile, columns cw0 + 8 j + 2 t (+1):
  // acc[4 j + e] is row il0 + 8 (e / 2), column cw0 + 8 j + 2 t + e % 2 (P
  // passes a product: pass i's columns are the registers from i * TN / 2
  // on, in the same order).
  const int t = lane & 3;
  const int il0 = 16 * (warp % 4) + (lane >> 2);
  const int cw0 = warp / 4 * TN;
  const bool live[2] = {a0 + il0 < p.q_n, a0 + il0 + 8 < p.q_n};
  const size_t width = (size_t)p.r * p.w;
  const int jmax = (int)((1u << p.jbits) - 1u);
  const unsigned below = (1u << lane) - 1u;  // lanes before this one
  int* q_key = queues + warp * 2 * QUEUE;
  int* q_val = q_key + QUEUE;
  float q_sq[2] = {0.f, 0.f};
  if (V < kSym && p.l2) {
    for (int h = 0; h < 2; ++h)
      if (live[h]) q_sq[h] = p.q_sq[a0 + il0 + 8 * h];
  }

  int kept[NJ][4];
#pragma unroll
  for (int j = 0; j < NJ; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      kept[j][e] = INT_MIN;
      const int il = il0 + 8 * (e >> 1), jl = cw0 + 8 * j + 2 * t + (e & 1);
      if (p.global_slots) {
        if (live[e >> 1])
          for (int r = 0; r < p.r; ++r)
            p.buf[(size_t)(a0 + il) * width + (size_t)r * p.w + lane0 + jl] =
                INT_MIN;
      } else {
        for (int r = 0; r < p.rb; ++r) slots[(r * BM + il) * BN + jl] = INT_MIN;
      }
    }

  const uint32_t a_base = smem_u32(base), ring = smem_u32(ring_p);
  const uint32_t conv = smem_u32(conv_p);
  if (RESIDENT) mbar_wait(a_full, 0);
  if constexpr (P == 1) {
    // ---- one pass a product
    int s = 0, phase = 0, widened = 0;
    for (int pass = 0; pass < passes; ++pass) {
      const int c0 = pass * p.w + lane0;
      // this pass's scales, norms and validity of the thread's columns, in
      // flight while the products run
      float sc[NJ][2], dsq[NJ][2];
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
            ok[j][h] = c0 + jl < p.nv;
            sc[j][h] = V != kBF16 && ok[j][h] ? p.scales[c0 + jl] : 1.f;
          }
          dsq[j][h] = V < kSym && p.l2 && ok[j][h] ? p.d_sq[c0 + jl] : 0.f;
        }

      Acc acc[BN / 2], lo[BN / 2];
#pragma unroll
      for (int i = 0; i < BN / 2; ++i) acc[i] = lo[i] = 0;
      int prev = 0;
      for (int j = 0; j < steps; ++j) {
        mbar_wait(smem_u32(&full[s]), phase);
        const uint32_t st = ring + s * p.stage_bytes;
        if constexpr (WIDEN) {
          // E: widen each db box into the next of the CONV_BUFS buffers,
          // then its products. The barrier after the copy also orders it
          // after every warp's wait for the products two boxes back, the
          // last reader of this buffer. A resident stage holds db rows only
          // and is released once copied; a streamed one also holds the query
          // rows the products read, and is released as D's, F's and J's are.
#pragma unroll
          for (int b = 0; b < SB; ++b) {
            const uint32_t qa =
                RESIDENT ? a_base + (j * SB + b) * A_STRIDE : st;
            const int off = (widened % CONV_BUFS) * QB * B_BOX;
            widen_box<BN>(ring_p + s * p.stage_bytes +
                              (RESIDENT ? b * B_BOX : A_STRIDE),
                          conv_p + off, threadIdx.x);
            fence_async_shared();
            consumer_sync<128>();
            if (RESIDENT && b == SB - 1 && lane == 0) mbar_arrive(&empty[s]);
            fence_regs(acc);
            wgmma_fence();
#pragma unroll
            for (int h = 0; h < QB; ++h)
#pragma unroll
              for (int kk = 0; kk < BOX / 32; ++kk)
                wgmma(acc, sw128_desc(qa + h * A_BYTES + kk * 32, 16, 1024),
                      sw128_desc(conv + off + h * B_BOX + kk * 32, 16, 1024));
            wgmma_commit();
            wgmma_wait<1>();
            fence_regs(acc);
            ++widened;
          }
          if (!RESIDENT) {
            if (j > 0 && lane == 0) mbar_arrive(&empty[prev]);
            prev = s;
          }
        } else {
          fence_regs(acc);
          if (kTwo) fence_regs(lo);
          wgmma_fence();
#pragma unroll
          for (int b = 0; b < SB; ++b) {
            const uint32_t qa =
                RESIDENT ? a_base + (j * SB + b) * A_STRIDE : st;
            const uint32_t da = RESIDENT ? st + b * B_BOX : st + A_STRIDE;
            // a k step moves 32 bytes into the swizzled 128-byte rows
#pragma unroll
            for (int kk = 0; kk < BOX / 32; ++kk) {
              const uint64_t db_desc = sw128_desc(da + kk * 32, 16, 1024);
              wgmma(acc, sw128_desc(qa + kk * 32, 16, 1024), db_desc);
              if (kTwo)
                wgmma(lo, sw128_desc(qa + A_BYTES + kk * 32, 16, 1024),
                      db_desc);
            }
          }
          wgmma_commit();
          wgmma_wait<1>();  // the previous stage's products are done
          fence_regs(acc);
          if (kTwo) fence_regs(lo);
          if (j > 0 && lane == 0) mbar_arrive(&empty[prev]);
          prev = s;
        }
        if (++s == S) {
          s = 0;
          phase ^= 1;
        }
      }
      wgmma_wait<0>();
      fence_regs(acc);
      if (kTwo) fence_regs(lo);
      if (!(WIDEN && RESIDENT) && lane == 0) mbar_arrive(&empty[prev]);

      // this pass's winners through the warp's queue (n entries, warp-wide)
      int n = 0;
      unsigned won = 0;  // bit 4 j + e: this thread's pair (j, e) won
#pragma unroll
      for (int j = 0; j < NJ; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          // rows past q_n and masked columns (past n, J's padding) never enter
          int cand = INT_MIN;
          if (live[e >> 1] && ok[j][e & 1]) {
            float sim;
            if constexpr (V >= kSym)
              sim = sym_sim<kTwo>(acc[4 * j + e], lo[4 * j + e], sc[j][e & 1]);
            else
              sim = float_sim<V>(acc[4 * j + e], sc[j][e & 1], q_sq[e >> 1],
                                 dsq[j][e & 1], p.l2);
            cand = (knn::ordered_int(sim) & ~jmax) | (jmax - pass);
          }
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
  } else {
    // ---- P passes a product: two accumulator sets (and residual sets),
    // the scales (J: and packed ids) of column lane0 + lane of each pass
    // of a set's group, loaded as its products are issued
    constexpr int NA = P * TN / 2;
    int acc[2][NA], lo[2][NA];
    float sc[2][P];
    int id[2][P];
#pragma unroll
    for (int x = 0; x < 2; ++x)
#pragma unroll
      for (int a = 0; a < NA; ++a) acc[x][a] = lo[x][a] = 0;
    // rows past q_n: an R-th value no candidate beats
#pragma unroll
    for (int j = 0; j < NJ; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e)
        if (!live[e >> 1]) kept[j][e] = INT_MAX;
    const int groups = issued_groups(passes, P);
    int s = 0, phase = 0, prev = -1;
    for (int h0 = 0; h0 < groups; h0 += 2) {
#pragma unroll
      for (int x = 0; x < 2; ++x) {
        const int h = h0 + x, y = x ^ 1;  // group h into set x; h - 1 in y
        if (h == groups) break;
#pragma unroll
        for (int i = 0; i < P; ++i) {
          const int pass = h * P + i, c0 = pass * p.w + lane0 + cw0;
          sc[x][i] = 0.f;
          id[x][i] = -1;
          if (pass < passes && lane < TN) {
            if (kInd) {
              const int row = tile_row<true>(p, c0) + lane;
              sc[x][i] = p.scales[row];
              id[x][i] = p.ids[row];
            } else if (c0 + lane < p.nv) {
              sc[x][i] = p.scales[c0 + lane];
            }
          }
        }
        int entered = 0;  // passes of group h - 1 entered so far
        for (int j = 0; j < steps; ++j) {
          mbar_wait(smem_u32(&full[s]), phase);
          const uint32_t st = ring + s * p.stage_bytes;
          fence_regs(acc[x]);
          if (kTwo) fence_regs(lo[x]);
          wgmma_fence();
          for (int b = 0; b < p.sb; ++b) {
            const uint32_t qa = a_base + (j * p.sb + b) * A_STRIDE;
            const uint32_t da = st + (b * WGS + warp / 4) * P * T_BOX;
#pragma unroll
            for (int kk = 0; kk < BOX / 32; ++kk) {
              // the group's first k step starts the sums: no instruction
              // but a wgmma defines a set while the other's are in flight
              const int sum = j > 0 || b > 0 || kk > 0;
              const uint64_t db_desc = sw128_desc(da + kk * 32, 16, 1024);
              wgmma(acc[x], sw128_desc(qa + kk * 32, 16, 1024), db_desc, sum);
              if (kTwo)
                wgmma(lo[x], sw128_desc(qa + A_BYTES + kk * 32, 16, 1024),
                      db_desc, sum);
            }
          }
          wgmma_commit();
          // all but this stage's products are done, group h - 1's with them
          wgmma_wait<1>();
          fence_regs(acc[y]);
          if (kTwo) fence_regs(lo[y]);
          if (prev >= 0 && lane == 0) mbar_arrive(&empty[prev]);
          prev = s;
          if (++s == S) {
            s = 0;
            phase ^= 1;
          }
          // group h - 1's passes due after this stage, in pass order, each
          // from its registers of set y, picked by masks: one copy of the
          // insert a set, and no branch reads the sums
          const int due = min(P, ((j + 1) * P + steps - 1) / steps);
          for (int i = entered; i < due; ++i) {
            const int pass = (h - 1) * P + i;
            if (pass < 0 || pass >= passes) continue;
            int hi[TN / 2], lo_i[TN / 2], sc_i = 0, id_i = 0;
#pragma unroll
            for (int k = 0; k < TN / 2; ++k) hi[k] = lo_i[k] = 0;
#pragma unroll
            for (int u = 0; u < P; ++u) {
              const int mu = -(int)(i == u);
#pragma unroll
              for (int k = 0; k < TN / 2; ++k) {
                hi[k] |= acc[y][u * TN / 2 + k] & mu;
                if (kTwo) lo_i[k] |= lo[y][u * TN / 2 + k] & mu;
              }
              sc_i |= __float_as_int(sc[y][u]) & mu;
              id_i |= id[y][u] & mu;
            }
            enter_grouped<BN, TN, kTwo, kInd>(
                p, slots, q_key, q_val, kept, hi, lo_i, __int_as_float(sc_i),
                id_i, pass, pass * p.w + lane0 + cw0, cw0, il0, t, lane,
                jmax);
          }
          entered = due;
        }
      }
    }
    wgmma_wait<0>();
    if (lane == 0) mbar_arrive(&empty[prev]);
  }
  if (p.global_slots) return;
  consumer_sync<128 * WGS>();
  // coalesced copy-out: consecutive threads write consecutive lanes
  for (int e = threadIdx.x; e < BM * BN * p.r; e += 128 * WGS) {
    const int jl = e % BN, il = (e / BN) % BM, r = e / (BM * BN);
    if (a0 + il < p.q_n)
      p.buf[(size_t)(a0 + il) * width + (size_t)r * p.w + lane0 + jl] =
          slots[e];
  }
}

// bytes of a launch's shared memory beside its ring: the alignment slack,
// the barriers, the queues, the resident rows, E's widened boxes and the
// slots
size_t fixed_bytes(const MmaParams& p, int v, int bn) {
  return 1024 + 16 * MAX_STAGES + 8 +
         4 * consumer_groups(p.group) * 2 * QUEUE * sizeof(int) + p.a_bytes +
         conv_bytes(v, bn) +
         (p.global_slots ? 0 : (size_t)BM * bn * p.rb * sizeof(int));
}

// Several passes a product on resident rows (plan_for), where the
// variant, the pass count (at least P), R (<= MAX_FAST_R) and shared
// memory allow: a stage holds sb = boxes / P boxes along d of the group's
// P passes, so a group takes about P stages, one pass entered after each
// (sb halved until MIN_GROUP_STAGES of them fit the ring). Else p keeps one
// pass a product.
void plan_group(MmaParams& p, int v, int bn, int boxes) {
  const int g = max_group(v, bn);
  const int passes = (p.n + p.w - 1) / p.w;
  if (g == 1 || passes < g || p.r > MAX_FAST_R) return;
  for (int sb = std::max(1, boxes / g); sb >= 1; sb /= 2) {
    MmaParams t = p;
    t.group = g;
    t.rb = p.r <= 8 ? 8 : MAX_FAST_R;
    t.sb = sb;
    t.chunks = (boxes + sb - 1) / sb * sb;
    t.a_bytes = t.chunks * a_stride(v);
    t.stage_bytes = sb * g * bn * BOX;
    const size_t fixed = fixed_bytes(t, v, bn);
    if (fixed + (size_t)MIN_GROUP_STAGES * t.stage_bytes <= SMEM_LIMIT) {
      t.stages = (int)std::min<size_t>(MAX_STAGES,
                                       (SMEM_LIMIT - fixed) / t.stage_bytes);
      p = t;
      return;
    }
  }
}

// The launch's plan, filled into p; returns the lane tile BN.
//   * Resident (BN = 32, or 16 when the slots of 32 leave fewer than 4
//     stages): the block's query rows (and residuals) load once and stay
//     in shared memory, and the ring streams db rows only, as deep as the
//     rest of the 227 KB allows: 8 KB stages of one pass, or for F and J
//     stages of several passes a product (plan_group).
//   * Streamed (BN = 64), where resident rows do not fit (large d or R):
//     each stage is one chunk's query boxes, residuals and db box; slots
//     in device memory when two stages do not fit beside them.
int plan_for(MmaParams& p, int v) {
  const int boxes = (p.d * db_elem(v) + BOX - 1) / BOX;
  p.global_slots = false;
  p.group = 1;
  p.sb = 1;
  p.rb = p.r;
  for (int bn : {32, 16}) {
    const int sb = RESIDENT_STAGE / (bn * BOX);
    p.chunks = (boxes + sb - 1) / sb * sb;
    p.a_bytes = p.chunks * a_stride(v);
    p.stage_bytes = RESIDENT_STAGE;
    const size_t fixed = fixed_bytes(p, v, bn);
    if (fixed + (size_t)MIN_RESIDENT_STAGES * RESIDENT_STAGE <= SMEM_LIMIT) {
      p.stages = (int)std::min<size_t>(MAX_STAGES,
                                       (SMEM_LIMIT - fixed) / RESIDENT_STAGE);
      plan_group(p, v, bn, boxes);
      return bn;
    }
  }
  p.chunks = boxes;
  p.a_bytes = 0;
  p.stage_bytes = a_stride(v) + 64 * BOX;
  if (fixed_bytes(p, v, 64) + 2 * (size_t)p.stage_bytes > SMEM_LIMIT)
    p.global_slots = true;
  p.stages = (int)std::min<size_t>(
      MAX_STAGES, (SMEM_LIMIT - fixed_bytes(p, v, 64)) / p.stage_bytes);
  return 64;
}

template <int BN, int V, bool kInd, int P>
cudaError_t launch(const CUtensorMap (&maps)[3], const MmaParams& p,
                   cudaStream_t stream) {
  const size_t smem = fixed_bytes(p, V, BN) + (size_t)p.stages * p.stage_bytes;
  auto kernel = segment_packed_mma<BN, V, kInd, P>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  const dim3 grid((p.q_n + BM - 1) / BM, p.w / BN);
  kernel<<<grid, threads_of(P), smem, stream>>>(maps[0], maps[1], maps[2], p);
  return cudaGetLastError();
}

// the plan's passes a product: max_group(V, BN) or 1
template <int BN, int V, bool kInd>
cudaError_t launch_bn(const CUtensorMap (&maps)[3], const MmaParams& p,
                      cudaStream_t stream) {
  constexpr int G = max_group(V, BN);
  if (G > 1 && p.group == G) return launch<BN, V, kInd, G>(maps, p, stream);
  return launch<BN, V, kInd, 1>(maps, p, stream);
}

template <int V, bool kInd>
cudaError_t launch_any(const void* q, const void* q_lo, const void* db,
                       int db_rows, MmaParams p, cudaStream_t stream) {
  const int bn = plan_for(p, V);
  CUtensorMap maps[3];
  const CUtensorMapDataType u8 = CU_TENSOR_MAP_DATA_TYPE_UINT8;
  const CUtensorMapDataType bf = CU_TENSOR_MAP_DATA_TYPE_BFLOAT16;
  const int qe = q_elem(V), de = db_elem(V);
  if (!make_map_2d(&maps[0], q, qe == 2 ? bf : u8, qe, p.q_n, p.d, BOX / qe,
                   BM) ||
      (two(V) && !make_map_2d(&maps[1], q_lo, u8, 1, p.q_n, p.d, BOX, BM)) ||
      !make_map_2d(&maps[2], db, de == 2 ? bf : u8, de, db_rows, p.d,
                   BOX / de, bn / consumer_groups(p.group)))
    return cudaErrorInvalidValue;
  if (!two(V)) maps[1] = maps[0];
  switch (bn) {
    case 16: return launch_bn<16, V, kInd>(maps, p, stream);
    case 32: return launch_bn<32, V, kInd>(maps, p, stream);
    default: return launch_bn<64, V, kInd>(maps, p, stream);
  }
}

}  // namespace mma

}  // namespace

// variant: 0 D fp32, 1 D bf16, 2 E (bf16 q, int8 db), 3 F sym, 4 F sym2.
// d counts columns; every variant but fp32 D needs d % 16 == 0 (TMA rows
// of whole 16 bytes). norms: [q_n + n] f32 scratch for l2 with D bf16 and
// E (the squared norms of the queries, then of the db rows), else unused.
// Columns >= n_valid never enter a slot (a shard's pad rows); the passes
// and jbits stay those of all n rows, as the reference plans them.
extern "C" int knn_segment_packed(const void* q, const void* q_lo,
                                  const void* db, const float* scales,
                                  float* norms, int* buf, int q_n, int n,
                                  int n_valid, int d, int w, int r, int jbits,
                                  int variant, int l2, cudaStream_t stream) {
  const bool sq8 = variant >= kSQ8, sym = variant >= kSym;
  if (w < 64 || w % 64 != 0 || r < 1 || q_n < 1 || n < 1 || d < 1 ||
      jbits < 1 || jbits > 30 || variant < kF32 || variant > kSym2 ||
      (sq8 && scales == nullptr) || (variant == kSym2 && q_lo == nullptr) ||
      (sym && l2) || (variant != kF32 && d % 16 != 0) ||
      (l2 && (variant == kBF16 || variant == kSQ8) && norms == nullptr))
    return (int)cudaErrorInvalidValue;
  const int nv = n_valid < 0 ? 0 : (n_valid < n ? n_valid : n);
  if (variant == kF32) {
    const Params p{static_cast<const float*>(q), static_cast<const float*>(db),
                   buf, q_n, n, d, w, r, jbits, nv, l2 != 0, false};
    return (int)launch_f32(p, stream);
  }
  mma::MmaParams p{};
  p.scales = scales;
  p.buf = buf;
  p.q_n = q_n, p.n = n, p.d = d, p.w = w, p.r = r, p.jbits = jbits;
  p.nv = nv;
  p.l2 = l2 != 0;
  if (p.l2) {
    p.q_sq = norms;
    p.d_sq = norms + q_n;
    cudaError_t err = knn::launch_norms<__nv_bfloat16>(q, q_n, d, norms, stream);
    if (err == cudaSuccess)
      err = variant == kBF16
                ? knn::launch_norms<__nv_bfloat16>(db, n, d, norms + q_n, stream)
                : knn::launch_norms<int8_t>(db, n, d, norms + q_n, stream);
    if (err != cudaSuccess) return (int)err;
  }
  switch (variant) {
    case kBF16:
      return (int)mma::launch_any<kBF16, false>(q, q_lo, db, n, p, stream);
    case kSQ8:
      return (int)mma::launch_any<kSQ8, false>(q, q_lo, db, n, p, stream);
    case kSym:
      return (int)mma::launch_any<kSym, false>(q, q_lo, db, n, p, stream);
    default:
      return (int)mma::launch_any<kSym2, false>(q, q_lo, db, n, p, stream);
  }
}

// Passes a product in the plan of a knn_segment_packed launch (variant as
// there; n its columns) or of a knn_ivf_indirect one (variant 3, or 4 for
// two_level; n = budget * 128, w its W): 1 for D and E; -1 where the
// launch would refuse the arguments.
extern "C" int knn_segment_packed_group(int variant, int n, int d, int w,
                                        int r) {
  if (w < 64 || w % 64 != 0 || r < 1 || n < 1 || d < 1 || variant < kF32 ||
      variant > kSym2 || (variant != kF32 && d % 16 != 0))
    return -1;
  if (variant == kF32) return 1;
  mma::MmaParams p{};
  p.n = n, p.d = d, p.w = w, p.r = r;
  mma::plan_for(p, variant);
  return p.group;
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
  mma::MmaParams p{};
  p.scales = scales;
  p.cells = cells;
  p.ids = ids;
  p.buf = buf;
  p.q_n = q_n, p.n = budget * 128, p.d = d, p.w = w, p.r = r;
  p.nv = p.n;
  p.jbits = jbits;
  return two_level
             ? (int)mma::launch_any<kSym2, true>(q, q_lo, pv, table_rows, p,
                                                 stream)
             : (int)mma::launch_any<kSym, true>(q, q_lo, pv, table_rows, p,
                                                stream);
}
