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
//   F  _segment_packed_sq8sym_kernel int8 q . int8 db -> int32 (__dp4a);
//                                    sym2 adds the residual query's dot:
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
// with a row table (the template flag kInd): each pass first looks up its
// BN columns' physical rows, scales and validity in shared memory, then
// scores and inserts exactly as F does, so the two cannot drift. The TPU
// kernel scored a query block against e*128 = 1024 lanes per step and kept
// all R*1024 slots of each query in its fast memory; here a block owns BN
// = 64 of those lanes for BM = 32 queries, as in F, so its slot state is
// BM*BN*R*4 bytes (32 KB at R = 4) whatever the tile width, and the width
// only sets gridDim.y.
//
// F and J are bit-exact: |dot| <= d * 127^2 < 2^24 for d <= 1024, so int32
// -> f32 is exact, and lo * (1/128) is exact; the combine
// (hi + lo * (1/128)) * sc is written with _rn intrinsics, so no FMA
// contraction can reorder it.
//
// What bounds it here: the product (FFMA for D and E, 2*Q*N*d flops;
// __dp4a for F, 4 int8 MACs per instruction), since the [Q, N] similarity
// block never reaches device memory. On the TPU the slots lived in VMEM
// across a sequential pass axis. Here a block owns BM queries x BN lanes
// and loops over ALL passes itself, so no cross-block merge is needed, and
// its slots live in shared memory (4 bytes each): BM*BN*R*4 bytes, 57 KB
// at the bench plan (32 x 64 x R = 7). Each thread keeps the R-th kept
// value of its (query, lane) pairs in registers, so a candidate costs one
// compare and only winners pay the insertion. Past R = 25 (no workload
// plans it; the recall bound and the R*W >= k doubling can) the slots move
// to the output buffer in device memory, as in kernel B.

#include <limits.h>
#include <stdint.h>

#include <type_traits>

#include "knn_common.cuh"

namespace {

enum Variant { kF32 = 0, kBF16 = 1, kSQ8 = 2, kSym = 3, kSym2 = 4 };

// shared memory for the slots of one block; a block's tiles add < 8 KB,
// inside the card's 227 KB per block
constexpr int kSlotSmemBytes = 200 * 1024;
// one block shape at every R: 32 queries (ops/exact_cuda.py:
// SEGMENT_PACKED_QUERIES) x 64 lanes, 2 x 4 (query, lane) pairs per thread
constexpr int kTM = 2, kTN = 4;
constexpr int kBKW = 8;  // int8 path: 32-bit words (4 columns) per step

struct Params {
  const void* q;
  const void* q_lo;
  const void* db;
  const float* scales;
  int* buf;
  int q_n, n, d, w, r, jbits;
  bool l2, global_slots;
  // J only: cell slot -> cell id [n / 128], and the packed ids [C*128]
  const int* cells;
  const int* ids;
};

// Row of the database behind column m of a tile (-1: none, reads as zero).
// F: column b0 + m is row b0 + m, up to n.
struct DirectRows {
  int b0, n;
  __device__ __forceinline__ int operator()(int m) const {
    return b0 + m < n ? b0 + m : -1;
  }
};
// J: the pass's row table in shared memory.
struct TableRows {
  const int* row;
  __device__ __forceinline__ int operator()(int m) const { return row[m]; }
};

// F's and J's similarity: (hi + lo / 128) * sc in this order, each step
// rounded on its own.
template <bool kTwo>
__device__ __forceinline__ float sym_sim(int hi, int lo, float sc) {
  float v = (float)hi;
  if (kTwo) v = __fadd_rn(v, __fmul_rn((float)lo, 1.f / 128.f));
  return __fmul_rn(v, sc);
}

template <int TM, int TN>
struct I8Smem {
  static constexpr int BM = 16 * TM;
  static constexpr int BN = 16 * TN;
  int a[kBKW][BM + 4];
  int a_lo[kBKW][BM + 4];
  int b[kBKW][BN + 4];
};

// acc[i][j] = int8 dot(Q[a0 + ty*TM + i], B[rows(tx*TN + j)]) over dw words
// of 4 packed int8 columns each (acc_lo the same for Qlo when kTwo).
template <int TM, int TN, bool kTwo, typename Rows>
__device__ __forceinline__ void tile_dots_i8(
    const int* __restrict__ Q, const int* __restrict__ Qlo, int a_rows,
    int a0, const int* __restrict__ B, Rows rows, int dw,
    I8Smem<TM, TN>& s, int (&acc)[TM][TN], int (&acc_lo)[TM][TN]) {
  constexpr int BM = I8Smem<TM, TN>::BM;
  constexpr int BN = I8Smem<TM, TN>::BN;
  const int tid = threadIdx.x;
  const int ty = tid / 16, tx = tid % 16;
#pragma unroll
  for (int i = 0; i < TM; ++i)
#pragma unroll
    for (int j = 0; j < TN; ++j) acc[i][j] = acc_lo[i][j] = 0;

  for (int k0 = 0; k0 < dw; k0 += kBKW) {
    // consecutive threads read consecutive words of one row (32-byte runs)
    for (int e = tid; e < BM * kBKW; e += knn::kThreads) {
      const int m = e / kBKW, kw = e % kBKW;
      const int row = a0 + m, col = k0 + kw;
      const bool ok = row < a_rows && col < dw;
      s.a[kw][m] = ok ? Q[(size_t)row * dw + col] : 0;
      if (kTwo) s.a_lo[kw][m] = ok ? Qlo[(size_t)row * dw + col] : 0;
    }
    for (int e = tid; e < BN * kBKW; e += knn::kThreads) {
      const int m = e / kBKW, kw = e % kBKW;
      const int row = rows(m), col = k0 + kw;
      s.b[kw][m] = (row >= 0 && col < dw) ? B[(size_t)row * dw + col] : 0;
    }
    __syncthreads();
#pragma unroll
    for (int kw = 0; kw < kBKW; ++kw) {
      int a[TM], alo[TM], b[TN];
#pragma unroll
      for (int i = 0; i < TM; ++i) {
        a[i] = s.a[kw][ty * TM + i];
        if (kTwo) alo[i] = s.a_lo[kw][ty * TM + i];
      }
#pragma unroll
      for (int j = 0; j < TN; ++j) b[j] = s.b[kw][tx * TN + j];
#pragma unroll
      for (int i = 0; i < TM; ++i)
#pragma unroll
        for (int j = 0; j < TN; ++j) {
          acc[i][j] = __dp4a(a[i], b[j], acc[i][j]);
          if (kTwo) acc_lo[i][j] = __dp4a(alo[i], b[j], acc_lo[i][j]);
        }
    }
    __syncthreads();
  }
}

template <int TM, int TN, int V>
using SmemOf = typename std::conditional<(V >= kSym), I8Smem<TM, TN>,
                                         knn::TileSmem<TM, TN>>::type;

// sim[i][j] for the block's queries a0.. against db columns b0.. (the
// reference kernels' arithmetic, in their order of operations); J takes
// its rows and scales from the pass's tables
template <int TM, int TN, int V, bool kInd>
__device__ __forceinline__ void tile_sims(const Params& p, int a0, int b0,
                                          SmemOf<TM, TN, V>& s,
                                          const int* row_tab,
                                          const float* sc_tab,
                                          float (&sim)[TM][TN]) {
  static_assert(!kInd || V >= kSym, "J is the sym variants only");
  const int tid = threadIdx.x;
  const int ty = tid / 16, tx = tid % 16;
  if constexpr (V >= kSym) {
    int hi[TM][TN], lo[TM][TN];
    const int* q = static_cast<const int*>(p.q);
    const int* q_lo = static_cast<const int*>(p.q_lo);
    const int* db = static_cast<const int*>(p.db);
    if constexpr (kInd)
      tile_dots_i8<TM, TN, V == kSym2>(q, q_lo, p.q_n, a0, db,
                                       TableRows{row_tab}, p.d, s, hi, lo);
    else
      tile_dots_i8<TM, TN, V == kSym2>(q, q_lo, p.q_n, a0, db,
                                       DirectRows{b0, p.n}, p.d, s, hi, lo);
#pragma unroll
    for (int j = 0; j < TN; ++j) {
      const int jl = tx * TN + j, col = b0 + jl;
      const float sc = kInd ? sc_tab[jl] : col < p.n ? p.scales[col] : 1.f;
#pragma unroll
      for (int i = 0; i < TM; ++i)
        sim[i][j] = sym_sim<V == kSym2>(hi[i][j], lo[i][j], sc);
    }
  } else {
    float acc[TM][TN];
    if constexpr (V == kF32) {
      knn::tile_dots<TM, TN>(static_cast<const float*>(p.q), p.q_n, a0,
                             static_cast<const float*>(p.db), p.n, b0, p.d,
                             p.l2, s, acc);
    } else if constexpr (V == kBF16) {
      knn::tile_dots<TM, TN>(static_cast<const __nv_bfloat16*>(p.q), p.q_n,
                             a0, static_cast<const __nv_bfloat16*>(p.db), p.n,
                             b0, p.d, p.l2, s, acc);
    } else {
      knn::tile_dots<TM, TN>(static_cast<const __nv_bfloat16*>(p.q), p.q_n,
                             a0, static_cast<const int8_t*>(p.db), p.n, b0,
                             p.d, p.l2, s, acc);
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
}

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

template <int V, bool kInd>
__global__ void __launch_bounds__(knn::kThreads)
segment_packed(const Params p) {
  constexpr int TM = kTM, TN = kTN, BM = 16 * TM, BN = 16 * TN;
  extern __shared__ int slot_smem[];  // [R][BM][BN] unless global_slots
  __shared__ SmemOf<TM, TN, V> s;
  // J: the pass's physical rows, scales and validity of its BN columns
  __shared__ int row_tab[kInd ? BN : 1];
  __shared__ float sc_tab[kInd ? BN : 1];
  __shared__ bool ok_tab[kInd ? BN : 1];
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
    if constexpr (kInd) {
      __syncthreads();  // every thread is done with the last pass's tables
      if (tid < BN) {
        // W is a multiple of 128, so column c is lane c % 128 of cell slot
        // c / 128
        const int c = b0 + tid;
        const int row = p.cells[c >> 7] * 128 + (c & 127);
        row_tab[tid] = row;
        sc_tab[tid] = p.scales[row];
        ok_tab[tid] = p.ids[row] >= 0;
      }
      __syncthreads();
    }
    float sim[TM][TN];
    tile_sims<TM, TN, V, kInd>(p, a0, b0, s, row_tab, sc_tab, sim);
#pragma unroll
    for (int i = 0; i < TM; ++i) {
      const int il = ty * TM + i;
      if (a0 + il >= p.q_n) continue;
#pragma unroll
      for (int j = 0; j < TN; ++j) {
        const int jl = tx * TN + j;
        // masked columns never enter: past n, or J's capacity padding
        if (kInd ? !ok_tab[jl] : b0 + jl >= p.n) continue;
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
template <int V, bool kInd = false>
cudaError_t launch(Params p, cudaStream_t stream) {
  constexpr int BM = 16 * kTM, BN = 16 * kTN;
  p.global_slots = (size_t)BM * BN * p.r * sizeof(int) > kSlotSmemBytes;
  const size_t smem = p.global_slots ? 0 : (size_t)BM * BN * p.r * sizeof(int);
  auto kernel = segment_packed<V, kInd>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  const dim3 grid((p.q_n + BM - 1) / BM, p.w / BN);
  kernel<<<grid, knn::kThreads, smem, stream>>>(p);
  return cudaGetLastError();
}

}  // namespace

// variant: 0 D fp32, 1 D bf16, 2 E (bf16 q, int8 db), 3 F sym, 4 F sym2.
// d counts columns; F needs d % 4 == 0 (4-byte rows of packed int8).
extern "C" int knn_segment_packed(const void* q, const void* q_lo,
                                  const void* db, const float* scales,
                                  int* buf, int q_n, int n, int d, int w,
                                  int r, int jbits, int variant, int l2,
                                  cudaStream_t stream) {
  const bool sq8 = variant >= kSQ8, sym = variant >= kSym;
  if (w < 64 || w % 64 != 0 || r < 1 || q_n < 1 || n < 1 || d < 1 ||
      jbits < 1 || jbits > 30 || variant < kF32 || variant > kSym2 ||
      (sq8 && scales == nullptr) || (variant == kSym2 && q_lo == nullptr) ||
      (sym && (l2 || d % 4 != 0)))
    return (int)cudaErrorInvalidValue;
  Params p{q, q_lo, db, scales, buf, q_n, n, sym ? d / 4 : d, w, r, jbits,
           l2 != 0, false, nullptr, nullptr};
  switch (variant) {
    case kF32: return (int)launch<kF32>(p, stream);
    case kBF16: return (int)launch<kBF16>(p, stream);
    case kSQ8: return (int)launch<kSQ8>(p, stream);
    case kSym: return (int)launch<kSym>(p, stream);
    default: return (int)launch<kSym2>(p, stream);
  }
}

// Kernel J. pv [C*128, d] int8 slabs, scales and ids [C*128] (per packed
// row), cells [budget] the cell of each slot; the virtual database has
// n = budget * 128 columns, W = e * 128 lanes and budget / e passes. Cell
// ids must lie in [0, C). q (and q_lo when two_level) int8 [q_n, d], d % 4
// == 0.
extern "C" int knn_ivf_indirect(const void* q, const void* q_lo,
                                const void* pv, const float* scales,
                                const int* ids, const int* cells, int* buf,
                                int q_n, int budget, int d, int w, int r,
                                int jbits, int two_level, cudaStream_t stream) {
  if (w < 128 || w % 128 != 0 || budget < 1 || (budget * 128) % w != 0 ||
      r < 1 || q_n < 1 || d < 4 || d % 4 != 0 || jbits < 1 || jbits > 30 ||
      (two_level && q_lo == nullptr) || cells == nullptr || ids == nullptr)
    return (int)cudaErrorInvalidValue;
  Params p{q, q_lo, pv, scales, buf, q_n, budget * 128, d / 4, w, r, jbits,
           false, false, cells, ids};
  return two_level ? (int)launch<kSym2, true>(p, stream)
                   : (int)launch<kSym, true>(p, stream);
}
