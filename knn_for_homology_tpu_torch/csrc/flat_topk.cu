// Kernel A: fused fp32 distance + exact small-k top-k (k <= 32).
//
// Replaces knn_for_homology_tpu/ops/flat_pallas.py:_flat_topk_kernel
// (entry pallas_flat_topk): q . db^T (l2 as 2qd - |q|^2 - |d|^2), rows >= n
// masked to -inf, the k best per query ordered by value descending, lower id
// first on ties.
//
// What bounds it here: the fp32 FFMA product, 2*Q*N*d operations; the
// [Q, N] block never reaches device memory. The product stays on FFMA, in
// k order, by the card's evidence (an H100,
// scripts/torch_tf32x3_accuracy.py): on d = 100 Gaussian rows (inner
// products up to 57) the 3xTF32 product of kernel B (csrc/tf32x3.cuh)
// comes closer to fp64 than the plain fp32 matmul does, but lands 3e-5
// from the plain route's scores, where A's card test allows 1e-5; k-order
// FFMA sums match the plain route there bit for bit. So the FFMA product
// is register-blocked for Hopper instead: 256 threads compute a 128-query
// x 128-row tile, 8 x 8 outputs a thread, from 16-column stages of both
// operands in shared memory (stored k-major, so a thread reads its 8 rows
// and 8 columns as four float4), double-buffered through registers: 64
// FFMA per four shared loads, and a stage's 1024 FFMA a thread cover the
// next stage's loads (8-column stages left them exposed).
//
// On the TPU the winner set was carried across a SEQUENTIAL database grid
// axis. Blocks on the card run in parallel and in no order, so the
// database is cut into `splits` contiguous row ranges, one per blockIdx.y,
// each scanned by a loop inside its block (the wrapper sizes `splits` so
// the blocks fill the card's SMs: ops/flat_cuda.py:plan_splits); a second
// small kernel merges the per-split lists. Split s holds only ids below
// split s+1's, and each list is already in (value desc, id asc) order, so
// merging the splits in order with a strict `>` keeps the lower-id-first
// tie rule across the merge.
//
// The selection is kept off the product's path: every thread compares its
// own 64 sums against its 8 rows' running k-th values (read once a step,
// so that over the product loop they hold no registers and two blocks fit
// an SM), so a candidate costs one compare; a step's winners are
// compacted into a
// per-warp queue (ballot + prefix count), and the warp folds them into
// their rows' sorted lists in shared memory (flush). A step's winners all
// carry higher ids than the lists' entries, so the filter `v > k-th` is
// exact; inside a step the insert orders equal values by id.

#include <math.h>

#include "knn_common.cuh"

namespace {

constexpr int kMaxK = 32;
constexpr int THREADS = 256;
constexpr int BM = 128, BN = 128;  // queries x db rows a step
constexpr int BK = 16;             // columns a stage
constexpr int PAD = BM + 4;        // k-major stage rows, 16-byte aligned
constexpr int LIST = kMaxK + 1;    // row stride of the lists: distinct banks
constexpr int QUEUE = 128;         // a warp's queued winners (value, key)

struct Smem {
  float a[2][BK][PAD];  // query rows, k-major, double-buffered
  float b[2][BK][PAD];  // db rows
  float best_v[BM][LIST];
  int best_i[BM][LIST];
  float q_val[THREADS / 32][QUEUE];
  int q_key[THREADS / 32][QUEUE];
};

struct Params {
  const float* q;
  const float* db;
  const float* q_sq;  // l2: [q_n] squared query norms
  const float* d_sq;  // l2: [n] squared db row norms
  float* part_v;
  int* part_i;
  int q_n, n, d, k, splits, rows_per_split;
  bool l2;
};

__device__ __forceinline__ void insert_sorted(float* v, int* id, int k,
                                              float val, int idx) {
  // v[0..k) sorted desc; val > v[k-1]. Equal values stay ahead (lower ids).
  int p = k - 1;
  while (p > 0 && v[p - 1] < val) {
    v[p] = v[p - 1];
    id[p] = id[p - 1];
    --p;
  }
  v[p] = val;
  id[p] = idx;
}

// one float4 of row `row` (of `rows`), columns k0 .. k0+3; zeros past
// either edge (d % 4 == 0, so a float4 lies wholly inside or outside)
__device__ __forceinline__ float4 load4(const float* x, int rows, int d,
                                        int row, int k0) {
  if (row < rows && k0 < d)
    return __ldg(reinterpret_cast<const float4*>(x + (size_t)row * d + k0));
  return make_float4(0.f, 0.f, 0.f, 0.f);
}

__device__ __forceinline__ void store4(float (*dst)[PAD], int c4, int row,
                                       float4 v) {
  dst[c4][row] = v.x;
  dst[c4 + 1][row] = v.y;
  dst[c4 + 2][row] = v.z;
  dst[c4 + 3][row] = v.w;
}

// A warp's n queued winners into their rows' lists, one winner at a time
// by the whole warp: lane l < k holds entry l of the winner's row, a
// ballot counts the entries that stay ahead of it in (value desc, id asc)
// order (a prefix: the list is sorted), and the entries behind move down
// one in a single step. Out of line: winners are rare after the first
// steps of a split, where every value wins; one lane per row scanning the
// queue and shifting its list entry by entry was slow exactly there.
__device__ __noinline__ void flush(const float* q_val, const int* q_key,
                                   int n, float (*best_v)[LIST],
                                   int (*best_i)[LIST], int warp, int k,
                                   int lane) {
  __syncwarp();
  for (int e = 0; e < n; ++e) {
    const int key = q_key[e];
    const float v = q_val[e];
    const int id = key >> 4, r = key & 15;
    const int row = (r < 8 ? 0 : 64 - 8) + 8 * warp + r;
    const float mv = lane < k ? best_v[row][lane] : -INFINITY;
    const int mi = lane < k ? best_i[row][lane] : -1;
    const bool ahead = lane < k && (mv > v || (mv == v && mi < id));
    const int pos = __popc(__ballot_sync(0xffffffffu, ahead));
    if (pos < k) {  // warp-uniform
      if (lane >= pos && lane + 1 < k) {
        best_v[row][lane + 1] = mv;
        best_i[row][lane + 1] = mi;
      }
      if (lane == pos) {
        best_v[row][pos] = v;
        best_i[row][pos] = id;
      }
    }
    __syncwarp();
  }
}

// Thread (ty, tx) of a 16 x 16 grid owns rows ty*4 + i and 64 + ty*4 + i
// (i < 4) of the step's 128 queries, columns tx*4 + j and 64 + tx*4 + j of
// its 128 db rows: row_of(ty, i) and row_of(tx, j) for i, j < 8. Warp w holds ty
// 2w and 2w + 1: query rows 8w .. 8w+7 and 64+8w .. 64+8w+7, its 16 rows.
__device__ __forceinline__ int row_of(int ty, int i) {
  return (i < 4 ? 0 : 64 - 4) + ty * 4 + i;
}

__global__ void __launch_bounds__(THREADS, 2)
flat_topk_partial(const Params p) {
  extern __shared__ float4 smem_f4[];
  Smem& s = *reinterpret_cast<Smem*>(smem_f4);
  const int tid = threadIdx.x;
  const int ty = tid / 16, tx = tid % 16;
  const int warp = tid / 32, lane = tid % 32;
  const int a0 = blockIdx.x * BM;
  const int split = blockIdx.y;
  const int row_lo = split * p.rows_per_split;
  const int row_hi = min(p.n, row_lo + p.rows_per_split);
  const int k = p.k;

  for (int e = tid; e < BM * LIST; e += THREADS) {
    (&s.best_v[0][0])[e] = -INFINITY;
    (&s.best_i[0][0])[e] = -1;
  }
  __syncthreads();

  // the 16 rows of this warp: row r (< 16) is block row 8w + r (r < 8) or
  // 64 + 8w + r - 8 (the key's low 4 bits); lane r < 16 writes row r out
  const int own_row = (lane < 8 ? 0 : 64 - 8) + 8 * warp + (lane & 15);
  float* q_val = s.q_val[warp];
  int* q_key = s.q_key[warp];
  const unsigned below = (1u << lane) - 1u;  // lanes before this one

  // the loader's float4s: of each operand's 128 x 16 stage, float4 f = tid
  // and tid + 256 (row f / 4, columns (f % 4) * 4)
  const int ld_row = tid >> 2, ld_c4 = (tid & 3) * 4;
  const int stages = (p.d + BK - 1) / BK;
  for (int b0 = row_lo; b0 < row_hi; b0 += BN) {
    float acc[8][8];
#pragma unroll
    for (int i = 0; i < 8; ++i)
#pragma unroll
      for (int j = 0; j < 8; ++j) acc[i][j] = 0.f;
    float4 na[2], nb[2];
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      na[h] = load4(p.q, p.q_n, p.d, a0 + ld_row + 64 * h, ld_c4);
      nb[h] = load4(p.db, p.n, p.d, b0 + ld_row + 64 * h, ld_c4);
      store4(s.a[0], ld_c4, ld_row + 64 * h, na[h]);
      store4(s.b[0], ld_c4, ld_row + 64 * h, nb[h]);
    }
    __syncthreads();
    for (int st = 0; st < stages; ++st) {
      const int cur = st & 1;
      if (st + 1 < stages) {  // the next stage, in flight over the FFMAs
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          na[h] = load4(p.q, p.q_n, p.d, a0 + ld_row + 64 * h,
                        (st + 1) * BK + ld_c4);
          nb[h] = load4(p.db, p.n, p.d, b0 + ld_row + 64 * h,
                        (st + 1) * BK + ld_c4);
        }
      }
#pragma unroll
      for (int kk = 0; kk < BK; ++kk) {
        float a[8], b[8];
        *reinterpret_cast<float4*>(a) =
            *reinterpret_cast<const float4*>(&s.a[cur][kk][ty * 4]);
        *reinterpret_cast<float4*>(a + 4) =
            *reinterpret_cast<const float4*>(&s.a[cur][kk][64 + ty * 4]);
        *reinterpret_cast<float4*>(b) =
            *reinterpret_cast<const float4*>(&s.b[cur][kk][tx * 4]);
        *reinterpret_cast<float4*>(b + 4) =
            *reinterpret_cast<const float4*>(&s.b[cur][kk][64 + tx * 4]);
#pragma unroll
        for (int i = 0; i < 8; ++i)
#pragma unroll
          for (int j = 0; j < 8; ++j) acc[i][j] = fmaf(a[i], b[j], acc[i][j]);
      }
      if (st + 1 < stages) {
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          store4(s.a[cur ^ 1], ld_c4, ld_row + 64 * h, na[h]);
          store4(s.b[cur ^ 1], ld_c4, ld_row + 64 * h, nb[h]);
        }
      }
      __syncthreads();
    }

    // the step's winners through the warp's queue (n entries, warp-wide),
    // against the k-th values from before the step: the lists then hold
    // only lower ids than the step's. The rows' state is read here, not
    // kept in registers over the product loop.
    float kth[8], dsq[8];
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      kth[i] = s.best_v[row_of(ty, i)][k - 1];
      const int c = b0 + row_of(tx, i);
      dsq[i] = p.l2 && c < row_hi ? p.d_sq[c] : 0.f;
    }
    int n = 0;
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      const int qi = a0 + row_of(ty, i);
      const float q_sq = p.l2 && qi < p.q_n ? p.q_sq[qi] : 0.f;
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const int c = b0 + row_of(tx, j);
        float sim = acc[i][j];
        if (p.l2)  // 2 dot - |q|^2 - |d|^2, in the reference's order
          sim = __fsub_rn(__fsub_rn(2.f * sim, q_sq), dsq[j]);
        // rows past q_n and columns past the split never enter
        const bool win = qi < p.q_n && c < row_hi && sim > kth[i];
        const unsigned mask = __ballot_sync(0xffffffffu, win);
        if (win) {
          const int at = n + __popc(mask & below);
          q_val[at] = sim;
          q_key[at] = c * 16 + (i < 4 ? 0 : 8) + (ty & 1) * 4 + (i & 3);
        }
        n += __popc(mask);
        if (n > QUEUE - 32) {
          flush(q_val, q_key, n, s.best_v, s.best_i, warp, k, lane);
          n = 0;
        }
      }
    }
    if (n > 0) flush(q_val, q_key, n, s.best_v, s.best_i, warp, k, lane);
  }

  if (lane < 16 && a0 + own_row < p.q_n) {
    const size_t base = ((size_t)(a0 + own_row) * p.splits + split) * k;
    for (int r = 0; r < k; ++r) {
      p.part_v[base + r] = s.best_v[own_row][r];
      p.part_i[base + r] = s.best_i[own_row][r];
    }
  }
}

__global__ void flat_topk_merge(const float* __restrict__ part_v,
                                const int* __restrict__ part_i,
                                float* __restrict__ vals, int* __restrict__ ids,
                                int q_n, int k, int splits) {
  const int qi = blockIdx.x * blockDim.x + threadIdx.x;
  if (qi >= q_n) return;
  float bv[kMaxK];
  int bi[kMaxK];
  for (int r = 0; r < k; ++r) {
    bv[r] = -INFINITY;
    bi[r] = -1;
  }
  for (int sp = 0; sp < splits; ++sp) {
    const size_t base = ((size_t)qi * splits + sp) * k;
    for (int r = 0; r < k; ++r) {
      const float v = part_v[base + r];
      if (!(v > bv[k - 1])) break;  // the split's list is sorted desc
      insert_sorted(bv, bi, k, v, part_i[base + r]);
    }
  }
  for (int r = 0; r < k; ++r) {
    vals[(size_t)qi * k + r] = bv[r];
    ids[(size_t)qi * k + r] = bi[r];
  }
}

}  // namespace

// q [q_n, d], db [n, d] fp32 rows, d % 4 == 0 and 16-byte aligned (float4
// loads); norms: [q_n + n] f32 scratch for l2 (the squared norms of the
// queries, then of the db rows), else unused; part_v / part_i [q_n,
// splits, k] scratch of the per-split lists.
extern "C" int knn_flat_topk(const float* q, const float* db, float* norms,
                             float* vals, int* ids, float* part_v,
                             int* part_i, int q_n, int n, int d, int k,
                             int splits, int l2, cudaStream_t stream) {
  if (k < 1 || k > kMaxK || splits < 1 || q_n < 1 || n < 1 ||
      n >= (1 << 27) || d < 4 || d % 4 != 0 || (l2 && norms == nullptr) ||
      reinterpret_cast<uintptr_t>(q) % 16 || reinterpret_cast<uintptr_t>(db) % 16)
    return (int)cudaErrorInvalidValue;
  Params p{};
  p.q = q;
  p.db = db;
  p.part_v = part_v;
  p.part_i = part_i;
  p.q_n = q_n, p.n = n, p.d = d, p.k = k, p.splits = splits;
  const int n_tiles = (n + BN - 1) / BN;
  p.rows_per_split = ((n_tiles + splits - 1) / splits) * BN;
  p.l2 = l2 != 0;
  cudaError_t err;
  if (p.l2) {
    p.q_sq = norms;
    p.d_sq = norms + q_n;
    err = knn::launch_norms<float>(q, q_n, d, norms, stream);
    if (err == cudaSuccess)
      err = knn::launch_norms<float>(db, n, d, norms + q_n, stream);
    if (err != cudaSuccess) return (int)err;
  }
  const int smem = (int)sizeof(Smem);
  err = cudaFuncSetAttribute(flat_topk_partial,
                             cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((q_n + BM - 1) / BM, splits);
  flat_topk_partial<<<grid, THREADS, smem, stream>>>(p);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  flat_topk_merge<<<(q_n + 127) / 128, 128, 0, stream>>>(
      part_v, part_i, vals, ids, q_n, k, splits);
  return (int)cudaGetLastError();
}

extern "C" const char* knn_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}
