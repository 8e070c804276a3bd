// Kernel A: fused fp32 distance + exact small-k top-k (k <= 32).
//
// Replaces knn_for_homology_tpu/ops/flat_pallas.py:_flat_topk_kernel
// (entry pallas_flat_topk): q . db^T (l2 as 2qd - |q|^2 - |d|^2), rows >= n
// masked to -inf, the k best per query ordered by value descending, lower id
// first on ties.
//
// What bounds it here: the fp32 FFMA product, 2*Q*N*d flops (no TF32, see
// knn_common.cuh); the selection is a few compares per similarity and the
// [Q, N] block never reaches device memory. On the TPU the winner set was
// carried across a SEQUENTIAL database grid axis. Blocks on the card run in
// parallel and in no order, so the database is cut into `splits` contiguous
// row ranges, one per blockIdx.y, each scanned by a loop inside its block;
// a second small kernel merges the per-split lists. Split s holds only ids
// below split s+1's, and each list is already in (value desc, id asc)
// order, so merging the splits in order with a strict `>` keeps the
// lower-id-first tie rule across the merge.
//
// Block: 64 queries x 64 db rows per step (4x4 outputs per thread); the
// 64 threads that own a query then fold the step's 64 similarities into
// that query's sorted list in shared memory. A candidate costs one compare
// against the running k-th value; only winners pay the insertion.

#include <math.h>

#include "knn_common.cuh"

namespace {

constexpr int kMaxK = 32;
constexpr int TM = 4, TN = 4;
constexpr int BM = 16 * TM, BN = 16 * TN;

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

__global__ void __launch_bounds__(knn::kThreads)
flat_topk_partial(const float* __restrict__ q, const float* __restrict__ db,
                  float* __restrict__ part_v, int* __restrict__ part_i,
                  int q_n, int n, int d, int k, int splits, int rows_per_split,
                  bool l2) {
  __shared__ knn::TileSmem<TM, TN> s;
  __shared__ float sims[BM][BN + 1];
  __shared__ float best_v[BM][kMaxK + 1];  // +1: rows on distinct banks
  __shared__ int best_i[BM][kMaxK + 1];

  const int tid = threadIdx.x;
  const int ty = tid / 16, tx = tid % 16;
  const int a0 = blockIdx.x * BM;
  const int split = blockIdx.y;
  const int row_lo = split * rows_per_split;
  const int row_hi = min(n, row_lo + rows_per_split);

  for (int e = tid; e < BM * kMaxK; e += knn::kThreads) {
    best_v[e / kMaxK][e % kMaxK] = -INFINITY;
    best_i[e / kMaxK][e % kMaxK] = -1;
  }
  __syncthreads();  // owners read rows other threads initialised
  float kth = -INFINITY;  // running k-th value of query a0 + tid (tid < BM)
  const bool owner = tid < BM && a0 + tid < q_n;

  float acc[TM][TN];
  for (int b0 = row_lo; b0 < row_hi; b0 += BN) {
    knn::tile_dots<TM, TN>(q, q_n, a0, db, row_hi, b0, d, l2, s, acc);
#pragma unroll
    for (int i = 0; i < TM; ++i)
#pragma unroll
      for (int j = 0; j < TN; ++j) {
        const int il = ty * TM + i, jl = tx * TN + j;
        sims[il][jl] = (b0 + jl < row_hi)
                           ? knn::tile_sim<TM, TN>(s, acc[i][j], il, jl, l2)
                           : -INFINITY;
      }
    __syncthreads();
    if (owner) {
      for (int c = 0; c < BN; ++c) {
        const float v = sims[tid][c];
        if (v > kth) {
          insert_sorted(best_v[tid], best_i[tid], k, v, b0 + c);
          kth = best_v[tid][k - 1];
        }
      }
    }
    __syncthreads();
  }
  if (owner) {
    const size_t base = ((size_t)(a0 + tid) * splits + split) * k;
    for (int r = 0; r < k; ++r) {
      part_v[base + r] = best_v[tid][r];
      part_i[base + r] = best_i[tid][r];
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

extern "C" int knn_flat_topk(const float* q, const float* db, float* vals,
                             int* ids, float* part_v, int* part_i, int q_n,
                             int n, int d, int k, int splits, int l2,
                             cudaStream_t stream) {
  if (k < 1 || k > kMaxK || splits < 1 || q_n < 1 || n < 1)
    return (int)cudaErrorInvalidValue;
  const int n_tiles = (n + BN - 1) / BN;
  const int rows_per_split = ((n_tiles + splits - 1) / splits) * BN;
  const dim3 grid((q_n + BM - 1) / BM, splits);
  flat_topk_partial<<<grid, knn::kThreads, 0, stream>>>(
      q, db, part_v, part_i, q_n, n, d, k, splits, rows_per_split, l2 != 0);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  flat_topk_merge<<<(q_n + 127) / 128, 128, 0, stream>>>(
      part_v, part_i, vals, ids, q_n, k, splits);
  return (int)cudaGetLastError();
}

extern "C" const char* knn_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}
