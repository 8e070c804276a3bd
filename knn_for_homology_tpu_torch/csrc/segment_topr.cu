// Kernel B: exact segment-top-R candidates for large-k selection.
//
// Replaces knn_for_homology_tpu/ops/exact_pallas.py:_segment_topr_kernel
// (entry _candidates_and_topk, before its epilogue). The database axis is
// cut into W strided segments: column c belongs to lane c mod W, and pass
// j covers columns j*W .. j*W+W-1. For every query and lane the kernel
// keeps the R largest ordered-int32 similarities (knn::ordered_int) seen in
// that lane, sorted descending, each with its pass index j. A strict `>`
// keeps the earlier pass on ties (the reference's lax.top_k order); empty
// slots hold INT32_MIN / -1. Buffer layout as in the reference: slot r of
// lane w sits at column r*W + w of the [Q, R*W] buffers. The epilogue (the
// two-key sort, the certificate, the rescue) stays in PyTorch, as it stayed
// outside the Pallas kernel (ops/exact_cuda.py).
//
// What bounds it here: the fp32 FFMA product, 2*Q*N*d flops; the [Q, N]
// similarity block never reaches device memory. On the TPU the R-slot
// state lived in VMEM across a sequential pass axis; on the card a block
// owns 32 queries x 64 lanes and loops over ALL passes itself, so no
// cross-block merge is needed. The R slots (R*W*8 bytes per query, too big
// for shared memory at R = 15..64) live in the output buffers in device
// memory, and each thread keeps the R-th kept value of its 8 (query, lane)
// pairs in registers: a candidate costs one register compare, and only the
// ~R*ln(passes/R) winners per lane touch memory (cached in L2).

#include <limits.h>

#include "knn_common.cuh"

namespace {

constexpr int TM = 2, TN = 4;  // 32 queries x 64 lanes per block
constexpr int BM = 16 * TM, BN = 16 * TN;

__global__ void __launch_bounds__(knn::kThreads)
segment_topr(const float* __restrict__ q, const float* __restrict__ db,
             int* __restrict__ buf_v, int* __restrict__ buf_i, int q_n, int n,
             int d, int w, int r_slots, bool l2) {
  __shared__ knn::TileSmem<TM, TN> s;
  const int tid = threadIdx.x;
  const int ty = tid / 16, tx = tid % 16;
  const int a0 = blockIdx.x * BM;
  const int lane0 = blockIdx.y * BN;
  const size_t width = (size_t)r_slots * w;

  int kept_min[TM][TN];  // R-th kept value of each owned (query, lane)
#pragma unroll
  for (int i = 0; i < TM; ++i) {
    const int qi = a0 + ty * TM + i;
#pragma unroll
    for (int j = 0; j < TN; ++j) {
      kept_min[i][j] = INT_MIN;
      if (qi < q_n) {
        const size_t base = (size_t)qi * width + lane0 + tx * TN + j;
        for (int r = 0; r < r_slots; ++r) {
          buf_v[base + (size_t)r * w] = INT_MIN;
          buf_i[base + (size_t)r * w] = -1;
        }
      }
    }
  }

  const int passes = (n + w - 1) / w;
  float acc[TM][TN];
  for (int pass = 0; pass < passes; ++pass) {
    const int b0 = pass * w + lane0;
    knn::tile_dots<TM, TN>(q, q_n, a0, db, n, b0, d, l2, s, acc);
#pragma unroll
    for (int i = 0; i < TM; ++i) {
      const int il = ty * TM + i;
      if (a0 + il >= q_n) continue;
#pragma unroll
      for (int j = 0; j < TN; ++j) {
        const int jl = tx * TN + j;
        const int v =
            (b0 + jl < n)
                ? knn::ordered_int(knn::tile_sim<TM, TN>(s, acc[i][j], il, jl, l2))
                : INT_MIN;
        if (v <= kept_min[i][j]) continue;
        // sorted insert (desc); equal values stay ahead = earlier pass
        const size_t base = (size_t)(a0 + il) * width + lane0 + jl;
        int p = r_slots - 1;
        int new_min = v;
        while (p > 0) {
          const int pv = buf_v[base + (size_t)(p - 1) * w];
          if (pv >= v) break;
          if (p == r_slots - 1) new_min = pv;
          buf_v[base + (size_t)p * w] = pv;
          buf_i[base + (size_t)p * w] = buf_i[base + (size_t)(p - 1) * w];
          --p;
        }
        buf_v[base + (size_t)p * w] = v;
        buf_i[base + (size_t)p * w] = pass;
        kept_min[i][j] = new_min;
      }
    }
  }
}

}  // namespace

extern "C" int knn_segment_topr(const float* q, const float* db, int* buf_v,
                                int* buf_i, int q_n, int n, int d, int w,
                                int r_slots, int l2, cudaStream_t stream) {
  if (w < BN || w % BN != 0 || r_slots < 1 || q_n < 1 || n < 1)
    return (int)cudaErrorInvalidValue;
  const dim3 grid((q_n + BM - 1) / BM, w / BN);
  segment_topr<<<grid, knn::kThreads, 0, stream>>>(q, db, buf_v, buf_i, q_n, n,
                                                   d, w, r_slots, l2 != 0);
  return (int)cudaGetLastError();
}
