// Shared device code of the search kernels (flat_topk.cu, segment_topr.cu,
// segment_packed.cu): a register-tiled fp32 FFMA tile product, the
// squared row norms of the l2 epilogues and the monotone float -> int32
// map of the segment kernels.
//
// The FFMA tile product (D's fp32 route, segment_packed.cu) keeps full
// fp32: the reference computes these dots at Precision.HIGHEST, and a
// single TF32 product's ~3 decimal digits would swap near-tie neighbours.
// Kernel B takes the same precision on the tensor cores as 3xTF32 products
// (tf32x3.cuh); kernel A keeps its own FFMA product summed in k order
// (flat_topk.cu says why). 256 threads compute a
// BM x BN = (16*TM) x (16*TN) block of q . db^T, staging BK = 16 columns
// of each operand in shared memory per step. Operands may be float, bf16
// or int8; they are widened to float (exactly) when staged.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace knn {

__device__ __forceinline__ float to_float(float x) { return x; }
__device__ __forceinline__ float to_float(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
__device__ __forceinline__ float to_float(int8_t x) { return (float)x; }

constexpr int kThreads = 256;
constexpr int kBK = 16;

template <int TM, int TN>
struct TileSmem {
  static constexpr int BM = 16 * TM;
  static constexpr int BN = 16 * TN;
  // +4 keeps rows 16-byte aligned while breaking the store bank pattern
  float a[kBK][BM + 4];
  float b[kBK][BN + 4];
  float a_sq[BM];
  float b_sq[BN];
};

// acc[i][j] = dot(A[a0 + ty*TM + i], B[b0 + tx*TN + j]) over d columns,
// rows past a_rows / b_rows read as zero. With `norms`, the squared row
// norms of both blocks land in s.a_sq / s.b_sq (for l2). Ends with a
// __syncthreads(), so s may be reused right after.
template <int TM, int TN, typename TA, typename TB>
__device__ __forceinline__ void tile_dots(
    const TA* __restrict__ A, int a_rows, int a0,
    const TB* __restrict__ B, int b_rows, int b0, int d, bool norms,
    TileSmem<TM, TN>& s, float (&acc)[TM][TN]) {
  constexpr int BM = TileSmem<TM, TN>::BM;
  constexpr int BN = TileSmem<TM, TN>::BN;
  const int tid = threadIdx.x;
  const int ty = tid / 16, tx = tid % 16;
#pragma unroll
  for (int i = 0; i < TM; ++i)
#pragma unroll
    for (int j = 0; j < TN; ++j) acc[i][j] = 0.f;
  float sq = 0.f;

  for (int k0 = 0; k0 < d; k0 += kBK) {
    // consecutive threads read consecutive columns of one row (64-byte runs)
#pragma unroll
    for (int p = 0; p < TM; ++p) {
      const int e = tid + kThreads * p;
      const int m = e / kBK, kk = e % kBK;
      const int row = a0 + m, col = k0 + kk;
      s.a[kk][m] =
          (row < a_rows && col < d) ? to_float(A[(size_t)row * d + col]) : 0.f;
    }
#pragma unroll
    for (int p = 0; p < TN; ++p) {
      const int e = tid + kThreads * p;
      const int n = e / kBK, kk = e % kBK;
      const int row = b0 + n, col = k0 + kk;
      s.b[kk][n] =
          (row < b_rows && col < d) ? to_float(B[(size_t)row * d + col]) : 0.f;
    }
    __syncthreads();
    if (norms) {
      if (tid < BM) {
#pragma unroll
        for (int kk = 0; kk < kBK; ++kk) sq = fmaf(s.a[kk][tid], s.a[kk][tid], sq);
      } else if (tid < BM + BN) {
        const int n = tid - BM;
#pragma unroll
        for (int kk = 0; kk < kBK; ++kk) sq = fmaf(s.b[kk][n], s.b[kk][n], sq);
      }
    }
#pragma unroll
    for (int kk = 0; kk < kBK; ++kk) {
      float a[TM], b[TN];
#pragma unroll
      for (int i = 0; i < TM; ++i) a[i] = s.a[kk][ty * TM + i];
#pragma unroll
      for (int j = 0; j < TN; ++j) b[j] = s.b[kk][tx * TN + j];
#pragma unroll
      for (int i = 0; i < TM; ++i)
#pragma unroll
        for (int j = 0; j < TN; ++j) acc[i][j] = fmaf(a[i], b[j], acc[i][j]);
    }
    __syncthreads();
  }
  if (norms) {
    if (tid < BM) s.a_sq[tid] = sq;
    else if (tid < BM + BN) s.b_sq[tid - BM] = sq;
  }
  __syncthreads();
}

// Internal bigger-is-better similarity (ops/distance.py convention).
template <int TM, int TN>
__device__ __forceinline__ float tile_sim(const TileSmem<TM, TN>& s,
                                          float dot, int i_local, int j_local,
                                          bool l2) {
  return l2 ? 2.f * dot - s.a_sq[i_local] - s.b_sq[j_local] : dot;
}

// Monotone float32-bits -> int32 map (an involution): int32 order of the
// result equals float order of the input (reference: exact_pallas._ordered_int).
__device__ __forceinline__ int32_t ordered_int(float v) {
  const int32_t u = __float_as_int(v);
  return u ^ ((u >> 31) & 0x7FFFFFFF);
}

// Squared row norms |x_i|^2 in fp32 for the l2 epilogues of A, B, D and E,
// one warp a row. (Unnamed namespace: each unit keeps its own copy.)
namespace {

template <typename T>
__global__ void __launch_bounds__(256)
row_sq_norms(const T* __restrict__ x, int rows, int d, float* __restrict__ out) {
  const int row = blockIdx.x * 8 + threadIdx.x / 32, lane = threadIdx.x % 32;
  if (row >= rows) return;
  float sq = 0.f;
  for (int c = lane; c < d; c += 32) {
    const float v = to_float(x[(size_t)row * d + c]);
    sq = fmaf(v, v, sq);
  }
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) sq += __shfl_xor_sync(0xffffffffu, sq, o);
  if (lane == 0) out[row] = sq;
}

template <typename T>
cudaError_t launch_norms(const void* x, int rows, int d, float* out,
                         cudaStream_t stream) {
  row_sq_norms<T><<<(rows + 7) / 8, 256, 0, stream>>>(
      static_cast<const T*>(x), rows, d, out);
  return cudaGetLastError();
}

}  // namespace

}  // namespace knn
