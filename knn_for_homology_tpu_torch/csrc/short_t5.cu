// Kernel I: dense T5 attention for short sequences (L <= 512).
//
// Replaces knn_for_homology_tpu/ops/short_attention.py:_short_kernel (entry
// short_attention_t5), with models/t5.py:_attention's numerics: exact fp32
// scores q.k plus the [H, L, L] fp32 bias, the -1e9 fill for masked keys
// (p is NOT zeroed, so a row with every key masked softmaxes to uniform),
// max, exp, sum and divide in fp32, p cast to bf16, PV summed in fp32 and
// cast once. T5 has no 1/sqrt(d_kv) scale.
//
// What bounds it on an H100, at the opt-in short batches (q, k, v
// [B, 32, L, 128] bf16, L = 512, B = 13): the products, 4*B*H*L^2*128 flop =
// 5.6e10, 0.056 ms at the 989 TFLOP/s bf16 peak; the bytes, q, k, v, out
// (4 * 54.5 MB) plus the bias (32 MB), 0.075 ms at 3.35 TB/s. So it is
// bound by bytes, and the bias is the trap: read once per batch row it
// would be 416 MB per layer at B = 13, more than the products cost.
//
// Design. Blocks are numbered query tile first, then batch row, then head
// (the TPU kernel's (head group, batch) grid order), so the blocks resident
// at once read one head's 1 MB of bias and serve it from L2 to every batch
// row. A block takes 64 queries of one (batch row, head), four warps of 16
// rows each: its [64, L] fp32 score tile (up to 129 KB) lives in shared
// memory. Pass 1 streams the keys in 64-key steps, computes q.k with
// mma.sync (m16n8k16, bf16 in, fp32 out; q held in registers), adds the
// bias and the mask fill, and stores the scores. Pass 2 turns each row into
// exact softmax probabilities in place. Pass 3 streams v in 64-key steps and
// sums bf16(p) . v into fp32 registers. Keys past L (the last step's ragged
// edge) score -inf, so they weigh nothing even in an all-masked row, which
// then averages over exactly L keys. Simple and correct first: no
// pipelining, one block per SM.

#include <cuda_bf16.h>
#include <math.h>
#include <stdint.h>

#include "mma_bf16.cuh"

namespace {

using knn_mma::bf16;

constexpr int BQ = 64;  // queries per block (4 warps x 16)
constexpr int BK = 64;  // keys per step
constexpr int DK = 128;
constexpr int LDK = DK + 8;
constexpr int THREADS = 128;
constexpr int MAX_L = 512;
constexpr float NEG = -1e9f;

__host__ __device__ constexpr int padded(int l) { return (l + BK - 1) / BK * BK; }

__global__ void __launch_bounds__(THREADS, 1)
short_t5_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                const bf16* __restrict__ v, const uint8_t* __restrict__ mask,
                const float* __restrict__ bias, bf16* __restrict__ out,
                int h_n, int l) {
  const int lp = padded(l), lds = lp + 4;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  float* s_s = reinterpret_cast<float*>(smem_raw);             // [BQ][lds]
  bf16* s_kv = reinterpret_cast<bf16*>(s_s + BQ * lds);        // [BK][LDK]
  float* s_code = reinterpret_cast<float*>(s_kv + BK * LDK);   // [lp]

  const int b = blockIdx.y, head = blockIdx.z;
  const size_t base = ((size_t)b * h_n + head) * (size_t)l * DK;
  const bf16* qb = q + base;
  const bf16* kb = k + base;
  const bf16* vb = v + base;
  const float* hb = bias + (size_t)head * l * l;
  // key code: 1 real, 0 masked (-1e9 fill), -1 past L (-inf)
  for (int i = threadIdx.x; i < lp; i += THREADS)
    s_code[i] = i < l ? (mask[(size_t)b * l + i] ? 1.0f : 0.0f) : -1.0f;

  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane >> 2, t = lane & 3;
  const int lr0 = warp * 16 + g;  // this lane's rows in the tile: lr0, lr0 + 8
  const int r0 = blockIdx.x * BQ + lr0, r1 = r0 + 8;
  // bias rows of padded queries (>= l, never stored) read row l - 1
  const float* bias0 = hb + (size_t)min(r0, l - 1) * l;
  const float* bias1 = hb + (size_t)min(r1, l - 1) * l;

  uint32_t qa[DK / 16][4];
#pragma unroll
  for (int kk = 0; kk < DK / 16; ++kk) {
    const int c = kk * 16 + 2 * t;
    qa[kk][0] = r0 < l ? knn_mma::ld_pair(qb + (size_t)r0 * DK + c) : 0u;
    qa[kk][1] = r1 < l ? knn_mma::ld_pair(qb + (size_t)r1 * DK + c) : 0u;
    qa[kk][2] = r0 < l ? knn_mma::ld_pair(qb + (size_t)r0 * DK + c + 8) : 0u;
    qa[kk][3] = r1 < l ? knn_mma::ld_pair(qb + (size_t)r1 * DK + c + 8) : 0u;
  }

  // pass 1: scores + bias, mask fill → s_s
  for (int k0 = 0; k0 < lp; k0 += BK) {
    __syncthreads();  // the last step's reads of s_kv are done
    knn_mma::copy_tile<BK, DK, THREADS>(s_kv, LDK, kb + (size_t)k0 * DK, DK,
                                        min(BK, l - k0));
    __syncthreads();
#pragma unroll
    for (int j = 0; j < BK / 8; ++j) {
      float s[4] = {0.0f, 0.0f, 0.0f, 0.0f};
#pragma unroll
      for (int kk = 0; kk < DK / 16; ++kk) {
        uint32_t b0, b1;
        knn_mma::ld_b_nk(b0, b1, s_kv + (8 * j) * LDK + kk * 16, LDK, g, t);
        knn_mma::mma(s, qa[kk], b0, b1);
      }
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int key = k0 + 8 * j + 2 * t + (e & 1);
        const float code = s_code[key];
        const float* brow = e < 2 ? bias0 : bias1;
        float val = -INFINITY;
        if (code > 0.0f) val = s[e] + brow[key];
        else if (code == 0.0f) val = NEG;
        s_s[(lr0 + (e < 2 ? 0 : 8)) * lds + key] = val;
      }
    }
  }
  __syncwarp();

  // pass 2: each warp turns its 16 rows into softmax probabilities
  for (int r = 0; r < 16; ++r) {
    float* row = s_s + (warp * 16 + r) * lds;
    float mx = -INFINITY;
    for (int c = lane; c < lp; c += 32) mx = fmaxf(mx, row[c]);
#pragma unroll
    for (int o = 16; o > 0; o >>= 1)
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, o));
    float sum = 0.0f;
    for (int c = lane; c < lp; c += 32) {
      const float e = expf(row[c] - mx);
      row[c] = e;
      sum += e;
    }
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) sum += __shfl_xor_sync(0xffffffffu, sum, o);
    for (int c = lane; c < lp; c += 32) row[c] = row[c] / sum;
  }
  __syncwarp();

  // pass 3: o = bf16(p) . v
  float o[DK / 8][4];
#pragma unroll
  for (int n = 0; n < DK / 8; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) o[n][e] = 0.0f;
  const float* p0 = s_s + lr0 * lds;
  const float* p1 = p0 + 8 * lds;
  for (int k0 = 0; k0 < lp; k0 += BK) {
    __syncthreads();
    knn_mma::copy_tile<BK, DK, THREADS>(s_kv, LDK, vb + (size_t)k0 * DK, DK,
                                        min(BK, l - k0));
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < BK / 16; ++kk) {
      const int c = k0 + 16 * kk + 2 * t;
      const uint32_t a[4] = {
          knn_mma::pack(p0[c], p0[c + 1]),
          knn_mma::pack(p1[c], p1[c + 1]),
          knn_mma::pack(p0[c + 8], p0[c + 9]),
          knn_mma::pack(p1[c + 8], p1[c + 9]),
      };
#pragma unroll
      for (int n = 0; n < DK / 8; ++n) {
        uint32_t b0, b1;
        knn_mma::ld_b_kn(b0, b1, s_kv + (16 * kk) * LDK + 8 * n, LDK, g, t);
        knn_mma::mma(o[n], a, b0, b1);
      }
    }
  }

#pragma unroll
  for (int n = 0; n < DK / 8; ++n) {
    const int c = 8 * n + 2 * t;
    if (r0 < l)
      *reinterpret_cast<uint32_t*>(out + base + (size_t)r0 * DK + c) =
          knn_mma::pack(o[n][0], o[n][1]);
    if (r1 < l)
      *reinterpret_cast<uint32_t*>(out + base + (size_t)r1 * DK + c) =
          knn_mma::pack(o[n][2], o[n][3]);
  }
}

}  // namespace

extern "C" int knn_short_t5(const void* q, const void* k, const void* v,
                            const void* mask, const void* bias, void* out,
                            int b_n, int h_n, int l, cudaStream_t stream) {
  if (b_n < 1 || h_n < 1 || l < 1 || l > MAX_L || b_n > 65535 || h_n > 65535)
    return (int)cudaErrorInvalidValue;
  const int lp = padded(l);
  const size_t smem = sizeof(float) * BQ * (lp + 4) +
                      sizeof(bf16) * BK * LDK + sizeof(float) * lp;
  cudaError_t err = cudaFuncSetAttribute(
      short_t5_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((l + BQ - 1) / BQ, b_n, h_n);
  short_t5_kernel<<<grid, THREADS, smem, stream>>>(
      static_cast<const bf16*>(q), static_cast<const bf16*>(k),
      static_cast<const bf16*>(v), static_cast<const uint8_t*>(mask),
      static_cast<const float*>(bias), static_cast<bf16*>(out), h_n, l);
  return (int)cudaGetLastError();
}
