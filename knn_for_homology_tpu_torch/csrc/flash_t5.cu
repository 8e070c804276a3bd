// Kernel H: T5 flash attention, forward, with the offset-bias table.
//
// Replaces knn_for_homology_tpu/ops/flash_attention.py:_flash_kernel (entry
// flash_attention_t5): an online softmax of q.k + bias(k_pos - q_pos) with
// the Pallas kernel's numerics. The running max starts at -1e9; masked keys
// get the -1e9 fill AND their p multiplied by 0 (a row with no real key
// ends at 0, not NaN); the normaliser sums the fp32 p; p is cast to bf16
// for the PV product, which sums in fp32; out = bf16(acc / max(l, 1e-30)).
// T5 has no 1/sqrt(d_kv) scale.
//
// What bounds it on an H100, at the encoder's long batches (q, k, v
// [B, 32, L, 128] bf16, L = 1152..3200, B = floor(7000 / L)): the two
// products, 4*B*H*L^2*128 flop = 3.4e11 at B = 2, L = 3200, 0.34 ms at the
// 989 TFLOP/s bf16 peak; q, k, v and out are 4 * 52 MB, 0.06 ms at 3.35
// TB/s. The [L, L] scores never reach device memory.
//
// Design. The Toeplitz [n_rel, H, block, block] bias blocks of the TPU
// kernel were a Mosaic workaround; the bias depends only on the offset, so
// the block holds its head's row of the [H, 2L-1] fp32 table (25.6 KB at
// L = 3200, built once per encode and shared by all layers) in shared
// memory. A block takes 64 queries of one (batch row, head), four warps of
// 16 rows each, and loops over the keys in 64-key steps staged in shared
// memory (the TPU's sequential kv grid axis becomes this loop). Scores come
// from mma.sync (m16n8k16, bf16 in, fp32 out) with q held in registers; the
// C layout tells each lane its two rows, so the running max, the
// correction and the normaliser are reduced over the 4 lanes of a row
// group, and p turns into the PV product's A fragments without leaving
// registers. The ragged edge (L need not be a multiple of 64) is masked
// here; no padding. Blocks are numbered query tile first, so the blocks
// resident at once share one head's k and v in L2. Simple and correct
// first: no cp.async pipelining, no wgmma.

#include <cuda_bf16.h>
#include <stdint.h>

#include "mma_bf16.cuh"

namespace {

using knn_mma::bf16;

constexpr int BQ = 64;  // queries per block (4 warps x 16)
constexpr int BK = 64;  // keys per step
constexpr int DK = 128;
constexpr int LDK = DK + 8;
constexpr int THREADS = 128;
constexpr float NEG = -1e9f;

__global__ void __launch_bounds__(THREADS)
flash_t5_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                const bf16* __restrict__ v, const uint8_t* __restrict__ mask,
                const float* __restrict__ table, bf16* __restrict__ out,
                int h_n, int l) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* s_k = reinterpret_cast<bf16*>(smem_raw);
  bf16* s_v = s_k + BK * LDK;
  float* s_keep = reinterpret_cast<float*>(s_v + BK * LDK);  // [BK]
  float* s_bias = s_keep + BK;                                 // [2l - 1]

  const int head = blockIdx.y, b = blockIdx.z;
  const size_t base = ((size_t)b * h_n + head) * (size_t)l * DK;
  const bf16* qb = q + base;
  const bf16* kb = k + base;
  const bf16* vb = v + base;
  const uint8_t* mb = mask + (size_t)b * l;
  const float* tb = table + (size_t)head * (2 * l - 1);
  for (int i = threadIdx.x; i < 2 * l - 1; i += THREADS) s_bias[i] = tb[i];

  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane >> 2, t = lane & 3;
  const int r0 = blockIdx.x * BQ + warp * 16 + g, r1 = r0 + 8;
  // bias index k - q + l - 1, with q and k clamped to l - 1 so that it
  // stays inside the table: padded rows (>= l) are never stored, padded
  // keys are masked
  const int bq0 = l - 1 - min(r0, l - 1), bq1 = l - 1 - min(r1, l - 1);

  // this lane's q fragments for all of d_kv (rows past l are zeros)
  uint32_t qa[DK / 16][4];
#pragma unroll
  for (int kk = 0; kk < DK / 16; ++kk) {
    const int c = kk * 16 + 2 * t;
    qa[kk][0] = r0 < l ? knn_mma::ld_pair(qb + (size_t)r0 * DK + c) : 0u;
    qa[kk][1] = r1 < l ? knn_mma::ld_pair(qb + (size_t)r1 * DK + c) : 0u;
    qa[kk][2] = r0 < l ? knn_mma::ld_pair(qb + (size_t)r0 * DK + c + 8) : 0u;
    qa[kk][3] = r1 < l ? knn_mma::ld_pair(qb + (size_t)r1 * DK + c + 8) : 0u;
  }

  float m0 = NEG, m1 = NEG, l0 = 0.0f, l1 = 0.0f;
  float o[DK / 8][4];
#pragma unroll
  for (int n = 0; n < DK / 8; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) o[n][e] = 0.0f;

  for (int k0 = 0; k0 < l; k0 += BK) {
    __syncthreads();  // the last step's reads are done (and s_bias is in)
    const int valid = min(BK, l - k0);
    knn_mma::copy_tile<BK, DK, THREADS>(s_k, LDK, kb + (size_t)k0 * DK, DK,
                                        valid);
    knn_mma::copy_tile<BK, DK, THREADS>(s_v, LDK, vb + (size_t)k0 * DK, DK,
                                        valid);
    if (threadIdx.x < BK)
      s_keep[threadIdx.x] =
          (threadIdx.x < valid && mb[k0 + threadIdx.x]) ? 1.0f : 0.0f;
    __syncthreads();

    // scores: 16 rows x 64 keys per warp
    float s[BK / 8][4];
#pragma unroll
    for (int j = 0; j < BK / 8; ++j) {
#pragma unroll
      for (int e = 0; e < 4; ++e) s[j][e] = 0.0f;
#pragma unroll
      for (int kk = 0; kk < DK / 16; ++kk) {
        uint32_t b0, b1;
        knn_mma::ld_b_nk(b0, b1, s_k + (8 * j) * LDK + kk * 16, LDK, g, t);
        knn_mma::mma(s[j], qa[kk], b0, b1);
      }
    }

    // + bias, mask fill, running max
    float mx0 = m0, mx1 = m1;
#pragma unroll
    for (int j = 0; j < BK / 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int kl = 8 * j + 2 * t + (e & 1);
        const int off = min(k0 + kl, l - 1) + (e < 2 ? bq0 : bq1);
        const float val = s_keep[kl] != 0.0f ? s[j][e] + s_bias[off] : NEG;
        s[j][e] = val;
        if (e < 2) mx0 = fmaxf(mx0, val);
        else mx1 = fmaxf(mx1, val);
      }
    mx0 = knn_mma::group_max(mx0);
    mx1 = knn_mma::group_max(mx1);
    const float c0 = expf(m0 - mx0), c1 = expf(m1 - mx1);

    float sum0 = 0.0f, sum1 = 0.0f;
#pragma unroll
    for (int j = 0; j < BK / 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float p = expf(s[j][e] - (e < 2 ? mx0 : mx1)) *
                        s_keep[8 * j + 2 * t + (e & 1)];
        s[j][e] = p;
        if (e < 2) sum0 += p;
        else sum1 += p;
      }
    l0 = l0 * c0 + knn_mma::group_sum(sum0);
    l1 = l1 * c1 + knn_mma::group_sum(sum1);
    m0 = mx0;
    m1 = mx1;
#pragma unroll
    for (int n = 0; n < DK / 8; ++n) {
      o[n][0] *= c0;
      o[n][1] *= c0;
      o[n][2] *= c1;
      o[n][3] *= c1;
    }

    // o += bf16(p) . v
#pragma unroll
    for (int kk = 0; kk < BK / 16; ++kk) {
      const uint32_t a[4] = {
          knn_mma::pack(s[2 * kk][0], s[2 * kk][1]),
          knn_mma::pack(s[2 * kk][2], s[2 * kk][3]),
          knn_mma::pack(s[2 * kk + 1][0], s[2 * kk + 1][1]),
          knn_mma::pack(s[2 * kk + 1][2], s[2 * kk + 1][3]),
      };
#pragma unroll
      for (int n = 0; n < DK / 8; ++n) {
        uint32_t b0, b1;
        knn_mma::ld_b_kn(b0, b1, s_v + (16 * kk) * LDK + 8 * n, LDK, g, t);
        knn_mma::mma(o[n], a, b0, b1);
      }
    }
  }

  const float d0 = fmaxf(l0, 1e-30f), d1 = fmaxf(l1, 1e-30f);
#pragma unroll
  for (int n = 0; n < DK / 8; ++n) {
    const int c = 8 * n + 2 * t;
    if (r0 < l)
      *reinterpret_cast<uint32_t*>(out + base + (size_t)r0 * DK + c) =
          knn_mma::pack(o[n][0] / d0, o[n][1] / d0);
    if (r1 < l)
      *reinterpret_cast<uint32_t*>(out + base + (size_t)r1 * DK + c) =
          knn_mma::pack(o[n][2] / d1, o[n][3] / d1);
  }
}

}  // namespace

extern "C" int knn_flash_t5(const void* q, const void* k, const void* v,
                            const void* mask, const void* table, void* out,
                            int b_n, int h_n, int l, cudaStream_t stream) {
  if (b_n < 1 || h_n < 1 || l < 1 || h_n > 65535 || b_n > 65535)
    return (int)cudaErrorInvalidValue;
  const size_t smem = sizeof(bf16) * 2 * BK * LDK + sizeof(float) * BK +
                      sizeof(float) * (2 * (size_t)l - 1);
  cudaError_t err = cudaFuncSetAttribute(
      flash_t5_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((l + BQ - 1) / BQ, h_n, b_n);
  flash_t5_kernel<<<grid, THREADS, smem, stream>>>(
      static_cast<const bf16*>(q), static_cast<const bf16*>(k),
      static_cast<const bf16*>(v), static_cast<const uint8_t*>(mask),
      static_cast<const float*>(table), static_cast<bf16*>(out), h_n, l);
  return (int)cudaGetLastError();
}
