// Kernel G: the fused T5 FFN block, out = x + relu(rms_norm(x) . wi) . wo.
//
// Replaces knn_for_homology_tpu/ops/ffn_pallas.py:_ffn_kernel (entry
// fused_ffn_t5) with its roundings: normed = bf16(bf16(x32 * rsqrt(mean(
// x32^2) + eps)) * ln); h = bf16(relu(normed . wi)) from fp32 sums; the
// second product summed in fp32 and added to x32 before the one cast.
//
// What bounds it on an H100, at the encoder's shapes (x [T, 1024] bf16,
// T <= 7000; wi [1024, 16384], wo [16384, 1024]): the products, 4*T*D*F =
// 4.7e11 flop at T = 7000, 0.48 ms at the 989 TFLOP/s bf16 peak; the bytes
// that must move are x and out (2 * 14 MB) and the weights (64 MB), 0.03 ms
// at 3.35 TB/s. The [T, d_ff] intermediate (229 MB of bf16 at T = 7000)
// never reaches device memory.
//
// Design. The TPU kept a [256, 1024] fp32 accumulator (1 MB) in VMEM per
// token tile; a block here has 227 KB of shared memory. So a block takes
// 32 tokens and keeps their [32, 1024] fp32 accumulator in the registers
// of its 16 warps (warp w owns output columns [64w, 64w + 64): 2 x 8 mma
// tiles, 64 floats a lane). The block normalises its 32 rows into shared
// memory once, then walks d_ff in 128-wide slices: h[32, 128] = relu(
// normed . wi[:, slice]) (one 16 x 16 tile per warp, K = 1024 staged 128
// rows at a time), rounded to bf16 into shared memory, then acc += h .
// wo[slice, :] (wo staged 32 rows at a time). The slices go in one fixed
// order and no atomics are used, so results repeat from run to run. The
// epilogue adds x in fp32 and writes bf16.
// Every token tile re-reads all of wi and wo: 64 MB x ceil(T / 32) blocks =
// 14 GB per call at T = 7000. Blocks are numbered by token tile, and all
// walk the slices in the same order, so the ~132 blocks resident at once
// read the same 512 KB slice of wi and wo at about the same time and serve
// it from L2; device memory sees the weights about once per wave. Tensor
// cores run through mma.sync (m16n8k16, fp32 accumulators); wgmma and TMA
// are later work.

#include <cuda_bf16.h>
#include <stdint.h>

#include "mma_bf16.cuh"

namespace {

using knn_mma::bf16;

constexpr int BM = 32;       // tokens per block
constexpr int WARPS = 16;
constexpr int THREADS = WARPS * 32;
constexpr int FS = 128;      // d_ff slice per step
constexpr int KC1 = 128;     // wi rows staged at a time
constexpr int KC2 = 32;      // wo rows staged at a time
constexpr int PAD = 8;       // row padding (bf16) against bank conflicts

template <int D>
struct Layout {
  static constexpr int LDN = D + PAD;    // normed [BM][LDN]
  static constexpr int LDH = FS + PAD;   // h [BM][LDH]
  static constexpr int LDW1 = FS + PAD;  // wi chunk [KC1][LDW1]
  static constexpr int LDW2 = D + PAD;   // wo chunk [KC2][LDW2]
  static constexpr int W = KC1 * LDW1 > KC2 * LDW2 ? KC1 * LDW1 : KC2 * LDW2;
  static constexpr size_t BYTES = sizeof(bf16) * (BM * LDN + BM * LDH + W);
  static constexpr int NT = D / (WARPS * 8);  // 8-column tiles per warp
};

template <int D>
__global__ void __launch_bounds__(THREADS, 1)
ffn_fused_kernel(const bf16* __restrict__ x, const bf16* __restrict__ ln,
                 const bf16* __restrict__ wi, const bf16* __restrict__ wo,
                 bf16* __restrict__ out, int t_n, int f_n, float eps) {
  using L = Layout<D>;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* s_n = reinterpret_cast<bf16*>(smem_raw);
  bf16* s_h = s_n + BM * L::LDN;
  bf16* s_w = s_h + BM * L::LDH;

  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane >> 2, t = lane & 3;
  const int row0 = blockIdx.x * BM;

  // prologue: rms-normalised rows, in the reference's two roundings
  for (int r = warp; r < BM; r += WARPS) {
    bf16* dst = s_n + r * L::LDN;
    const int row = row0 + r;
    if (row >= t_n) {
      for (int c = lane; c < D; c += 32) dst[c] = __float2bfloat16(0.0f);
      continue;
    }
    const bf16* src = x + (size_t)row * D;
    float ss = 0.0f;
    for (int c = lane; c < D; c += 32) {
      const float v = __bfloat162float(src[c]);
      ss += v * v;
    }
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) ss += __shfl_xor_sync(0xffffffffu, ss, o);
    const float inv = rsqrtf(ss / (float)D + eps);
    for (int c = lane; c < D; c += 32) {
      const float n = __bfloat162float(
          __float2bfloat16(__bfloat162float(src[c]) * inv));
      dst[c] = __float2bfloat16(n * __bfloat162float(ln[c]));
    }
  }
  __syncthreads();

  float acc[2][L::NT][4];
#pragma unroll
  for (int rt = 0; rt < 2; ++rt)
#pragma unroll
    for (int j = 0; j < L::NT; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[rt][j][e] = 0.0f;

  // step 1's tile of h: rows 16 * (warp / 8), columns 16 * (warp % 8)
  const int h_row = (warp >> 3) * 16, h_col = (warp & 7) * 16;
  const int o_col = warp * L::NT * 8;  // step 2's output columns

  for (int f0 = 0; f0 < f_n; f0 += FS) {
    float h[2][4] = {{0.0f, 0.0f, 0.0f, 0.0f}, {0.0f, 0.0f, 0.0f, 0.0f}};
    for (int k0 = 0; k0 < D; k0 += KC1) {
      knn_mma::copy_tile<KC1, FS, THREADS>(
          s_w, L::LDW1, wi + (size_t)k0 * f_n + f0, f_n, KC1);
      __syncthreads();
#pragma unroll
      for (int kk = 0; kk < KC1; kk += 16) {
        uint32_t a[4];
        knn_mma::ld_a(a, s_n + h_row * L::LDN + k0 + kk, L::LDN, g, t);
#pragma unroll
        for (int j = 0; j < 2; ++j) {
          uint32_t b0, b1;
          knn_mma::ld_b_kn(b0, b1, s_w + kk * L::LDW1 + h_col + 8 * j,
                           L::LDW1, g, t);
          knn_mma::mma(h[j], a, b0, b1);
        }
      }
      __syncthreads();
    }
#pragma unroll
    for (int j = 0; j < 2; ++j) {
      bf16* p = s_h + (h_row + g) * L::LDH + h_col + 8 * j + 2 * t;
      *reinterpret_cast<uint32_t*>(p) =
          knn_mma::pack(fmaxf(h[j][0], 0.0f), fmaxf(h[j][1], 0.0f));
      *reinterpret_cast<uint32_t*>(p + 8 * L::LDH) =
          knn_mma::pack(fmaxf(h[j][2], 0.0f), fmaxf(h[j][3], 0.0f));
    }
    // the first wo chunk's barrier also publishes s_h
    for (int k0 = 0; k0 < FS; k0 += KC2) {
      knn_mma::copy_tile<KC2, D, THREADS>(
          s_w, L::LDW2, wo + (size_t)(f0 + k0) * D, D, KC2);
      __syncthreads();
#pragma unroll
      for (int kk = 0; kk < KC2; kk += 16) {
        uint32_t a0[4], a1[4];
        knn_mma::ld_a(a0, s_h + k0 + kk, L::LDH, g, t);
        knn_mma::ld_a(a1, s_h + 16 * L::LDH + k0 + kk, L::LDH, g, t);
#pragma unroll
        for (int j = 0; j < L::NT; ++j) {
          uint32_t b0, b1;
          knn_mma::ld_b_kn(b0, b1, s_w + kk * L::LDW2 + o_col + 8 * j,
                           L::LDW2, g, t);
          knn_mma::mma(acc[0][j], a0, b0, b1);
          knn_mma::mma(acc[1][j], a1, b0, b1);
        }
      }
      __syncthreads();
    }
  }

  // epilogue: out = bf16(x32 + acc)
#pragma unroll
  for (int rt = 0; rt < 2; ++rt)
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const int row = row0 + 16 * rt + g + 8 * half;
      if (row >= t_n) continue;
#pragma unroll
      for (int j = 0; j < L::NT; ++j) {
        const size_t idx = (size_t)row * D + o_col + 8 * j + 2 * t;
        const __nv_bfloat162 xv =
            *reinterpret_cast<const __nv_bfloat162*>(x + idx);
        *reinterpret_cast<uint32_t*>(out + idx) = knn_mma::pack(
            __bfloat162float(xv.x) + acc[rt][j][2 * half],
            __bfloat162float(xv.y) + acc[rt][j][2 * half + 1]);
      }
    }
}

template <int D>
int launch(const bf16* x, const bf16* ln, const bf16* wi, const bf16* wo,
           bf16* out, int t_n, int f_n, float eps, cudaStream_t stream) {
  const int smem = (int)Layout<D>::BYTES;
  cudaError_t err = cudaFuncSetAttribute(
      ffn_fused_kernel<D>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return (int)err;
  ffn_fused_kernel<D><<<(t_n + BM - 1) / BM, THREADS, smem, stream>>>(
      x, ln, wi, wo, out, t_n, f_n, eps);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" int knn_ffn_fused(const void* x, const void* ln, const void* wi,
                             const void* wo, void* out, int t_n, int d,
                             int f_n, float eps, cudaStream_t stream) {
  if (t_n < 1 || f_n < FS || f_n % FS != 0) return (int)cudaErrorInvalidValue;
  const bf16* xb = static_cast<const bf16*>(x);
  const bf16* lb = static_cast<const bf16*>(ln);
  const bf16* wib = static_cast<const bf16*>(wi);
  const bf16* wob = static_cast<const bf16*>(wo);
  bf16* ob = static_cast<bf16*>(out);
  switch (d) {
    case 128: return launch<128>(xb, lb, wib, wob, ob, t_n, f_n, eps, stream);
    case 256: return launch<256>(xb, lb, wib, wob, ob, t_n, f_n, eps, stream);
    case 512: return launch<512>(xb, lb, wib, wob, ob, t_n, f_n, eps, stream);
    case 1024: return launch<1024>(xb, lb, wib, wob, ob, t_n, f_n, eps, stream);
    default: return (int)cudaErrorInvalidValue;
  }
}
