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
// at 3.35 TB/s.
//
// Design: three kernels on the call's stream. The TPU kept a [256, 1024]
// fp32 accumulator in VMEM per token tile; here wgmma takes 64-row tiles,
// and a [64, 1024] fp32 output accumulator (256 KB) fits neither a block's
// registers nor its 227 KB of shared memory, so the fused form would force
// a 32-token mma.sync tile that re-reads all 64 MB of weights per tile.
// Instead h goes through device memory, [T, F] bf16 scratch from the
// wrapper (229 MB at T = 7000; its write and read, 458 MB, take ~0.14 ms at
// 3.35 TB/s, under a third of the product bound):
//   1. rms_norm_kernel writes normed [T, D] bf16, one warp a row;
//   2. gemm_kernel<RELU>: h = bf16(relu(normed . wi));
//   3. gemm_kernel<RESIDUAL>: out = bf16(x32 + h . wo).
// The GEMM: a block computes a BM x BN = 128 x 256 tile (128 for N = 128)
// with two consumer warpgroups of 64 rows (wgmma m64n128k16 bf16 -> fp32,
// A K-major, B [K, N] row-major read MN-major through the descriptor's
// transpose bit) and a producer warp whose lane 0 keeps a ring of STAGES
// TMA-fed, 128-byte-swizzled (A, B) k-slices of 64 in flight. The grid is
// persistent: one block per SM walks the tiles, and its producer loads the
// next tile's first slices while the consumers store this tile (at K =
// 1024 a tile has only 16 slices, so a fresh block per tile would wait for
// its ring to fill every time). Tiles are numbered N tile first, so the
// tiles in flight at once share their A rows in L2. Every tile sums its
// whole K in one fixed order and no atomics are used, so results repeat
// from run to run. TMA reads past T (and past N) as zeros; the epilogue
// stores inside [T, N] only.

#include <cuda.h>
#include <cuda_bf16.h>
#include <stdint.h>

#include "hopper.cuh"

namespace {

using namespace knn_sm90;
using bf16 = __nv_bfloat16;

constexpr int BM = 128;               // rows per block: two warpgroups
constexpr int BK = 64;                // k per stage: one 128-byte row
constexpr int THREADS = 2 * 128 + 32;  // consumers + the producer warp
constexpr int A_BYTES = BM * BK * 2;  // 16 KB

template <int BN>
struct Gemm {
  static constexpr int NB = BN / 128;            // m64n128 products a k-step
  static constexpr int B_BYTES = BK * BN * 2;    // [BN / 64][BK][64]
  static constexpr int STAGE = A_BYTES + B_BYTES;
  static constexpr int STAGES = BN == 256 ? 4 : 6;
  static constexpr size_t SMEM = 1024 + (size_t)STAGES * STAGE + 16 * STAGES;
};

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

// d[64 x 128] += A[64 x 16] (K-major) . B[16 x 128] (MN-major), both in
// shared memory
__device__ __forceinline__ void wgmma_128(float (&d)[64], uint64_t desc_a,
                                          uint64_t desc_b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, "
      "%30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, "
      "%44, %45, %46, %47, %48, %49, %50, %51, %52, %53, %54, %55, %56, %57, "
      "%58, %59, %60, %61, %62, %63}, %64, %65, p, 1, 1, 0, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]),
        "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]),
        "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]), "+f"(d[49]),
        "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]),
        "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "l"(desc_a), "l"(desc_b), "r"(1));
}

// normed[r] = bf16(bf16(x32[r] * rsqrt(mean(x32[r]^2) + eps)) * ln), one
// warp a row
template <int D>
__global__ void __launch_bounds__(256)
rms_norm_kernel(const bf16* __restrict__ x, const bf16* __restrict__ ln,
                bf16* __restrict__ normed, int t_n, float eps) {
  const int row = blockIdx.x * 8 + threadIdx.x / 32, lane = threadIdx.x % 32;
  if (row >= t_n) return;
  const bf16* src = x + (size_t)row * D;
  float ss = 0.0f;
#pragma unroll
  for (int c = lane; c < D; c += 32) {
    const float v = __bfloat162float(src[c]);
    ss += v * v;
  }
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) ss += __shfl_xor_sync(0xffffffffu, ss, o);
  const float inv = rsqrtf(ss / (float)D + eps);
  bf16* dst = normed + (size_t)row * D;
#pragma unroll
  for (int c = lane; c < D; c += 32) {
    const float n =
        __bfloat162float(__float2bfloat16(__bfloat162float(src[c]) * inv));
    dst[c] = __float2bfloat16(n * __bfloat162float(ln[c]));
  }
}

// out[M, N] = epilogue(A[M, K] . B[K, N]); RESIDUAL: bf16(x32 + acc), else
// bf16(relu(acc)). a_map: 2-d {K, M}, boxes of 64 x BM; b_map: 3-d {64, K,
// N / 64}, boxes of 64 x BK x BN / 64 ([BN / 64][BK][64] in shared memory).
// The card charges a block registers by whole warpgroups: 288 threads cost
// as 384, so 168 registers a thread fit one block per SM.
template <int BN, bool RESIDUAL>
__global__ void __maxnreg__(168)
gemm_kernel(const __grid_constant__ CUtensorMap a_map,
            const __grid_constant__ CUtensorMap b_map,
            const bf16* __restrict__ x, bf16* __restrict__ out, int m, int n,
            int k) {
  using G = Gemm<BN>;
  constexpr int S = G::STAGES;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* base =
      smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) & 1023);
  uint64_t* full = reinterpret_cast<uint64_t*>(base + S * G::STAGE);
  uint64_t* empty = full + S;

  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int k_steps = k / BK;
  const int n_tiles = (n + BN - 1) / BN;
  const int tiles = n_tiles * ((m + BM - 1) / BM);

  if (threadIdx.x == 0) {
    for (int i = 0; i < S; ++i) {
      mbar_init(&full[i], 1);
      mbar_init(&empty[i], 8);  // one arrival per consumer warp
    }
    mbar_init_fence();
  }
  __syncthreads();

  if (warp == 8) {
    // ---- producer: the block's tiles' k-slices in order, slice `it` into
    // ring slot it % S once every consumer warp has released the slot's
    // previous slice (so the next tile's first slices load during this
    // tile's epilogue)
    if (lane == 0) {
      tma_prefetch(&a_map);
      tma_prefetch(&b_map);
      int it = 0;
      for (int tile = blockIdx.x; tile < tiles; tile += gridDim.x) {
        const int n0 = (tile % n_tiles) * BN, m0 = (tile / n_tiles) * BM;
        for (int kt = 0; kt < k_steps; ++kt, ++it) {
          const int s = it % S;
          mbar_wait(&empty[s], ((it / S) & 1) ^ 1);
          mbar_expect_tx(&full[s], G::STAGE);
          unsigned char* stage = base + s * G::STAGE;
          tma_load_2d(stage, &a_map, &full[s], kt * BK, m0);
          tma_load_3d(stage + A_BYTES, &b_map, &full[s], 0, kt * BK, n0 / 64);
        }
      }
    }
    return;
  }

  // ---- consumers: warpgroup wg owns rows m0 + 64 wg .. + 63 of a tile
  const int wg = warp / 4;
  const uint32_t ring = smem_u32(base);
  int it = 0;
  for (int tile = blockIdx.x; tile < tiles; tile += gridDim.x) {
    const int n0 = (tile % n_tiles) * BN, m0 = (tile / n_tiles) * BM;
    float acc[G::NB][64];
#pragma unroll
    for (int nb = 0; nb < G::NB; ++nb)
#pragma unroll
      for (int i = 0; i < 64; ++i) acc[nb][i] = 0.0f;

    for (int kt = 0; kt < k_steps; ++kt, ++it) {
      const int s = it % S;
      mbar_wait(smem_u32(&full[s]), (it / S) & 1);
      const uint32_t a_addr = ring + s * G::STAGE + wg * 64 * 128;
      const uint32_t b_addr = ring + s * G::STAGE + A_BYTES;
#pragma unroll
      for (int nb = 0; nb < G::NB; ++nb) fence_regs(acc[nb]);
      wgmma_fence();
      // a k16 step: 32 bytes into A's swizzled rows; 16 rows (2048 bytes)
      // down B's; B's 64-column chunks 8 KB apart, N halves 16 KB apart
#pragma unroll
      for (int kk = 0; kk < BK / 16; ++kk)
#pragma unroll
        for (int nb = 0; nb < G::NB; ++nb)
          wgmma_128(acc[nb], sw128_desc(a_addr + kk * 32, 16, 1024),
                    sw128_desc(b_addr + nb * 16384 + kk * 2048, 8192, 1024));
      wgmma_commit();
      wgmma_wait<1>();  // the product of slice it - 1 is done: release it
#pragma unroll
      for (int nb = 0; nb < G::NB; ++nb) fence_regs(acc[nb]);
      if (kt > 0 && lane == 0) mbar_arrive(&empty[(it - 1) % S]);
    }
    wgmma_wait<0>();
#pragma unroll
    for (int nb = 0; nb < G::NB; ++nb) fence_regs(acc[nb]);
    if (lane == 0) mbar_arrive(&empty[(it - 1) % S]);

    // epilogue: a lane holds rows r0 and r0 + 8, columns 8 j + 2 t (+1)
    const int r0 = m0 + 64 * wg + 16 * (warp % 4) + (lane >> 2);
    const int t = lane & 3;
#pragma unroll
    for (int nb = 0; nb < G::NB; ++nb)
#pragma unroll
      for (int j = 0; j < 16; ++j) {
        const int col = n0 + nb * 128 + 8 * j + 2 * t;
        if (col >= n) continue;
#pragma unroll
        for (int half = 0; half < 2; ++half) {
          const int row = r0 + 8 * half;
          if (row >= m) continue;
          const size_t idx = (size_t)row * n + col;
          float v0 = acc[nb][4 * j + 2 * half];
          float v1 = acc[nb][4 * j + 2 * half + 1];
          if (RESIDUAL) {
            const __nv_bfloat162 xv =
                *reinterpret_cast<const __nv_bfloat162*>(x + idx);
            v0 = __bfloat162float(xv.x) + v0;
            v1 = __bfloat162float(xv.y) + v1;
          } else {
            v0 = fmaxf(v0, 0.0f);
            v1 = fmaxf(v1, 0.0f);
          }
          *reinterpret_cast<uint32_t*>(out + idx) = pack_bf16(v0, v1);
        }
      }
  }
}

// A [M, K] bf16 row-major as a 2-d map with 64 x BM boxes
bool map_a(CUtensorMap* map, const void* ptr, int m, int k) {
  return make_map_2d(map, ptr, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2, m, k, 64,
                     BM);
}

// B [K, N] bf16 row-major as {64 cols, K rows, N / 64 chunks}: one box is a
// [BN / 64][BK][64] tile, each chunk's rows 128-byte swizzled
bool map_b(CUtensorMap* map, const void* ptr, int k, int n, int bn) {
  if (reinterpret_cast<uintptr_t>(ptr) % 16) return false;
  cuuint64_t dims[3] = {64, (cuuint64_t)k, (cuuint64_t)(n / 64)};
  cuuint64_t strides[2] = {(cuuint64_t)n * 2, 128};
  cuuint32_t box[3] = {64, BK, (cuuint32_t)(bn / 64)};
  cuuint32_t one[3] = {1, 1, 1};
  return cuTensorMapEncodeTiled(
             map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 3, const_cast<void*>(ptr),
             dims, strides, box, one, CU_TENSOR_MAP_INTERLEAVE_NONE,
             CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
             CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

template <int BN, bool RESIDUAL>
cudaError_t gemm(const bf16* a, const bf16* b, const bf16* x, bf16* out,
                 int m, int n, int k, cudaStream_t stream) {
  CUtensorMap a_map, b_map;
  if (!map_a(&a_map, a, m, k) || !map_b(&b_map, b, k, n, BN))
    return cudaErrorInvalidValue;
  auto kernel = gemm_kernel<BN, RESIDUAL>;
  const int smem = (int)Gemm<BN>::SMEM;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  // persistent: one block per SM walks the tiles (N tile first)
  static int sms = 0;
  if (sms == 0) {
    int dev = 0;
    if (cudaGetDevice(&dev) != cudaSuccess ||
        cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev) !=
            cudaSuccess)
      return cudaErrorInvalidValue;
  }
  const int tiles = ((n + BN - 1) / BN) * ((m + BM - 1) / BM);
  const int grid = tiles > sms ? sms : tiles;
  kernel<<<grid, THREADS, smem, stream>>>(a_map, b_map, x, out, m, n, k);
  return cudaGetLastError();
}

// the widest tile the output's N fills
template <bool RESIDUAL>
cudaError_t gemm_any(const bf16* a, const bf16* b, const bf16* x, bf16* out,
                     int m, int n, int k, cudaStream_t stream) {
  if (n >= 256)
    return gemm<256, RESIDUAL>(a, b, x, out, m, n, k, stream);
  return gemm<128, RESIDUAL>(a, b, x, out, m, n, k, stream);
}

template <int D>
cudaError_t launch(const bf16* x, const bf16* ln, const bf16* wi,
                   const bf16* wo, bf16* normed, bf16* h, bf16* out, int t_n,
                   int f_n, float eps, cudaStream_t stream) {
  rms_norm_kernel<D><<<(t_n + 7) / 8, 256, 0, stream>>>(x, ln, normed, t_n,
                                                        eps);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  err = gemm_any<false>(normed, wi, nullptr, h, t_n, f_n, D, stream);
  if (err != cudaSuccess) return err;
  return gemm_any<true>(h, wo, x, out, t_n, D, f_n, stream);
}

}  // namespace

// x [t, d], ln [d], wi [d, f], wo [f, d], out [t, d] bf16; normed [t, d]
// and h [t, f] bf16 scratch. d in {128, 256, 512, 1024}, f % 128 == 0.
extern "C" int knn_ffn_fused(const void* x, const void* ln, const void* wi,
                             const void* wo, void* normed, void* h, void* out,
                             int t_n, int d, int f_n, float eps,
                             cudaStream_t stream) {
  if (t_n < 1 || f_n < 128 || f_n % 128 != 0) return (int)cudaErrorInvalidValue;
  const bf16* xb = static_cast<const bf16*>(x);
  const bf16* lb = static_cast<const bf16*>(ln);
  const bf16* wib = static_cast<const bf16*>(wi);
  const bf16* wob = static_cast<const bf16*>(wo);
  bf16* nb = static_cast<bf16*>(normed);
  bf16* hb = static_cast<bf16*>(h);
  bf16* ob = static_cast<bf16*>(out);
  switch (d) {
    case 128:
      return (int)launch<128>(xb, lb, wib, wob, nb, hb, ob, t_n, f_n, eps, stream);
    case 256:
      return (int)launch<256>(xb, lb, wib, wob, nb, hb, ob, t_n, f_n, eps, stream);
    case 512:
      return (int)launch<512>(xb, lb, wib, wob, nb, hb, ob, t_n, f_n, eps, stream);
    case 1024:
      return (int)launch<1024>(xb, lb, wib, wob, nb, hb, ob, t_n, f_n, eps, stream);
    default:
      return (int)cudaErrorInvalidValue;
  }
}
