// Kernel M: one layer of SeqVec's bidirectional LSTMP recurrence, every
// step of both directions in one persistent launch.
//
// The JAX package runs ELMo's LSTM as a lax.scan of XLA ops (no Pallas
// kernel); the port's step loop (models/elmo.py:lstm_step) launched ~18
// small kernels a step and direction. Per step and direction, with P = 512
// (projection), H = 4096 (cells) and xw_t = x_t . W_x + b computed for all
// steps beforehand (one cuBLAS GEMM a direction):
//
//   gates = xw_t + h_{t-1} . W_h           W_h [P, 4H], gates [i, f, g, o]
//   c_t   = clip(sig(f) c_{t-1} + sig(i) tanh(g), +-cell_clip)      fp32
//   h_t   = clip(bf16(sig(o) tanh(c_t)) . W_proj, +-proj_clip)  -> bf16
//
// The plain version (ops/lstm.py:lstmp_bidir_plain) rounds where this
// kernel rounds: xw and h are bf16, the gate sums, the cell state and the
// projection sums fp32, the projection's operand bf16.
//
// Design. A cooperative grid of 2 x 64 blocks (a direction on each half,
// one block an SM, all resident); block b of a direction owns cells
// [64b, 64b + 64), i.e. 256 gate columns, and its 8 warps 8 cells each, so
// a warp's four mma n-tiles are the i, f, g and o gates of the same cells
// and the cell update runs in the accumulators' registers. Per step:
//   1. the block stages h_{t-1} of the live rows (fp32 sums -> clip ->
//      bf16) into shared memory, 64 rows a chunk, and writes its 8
//      columns of it to the output; xw_t and c_{t-1} of the warp's
//      (row, cell) pairs are loaded first, so their latency runs under
//      the staging and the products;
//   2. gates on mma.sync m16n8k16 (bf16 in, fp32 sums). Holding the
//      recurrent weights: both directions' W_h and W_proj are 42 MB in
//      bf16, against ~29 MB of shared memory and 32 MB of registers on
//      128 SMs. Each block keeps its W_proj slice (64 KB) and 10 of its
//      warps' 32 W_h k-tiles (80 KB) in shared memory and 8 k-tiles in
//      registers (64 a thread) for the whole launch; the other 14 (14 MB
//      a step for both directions) stream from L2. The wrapper packs
//      W_h and W_proj in the order the lanes read them;
//   3. the cell update; bf16 h_full of the chunk into shared memory;
//   4. the block's share of the projection, h_full [rows, 64] . W_proj
//      [64, 512], added into an fp32 [rows, 512] sum in global memory
//      with 16-byte vector atomics (lanes pair up to hold 4 columns);
//   5. a barrier of the direction's 64 blocks (an arrival counter).
// The sums rotate through three buffers: step t adds into t % 3, reads
// (t - 1) % 3, and zeroes (t + 1) % 3, so one barrier a step suffices. The
// fp32 sums are added in no fixed order: results may differ from run to
// run in the last bits of a sum before its bf16 rounding. Measured on an
// H100 (PERF.md): a step of both directions takes ~14 us at 10 rows and
// ~38 us at 56; the atomics are ~6 us of the latter.
//
// Ragged rows: the wrapper hands rows sorted by length, longest first
// (`order` maps a sorted row to the batch's row), so the live rows of step
// t are a prefix; a row's work and its writes stop at its length, and a
// chunk's m-tiles past the live rows are skipped. The backward direction
// walks each row's own valid prefix reversed: at step t row r reads and
// writes position len_r - 1 - t. Positions past a row's length are never
// written (the wrapper's output is zeroed).
//
// What bounds it (H100 SXM): the products, 4 (P.4H + H.P) flop a row, step
// and direction, at the bf16 peak; the bytes, the recurrent weights once a
// launch plus xw and h once. Its reach: P 512, H 4096, any rows (in chunks
// of 64) and steps.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace knn_lstm {

constexpr int P = 512;            // projection width
constexpr int H = 4096;           // cells
constexpr int G = 4 * H;          // gate columns
constexpr int NB = 64;            // blocks a direction
constexpr int CB = H / NB;        // cells a block
constexpr int WARPS = 8;
constexpr int THREADS = 32 * WARPS;
constexpr int CW = CB / WARPS;    // cells a warp
constexpr int KT = P / 16;        // k-tiles of the gates product
constexpr int PKT = CB / 16;      // k-tiles of the projection
constexpr int PNT = P / 8 / WARPS;  // n-tiles of the projection a warp
constexpr int MC = 64;            // rows a chunk
constexpr int MT = MC / 16;       // m-tiles a chunk
constexpr int HS = P + 8;         // h stage row stride (bf16)
constexpr int FS = CB + 8;        // h_full stage row stride (bf16)
constexpr int COLS = P / NB;      // output columns a block writes
// where a warp's W_h k-tiles live for the whole launch: the first KT_REG in
// registers, the next KT_SMEM in shared memory, the rest read from L2
constexpr int KT_REG = 8;
constexpr int KT_SMEM = 10;
static_assert(KT_REG + KT_SMEM <= KT, "more resident k-tiles than K has");

constexpr size_t WPROJ_BYTES = (size_t)CB * P * 2;
constexpr size_t WH_BYTES = (size_t)KT_SMEM * WARPS * 32 * 32;
constexpr size_t HSTAGE_BYTES = (size_t)MC * HS * 2;
constexpr size_t FSTAGE_BYTES = (size_t)MC * FS * 2;
constexpr size_t SMEM_BYTES =
    WPROJ_BYTES + WH_BYTES + HSTAGE_BYTES + FSTAGE_BYTES;

__device__ __forceinline__ void mma_bf16(float (&c)[4], uint32_t a0,
                                         uint32_t a1, uint32_t a2,
                                         uint32_t a3, uint32_t b0,
                                         uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a0), "r"(a1), "r"(a2), "r"(a3), "r"(b0), "r"(b1));
}

__device__ __forceinline__ void ldmatrix_x4(uint32_t (&r)[4],
                                            const void* smem) {
  uint32_t addr = (uint32_t)__cvta_generic_to_shared(smem);
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(addr));
}

__device__ __forceinline__ unsigned load_acquire(const unsigned* p) {
  unsigned v;
  asm volatile("ld.acquire.gpu.global.u32 %0, [%1];\n"
               : "=r"(v)
               : "l"(p)
               : "memory");
  return v;
}

__device__ __forceinline__ float sigmoid(float x) {
  return 1.f / (1.f + expf(-x));
}

__device__ __forceinline__ float clip(float x, float bound) {
  return fminf(fmaxf(x, -bound), bound);
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

// the direction's blocks meet: every block's atomics of the step are done
// before any block reads the sums. A block missing for 2^25 polls (tens of
// seconds) traps, so a broken launch fails instead of hanging the card.
__device__ __forceinline__ void direction_barrier(unsigned* counter,
                                                  unsigned target) {
  __syncthreads();
  if (threadIdx.x == 0) {
    __threadfence();
    atomicAdd(counter, 1u);
    unsigned polls = 0;
    while (load_acquire(counter) < target) {
      if (++polls == (1u << 25)) __trap();
    }
    __threadfence();
  }
  __syncthreads();
}

// live rows at step t: rows are sorted by length, longest first
__device__ __forceinline__ int live_rows(const int* lens, int live, int t) {
  while (live > 0 && __ldg(lens + live - 1) <= t) --live;
  return live;
}

__global__ void __launch_bounds__(THREADS, 1)
lstmp_bidir_kernel(const __nv_bfloat16* __restrict__ xw,
                   const uint4* __restrict__ w_h,
                   const uint4* __restrict__ w_proj,
                   const int* __restrict__ order, const int* __restrict__ lens,
                   __nv_bfloat16* __restrict__ y, float* sums, float* cells,
                   unsigned* counters, int rows, int steps, float cell_clip,
                   float proj_clip) {
  extern __shared__ __align__(16) unsigned char smem[];
  uint4* wproj_s = reinterpret_cast<uint4*>(smem);
  uint4* wh_s = reinterpret_cast<uint4*>(smem + WPROJ_BYTES);
  __nv_bfloat16* h_s =
      reinterpret_cast<__nv_bfloat16*>(smem + WPROJ_BYTES + WH_BYTES);
  __nv_bfloat16* f_s = reinterpret_cast<__nv_bfloat16*>(
      smem + WPROJ_BYTES + WH_BYTES + HSTAGE_BYTES);

  const int blk = blockIdx.x, dir = blockIdx.y;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, tig = lane & 3;
  const size_t sum_plane = (size_t)rows * P;  // one direction of a buffer
  unsigned* counter = counters + dir;

  // this block's W_proj fragments, for the whole launch
  {
    const uint4* src = w_proj + (size_t)(dir * NB + blk) * (WPROJ_BYTES / 16);
    for (int i = tid; i < (int)(WPROJ_BYTES / 16); i += THREADS)
      wproj_s[i] = src[i];
  }
  // this warp's W_h fragments: [kt][lane][4 gates x 2 registers]
  const uint4* wh = w_h + ((size_t)(dir * NB + blk) * WARPS + warp) * KT * 64 +
                    lane * 2;
  // the resident k-tiles: registers, then shared memory as [kt][half]
  // [lane] (conflict-free 16-byte reads)
  uint4 w_reg[KT_REG > 0 ? KT_REG : 1][2];
#pragma unroll
  for (int kt = 0; kt < KT_REG; ++kt) {
    w_reg[kt][0] = __ldg(wh + kt * 64);
    w_reg[kt][1] = __ldg(wh + kt * 64 + 1);
  }
  uint4* wh_warp = wh_s + warp * KT_SMEM * 64;
  for (int kt = 0; kt < KT_SMEM; ++kt) {
    wh_warp[(kt * 2) * 32 + lane] = __ldg(wh + (KT_REG + kt) * 64);
    wh_warp[(kt * 2 + 1) * 32 + lane] = __ldg(wh + (KT_REG + kt) * 64 + 1);
  }
  const int warp_cell = warp * CW + tig * 2;  // + e: the block's cell
  const int cell0 = blk * CB + warp_cell;     // the direction's cell
  const __nv_bfloat16* xw_dir = xw + (size_t)dir * rows * steps * G;

  // h of step `at` (clipped, bf16) of rows [r0, r1): this block's
  // columns, from the step's sums to the output
  auto write_rows = [&](const float* sums_at, int r0, int r1, int at) {
    for (int i = tid; i < (r1 - r0) * COLS; i += THREADS) {
      const int r = r0 + i / COLS, k = blk * COLS + i % COLS;
      const int pos = dir == 0 ? at : __ldg(lens + r) - 1 - at;
      const float v = clip(__ldcg(sums_at + (size_t)r * P + k), proj_clip);
      y[((size_t)__ldg(order + r) * steps + pos) * (2 * P) + dir * P + k] =
          __float2bfloat16_rn(v);
    }
  };

  int live = rows, t = 0;
  for (; t < steps; ++t) {
    const int was_live = live;
    live = live_rows(lens, live, t);
    const float* prev = sums + (size_t)((t + 2) % 3) * 2 * sum_plane +
                        dir * sum_plane;
    float* cur = sums + (size_t)(t % 3) * 2 * sum_plane + dir * sum_plane;
    float* next = sums + (size_t)((t + 1) % 3) * 2 * sum_plane +
                  dir * sum_plane;
    // rows that ended at step t - 1 write it here; the live rows, while
    // their h_{t-1} is staged
    if (t > 0) write_rows(prev, live, was_live, t - 1);
    if (live == 0) break;  // the same step in every block

    for (int c0 = 0; c0 < live; c0 += MC) {
      const int chunk = min(MC, live - c0);
      const int mts = (chunk + 15) >> 4;
      // xw_t and c_{t-1} of the warp's (row, cell) pairs, before they are
      // needed: their latency runs under the staging and the products
      uint32_t xv[MT][2][4];
      float2 cv[MT][2];
#pragma unroll
      for (int m = 0; m < MT; ++m) {
#pragma unroll
        for (int half = 0; half < 2; ++half) {
          const int r = c0 + m * 16 + g + 8 * half;
          if (m < mts && r < live) {
            const int pos = dir == 0 ? t : __ldg(lens + r) - 1 - t;
            const __nv_bfloat16* x =
                xw_dir + ((size_t)__ldg(order + r) * steps + pos) * G + cell0;
#pragma unroll
            for (int j = 0; j < 4; ++j)
              xv[m][half][j] = __ldcs(reinterpret_cast<const unsigned*>(
                  x + (size_t)j * H));
            cv[m][half] = *reinterpret_cast<const float2*>(
                cells + ((size_t)dir * rows + r) * H + cell0);
          }
        }
      }
      // 1. h_{t-1} of the chunk's rows, clipped and rounded to bf16 (rows
      // past the chunk zero), and this block's columns of it to the output
      for (int i = tid; i < mts * 16 * (P / 4); i += THREADS) {
        const int r = i / (P / 4), k = (i % (P / 4)) * 4;
        float4 v = make_float4(0.f, 0.f, 0.f, 0.f);
        if (r < chunk)
          v = __ldcg(reinterpret_cast<const float4*>(prev + (size_t)(c0 + r) *
                                                                P + k));
        v.x = clip(v.x, proj_clip);
        v.y = clip(v.y, proj_clip);
        v.z = clip(v.z, proj_clip);
        v.w = clip(v.w, proj_clip);
        uint2 packed;
        packed.x = pack_bf16(v.x, v.y);
        packed.y = pack_bf16(v.z, v.w);
        *reinterpret_cast<uint2*>(h_s + r * HS + k) = packed;
        if (t > 0 && r < chunk && k / COLS == blk) {
          const int row = c0 + r;
          const int pos = dir == 0 ? t - 1 : __ldg(lens + row) - t;
          *reinterpret_cast<uint2*>(
              y + ((size_t)__ldg(order + row) * steps + pos) * (2 * P) +
              dir * P + k) = packed;
        }
      }
      __syncthreads();

      // 2. the warp's gates: [rows of the chunk] x [i, f, g, o of 8 cells]
      float acc[MT][4][4];
#pragma unroll
      for (int m = 0; m < MT; ++m)
#pragma unroll
        for (int j = 0; j < 4; ++j)
#pragma unroll
          for (int q = 0; q < 4; ++q) acc[m][j][q] = 0.f;
#pragma unroll
      for (int kt = 0; kt < KT; ++kt) {
        uint4 w0, w1;
        if (kt < KT_REG) {
          w0 = w_reg[kt][0];
          w1 = w_reg[kt][1];
        } else if (kt < KT_REG + KT_SMEM) {
          w0 = wh_warp[((kt - KT_REG) * 2) * 32 + lane];
          w1 = wh_warp[((kt - KT_REG) * 2 + 1) * 32 + lane];
        } else {
          w0 = __ldg(wh + kt * 64);
          w1 = __ldg(wh + kt * 64 + 1);
        }
#pragma unroll
        for (int m = 0; m < MT; ++m) {
          if (m < mts) {
            uint32_t a[4];
            ldmatrix_x4(a, h_s + (m * 16 + (lane & 15)) * HS + kt * 16 +
                               (lane >> 4) * 8);
            mma_bf16(acc[m][0], a[0], a[1], a[2], a[3], w0.x, w0.y);
            mma_bf16(acc[m][1], a[0], a[1], a[2], a[3], w0.z, w0.w);
            mma_bf16(acc[m][2], a[0], a[1], a[2], a[3], w1.x, w1.y);
            mma_bf16(acc[m][3], a[0], a[1], a[2], a[3], w1.z, w1.w);
          }
        }
      }

      // 3. the cell update of the warp's (row, cell) pairs
#pragma unroll
      for (int m = 0; m < MT; ++m) {
        if (m >= mts) continue;
#pragma unroll
        for (int half = 0; half < 2; ++half) {
          const int r_local = m * 16 + g + 8 * half;
          const int r = c0 + r_local;
          uint32_t hf = 0;
          if (r < live) {
            float2* cp = reinterpret_cast<float2*>(
                cells + ((size_t)dir * rows + r) * H + cell0);
            const float2 c = cv[m][half];
            float pre[4][2];
#pragma unroll
            for (int j = 0; j < 4; ++j) {
              const uint32_t raw = xv[m][half][j];
              const __nv_bfloat162 v =
                  *reinterpret_cast<const __nv_bfloat162*>(&raw);
              pre[j][0] = acc[m][j][half * 2] + __low2float(v);
              pre[j][1] = acc[m][j][half * 2 + 1] + __high2float(v);
            }
            float cn[2] = {c.x, c.y}, out[2];
#pragma unroll
            for (int e = 0; e < 2; ++e) {
              float cv_ = sigmoid(pre[1][e]) * cn[e] +
                          sigmoid(pre[0][e]) * tanhf(pre[2][e]);
              cv_ = clip(cv_, cell_clip);
              cn[e] = cv_;
              out[e] = sigmoid(pre[3][e]) * tanhf(cv_);
            }
            *cp = make_float2(cn[0], cn[1]);
            hf = pack_bf16(out[0], out[1]);
          }
          *reinterpret_cast<uint32_t*>(f_s + r_local * FS + warp_cell) = hf;
        }
      }
      __syncthreads();

      // 4. the block's share of h_t: h_full [chunk, 64] . W_proj slice,
      // added into the step's sums
#pragma unroll 1
      for (int m = 0; m < mts; ++m) {
        float pacc[PNT][4];
#pragma unroll
        for (int j = 0; j < PNT; ++j)
#pragma unroll
          for (int q = 0; q < 4; ++q) pacc[j][q] = 0.f;
#pragma unroll
        for (int kt = 0; kt < PKT; ++kt) {
          uint32_t a[4];
          ldmatrix_x4(a, f_s + (m * 16 + (lane & 15)) * FS + kt * 16 +
                             (lane >> 4) * 8);
          const uint4* wp = wproj_s + ((warp * PKT + kt) * 32 + lane) * 4;
#pragma unroll
          for (int q = 0; q < 4; ++q) {
            const uint4 w = wp[q];
            mma_bf16(pacc[2 * q], a[0], a[1], a[2], a[3], w.x, w.y);
            mma_bf16(pacc[2 * q + 1], a[0], a[1], a[2], a[3], w.z, w.w);
          }
        }
        // lanes 2i and 2i + 1 trade halves: the even one adds 4 columns of
        // row g, the odd one 4 columns of row g + 8, one vector atomic each
        const bool odd = tig & 1;
        const int r = c0 + m * 16 + g + (odd ? 8 : 0);
        float* dst = cur + (size_t)r * P + warp * PNT * 8 + (tig & 2) * 2;
#pragma unroll
        for (int j = 0; j < PNT; ++j) {
          const float s0 = odd ? pacc[j][0] : pacc[j][2];
          const float s1 = odd ? pacc[j][1] : pacc[j][3];
          const float r0 = __shfl_xor_sync(0xffffffffu, s0, 1);
          const float r1 = __shfl_xor_sync(0xffffffffu, s1, 1);
          const float4 v = odd ? make_float4(r0, r1, pacc[j][2], pacc[j][3])
                               : make_float4(pacc[j][0], pacc[j][1], r0, r1);
          if (r < live) atomicAdd(reinterpret_cast<float4*>(dst + j * 8), v);
        }
      }
      __syncthreads();  // h_s and f_s are the next chunk's
    }

    // zero this block's columns of the buffer step t + 1 adds into
    for (int i = tid; i < rows * (COLS / 4); i += THREADS) {
      const int r = i / (COLS / 4), k = blk * COLS + (i % (COLS / 4)) * 4;
      __stcg(reinterpret_cast<float4*>(next + (size_t)r * P + k),
             make_float4(0.f, 0.f, 0.f, 0.f));
    }
    direction_barrier(counter, (unsigned)(t + 1) * NB);
  }
  // the last step's h of the rows still live at its end
  if (t == steps)
    write_rows(sums + (size_t)((t + 2) % 3) * 2 * sum_plane + dir * sum_plane,
               0, live, t - 1);
}

}  // namespace knn_lstm

// xw [2, rows, steps, 4H] bf16 (x . W_x + b of each direction, positions
// as the batch holds them); w_h, w_proj: the wrapper's fragment packs;
// order [rows] int32 (sorted row -> batch row), lens [rows] int32 (sorted,
// longest first, each <= steps); y [rows, steps, 2P] bf16, zeroed;
// scratch: sums [3, 2, rows, P] f32, cells [2, rows, H] f32, counters [2]
// u32, all zeroed.
extern "C" int knn_lstmp_bidir(const void* xw, const void* w_h,
                               const void* w_proj, const void* order,
                               const void* lens, void* y, void* sums,
                               void* cells, void* counters, int rows,
                               int steps, float cell_clip, float proj_clip,
                               cudaStream_t stream) {
  using namespace knn_lstm;
  if (rows < 1 || steps < 1) return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaFuncSetAttribute(
      lstmp_bidir_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)SMEM_BYTES);
  if (err != cudaSuccess) return (int)err;
  const __nv_bfloat16* xw_p = static_cast<const __nv_bfloat16*>(xw);
  const uint4* wh_p = static_cast<const uint4*>(w_h);
  const uint4* wp_p = static_cast<const uint4*>(w_proj);
  const int* order_p = static_cast<const int*>(order);
  const int* lens_p = static_cast<const int*>(lens);
  __nv_bfloat16* y_p = static_cast<__nv_bfloat16*>(y);
  float* sums_p = static_cast<float*>(sums);
  float* cells_p = static_cast<float*>(cells);
  unsigned* counters_p = static_cast<unsigned*>(counters);
  void* args[] = {&xw_p,   &wh_p,    &wp_p,       &order_p,
                  &lens_p, &y_p,     &sums_p,     &cells_p,
                  &counters_p, &rows, &steps, &cell_clip, &proj_clip};
  err = cudaLaunchCooperativeKernel((const void*)lstmp_bidir_kernel,
                                    dim3(NB, 2), dim3(THREADS), args,
                                    SMEM_BYTES, stream);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}
