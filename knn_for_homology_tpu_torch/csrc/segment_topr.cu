// Kernel B: exact segment-top-R candidates for large-k selection.
//
// Replaces knn_for_homology_tpu/ops/exact_pallas.py:_segment_topr_kernel
// (entry _candidates_and_topk, before its epilogue). The database axis is
// cut into W strided segments: column c belongs to lane c mod W, and pass
// j covers columns j*W .. j*W+W-1. For every query and lane the kernel
// keeps the R largest ordered-int32 similarities (knn::ordered_int) seen in
// that lane, sorted descending, each with its pass index j. A strict `>`
// keeps the earlier pass on ties (the reference's lax.top_k order); empty
// slots hold INT32_MIN / -1 and columns >= n_valid never enter. Buffer
// layout as in the reference: slot r of lane w sits at column r*W + w of
// the [Q, R*W] buffers. The epilogue (the two-key sort, the certificate, the
// rescue) stays in PyTorch, as it stayed outside the Pallas kernel
// (ops/exact_cuda.py).
//
// What bounds it here: the products, 2*Q*N*d operations, taken as 3xTF32
// wgmma (tf32x3.cuh: fp32-accurate, three tensor-core products a k step);
// the [Q, N] similarity block never reaches device memory. On the TPU the
// R-slot state lived in VMEM across a sequential pass axis; here a block
// owns 64 queries x BN = 16 lanes (one consumer warpgroup and a producer
// warp) and loops over ALL passes itself, so no cross-block merge is
// needed.
// Each thread owns the same accumulator positions on every pass, so the
// R-th kept value of each of its (query, lane) pairs stays in a register
// and a candidate costs one compare. The insert is kept off the products'
// path: a pass's winners are compacted into a per-warp queue (ballot +
// prefix count) and inserted 32 at a time, one lane a pair (a pass gives a
// pair one candidate, so the lists are distinct).
//
// The slots are two words: the ordered value (int32, exact) and the pass
// index (uint16 in shared memory: 6 bytes a slot, so passes <= 65535). At
// the phase-3 / bench plan (W = 256, R = 16) 64 queries x 16 lanes hold 96
// KB of slots beside a ring of 24 KB stages. The slots' home and the ring's
// depth come from the wrapper's planner (ops/exact_cuda.py:topr_plan):
// shared memory while the block's slots and >= 3 stages fit in 227 KB,
// else the output buffers in device memory (large R: the 2R rescue, up to
// 64).
//
// One lane tile, BN = 16: its slots fit wherever a wider tile's fit, it
// gives the most blocks ((Q / 64) x (W / 16): 128 at 512 queries and W =
// 256), and a step covers 64 / BN passes of 64 db rows whatever BN is, so
// a wider tile reads no fewer query or db bytes.

#include <cuda.h>
#include <limits.h>
#include <stdint.h>

#include "knn_common.cuh"
#include "tf32x3.cuh"

namespace {

using namespace knn_tf32;

// a warp's winners held before an insert round: up to 31 left over and 32
// more from one accumulator position
constexpr int QUEUE = 64;
constexpr int QUEUE_BYTES = 4 * 2 * QUEUE * sizeof(int);
constexpr uint16_t NO_PASS = 0xFFFF;
constexpr int BN = 16;              // lanes a block
constexpr int PB = TILE_ROWS / BN;  // passes a step
constexpr int NJ = BN / 8;          // 8-column groups of one pass

struct Params {
  const float* q_sq;  // l2: [q_n] squared query norms
  const float* d_sq;  // l2: [n] squared db row norms
  int* buf_v;
  int* buf_i;
  int q_n, n, w, r, chunks, stages;
  int nv;  // columns >= nv never enter (min(n, n_valid)); the passes are n's
  bool l2, global_slots;
};

__host__ __device__ constexpr size_t slot_bytes(int r) {
  return (size_t)BM * BN * r * (sizeof(int) + sizeof(uint16_t));
}

// Insert (v, pass), v > vals[(r-1)*stride], into a descending list of r
// two-word slots; equal values stay ahead (earlier passes). Returns the
// new r-th value.
template <typename Id>
__device__ __forceinline__ int insert_slot(int* vals, Id* ids, size_t stride,
                                           int r, int v, int pass) {
  int p = r - 1;
  while (p > 0) {
    const int pv = vals[(size_t)(p - 1) * stride];
    if (pv >= v) break;
    vals[(size_t)p * stride] = pv;
    ids[(size_t)p * stride] = ids[(size_t)(p - 1) * stride];
    --p;
  }
  vals[(size_t)p * stride] = v;
  ids[(size_t)p * stride] = (Id)pass;
  return vals[(size_t)(r - 1) * stride];
}

// One queued winner (`key` = il * BN + jl of the tile) into the block's
// shared slots or its rows of the output buffers.
__device__ __forceinline__ void insert_winner(const Params& p, int* sv,
                                              uint16_t* si, int a0, int lane0,
                                              int key, int v, int pass) {
  if (p.global_slots) {
    const size_t at = (size_t)(a0 + key / BN) * p.r * p.w + lane0 + key % BN;
    insert_slot(p.buf_v + at, p.buf_i + at, (size_t)p.w, p.r, v, pass);
  } else {
    insert_slot(sv + key, si + key, (size_t)(BM * BN), p.r, v, pass);
  }
}

// Shared memory: the ring (tf32x3.cuh), each consumer warp's queue of
// winners [4][keys, values][QUEUE], then unless global_slots the slots'
// values int32 [R][BM][BN] and pass indices uint16 [R][BM][BN].
//
// A step takes PB = 64 / BN passes at once: its tile is the block's 64
// queries x the 64 db rows of its BN lanes in PB passes, so each query
// chunk that the ring brings serves PB passes (one pass a step re-read the
// query rows from L2 every pass: 21 GB at phase 3's 512 queries). The
// winners are then inserted pass by pass, in pass order.
__global__ void __launch_bounds__(THREADS)
segment_topr(const __grid_constant__ CUtensorMap q_map,
             const __grid_constant__ CUtensorMap db_map, const Params p) {
  extern __shared__ unsigned char smem_raw[];
  Ring ring;
  int* queues = reinterpret_cast<int*>(ring_setup(smem_raw, p.stages, ring));
  int* sv = queues + 4 * 2 * QUEUE;
  uint16_t* si = reinterpret_cast<uint16_t*>(sv + BM * BN * p.r);
  __syncthreads();

  const int a0 = blockIdx.x * BM, lane0 = blockIdx.y * BN;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int passes = (p.n + p.w - 1) / p.w;
  const int steps = (passes + PB - 1) / PB;
  if (warp == 4) {
    if (lane == 0)
      produce<PB>(&q_map, &db_map, ring, a0, steps, p.chunks, lane0,
                  PB * p.w, p.w);
    return;
  }

  const int t = lane & 3;
  const int il0 = 16 * warp + (lane >> 2);
  const bool live[2] = {a0 + il0 < p.q_n, a0 + il0 + 8 < p.q_n};
  const size_t width = (size_t)p.r * p.w;
  const unsigned below = (1u << lane) - 1u;  // lanes before this one
  int* q_key = queues + warp * 2 * QUEUE;
  int* q_val = q_key + QUEUE;
  float q_sq[2] = {0.f, 0.f};
  if (p.l2) {
    for (int h = 0; h < 2; ++h)
      if (live[h]) q_sq[h] = p.q_sq[a0 + il0 + 8 * h];
  }

  // empty slots; each thread its own pairs (a warp's inserts touch only its
  // own rows, after a __syncwarp)
  int kept[NJ][4];
#pragma unroll
  for (int j = 0; j < NJ; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      kept[j][e] = INT_MIN;
      const int il = il0 + 8 * (e >> 1), jl = 8 * j + 2 * t + (e & 1);
      if (p.global_slots) {
        if (live[e >> 1]) {
          const size_t at = (size_t)(a0 + il) * width + lane0 + jl;
          for (int r = 0; r < p.r; ++r) {
            p.buf_v[at + (size_t)r * p.w] = INT_MIN;
            p.buf_i[at + (size_t)r * p.w] = -1;
          }
        }
      } else {
        for (int r = 0; r < p.r; ++r) {
          sv[(r * BM + il) * BN + jl] = INT_MIN;
          si[(r * BM + il) * BN + jl] = NO_PASS;
        }
      }
    }

  for (int step = 0; step < steps; ++step) {
    float acc[ACC];
    tile_products(ring, p.chunks, acc);

#pragma unroll
    for (int b = 0; b < PB; ++b) {
      const int pass = step * PB + b;
      if (pass >= passes) break;
      const int c0 = pass * p.w + lane0;
      // this pass's winners through the warp's queue (n entries,
      // warp-wide); accumulator group b * NJ + j holds its lanes 8 j ..
      int n = 0;
      unsigned won = 0;  // bit 4 j + e: this thread's pair (j, e) won
#pragma unroll
      for (int j = 0; j < NJ; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          // rows past q_n and columns past nv never enter
          const int c = c0 + 8 * j + 2 * t + (e & 1);
          int cand = INT_MIN;
          if (live[e >> 1] && c < p.nv) {
            float sim = acc[4 * (b * NJ + j) + e];
            if (p.l2)  // 2 dot - |q|^2 - |d|^2, in the reference's order
              sim = __fsub_rn(__fsub_rn(2.f * sim, q_sq[e >> 1]), p.d_sq[c]);
            cand = knn::ordered_int(sim);
          }
          const bool win = cand > kept[j][e];
          const unsigned mask = __ballot_sync(0xffffffffu, win);
          if (win) {
            const int at = n + __popc(mask & below);
            q_key[at] = (il0 + 8 * (e >> 1)) * BN + 8 * j + 2 * t + (e & 1);
            q_val[at] = cand;
            won |= 1u << (4 * j + e);
          }
          n += __popc(mask);
          if (n >= 32) {  // a full queue: one insert per lane
            __syncwarp();
            n -= 32;
            insert_winner(p, sv, si, a0, lane0, q_key[n + lane],
                              q_val[n + lane], pass);
            __syncwarp();
          }
        }
      __syncwarp();
      if (lane < n)
        insert_winner(p, sv, si, a0, lane0, q_key[lane], q_val[lane],
                          pass);
      __syncwarp();
      // the new R-th kept value of each pair this thread won
#pragma unroll
      for (int j = 0; j < NJ; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          if (!((won >> (4 * j + e)) & 1u)) continue;
          const int il = il0 + 8 * (e >> 1), jl = 8 * j + 2 * t + (e & 1);
          kept[j][e] = p.global_slots
                           ? p.buf_v[(size_t)(a0 + il) * width +
                                     (size_t)(p.r - 1) * p.w + lane0 + jl]
                           : sv[((p.r - 1) * BM + il) * BN + jl];
        }
    }
  }
  if (p.global_slots) return;
  consumer_sync();
  // coalesced copy-out: consecutive threads write consecutive lanes
  for (int e = threadIdx.x; e < BM * BN * p.r; e += 128) {
    const int jl = e % BN, il = (e / BN) % BM, r = e / (BM * BN);
    if (a0 + il < p.q_n) {
      const size_t at = (size_t)(a0 + il) * width + (size_t)r * p.w + lane0 + jl;
      p.buf_v[at] = sv[e];
      p.buf_i[at] = si[e] == NO_PASS ? -1 : (int)si[e];
    }
  }
}

size_t smem_bytes(int stages, int r, bool global_slots) {
  return ring_bytes(stages) + QUEUE_BYTES + (global_slots ? 0 : slot_bytes(r));
}

cudaError_t launch(const float* q, const float* db, const Params& p,
                   int d, size_t smem, cudaStream_t stream) {
  CUtensorMap q_map, db_map;
  if (!make_f32_map(&q_map, q, p.q_n, d, BM) ||
      !make_f32_map(&db_map, db, p.n, d, BN))
    return cudaErrorInvalidValue;
  cudaError_t err = cudaFuncSetAttribute(
      segment_topr, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  const dim3 grid((p.q_n + BM - 1) / BM, p.w / BN);
  segment_topr<<<grid, THREADS, smem, stream>>>(q_map, db_map, p);
  return cudaGetLastError();
}

}  // namespace

// q [q_n, d], db [n, d] fp32 rows, d % 4 == 0 (TMA rows of whole 16
// bytes); norms: [q_n + n] f32 scratch for l2 (the squared norms of the
// queries, then of the db rows), else unused. The plan (ring stages,
// slots in device memory) is the wrapper's (ops/exact_cuda.py:topr_plan);
// a plan that does not fit is refused. Columns >= n_valid never enter a
// slot (a shard's pad rows); the passes stay those of all n rows.
extern "C" int knn_segment_topr(const float* q, const float* db, float* norms,
                                int* buf_v, int* buf_i, int q_n, int n,
                                int n_valid, int d, int w, int r_slots, int l2,
                                int stages, int global_slots,
                                cudaStream_t stream) {
  const int passes = n > 0 && w > 0 ? (n + w - 1) / w : 0;
  if (w < BN || w % BN != 0 ||
      r_slots < 1 || q_n < 1 || n < 1 || d < 4 || d % 4 != 0 || stages < 2 ||
      stages > MAX_STAGES || (!global_slots && passes > NO_PASS) ||
      (l2 && norms == nullptr))
    return (int)cudaErrorInvalidValue;
  const size_t smem = smem_bytes(stages, r_slots, global_slots != 0);
  if (smem > (size_t)SMEM_LIMIT) return (int)cudaErrorInvalidValue;
  Params p{};
  p.buf_v = buf_v;
  p.buf_i = buf_i;
  p.q_n = q_n, p.n = n, p.w = w, p.r = r_slots;
  p.nv = n_valid < 0 ? 0 : (n_valid < n ? n_valid : n);
  p.chunks = (d + COLS - 1) / COLS;
  p.stages = stages;
  p.l2 = l2 != 0;
  p.global_slots = global_slots != 0;
  if (p.l2) {
    p.q_sq = norms;
    p.d_sq = norms + q_n;
    cudaError_t err = knn::launch_norms<float>(q, q_n, d, norms, stream);
    if (err == cudaSuccess)
      err = knn::launch_norms<float>(db, n, d, norms + q_n, stream);
    if (err != cudaSuccess) return (int)err;
  }
  return (int)launch(q, db, p, d, smem, stream);
}
