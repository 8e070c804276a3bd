// Kernel K: slab expansion, the gather-and-score step of the IVF per-probe
// path and of graph beam search.
//
// Replaces both kernels behind knn_for_homology_tpu/ops/graph_pallas.py:
// beam_expand: _expand_kernel (auto-pipelined BlockSpec gathers) and
// _expand_kernel_dma (manual double-buffered DMA). The two differ only in
// how the TPU moved the slabs; their scoring tail (_score_epilogue) is the
// same, so one kernel serves both. For query q and each of its E selected
// nodes n = sel[q, j]: read the node's [deg_p, d] int8 slab (rows
// n*deg_p ..), take the fp32 dot of each row with the query, multiply by
// the node's per-row scale, write -inf (times the scale, as the reference
// multiplies its -inf padding) in lanes >= deg_p, and copy the node's 128
// packed ids. Out: sims and ids [Q, E, 128].
//
// What bounds it here: bytes. Each (query, node) pair reads deg_p * d bytes
// of slab (128 KB at deg_p = 128, d = 1024) for 2 flops per byte, far below
// the card's flops per byte. So the design is a plain coalesced gather: a
// block per query holds the query in shared memory as fp32, each warp
// scores whole slab rows (32 lanes x 16 bytes cover 512 contiguous bytes of
// a row per load), kRows rows in flight per warp to keep enough loads
// outstanding, then a shuffle reduction per row. Node ids must lie in
// [0, n_nodes); the kernel clamps them so that a bad id cannot read outside
// the table.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kLane = 128;   // ids / scales / output lanes per node
constexpr int kWarps = 8;
constexpr int kRows = 4;     // slab rows in flight per warp
constexpr int kMaxD = 12288; // the query's fp32 copy stays under 48 KB

__device__ __forceinline__ int clamp_node(int node, int n_nodes) {
  return node < 0 ? 0 : node >= n_nodes ? n_nodes - 1 : node;
}

// sum over the 16 int8 of `v` times q[0..16), in order
__device__ __forceinline__ float dot16(int4 v, const float* q, float acc) {
  const int w[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int b = 0; b < 4; ++b)
      acc = fmaf((float)(int8_t)(w[i] >> (8 * b)), q[4 * i + b], acc);
  return acc;
}

__global__ void __launch_bounds__(kWarps * 32)
slab_expand(const int* __restrict__ sel, const float* __restrict__ q,
            const int8_t* __restrict__ pv, const int* __restrict__ pi,
            const float* __restrict__ sc, float* __restrict__ sims,
            int* __restrict__ nbrs, int e, int d, int deg_p, int n_nodes) {
  extern __shared__ float qs[];  // the query, d floats
  const int qi = blockIdx.x;
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  for (int c = tid; c < d; c += blockDim.x) qs[c] = q[(size_t)qi * d + c];
  __syncthreads();

  const int chunks = d / 16;  // 16-byte loads per slab row
  const int rows = e * deg_p;
  const int* sel_q = sel + (size_t)qi * e;
  for (int base = warp * kRows; base < rows; base += kWarps * kRows) {
    const int4* src[kRows];
    float acc[kRows];
#pragma unroll
    for (int u = 0; u < kRows; ++u) {
      const int r = min(base + u, rows - 1);
      const int node = clamp_node(sel_q[r / deg_p], n_nodes);
      src[u] = reinterpret_cast<const int4*>(
          pv + ((size_t)node * deg_p + r % deg_p) * d);
      acc[u] = 0.f;
    }
    for (int c = lane; c < chunks; c += 32) {
      int4 v[kRows];
#pragma unroll
      for (int u = 0; u < kRows; ++u) v[u] = __ldg(src[u] + c);
#pragma unroll
      for (int u = 0; u < kRows; ++u) acc[u] = dot16(v[u], qs + 16 * c, acc[u]);
    }
#pragma unroll
    for (int u = 0; u < kRows; ++u)
#pragma unroll
      for (int off = 16; off > 0; off >>= 1)
        acc[u] += __shfl_xor_sync(0xffffffffu, acc[u], off);
    if (lane == 0) {
#pragma unroll
      for (int u = 0; u < kRows; ++u) {
        const int r = base + u;
        if (r >= rows) break;
        const int j = r / deg_p, l = r % deg_p;
        const int node = clamp_node(sel_q[j], n_nodes);
        sims[((size_t)qi * e + j) * kLane + l] =
            acc[u] * sc[(size_t)node * kLane + l];
      }
    }
  }

  // ids of every lane, and the -inf padding lanes >= deg_p
  for (int t = tid; t < e * kLane; t += blockDim.x) {
    const int j = t / kLane, l = t % kLane;
    const int node = clamp_node(sel_q[j], n_nodes);
    const size_t out = ((size_t)qi * e + j) * kLane + l;
    nbrs[out] = pi[(size_t)node * kLane + l];
    if (l >= deg_p) sims[out] = -INFINITY * sc[(size_t)node * kLane + l];
  }
}

}  // namespace

// sel [q_n, e] int32 node ids; q [q_n, d] f32; pv [n_nodes*deg_p, d] int8;
// pi, sc [n_nodes, 128]; sims, nbrs [q_n, e, 128]. d % 16 == 0 (the packed
// slabs are lane-padded to a multiple of 128), deg_p <= 128.
extern "C" int knn_slab_expand(const int* sel, const float* q,
                               const int8_t* pv, const int* pi,
                               const float* sc, float* sims, int* nbrs,
                               int q_n, int e, int d, int deg_p, int n_nodes,
                               cudaStream_t stream) {
  if (q_n < 1 || e < 1 || d < 16 || d % 16 != 0 || d > kMaxD || deg_p < 1 ||
      deg_p > kLane || n_nodes < 1)
    return (int)cudaErrorInvalidValue;
  slab_expand<<<q_n, kWarps * 32, (size_t)d * sizeof(float), stream>>>(
      sel, q, pv, pi, sc, sims, nbrs, e, d, deg_p, n_nodes);
  return (int)cudaGetLastError();
}
