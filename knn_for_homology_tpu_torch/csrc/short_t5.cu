// Kernel I: dense T5 attention for short sequences (L <= 1024).
//
// Replaces knn_for_homology_tpu/ops/short_attention.py:_short_kernel (entry
// short_attention_t5), with ops/short_attention.py:short_attention_plain's
// numerics: exact fp32 scores q.k plus the bias, the -1e9 fill for masked
// keys (p is NOT zeroed, so a row with every key masked softmaxes to
// uniform over its L keys), max, exp, sum and normalise in fp32, p cast to
// bf16, PV summed in fp32 and cast once. The bias comes as the [H, 2L-1]
// fp32 offset table of models/t5.py:offset_bias_table (the bias depends
// only on k_pos - q_pos), not as the dense [H, L, L] tensor. The encoder takes it
// for every batch padded to at most blockwise_above (1024) tokens on the
// card (models/t5.py:attention_route).
//
// What bounds it on an H100, at a 7000-token batch (q, k, v [B, 32, L, 128]
// bf16, L = 512, B = 13): the bytes, q, k, v and out (4 x 54.5 MB; the
// table and mask are negligible), 0.065 ms at 3.35 TB/s; the products,
// 4*B*H*L^2*128 = 5.6e10 flop, 0.056 ms at the 989 TFLOP/s bf16 peak. At
// L = 1024 (B = 6) the products lead: 1.03e11 flop, 0.104 ms. The earlier
// design read the dense fp32 bias once per score (436 MB a call) and kept
// a [64, L] fp32 score tile in shared memory (one block per SM).
//
// Design: attention_t5.cuh with one consumer warpgroup (64 queries) and a
// producer warp per block (TMA copies of q, k and v), ~100 KB of shared
// memory (q, a 3-slot k ring, a 2-slot v ring: 96 KB; the table window,
// (L + 127) floats, and the key bits: 4.5 KB at L = 1024) and at
// most 128 registers a thread, so two blocks fit per SM (the CUDA
// occupancy query, knn_short_t5_blocks_per_sm). The softmax is exact in
// two sweeps: sweep 1 streams k for the row max and sum (online), sweep 2
// recomputes q.k, normalises p before the bf16 cast and sums p.v on wgmma.
// The second q.k costs 1.5x the products' flop. ptxas (sm_90a, CUDA 12.8):
// 128 registers (the cap), 96 bytes of spill stores and 144 of spill
// loads, and the wgmma serialised for want of registers (C7512); a
// 168-register block of one warpgroup would fit only once per SM.

#include "attention_t5.cuh"

namespace {
constexpr int MAX_L = 1024;
}  // namespace

extern "C" int knn_short_t5(const void* q, const void* k, const void* v,
                            const void* mask, const void* table, void* out,
                            int b_n, int h_n, int l, cudaStream_t stream) {
  if (b_n < 1 || h_n < 1 || l < 1 || l > MAX_L || b_n > 65535 || h_n > 65535)
    return (int)cudaErrorInvalidValue;
  return knn_attn::launch<1, true>(q, k, v, mask, table, out, b_n, h_n, l,
                                   stream);
}

extern "C" int knn_short_t5_blocks_per_sm(int l) {
  return knn_attn::blocks_per_sm<1, true>(l);
}

