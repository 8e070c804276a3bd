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
// TB/s. The [L, L] scores never reach device memory. Only wgmma reaches the
// bf16 peak; the earlier mma.sync design, with synchronous k/v staging and
// scalar fragment loads, ran at ~10% of it.
//
// Design: attention_t5.cuh with two consumer warpgroups (128 queries) and
// a producer warp per block: k and v tiles arrive by TMA into 3-slot rings
// in the order the consumers need them; one block per SM (~146 KB of
// shared memory at L = 3200: q, the rings, and the block's window of the
// head's table row, L + 191 floats). The TPU kernel's Toeplitz [n_rel, H,
// block, block] bias blocks were a Mosaic workaround; the table is built
// once per encode and shared by all layers. ptxas (sm_90a): 150 registers,
// no spills; the card charges the 288-thread block as 384 threads, so
// registers are capped at 168, and ptxas serialises the wgmma there (C7512,
// "insufficient register resources").

#include "attention_t5.cuh"

extern "C" int knn_flash_t5(const void* q, const void* k, const void* v,
                            const void* mask, const void* table, void* out,
                            int b_n, int h_n, int l, cudaStream_t stream) {
  if (b_n < 1 || h_n < 1 || l < 1 || h_n > 65535 || b_n > 65535)
    return (int)cudaErrorInvalidValue;
  return knn_attn::launch<2, false>(q, k, v, mask, table, out, b_n, h_n, l,
                                    stream);
}

extern "C" int knn_flash_t5_blocks_per_sm(int l) {
  return knn_attn::blocks_per_sm<2, false>(l);
}

