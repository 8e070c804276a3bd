// Kernel L: XLNet's relative-position attention, forward, fused flash style.
//
// Replaces no TPU kernel: the JAX package runs XLNet's attention as plain
// XLA ops (knn_for_homology_tpu/models/xlnet.py:_rel_attn), which hold the
// [B, H, L, L] content scores, the [B, H, L, 2L] position scores and their
// reshape shift in memory. Per (query i, key j):
//
//   score = ((q_i + r_w).k_j + (q_i + r_r).R[L - i + j]) / 8
//
// with R = sinusoid(L ... -L+1) . W_r, bf16 [2L, H, 64] (any row stride:
// the encoder passes one layer's slice of all layers' R). Then the mask,
// the softmax and p.v. Numerics are kernel H's: fp32 scores, running max
// from -1e9, masked keys get the -1e9 fill AND p = 0, the normaliser sums
// the fp32 p, p goes to bf16 unnormalised for PV (fp32 sums), out =
// bf16(acc / max(l, 1e-30)). A padded key stays attendable from its own
// row, as models/xlnet.py's plain route allows the diagonal (XLNet's
// non_tgt_mask), so a padded query row attends to the real keys and
// itself and is never NaN.
//
// What bounds it on an H100 at ProtXLNet's long batches (q, k, v
// [B, 16, L, 64] bf16, L up to 3202, B = 2): three products, 6*B*H*L^2*64
// flop = 1.26e11 at B = 2, L = 3202, 0.127 ms at the 989 TFLOP/s bf16
// peak; q, k, v, out and R are ~60 MB, 0.018 ms at 3.35 TB/s. No [L, L] or
// [L, 2L] tensor reaches device memory.
//
// Design: kernel H's layout (csrc/attention_t5.cuh) at d_head 64, one
// 128-byte swizzled tile a box. A block takes 128 queries of one (batch
// row, head) in two consumer warpgroups of 64 rows, and a producer warp
// whose lane 0 keeps q, k, v and R tiles coming by TMA in the order the
// consumers need them. The position term is a product too: a warpgroup's
// 64 queries at key tile t reach the 127 rows of R from its base + 64t, so
// it multiplies (q + r_r) by 64-row chunks of R with wgmma and keeps the
// last two chunks' [64 x 64] fp32 products in a ring of 128 columns in
// shared memory; the score of (row r, key c) is read back skewed, at
// column (63 - r + c + 64t) mod 128. One new chunk a key tile, so the
// position term costs one more product of the content term's size (two
// for the first tile). The two warpgroups' chunk sequences are one chunk
// apart, so the block loads each chunk of R once, into a ring of four
// slots. Rows of R outside [0, 2L) arrive as zeros (TMA's fill, negative
// coordinates included); they meet only keys or queries past L.
//   Shared memory: q + r_w and q + r_r (2 x 2 x 8 KB), k and v rings (3 x
// 8 KB each), the R ring (4 x 8 KB), the position rings (2 x 64 x 136
// floats, 69.6 KB), barriers and key bits: ~186 KB, one block an SM.

#include "attention_t5.cuh"

namespace knn_xlnet {

using namespace knn_sm90;
using knn_attn::bf16;
using knn_attn::BK;
using knn_attn::LOG2E;
using knn_attn::NEG2;

constexpr int DH = 64;
constexpr int NWG = 2;                  // consumer warpgroups of 64 rows
constexpr int BQ = 64 * NWG;            // queries a block
constexpr int TILE = 64 * DH;           // bf16 elements of one 64-row tile
constexpr int TILE_BYTES = TILE * 2;    // 8 KB, eight 1024-byte swizzle atoms
constexpr int KST = 3, VST = 3, RST = 4;  // ring slots of k, v and R
constexpr int PS = 136;  // floats a row of a position ring (128 + 8: a
                         // half-warp's v2 stores hit 32 distinct banks)
constexpr float SCALE2 = 0.125f * LOG2E;  // 1/sqrt(64), in exp2's scale

constexpr int N_BARS = 1 + 2 * KST + 2 * VST + 2 * RST;
constexpr int TILES_BYTES = (2 * NWG + KST + VST + RST) * TILE_BYTES;
constexpr int POS_BYTES = NWG * 64 * PS * 4;

inline size_t smem_bytes(int l) {
  const int n_tiles = (l + BK - 1) / BK;
  return 1024 + TILES_BYTES + POS_BYTES + 8 * N_BARS + 8 * (size_t)n_tiles;
}

__device__ __forceinline__ void sts_v2(uint32_t addr, float a, float b) {
  asm volatile("st.shared.v2.f32 [%0], {%1, %2};\n"
               :: "r"(addr), "f"(a), "f"(b) : "memory");
}

// d[64 x 64] += A[64 x 16] (registers) . B[16 x 64] (MN-major, shared)
__device__ __forceinline__ void wgmma_pv(float (&d)[32], const uint32_t (&a)[4],
                                         uint64_t desc_b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, "
      "%30, %31}, {%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc_b), "r"(1));
}

// acc = A . B^T over d_head in 16-wide steps, both 64-row K-major tiles in
// shared memory (a step's descriptors point 32 bytes further into the
// 128-byte swizzled rows)
__device__ __forceinline__ void issue_dot(float (&acc)[32], uint32_t a_addr,
                                          uint32_t b_addr) {
  wgmma_fence();
#pragma unroll
  for (int kk = 0; kk < DH / 16; ++kk)
    knn_attn::wgmma_qk(acc, sw128_desc(a_addr + 32 * kk, 16, 1024),
                       sw128_desc(b_addr + 32 * kk, 16, 1024), kk > 0);
  wgmma_commit();
}

// One consumer warpgroup: its 64 rows' output accumulator, row max (in
// exp2's scale) and sum, O's pending rescale and the bf16 P of the pending
// PV product; a lane holds rows rl0 and rl0 + 8 (local to the warpgroup).
struct Consumer {
  uint32_t qw_addr, qr_addr, k_base, v_base, r_base, pos, bits;
  uint32_t k_full, v_full, r_full;
  int t, rl0, row0, e;  // e: this warpgroup's first chunk of R
  float o[32];
  float m0, m1, l0, l1, c0, c1;
  uint32_t pa[BK / 16][4];

  __device__ __forceinline__ void issue_qk(float (&s)[32], int it) {
    const int slot = it % KST;
    mbar_wait(k_full + 8 * slot, (it / KST) & 1);
    issue_dot(s, qw_addr, k_base + slot * TILE_BYTES);
  }

  // (q + r_r) . R^T over chunk m of the block's R window; returns its slot
  __device__ __forceinline__ int issue_qr(float (&pn)[32], int m) {
    const int slot = m % RST;
    mbar_wait(r_full + 8 * slot, (m / RST) & 1);
    issue_dot(pn, qr_addr, r_base + slot * TILE_BYTES);
    return slot;
  }

  // a chunk's products into ring half `half` of this lane's two rows
  __device__ __forceinline__ void store_pos(const float (&pn)[32], int half) {
    const uint32_t p0 = pos + 4 * (rl0 * PS + 64 * half + 2 * t);
    const uint32_t p1 = p0 + 4 * 8 * PS;
    __syncwarp();  // this warp's reads of the half's previous chunk are done
#pragma unroll
    for (int j = 0; j < BK / 8; ++j) {
      sts_v2(p0 + 32 * j, pn[4 * j], pn[4 * j + 1]);
      sts_v2(p1 + 32 * j, pn[4 * j + 2], pn[4 * j + 3]);
    }
    __syncwarp();
  }

  // O = c * O + bf16(P).V for key tile `it`. v's descriptor: 8-key groups
  // 1024 bytes apart (MN-major, transposed by the instruction).
  __device__ __forceinline__ void issue_pv(int it) {
#pragma unroll
    for (int n = 0; n < DH / 8; ++n) {
      o[4 * n] *= c0;
      o[4 * n + 1] *= c0;
      o[4 * n + 2] *= c1;
      o[4 * n + 3] *= c1;
    }
    const int slot = it % VST;
    mbar_wait(v_full + 8 * slot, (it / VST) & 1);
    const uint32_t v_addr = v_base + slot * TILE_BYTES;
    fence_regs(o);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < BK / 16; ++kk)
      wgmma_pv(o, pa[kk], sw128_desc(v_addr + kk * 2048, TILE_BYTES, 1024));
    wgmma_commit();
  }

  // The online softmax of key tile `it` on its content scores s: adds the
  // position term from the ring, scales, masks; leaves fp32 p in s and O's
  // rescale in c0, c1.
  __device__ __forceinline__ void softmax(int it, float (&s)[32]) {
    const int k0 = it * BK;
    const uint64_t word = knn_attn::lds_u64(bits + 8 * it);
    const bool full = word == ~0ull;  // every key of the tile real
    const uint64_t mine = word >> (2 * t);
    const uint32_t bits_lo = static_cast<uint32_t>(mine);
    const uint32_t bits_hi = static_cast<uint32_t>(mine >> 32);
    // ring column of (row, key k0 + 2t + kl): (63 - row + 2t + kl + 64 it)
    const int sh0 = 63 - rl0 + 2 * t + 64 * it, sh1 = sh0 - 8;
    const uint32_t p0 = pos + 4 * rl0 * PS, p1 = p0 + 4 * 8 * PS;
    const int d0 = row0 - k0 - 2 * t, d1 = d0 + 8;  // the diagonal's kl
#pragma unroll
    for (int j = 0; j < BK / 8; ++j)
#pragma unroll
      for (int e2 = 0; e2 < 4; ++e2) {
        const int kl = 8 * j + (e2 & 1);
        const bool lo = e2 < 2;
        const float bd = knn_attn::lds_f32(
            (lo ? p0 : p1) + 4 * (((lo ? sh0 : sh1) + kl) & 127));
        const float val = (s[4 * j + e2] + bd) * SCALE2;
        const bool keep =
            full || (((j < 4 ? bits_lo : bits_hi) >> (kl & 31)) & 1u) ||
            kl == (lo ? d0 : d1);
        s[4 * j + e2] = keep ? val : NEG2;
      }
    float r0[BK / 8], r1[BK / 8];
#pragma unroll
    for (int j = 0; j < BK / 8; ++j) {
      r0[j] = fmaxf(s[4 * j], s[4 * j + 1]);
      r1[j] = fmaxf(s[4 * j + 2], s[4 * j + 3]);
    }
#pragma unroll
    for (int w = BK / 16; w >= 1; w /= 2)
#pragma unroll
      for (int j = 0; j < w; ++j) {
        r0[j] = fmaxf(r0[j], r0[j + w]);
        r1[j] = fmaxf(r1[j], r1[j + w]);
      }
    const float mx0 = knn_attn::quad_max(fmaxf(m0, r0[0]));
    const float mx1 = knn_attn::quad_max(fmaxf(m1, r1[0]));
    c0 = knn_attn::ex2(m0 - mx0);
    c1 = knn_attn::ex2(m1 - mx1);
#pragma unroll
    for (int j = 0; j < BK / 8; ++j)
#pragma unroll
      for (int e2 = 0; e2 < 4; ++e2) {
        const int kl = 8 * j + (e2 & 1);
        const bool lo = e2 < 2;
        const bool keep =
            full || (((j < 4 ? bits_lo : bits_hi) >> (kl & 31)) & 1u) ||
            kl == (lo ? d0 : d1);
        s[4 * j + e2] = keep ? knn_attn::ex2(s[4 * j + e2] - (lo ? mx0 : mx1))
                             : 0.0f;
      }
#pragma unroll
    for (int j = 0; j < BK / 8; ++j) {
      r0[j] = s[4 * j] + s[4 * j + 1];
      r1[j] = s[4 * j + 2] + s[4 * j + 3];
    }
    l0 = l0 * c0 + knn_attn::quad_sum(knn_attn::tree_sum(r0));
    l1 = l1 * c1 + knn_attn::quad_sum(knn_attn::tree_sum(r1));
    m0 = mx0;
    m1 = mx1;
  }

  // p's C fragments are the A fragments of PV, 16 keys per step
  __device__ __forceinline__ void pack(const float (&s)[32]) {
#pragma unroll
    for (int kk = 0; kk < BK / 16; ++kk) {
      pa[kk][0] = knn_attn::pack_bf16(s[8 * kk], s[8 * kk + 1]);
      pa[kk][1] = knn_attn::pack_bf16(s[8 * kk + 2], s[8 * kk + 3]);
      pa[kk][2] = knn_attn::pack_bf16(s[8 * kk + 4], s[8 * kk + 5]);
      pa[kk][3] = knn_attn::pack_bf16(s[8 * kk + 6], s[8 * kk + 7]);
    }
  }
};

// Warp specialisation as kernel H: two consumer warpgroups and one
// producer warp. The 288-thread block is charged as 384 threads, so
// registers are capped at 168 and one block runs an SM (as H).
__global__ void __maxnreg__(168)
attention_xlnet_kernel(const __grid_constant__ CUtensorMap q_map,
                       const __grid_constant__ CUtensorMap k_map,
                       const __grid_constant__ CUtensorMap v_map,
                       const __grid_constant__ CUtensorMap r_map,
                       const uint8_t* __restrict__ mask,
                       const bf16* __restrict__ r_w,
                       const bf16* __restrict__ r_r, bf16* __restrict__ out,
                       int h_n, int l) {
  extern __shared__ unsigned char smem_raw[];
  unsigned char* base =
      smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) & 1023);
  bf16* s_q = reinterpret_cast<bf16*>(base);  // q, then q + r_w
  bf16* s_qr = s_q + NWG * TILE;              // q + r_r
  bf16* s_k = s_qr + NWG * TILE;
  bf16* s_v = s_k + KST * TILE;
  bf16* s_r = s_v + VST * TILE;
  float* s_pos = reinterpret_cast<float*>(base + TILES_BYTES);
  uint64_t* q_full = reinterpret_cast<uint64_t*>(base + TILES_BYTES +
                                                 POS_BYTES);
  uint64_t* k_full = q_full + 1;
  uint64_t* k_empty = k_full + KST;
  uint64_t* v_full = k_empty + KST;
  uint64_t* v_empty = v_full + VST;
  uint64_t* r_full = v_empty + VST;
  uint64_t* r_empty = r_full + RST;
  uint64_t* s_bits = q_full + N_BARS;
  const int n_tiles = (l + BK - 1) / BK;

  const int q0 = blockIdx.x * BQ, head = blockIdx.y, b = blockIdx.z;
  const int bh = b * h_n + head;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  // chunk m of the block's R window: rows r0 + 64m .. r0 + 64m + 63; the
  // warpgroup of queries q0 + 64w .. + 63 reads chunks 1 - w + t and
  // 2 - w + t at key tile t
  const int r0 = l - q0 - (BQ - 1);

  if (threadIdx.x == 0) {
    mbar_init(q_full, 1);
    for (int i = 0; i < KST; ++i) {
      mbar_init(&k_full[i], 1);
      mbar_init(&k_empty[i], 4 * NWG);
    }
    for (int i = 0; i < VST; ++i) {
      mbar_init(&v_full[i], 1);
      mbar_init(&v_empty[i], 4 * NWG);
    }
    for (int i = 0; i < RST; ++i) {
      mbar_init(&r_full[i], 1);
      mbar_init(&r_empty[i], 4 * NWG);
    }
    mbar_init_fence();
  }
  __syncthreads();

  if (warp == 4 * NWG) {
    // ---- producer: q once; then k(it), the chunks of R step it needs
    // first and v(it - 1), each into its ring slot once every consumer
    // warp has released the slot's previous tile
    if (lane == 0) {
      tma_prefetch(&q_map);
      tma_prefetch(&k_map);
      tma_prefetch(&v_map);
      tma_prefetch(&r_map);
      mbar_expect_tx(q_full, NWG * TILE_BYTES);
      for (int w = 0; w < NWG; ++w)
        tma_load_3d(s_q + w * TILE, &q_map, q_full, 0, q0 + 64 * w, bh);
      auto load_r = [&](int m) {
        const int slot = m % RST;
        mbar_wait(&r_empty[slot], ((m / RST) & 1) ^ 1);
        mbar_expect_tx(&r_full[slot], TILE_BYTES);
        tma_load_2d(s_r + slot * TILE, &r_map, &r_full[slot], head * DH,
                    r0 + 64 * m);
      };
      for (int it = 0; it <= n_tiles; ++it) {
        if (it < n_tiles) {
          const int slot = it % KST;
          mbar_wait(&k_empty[slot], ((it / KST) & 1) ^ 1);
          mbar_expect_tx(&k_full[slot], TILE_BYTES);
          tma_load_3d(s_k + slot * TILE, &k_map, &k_full[slot], 0, it * BK,
                      bh);
          if (it == 0) {
            load_r(0);
            load_r(1);
            load_r(2);
          } else {
            load_r(it + 2);
          }
        }
        if (it > 0) {
          const int j = it - 1, slot = j % VST;
          mbar_wait(&v_empty[slot], ((j / VST) & 1) ^ 1);
          mbar_expect_tx(&v_full[slot], TILE_BYTES);
          tma_load_3d(s_v + slot * TILE, &v_map, &v_full[slot], 0, j * BK,
                      bh);
        }
      }
    }
    return;
  }

  const int wg = warp / 4;
  // ---- consumers: the key bits, and q + r_w, q + r_r in the swizzled
  // layout (16-byte chunk c of row r holds columns 8 (c ^ (r % 8)) ...)
  {
    const uint8_t* mb = mask + (size_t)b * l;
    for (int i = warp; i < n_tiles; i += 4 * NWG) {
      const int k_lo = i * BK + lane, k_hi = k_lo + 32;
      const uint32_t lo = __ballot_sync(0xffffffffu, k_lo < l && mb[k_lo]);
      const uint32_t hi = __ballot_sync(0xffffffffu, k_hi < l && mb[k_hi]);
      if (lane == 0) s_bits[i] = lo | (static_cast<uint64_t>(hi) << 32);
    }
    mbar_wait(q_full, 0);
    bf16* qt = s_q + wg * TILE;
    bf16* qrt = s_qr + wg * TILE;
    const bf16* rw = r_w + head * DH;
    const bf16* rr = r_r + head * DH;
    for (int c = threadIdx.x % 128; c < 64 * 8; c += 128) {
      const int row = c / 8, col = 8 * ((c % 8) ^ (row % 8));
      uint4 raw = *reinterpret_cast<const uint4*>(qt + 8 * c);
      uint4 with_w, with_r;
      const bf16* x = reinterpret_cast<const bf16*>(&raw);
      bf16* yw = reinterpret_cast<bf16*>(&with_w);
      bf16* yr = reinterpret_cast<bf16*>(&with_r);
#pragma unroll
      for (int e = 0; e < 8; ++e) {
        const float f = __bfloat162float(x[e]);
        yw[e] = __float2bfloat16_rn(f + __bfloat162float(rw[col + e]));
        yr[e] = __float2bfloat16_rn(f + __bfloat162float(rr[col + e]));
      }
      *reinterpret_cast<uint4*>(qt + 8 * c) = with_w;
      *reinterpret_cast<uint4*>(qrt + 8 * c) = with_r;
    }
    fence_async_shared();  // the stores above feed wgmma (async proxy)
    asm volatile("bar.sync 1, %0;\n" :: "n"(NWG * 128) : "memory");
  }

  Consumer c;
  c.qw_addr = smem_u32(s_q + wg * TILE);
  c.qr_addr = smem_u32(s_qr + wg * TILE);
  c.k_base = smem_u32(s_k);
  c.v_base = smem_u32(s_v);
  c.r_base = smem_u32(s_r);
  c.pos = smem_u32(s_pos + wg * 64 * PS);
  c.bits = smem_u32(s_bits);
  c.k_full = smem_u32(k_full);
  c.v_full = smem_u32(v_full);
  c.r_full = smem_u32(r_full);
  c.t = lane & 3;
  c.rl0 = 16 * (warp % 4) + (lane >> 2);
  c.row0 = q0 + 64 * wg + c.rl0;
  c.e = NWG - 1 - wg;
#pragma unroll
  for (int i = 0; i < 32; ++i) c.o[i] = 0.0f;
  c.m0 = c.m1 = NEG2;
  c.l0 = c.l1 = 0.0f;

  // the window's first chunk: its products into ring half 0. The last
  // warpgroup never reads chunk 0 and releases it at once.
  float pn[32];
  if (c.e == 1 && lane == 0) mbar_arrive(&r_empty[0]);
  {
    const int slot = c.issue_qr(pn, c.e);
    wgmma_wait<0>();
    fence_regs(pn);
    if (lane == 0) mbar_arrive(&r_empty[slot]);
    c.store_pos(pn, 0);
  }

  // Key tile it issues S(it) and the position products of its new chunk,
  // then PV(it - 1), and runs the softmax of tile it while the tensor
  // cores sum PV(it - 1) (kernel H's order).
  float s[32];
  for (int it = 0; it < n_tiles; ++it) {
    c.issue_qk(s, it);
    const int r_slot = c.issue_qr(pn, c.e + it + 1);
    if (it > 0) {
      c.issue_pv(it - 1);
      wgmma_wait<1>();
    } else {
      wgmma_wait<0>();
    }
    fence_regs(s);
    fence_regs(pn);
    if (lane == 0) {
      mbar_arrive(&k_empty[it % KST]);
      mbar_arrive(&r_empty[r_slot]);
    }
    c.store_pos(pn, (it + 1) & 1);
    c.softmax(it, s);
    if (it > 0) {
      wgmma_wait<0>();
      fence_regs(c.o);
      if (lane == 0) mbar_arrive(&v_empty[(it - 1) % VST]);
    }
    c.pack(s);
  }
  c.issue_pv(n_tiles - 1);
  wgmma_wait<0>();
  fence_regs(c.o);

  const float d0 = fmaxf(c.l0, 1e-30f), d1 = fmaxf(c.l1, 1e-30f);
  const int row1 = c.row0 + 8;
  bf16* ob = out + (size_t)bh * l * DH;
#pragma unroll
  for (int n = 0; n < DH / 8; ++n) {
    const int col = 8 * n + 2 * c.t;
    if (c.row0 < l)
      *reinterpret_cast<uint32_t*>(ob + (size_t)c.row0 * DH + col) =
          knn_attn::pack_bf16(c.o[4 * n] / d0, c.o[4 * n + 1] / d0);
    if (row1 < l)
      *reinterpret_cast<uint32_t*>(ob + (size_t)row1 * DH + col) =
          knn_attn::pack_bf16(c.o[4 * n + 2] / d1, c.o[4 * n + 3] / d1);
  }
}

// A 3-d TMA map of a contiguous bf16 [B*H, L, 64] tensor: one box is a
// 64-row tile with the 128-byte swizzle; rows past L read as zeros.
inline bool make_qkv_map(CUtensorMap* map, const void* ptr, int l, int heads) {
  if (reinterpret_cast<uintptr_t>(ptr) % 16) return false;
  cuuint64_t dims[3] = {DH, (cuuint64_t)l, (cuuint64_t)heads};
  cuuint64_t strides[2] = {DH * 2, (cuuint64_t)l * DH * 2};
  cuuint32_t box[3] = {DH, 64, 1};
  cuuint32_t elem[3] = {1, 1, 1};
  return cuTensorMapEncodeTiled(
             map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 3, const_cast<void*>(ptr),
             dims, strides, box, elem, CU_TENSOR_MAP_INTERLEAVE_NONE,
             CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
             CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

// A 2-d map of R, [2L rows, H * 64 columns] with a row stride of its own:
// a box is 64 rows of one head's 64 columns; rows outside [0, 2L) read as
// zeros.
inline bool make_r_map(CUtensorMap* map, const void* ptr, int rows, int cols,
                       long long row_stride) {
  if (reinterpret_cast<uintptr_t>(ptr) % 16 || (row_stride * 2) % 16)
    return false;
  cuuint64_t dims[2] = {(cuuint64_t)cols, (cuuint64_t)rows};
  cuuint64_t strides[1] = {(cuuint64_t)row_stride * 2};
  cuuint32_t box[2] = {DH, 64};
  cuuint32_t elem[2] = {1, 1};
  return cuTensorMapEncodeTiled(
             map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2, const_cast<void*>(ptr),
             dims, strides, box, elem, CU_TENSOR_MAP_INTERLEAVE_NONE,
             CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
             CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

}  // namespace knn_xlnet

extern "C" int knn_flash_xlnet(const void* q, const void* k, const void* v,
                               const void* r, long long r_row_stride,
                               const void* mask, const void* r_w,
                               const void* r_r, void* out, int b_n, int h_n,
                               int l, cudaStream_t stream) {
  using namespace knn_xlnet;
  if (b_n < 1 || h_n < 1 || l < 1 || h_n > 65535 || b_n > 65535)
    return (int)cudaErrorInvalidValue;
  CUtensorMap maps[4];
  const void* ptrs[3] = {q, k, v};
  for (int i = 0; i < 3; ++i)
    if (!make_qkv_map(&maps[i], ptrs[i], l, b_n * h_n))
      return (int)cudaErrorInvalidValue;
  if (!make_r_map(&maps[3], r, 2 * l, h_n * DH, r_row_stride))
    return (int)cudaErrorInvalidValue;
  const size_t smem = smem_bytes(l);
  cudaError_t err = cudaFuncSetAttribute(
      attention_xlnet_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((l + BQ - 1) / BQ, h_n, b_n);
  attention_xlnet_kernel<<<grid, NWG * 128 + 32, smem, stream>>>(
      maps[0], maps[1], maps[2], maps[3], static_cast<const uint8_t*>(mask),
      static_cast<const bf16*>(r_w), static_cast<const bf16*>(r_r),
      static_cast<bf16*>(out), h_n, l);
  return (int)cudaGetLastError();
}
