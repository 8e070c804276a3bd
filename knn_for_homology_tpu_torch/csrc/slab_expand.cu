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
// What bounds it here. Read pair by pair, the slabs are 128 KB each at
// deg_p = 128, d = 1024: 17 GB at 4096 queries x 32 probes, where the
// distinct slabs are 268 MB. So the (query, probe) pairs are grouped by
// node first, on the device with no host sync (ops/slab_cuda.py:slab_plan):
// a stable sort by node (torch), then slab_tiles cuts each node's run into
// tiles of at most NQ = 64 pairs. A block reads its tile's slab once and
// scores it against the tile's queries, and the bytes fall to about the
// distinct slabs'. The product then sets the pace (2 x 4096 x 32 x 128 x
// 1024 flops), so it runs on the tensor cores, fp32-accurate in two TF32
// products:
//
//   * A (registers): slab rows, m64 per warpgroup and row half (deg_p =
//     128 takes two), int8 converted to fp32 in registers; small integers
//     are exact in TF32.
//   * B (shared memory): the tile's queries, n = 8, 16, 32 or 64 columns
//     (the tile's pair count rounded up), so a node probed once costs an
//     n8 product. Each query value is split as big + small (tf32x3.cuh);
//     dot = slab . big + slab . small, dropping ~2^-22 of |slab||q|.
//
// Two launches, each over its list of tiles. Tiles of more than NARROW =
// 16 pairs (where the products set the pace) take the wide one: a
// warpgroup per 64 slab rows, query buffers of 64 rows, one block an SM.
// The rest (online search, a few pairs a node, where the latency of each
// chunk's steps sets it) take the narrow one: one warpgroup over both row
// halves, query buffers of 16 rows, two blocks an SM to overlap the steps
// (with every tile in the wide launch, 256 queries x 32 probes on 2048 to
// 32768 cells took 1.3-1.5x as long on an H100).
//
// Where most probed nodes are probed by one pair and there are queries
// enough to fill the card, a tile of one pair still takes a whole slab's
// chunk steps in lockstep, and the pair route below (a block a query,
// slab_expand_pairs) is faster; ops/slab_cuda.py:slab_route chooses.
//
// The slab streams through a ring of TMA boxes (deg_p rows x 64 columns,
// 64-byte swizzle), which thread 0 keeps full across the block's tiles (the
// grid is persistent: a block takes tiles blockIdx.x, + gridDim.x, ...).
// wgmma's A fragment gives a lane columns lane % 4 + 4 i of each k step, so
// a lane reads both its rows' 64 bytes (four 16-byte loads each, which the
// swizzle keeps free of bank conflicts) and converts byte lane % 4 of each
// word. The query rows, gathered by pair, come in by 16-byte cp.async, two
// chunks ahead, straight into wgmma's 128-byte-swizzled K-major layout;
// each thread splits the values it fetched in place (big) and into a second
// buffer (small). A chunk's products run while the next chunk's queries are
// split and its slab box waits.
//
// Accuracy (as in tf32x3.cuh): the tensor cores' fp32 sums
// truncate when they align addends, so each chunk's 16 products start a
// fresh register tile, which joins the fp32 sum with one rounded add.
//
// The wrapper clamps node ids to [0, n_nodes) before the sort, so a bad id
// cannot read outside the table.

#include <cuda.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "hopper.cuh"
#include "tf32x3.cuh"

namespace {

using namespace knn_sm90;

constexpr int kLane = 128;     // ids / scales / output lanes per node
constexpr int NQ = 64;         // pairs (queries) of a tile at most: wgmma N
// tiles of at most NARROW pairs (n8, n16) go to the narrow launch, whose
// query buffers hold NARROW rows, so that two blocks share an SM
constexpr int NARROW = 16;
constexpr int KC = 64;         // slab columns (int8 bytes) a chunk
constexpr int QSTAGES = 3;     // query chunks: fetched two ahead (big)
constexpr int MAX_STAGES = 8;  // slab chunks in flight
constexpr int SMEM_LIMIT = 227 * 1024;

__host__ __device__ constexpr int stage_bytes(int deg_p) {
  return (deg_p * KC + 1023) / 1024 * 1024;
}

// slab ring stages: 64 KB of boxes at deg_p > 64; 24 KB below, where two
// blocks of the wide launch then share an SM
__host__ __device__ constexpr int ring_stages(int deg_p) {
  const int n = (deg_p > 64 ? 64 : 24) * 1024 / stage_bytes(deg_p);
  return n < MAX_STAGES ? n : MAX_STAGES;
}

// 1024-byte alignment slack; the query chunks (QSTAGES big, two small) of
// nr rows; the slab ring and its barriers; the tile's pair and query
// indices
__host__ __device__ constexpr size_t smem_bytes(int deg_p, int nr) {
  return 1024 + (size_t)(QSTAGES + 2) * 2 * nr * 128 +
         (size_t)ring_stages(deg_p) * (stage_bytes(deg_p) + 8) +
         2 * NQ * sizeof(int);
}

// d[64 x 8 NJ] (+)= A[64 x 8] . B[8 x 8 NJ], A tf32 in registers, B tf32
// K-major in shared memory
template <int NJ>
__device__ __forceinline__ void wgmma_nj(float (&d)[4 * NJ],
                                         const uint32_t (&a)[4], uint64_t b,
                                         int scale_d);

#define KNN_WGMMA_HEAD(N)                                   \
  "{\n.reg .pred p;\nsetp.ne.b32 p, %" #N ", 0;\n"         \
  "wgmma.mma_async.sync.aligned.m64n"

template <>
__device__ __forceinline__ void wgmma_nj<1>(float (&d)[4],
                                            const uint32_t (&a)[4],
                                            uint64_t b, int scale_d) {
  asm volatile(KNN_WGMMA_HEAD(9) "8k8.f32.tf32.tf32 "
               "{%0, %1, %2, %3}, {%4, %5, %6, %7}, %8, p, 1, 1;\n}\n"
               : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
               : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b),
                 "r"(scale_d));
}

template <>
__device__ __forceinline__ void wgmma_nj<2>(float (&d)[8],
                                            const uint32_t (&a)[4],
                                            uint64_t b, int scale_d) {
  asm volatile(KNN_WGMMA_HEAD(13) "16k8.f32.tf32.tf32 "
               "{%0, %1, %2, %3, %4, %5, %6, %7}, "
               "{%8, %9, %10, %11}, %12, p, 1, 1;\n}\n"
               : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
                 "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7])
               : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b),
                 "r"(scale_d));
}

template <>
__device__ __forceinline__ void wgmma_nj<4>(float (&d)[16],
                                            const uint32_t (&a)[4],
                                            uint64_t b, int scale_d) {
  asm volatile(KNN_WGMMA_HEAD(21) "32k8.f32.tf32.tf32 "
               "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, "
               "%13, %14, %15}, {%16, %17, %18, %19}, %20, p, 1, 1;\n}\n"
               : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
                 "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
                 "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
                 "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15])
               : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b),
                 "r"(scale_d));
}

template <>
__device__ __forceinline__ void wgmma_nj<8>(float (&d)[32],
                                            const uint32_t (&a)[4],
                                            uint64_t b, int scale_d) {
  knn_tf32::wgmma_tf32(d, a, b, scale_d);  // m64n64k8
}

#undef KNN_WGMMA_HEAD

struct Args {
  const float* q;      // [q_n, d]
  const int* pi;       // [n_nodes, 128]
  const float* sc;     // [n_nodes, 128]
  const int* order;    // [P] pair ids (q * e + j), stably sorted by node
  const int* nodes;    // [P] their clamped nodes, in that order
  const int* n_tiles;  // the launch's tile count
  const int* tiles;    // its tiles: (first sorted position, pairs)
  float* sims;         // [P, 128]
  int* nbrs;           // [P, 128]
  int e, d, deg_p, chunks;
};

// The slab ring: `stages` boxes of deg_p rows x 64 bytes.
struct Ring {
  unsigned char* ptr;
  uint64_t* full;
  int stages, stage_bytes, s, phase;

  __device__ __forceinline__ void advance() {
    if (++s == stages) {
      s = 0;
      phase ^= 1;
    }
  }
};

// Thread 0's load cursor over the block's (tile, chunk) sequence: the next
// chunk to load, of tile t (row0 = the first slab row of its node), into
// stage s; t >= n_tiles when the block has no more.
struct Feed {
  int t, j, s, n_tiles, row0;

  __device__ __forceinline__ void seek(const Args& a) {
    if (t < n_tiles) row0 = a.nodes[a.tiles[2 * t]] * a.deg_p;
  }

  __device__ __forceinline__ void issue(const Args& a, const Ring& r,
                                        const CUtensorMap* map) {
    if (t >= n_tiles) return;
    mbar_expect_tx(&r.full[s], a.deg_p * KC);
    tma_load_2d(r.ptr + s * r.stage_bytes, map, &r.full[s], j * KC, row0);
    if (++s == r.stages) s = 0;
    if (++j == a.chunks) {
      j = 0;
      t += gridDim.x;
      seek(a);
    }
  }
};

// 16 bytes global -> shared, bypassing L1; zeros where src_bytes is 0
__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           int src_bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n"
               :: "r"(smem_u32(dst)), "l"(src), "r"(src_bytes) : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
// all but the newest group of this thread's copies have landed
__device__ __forceinline__ void cp_async_wait_all_but_one() {
  asm volatile("cp.async.wait_group 1;\n" ::: "memory");
}

// float of a signed byte: byte k of biased (a word ^ 0x80808080) below
// 2^23's exponent, minus 2^23 + 128
__device__ __forceinline__ uint32_t byte_f32(uint32_t biased, int k) {
  const float f = __uint_as_float(__byte_perm(biased, 0x4B000000u, 0x7540 + k));
  return __float_as_uint(__fsub_rn(f, 8388736.f));
}

// One tile: its cnt pairs (<= 8 NJ) against the node's slab, chunk by
// chunk, then the epilogue; query buffers of NR rows. WG warpgroups, MH
// row halves a warpgroup: warpgroup wg owns slab rows 64 (wg + m),
// m < MH, and in each of them a lane holds rows r0 + 64 m and r0 + 64 m + 8
// (r0 = 16 warp + lane / 4) and accumulator columns
// 8 jj + 2 (lane % 4) + {0, 1}.
template <int WG, int NJ, int NR, int MH>
struct Tile {
  static_assert(8 * NJ <= NR, "the tile's rows fit the query buffers");
  static constexpr int SUB = NR * 128;  // a 32-column sub-chunk of NR rows
  static constexpr int QBOX = 2 * SUB;  // a chunk of the tile's queries
  static constexpr int THREADS = 128 * WG;
  static constexpr int ACC = 4 * NJ;
  // 16-byte units of a query chunk: row n, columns 4 v .. 4 v + 3
  static constexpr int UNITS = 8 * NJ * 16;
  static constexpr int U = (UNITS + THREADS - 1) / THREADS;  // a thread's
  const Args& a;
  Ring& r;
  Feed& feed;
  const CUtensorMap* map;
  unsigned char* qbig;    // QSTAGES query chunks: fetched, then split
  unsigned char* qsmall;  // two chunks' small parts
  const int* pair_sm;
  const int* qrow_sm;
  int cnt, node, r0;
  unsigned live;  // bit 2 m + h: row r0 + 64 m + 8 h < deg_p
  float acc[MH][ACC], part[MH][ACC];
  uint32_t fr[MH][8][4];  // A fragments: [row half][k step][register]

  // unit k of this thread: (row n, 16-byte column v) and its byte offset
  // in a chunk (128-byte swizzle: 16-byte unit v % 8 of row n at
  // (v % 8) ^ (n % 8); columns 32 .. 63 in the second sub-chunk)
  __device__ __forceinline__ bool unit(int k, int& n, int& v, int& off) {
    const int u = threadIdx.x + k * THREADS;
    n = u >> 4;
    v = u & 15;
    off = (v >> 3) * SUB + n * 128 + (((v & 7) ^ (n & 7)) << 4);
    return UNITS % THREADS == 0 || u < UNITS;
  }

  // cp.async of chunk j of the tile's query rows into big stage j % 3;
  // zeros past cnt rows and past d. One commit group a call, empty past
  // the last chunk, so that every chunk waits for the same count.
  __device__ __forceinline__ void fetch(int j) {
    if (j < a.chunks) {
      unsigned char* dst = qbig + (j % QSTAGES) * QBOX;
#pragma unroll
      for (int k = 0; k < U; ++k) {
        int n, v, off;
        if (!unit(k, n, v, off)) continue;
        const int c = j * KC + 4 * v;
        const bool ok = n < cnt && c < a.d;
        cp_async16(dst + off, ok ? a.q + (size_t)qrow_sm[n] * a.d + c : a.q,
                   ok ? 16 : 0);
      }
    }
    cp_async_commit();
  }

  // the thread's own units of chunk j, landed: big in place, small beside
  __device__ __forceinline__ void split(int j) {
    unsigned char* big = qbig + (j % QSTAGES) * QBOX;
    unsigned char* small = qsmall + (j & 1) * QBOX;
#pragma unroll
    for (int k = 0; k < U; ++k) {
      int n, v, off;
      if (!unit(k, n, v, off)) continue;
      float4 x = *reinterpret_cast<float4*>(big + off);
      const float4 lo = knn_tf32::split4(x);
      *reinterpret_cast<float4*>(big + off) = x;
      *reinterpret_cast<float4*>(small + off) = lo;
    }
  }

  // the previous chunk's products are done: join them to the sum
  __device__ __forceinline__ void retire() {
    wgmma_wait<0>();
#pragma unroll
    for (int m = 0; m < MH; ++m) {
      fence_regs(part[m]);
#pragma unroll
      for (int i = 0; i < ACC; ++i)
        acc[m][i] = __fadd_rn(acc[m][i], part[m][i]);
    }
  }

  // A fragments of the current slab box: the thread's rows' 64 bytes;
  // 64-byte swizzle: 16-byte unit u of row r at u ^ ((r / 2) % 4), the
  // same for all of them. Logical column 8 kk + t + 4 h is byte t of word
  // 2 kk + h.
  __device__ __forceinline__ void convert() {
    const int t = threadIdx.x & 3;
    const unsigned char* st = r.ptr + r.s * r.stage_bytes;
    const int swz = (r0 >> 1) & 3;
#pragma unroll
    for (int m = 0; m < MH; ++m)
#pragma unroll
      for (int u = 0; u < 4; ++u) {
        uint4 w0 = make_uint4(0, 0, 0, 0), w1 = w0;
        const unsigned char* row = st + (r0 + 64 * m) * KC + ((u ^ swz) << 4);
        if (live >> (2 * m) & 1) w0 = *reinterpret_cast<const uint4*>(row);
        if (live >> (2 * m + 1) & 1)
          w1 = *reinterpret_cast<const uint4*>(row + 8 * KC);
        const uint32_t b0[4] = {w0.x ^ 0x80808080u, w0.y ^ 0x80808080u,
                                w0.z ^ 0x80808080u, w0.w ^ 0x80808080u};
        const uint32_t b1[4] = {w1.x ^ 0x80808080u, w1.y ^ 0x80808080u,
                                w1.z ^ 0x80808080u, w1.w ^ 0x80808080u};
#pragma unroll
        for (int i = 0; i < 4; ++i) {  // word 4 u + i: k step 2 u + i / 2
          const int kk = 2 * u + (i >> 1), h = i & 1;
          fr[m][kk][2 * h] = byte_f32(b0[i], t);
          fr[m][kk][2 * h + 1] = byte_f32(b1[i], t);
        }
      }
    r.advance();
  }

  // Chunk j (its queries fetched). kRetire: the previous chunk's products
  // run, so wait for them before this chunk's A fragments are made and its
  // products overwrite part, and before any thread reuses their query
  // stages. Made before the wait (into a second register set, or copied in
  // after it), the fragments came out wrong in some runs: ptxas does not
  // keep the A registers of a wgmma in flight from reuse (and an empty asm
  // that "uses" them leaves nothing in the PTX to stop it). The wait is not
  // behind a runtime branch, and the loop over chunks is not unrolled: a
  // path on which ptxas would move accumulators of a wgmma in flight makes
  // it serialise every wgmma (C7512, C7514; two fragment sets in a loop
  // unrolled by two did).
  template <bool kRetire>
  __device__ __forceinline__ void chunk(int j) {
    cp_async_wait_all_but_one();  // chunk j's; chunk j + 1's may fly
    split(j);
    mbar_wait(smem_u32(&r.full[r.s]), r.phase);
    // wgmma.wait_group waits for the calling thread's own products only,
    // and every warp's products read all of a query stage: each thread
    // retires chunk j - 1 before the barrier, so that no stage is written
    // after it (the fetch below, the next step's split) while another
    // warp's products still read it
    if (kRetire) retire();
    fence_async_shared();  // the split queries are read by wgmma
    __syncthreads();       // ... of every warp; the box read at the
                           // previous step is free
    if (threadIdx.x == 0) feed.issue(a, r, map);
    __syncwarp();
    convert();
    fetch(j + 2);  // into the stage chunk j - 1's products read
    wgmma_fence();
    const uint32_t big = smem_u32(qbig + (j % QSTAGES) * QBOX);
    const uint32_t small = smem_u32(qsmall + (j & 1) * QBOX);
#pragma unroll
    for (int kk = 0; kk < 8; ++kk) {
      const uint32_t at = (kk >> 2) * SUB + (kk & 3) * 32;
#pragma unroll
      for (int m = 0; m < MH; ++m)
        wgmma_nj<NJ>(part[m], fr[m][kk], sw128_desc(small + at, 16, 1024),
                     kk > 0);
#pragma unroll
      for (int m = 0; m < MH; ++m)
        wgmma_nj<NJ>(part[m], fr[m][kk], sw128_desc(big + at, 16, 1024), 1);
    }
    wgmma_commit();
  }

  __device__ __forceinline__ void run() {
    const int tid = threadIdx.x, t = tid & 3;
#pragma unroll
    for (int m = 0; m < MH; ++m)
#pragma unroll
      for (int i = 0; i < ACC; ++i) acc[m][i] = 0.f;
    fetch(0);
    fetch(1);
    chunk<false>(0);
#pragma unroll 1
    for (int j = 1; j < a.chunks; ++j) chunk<true>(j);
    retire();

    // scores of the live rows, scaled; -inf lanes and ids below
    const float* sc = a.sc + (size_t)node * kLane;
#pragma unroll
    for (int m = 0; m < MH; ++m) {
      const int row = r0 + 64 * m;
      const float s0 = live >> (2 * m) & 1 ? sc[row] : 0.f;
      const float s1 = live >> (2 * m + 1) & 1 ? sc[row + 8] : 0.f;
#pragma unroll
      for (int jj = 0; jj < NJ; ++jj)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int n = 8 * jj + 2 * t + (e & 1), hi = e >> 1;
          if (n < cnt && (live >> (2 * m + hi) & 1))
            a.sims[(size_t)pair_sm[n] * kLane + row + 8 * hi] =
                acc[m][4 * jj + e] * (hi ? s1 : s0);
        }
    }
    for (int u = tid; u < cnt * kLane; u += THREADS) {
      const int n = u / kLane, l = u % kLane;
      const size_t out = (size_t)pair_sm[n] * kLane + l;
      a.nbrs[out] = a.pi[(size_t)node * kLane + l];
      if (l >= a.deg_p) a.sims[out] = -INFINITY * sc[l];
    }
  }
};

template <int WG, int NJ, int NR, int MH>
__device__ __forceinline__ void run_tile(const Args& a, Ring& r, Feed& feed,
                                         const CUtensorMap* map,
                                         unsigned char* qbig,
                                         const int* pair_sm,
                                         const int* qrow_sm, int cnt,
                                         int node) {
  const int tid = threadIdx.x;
  const int r0 = 16 * (tid / 32) + (tid % 32) / 4;  // 64 wg + 16 warp + g
  unsigned live = 0;
#pragma unroll
  for (int b = 0; b < 2 * MH; ++b)
    live |= (unsigned)(r0 + 64 * (b >> 1) + 8 * (b & 1) < a.deg_p) << b;
  Tile<WG, NJ, NR, MH> tile{a,       r,       feed, map,
                            qbig,    qbig + QSTAGES * 2 * NR * 128,
                            pair_sm, qrow_sm, cnt,  node, r0, live};
  tile.run();
}

// WG warpgroups of MH row halves: 128 WG MH >= deg_p rows; query buffers
// of NR rows: NQ for the wide launch (one warpgroup per 64 rows), NARROW
// for the narrow one (one warpgroup, two blocks an SM)
template <int WG, int NR, int MH>
__global__ void __launch_bounds__(128 * WG, NR == NQ ? 1 : 2)
slab_expand(const __grid_constant__ CUtensorMap map,
            const __grid_constant__ Args a) {
  extern __shared__ unsigned char smem_raw[];
  unsigned char* qbig =
      smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) & 1023);
  Ring r;
  r.stages = ring_stages(a.deg_p);
  r.stage_bytes = stage_bytes(a.deg_p);
  r.ptr = qbig + (QSTAGES + 2) * 2 * NR * 128;
  r.full = reinterpret_cast<uint64_t*>(r.ptr + r.stages * r.stage_bytes);
  r.s = r.phase = 0;
  int* pair_sm = reinterpret_cast<int*>(r.full + r.stages);
  int* qrow_sm = pair_sm + NQ;
  const int tid = threadIdx.x;

  // the ring starts one box short of full: each chunk's step loads into
  // the stage the step before it read
  const int n_tiles = *a.n_tiles;
  Feed feed{(int)blockIdx.x, 0, 0, n_tiles, 0};
  if (tid == 0) {
    for (int i = 0; i < r.stages; ++i) mbar_init(&r.full[i], 1);
    mbar_init_fence();
    tma_prefetch(&map);
    feed.seek(a);
    for (int i = 0; i + 1 < r.stages; ++i) feed.issue(a, r, &map);
  }

  for (int t = blockIdx.x; t < n_tiles; t += gridDim.x) {
    const int start = a.tiles[2 * t], c = a.tiles[2 * t + 1];  // 1 .. NR
    __syncthreads();  // the last tile's epilogue has read pair_sm
    if (tid < c) {
      const int pr = a.order[start + tid];
      pair_sm[tid] = pr;
      qrow_sm[tid] = pr / a.e;
    }
    const int nd = a.nodes[start];
    __syncthreads();
    static_assert(NARROW == 16, "the narrow launch takes n8 and n16");
    if constexpr (NR == NARROW) {
      if (c <= 8)
        run_tile<WG, 1, NR, MH>(a, r, feed, &map, qbig, pair_sm, qrow_sm, c,
                                nd);
      else
        run_tile<WG, 2, NR, MH>(a, r, feed, &map, qbig, pair_sm, qrow_sm, c,
                                nd);
    } else {  // with no narrow launch (narrow = 0), small tiles run as n32
      if (c <= 32)
        run_tile<WG, 4, NR, MH>(a, r, feed, &map, qbig, pair_sm, qrow_sm, c,
                                nd);
      else
        run_tile<WG, 8, NR, MH>(a, r, feed, &map, qbig, pair_sm, qrow_sm, c,
                                nd);
    }
  }
}

// The tile cut of the plan: one thread per sorted pair. A pair whose rank
// in its node's run is a multiple of NQ starts a tile of min(NQ, the rest
// of the run) pairs and claims a slot in the wide list (more than `narrow`
// pairs) or the narrow one; slots go in no fixed order, but each tile's
// pairs are fixed, so the scores do not depend on it. tiles: [wide count,
// narrow count, wide list (t_max pairs of ints), narrow list].
__global__ void slab_tiles(const int* __restrict__ nodes, int pairs,
                           int t_max, int narrow, int* __restrict__ tiles) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= pairs) return;
  const int node = nodes[i];
  int lo = 0, hi = i;  // the run's first position: lower bound in [0, i]
  while (lo < hi) {
    const int mid = (lo + hi) >> 1;
    if (nodes[mid] < node) lo = mid + 1;
    else hi = mid;
  }
  if ((i - lo) % NQ) return;
  lo = i + 1;  // the tile's end: upper bound in [i + 1, i + NQ]
  hi = min(pairs, i + NQ);
  while (lo < hi) {
    const int mid = (lo + hi) >> 1;
    if (nodes[mid] <= node) lo = mid + 1;
    else hi = mid;
  }
  const bool kind = lo - i <= narrow;
  const int t = atomicAdd(tiles + kind, 1);
  int* list = tiles + 2 + (kind ? 2 * t_max : 0);
  list[2 * t] = i;
  list[2 * t + 1] = lo - i;
}

template <int WG, int NR, int MH>
cudaError_t launch(const CUtensorMap& map, const Args& a, int t_max,
                   cudaStream_t stream) {
  const size_t smem = smem_bytes(a.deg_p, NR);
  if (smem > (size_t)SMEM_LIMIT) return cudaErrorInvalidValue;
  cudaError_t err = cudaFuncSetAttribute(
      slab_expand<WG, NR, MH>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  static int sms = 0;
  if (err == cudaSuccess && sms == 0) {
    int dev = 0;
    err = cudaGetDevice(&dev);
    if (err == cudaSuccess)
      err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  }
  // a persistent grid of as many blocks as fit on the card at once
  int per_sm = 0;
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &per_sm, slab_expand<WG, NR, MH>, 128 * WG, smem);
  if (err != cudaSuccess) return err;
  if (per_sm < 1) return cudaErrorInvalidConfiguration;
  const int grid = t_max < sms * per_sm ? t_max : sms * per_sm;
  slab_expand<WG, NR, MH><<<grid, 128 * WG, smem, stream>>>(map, a);
  return cudaGetLastError();
}

// The wide launch (a warpgroup per 64 rows), then the narrow one (one
// warpgroup of WG row halves), each over its list of the plan. At deg_p >
// 64, a narrow block of two warpgroups (at most 128 registers a thread
// for two blocks an SM) had ptxas serialise its wgmma (C7512).
template <int WG>
cudaError_t launch_both(const CUtensorMap& map, Args a, const int* tiles,
                        int t_max, cudaStream_t stream) {
  a.n_tiles = tiles;
  a.tiles = tiles + 2;
  cudaError_t err = launch<WG, NQ, 1>(map, a, t_max, stream);
  if (err != cudaSuccess) return err;
  a.n_tiles = tiles + 1;
  a.tiles = tiles + 2 + 2 * t_max;
  return launch<1, NARROW, WG>(map, a, t_max, stream);
}

// The pair route: a block per query, which streams each of its E slabs
// (no plan, no sharing). Where most nodes are probed by one pair and the
// queries fill the card, this reads the same bytes as the tiles do at a
// higher rate: a tile of one pair still takes the chunk steps of a whole
// slab in lockstep, where these blocks keep kPairRows rows a warp in
// flight. Each warp scores whole slab rows (32 lanes x 16 bytes cover 512
// contiguous bytes of a row a load), fp32 FFMA, then a shuffle reduction a
// row. Node ids are clamped to [0, n_nodes).
constexpr int kPairWarps = 8;
constexpr int kPairRows = 4;      // slab rows in flight a warp
constexpr int kPairMaxD = 12288;  // the query's fp32 copy stays under 48 KB

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

__global__ void __launch_bounds__(kPairWarps * 32)
slab_expand_pairs(const int* __restrict__ sel, const float* __restrict__ q,
                  const int8_t* __restrict__ pv, const int* __restrict__ pi,
                  const float* __restrict__ sc, float* __restrict__ sims,
                  int* __restrict__ nbrs, int e, int d, int deg_p,
                  int n_nodes) {
  extern __shared__ float qs[];  // the query, d floats
  const int qi = blockIdx.x;
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  for (int c = tid; c < d; c += blockDim.x) qs[c] = q[(size_t)qi * d + c];
  __syncthreads();

  const int chunks = d / 16;  // 16-byte loads a slab row
  const int rows = e * deg_p;
  const int* sel_q = sel + (size_t)qi * e;
  for (int base = warp * kPairRows; base < rows;
       base += kPairWarps * kPairRows) {
    const int4* src[kPairRows];
    float acc[kPairRows];
#pragma unroll
    for (int u = 0; u < kPairRows; ++u) {
      const int r = min(base + u, rows - 1);
      const int node = clamp_node(sel_q[r / deg_p], n_nodes);
      src[u] = reinterpret_cast<const int4*>(
          pv + ((size_t)node * deg_p + r % deg_p) * d);
      acc[u] = 0.f;
    }
    for (int c = lane; c < chunks; c += 32) {
      int4 v[kPairRows];
#pragma unroll
      for (int u = 0; u < kPairRows; ++u) v[u] = __ldg(src[u] + c);
#pragma unroll
      for (int u = 0; u < kPairRows; ++u)
        acc[u] = dot16(v[u], qs + 16 * c, acc[u]);
    }
#pragma unroll
    for (int u = 0; u < kPairRows; ++u)
#pragma unroll
      for (int off = 16; off > 0; off >>= 1)
        acc[u] += __shfl_xor_sync(0xffffffffu, acc[u], off);
    if (lane == 0) {
#pragma unroll
      for (int u = 0; u < kPairRows; ++u) {
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

// The tile cut of kernel K's plan (ops/slab_cuda.py:slab_plan): nodes
// [pairs] clamped node ids sorted ascending; tiles [2 + 4 t_max] int32
// scratch (slab_tiles), t_max >= the tile count (the wrapper's bound from
// shapes); tiles of at most `narrow` (0 or NARROW) pairs go to the narrow
// list.
extern "C" int knn_slab_tiles(const int* nodes, int pairs, int t_max,
                              int narrow, int* tiles, cudaStream_t stream) {
  if (pairs < 1 || t_max < 1 || narrow < 0 || narrow > NARROW)
    return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaMemsetAsync(tiles, 0, 2 * sizeof(int), stream);
  if (err != cudaSuccess) return (int)err;
  slab_tiles<<<(pairs + 255) / 256, 256, 0, stream>>>(nodes, pairs, t_max,
                                                      narrow, tiles);
  return (int)cudaGetLastError();
}

// q [q_n, d] f32; pv [n_nodes*deg_p, d] int8; pi, sc [n_nodes, 128];
// sims, nbrs [q_n, e, 128]; the plan (ops/slab_cuda.py:slab_plan): order
// [q_n*e] pair ids (q * e + j) stably sorted by clamped node, nodes
// [q_n*e] those nodes, tiles from knn_slab_tiles. Two launches: the wide
// tiles', then the narrow tiles'. d % 16 == 0 (TMA rows of whole 16
// bytes; the packed slabs are lane-padded to a multiple of 128), deg_p <=
// 128.
extern "C" int knn_slab_expand(const float* q, const int8_t* pv,
                               const int* pi, const float* sc,
                               const int* order, const int* nodes,
                               const int* tiles, float* sims, int* nbrs,
                               int q_n, int e, int d, int deg_p, int n_nodes,
                               int t_max, cudaStream_t stream) {
  if (q_n < 1 || e < 1 || d < 16 || d % 16 != 0 || deg_p < 1 ||
      deg_p > kLane || n_nodes < 1 || t_max < 1)
    return (int)cudaErrorInvalidValue;
  CUtensorMap map;
  {
    cuuint64_t dims[2] = {(cuuint64_t)d, (cuuint64_t)n_nodes * deg_p};
    cuuint64_t strides[1] = {(cuuint64_t)d};
    cuuint32_t box[2] = {(cuuint32_t)KC, (cuuint32_t)deg_p};
    cuuint32_t one[2] = {1, 1};
    if (reinterpret_cast<uintptr_t>(pv) % 16 ||
        cuTensorMapEncodeTiled(
            &map, CU_TENSOR_MAP_DATA_TYPE_UINT8, 2, const_cast<int8_t*>(pv),
            dims, strides, box, one, CU_TENSOR_MAP_INTERLEAVE_NONE,
            CU_TENSOR_MAP_SWIZZLE_64B, CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
            CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) != CUDA_SUCCESS)
      return (int)cudaErrorInvalidValue;
  }
  const Args a{q,    pi, sc, order, nodes, nullptr, nullptr, sims,
               nbrs, e,  d,  deg_p, (d + KC - 1) / KC};
  return (int)(deg_p > 64 ? launch_both<2>(map, a, tiles, t_max, stream)
                          : launch_both<1>(map, a, tiles, t_max, stream));
}

// The pair route (slab_expand_pairs): sel [q_n, e] int32 node ids; q, pv,
// pi, sc, sims, nbrs as knn_slab_expand's. d % 16 == 0, d <= 12288, deg_p
// <= 128.
extern "C" int knn_slab_expand_pairs(const int* sel, const float* q,
                                     const int8_t* pv, const int* pi,
                                     const float* sc, float* sims, int* nbrs,
                                     int q_n, int e, int d, int deg_p,
                                     int n_nodes, cudaStream_t stream) {
  if (q_n < 1 || e < 1 || d < 16 || d % 16 != 0 || d > kPairMaxD ||
      deg_p < 1 || deg_p > kLane || n_nodes < 1)
    return (int)cudaErrorInvalidValue;
  slab_expand_pairs<<<q_n, kPairWarps * 32, (size_t)d * sizeof(float),
                      stream>>>(sel, q, pv, pi, sc, sims, nbrs, e, d, deg_p,
                                n_nodes);
  return (int)cudaGetLastError();
}
