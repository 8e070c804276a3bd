// Kernel C: grouped Smith-Waterman local-alignment scores, affine gaps.
//
// Replaces knn_for_homology_tpu/ops/align_pallas.py:_sw_kernel and
// _sw_kernel_hbm (entry sw_scores_grouped_pallas): group g's query row
// codes [Lq] against its K target lanes [K, Lt], BLOSUM62 substitutions,
// a gap of length L costing gap_first + (L-1)*gap_ext. Output [G, K], or
// [G, S, K] with ragged lanes (S = segments > 1): a lane then holds several
// targets separated by -1 codes, and slot s scores the lane's (s+1)-th
// target (0 for absent segments). Scores are bit-identical to the
// reference: every quantity is an integer below 2^24, so the DP runs in
// int32.
//
// What bounds it here: integer operations, about ten a DP cell (the
// substitution, two gap updates, a four-way max, the running best), at
// the card's INT32 rate, when a launch holds more lanes than the card holds
// warps. A launch of a few long lanes is bound instead by one warp's
// dependent chain (two DPX operations a row, eight rows a step): about 450
// cycles a step on an H100. The TPU kernel kept the whole [Lt, K] state and a
// substitution profile in VMEM and swept all 128 lanes of a group at once,
// one query row per step. A lane is one (query, target) alignment, and a
// group holds about as many live lanes as its query has hits, so that
// plan leaves most of the card's threads without a lane. Here the
// parallelism is inside one alignment (the wavefront design of GPU
// Smith-Waterman codes such as CUDASW++ 4.0):
//
//   * One warp owns one live lane. Thread t holds RB = 8 consecutive query
//     rows of a strip of 32 * RB = 256 rows in registers: their H (of the
//     previous column), their E and their query codes. The planner's rows
//     come in buckets of 128 and the length mix's median is 330, so one or
//     two strips cover most queries; groups of 8 or 16 threads would only
//     pay off for queries under 128 residues, a few percent of the rows.
//   * Diagonal wavefront: at step s thread t works on column j = s - t. It
//     receives (H, F) of the row above its first row, and the column's
//     target code, from thread t-1 with __shfl_up_sync; thread 0 takes the
//     code, and (H, F) from the strip boundary, out of a 32-column chunk
//     the warp loads together, one chunk ahead, so no step waits on device
//     memory. E and H-left stay in the thread. The
//     substitution comes from BLOSUM62 in shared memory, laid out
//     [target code][query code] so the 32 threads' reads of one column
//     fall in distinct banks; a 25th code row and column of -2^24 is the
//     knocked-out substitution of pads.
//   * Long queries go in strips: thread 31 writes the strip's last row
//     (H, F) at each column to a per-warp scratch in device memory, where
//     the next strip reads it (one int2 per column and strip). Column j's
//     load, a chunk ahead, is consumed by step j, and thread 31 rewrites
//     the column at step j + 31, so each column is read before it is
//     rewritten.
//   * The cell runs on Hopper's DPX instructions: F and E are
//     __viaddmax_s32 (max(a + b, c)), H is __vimax3_s32_relu (a three-way
//     max with 0), and the running best __vimax_s32_relu.
//   * Lanes are found on the card: a first kernel (sw_lanes) scans each
//     lane from its end for its last residue, writes the lane's zeros to
//     the output and appends live lanes to a list; the DP kernel
//     (sw_wavefront) is a persistent grid whose warps take lanes from that
//     list with an atomic counter. Empty lanes cost one scan and no DP;
//     trailing pad rows and columns cannot raise a score and are skipped.
//   * Ragged lanes: each thread restarts at a separator when its wavefront
//     reaches it and keeps the running maximum of its rows in the current
//     segment; at each separator (and at the lane's end) it folds that
//     maximum into the warp's <= 63 segment slots in shared memory with
//     atomicMax; each output slot is written once, after the lane.
//
// Traps kept from the reference: a query pad row (code < 0) knocks out
// every substitution of that row but gaps still run through it; a target
// pad is a knocked-out column; in ragged mode every -1 column restarts the
// alignment (H = 0, E = F = -inf), which is what the reference's baked
// seg * 2^17 offsets amount to. Because gap_first >= gap_ext, the running
// E equals the reference's prefix max over H0. Rows past the query's last
// residue run as pad rows (they cannot raise a maximum).

#include <stdint.h>

#include <cuda_runtime.h>

namespace {

constexpr int kAlphabet = 24;
constexpr int kCodes = kAlphabet + 1;  // + the knocked-out code of pads
constexpr int kRB = 8;                 // query rows per thread
constexpr int kStrip = 32 * kRB;       // query rows per warp sweep
constexpr int kWarps = 8;              // warps per block
constexpr int kNeg = -(1 << 28);       // -inf for E / F (no int32 overflow)
constexpr int kNegSub = -(1 << 24);    // knocked-out substitution
constexpr int kMaxSegments = 63;

struct Params {
  const int* q;        // [G, Lq] query codes
  const int8_t* t;     // [G, K, Lt] target codes, one lane contiguous
  const int* blosum;   // [24, 24]
  int2* bound;         // [warps of the DP grid, Lt] strip boundary (H, F)
  int2* live;          // [G * K] (lane, its last residue + 1)
  int* counters;       // [0] live lanes, [1] lanes taken
  float* out;          // [G, S, K]
  int g, lq, lt, k, segments, gap_first, gap_ext;
};

// One warp per lane: zero its output slots, find its last residue, append
// it to the live list if it has one.
__global__ void __launch_bounds__(32 * kWarps) sw_lanes(const Params p) {
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const long long gk = (long long)blockIdx.x * kWarps + warp;
  if (gk >= (long long)p.g * p.k) return;
  const int g = (int)(gk / p.k), kk = (int)(gk % p.k);
  for (int s = lane; s < p.segments; s += 32)
    p.out[((size_t)g * p.segments + s) * p.k + kk] = 0.f;
  const int8_t* tl = p.t + (size_t)gk * p.lt;
  int last = 0;
  for (int j0 = (p.lt - 1) / 32 * 32; j0 >= 0; j0 -= 32) {
    const int j = j0 + lane;
    const unsigned m = __ballot_sync(0xffffffffu, j < p.lt && tl[j] >= 0);
    if (m) {
      last = j0 + 32 - __clz(m);
      break;
    }
  }
  if (lane == 0 && last > 0) {
    const int at = atomicAdd(&p.counters[0], 1);
    p.live[at] = make_int2((int)gk, last);
  }
}

__global__ void __launch_bounds__(32 * kWarps) sw_wavefront(const Params p) {
  __shared__ int sub[kCodes * kCodes];  // [target code][query code]
  __shared__ int seg_best[kWarps][kMaxSegments + 1];
  for (int i = threadIdx.x; i < kCodes * kCodes; i += blockDim.x) {
    const int tc = i / kCodes, qc = i % kCodes;
    sub[i] = (tc < kAlphabet && qc < kAlphabet) ? p.blosum[qc * kAlphabet + tc]
                                                : kNegSub;
  }
  __syncthreads();

  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  int2* bnd = p.bound + (size_t)(blockIdx.x * kWarps + warp) * p.lt;
  int* best_s = seg_best[warp];
  const bool ragged = p.segments > 1;
  const int gf = p.gap_first, ext = p.gap_ext;
  const int live_n = p.counters[0];

  for (;;) {
    int idx = 0;
    if (lane == 0) idx = atomicAdd(&p.counters[1], 1);
    idx = __shfl_sync(0xffffffffu, idx, 0);
    if (idx >= live_n) break;
    const int2 lv = p.live[idx];
    const int lt_eff = lv.y;
    const int g = lv.x / p.k, kk = lv.x % p.k;
    const int* qg = p.q + (size_t)g * p.lq;
    const int8_t* tl = p.t + (size_t)lv.x * p.lt;

    int lq_eff = 0;
    for (int i0 = (p.lq - 1) / 32 * 32; i0 >= 0; i0 -= 32) {
      const int i = i0 + lane;
      const unsigned m = __ballot_sync(0xffffffffu, i < p.lq && qg[i] >= 0);
      if (m) {
        lq_eff = i0 + 32 - __clz(m);
        break;
      }
    }
    if (lq_eff == 0) continue;  // no query residue: the zeros stand
    if (ragged) {
      for (int s = lane; s <= kMaxSegments; s += 32) best_s[s] = 0;
      __syncwarp();
    }

    int best = 0;
    for (int i0 = 0; i0 < lq_eff; i0 += kStrip) {
      const bool first = i0 == 0, more = i0 + kStrip < lq_eff;
      int qc[kRB], left[kRB], e[kRB];
#pragma unroll
      for (int r = 0; r < kRB; ++r) {
        const int i = i0 + lane * kRB + r;
        const int c = i < lq_eff ? qg[i] : -1;
        qc[r] = c < 0 ? kAlphabet : min(c, kAlphabet - 1);
        left[r] = 0;
        e[r] = kNeg;
      }
      // what this thread passes down: (H, F) of its last row and the
      // column's target code
      int h_out = 0, f_out = kNeg, tc_out = -1;
      int diag = 0;  // H of the row above the first row, previous column
      int run = 0, seg = 0;
      // column 32c + lane's target code and strip boundary (H, F), for the
      // current chunk c and the next (the top strip's boundary is (0, -inf))
      auto code_at = [&](int j) { return j < lt_eff ? (int)tl[j] : -1; };
      auto bound_at = [&](int j) {
        return !first && j < lt_eff ? bnd[j] : make_int2(0, kNeg);
      };
      int code = code_at(lane), code_next = code_at(32 + lane);
      int2 b = bound_at(lane), b_next = bound_at(32 + lane);
      const int steps = lt_eff + 31;
      for (int s = 0; s < steps; ++s) {
        if ((s & 31) == 0 && s > 0) {
          code = code_next;
          b = b_next;
          code_next = code_at(s + 32 + lane);
          b_next = bound_at(s + 32 + lane);
        }
        const int c0 = __shfl_sync(0xffffffffu, code, s & 31);
        const int h0 = __shfl_sync(0xffffffffu, b.x, s & 31);
        const int f0 = __shfl_sync(0xffffffffu, b.y, s & 31);
        int hu = __shfl_up_sync(0xffffffffu, h_out, 1);
        int fu = __shfl_up_sync(0xffffffffu, f_out, 1);
        int tc = __shfl_up_sync(0xffffffffu, tc_out, 1);
        const int j = s - lane;
        if (j < 0 || j >= lt_eff) continue;
        if (lane == 0) {
          tc = c0;
          hu = h0;
          fu = f0;
        }
        if (ragged && tc < 0) {
          // separator: close the segment, restart the alignment after it
          if (seg < p.segments) atomicMax(&best_s[seg], run);
          seg = min(seg + 1, kMaxSegments);
          run = 0;
#pragma unroll
          for (int r = 0; r < kRB; ++r) {
            left[r] = 0;
            e[r] = kNeg;
          }
          diag = 0;
          h_out = 0;
          f_out = kNeg;
        } else {
          const int* col =
              sub + (tc < 0 ? kAlphabet : min(tc, kAlphabet - 1)) * kCodes;
          int h = hu, f = fu, dg = diag;
#pragma unroll
          for (int r = 0; r < kRB; ++r) {
            f = __viaddmax_s32(h, -gf, f - ext);
            e[r] = __viaddmax_s32(left[r], -gf, e[r] - ext);
            h = __vimax3_s32_relu(dg + col[qc[r]], f, e[r]);
            dg = left[r];
            left[r] = h;
            run = __vimax_s32_relu(run, h);
          }
          diag = hu;
          h_out = h;
          f_out = f;
        }
        tc_out = tc;
        if (lane == 31 && more) bnd[j] = make_int2(h_out, f_out);
      }
      if (ragged) {
        if (seg < p.segments) atomicMax(&best_s[seg], run);
      } else {
        best = max(best, run);
      }
      __syncwarp();  // thread 31's boundary stores before thread 0's loads
    }

    float* og = p.out + (size_t)g * p.segments * p.k + kk;
    if (ragged) {
      __syncwarp();
      for (int s = lane; s < p.segments; s += 32)
        og[(size_t)s * p.k] = (float)best_s[s];
      __syncwarp();
    } else {
      best = __reduce_max_sync(0xffffffffu, best);
      if (lane == 0) og[0] = (float)best;
    }
  }
}

// blocks of the persistent DP grid for `lanes` lanes: as many as fit on
// the card at once, at most one warp per lane
int dp_blocks(long long lanes) {
  static int resident = 0;
  if (resident == 0) {
    int dev = 0, sms = 0, per_sm = 0;
    if (cudaGetDevice(&dev) != cudaSuccess ||
        cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev) !=
            cudaSuccess ||
        cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, sw_wavefront,
                                                      32 * kWarps, 0) !=
            cudaSuccess)
      return -1;
    resident = sms * per_sm;
  }
  const long long need = (lanes + kWarps - 1) / kWarps;
  return (int)(need < resident ? need : resident);
}

}  // namespace

// Warps of the DP grid for g * k lanes (the rows of the strip-boundary
// scratch the caller allocates), or -1 if the card cannot be queried.
extern "C" int knn_sw_grouped_warps(int g, int k) {
  const int blocks = dp_blocks((long long)g * k);
  return blocks < 0 ? -1 : blocks * kWarps;
}

// q [g, lq] int32 codes, t [g, k, lt] int8 codes (one lane contiguous),
// blosum [24, 24] int32; scratch: bound [knn_sw_grouped_warps(g, k), lt]
// int2, live [g * k] int2, counters [2] int32 zeroed by the caller; out
// [g, segments, k] float32.
extern "C" int knn_sw_grouped(const int* q, const int8_t* t, const int* blosum,
                              int2* bound, int2* live, int* counters,
                              float* out, int g, int lq, int lt, int n_lanes,
                              int segments, int gap_first, int gap_ext,
                              cudaStream_t stream) {
  const long long lanes = (long long)g * n_lanes;
  if (g < 1 || lq < 1 || lt < 1 || n_lanes < 1 || lanes >= (1ll << 31) ||
      segments < 1 || segments > kMaxSegments || gap_first < gap_ext ||
      gap_ext < 0)
    return (int)cudaErrorInvalidValue;
  const int blocks = dp_blocks(lanes);
  if (blocks < 0) return (int)cudaErrorInvalidValue;
  const Params p{q, t, blosum, bound, live, counters, out,
                 g, lq, lt, n_lanes, segments, gap_first, gap_ext};
  sw_lanes<<<(unsigned)((lanes + kWarps - 1) / kWarps), 32 * kWarps, 0,
             stream>>>(p);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  sw_wavefront<<<blocks, 32 * kWarps, 0, stream>>>(p);
  return (int)cudaGetLastError();
}
