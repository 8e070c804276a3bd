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
// What bounds it here: memory latency and bandwidth of the DP row state,
// not arithmetic (about ten integer ops per cell). The TPU kernel kept the
// whole [Lt, K] state plus a [24, Lt, K] substitution profile in VMEM and
// resolved the horizontal gap E with a log-depth prefix max per row. On
// the card one thread owns one (group, lane) and sweeps the target axis
// sequentially, so E is a register carried along j (classic Gotoh; equal
// to the reference's prefix max because gap_first >= gap_ext), and the
// substitution is a lookup into BLOSUM62 in shared memory: no profile. The
// row state (H, F) of each lane lives in a [G, Lt, K] int2 scratch, where
// neighbouring threads touch neighbouring addresses; each sweep advances
// RB = 8 query rows at once in registers, so the state is read and written
// once per 8 DP rows. Trailing pad rows and columns cannot raise a score
// and are skipped.
//
// Traps kept from the reference: a query pad row (code < 0) knocks out
// every substitution of that row but gaps still run through it; a target
// pad is a knocked-out column; in ragged mode every -1 column restarts the
// alignment (H = 0, E = F = -inf), which is what the reference's baked
// seg * 2^17 offsets amount to.

#include <stdint.h>

#include <cuda_runtime.h>

namespace {

constexpr int kAlphabet = 24;
constexpr int kRB = 8;                 // query rows per sweep
constexpr int kNeg = -(1 << 28);       // -inf for E / F (no int32 overflow)
constexpr int kNegSub = -(1 << 24);    // knocked-out substitution
constexpr int kMaxSegments = 63;

__global__ void __launch_bounds__(32)
sw_grouped(const int* __restrict__ q, const int8_t* __restrict__ t,
           const int* __restrict__ blosum, int2* __restrict__ state,
           float* __restrict__ out, int lq, int lt, int n_lanes, int segments,
           int gap_first, int gap_ext) {
  __shared__ int sb[kAlphabet * kAlphabet];
  for (int i = threadIdx.x; i < kAlphabet * kAlphabet; i += blockDim.x)
    sb[i] = blosum[i];
  __syncthreads();

  const int g = blockIdx.y;
  const int lane = blockIdx.x * blockDim.x + threadIdx.x;
  if (lane >= n_lanes) return;
  const int* qg = q + (size_t)g * lq;
  const int8_t* tg = t + (size_t)g * lt * n_lanes + lane;  // col j: tg[j*K]
  int2* st = state + (size_t)g * lt * n_lanes + lane;
  float* og = out + (size_t)g * segments * n_lanes + lane;  // slot s: og[s*K]
  const bool ragged = segments > 1;

  for (int s = 0; s < segments; ++s) og[(size_t)s * n_lanes] = 0.f;
  int lt_eff = 0, lq_eff = 0;
  for (int j = 0; j < lt; ++j)
    if (tg[(size_t)j * n_lanes] >= 0) lt_eff = j + 1;
  for (int i = 0; i < lq; ++i)
    if (qg[i] >= 0) lq_eff = i + 1;
  if (lt_eff == 0 || lq_eff == 0) return;
  for (int j = 0; j < lt_eff; ++j) st[(size_t)j * n_lanes] = make_int2(0, kNeg);

  int best = 0;
  for (int i0 = 0; i0 < lq_eff; i0 += kRB) {
    int qrow[kRB], diag[kRB], left[kRB], e[kRB];
#pragma unroll
    for (int r = 0; r < kRB; ++r) {
      const int qi = (i0 + r < lq) ? qg[i0 + r] : -1;
      qrow[r] = qi < 0 ? -1 : min(qi, kAlphabet - 1) * kAlphabet;
      diag[r] = 0;
      left[r] = kNeg;
      e[r] = kNeg;
    }
    int run = 0, seg = 0;
    for (int j = 0; j < lt_eff; ++j) {
      const int tj = tg[(size_t)j * n_lanes];
      const int2 up = st[(size_t)j * n_lanes];
      if (ragged && tj < 0) {
        // separator: close this segment, restart alignments after it
        if (seg < segments)
          og[(size_t)seg * n_lanes] = fmaxf(og[(size_t)seg * n_lanes], (float)run);
        seg = min(seg + 1, kMaxSegments);
        run = 0;
#pragma unroll
        for (int r = 0; r < kRB; ++r) {
          diag[r] = 0;
          left[r] = 0;
          e[r] = kNeg;
        }
        st[(size_t)j * n_lanes] = make_int2(0, kNeg);
        continue;
      }
      const int tcode = max(min(tj, kAlphabet - 1), 0);
      int hu = up.x, fu = up.y;  // H, F of the row above, this column
#pragma unroll
      for (int r = 0; r < kRB; ++r) {
        const int sub = (qrow[r] < 0 || tj < 0) ? kNegSub : sb[qrow[r] + tcode];
        const int f = max(hu - gap_first, fu - gap_ext);
        const int h0 = max(max(diag[r] + sub, f), 0);
        e[r] = max(left[r] - gap_first, e[r] - gap_ext);
        const int h = max(h0, e[r]);
        diag[r] = hu;
        left[r] = h;
        run = max(run, h);
        hu = h;
        fu = f;
      }
      st[(size_t)j * n_lanes] = make_int2(hu, fu);
    }
    if (ragged) {
      if (seg < segments)
        og[(size_t)seg * n_lanes] = fmaxf(og[(size_t)seg * n_lanes], (float)run);
    } else {
      best = max(best, run);
    }
  }
  if (!ragged) og[0] = (float)best;
}

}  // namespace

extern "C" int knn_sw_grouped(const int* q, const int8_t* t, const int* blosum,
                              int2* state, float* out, int g, int lq, int lt,
                              int n_lanes, int segments, int gap_first,
                              int gap_ext, cudaStream_t stream) {
  if (g < 1 || g > 65535 || lq < 1 || lt < 1 || n_lanes < 1 || segments < 1 ||
      segments > kMaxSegments)
    return (int)cudaErrorInvalidValue;
  const dim3 grid((n_lanes + 31) / 32, g);
  sw_grouped<<<grid, 32, 0, stream>>>(q, t, blosum, state, out, lq, lt, n_lanes,
                                      segments, gap_first, gap_ext);
  return (int)cudaGetLastError();
}
