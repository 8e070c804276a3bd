"""Kernel B: exact large-k top-k via segment-top-R candidates
(csrc/segment_topr.cu). Port of the exact native part of
knn_for_homology_tpu/ops/exact_pallas.py (`exact_pallas_topk`).

Column c of the database belongs to segment (lane) c mod W. The kernel keeps
each segment's R best similarities per query; a two-key sort over the
[Q, R·W] candidate buffer gives the top-k. Certificate: a row can only miss
a true top-k element if some segment discarded one, and every discard is ≤
that segment's R-th kept value — so a row whose R-th kept values all fall
below its k-th value is provably exact. Flagged rows are re-run at 2R, and
by a full plain sort once R ≥ 32: exactness is unconditional.

A CUDA tensor goes to the kernel; a CPU tensor to `segment_topr_plain`,
which builds the same buffer in plain PyTorch. The epilogue is PyTorch on
either device, as it was XLA outside the Pallas kernel.

The planner (`plan`, `plan_fingerprint`) also sizes the packed approx
kernels of ops/packed_cuda.py: R from the recall target (`r_for_recall`)
instead of the certificate's bound. W and R decide which ids survive, so
they follow the reference's `_plan` rules exactly.
"""

import math
from typing import Tuple

import torch

from . import _build
from .distance import check_search_inputs, similarity_block
from .topk import NEG_INF, oneshot_topk, pad_k

INT32_MIN = -(2**31)

# Bound on the [QB, R·W] candidate buffers (int32 value + int32 pass index)
# per query block; the epilogue's int64 sort keys add as much again.
CANDIDATE_BYTES = 1 << 30

# queries per CUDA block of kernel B (csrc/segment_topr.cu: BM), of
# kernels D/E at every R (csrc/segment_packed.cu: BM = 16 * TM) and of the
# sym storages' kernel F (one wgmma warpgroup, sym::BM)
SEGMENT_TOPR_QUERIES = 32
SEGMENT_PACKED_QUERIES = 32
SYM_PACKED_QUERIES = 64


def _ordered_int(u: torch.Tensor) -> torch.Tensor:
    """Monotone float32-bits -> int32 map (an involution): the int32 order
    of the result equals the float order of the input bits."""
    return u ^ ((u >> 31) & 0x7FFFFFFF)


def _poisson_tail(lam: float, r: int) -> float:
    """P(X >= r) for X ~ Poisson(lam)."""
    cdf = 0.0
    term = math.exp(-lam)
    for x in range(0, r):
        cdf += term
        term = term * lam / (x + 1)
    return max(0.0, 1.0 - cdf)


def r_for_exact(k: int, db_tile: int, per_row_target: float = 3e-3) -> int:
    """Smallest per-segment slot count R whose expected certificate-failure
    rate stays under `per_row_target`: a row flags iff some segment holds
    ≥ R of its top-k, segments fill ~Poisson(k/W), and there are W of them."""
    lam = max(k / db_tile, 1e-9)
    for r in range(max(2, int(lam) + 1), 65):
        if _poisson_tail(lam, r) * db_tile <= per_row_target:
            return r
    return 64


def r_for_recall(k: int, db_tile: int, recall_target: float) -> int:
    """Smallest per-segment slot count R whose expected element loss meets
    the recall target (the approx regime). Top-k elements land in segments
    ~Poisson(λ = k/W); a segment drops E[(X-R)+] of them, so the missed
    fraction is E[(X-R)+]/λ."""
    lam = max(k / db_tile, 1e-9)
    for r in range(1, 65):
        loss = sum(
            (x - r) * math.exp(-lam) * lam**x / math.factorial(x)
            for x in range(r + 1, r + 40)
        )
        if loss / lam <= (1.0 - recall_target):
            return r
    return 64


def default_db_tile(k_eff: int, n: int = None, exact: bool = True) -> int:
    """Segment count W the entry points start from (the db_tile half of the
    reference's default_plan_inputs). Exact: narrow segments for large k.
    Approx: 256, widened for n > 2^20 so the packed pass-index field leaves
    the value enough bits."""
    if exact:
        return 256 if k_eff >= 128 else 1024
    return max(256, _round_up(n // 4096, 128) if n > 2**20 else 256)


def _round_up(x: int, m: int) -> int:
    return ((x + m - 1) // m) * m


def plan(n: int, k_eff: int, db_tile: int, r_slots: int = None,
         exact_row_target: float = 3e-3, exact: bool = True,
         recall_target: float = 0.95) -> Tuple[int, int]:
    """(W, R) for a search: the reference planner's rules, which decide the
    surviving ids. Exact: R·W candidates must cover k with headroom, and
    the striding argument needs W ~ k, so R grows until R·W ≥ max(2k, k+W)
    — correctness-relevant: the certificate assumes it. Approx: R from the
    recall target (`r_slots` is ignored, as in the reference), grown until
    R·W ≥ k."""
    db_tile = min(db_tile, max(128, _round_up(n, 128)))
    if not exact:
        r_slots = r_for_recall(k_eff, db_tile, recall_target)
    elif r_slots is None:
        r_slots = r_for_exact(k_eff, db_tile, exact_row_target)
    need = max(2 * k_eff, k_eff + db_tile) if exact else k_eff
    while r_slots * db_tile < need:
        r_slots *= 2
    return db_tile, r_slots


def plan_fingerprint(
    n: int, d: int, k: int, exact: bool = False, storage: str = "native",
    recall_target: float = 0.95, itemsize: int = 2,
) -> dict:
    """The kernel shape the public entry points would pick, for the bench
    JSON (port of the reference's plan_fingerprint). W and R equal the
    reference's for every input. `query_block` is this port's own: the
    queries one CUDA block of the kernel owns (the reference reported its
    VMEM query block there, which does not change results). `d` and
    `itemsize` sized only that VMEM block, so they are unused here."""
    del d, itemsize
    k_eff = min(k, n)
    db_tile, r_slots = plan(
        n, k_eff, default_db_tile(k_eff, n, exact), exact=exact,
        recall_target=recall_target,
    )
    return {
        "db_tile": db_tile,
        "query_block": SEGMENT_TOPR_QUERIES if exact
        else SYM_PACKED_QUERIES if storage in ("sq8-sym", "sq8-sym2")
        else SEGMENT_PACKED_QUERIES,
        "r_slots": r_slots,
        "storage": storage,
    }


def segment_topr_plain(
    db: torch.Tensor, queries: torch.Tensor, db_tile: int, r_slots: int,
    metric: str = "cosine",
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain PyTorch version of the kernel: the same (buf_v, buf_i)
    [Q, R·W] int32 buffers (ordered-int values, pass indices)."""
    n = db.shape[0]
    q_n = queries.shape[0]
    w, r = db_tile, r_slots
    passes = -(-n // w)
    sims = similarity_block(queries, db, metric)
    oi = _ordered_int(sims.view(torch.int32))
    full = oi.new_full((q_n, passes * w), INT32_MIN)
    full[:, :n] = oi
    # [Q, W, P]: a stable descending sort over passes keeps the earlier
    # pass first on ties, like the kernel's strict `>`
    per_lane = full.view(q_n, passes, w).transpose(1, 2)
    vals, pass_idx = torch.sort(per_lane, dim=2, descending=True, stable=True)
    vals, pass_idx = vals[:, :, :r], pass_idx[:, :, :r].to(torch.int32)
    if passes < r:
        fill = r - passes
        vals = torch.cat([vals, vals.new_full((q_n, w, fill), INT32_MIN)], 2)
        pass_idx = torch.cat(
            [pass_idx, pass_idx.new_full((q_n, w, fill), -1)], 2
        )
    # masked columns never enter a slot: their slots stay empty
    pass_idx = torch.where(vals == INT32_MIN, -1, pass_idx)
    buf_v = vals.transpose(1, 2).reshape(q_n, r * w).contiguous()
    buf_i = pass_idx.transpose(1, 2).reshape(q_n, r * w).contiguous()
    return buf_v, buf_i


def segment_topr_kernel(
    db: torch.Tensor, queries: torch.Tensor, db_tile: int, r_slots: int,
    metric: str = "cosine",
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Per-segment top-R candidate buffers (buf_v, buf_i), [Q, R·W] int32
    each: slot r of lane w at column r·W + w, values as ordered int32,
    ids as pass indices, empty slots INT32_MIN / -1."""
    check_search_inputs(db, queries, metric)
    if db_tile % 64 or r_slots < 1:
        raise ValueError(f"need W % 64 == 0 and R ≥ 1, got {db_tile}, {r_slots}")
    if db.device.type == "cpu":
        return segment_topr_plain(db, queries, db_tile, r_slots, metric)
    n, d = db.shape
    q_n = queries.shape[0]
    buf_v = torch.empty((q_n, r_slots * db_tile), dtype=torch.int32,
                        device=db.device)
    buf_i = torch.empty_like(buf_v)
    code = _build.library().knn_segment_topr(
        queries.data_ptr(), db.data_ptr(), buf_v.data_ptr(), buf_i.data_ptr(),
        q_n, n, d, db_tile, r_slots, int(metric == "l2"),
        _build.stream_ptr(db.device),
    )
    _build.check(code, "knn_segment_topr")
    segment_topr_kernel.launches += 1
    return buf_v, buf_i


segment_topr_kernel.launches = 0


def epilogue(
    buf_v: torch.Tensor, buf_i: torch.Tensor, k: int, db_tile: int,
    r_slots: int,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Candidate buffers -> (vals [Q,k] f32, ids [Q,k] int32, suspect [Q]).

    Order is value descending, id ascending: one int64 key per slot, high
    word ~value (so empty INT32_MIN slots sort last), low word id+1 —
    unique per candidate, so the selection has no ties to break."""
    width = r_slots * db_tile
    lanes = torch.arange(width, device=buf_v.device) % db_tile
    gids = torch.where(buf_i >= 0, buf_i.to(torch.int64) * db_tile + lanes, -1)
    key = torch.bitwise_not(buf_v).to(torch.int64) * (1 << 32) + (gids + 1)
    sel, _ = torch.topk(key, k, dim=1, largest=False, sorted=True)
    kept_oi = torch.bitwise_not(sel >> 32).to(torch.int32)
    ids = ((sel & 0xFFFFFFFF) - 1).to(torch.int32)
    vals = torch.where(
        ids >= 0, _ordered_int(kept_oi).view(torch.float32), NEG_INF
    )
    theta = vals[:, k - 1]
    min_kept = buf_v[:, (r_slots - 1) * db_tile :]
    suspect = torch.any(min_kept >= kept_oi[:, k - 1 : k], dim=1) & torch.isfinite(
        theta
    )
    return vals, ids, suspect


def candidates_and_topk(
    db: torch.Tensor, queries: torch.Tensor, k: int, r_slots: int,
    metric: str, db_tile: int,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Kernel (or its plain version) + epilogue for one query block."""
    buf_v, buf_i = segment_topr_kernel(db, queries, db_tile, r_slots, metric)
    return epilogue(buf_v, buf_i, k, db_tile, r_slots)


def exact_topk(
    db: torch.Tensor,
    queries: torch.Tensor,
    k: int,
    metric: str = "cosine",
    db_tile: int = None,
    r_slots: int = None,
    exact: bool = True,
    recall_target: float = 0.95,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Exact top-k over the whole database (the large-k path). Returns
    (sims [Q, k] descending, ids [Q, k] int32) in the internal convention;
    ids equal a full stable sort's, k > N pads with (-inf, -1).

    `exact=False` goes to the packed approx kernels (ops/packed_cuda.py) at
    `recall_target`, as the reference's exact_pallas_topk does."""
    if not exact:
        from .packed_cuda import packed_topk

        return packed_topk(
            db, queries, k, metric=metric, db_tile=db_tile,
            recall_target=recall_target,
        )
    n = db.shape[0]
    q_n = queries.shape[0]
    if q_n == 0:
        return (
            queries.new_zeros((0, k)),
            torch.zeros((0, k), dtype=torch.int32, device=queries.device),
        )
    k_eff = min(k, n)
    if db_tile is None:
        db_tile = default_db_tile(k_eff)
    db_tile, r_slots = plan(n, k_eff, db_tile, r_slots)
    max_block = max(32, CANDIDATE_BYTES // (r_slots * db_tile * 8))
    parts = [
        candidates_and_topk(
            db, queries[s : s + max_block], k_eff, r_slots, metric, db_tile
        )
        for s in range(0, q_n, max_block)
    ]
    vals = torch.cat([p[0] for p in parts], 0)
    ids = torch.cat([p[1] for p in parts], 0)
    suspect = torch.cat([p[2] for p in parts], 0)

    # one host read for the whole call
    flagged = torch.nonzero(suspect).flatten()
    if flagged.numel():
        sub = queries[flagged]
        if r_slots < 32:
            f_vals, f_ids = exact_topk(
                db, sub, k_eff, metric=metric, db_tile=db_tile,
                r_slots=2 * r_slots,
            )
        else:
            f_vals, f_ids = oneshot_topk(db, sub, k_eff, metric=metric)
        vals[flagged] = f_vals
        ids[flagged] = f_ids
    return pad_k(vals, ids, k)
