"""IVF (inverted-file) ANN index (port of knn_for_homology_tpu/search/ivf.py).

Plays the role of FAISS IndexHNSWFlat in the reference
(pfam/proteins_search.py:30-49: M=42, efSearch=256, k=1000): one routing
product (queries x centroids) followed by contiguous-slab scoring. Clusters
hold at most 128 members, so a cluster IS a slab of ops/slab_cuda.py's
layout (node = cluster, neighbours = members): int8 rows, per-row scales,
member ids.

Two candidate paths share the layout:
  * per-probe (`_dma_block_one`): each query's own nprobe slabs through
    kernel K (ops/slab_cuda.beam_expand), for blocks below UNION_MIN_Q;
  * union scan (`_union_scan_one`): a block's queries scan the UNION of the
    cells they probe, ip / cosine through kernel J (ops/ivf_cuda.py, no
    gather), l2 through a gathered bf16 buffer with a bias lane and kernel D
    (ops/exact_cuda.exact_topk(exact=False)).
Small k (≤ RESCORE_MAX_K) rescores the shortlist in fp32, from the stored
rows or, in the lean layout (store_fp32=False), from the dequantised slabs.

Which ids come back is the reference's: the same constants, the same plan,
the same tie rules (`lax.top_k`'s lower-index-first is a stable sort here).
The reference's jit-time constructs are plain loops: its stacked scans over
blocks (which saved dispatches through a device relay) and k-means'
fori_loop. Its approximate routing (`approx_max_k`, the TPU's PartialReduce,
which it turned off off the TPU) is not ported: routing is exact. The
device is explicit (`device`, "cuda" by default).
"""

import logging
from collections import Counter
from typing import Optional, Tuple

import numpy as np
import torch

from ..device import resolve_device
from ..ops import ivf_cuda, slab_cuda
from ..ops.distance import finalize_scores, l2_normalize
from ..ops.topk import NEG_INF, stable_topk

logger = logging.getLogger(__name__)

CAPACITY = slab_cuda.LANE  # cluster capacity == the slab layout's 128 lanes

# [rows, C] routing block of _route_prefs: 2^26 similarities (256 MiB fp32,
# about 1 GiB with the stable sort's values and int64 indices), a small
# transient beside an index on the 80 GB card
_ROUTE_BLOCK_SIMS = 1 << 26

_BIAS_BIG = 3.0e4  # pad-row knockout; |real scores| << this at any metric

# _union_rescore_matmul's [budget*128, d] fp32 union rows and [qb,
# budget*128] score matrix, in bytes: each transient stays at 2 GiB on the
# 80 GB card; above either the rescore takes the per-(query, candidate)
# row gather, chunked over query sub-blocks
_MATMUL_RESCORE_BUF_MAX = 1 << 31
_MATMUL_RESCORE_SCORES_MAX = 1 << 31

# per-chunk transient of the row-gather rescores (_map_rescore), sized for
# the 80 GB card: 2 GiB beside the index and the candidate buffers
_RESCORE_CHUNK_BYTES = 2 << 30


def _route_sims(queries, centroids, metric):
    """[Q, C] bigger-is-better routing similarities: bf16 operands, fp32
    sums. The bf16 values are widened before the product: a bf16 matmul
    would round every routing score to bf16."""
    q = queries.to(torch.bfloat16).to(torch.float32)
    c = centroids.to(torch.bfloat16).to(torch.float32)
    dots = q @ c.T
    if metric == "l2":
        c32 = centroids.to(torch.float32)
        c_sq = torch.sum(c32 * c32, dim=-1)
        return 2.0 * dots - c_sq[None, :]
    return dots


def _route_topk(sims, nprobe: int):
    """Top-nprobe cells per row, lower cell id first on equal scores."""
    return stable_topk(sims, nprobe)[1]


def _route_prefs(db, centroids, metric, p):
    """[N, p] ranked nearest-centroid preferences, in row blocks so the
    [rows, C] similarity transient stays bounded."""
    c = centroids.shape[0]
    block = max(256, _ROUTE_BLOCK_SIMS // max(c, 1))
    return torch.cat([
        _route_topk(_route_sims(db[s : s + block], centroids, metric), p)
        for s in range(0, db.shape[0], block)
    ])


def _segment_sums(v, assign, c: int):
    """([C, d] sums, [C] counts) of the rows of each cluster, as products
    of one-hot row blocks with the rows: a scatter-add (index_add_) adds in
    an order that changes from run to run on the card, and the build would
    follow it. Blocks of 2^28 one-hot entries (1 GiB) bound the transient."""
    n = v.shape[0]
    block = max(1, (1 << 28) // max(c, 1))
    sums = v.new_zeros((c, v.shape[1]))
    counts = v.new_zeros((c,))
    for s in range(0, n, block):
        part = assign[s : s + block]
        onehot = v.new_zeros((c, part.shape[0]))
        onehot[part, torch.arange(part.shape[0], device=v.device)] = 1.0
        sums += onehot @ v[s : s + block]
        counts += onehot.sum(dim=1)
    return sums, counts


def _kmeans_step(v, centroids, metric: str, reseed: bool):
    """One Lloyd iteration: assignment product + segment-sum update, then
    (reseed=True) every empty cluster is re-seeded at a poorly covered row:
    rows whose best-centroid similarity is lowest mark structure no cell
    covers yet."""
    n = v.shape[0]
    c = centroids.shape[0]
    dots = v @ centroids.T
    if metric == "l2":
        c_sq = torch.sum(centroids * centroids, dim=-1)
        dots = 2.0 * dots - c_sq[None, :]
    best, assign = torch.max(dots, dim=-1)  # first index among equal maxima
    sums, counts = _segment_sums(v, assign, c)
    fresh = sums / torch.clamp(counts, min=1.0)[:, None]
    if metric == "cosine":
        fresh = l2_normalize(fresh)
    centroids = torch.where((counts > 0)[:, None], fresh, centroids)
    if reseed:
        k_cand = min(c, n)
        worst = stable_topk(-best[None, :], k_cand)[1][0]
        empty = counts <= 0
        n_empty = torch.sum(empty.to(torch.int64))
        # spread the picks across the worst-row list: consecutive worst rows
        # are usually members of the SAME uncovered cluster
        rank = torch.cumsum(empty.to(torch.int64), 0) - 1
        stride = torch.clamp(
            torch.div(k_cand, torch.clamp(n_empty, min=1), rounding_mode="floor"),
            min=1,
        )
        pick = torch.clamp(rank * stride, 0, k_cand - 1)
        centroids = torch.where(empty[:, None], v[worst[pick]], centroids)
    return centroids, counts


def _kmeans(v, n_clusters: int, iters: int, metric: str):
    """Lloyd refinement of a strided init, reseeding empty clusters at every
    step but the last (so the returned centroids' assignment is consistent
    with their final update)."""
    step = max(v.shape[0] // n_clusters, 1)
    centroids = v[::step][:n_clusters].clone()
    if iters <= 0:
        return centroids
    for _ in range(iters - 1):
        centroids = _kmeans_step(v, centroids, metric, reseed=True)[0]
    return _kmeans_step(v, centroids, metric, reseed=False)[0]


def _balanced_members(order2, n_clusters: int, capacity: int):
    """[C, capacity] member ids (-1 padded) from each row's ranked cluster
    preferences `order2` [N, P]: pass p assigns every still-free row to its
    rank-p cluster if space remains (row-id order breaks ties), then
    leftovers spill into the globally free slots. Every row is stored
    exactly once."""
    n, p_max = order2.shape
    c = n_clusters
    dev = order2.device
    rows = torch.arange(n, dtype=torch.int64, device=dev)
    assigned = torch.full((n,), -1, dtype=torch.int64, device=dev)
    counts = torch.zeros((c,), dtype=torch.int64, device=dev)
    # flat member table + one overflow slot that absorbs masked writes
    members_flat = torch.full((c * capacity + 1,), -1, dtype=torch.int64,
                              device=dev)
    zero = counts.new_zeros((1,))
    for p in range(p_max):
        free = assigned < 0
        want = torch.where(free, order2[:, p].to(torch.int64), c)
        perm = torch.argsort(want, stable=True)  # groups by cluster, row order
        want_s = want[perm]
        grp_start = torch.searchsorted(want_s, want_s)  # side="left"
        rank = rows - grp_start  # position within the contender group
        counts_ext = torch.cat([counts, zero])
        space_s = torch.where(want_s == c, 0, capacity - counts_ext[want_s])
        take = rank < space_s
        slot = counts_ext[torch.clamp(want_s, max=c - 1)] + rank
        idx = torch.where(take, want_s * capacity + slot, c * capacity)
        members_flat[idx] = torch.where(take, perm, -1)
        assigned[perm] = torch.where(take, want_s, assigned[perm])
        counts = counts + torch.bincount(
            torch.where(take, want_s, c), minlength=c + 1
        )[:c]

    # spill: r-th leftover row (row order) -> r-th globally free slot
    left = assigned < 0
    spill_rank = torch.cumsum(left.to(torch.int64), 0) - 1
    cum = torch.cumsum(capacity - counts, 0)
    cl = torch.clamp(torch.searchsorted(cum, spill_rank, right=True), 0, c - 1)
    prev = torch.where(cl > 0, cum[torch.clamp(cl - 1, min=0)], 0)
    slot = spill_rank - prev + counts[cl]
    ok = left & (spill_rank < cum[c - 1])
    idx = torch.where(ok, cl * capacity + slot, c * capacity)
    members_flat[idx] = torch.where(ok, rows, -1)
    return members_flat[: c * capacity].view(c, capacity).to(torch.int32)


def _probed_cells(sel, c: int, pad: int = 0):
    """[C] count of the block's queries probing each cell. The reference
    fills a short block up to its full size with copies of its last query;
    `pad` counts those copies, whose probes raise the counts (and so the
    order of the scanned cells) without being scanned here."""
    counts = torch.bincount(sel.reshape(-1), minlength=c)
    if pad:
        counts = counts + pad * torch.bincount(sel[-1], minlength=c)
    return counts


def _block_union_counts(q_blocks, centroids, metric: str, nprobe: int):
    """([B] distinct-probed-cell counts, [B] probe selections [qb, nprobe])
    of the query blocks: one host read sizes every block's budget, and the
    scan reuses the selections instead of routing again."""
    c = centroids.shape[0]
    sels = [
        _route_topk(_route_sims(q, centroids, metric), nprobe)
        for q in q_blocks
    ]
    counts = torch.stack(
        [torch.count_nonzero(_probed_cells(sel, c)) for sel in sels]
    )
    return counts, sels


def _gather_bias_buffer(pv, pi, sc, row_sq, cells_sel, metric: str):
    """The selected cells' int8 slabs as one dequantised bf16 buffer with a
    BIAS LANE appended (lane d = 0 for real rows, -_BIAS_BIG for
    capacity-padding rows; queries carry 1.0 there), so pad rows never
    reach the top-k. The lane block is 128 wide, as in the reference. For
    l2 the rows are doubled and the bias lane carries -|row|^2, making the
    raw dot 2qd - |row|^2 (the -|q|^2 term is added by the caller)."""
    c_total, lane = pi.shape
    d = pv.shape[1]
    idx = cells_sel.long()
    budget = idx.shape[0]
    gids = pi[idx].reshape(-1)  # [B*lane]
    rows8 = pv.view(c_total, lane, d)[idx].reshape(-1, d)
    scales = sc[idx].reshape(-1)
    rows = rows8.to(torch.bfloat16) * scales[:, None].to(torch.bfloat16)
    if metric == "l2":
        rows = 2.0 * rows
        content = -row_sq[idx].reshape(-1)
    else:
        content = torch.zeros((budget * lane,), device=pv.device)
    bias = torch.where(gids >= 0, content, -_BIAS_BIG).to(torch.bfloat16)
    pad = torch.zeros((budget * lane, 127), dtype=torch.bfloat16,
                      device=pv.device)
    return torch.cat([rows, bias[:, None], pad], dim=1), gids


def _rows_dot(rows, q):
    """[q, k] dots of rows [q, k, d] with their query q [q, d]."""
    return torch.bmm(rows, q[:, :, None])[..., 0]


def _exact_rescore_rows(db, q, ids, metric: str):
    """fp32 re-scoring of final candidates from the stored rows."""
    safe = torch.clamp(ids.long(), 0, db.shape[0] - 1)
    rows = db[safe]  # [q, k, d]
    s = _rows_dot(rows, q)
    if metric == "l2":
        r_sq = torch.sum(rows * rows, dim=-1)
        q_sq = torch.sum(q * q, dim=-1)
        s = 2.0 * s - r_sq - q_sq[:, None]
    return torch.where(ids >= 0, s, NEG_INF)


def _slab_rescore_rows(pv, sc, row_sq, slot, q, ids, metric: str):
    """fp32 re-scoring of final candidates from the DEQUANTISED int8 slabs
    (the lean layout's _exact_rescore_rows): the scan's compute noise goes,
    the storage quantisation stays."""
    safe = torch.clamp(ids.long(), 0, slot.shape[0] - 1)
    srows = slot[safe].long()  # [q, k] packed slot index
    # slabs are lane-padded to a 128 multiple at pack time; slice back
    rows = pv[srows][..., : q.shape[1]].to(torch.float32) * (
        sc.reshape(-1)[srows][..., None]
    )
    s = _rows_dot(rows, q)
    if metric == "l2":
        # the exact fp32 row norms survive the lean build
        s = (
            2.0 * s
            - row_sq.reshape(-1)[srows]
            - torch.sum(q * q, dim=-1)[:, None]
        )
    return torch.where(ids >= 0, s, NEG_INF)


def _map_rescore(fn, q, ids, per_query_bytes: int):
    """A row-gather rescore over query sub-blocks, so its [chunk,
    shortlist, d] gather transient stays under _RESCORE_CHUNK_BYTES however
    large the query block is (rows are independent: chunking changes no
    result)."""
    chunk = max(64, 1 << max(
        _RESCORE_CHUNK_BYTES // max(per_query_bytes, 1), 1
    ).bit_length() - 1)
    return torch.cat([
        fn(q[s : s + chunk], ids[s : s + chunk])
        for s in range(0, q.shape[0], chunk)
    ])


def _union_rescore_matmul(db, q, pi, cells_sel, pos, ids, metric: str):
    """fp32 re-scoring of the shortlist without the per-(query, candidate)
    row gather: gather the union's fp32 rows once, score every (query,
    union row) pair with one product, and pick the shortlist's scores by
    buffer position."""
    gids = pi[cells_sel.long()].reshape(-1)
    safe = torch.clamp(gids.long(), 0, db.shape[0] - 1)
    buf = db[safe]  # [budget*lane, d] f32, slab-ordered
    s = q @ buf.T
    if metric == "l2":
        r_sq = torch.sum(buf * buf, dim=-1)
        q_sq = torch.sum(q * q, dim=-1)
        s = 2.0 * s - r_sq[None, :] - q_sq[:, None]
    # empty slots (pos -1) are masked below
    vals = torch.gather(s, 1, torch.clamp(pos.long(), min=0))
    return torch.where(ids >= 0, vals, NEG_INF)


def _rescore_topk(vals, ids, k_eff):
    vals, order = stable_topk(vals, min(k_eff, vals.shape[1]))
    return vals, torch.gather(ids, 1, order)


def _union_scan_one(
    q, centroids, pv, pi, sc, row_sq, db, slot, *,
    metric, k_eff, nprobe, shortlist, rescore, budget, int8_min_rows,
    compute="sym", sel=None, pad=0,
):
    """One query block through the batched union scan over `budget` cells.
    `sel` takes precomputed probe selections. `rescore`: False, "db" (fp32
    rows) or "slab" (dequantised slabs, the lean layout; `slot` maps ids to
    packed rows). `pad`: copies of the last query that fill the block up
    to QUERY_BLOCK in the reference (_probed_cells)."""
    c = centroids.shape[0]
    d = q.shape[1]
    if sel is None:
        sel = _route_topk(_route_sims(q, centroids, metric), nprobe)
    # cells ranked by POPULARITY (how many of the block's queries probe
    # them), lower cell id first among equal counts: with a budget ≥ the
    # true union this selects exactly the probed cells; a smaller fixed
    # budget drops the least popular ones
    probed = _probed_cells(sel, c, pad)
    if budget >= c:
        cells_sel = torch.arange(c, dtype=torch.int32, device=q.device)
    else:
        cells_sel = torch.sort(probed, descending=True, stable=True)[1][
            :budget
        ].to(torch.int32)
    q32 = q.to(torch.float32)
    if pv.shape[1] != d:
        # slabs are lane-padded to a 128 multiple at pack time; zero query
        # columns keep every dot product unchanged
        q32 = torch.nn.functional.pad(q32, (0, pv.shape[1] - d))
    # ip / cosine scan the selected slabs in place through kernel J; l2
    # keeps the gather path (its -|row|^2 bias lane has no int8 encoding),
    # and `int8_min_rows` can force it for any metric
    if metric != "l2" and budget * CAPACITY >= int8_min_rows:
        s = min(shortlist, budget * CAPACITY)
        vals, pos, ids = ivf_cuda.ivf_union_topk(
            pv, sc, pi, cells_sel, q32, s, recall_target=0.995,
            compute=compute, reciprocal=True,
        )
    else:
        from ..ops.exact_cuda import exact_topk

        buf, gids = _gather_bias_buffer(pv, pi, sc, row_sq, cells_sel, metric)
        q_aug = torch.cat([
            q32, q32.new_ones((q.shape[0], 1)), q32.new_zeros((q.shape[0], 127))
        ], dim=1)
        s = min(shortlist, buf.shape[0])
        # the engine's Poisson loss multiplies the routing loss, so pin it
        # well above the index-level target
        vals, pos = exact_topk(buf, q_aug, s, metric="cosine", exact=False,
                               recall_target=0.995)
        # an empty slot (pos -1) reads the buffer's last id, as the
        # reference's gather wraps negative positions
        ids = gids[pos.long()]
    vals = torch.where(ids >= 0, vals, NEG_INF)
    if metric == "l2":
        vals = vals - torch.sum(q32[:, :d] * q32[:, :d], dim=-1)[:, None]
    if rescore:
        s_actual = ids.shape[1]
        if rescore == "slab":
            vals = _map_rescore(
                lambda qq, ii: _slab_rescore_rows(
                    pv, sc, row_sq, slot, qq, ii, metric
                ),
                q, ids, s_actual * pv.shape[1] * 5,
            )
        elif (
            budget * CAPACITY * d * 4 <= _MATMUL_RESCORE_BUF_MAX
            and q.shape[0] * budget * CAPACITY * 4
            <= _MATMUL_RESCORE_SCORES_MAX
        ):
            vals = _union_rescore_matmul(db, q, pi, cells_sel, pos, ids, metric)
        else:
            vals = _map_rescore(
                lambda qq, ii: _exact_rescore_rows(db, qq, ii, metric),
                q, ids, s_actual * d * 4,
            )
        return _rescore_topk(vals, ids, k_eff)
    return vals[:, :k_eff], ids[:, :k_eff]


def _dma_block_one(
    q, centroids, pv, pi, sc, row_sq, db, slot, *,
    metric, k_eff, nprobe, shortlist, rescore, max_probe,
):
    """One query block through the per-probe path: route, score each query's
    own nprobe slabs with kernel K (max_probe per call), top-k the candidate
    strip, optionally rescore."""
    sel = _route_topk(_route_sims(q, centroids, metric), nprobe)  # [q, nprobe]
    q_sq = torch.sum(q * q, dim=-1) if metric == "l2" else None
    parts_s, parts_i = [], []
    for p0 in range(0, nprobe, max_probe):
        sel_part = sel[:, p0 : p0 + max_probe]
        s_part, i_part = slab_cuda.beam_expand(sel_part, q, pv, pi, sc, CAPACITY)
        if metric == "l2":
            # negated squared distance = 2qd - |d|^2 - |q|^2
            s_part = 2.0 * s_part - row_sq[sel_part] - q_sq[:, None, None]
        parts_s.append(s_part)
        parts_i.append(i_part)
    cand_s = torch.cat(parts_s, dim=1).reshape(q.shape[0], -1)
    cand_i = torch.cat(parts_i, dim=1).reshape(q.shape[0], -1)
    cand_s = torch.where(cand_i >= 0, cand_s, NEG_INF)
    vals, pos = stable_topk(cand_s, min(shortlist, cand_s.shape[1]))
    ids = torch.gather(cand_i, 1, pos)
    if rescore:
        s_actual = ids.shape[1]
        if rescore == "slab":
            vals = _map_rescore(
                lambda qq, ii: _slab_rescore_rows(
                    pv, sc, row_sq, slot, qq, ii, metric
                ),
                q, ids, s_actual * pv.shape[1] * 5,
            )
        else:
            vals = _map_rescore(
                lambda qq, ii: _exact_rescore_rows(db, qq, ii, metric),
                q, ids, s_actual * db.shape[1] * 4,
            )
        return _rescore_topk(vals, ids, k_eff)
    return vals, ids


class IVFIndex:
    """Inverted-file ANN over device-resident int8 slabs.

    Two execution paths share one index layout:

    * per-probe (kernel K): each query's probed slabs — for small / online
      batches (below UNION_MIN_Q queries) and low-locality query sets;
    * union scan (kernel J for ip / cosine): a block's queries score every
      cell any of them probes, each slab read once per block. Work scales
      with the probed fraction of the database, and a query sees every
      unioned cell, not just its own nprobe — a recall superset of
      classical IVF.
    """

    # fp32 rescore of the final top-k up to this k
    RESCORE_MAX_K = 128
    # queries per union-scan block: a block's union is what each of its
    # queries sees, so this decides results
    QUERY_BLOCK = 4096
    # union-scan rows at/above which the int8 kernel J runs for ip/cosine
    # (0 = always; tests force the bf16 gather path with 10**9)
    INT8_UNION_MIN_ROWS = 0
    # probes per kernel K call: its [qb, 32, 128] f32 + int32 outputs are
    # 128 MiB at qb = 4096 (K itself holds one query per block whatever
    # the probe count)
    MAX_PROBE_PER_CALL = 32
    # blocks at least this big take the union-scan path
    UNION_MIN_Q = 512
    # budget/nprobe ratio above which the per-probe path serves even big
    # batches (the reference's switch point, kept: it decides results)
    DMA_OVER_UNION_RATIO = 96

    def __init__(
        self,
        metric: str = "cosine",
        n_clusters: int = 0,  # 0 -> auto: ~2 * n / capacity (half-full)
        nprobe: int = 16,
        kmeans_iters: int = 8,
        prefs: int = 4,  # ranked cluster choices for capacity balancing
        store_fp32: bool = True,
        rescore_max_k: Optional[int] = None,
        shortlist_mult: float = 4.0,
        device="cuda",
    ):
        self.metric = metric
        self.n_clusters = n_clusters
        self.nprobe = nprobe
        self.kmeans_iters = kmeans_iters
        self.prefs = prefs
        # rescore_max_k lifts the fp32-rescore cutoff above RESCORE_MAX_K;
        # shortlist_mult sizes the rescore pool (default 4×k, capped by the
        # candidate pool)
        self.rescore_max_k = rescore_max_k
        self.shortlist_mult = shortlist_mult
        # store_fp32=False is the memory-lean layout: the fp32 rows are
        # dropped after build, small k rescores from the dequantised slabs,
        # and add() cannot extend the index
        self.store_fp32 = store_fp32
        self.device = resolve_device(device)
        self._db: Optional[torch.Tensor] = None
        self._n = 0
        self._d = 0
        self._centroids: Optional[torch.Tensor] = None
        self._members: Optional[torch.Tensor] = None
        self._packed = None  # (vecs int8 [C*128, d], ids [C,128], scales)
        self._slot = None  # [n] int64: global id -> packed row (lazy)
        self._row_sq: Optional[torch.Tensor] = None  # l2 additive term

    @property
    def ntotal(self) -> int:
        return self._n

    def _to_device(self, x) -> torch.Tensor:
        v = torch.as_tensor(np.asarray(x, dtype=np.float32)).to(self.device)
        return l2_normalize(v) if self.metric == "cosine" else v

    def add(self, vectors) -> "IVFIndex":
        if self._n and self._db is None:
            raise ValueError(
                "store_fp32=False dropped the fp32 rows at build; a lean"
                " index cannot add() incrementally — rebuild from the"
                " source vectors"
            )
        v = self._to_device(vectors)
        if self._db is not None:
            v = torch.cat([self._db, v], dim=0)
        self._db = v.contiguous()
        self._n, self._d = int(v.shape[0]), int(v.shape[1])
        self._build()
        if not self.store_fp32:
            self._db = None
        return self

    def _auto_clusters(self, n: int) -> int:
        if self.n_clusters > 0:
            return min(self.n_clusters, n)
        return max(1, int(np.ceil(2 * n / CAPACITY)))

    def add_chunks(
        self,
        make_chunks,
        n_total: int,
        kmeans_sample: int = 1 << 19,
    ) -> "IVFIndex":
        """Streamed lean build for a corpus whose fp32 rows never fit the
        device at once: the footprint is one fp32 chunk + the growing int8
        copy. `make_chunks` is a zero-argument callable returning a fresh
        iterable of [rows, d] arrays; it is called twice: pass 1 strides a
        <= `kmeans_sample`-row subsample for k-means, pass 2 routes and
        quantises each chunk into preallocated device buffers. Requires
        store_fp32=False."""
        if self._n:
            raise ValueError(
                "add_chunks builds from scratch; the index already has"
                f" {self._n} rows"
            )
        if self.store_fp32:
            raise ValueError(
                "add_chunks is the lean streamed build — construct the"
                " index with store_fp32=False (the fp32 rows are exactly"
                " what cannot be resident)"
            )
        n = int(n_total)
        c = self._auto_clusters(n)
        p = min(self.prefs, c)
        d = None
        # ---- pass 1: strided k-means subsample ----
        stride = max(1, -(-n // int(kmeans_sample)))
        parts = []
        seen = 0
        for chunk in make_chunks():
            v = self._to_device(chunk)
            d = int(v.shape[1])
            first = (-seen) % stride
            parts.append(v[first::stride])
            seen += int(v.shape[0])
        if seen != n:
            raise ValueError(
                f"make_chunks() yielded {seen} rows, n_total says {n}"
            )
        sample = torch.cat(parts)
        del parts
        self._centroids = _kmeans(sample, c, self.kmeans_iters, self.metric)
        del sample
        # ---- pass 2: route + quantise chunk by chunk ----
        dev = self.device
        db_i8 = torch.zeros((n, d), dtype=torch.int8, device=dev)
        scales = torch.ones((n,), device=dev)
        order2 = torch.zeros((n, p), dtype=torch.int64, device=dev)
        sq = torch.zeros((n,), device=dev) if self.metric == "l2" else None
        start = 0
        for chunk in make_chunks():
            v = self._to_device(chunk)
            end = start + int(v.shape[0])
            # the reference quantises each chunk eagerly: it divides by 127
            db_i8[start:end], scales[start:end] = slab_cuda.quantize_int8(v)
            order2[start:end] = _route_prefs(v, self._centroids, self.metric, p)
            if sq is not None:
                sq[start:end] = torch.sum(v * v, dim=-1)
            start = end
        self._n, self._d = n, d
        self._members = _balanced_members(order2, c, CAPACITY)
        del order2
        self._packed = slab_cuda.pack_neighbours_prequant(
            db_i8, scales, self._members, CAPACITY
        )
        self._slot = None
        if sq is not None:
            self._row_sq = self._member_values(sq)
        self._db = None
        return self

    def _member_values(self, per_row):
        """[C, 128] of a per-row quantity at each member slot, 0 on padding."""
        members = self._members.long()
        safe = torch.clamp(members, 0, self._n - 1)
        return torch.where(members >= 0, per_row[safe], 0.0)

    def _build(self) -> None:
        n = self._db.shape[0]
        c = self._auto_clusters(n)
        self._centroids = _kmeans(self._db, c, self.kmeans_iters, self.metric)
        # ranked preferences for balancing (top-P nearest centroids)
        p = min(self.prefs, c)
        order2 = _route_prefs(self._db, self._centroids, self.metric, p)
        self._members = _balanced_members(order2, c, CAPACITY)
        self._repack()

    def _repack(self) -> None:
        """Slabs (and the l2 row norms) from the fp32 rows and members."""
        self._packed = slab_cuda.pack_neighbours(
            self._db, self._members, CAPACITY
        )
        self._slot = None  # stale after a re-pack (incremental add)
        if self.metric == "l2":
            self._row_sq = self._member_values(
                torch.sum(self._db * self._db, dim=-1)
            )

    def search(
        self, queries, k: int, union_budget: Optional[int] = None
    ) -> Tuple[np.ndarray, np.ndarray]:
        sims, ids = self.search_device(queries, k, union_budget)
        return sims.cpu().numpy(), ids.cpu().numpy()

    def search_device(
        self, queries, k: int, union_budget: Optional[int] = None
    ) -> Tuple[torch.Tensor, torch.Tensor]:
        """Device-resident search: (scores [Q, k], ids [Q, k]) in the FAISS
        convention. `union_budget` fixes every union-scan block at that many
        cells instead of sizing each from its measured union (blocks whose
        union is larger drop their least popular cells)."""
        if self._n == 0:
            raise ValueError("index is empty; call add() first")
        if union_budget is not None and union_budget <= 0:
            union_budget = None  # 0/negative = "size from the blocks"
        q_all = self._to_device(queries)
        c = self._centroids.shape[0]
        k_eff, nprobe, rescore, shortlist, qb, compute = self.plan_blocks(k)
        pv, pi, sc = self._packed
        args = (self._centroids, pv, pi, sc, self._row_sq, self._db,
                self._slot_arg())
        q_n = q_all.shape[0]
        union = q_n >= self.UNION_MIN_Q
        perm = None
        if union and q_n > qb:
            # route-locality sort: queries grouped by their top-1 cell give
            # each block a smaller union; the inverse permutation restores
            # caller order
            top1 = _route_prefs(q_all, self._centroids, self.metric, 1)
            perm = torch.argsort(top1[:, 0], stable=True)
            q_all = q_all[perm]
        # blocks of qb queries; a query's result depends only on its own
        # block's cells, so the short tail block is not padded, but its
        # padding's probes still count (_probed_cells)
        blocks = [q_all[s : s + qb] for s in range(0, q_n, qb)]
        tail_pad = len(blocks) * qb - q_n
        budgets = sels = None
        if union:
            if union_budget is not None:
                budgets = [min(int(union_budget), c)] * len(blocks)
            else:
                u, sels = _block_union_counts(
                    blocks, self._centroids, self.metric, nprobe
                )
                budgets = [
                    min(1 << max(int(x) - 1, 0).bit_length(), c)
                    for x in u.tolist()
                ]
                logger.debug(
                    "%d queries in %d blocks: union cell budgets %s of %d"
                    " cells", q_n, len(blocks),
                    dict(sorted(Counter(budgets).items())), c,
                )
                # low-locality escape: huge unions relative to nprobe make
                # the per-probe path cheaper
                if float(np.median(budgets)) >= (
                    self.DMA_OVER_UNION_RATIO * nprobe
                ):
                    budgets = None
        if budgets is not None:
            outs = [
                _union_scan_one(
                    q, *args, metric=self.metric, k_eff=k_eff, nprobe=nprobe,
                    shortlist=shortlist, rescore=rescore, budget=b,
                    int8_min_rows=self.INT8_UNION_MIN_ROWS, compute=compute,
                    sel=None if sels is None else sels[bi],
                    pad=tail_pad if bi == len(blocks) - 1 else 0,
                )
                for bi, (q, b) in enumerate(zip(blocks, budgets))
            ]
        else:
            outs = [
                _dma_block_one(
                    q, *args, metric=self.metric, k_eff=k_eff, nprobe=nprobe,
                    shortlist=shortlist, rescore=rescore,
                    max_probe=self.MAX_PROBE_PER_CALL,
                )
                for q in blocks
            ]
        sims = torch.cat([o[0] for o in outs])
        ids = torch.cat([o[1] for o in outs])
        return self._finalize_search(sims, ids, k, perm)

    def _finalize_search(self, sims, ids, k: int, perm):
        """Undo the route-locality sort, pad the columns to k with the FAISS
        sentinel, finalize scores."""
        if perm is not None:
            inv = torch.empty_like(perm)
            inv[perm] = torch.arange(perm.shape[0], device=perm.device)
            sims, ids = sims[inv], ids[inv]
        if sims.shape[1] < k:
            pad = k - sims.shape[1]
            sims = torch.nn.functional.pad(sims, (0, pad), value=NEG_INF)
            ids = torch.nn.functional.pad(ids, (0, pad), value=-1)
        return finalize_scores(sims, self.metric), ids

    def plan_blocks(self, k: int):
        """Shared search sizing: (k_eff, nprobe, rescore, shortlist, qb,
        compute).

        * nprobe: the candidate pool must cover k with headroom (2x the
          average cell fill n/c, not the capacity);
        * rescore: "db" / "slab" up to RESCORE_MAX_K (or rescore_max_k);
        * compute: without the fp32 rows' rescore the scan takes the sym2
          residual pass instead, which reaches the storage-noise floor;
        * shortlist: the rescore pool, a cluster's worth of headroom."""
        n = self.ntotal
        c = self._centroids.shape[0]
        k_eff = min(k, n)
        avg_fill = max(1, n // max(c, 1))
        nprobe = min(max(self.nprobe, -(-2 * k_eff // avg_fill)), c)
        rescore = False
        max_rescore_k = (
            self.rescore_max_k
            if self.rescore_max_k is not None
            else self.RESCORE_MAX_K
        )
        if k_eff <= max_rescore_k:
            rescore = "db" if self._db is not None else "slab"
        compute = "sym" if rescore == "db" else "sym2"
        shortlist = (
            min(
                max(int(self.shortlist_mult * k_eff), CAPACITY),
                nprobe * CAPACITY,
            )
            if rescore
            else k_eff
        )
        return k_eff, nprobe, rescore, shortlist, self.QUERY_BLOCK, compute

    def _slot_arg(self) -> Optional[torch.Tensor]:
        """[n] global id -> packed slab row, for the lean slab rescore (None
        when fp32 rows exist). Built lazily by inverting the packed id table
        (each row lives in exactly one cell; padding slots scatter into a
        discarded overflow entry)."""
        if self._db is not None:
            return None
        if self._slot is None:
            flat = self._packed[1].reshape(-1).long()
            idx = torch.where(flat >= 0, flat, self._n)
            slot = torch.zeros((self._n + 1,), dtype=torch.int64,
                               device=flat.device)
            slot[idx] = torch.arange(flat.shape[0], device=flat.device)
            self._slot = slot[: self._n]
        return self._slot

    # --- persistence payload (see search/io.py) ---
    def state(self) -> dict:
        base = {
            "kind": "ivf",
            "metric": self.metric,
            "n_clusters": self._centroids.shape[0],
            "nprobe": self.nprobe,
            "kmeans_iters": self.kmeans_iters,
            "prefs": self.prefs,
            "centroids": self._centroids.cpu().numpy(),
            "members": self._members.cpu().numpy(),
        }
        if self._db is not None:
            base["vectors"] = self._db.cpu().numpy()
            return base
        # lean layout: the int8 slabs ARE the index — persist them directly
        # so the round trip is bit-identical
        pv, pi, sc = self._packed
        base.update(
            lean=1,
            n=self._n,
            d=self._d,
            packed_vecs=pv.cpu().numpy(),
            packed_ids=pi.cpu().numpy(),
            packed_scales=sc.cpu().numpy(),
        )
        if self._row_sq is not None:
            base["row_sq"] = self._row_sq.cpu().numpy()
        return base

    @classmethod
    def from_state(cls, state: dict, device="cuda") -> "IVFIndex":
        """The index a state describes (written by either package), on
        `device`. The fp32 layout re-packs its slabs as the reference does."""
        lean = "lean" in state and bool(np.asarray(state["lean"]))
        index = cls(
            metric=str(state["metric"]),
            n_clusters=int(state["n_clusters"]),
            nprobe=int(state["nprobe"]),
            kmeans_iters=int(state["kmeans_iters"]),
            prefs=int(state["prefs"]),
            store_fp32=not lean,
            device=device,
        )

        def put(key, dtype):
            return torch.from_numpy(np.array(state[key], dtype=dtype)).to(
                index.device)

        index._centroids = put("centroids", np.float32)
        index._members = put("members", np.int32)
        if lean:
            index._n = int(state["n"])
            index._d = int(state["d"])
            index._packed = (put("packed_vecs", np.int8),
                             put("packed_ids", np.int32),
                             put("packed_scales", np.float32))
            if "row_sq" in state:
                index._row_sq = put("row_sq", np.float32)
            return index
        index._db = put("vectors", np.float32)
        index._n, index._d = (int(s) for s in index._db.shape)
        index._repack()
        return index
