"""Graph ANN index (port of knn_for_homology_tpu/search/graph.py): the
stand-in for the reference's FAISS IndexHNSWFlat (M=42, efSearch=256,
k=1000; reference: pfam/proteins_search.py:30-49).

  build — a flat kNN graph: exact top-(degree+1) neighbours from the flat
          engine (ops/topk.py:flat_topk, kernel B on the card at degree 42),
          self-hit stripped, the tail columns replaced by seeded long-range
          edges (JAX's Threefry draw, utils/threefry.py); above
          EXACT_BUILD_MAX rows, kNN-descent rounds instead.
  query — batched best-first beam search (CAGRA-style, arXiv:2308.15136):
          every step expands the best unexpanded beam entries of all
          queries at once, scores their neighbours, drops duplicates and
          rebuilds the beam. Two routes: the packed route scores the
          neighbours' int8 slabs with kernel K (ops/slab_cuda.beam_expand),
          the unpacked route gathers a bf16 copy of the rows.

Which ids come back is the reference's. Its `lax.top_k` keeps the lower
index on ties: here a stable sort does (the expand pick, the beam rebuild,
the entry seeding, kNN-descent). Its duplicate masks (against the beam
and earlier candidates) are one stable sort by id here. Its bf16 x bf16 products summed in fp32
are fp32 products of the bf16 values here (exact), with TF32 off. The
loop runs its steps with no host sync: K's route comes from shapes and
its tile plan stays on the device. The device is explicit (`device`,
"cuda" by default). Scores follow the FAISS convention (cosine / ip
descending, l2 ascending squared distances).
"""

from typing import Optional, Tuple

import numpy as np
import torch

from ..device import resolve_device
from ..ops import slab_cuda
from ..ops.distance import METRICS, finalize_scores, l2_normalize
from ..ops.topk import NEG_INF, flat_topk, stable_topk
from ..utils import threefry

# the reference's seed of the long-range edges (search/graph.py:_finish_graph)
EDGE_SEED = 0x5EED


def _bf16(x: torch.Tensor) -> torch.Tensor:
    """x rounded to bf16, as fp32: products of such values are exact in
    fp32, so an fp32 product of them is the reference's bf16 product with
    fp32 sums."""
    return x.to(torch.bfloat16).to(torch.float32)


def _rows_sims(vecs, q, queries, metric: str) -> torch.Tensor:
    """[Q, C] bigger-is-better similarities of gathered rows [Q, C, d]: dots
    with q [Q, d] (the queries, or their bf16 rounding); l2 2·dot − |v|² −
    |query|²."""
    s = torch.bmm(vecs, q[:, :, None])[..., 0]
    if metric == "l2":
        s = (2.0 * s - torch.sum(vecs * vecs, dim=-1)
             - torch.sum(queries * queries, dim=-1, keepdim=True))
    return s


def _traversal_sims(rows, ids, q_t, queries, metric: str) -> torch.Tensor:
    """[Q, C] traversal similarities of the rows `ids` [Q, C] (clamped to
    the table; callers mask what is not a node): bf16 row values against
    the bf16 query `q_t`, fp32 sums."""
    vecs = _bf16(rows[ids.clamp(0, rows.shape[0] - 1).long()])
    return _rows_sims(vecs, q_t, queries, metric)


def _repeats(ids: torch.Tensor) -> torch.Tensor:
    """[Q, C] True where an id repeats one at an earlier position of its
    row: a stable sort by id keeps each id's first position first."""
    sorted_ids, order = torch.sort(ids, dim=1, stable=True)
    later = torch.cat([
        torch.zeros_like(sorted_ids[:, :1], dtype=torch.bool),
        sorted_ids[:, 1:] == sorted_ids[:, :-1],
    ], dim=1)
    return torch.empty_like(later).scatter_(1, order, later)


def _mask_padding(nbrs: torch.Tensor, sel_ids: torch.Tensor) -> torch.Tensor:
    """[Q, E·degree] candidate ids from the expanded nodes' [Q, E, degree]
    lists, -1 where the expanded entry was beam padding (-1)."""
    nbrs = torch.where(sel_ids[:, :, None] < 0, -1, nbrs)
    return nbrs.reshape(nbrs.shape[0], -1)


def _beam_loop(init_ids, init_sims, expand_step, beam_width: int,
               expand: int, iters: int):
    """The reference's fori_loop: `iters` steps, each expanding the best
    `expand` unexpanded entries (padding counts as expanded) and keeping
    the best `beam_width` of beam + new candidates. `expand_step(sel_ids)`
    gives the candidates: (ids [Q, C], -1 where no node; similarities).
    Returns (beam ids, beam similarities), best first."""
    q_n, s = init_ids.shape
    beam_width = max(beam_width, s)  # the beam holds the entries
    pad = beam_width - s
    beam_ids = torch.nn.functional.pad(init_ids, (0, pad), value=-1)
    beam_sims = torch.nn.functional.pad(init_sims, (0, pad), value=NEG_INF)
    expanded = torch.ones_like(beam_ids, dtype=torch.bool)
    expanded[:, :s] = False
    for _ in range(iters):
        cand = torch.where(expanded, NEG_INF, beam_sims)
        sel = stable_topk(cand, expand)[1]
        sel_ids = torch.gather(beam_ids, 1, sel)
        expanded = expanded.scatter(1, sel, True)
        nbrs, n_sims = expand_step(sel_ids)
        ids = torch.cat([beam_ids, nbrs], 1)
        # a candidate dies if it repeats a beam entry or an earlier one
        dead = _repeats(ids)[:, beam_width:] | (nbrs < 0)
        beam_sims, keep = stable_topk(
            torch.cat([beam_sims, torch.where(dead, NEG_INF, n_sims)], 1),
            beam_width)
        beam_ids = torch.gather(ids, 1, keep)
        expanded = torch.gather(
            torch.cat([expanded, torch.zeros_like(dead)], 1), 1, keep)
    return beam_ids, beam_sims


def _mask_rows(sims: torch.Tensor, ids: torch.Tensor, n_valid) -> torch.Tensor:
    """-inf where ids ≥ n_valid (a shard's pad rows never score)."""
    if n_valid is None:
        return sims
    return torch.where(ids < n_valid, sims, NEG_INF)


def _init_beam(entry_ids: torch.Tensor, q_n: int) -> torch.Tensor:
    """[Q, S] entries: shared [S] ones broadcast, per-query [Q, S] as is."""
    if entry_ids.dim() == 1:
        return entry_ids[None, :].expand(q_n, -1)
    return entry_ids


def _rescore(db, queries, top_ids, metric: str, n_valid=None):
    """Exact fp32 rescore of the winners, sorted by (score descending, id
    ascending) as the reference's two-key sort."""
    vecs = db[top_ids.clamp(0, db.shape[0] - 1).long()]
    s = _rows_sims(vecs, queries, queries, metric)
    s = _mask_rows(torch.where(top_ids < 0, NEG_INF, s), top_ids, n_valid)
    ids, by_id = torch.sort(top_ids, dim=1, stable=True)
    s, order = torch.sort(torch.gather(s, 1, by_id), dim=1, descending=True,
                          stable=True)
    return s, torch.gather(ids, 1, order)


def beam_search_packed(
    db: torch.Tensor,  # [N, d] fp32 (exact rescoring)
    packed_vecs: torch.Tensor,  # [N*deg_p, d] int8
    packed_ids: torch.Tensor,  # [N, 128] int32
    packed_scales: torch.Tensor,  # [N, 128] f32
    queries: torch.Tensor,  # [Q, d] fp32
    entry_ids: torch.Tensor,  # [S] or [Q, S] int32
    k: int,
    deg_p: int,
    degree: int,
    beam_width: int = 256,
    expand: int = 8,
    iters: int = 16,
    n_valid: Optional[int] = None,
    rescore: bool = True,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Beam search over the packed int8 neighbour slabs (cosine / ip): each
    step's neighbour gather and scoring is one call of kernel K on the
    card, its plain version on the CPU. Returns (sims [Q, k] descending,
    ids [Q, k]). Rows ≥ n_valid (a shard's pad rows) never score;
    `rescore=False` returns the beam's traversal scores."""
    q_n = queries.shape[0]
    n = db.shape[0]
    q_t = _bf16(queries)  # K takes the bf16-rounded query, as in JAX
    init_ids = _init_beam(entry_ids, q_n)
    init_sims = torch.where(init_ids < 0, NEG_INF, _mask_rows(
        _traversal_sims(db, init_ids, q_t, queries, "ip"), init_ids, n_valid))

    def expand_step(sel_ids):
        sims3, nbrs3 = slab_cuda.beam_expand(
            sel_ids.clamp(0, n - 1), q_t, packed_vecs, packed_ids,
            packed_scales, deg_p,
        )
        # expanded beam padding scores node 0's slab: not candidates
        nbrs = _mask_padding(nbrs3[:, :, :degree], sel_ids)
        return nbrs, _mask_rows(sims3[:, :, :degree].reshape(q_n, -1), nbrs,
                                n_valid)

    beam_ids, beam_sims = _beam_loop(init_ids, init_sims, expand_step,
                                     max(beam_width, k), expand, iters)
    if not rescore:
        return beam_sims[:, :k], beam_ids[:, :k]
    return _rescore(db, queries, beam_ids[:, :k], "ip", n_valid)


def beam_search(
    db: torch.Tensor,  # [N, d] fp32 (exact rescoring)
    graph: torch.Tensor,  # [N, degree] int32
    queries: torch.Tensor,  # [Q, d] fp32
    entry_ids: torch.Tensor,  # [S] or [Q, S] int32
    k: int,
    beam_width: int = 256,
    expand: int = 4,
    iters: int = 24,
    metric: str = "cosine",
    db_traversal: Optional[torch.Tensor] = None,  # [N, d] bf16 copy
    n_valid: Optional[int] = None,
    rescore: bool = True,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Beam search over the adjacency lists, scoring gathered rows of the
    bf16 traversal copy; the winners are rescored against the fp32 `db`.
    Returns (sims [Q, k] descending, ids [Q, k]). Rows ≥ n_valid (a
    shard's pad rows) never score; `rescore=False` returns the beam's
    traversal scores."""
    q_n = queries.shape[0]
    db_t = db.to(torch.bfloat16) if db_traversal is None else db_traversal
    q_t = _bf16(queries)
    init_ids = _init_beam(entry_ids, q_n)
    init_sims = _mask_rows(
        _traversal_sims(db_t, init_ids, q_t, queries, metric), init_ids,
        n_valid)

    def expand_step(sel_ids):
        nbrs = _mask_padding(graph[sel_ids.clamp(0, graph.shape[0] - 1).long()],
                             sel_ids)
        return nbrs, _mask_rows(
            _traversal_sims(db_t, nbrs, q_t, queries, metric), nbrs, n_valid)

    beam_ids, beam_sims = _beam_loop(init_ids, init_sims, expand_step,
                                     max(beam_width, k), expand, iters)
    if not rescore:
        return beam_sims[:, :k], beam_ids[:, :k]
    return _rescore(db, queries, beam_ids[:, :k], metric, n_valid)


def _finish_graph(graph: torch.Tensor, n: int, deg: int, r: int):
    """DiskANN/NSW-style long-range edges: the last r columns become the
    reference's seeded random targets (jax.random.randint(PRNGKey(0x5EED),
    (n, r), 0, n), drawn bit for bit by utils/threefry.py), so the graph
    stays navigable when the data clusters tightly."""
    if r <= 0:
        return graph
    rand = threefry.randint(threefry.prng_key(EDGE_SEED), (n, r), 0, n)
    graph = graph.clone()
    graph[:, deg - r:] = torch.from_numpy(rand).to(graph.device)
    return graph


def _assemble_graph(ids: torch.Tensor, n: int, deg: int, r: int):
    """Strip the self column of the exact top-(deg+1) ids (a stable sort
    moves it last), back-fill missing hits with self-loops and install the
    long-range edges, on the device."""
    rows = torch.arange(n, dtype=torch.int32, device=ids.device)[:, None]
    ids = ids.to(torch.int32)
    order = torch.argsort((ids == rows).to(torch.uint8), dim=1, stable=True)
    graph = torch.gather(ids, 1, order)[:, :deg]
    graph = torch.where(graph < 0, rows, graph)
    return _finish_graph(graph, n, deg, r)


def _refine_block(db, graph, rows, degree: int, sample: int, metric: str):
    """One kNN-descent round for the nodes `rows`: candidates are their
    neighbours and the neighbours of their first `sample` neighbours;
    duplicates and self go, the best `degree` stay."""
    b = rows.shape[0]
    own = graph[rows]
    cand = torch.cat([own, graph[own[:, :sample].long()].reshape(b, -1)], 1)
    q = db[rows]
    sims = _rows_sims(db[cand.long()], q, q, metric)
    sims = torch.where(_repeats(cand) | (cand == rows[:, None]), NEG_INF,
                       sims)
    return torch.gather(cand, 1, stable_topk(sims, degree)[1])


def nn_descent_build(
    db: torch.Tensor,
    degree: int,
    iters: int = 6,
    sample: int = 12,
    metric: str = "cosine",
    block: int = 4096,
    seed: int = 0,
) -> np.ndarray:
    """kNN-descent graph construction, O(N·deg²·d) a round instead of the
    exact build's O(N²·d): the scalable path above EXACT_BUILD_MAX rows.
    Starts from the reference's `np.random.RandomState(seed)` graph and
    stops early when a round changes nothing. → [N, degree] int32."""
    n = db.shape[0]
    degree = min(degree, n - 1)
    sample = min(sample, degree)
    rng = np.random.RandomState(seed)
    graph = rng.randint(0, n, size=(n, degree)).astype(np.int32)
    for _ in range(iters):
        graph_dev = torch.from_numpy(graph).to(db.device)
        new_graph = np.concatenate([
            _refine_block(
                db, graph_dev,
                torch.arange(s, min(s + block, n), device=db.device),
                degree, sample, metric,
            ).cpu().numpy()
            for s in range(0, n, block)
        ])
        if np.array_equal(new_graph, graph):
            break
        graph = new_graph
    return graph


def _seed_entries(rows, pivot_ids, queries, n_entry: int, metric: str,
                  n_valid: Optional[int] = None):
    """Per-query entry points: the best `n_entry` of a strided pivot sample,
    scored once per query. The pivots are bf16-rounded; the queries too
    where `rows` is the bf16 traversal copy (the unpacked route), not
    where it is the fp32 db (the packed route), as in the reference.
    Pivots ≥ n_valid (a shard's pad rows) are never picked."""
    p_vecs = _bf16(rows[pivot_ids.long()])
    q = queries if rows.dtype == torch.float32 else _bf16(queries)
    s = q @ p_vecs.T
    if metric == "l2":
        s = 2.0 * s - torch.sum(p_vecs * p_vecs, dim=-1)[None, :]
    s = _mask_rows(s, pivot_ids[None, :], n_valid)
    sel = stable_topk(s, min(n_entry, pivot_ids.shape[0]))[1]
    return pivot_ids[sel]


def _card_bytes(device: torch.device) -> int:
    return torch.cuda.get_device_properties(device).total_memory


class GraphIndex:
    """Neighbour-graph ANN over device-resident vectors."""

    # exact O(N²) graph build up to this many rows; kNN-descent beyond
    EXACT_BUILD_MAX = 262144
    # packed="auto" packs on the card while the int8 slab table (N · deg_p
    # · d bytes) stays within this share of the card's memory: a quarter
    # (21.2 GB of an 80 GB H100) leaves the rest to the fp32 rows, the
    # pack's gather index (N · deg_p · 8 bytes), the search's transients
    # (RESCORE_SHARE) and a second index. The reference's 10 GiB was sized
    # for a 16 GB chip. The pfam-proteins table (131072 x 64 x 1024) is
    # 8.6 GB.
    PACKED_SHARE = 0.25
    # query block: the fp32 rescore gather [qb, beam, d] of a block stays
    # within this share of the card's memory (an eighth: 10.6 GB on an 80
    # GB H100, so qb = 2048 at k = 1000 and d = 1024), and within 2e9
    # bytes on the CPU (the reference's budget). Every query has its own
    # seeds and beam, so results do not depend on the block.
    QUERY_BLOCK = 4096
    RESCORE_SHARE = 0.125
    CPU_RESCORE_BYTES = 2e9
    # On the card every query block runs its whole search (seeding, the
    # beam loop, the rescore) as one CUDA graph: a block is ~600 small
    # launches, which otherwise keep the card waiting on the host (an online
    # batch of 256 queries: ~12 ms of launches for ~4 ms of kernels, PERF.md
    # §5). A block is padded to a power of two, so one k has at most 13
    # sizes; at most MAX_GRAPHS graphs are kept, the least recently used
    # freed first, all in one memory pool an index.
    MAX_GRAPHS = 16
    # replays of captured blocks, by every index (kernel K's counters count
    # only its eager launches: a replay does not pass through its wrapper)
    graph_replays = 0

    def __init__(
        self,
        metric: str = "cosine",
        degree: int = 42,
        beam_width: int = 128,
        expand: int = 8,
        iters: Optional[int] = None,
        n_entry: int = 32,
        n_pivots: int = 16384,  # 0 → shared strided entry points
        build: str = "auto",  # auto | exact | nn-descent
        packed: str = "auto",  # auto | always | never — kernel K's route
        random_edges: int = 4,  # long-range edges per node (connectivity)
        device="cuda",
    ):
        if metric not in METRICS:
            raise ValueError(f"metric must be one of {METRICS}")
        self.metric = metric
        self.build = build
        self.degree = degree
        self.beam_width = beam_width
        self.expand = expand
        self.iters = iters
        self.n_entry = n_entry
        self.n_pivots = n_pivots
        self.packed = packed
        self.random_edges = random_edges
        self.device = resolve_device(device)
        self._db: Optional[torch.Tensor] = None
        self._graph: Optional[torch.Tensor] = None
        self._db_t: Optional[torch.Tensor] = None
        self._packed = None  # (packed_vecs, packed_ids, packed_scales, deg_p)
        self._graphs = {}  # captured searches, LRU: key -> (graph, q, out)
        self._pool = None  # their memory pool

    def _use_packed(self) -> bool:
        """Kernel K's route or the unpacked one. The result rules are the
        reference's (l2 and degree > 128 go unpacked; packed="always"
        raises where it cannot be honoured), and so is d % 128, which K
        does not need (it pads d) but keeps the same calls raising in both
        packages. "auto" packs on the card within PACKED_SHARE."""
        reason = None
        if self.metric == "l2":
            reason = "packed scoring is ip/cosine only"
        elif self._graph is not None and self._graph.shape[1] > 128:
            reason = "packed ids/scales are one 128-lane row per node"
        elif self._db is not None and self._db.shape[1] % 128 != 0:
            reason = "slab rows are lane-aligned (the reference's rule)"
        if self.packed == "never" or reason is not None:
            if self.packed == "always" and reason is not None:
                degree = (self._graph.shape[1] if self._graph is not None
                          else self.degree)
                d = self._db.shape[1] if self._db is not None else "?"
                raise ValueError(
                    f"packed='always' cannot be honoured: {reason} "
                    f"(degree={degree}, d={d}, metric={self.metric})"
                )
            return False
        if self.packed == "always":
            return True
        n, d = self._db.shape
        deg_p = slab_cuda.pad_degree(min(self.degree, max(n - 1, 1)))
        return (self.device.type == "cuda" and n * deg_p * d
                <= self.PACKED_SHARE * _card_bytes(self.device))

    def _packed_state(self):
        """(packed_vecs, packed_ids, packed_scales, deg_p), built once per
        graph (ops/slab_cuda.pack_neighbours)."""
        if self._packed is None:
            deg_p = slab_cuda.pad_degree(self._graph.shape[1])
            pv, pi, sc = slab_cuda.pack_neighbours(self._db, self._graph,
                                                   deg_p)
            self._packed = (pv, pi, sc, deg_p)
        return self._packed

    def _db_traversal(self) -> torch.Tensor:
        """bf16 copy for the unpacked route's gathers (half the bytes of
        the fp32 rows; the final top-k is rescored in fp32)."""
        if self._db_t is None or self._db_t.shape != self._db.shape:
            self._db_t = self._db.to(torch.bfloat16)
        return self._db_t

    @property
    def ntotal(self) -> int:
        return 0 if self._db is None else self._db.shape[0]

    def add(self, vectors) -> "GraphIndex":
        """Install vectors and build the neighbour graph (one shot; unlike
        HNSW there is no insertion order to replay)."""
        v = torch.as_tensor(np.asarray(vectors, dtype=np.float32)).to(
            self.device)
        if self.metric == "cosine":
            v = l2_normalize(v)
        if self._db is not None:
            v = torch.cat([self._db, v], dim=0)
        self._db = v.contiguous()
        self._build_graph()
        return self

    def _build_graph(self) -> None:
        self._packed = None  # derived from the graph: rebuilt lazily
        self._graphs, self._pool = {}, None
        n = self._db.shape[0]
        deg = min(self.degree, n - 1)
        build = self.build
        if build == "auto":
            build = "exact" if n <= self.EXACT_BUILD_MAX else "nn-descent"
        r = min(self.random_edges, max(deg - 1, 0))
        if r > 0 and n <= deg + 1:
            r = 0
        if build == "nn-descent":
            graph = torch.from_numpy(
                nn_descent_build(self._db, deg, metric=self.metric)
            ).to(self.device)
            self._graph = _finish_graph(graph, n, deg, r)
        else:
            _, ids = flat_topk(self._db, self._db, deg + 1, metric=self.metric)
            self._graph = _assemble_graph(ids, n, deg, r)

    def _entry_points(self) -> torch.Tensor:
        n = self.ntotal
        step = max(n // max(self.n_entry, 1), 1)
        return torch.arange(0, n, step, dtype=torch.int32,
                            device=self.device)[: self.n_entry]

    def _pivot_ids(self) -> torch.Tensor:
        n = self.ntotal
        count = min(self.n_pivots, n)
        step = max(n // max(count, 1), 1)
        return torch.arange(0, n, step, dtype=torch.int32,
                            device=self.device)[:count]

    def query_block(self, k: int) -> int:
        """Queries per beam-search block (see QUERY_BLOCK)."""
        beam = max(self.beam_width, k)
        budget = (self.RESCORE_SHARE * _card_bytes(self.device)
                  if self.device.type == "cuda" else self.CPU_RESCORE_BYTES)
        qb = self.QUERY_BLOCK
        while qb > 256 and qb * beam * self._db.shape[1] * 4 > budget:
            qb //= 2
        return qb

    def search(self, queries, k: int) -> Tuple[np.ndarray, np.ndarray]:
        if self._db is None:
            raise ValueError("index is empty; call add() first")
        q_all = torch.as_tensor(np.asarray(queries, dtype=np.float32)).to(
            self.device)
        if self.metric == "cosine":
            q_all = l2_normalize(q_all)
        beam = max(self.beam_width, k)
        # `is None`, not falsy: iters=0 skips expansion
        iters = (self.iters if self.iters is not None
                 else max(8, beam // max(self.expand, 1) // 2))
        k_eff = min(k, self.ntotal)
        use_packed = self._use_packed()
        if use_packed:
            self._packed_state()
        pivot_rows = self._db if use_packed else self._db_traversal()
        qb = self.query_block(k)
        sims_out, ids_out = [], []
        for start in range(0, q_all.shape[0], qb):
            q = q_all[start : start + qb]
            args = (k_eff, beam, iters, use_packed, pivot_rows)
            if self.device.type == "cuda":
                s, i = self._replay(q, args)
            else:
                s, i = self._search_block(q, *args)
            sims_out.append(s)
            ids_out.append(i)
        sims = torch.cat(sims_out)
        ids = torch.cat(ids_out).to(torch.int32)
        if k > k_eff:
            sims = torch.nn.functional.pad(sims, (0, k - k_eff),
                                           value=NEG_INF)
            ids = torch.nn.functional.pad(ids, (0, k - k_eff), value=-1)
        return (finalize_scores(sims, self.metric).cpu().numpy(),
                ids.cpu().numpy())

    def _search_block(self, q, k, beam, iters, use_packed, pivot_rows):
        """(sims, ids) [Q, k] of one query block: seeding, the beam loop
        and the exact rescore, with no host sync."""
        if self.n_pivots > 0:
            entries = _seed_entries(pivot_rows, self._pivot_ids(), q,
                                    self.n_entry, self.metric)
        else:
            entries = self._entry_points()
        if use_packed:
            pv, pi, sc, deg_p = self._packed_state()
            return beam_search_packed(
                self._db, pv, pi, sc, q, entries, k=k, deg_p=deg_p,
                degree=self._graph.shape[1], beam_width=beam,
                expand=self.expand, iters=iters,
            )
        return beam_search(
            self._db, self._graph, q, entries, k=k, beam_width=beam,
            expand=self.expand, iters=iters, metric=self.metric,
            db_traversal=self._db_traversal(),
        )

    def _replay(self, q, args):
        """_search_block(q, *args) through the CUDA graph of the block
        padded to a power of two (rows past q's own are earlier queries,
        searched and dropped), captured at the first such block after one
        eager warm-up run on a side stream. The key holds the padded size,
        the arguments, the tables' addresses and the functions the search
        calls, so a rebuilt index or a replaced kernel route captures
        anew."""
        n = q.shape[0]
        size = 1 << (n - 1).bit_length()
        tables = self._packed[0] if args[3] else self._db_traversal()
        key = (size, *args[:4], self._db.data_ptr(), tables.data_ptr(),
               slab_cuda.beam_expand, slab_cuda.slab_route)
        entry = self._graphs.pop(key, None)
        if entry is None:
            static = q[torch.arange(size, device=q.device) % n]
            stream = torch.cuda.current_stream(self.device)
            side = torch.cuda.Stream(self.device)
            side.wait_stream(stream)
            with torch.cuda.stream(side):
                self._search_block(static, *args)
            stream.wait_stream(side)
            if len(self._graphs) >= self.MAX_GRAPHS:
                del self._graphs[next(iter(self._graphs))]
            if self._pool is None:
                self._pool = torch.cuda.graph_pool_handle()
            graph = torch.cuda.CUDAGraph()
            with torch.cuda.graph(graph, pool=self._pool,
                                  capture_error_mode="thread_local"):
                out = self._search_block(static, *args)
            entry = (graph, static, out)
        self._graphs[key] = entry  # the most recently used last
        graph, static, out = entry
        static[:n].copy_(q)
        graph.replay()
        GraphIndex.graph_replays += 1
        return out[0][:n].clone(), out[1][:n].clone()

    # --- persistence payload (see search/io.py) ---
    def state(self) -> dict:
        return {
            "kind": "graph",
            "metric": self.metric,
            "degree": self.degree,
            "beam_width": self.beam_width,
            "expand": self.expand,
            "n_entry": self.n_entry,
            "n_pivots": self.n_pivots,
            "iters": self.iters if self.iters is not None else -1,
            "build": self.build,
            "packed": self.packed,
            "random_edges": self.random_edges,
            "vectors": self._db.cpu().numpy(),
            "graph": self._graph.cpu().numpy(),
        }

    @classmethod
    def from_state(cls, state: dict, device="cuda") -> "GraphIndex":
        """The index a state describes (written by either package), on
        `device`, with the reference's defaults for keys older files
        lack."""
        iters = int(state["iters"]) if "iters" in state else -1
        index = cls(
            metric=str(state["metric"]),
            degree=int(state["degree"]),
            beam_width=int(state["beam_width"]),
            expand=int(state["expand"]),
            n_entry=int(state["n_entry"]),
            n_pivots=int(state["n_pivots"]) if "n_pivots" in state else 1024,
            iters=None if iters < 0 else iters,
            build=str(state["build"]) if "build" in state else "auto",
            packed=str(state["packed"]) if "packed" in state else "auto",
            random_edges=(
                int(state["random_edges"]) if "random_edges" in state else 4
            ),
            device=device,
        )
        index._db = torch.from_numpy(
            np.array(state["vectors"], dtype=np.float32)).to(index.device)
        index._graph = torch.from_numpy(
            np.array(state["graph"], dtype=np.int32)).to(index.device)
        return index
