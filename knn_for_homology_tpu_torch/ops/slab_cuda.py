"""Kernel K: slab expansion (csrc/slab_expand.cu), and the packed slab
layout it reads. Port of knn_for_homology_tpu/ops/graph_pallas.py.

Packed layout, built once at index-build time (`pack_neighbours`):
  * packed_vecs [G * deg_p, d] int8 — group g's member vectors at rows
    [g*deg_p, (g+1)*deg_p), symmetric per-row quantisation, pad rows zero,
    d zero-padded to a multiple of LANE;
  * packed_ids [G, 128] int32 — member ids, -1 on padding;
  * packed_scales [G, 128] f32 — per-row dequant scales, 1.0 on padding.
A group is a node's adjacency for a graph, or a cluster's members for the
IVF index (search/ivf.py, deg_p = 128).

`beam_expand` scores each query against the slabs of its selected groups:
kernel K on a CUDA tensor, `beam_expand_plain` on a CPU tensor. Kernel K
has two routes, chosen from shapes (`slab_route`): the tile route reads
each probed slab once per tile of up to NQ (query, probe) pairs of one
node, from the plan `slab_plan` makes on the device; the pair route, a
block per query, streams each pair's slab, which is faster where most
nodes are probed once and the queries fill the card.
"""

from typing import Tuple

import torch

from . import _build
from .packed_cuda import quantize_int8

LANE = 128
# (query, probe) pairs of one node a tile of kernel K scores against one
# read of its slab: the kernel's widest product (wgmma n64); tiles of at
# most NARROW pairs go to its narrow launch (csrc/slab_expand.cu's NQ and
# NARROW; 0 sends every tile to the wide launch)
NQ = 64
NARROW = 16
# the pair route: at least PAIRS_MIN_Q queries (a block each) and at most
# PAIRS_MAX_SHARE pairs a node on average (Q·E / N); queries of at most
# PAIRS_MAX_D columns (its fp32 copy in shared memory). On an H100 the
# pair route was as fast or faster there, and slower at fewer queries or
# more sharing (scripts/torch_slab_compare.py --sweep)
PAIRS_MIN_Q = 256
PAIRS_MAX_SHARE = 1.0
PAIRS_MAX_D = 12288
ROUTES = ("tiles", "pairs")

# queries per step of the plain version: bounds its [chunk, E*deg_p, d]
# fp32 slab transient to ~1 GiB
_PLAIN_BYTES = 1 << 30


def pad_degree(degree: int) -> int:
    """int8 slabs want a row multiple of 32."""
    return max(32, ((degree + 31) // 32) * 32)


def pack_neighbours(
    db: torch.Tensor, graph: torch.Tensor, deg_p: int, reciprocal: bool = True
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """(packed_vecs, packed_ids, packed_scales) from fp32 rows [N, d] and a
    group table `graph` [G, degree] int32. The reference jit-compiles this,
    so its quantisation multiplies by f32(1/127): `reciprocal=True`
    (ops/packed_cuda.py:quantize_int8)."""
    q8, scales = quantize_int8(db.to(torch.float32), reciprocal=reciprocal)
    return pack_neighbours_prequant(q8, scales, graph, deg_p)


def pack_neighbours_prequant(
    q8: torch.Tensor, scales: torch.Tensor, graph: torch.Tensor, deg_p: int
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """pack_neighbours from int8 rows [N, d] and their scales [N]: the
    streamed IVF build quantises chunk by chunk and packs the int8 copy."""
    n, d = q8.shape
    groups, degree = graph.shape
    if deg_p > LANE:
        raise ValueError(
            f"packed adjacency supports degree <= {LANE} (got {degree}: "
            f"ids/scales are one {LANE}-lane row per node)"
        )
    pad_ids = graph.new_full((groups, deg_p - degree), -1)
    ids_p = torch.cat([graph.to(torch.int32), pad_ids.to(torch.int32)], dim=1)
    safe = ids_p.clamp(0, n - 1).long()
    real = ids_p >= 0
    # masked in place: the gathered table is the pack's one large
    # transient (N · deg_p · d bytes: 8.6 GB for the graph index at
    # 131072 x 64 x 1024)
    vecs = q8[safe.reshape(-1)].masked_fill_(~real.reshape(-1, 1), 0)
    if d % LANE:
        # zero int8 columns leave every dot unchanged; queries are padded
        # to match
        vecs = torch.nn.functional.pad(vecs, (0, -d % LANE))
    # pad scales 1.0: pad score lanes are -inf, and -inf * 0 would be NaN
    sc = torch.where(real, scales[safe], torch.ones_like(scales[safe]))
    if deg_p < LANE:
        ids_out = torch.cat(
            [ids_p, ids_p.new_full((groups, LANE - deg_p), -1)], dim=1
        )
        sc_out = torch.cat([sc, sc.new_ones((groups, LANE - deg_p))], dim=1)
    else:
        ids_out, sc_out = ids_p[:, :LANE], sc[:, :LANE]
    return vecs.contiguous(), ids_out.contiguous(), sc_out.contiguous()


def _pad_queries(queries: torch.Tensor, d: int) -> torch.Tensor:
    q = queries.to(torch.float32)
    if q.shape[1] != d:  # slabs are lane-padded at pack time
        q = torch.nn.functional.pad(q, (0, d - q.shape[1]))
    return q.contiguous()


def beam_expand_plain(
    sel_ids: torch.Tensor, queries: torch.Tensor, packed_vecs: torch.Tensor,
    packed_ids: torch.Tensor, packed_scales: torch.Tensor, deg_p: int,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain PyTorch version of kernel K: (sims [Q, E, 128] f32, nbr_ids
    [Q, E, 128] int32), lanes >= deg_p -inf. Node ids are clamped to the
    table, as the kernel does."""
    q_n, e = sel_ids.shape
    d = packed_vecs.shape[1]
    q = _pad_queries(queries, d)
    n_nodes = packed_ids.shape[0]
    nodes = sel_ids.long().clamp(0, n_nodes - 1)
    slabs = packed_vecs.view(n_nodes, deg_p, d)
    dots = torch.empty((q_n, e * deg_p), dtype=torch.float32, device=q.device)
    chunk = max(1, _PLAIN_BYTES // (e * deg_p * d * 4))
    for s in range(0, q_n, chunk):
        rows = slabs[nodes[s : s + chunk]].reshape(-1, e * deg_p, d)
        dots[s : s + chunk] = torch.bmm(
            rows.to(torch.float32), q[s : s + chunk, :, None]
        )[..., 0]
    sims = torch.full((q_n, e, LANE), float("-inf"), device=q.device)
    sims[:, :, :deg_p] = dots.view(q_n, e, deg_p)
    return sims * packed_scales[nodes], packed_ids[nodes]


def slab_plan(
    sel_ids: torch.Tensor, n_nodes: int
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Kernel K's node-major tile plan, with no host sync (graph search
    calls K in a loop). The Q·E pairs p = q·E + j are sorted stably by their
    clamped node (torch ops); each node's run is cut into tiles of at most
    NQ pairs: the tile kernel of csrc/slab_expand.cu on a CUDA tensor, its
    plain version here on a CPU tensor. → (order [Q·E] int32: pair ids in
    sorted order; nodes [Q·E] int32: their clamped nodes; tiles
    [2 + 4·t_max] int32: the counts of wide (more than NARROW pairs) and
    narrow tiles, then t_max slots of (first sorted position, pairs) for
    each kind: by position on the CPU, in no fixed order on the card).
    t_max = ⌈Q·E / NQ⌉ + min(N, Q·E) bounds either count from shapes
    alone."""
    pairs = sel_ids.numel()
    flat = sel_ids.reshape(-1).to(torch.int32).clamp(0, n_nodes - 1)
    nodes, order = torch.sort(flat, stable=True)
    t_max = -(-pairs // NQ) + min(n_nodes, pairs)
    tiles = torch.empty(2 + 4 * t_max, dtype=torch.int32, device=flat.device)
    if nodes.device.type == "cpu":
        pos = torch.arange(pairs)
        # each pair's rank in its node's run
        rank = pos - torch.searchsorted(nodes, nodes)
        starts = pos[rank % NQ == 0]
        ends = torch.minimum(starts + NQ,
                             torch.searchsorted(nodes, nodes[starts],
                                                right=True))
        rows = torch.stack([starts, ends - starts], dim=1)
        for kind, keep in enumerate((rows[:, 1] > NARROW,
                                     rows[:, 1] <= NARROW)):
            at = 2 + 2 * t_max * kind
            tiles[kind] = int(keep.sum())
            tiles[at : at + 2 * tiles[kind]] = rows[keep].reshape(-1)
    else:
        code = _build.library().knn_slab_tiles(
            nodes.data_ptr(), pairs, t_max, NARROW, tiles.data_ptr(),
            _build.stream_ptr(nodes.device))
        _build.check(code, "knn_slab_tiles")
    return order.to(torch.int32), nodes, tiles


def slab_route(q_n: int, e: int, n_nodes: int, d: int) -> str:
    """Kernel K's route (one of ROUTES) from shapes alone (no host sync):
    "pairs" where the queries fill the card and most probed nodes are
    probed by one pair, else "tiles". beam_expand looks it up at each
    call, so a test can hold K to one route by replacing it."""
    if (q_n >= PAIRS_MIN_Q and q_n * e <= PAIRS_MAX_SHARE * n_nodes
            and d <= PAIRS_MAX_D):
        return "pairs"
    return "tiles"


def beam_expand(
    sel_ids: torch.Tensor,  # [Q, E] int32 selected node ids in [0, N)
    queries: torch.Tensor,  # [Q, d] (cast to f32)
    packed_vecs: torch.Tensor,  # [N*deg_p, d] int8
    packed_ids: torch.Tensor,  # [N, 128] int32
    packed_scales: torch.Tensor,  # [N, 128] f32
    deg_p: int,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """→ (sims [Q, E, 128] f32 dequantised, nbr_ids [Q, E, 128] int32).
    Lanes >= deg_p carry -inf / the id table's padding."""
    tensors = (sel_ids, queries, packed_vecs, packed_ids, packed_scales)
    if any(t.device != packed_vecs.device for t in tensors):
        raise ValueError("all operands must be on one device")
    if sel_ids.dim() != 2 or packed_vecs.dtype != torch.int8 or (
        packed_ids.dtype != torch.int32 or packed_scales.dtype != torch.float32
    ):
        raise TypeError("need sel [Q, E], int8 slabs, int32 ids, f32 scales")
    n_nodes = packed_ids.shape[0]
    if packed_vecs.shape[0] != n_nodes * deg_p or packed_ids.shape != (
        n_nodes, LANE
    ) or packed_scales.shape != (n_nodes, LANE):
        raise ValueError("packed tables do not match one slab layout")
    if packed_vecs.device.type == "cpu":
        return beam_expand_plain(sel_ids, queries, packed_vecs, packed_ids,
                                 packed_scales, deg_p)
    q_n, e = sel_ids.shape
    d = packed_vecs.shape[1]
    q = _pad_queries(queries, d)
    sims = torch.empty((q_n, e, LANE), dtype=torch.float32, device=q.device)
    nbrs = torch.empty((q_n, e, LANE), dtype=torch.int32, device=q.device)
    if q_n == 0 or e == 0:
        return sims, nbrs
    route = slab_route(q_n, e, n_nodes, d)
    tables = (packed_vecs.contiguous().data_ptr(),
              packed_ids.contiguous().data_ptr(),
              packed_scales.contiguous().data_ptr())
    if route == "pairs":
        sel = sel_ids.to(torch.int32).contiguous()
        code = _build.library().knn_slab_expand_pairs(
            sel.data_ptr(), q.data_ptr(), *tables, sims.data_ptr(),
            nbrs.data_ptr(), q_n, e, d, deg_p, n_nodes,
            _build.stream_ptr(q.device),
        )
        _build.check(code, "knn_slab_expand_pairs")
    else:
        order, nodes, tiles = slab_plan(sel_ids, n_nodes)
        code = _build.library().knn_slab_expand(
            q.data_ptr(), *tables, order.data_ptr(), nodes.data_ptr(),
            tiles.data_ptr(), sims.data_ptr(), nbrs.data_ptr(), q_n, e, d,
            deg_p, n_nodes, (tiles.numel() - 2) // 4,
            _build.stream_ptr(q.device),
        )
        _build.check(code, "knn_slab_expand")
    if not torch.cuda.is_current_stream_capturing():
        beam_expand.launches += 1
        beam_expand.routes[route] += 1
    return sims, nbrs


# launches made on the spot: a call inside a CUDA graph's capture records
# its launch into the graph and counts nothing (GraphIndex.graph_replays)
beam_expand.launches = 0
# launches by route; each call counts once in launches and once here
beam_expand.routes = dict.fromkeys(ROUTES, 0)
