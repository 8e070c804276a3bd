"""Kernel K's node-major tile plan (ops/slab_cuda.py:slab_plan) on the CPU.

The plan must cover every (query, probe) pair exactly once, in tiles of at
most NQ pairs of one (clamped) node, as few as the runs allow and within
the t_max bound the kernel's grid is sized from (on the CPU the tile cut is
the plain version of the card's tile kernel); and scoring the slabs tile by
tile through it, in plain torch, must give beam_expand_plain's sims and ids
(fp32 sums of the same products in another order: 1e-5 of the largest
|sim|, the kernel's own tolerance).
"""

import numpy as np
import pytest
import torch

from knn_for_homology_tpu_torch.ops import slab_cuda

K_RTOL = 1e-5
N_NODES = 50


def _sel(case, rng):
    """[Q, E] node ids of one sharing pattern over N_NODES nodes."""
    if case == "random":
        return rng.randint(0, N_NODES, size=(33, 7))
    if case == "one_node":  # every query probes the same node
        return np.full((150, 4), 17)
    if case == "crowded":  # node 7 probed by more than NQ queries
        sel = rng.randint(0, N_NODES, size=(150, 5))
        sel[:, 0] = 7
        return sel
    if case == "each_once":  # every node probed once
        return rng.permutation(N_NODES).reshape(10, 5)
    if case == "repeats":  # a node repeated within a query's selection
        sel = rng.randint(0, N_NODES, size=(40, 6))
        sel[:, 2] = sel[:, 0]
        sel[::3, 5] = sel[::3, 0]
        return sel
    if case == "out_of_range":  # clamped to [0, N_NODES)
        sel = rng.randint(0, N_NODES, size=(30, 6))
        sel[:, 1] = -3
        sel[::2, 4] = N_NODES
        sel[1::2, 5] = N_NODES + 100
        return sel
    raise ValueError(case)


CASES = ["random", "one_node", "crowded", "each_once", "repeats",
         "out_of_range"]


def tile_list(tiles):
    """(start, pairs) rows of a plan's tiles buffer, both lists, by start;
    the wide list's tiles hold more than NARROW pairs, the narrow list's
    at most NARROW."""
    t_max = (tiles.numel() - 2) // 4
    rows = []
    for kind in (0, 1):
        n, at = int(tiles[kind]), 2 + 2 * t_max * kind
        got = tiles[at : at + 2 * n].reshape(n, 2).tolist()
        assert all((c <= slab_cuda.NARROW) == bool(kind) for _, c in got)
        rows += got
    return sorted(map(tuple, rows))


def check_plan(sel, n_nodes, order, nodes, tiles):
    """Every pair once, stably grouped by clamped node; tiles contiguous
    from the first pair to the last, 1 .. NQ pairs of one node each, as few
    as the node runs allow, within the t_max bound."""
    pairs, nq = sel.numel(), slab_cuda.NQ
    t_max = -(-pairs // nq) + min(n_nodes, pairs)
    assert order.dtype == nodes.dtype == tiles.dtype == torch.int32
    assert tiles.shape == (2 + 4 * t_max,)
    assert sorted(order.tolist()) == list(range(pairs))
    want = sel.reshape(-1).long().clamp(0, n_nodes - 1)[order.long()]
    assert torch.equal(nodes.long(), want)
    assert bool((want[1:] >= want[:-1]).all())
    same = want[1:] == want[:-1]
    assert bool((order[1:][same] > order[:-1][same]).all())
    rows = tile_list(tiles)
    assert rows[0][0] == 0 and sum(c for _, c in rows) == pairs
    for (lo, c), (nxt, _) in zip(rows, rows[1:] + [(pairs, 0)]):
        assert 1 <= c <= nq and lo + c == nxt
        assert bool((want[lo:nxt] == want[lo]).all())
    counts = torch.bincount(want, minlength=n_nodes)
    assert len(rows) == int(((counts + nq - 1) // nq).sum()) <= t_max


@pytest.mark.parametrize("case", CASES)
def test_plan_covers_every_pair_once_in_node_tiles(case):
    sel = torch.from_numpy(_sel(case, np.random.RandomState(0)).astype(
        np.int32))
    check_plan(sel, N_NODES, *slab_cuda.slab_plan(sel, N_NODES))


def test_plan_cuts_long_runs_into_full_tiles():
    # one node probed 150 times: tiles of 64, 64, 22 pairs
    sel = torch.full((50, 3), 9, dtype=torch.int32)
    order, nodes, tiles = slab_cuda.slab_plan(sel, N_NODES)
    assert tile_list(tiles) == [(0, 64), (64, 64), (128, 22)]
    assert order.tolist() == list(range(150))


def _score_through_plan(sel, q, pv, pi, sc, deg_p):
    """beam_expand's function, tile by tile through slab_plan, as kernel K
    walks it: each tile reads its node's slab once for all its pairs."""
    q_n, e = sel.shape
    n_nodes, d = pi.shape[0], pv.shape[1]
    q = torch.nn.functional.pad(q, (0, d - q.shape[1]))
    order, nodes, tiles = slab_cuda.slab_plan(sel, n_nodes)
    sims = torch.empty((q_n * e, 128))
    nbrs = torch.empty((q_n * e, 128), dtype=torch.int32)
    for lo, c in tile_list(tiles):
        pairs = order[lo:lo + c].long()
        node = int(nodes[lo])
        slab = pv[node * deg_p:(node + 1) * deg_p].float()  # one read
        sims[pairs] = float("-inf")
        sims[pairs, :deg_p] = q[pairs // e] @ slab.T
        sims[pairs] *= sc[node]
        nbrs[pairs] = pi[node]
    return sims.view(q_n, e, 128), nbrs.view(q_n, e, 128)


@pytest.mark.parametrize("deg_p,degree", [(128, 100), (32, 20)])
@pytest.mark.parametrize("case", CASES)
def test_scoring_through_the_plan_equals_plain(case, deg_p, degree):
    rng = np.random.RandomState(1)
    d = 96
    db = torch.from_numpy(rng.randn(N_NODES * 20, d).astype(np.float32))
    members = np.full((N_NODES, degree), -1, np.int32)
    members[:, :20] = rng.permutation(N_NODES * 20).reshape(N_NODES, 20)
    pv, pi, sc = slab_cuda.pack_neighbours(db, torch.from_numpy(members),
                                           deg_p)
    sel = torch.from_numpy(_sel(case, rng).astype(np.int32))
    q = torch.from_numpy(rng.randn(sel.shape[0], d).astype(np.float32))
    got_s, got_n = _score_through_plan(sel, q, pv, pi, sc, deg_p)
    want_s, want_n = slab_cuda.beam_expand_plain(sel, q, pv, pi, sc, deg_p)
    assert torch.equal(got_n, want_n)
    assert torch.equal(torch.isneginf(got_s), torch.isneginf(want_s))
    fin = torch.isfinite(want_s)
    torch.testing.assert_close(got_s[fin], want_s[fin], rtol=K_RTOL,
                               atol=K_RTOL * float(want_s[fin].abs().max()))


@pytest.mark.parametrize("q_n,e,n_nodes,d,route", [
    (4096, 32, 2048, 1024, "tiles"),   # ~64 pairs a node
    (256, 32, 2048, 1024, "tiles"),    # phase 9's online batch, ~4
    (64, 32, 2048, 1024, "tiles"),     # each node once, too few queries
    (256, 32, 16384, 1024, "pairs"),   # ~0.5 pairs a node
    (1024, 8, 65536, 1024, "pairs"),   # a graph beam step, ~0.125
    # the graph index's beam step at k = 1000 (2048-query blocks over
    # 131072 nodes): measured faster on pairs at steps 20-61, slower only
    # at step 0 (PERF.md §6, graph findings)
    (2048, 8, 131072, 1024, "pairs"),
    (1024, 8, 65536, 16384, "tiles"),  # the query outgrows shared memory
])
def test_route_from_shapes(q_n, e, n_nodes, d, route):
    assert slab_cuda.slab_route(q_n, e, n_nodes, d) == route
