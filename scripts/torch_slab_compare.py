#!/usr/bin/env python3
"""Kernel K (the slab expansion) of one checkout of the PyTorch port, on one
NVIDIA GPU, at several sharing levels and on the IVF index's online batch,
so that two checkouts (a parent and its change) can be timed in turns in
one call:

    python3 scripts/torch_slab_compare.py --root <checkout> [--label L]
    python3 scripts/torch_slab_compare.py --sweep   # this checkout's routes

The slab tables hold random members (64 a cell) of chip_smoke.py phase 3's
131072 x 1024 clustered train vectors (seed 0, l2-normalised), packed at
deg_p = 128. Kernel K (slab_cuda.beam_expand, the whole wrapper) is timed
with chip_smoke.cuda_ms at:

  * a: 4096 queries x 32 probes, uniform over 2048 cells (~64 pairs a node);
  * b: 256 queries x 32 probes, uniform (phase 9's online shape, ~4);
  * c: 64 queries x 32 probes, every cell probed exactly once;
  * d: 256 queries x 32 probes, uniform over 16384 cells (~0.5 pairs a
    node: the online batch of an index 8x phase 9's);
  * g: a beam step of the reference's GraphIndex at its defaults (degree
    42, so deg_p = 64; expand = 8): 1024 queries expanding 8 nodes each of
    a 65536-node table (random neighbours from the train vectors), about
    0.125 pairs a node.

Each case's ids must equal the plain version's, its -inf lanes too, and its
sims lie within 1e-5 of the largest |sim|. Each case's device time per call
under torch.profiler is split into K's expansion kernels (slab_expand*)
and the rest of the wrapper (the plan: casts, the sort, K's tile cut).
Then the online batch: IVFIndex(cosine, nprobe=32) over the train vectors
with its automatic 2048 cells and with 16384, 256 test queries at k = 10
through the per-probe path, host wall (median of 5 after a warm call).

--sweep times this checkout's routes and launches apart, each held to the
plain version as above: the tile route with its narrow launch (tiles of at
most 16 pairs), the tile route in one launch (slab_cuda.NARROW = 0: the
tiles of at most 16 pairs then run as n32 products of the wide launch), and
the pair route, over 64-4096 queries x 32 probes on 2048-32768 cells and
over GraphIndex's shape at 256-4096 queries; then the 16384-cell online
batch on each route.

The checkout's package and chip_smoke.py are imported from --root (each
builds its own kernels there), so the parent's code runs as it was. Prints
the card (nvidia-smi name, power limit) and one JSON line.
"""

import argparse
import json
import statistics
import sys
import time
from pathlib import Path

from torch_topk_compare import train_test

FILL, PROBES = 64, 32
GRAPH_NODES, GRAPH_DEGREE, GRAPH_EXPAND = 65536, 42, 8
K_RTOL = 1e-5


def device_split(fn, reps=5):
    """{"expand": ms, "rest": ms}: device time per call under
    torch.profiler, K's expansion kernels apart from the rest."""
    import torch

    fn()
    torch.cuda.synchronize()
    acts = [torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    split = {"expand": 0.0, "rest": 0.0}
    for ev in prof.key_averages():
        us = getattr(ev, "device_time_total", None)
        if us is None:
            us = ev.cuda_time_total
        split["expand" if "slab_expand" in ev.key else "rest"] += us
    return {k: v / reps / 1e3 for k, v in split.items()}


def check(slab_cuda, kargs, name):
    """K against its plain version on kargs: ids and -inf lanes equal, sims
    within K_RTOL of the largest |sim|. Returns the max abs error."""
    import torch

    got_s, got_n = slab_cuda.beam_expand(*kargs)
    want_s, want_n = slab_cuda.beam_expand_plain(*kargs)
    fin = torch.isfinite(want_s)
    assert torch.equal(got_n, want_n), f"K {name}: ids differ"
    assert torch.equal(fin, torch.isfinite(got_s)), f"K {name}: -inf lanes"
    err = float((got_s[fin] - want_s[fin]).abs().max())
    assert err <= K_RTOL * float(want_s[fin].abs().max()), (name, err)
    return err


def online_ms(index, online, reps=5):
    """Host wall (ms) of index.search(online, 10): median of reps after a
    warm call."""
    import torch

    assert online.shape[0] < index.UNION_MIN_Q
    index.search(online, 10)
    walls = []
    for _ in range(reps):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        index.search(online, 10)
        torch.cuda.synchronize()
        walls.append(time.perf_counter() - t0)
    return statistics.median(walls) * 1e3


def main():
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--root", type=Path,
                   default=Path(__file__).resolve().parent.parent)
    p.add_argument("--label", default="")
    p.add_argument("--sweep", action="store_true",
                   help="time this checkout's routes and launches apart")
    args = p.parse_args()
    sys.path.insert(0, str(args.root.resolve()))

    import torch

    if not torch.cuda.is_available():
        raise SystemExit("needs a CUDA device")
    from chip_smoke import card_line, cuda_ms, warm_card
    from knn_for_homology_tpu_torch.ops import _build, slab_cuda
    from knn_for_homology_tpu_torch.ops.distance import l2_normalize
    from knn_for_homology_tpu_torch.search.ivf import IVFIndex

    _build.library()
    train, test = train_test()
    db = l2_normalize(torch.from_numpy(train).cuda()).contiguous()
    q_all = l2_normalize(torch.from_numpy(test).cuda()).contiguous()
    out = dict(label=args.label, root=str(args.root), card=card_line())
    gen = torch.Generator("cuda").manual_seed(11)

    def cell_table(cells):
        members = torch.full((cells, 128), -1, dtype=torch.int32,
                             device="cuda")
        members[:, :FILL] = torch.randint(
            0, db.shape[0], (cells, FILL), generator=gen, device="cuda",
            dtype=torch.int32)
        return (*slab_cuda.pack_neighbours(db, members, 128), 128)

    def uniform(q_n, e, n):
        return torch.randint(0, n, (q_n, e), generator=gen, device="cuda",
                             dtype=torch.int32)

    graph = torch.randint(0, db.shape[0], (GRAPH_NODES, GRAPH_DEGREE),
                          generator=gen, device="cuda", dtype=torch.int32)
    deg_p = slab_cuda.pad_degree(GRAPH_DEGREE)
    graph_table = (*slab_cuda.pack_neighbours(db, graph, deg_p), deg_p)
    del graph
    warm_card()

    if args.sweep:
        variants = {"tiles": dict(route="tiles", narrow=slab_cuda.NARROW),
                    "tiles_one_launch": dict(route="tiles", narrow=0),
                    "pairs": dict(route="pairs", narrow=slab_cuda.NARROW)}
        narrow0, route0 = slab_cuda.NARROW, slab_cuda.slab_route
        rows = []
        shapes = [(cells, q_n, PROBES) for cells in (2048, 8192, 16384, 32768)
                  for q_n in (64, 256, 1024, 4096)]
        shapes += [(GRAPH_NODES, q_n, GRAPH_EXPAND) for q_n in (256, 1024,
                                                                4096)]
        tables = {}
        for cells, q_n, e in shapes:
            if cells not in tables:
                tables.clear()
                torch.cuda.empty_cache()
                tables[cells] = (graph_table if cells == GRAPH_NODES
                                 else cell_table(cells))
            table = tables[cells]
            sel = uniform(q_n, e, cells)
            kargs = (sel, q_all[:q_n].contiguous(), *table)
            row = dict(cells=cells, deg_p=table[-1], queries=q_n, probes=e,
                       pairs_per_node=q_n * e / cells,
                       auto=slab_cuda.slab_route(q_n, e, cells,
                                                 table[0].shape[1]))
            for name, v in variants.items():
                slab_cuda.NARROW = v["narrow"]
                slab_cuda.slab_route = lambda *a, _r=v["route"]: _r
                check(slab_cuda, kargs, f"{cells}/{q_n}/{name}")
                row[name] = cuda_ms(lambda: slab_cuda.beam_expand(*kargs))
            slab_cuda.NARROW, slab_cuda.slab_route = narrow0, route0
            rows.append(row)
            print(json.dumps(row), flush=True)
        out["sweep"] = rows
        del tables, graph_table
        torch.cuda.empty_cache()
        index = IVFIndex(metric="cosine", nprobe=PROBES, n_clusters=16384,
                         device="cuda").add(train)
        for name in ("auto", "tiles", "pairs"):
            if name != "auto":
                slab_cuda.slab_route = lambda *a, _r=name: _r
            out[f"online_16384c_{name}_ms"] = online_ms(index, test[:256])
            slab_cuda.slab_route = route0
        print(json.dumps(out), flush=True)
        return

    t2048 = cell_table(2048)
    cases = {
        "a": (uniform(4096, PROBES, 2048), t2048),
        "b": (uniform(256, PROBES, 2048), t2048),
        "c": (torch.randperm(2048, generator=gen, device="cuda").view(
            2048 // PROBES, PROBES).to(torch.int32), t2048),
        "d": (uniform(256, PROBES, 16384), cell_table(16384)),
        "g": (uniform(1024, GRAPH_EXPAND, GRAPH_NODES), graph_table),
    }
    for name, (sel, table) in cases.items():
        kargs = (sel, q_all[:sel.shape[0]].contiguous(), *table)
        out[f"K_{name}_err"] = check(slab_cuda, kargs, name)
        out[f"K_{name}_ms"] = cuda_ms(lambda: slab_cuda.beam_expand(*kargs))
        out[f"K_{name}_device_ms"] = device_split(
            lambda: slab_cuda.beam_expand(*kargs))
    del db, q_all, cases, t2048, graph_table
    torch.cuda.empty_cache()

    for cells in (0, 16384):
        index = IVFIndex(metric="cosine", nprobe=PROBES, n_clusters=cells,
                         device="cuda").add(train)
        out[f"online_{cells or 2048}c_ms"] = online_ms(index, test[:256])
        del index
    print(json.dumps(out), flush=True)


if __name__ == "__main__":
    main()
