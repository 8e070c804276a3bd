"""All-vs-all search of a database at large k on int8 storage, through the
program's own entry: `search/flat.py:FlatIndex` with the "sq8" backend,
which quantises the database once, at the first search, and keeps it
(`ops/packed_cuda.py:quantize_database`). Each call is one
`FlatIndex.search` with every protein of the database configuration (its
train and test proteins, as `pfam/proteins_search.py` searches them all)
as a query, from host vectors to the [rows, k] scores and ids on the host,
as `pipelines/pfam_proteins.py:build_and_search` calls it.

Cell keys: "k", "recall_target" (the index's), "check_queries" (the rows
whose results the check compares in every pass, drawn from the seed).
"""

import numpy as np
import torch

from portbench.lib import traffic
from portbench.reference import search as ref_search


def setup(ctx):
    from knn_for_homology_tpu_torch.config import SearchConfig
    from knn_for_homology_tpu_torch.search.flat import FlatIndex

    cell, cfg = ctx.cell, ctx.config
    raw = traffic.database(cfg, ctx.seed, ctx.device)["all"]
    host = raw.cpu().numpy()
    n = host.shape[0]
    check = np.sort(traffic.rng(ctx.seed, 9).choice(
        n, min(cell["check_queries"], n), replace=False))
    ctx.mark("inputs")
    index = FlatIndex(
        metric=cfg["metric"], backend="sq8", device=ctx.device,
        config=SearchConfig(metric=cfg["metric"],
                            recall_target=cell["recall_target"]))
    index.add(host)
    ctx.mark("program")
    state = {"raw": raw, "host": host, "index": index, "k": cell["k"],
             "check": check, "recorder": ctx.recorder, "out": [],
             "info": {"rows": n, "dim": host.shape[1]}}
    step(state, 0)  # quantises the database, warms the pass's shapes
    state["out"].clear()
    return state


def step(state, i):
    with state["recorder"].span("pass"):
        sims, ids = state["index"].search(state["host"], state["k"])
    state["out"].append((sims[state["check"]], ids[state["check"]]))
    return {"units": ids.shape[0], "queries": ids.shape[0]}


def release(state):
    out = {k: state[k] for k in ("raw", "out", "check", "k")}
    state.clear()
    return out


@torch.no_grad()
def readings(ctx, out, control=False):
    """miss_share: 1 - recall of the returned ids against the exact top-k
    under the same int8 quantisation of rows and queries (a returned row
    counts where its quantised score reaches the k-th best; ties of any
    order read as found), over the checked rows of every pass; the config's
    recall target bounds it. score_abs_err: the widest difference of a
    returned score from that row's quantised score. The control is the
    exact top-k under int4 quantisation, judged the same way."""
    dev, k = ctx.device, out["k"]
    if not out["out"]:
        return {"miss_share": float("inf"), "score_abs_err": float("inf")}
    raw = out["raw"].float()
    rows = raw / raw.norm(dim=1, keepdim=True)
    q = rows[torch.as_tensor(out["check"], device=dev)]
    qc, qs = ref_search.quantize(q, 127)
    dc, ds = ref_search.quantize(rows, 127)
    exact = ref_search.quantized_scores(qc, qs, dc, ds)
    kth = exact.topk(k, dim=1).values[:, -1:]
    if control:
        c_vals, c_ids = ref_search.quantized_topk(q, rows, k, 7)
        passes = [(c_vals.cpu().numpy(), c_ids.cpu().numpy())]
    else:
        # every pass answers the same queries: each distinct answer is
        # judged once
        passes = []
        for sims, ids in out["out"]:
            if not any(np.array_equal(sims, s) and np.array_equal(ids, i)
                       for s, i in passes):
                passes.append((sims, ids))
    miss, err = [], 0.0
    for sims, ids in passes:
        ids_t = torch.as_tensor(ids, device=dev).long()
        got = ref_search.quantized_scores(qc, qs, dc, ds, ids_t)
        got = ref_search.unique_or_neginf(ids_t, got)
        found = (got >= kth).sum(dim=1).double() / k
        miss.append(float(1 - found.mean()))
        ok = torch.isfinite(got)
        diff = (torch.as_tensor(sims, device=dev).double() - got).abs()
        err = max(err, float(torch.where(ok, diff, torch.inf).max()))
    return {"miss_share": max(miss), "score_abs_err": err}
