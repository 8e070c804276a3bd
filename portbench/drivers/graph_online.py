"""Online search of new proteins against an embedded database through the
program's graph index, the reference's HNSW mode (`pfam/proteins_search.py`:
M 42, efSearch 256): `search/graph.py:GraphIndex(metric, degree,
beam_width)`, packed "auto" (kernel K scores the beam's neighbours on the
card), built in set-up over every protein of the database configuration,
as the reference indexes them all. Each call is one `GraphIndex.search` of
a batch of test proteins' vectors at the cell's k, from host vectors to the
[queries, k] scores and ids on the host.

Cell keys: "queries_per_call" (a batch; the test proteins make as many
distinct batches as they fill, dealt from the seed, then cycled), "k",
"degree", "beam_width", "check_queries" (the window's queries the check
compares, drawn from the seed).
"""

import numpy as np
import torch

from portbench.lib import traffic
from portbench.reference import search as ref_search


def setup(ctx):
    from knn_for_homology_tpu_torch.search.graph import GraphIndex

    cell, cfg, dev = ctx.cell, ctx.config, ctx.device
    db = traffic.database(cfg, ctx.seed, dev)
    raw = db["all"]
    test = db["test"].cpu().numpy()
    per = cell["queries_per_call"]
    order = traffic.rng(ctx.seed, 10).permutation(len(test))
    batches = [np.ascontiguousarray(test[order[i:i + per]])
               for i in range(0, len(test) - per + 1, per)]
    ctx.mark("inputs")
    index = GraphIndex(metric=cfg["metric"], degree=cell["degree"],
                       beam_width=cell["beam_width"], device=dev)
    index.add(raw.cpu().numpy())
    ctx.mark("program")
    state = {"index": index, "raw": raw, "batches": batches, "k": cell["k"],
             "recorder": ctx.recorder, "out": []}
    step(state, 0)  # packs the neighbours' slabs, warms the batch's shapes
    state["out"].clear()
    return state


def step(state, i):
    b = i % len(state["batches"])
    with state["recorder"].span("search"):
        scores, ids = state["index"].search(state["batches"][b], state["k"])
    state["out"].append((b, scores, ids))
    return {"units": ids.shape[0], "queries": ids.shape[0]}


def release(state):
    out = {k: state[k] for k in ("raw", "batches", "out", "k")}
    state.clear()
    return out


@torch.no_grad()
def readings(ctx, out, control=False):
    """miss_share: 1 - recall@k of the returned ids against the exact
    float64 cosine top-k over every row (a returned row counts where its
    cosine reaches the k-th best: ties of any order read as found; a
    repeated or missing id does not), over queries of the window drawn from
    the seed. score_abs_err: the widest distance of a returned score from
    its hit's float64 cosine. The control is the exact top-k under int4
    quantisation of rows and queries, with its dequantised scores."""
    k = out["k"]
    done = [(c, r) for c, (b, _, ids) in enumerate(out["out"])
            for r in range(ids.shape[0])]
    if not done:
        return {"miss_share": float("inf"), "score_abs_err": float("inf")}
    gen = traffic.rng(ctx.seed, 11)
    picks = [done[j] for j in np.sort(gen.choice(
        len(done), min(ctx.cell["check_queries"], len(done)), replace=False))]
    rows = out["raw"]
    q = torch.from_numpy(np.stack(
        [out["batches"][out["out"][c][0]][r] for c, r in picks])).to(rows.device)
    exact = ref_search.cosine_scores(q, rows)  # [Q, N] float64
    kth = exact.topk(k, dim=1).values[:, -1:]
    if control:
        scores, ids = ref_search.quantized_topk(
            ref_search.normalized64(q), ref_search.normalized64(rows), k, 7)
    else:
        ids = torch.from_numpy(np.stack(
            [out["out"][c][2][r] for c, r in picks])).to(rows.device)
        scores = torch.from_numpy(np.stack(
            [out["out"][c][1][r] for c, r in picks])).to(rows.device)
    ids = ids.long()
    ok = (ids >= 0) & (ids < rows.shape[0])
    got = exact.gather(1, ids.clamp(0, rows.shape[0] - 1))
    got = ref_search.unique_or_neginf(ids, torch.where(ok, got, -torch.inf))
    found = (got >= kth).sum(dim=1).double() / k
    off = (scores.double() - got).abs()
    off = torch.where(torch.isfinite(got), off, torch.inf)
    return {"miss_share": float(1 - found.mean()),
            "score_abs_err": float(off.max())}
