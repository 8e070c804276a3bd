"""Search a batch of queries (the database configuration's test proteins)
against its train proteins and rescore the hits by Smith-Waterman: each call is `FlatIndex.search` at the cell's k on one
batch of query vectors, then `ops/align.py:align_hits` on each query's hit
sequences, then each query's hits ranked by E-value (ascending, kNN order
on ties) with those above the cutoff dropped, as
`search/rescore.py:align_rescore` ranks them. One client, closed loop: the
next batch is sent when the last one's ranked hits are on the host.

Cell keys: "database" (the configuration of the vectors and sequences),
"queries_per_call" (the test proteins, the queries, are dealt into batches by
length, so every batch holds the same length mix; the batches cycle in an
order drawn from the seed), "hits", "e_value_cutoff", "warm_calls", "check_queries",
"check_pairs" (the sample the check compares; the pair of most DP cells is
always in it).
"""

import numpy as np
import torch

from portbench.lib import traffic
from portbench.reference import search as ref_search
from portbench.reference import sw as ref_sw


def setup(ctx):
    from knn_for_homology_tpu_torch.search.flat import FlatIndex

    cell, dev = ctx.cell, ctx.device
    data = traffic.database(ctx.config, ctx.seed, dev, with_sequences=True)
    rows, members = data["train"], data["train_seqs"]
    queries, held_out = data["test"], data["test_seqs"]
    ctx.mark("inputs")
    index = FlatIndex(metric=ctx.config["metric"], device=dev)
    index.add(rows.cpu().numpy())
    ctx.mark("program")
    per = cell["queries_per_call"]
    # batches dealt by query length, so that every batch holds the same mix
    # of lengths whatever the seed; the seed orders the batches and each
    # batch's queries
    by_len = np.argsort([len(s) for s in held_out], kind="stable")
    n_batches = len(by_len) // per
    gen = traffic.rng(ctx.seed, 7)
    order = np.concatenate([gen.permutation(by_len[b::n_batches][:per])
                            for b in gen.permutation(n_batches)])
    state = {
        "index": index, "rows": rows, "queries": queries.cpu().numpy(),
        "members": members, "held_out": held_out, "order": order,
        "per": per, "hits": cell["hits"], "cutoff": cell["e_value_cutoff"],
        "db_residues": float(sum(len(s) for s in members)),
        "recorder": ctx.recorder, "device": dev, "out": [], "info": {},
    }
    for i in range(cell["warm_calls"]):
        step(state, i)
    state["out"].clear()
    if ctx.recorder.traced:
        state["info"]["cells"] = []  # real DP cells of each call
    return state


def batch_of(state, i):
    n, per = len(state["order"]), state["per"]
    return state["order"][np.arange(i * per, (i + 1) * per) % n]


def step(state, i):
    from knn_for_homology_tpu_torch.ops.align import align_hits

    rec = state["recorder"]
    q_idx = batch_of(state, i)
    with rec.span("search"):
        scores, ids = state["index"].search(state["queries"][q_idx],
                                            state["hits"])
    with rec.span("align"):
        queries = [state["held_out"][q] for q in q_idx]
        hits = [[state["members"][h] for h in row if h >= 0] for row in ids]
        sw, evs = align_hits(queries, hits, db_residues=state["db_residues"],
                             device=state["device"])
        ranked = []
        for row, ev in zip(ids, evs):
            order = np.argsort(ev, kind="stable")
            keep = order[ev[order] <= state["cutoff"]]
            ranked.append(row[row >= 0][keep])
    state["out"].append((q_idx, ids, sw, evs, ranked, scores))
    if "cells" in state["info"]:
        state["info"]["cells"].append(sum(
            len(q) * len(t) for q, row in zip(queries, hits) for t in row))
    return {"units": len(q_idx), "queries": len(q_idx)}


def release(state):
    keep = ("rows", "queries", "members", "held_out", "out", "db_residues")
    out = {k: state[k] for k in keep}
    state.clear()
    return out


def readings(ctx, out, control=False):
    """hit_err: the widest gap of a returned hit below the exact float64
    top-k of its query, or of a returned score from its hit's exact cosine
    (the control: a TF32 product's top-k, with its scores).
    sw_abs_err: the widest difference of a sampled pair's score from the
    reference's (exact integers; the control: 8-bit saturating scores).
    evalue_rel_err: the widest relative difference of a sampled pair's
    E-value from the reference's float32 one on its own scores (relative to
    the larger of the two, and to float32's least normal number). The
    sample is drawn from the seed."""
    dev, k, cell = ctx.device, ctx.cell["hits"], ctx.cell
    gen = traffic.rng(ctx.seed, 8)
    if not out["out"]:
        return {"hit_err": float("inf"), "sw_abs_err": float("inf"),
                "evalue_rel_err": float("inf")}
    flat_q = np.concatenate([o[0] for o in out["out"]])
    flat_ids = np.concatenate([o[1] for o in out["out"]])
    flat_scores = np.concatenate([o[5] for o in out["out"]])
    pick = gen.choice(len(flat_q), min(cell["check_queries"], len(flat_q)),
                      replace=False)
    q = torch.from_numpy(out["queries"][flat_q[pick]]).to(dev)
    if control:
        sims = ref_search.tf32_round(ref_search.normalized64(q).float()) @ \
            ref_search.tf32_round(ref_search.normalized64(out["rows"])
                                  .float()).T
        scores, ids = sims.topk(k, dim=1)
    else:
        ids = torch.from_numpy(flat_ids[pick]).to(dev)
        scores = flat_scores[pick]
    hit = ref_search.hit_err(q, out["rows"], ids, scores, k)

    pairs = [(b, r, j) for b, o in enumerate(out["out"])
             for r in range(len(o[0])) for j in range(len(o[2][r]))]

    def seqs(p):
        b, r, j = p
        q_idx, ids_b = out["out"][b][0], out["out"][b][1]
        hit_rows = ids_b[r][ids_b[r] >= 0]
        return out["held_out"][q_idx[r]], out["members"][hit_rows[j]]

    cells = [len(a) * len(b) for a, b in map(seqs, pairs)]
    biggest = int(np.argmax(cells))
    n = min(cell["check_pairs"], len(pairs))
    chosen = [biggest] + [j for j in gen.choice(len(pairs), n, replace=False)
                          if j != biggest][:n - 1]
    qs, ts = zip(*(seqs(pairs[j]) for j in chosen))
    want = ref_sw.scores(list(qs), list(ts), dev)
    if control:
        got = ref_sw.scores(list(qs), list(ts), dev, cap=127)
        got_ev = ref_sw.e_values(got, [len(s) for s in qs],
                                 out["db_residues"])
    else:
        got = np.asarray([out["out"][pairs[j][0]][2][pairs[j][1]][pairs[j][2]]
                          for j in chosen], np.float64)
        got_ev = np.asarray(
            [out["out"][pairs[j][0]][3][pairs[j][1]][pairs[j][2]]
             for j in chosen], np.float64)
    want_ev = ref_sw.e_values(want, [len(s) for s in qs],
                              out["db_residues"]).astype(np.float64)
    tiny = float(np.finfo(np.float32).tiny)
    denom = np.maximum(np.maximum(np.abs(got_ev), np.abs(want_ev)), tiny)
    return {
        "hit_err": hit,
        "sw_abs_err": float(np.max(np.abs(np.asarray(got, np.float64)
                                          - want))),
        "evalue_rel_err": float(np.max(np.abs(got_ev - want_ev) / denom)),
    }
