"""Embed proteins with ProtT5 and search the pooled vectors against a
database's train proteins: each call is `ProtT5Embedder.embed_pooled` on one batch of
proteins, then `FlatIndex.search` at the cell's k, both returning host
arrays.

Cell keys: "database" (a configuration of database vectors),
"units_per_call" (proteins a call), "lengths" (their length set, see
lib/traffic.lengths_of: every call holds the same lengths in another
order, so every call runs the same batch shapes), "pool_calls"
(distinct calls made in set-up, then cycled), "hits", "token_budget",
"max_len", "check_proteins" and "check_queries" (the sample the check
compares, drawn from the seed; the longest protein is always in it).
"""

import numpy as np
import torch

from portbench.lib import traffic
from portbench.reference import search as ref_search
from portbench.reference import t5 as ref_t5


def t5_config(cfg: dict):
    from knn_for_homology_tpu_torch.models import t5

    return t5.T5Config(
        vocab_size=cfg["vocab_size"], d_model=cfg["d_model"],
        d_kv=cfg["d_kv"], d_ff=cfg["d_ff"], num_layers=cfg["num_layers"],
        num_heads=cfg["num_heads"],
        rel_buckets=cfg["relative_attention_num_buckets"],
        rel_max_distance=cfg["relative_attention_max_distance"],
        layer_norm_eps=cfg["layer_norm_epsilon"],
        dtype=getattr(torch, cfg["serving_dtype"]),
    )


def setup(ctx):
    from knn_for_homology_tpu_torch.models.registry import ProtT5Embedder
    from knn_for_homology_tpu_torch.search.flat import FlatIndex

    cell, cfg, dev = ctx.cell, ctx.config, ctx.device
    db_cfg = ctx.config_of(cell["database"])
    weights = traffic.t5_weights(cfg, ctx.seed, dev,
                                 getattr(torch, cfg["serving_dtype"]))
    rows = traffic.database(db_cfg, ctx.seed, dev)["train"]
    lengths = traffic.lengths_of(cell["lengths"])
    gen = traffic.rng(ctx.seed, 4)
    pool = [traffic.random_sequences(gen, gen.permutation(lengths))
            for _ in range(cell["pool_calls"])]
    ctx.mark("inputs")
    embedder = ProtT5Embedder(config=t5_config(cfg), params=weights,
                              token_budget=cell["token_budget"],
                              max_len=cell["max_len"], device=dev)
    index = FlatIndex(metric=db_cfg["metric"], device=dev)
    index.add(rows.cpu().numpy())
    ctx.mark("program")
    state = {"embedder": embedder, "index": index, "pool": pool,
             "weights": weights, "rows": rows, "recorder": ctx.recorder,
             "hits": cell["hits"], "out": [], "max_len": cell["max_len"]}
    batches = embedder.batches(pool[0])
    state["info"] = {
        "lengths": [min(n, cell["max_len"]) for n in lengths],
        "batches": [(len(b.sequences), b.padded_len) for b in batches],
    }
    # every call holds the same lengths, so this call warms every shape
    embedder.embed_pooled(pool[0])
    index.search(np.zeros((len(pool[0]), db_cfg["dim"]), np.float32),
                 cell["hits"])
    return state


def step(state, i):
    seqs = state["pool"][i % len(state["pool"])]
    rec = state["recorder"]
    with rec.span("embed"):
        pooled = state["embedder"].embed_pooled(seqs)
    with rec.span("search"):
        scores, ids = state["index"].search(pooled, state["hits"])
    state["out"].append((i % len(state["pool"]), pooled, ids, scores))
    residues = sum(min(len(s), state["max_len"]) for s in seqs)
    return {"units": len(seqs), "residues": residues}


def release(state):
    out = {k: state[k] for k in ("pool", "weights", "rows", "out", "max_len")}
    state.clear()
    return out


def sample(ctx, out):
    """(proteins, queries) the check compares: [(call, pos)] drawn from the
    seed among the window's proteins, the longest first."""
    gen = traffic.rng(ctx.seed, 5)
    done = [(c, p) for c, (pool_i, *_) in enumerate(out["out"])
            for p in range(len(out["pool"][pool_i]))]
    if not done:
        return [], []
    length = [len(out["pool"][out["out"][c][0]][p]) for c, p in done]
    longest = done[int(np.argmax(length))]
    n_p = min(ctx.cell["check_proteins"], len(done))
    n_q = min(ctx.cell["check_queries"], len(done))
    picks = [done[j] for j in gen.choice(len(done), n_p, replace=False)]
    proteins = [longest] + [d for d in picks if d != longest][:n_p - 1]
    queries = [done[j] for j in gen.choice(len(done), n_q, replace=False)]
    return proteins, queries


@torch.no_grad()
def readings(ctx, out, control=False):
    """pooled_rel_err: the widest relative L2 gap of a sampled protein's
    pooled vector from the float32 reference's (the control: the reference
    on fp8 operands). hit_err: the widest gap of a returned hit below the
    exact float64 top-k of the program's own pooled vectors, or of a
    returned score from its hit's exact cosine (the control: the top-k of
    a TF32 product, with its scores)."""
    proteins, queries = sample(ctx, out)
    if not proteins:
        return {"pooled_rel_err": float("inf"), "hit_err": float("inf")}
    cfg, dev, k = ctx.config, ctx.device, ctx.cell["hits"]
    max_len = out["max_len"]
    seqs = [out["pool"][out["out"][c][0]][p][:max_len] for c, p in proteins]
    want = ref_t5.pooled(out["weights"], seqs, cfg)
    if control:
        got = ref_t5.pooled(out["weights"], seqs, cfg, quant=ref_t5.fp8_round)
    else:
        got = torch.from_numpy(np.stack(
            [out["out"][c][1][p] for c, p in proteins])).to(dev)
    rel = ((got.double() - want.double()).norm(dim=1)
           / want.double().norm(dim=1))
    q = torch.from_numpy(np.stack(
        [out["out"][c][1][p] for c, p in queries])).to(dev)
    if control:
        sims = ref_search.tf32_round(ref_search.normalized64(q).float()) @ \
            ref_search.tf32_round(ref_search.normalized64(out["rows"])
                                  .float()).T
        scores, ids = sims.topk(k, dim=1)
    else:
        ids = torch.from_numpy(np.stack(
            [out["out"][c][2][p] for c, p in queries])).to(dev)
        scores = np.stack([out["out"][c][3][p] for c, p in queries])
    err = ref_search.hit_err(q, out["rows"], ids, scores, k)
    return {"pooled_rel_err": float(rel.max()), "hit_err": err}
