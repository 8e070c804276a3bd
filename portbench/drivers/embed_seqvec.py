"""Embed proteins with SeqVec and search the pooled vectors against a
database's train proteins: each call is `SeqVecEmbedder.embed_pooled` on
one batch of proteins (the "SeqVec Sum" vectors, pooled on the device),
then `FlatIndex.search` at the cell's k, both returning host arrays. The
calls, the traffic and the hit check are embed_search's, with SeqVec in
ProtT5's place, its recurrence on kernel M.

Cell keys: those of embed_search ("database", "units_per_call",
"lengths", "pool_calls", "hits", "token_budget" (SeqVec's
max_batch_tokens), "max_len", "check_proteins", "check_queries"; only
the queries of embed_search.sample are used here: the checked proteins
are chosen by their place in kernel M's launches, `checked_rows`).
"""

import math

import numpy as np
import torch

from portbench.drivers import embed_search
from portbench.lib import traffic
from portbench.reference import search as ref_search
from portbench.reference import seqvec as ref_seqvec

step = embed_search.step


def elmo_config(cfg: dict):
    """The served route: the serving dtype, whose recurrence runs on
    kernel M (a program without the kernel's wrapper fails here, at once)."""
    from knn_for_homology_tpu_torch.models import elmo
    from knn_for_homology_tpu_torch.ops import lstm_cuda  # noqa: F401

    config = elmo.ElmoConfig(
        char_embed_dim=cfg["char_embed_dim"],
        filters=tuple(tuple(f) for f in cfg["filters"]),
        n_highway=cfg["n_highway"], proj_dim=cfg["proj_dim"],
        lstm_dim=cfg["lstm_dim"], n_lstm_layers=cfg["n_lstm_layers"],
        cell_clip=float(cfg["cell_clip"]), proj_clip=float(cfg["proj_clip"]),
        dtype=getattr(torch, cfg["serving_dtype"]),
    )
    if not elmo.serves_on_kernel(config):
        raise ValueError(f"{cfg['serving_dtype']} does not serve on kernel M")
    return config


def seqvec_weights(cfg: dict, seed: int, device, dtype=torch.bfloat16) -> dict:
    """Random SeqVec weights in the port's tree, drawn on the device from
    the seed: each LSTM's input and recurrent kernels (the halves of
    bilm-tf's one [in + proj, 4·cells] LSTMCell kernel) and its projection
    at TF1's Glorot-uniform default, LSTM biases 0; the character
    embedding normal x 1, the convolutions, highways and projection normal
    x 0.1, their biases 0 (the scales of the port's elmo.init_params). At
    these LSTM scales the recurrence is not chaotic: a one-ulp change of
    the weights stays a one-ulp-sized change of the output."""
    gen = traffic.torch_gen(seed, 8, device)
    e, proj, cells = cfg["char_embed_dim"], cfg["proj_dim"], cfg["lstm_dim"]
    total = sum(n for _, n in cfg["filters"])

    def normal(shape, scale):
        return torch.randn(shape, generator=gen, device=device).mul_(scale) \
            .to(dtype)

    def glorot(shape, fan):
        limit = math.sqrt(6.0 / fan)
        return torch.rand(shape, generator=gen, device=device).mul_(2) \
            .sub_(1).mul_(limit).to(dtype)

    def zeros(n):
        return torch.zeros((n,), dtype=dtype, device=device)

    def lstm_cell():
        fan = proj + proj + 4 * cells  # bilm-tf's [in + proj, 4 cells]
        return {"w_x": glorot((proj, 4 * cells), fan),
                "w_h": glorot((proj, 4 * cells), fan),
                "b": zeros(4 * cells),
                "w_proj": glorot((cells, proj), cells + proj)}

    layers = cfg["n_lstm_layers"]
    return {
        "char_embedding": normal((cfg["n_characters"], e), 1.0),
        "convs": [{"w": normal((width, e, n), 0.1), "b": zeros(n)}
                  for width, n in cfg["filters"]],
        "highways": [{"w_gate": normal((total, total), 0.1),
                      "b_gate": zeros(total),
                      "w_lin": normal((total, total), 0.1),
                      "b_lin": zeros(total)}
                     for _ in range(cfg["n_highway"])],
        "proj_w": normal((total, proj), 0.1),
        "proj_b": zeros(proj),
        "lstm_fwd": [lstm_cell() for _ in range(layers)],
        "lstm_bwd": [lstm_cell() for _ in range(layers)],
    }


def setup(ctx):
    from knn_for_homology_tpu_torch.models.registry import SeqVecEmbedder
    from knn_for_homology_tpu_torch.search.flat import FlatIndex

    cell, cfg, dev = ctx.cell, ctx.config, ctx.device
    config = elmo_config(cfg)
    db_cfg = ctx.config_of(cell["database"])
    weights = seqvec_weights(cfg, ctx.seed, dev, config.dtype)
    rows = traffic.database(db_cfg, ctx.seed, dev)["train"]
    lengths = traffic.lengths_of(cell["lengths"])
    gen = traffic.rng(ctx.seed, 4)
    pool = [traffic.random_sequences(gen, gen.permutation(lengths))
            for _ in range(cell["pool_calls"])]
    ctx.mark("inputs")
    embedder = SeqVecEmbedder(config=config, params=weights,
                              max_batch_tokens=cell["token_budget"],
                              device=dev)
    index = FlatIndex(metric=db_cfg["metric"], device=dev)
    index.add(rows.cpu().numpy())
    ctx.mark("program")
    state = {"embedder": embedder, "index": index, "pool": pool,
             "weights": weights, "rows": rows, "recorder": ctx.recorder,
             "hits": cell["hits"], "out": [], "max_len": cell["max_len"],
             "seed": ctx.seed}
    # every call holds the same lengths, so this call warms every shape
    embedder.embed_pooled(pool[0])
    index.search(np.zeros((len(pool[0]), db_cfg["dim"]), np.float32),
                 cell["hits"])
    return state


TILE = 16  # rows of one m-tile of kernel M's launch


def checked_rows(n: int, gen) -> list:
    """Sorted rows of an n-row launch (longest first, as M sorts them) the
    check compares: the first, the last, and one drawn in each m-tile."""
    drawn = [int(gen.integers(t, min(t + TILE, n)))
             for t in range(0, n, TILE)]
    return sorted({0, n - 1, *drawn})


@torch.no_grad()
def encode_recurrence(embedder, seqs, picks: dict) -> list:
    """embedder.embed_pooled(seqs) with kernel M's wrapper hooked (the
    encoder looks up ops/lstm_cuda.py's at each layer): for each batch b
    of `embedder.batches(seqs)` in `picks` (embed_pooled runs them in
    that order), the outputs of its launches at each of its rows
    picks[b], cut to the row's <S> … </S> positions → [(sequence, [[len
    + 2, 2·proj] of each LSTM layer])], as the encode computed them."""
    from knn_for_homology_tpu_torch.ops import lstm_cuda

    recur = lstm_cuda.lstmp_bidir
    layers = embedder.config.n_lstm_layers
    batches = embedder.batches(seqs)
    kept = {(b, r): [] for b, rows in picks.items() for r in rows}

    def hooked(*args, **kwargs):
        out = recur(*args, **kwargs)
        b = hooked.calls // layers
        for r in picks.get(b, ()):
            n = len(batches[b].sequences[r])
            kept[(b, r)].append(out[r, :n + 2].clone())
        hooked.calls += 1
        return out

    # the wrapper counts its launches on the name it is found by
    hooked.calls, hooked.launches, hooked.steps = 0, recur.launches, \
        recur.steps
    lstm_cuda.lstmp_bidir = hooked
    try:
        embedder.embed_pooled(seqs)
    finally:
        lstm_cuda.lstmp_bidir = recur
    return [(batches[b].sequences[r], outs) for (b, r), outs in kept.items()]


def release(state):
    """embed_search's release, with the proteins the check compares. Every
    call holds the same lengths, so every call's batches hold as many
    rows: batch b is checked in the window's (b mod calls)-th distinct
    call, at checked_rows of its launch (drawn from the seed). Then one
    more run of the window's first call through the window's embedder
    keeps kernel M's outputs of both LSTM layers at the first row of the
    longest batch, and at the last row and a row drawn in the last m-tile
    of the batch with the most rows, as the window's encode computes
    them."""
    checked, lstm = [], []
    if state["out"]:
        embedder, pool = state["embedder"], state["pool"]
        gen = traffic.rng(state["seed"], 6)
        calls = list(dict.fromkeys(pool_i for pool_i, *_ in state["out"]))
        count = len(embedder.batches(pool[calls[0]]))
        for b in range(count):
            pool_i = calls[b % len(calls)]
            batch = embedder.batches(pool[pool_i])[b]
            rows = checked_rows(len(batch.indices), gen)
            checked += [(pool_i, batch.indices[r]) for r in rows]
        batches = embedder.batches(pool[calls[0]])
        widest = max(range(count), key=lambda b: len(batches[b].indices))
        n = len(batches[widest].indices)
        last_tile = (n - 1) // TILE * TILE
        picks = {0: {0}}
        picks.setdefault(widest, set()).update(
            {int(gen.integers(last_tile, n)), n - 1})
        lstm = encode_recurrence(embedder, pool[calls[0]],
                                 {b: sorted(r) for b, r in picks.items()})
    out = embed_search.release(state)
    out["checked"], out["lstm"] = checked, lstm
    return out


def per_position_rel_err(got: torch.Tensor, want: torch.Tensor) -> float:
    """Widest relative L2 error of one position's vector."""
    gap = (got.double() - want.double()).norm(dim=-1)
    rel = gap / want.double().norm(dim=-1).clamp_min(1e-30)
    worst = float(rel.max())
    return worst if math.isfinite(worst) else float("inf")


@torch.no_grad()
def readings(ctx, out, control=False):
    """pooled_rel_err: the widest relative L2 gap of a checked protein's
    pooled vector (release: the first, last and a drawn row of each m-tile
    of every batch's launch) from the float32 reference's (the control:
    the reference with fp8 recurrent weights, scaled a column).
    lstm2_rel_err: the widest relative L2 gap, at any position and in
    either LSTM layer, of kernel M's output at the hooked rows (release:
    the longest protein, and the last and a late row of the launch with
    the most rows), as the window's encode computed it, from the
    reference's LSTM output there (the control: the fp8 reference's); a
    wrong last step, a row retired early, a misplaced backward step or a
    wrong m-tile shows here, where a mean would hide it. hit_err: as
    embed_search's, on the program's own pooled vectors."""
    _, queries = embed_search.sample(ctx, out)
    if not out["checked"] or not out["lstm"]:
        return {"pooled_rel_err": float("inf"), "lstm2_rel_err": float("inf"),
                "hit_err": float("inf")}
    cfg, dev, k = ctx.config, ctx.device, ctx.cell["hits"]
    quant = ref_seqvec.fp8_columns if control else None
    first = {}  # pool index → the window's first call of it
    for c, (pool_i, *_) in enumerate(out["out"]):
        first.setdefault(pool_i, c)
    seqs = [out["pool"][pool_i][p] for pool_i, p in out["checked"]]
    want = ref_seqvec.pooled(out["weights"], seqs, cfg)
    if control:
        got = ref_seqvec.pooled(out["weights"], seqs, cfg, quant=quant)
    else:
        got = torch.from_numpy(np.stack(
            [out["out"][first[pool_i]][1][p]
             for pool_i, p in out["checked"]])).to(dev)
    rel = ((got.double() - want.double()).norm(dim=1)
           / want.double().norm(dim=1))
    pooled_err = float(rel.max())
    lstm_err = 0.0
    for seq, kept in out["lstm"]:
        want_l = ref_seqvec.run(out["weights"], seq, cfg)[1]
        got_l = (ref_seqvec.run(out["weights"], seq, cfg, quant)[1]
                 if control else kept)
        if len(got_l) != len(want_l):
            return {"pooled_rel_err": pooled_err,
                    "lstm2_rel_err": float("inf"), "hit_err": float("inf")}
        for g, w in zip(got_l, want_l):
            lstm_err = max(lstm_err, per_position_rel_err(g, w))
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
    return {"pooled_rel_err": pooled_err if math.isfinite(pooled_err)
            else float("inf"), "lstm2_rel_err": lstm_err, "hit_err": err}
