"""Embed proteins with ProtXLNet and search the pooled vectors against a
database's train proteins: each call is `XLNetEmbedder.embed_pooled` on
one batch of proteins, then `FlatIndex.search` at the cell's k, both
returning host arrays. The calls, the traffic and the check's sample are
embed_search's, with ProtXLNet in ProtT5's place.

Cell keys: those of embed_search ("database", "units_per_call",
"lengths", "pool_calls", "hits", "token_budget", "max_len",
"check_proteins", "check_queries").
"""

import math

import numpy as np
import torch

from portbench.drivers import embed_search
from portbench.lib import traffic
from portbench.reference import search as ref_search
from portbench.reference import xlnet as ref_xlnet

step = embed_search.step
# the layer whose attention the check compares: the first past a
# LayerNorm (layer 0 takes the 0.02-scale embedding, where attention is
# flat); deeper inputs converge under random weights, and a context that
# averages alike rows hardly sees which keys the position term weights
CHECK_LAYER = 1


def xlnet_config(cfg: dict):
    """The served route: the serving dtype through kernel L (a program
    without the route refuses the field, so the cell fails at once)."""
    from knn_for_homology_tpu_torch.models import xlnet

    config = xlnet.XLNetConfig(
        vocab_size=cfg["vocab_size"], d_model=cfg["d_model"],
        d_inner=cfg["d_inner"], num_layers=cfg["n_layer"],
        num_heads=cfg["n_head"], layer_norm_eps=cfg["layer_norm_eps"],
        dtype=getattr(torch, cfg["serving_dtype"]), use_kernel=True,
    )
    if config.d_head != cfg["d_head"]:
        raise ValueError(f"d_head {cfg['d_head']} is not d_model / n_head")
    return config


def xlnet_weights(cfg: dict, seed: int, device, dtype=torch.bfloat16) -> dict:
    """Random ProtXLNet weights in the port's tree (attention projections
    [d_model, H, d_head], feed-forward [in, out]), drawn on the device in
    one call per kind of tensor at XLNet's published initialisation
    (transformers' XLNetPreTrainedModel._init_weights): the embedding, q,
    k, v, o, r, r_w and r_r and both feed-forward matrices normal x
    initializer_range, feed-forward biases 0, LayerNorms 1 and 0."""
    d, h, dh, f = cfg["d_model"], cfg["n_head"], cfg["d_head"], cfg["d_inner"]
    layers, std = cfg["n_layer"], cfg["initializer_range"]
    gen = traffic.torch_gen(seed, 7, device)

    def draw(*shape):
        return torch.randn(shape, generator=gen, device=device).mul_(std) \
            .to(dtype)

    mats = {name: draw(layers, d, h, dh) for name in ("q", "k", "v", "o", "r")}
    mats.update(r_w_bias=draw(layers, h, dh), r_r_bias=draw(layers, h, dh),
                ff_w1=draw(layers, d, f), ff_w2=draw(layers, f, d))
    ones = torch.ones((2 * layers, d), dtype=dtype, device=device)
    zeros = torch.zeros((3 * layers, d), dtype=dtype, device=device)
    ff_b1 = torch.zeros((layers, f), dtype=dtype, device=device)
    return {
        "embedding": draw(cfg["vocab_size"], d),
        "layers": [
            dict({n: m[i] for n, m in mats.items()},
                 ln_attn=ones[2 * i], ln_attn_b=zeros[3 * i],
                 ff_b1=ff_b1[i], ff_b2=zeros[3 * i + 1],
                 ln_ff=ones[2 * i + 1], ln_ff_b=zeros[3 * i + 2])
            for i in range(layers)
        ],
    }


def setup(ctx):
    from knn_for_homology_tpu_torch.models.registry import XLNetEmbedder
    from knn_for_homology_tpu_torch.search.flat import FlatIndex

    cell, cfg, dev = ctx.cell, ctx.config, ctx.device
    config = xlnet_config(cfg)
    db_cfg = ctx.config_of(cell["database"])
    weights = xlnet_weights(cfg, ctx.seed, dev,
                            getattr(torch, cfg["serving_dtype"]))
    rows = traffic.database(db_cfg, ctx.seed, dev)["train"]
    lengths = traffic.lengths_of(cell["lengths"])
    gen = traffic.rng(ctx.seed, 4)
    pool = [traffic.random_sequences(gen, gen.permutation(lengths))
            for _ in range(cell["pool_calls"])]
    ctx.mark("inputs")
    embedder = XLNetEmbedder(config=config, params=weights,
                             token_budget=cell["token_budget"],
                             max_len=cell["max_len"], device=dev)
    index = FlatIndex(metric=db_cfg["metric"], device=dev)
    index.add(rows.cpu().numpy())
    ctx.mark("program")
    state = {"embedder": embedder, "index": index, "pool": pool,
             "weights": weights, "rows": rows, "recorder": ctx.recorder,
             "hits": cell["hits"], "out": [], "max_len": cell["max_len"]}
    # every call holds the same lengths, so this call warms every shape
    embedder.embed_pooled(pool[0])
    index.search(np.zeros((len(pool[0]), db_cfg["dim"]), np.float32),
                 cell["hits"])
    return state


@torch.no_grad()
def encode_contexts(embedder, seqs, layer: int, which: int):
    """embedder.embed_pooled(seqs) with kernel L's wrapper hooked (the
    encoder looks up ops/relattn_cuda.py's at each layer): the q, k, v and
    context of the `layer`-th call of batch `which` of `embedder.batches`
    (embed_pooled runs them in that order), each row cut to its protein's
    tokens → {sequence: (q, k, v, context)}, each [H, tokens, d_head]."""
    from knn_for_homology_tpu_torch.ops import relattn_cuda

    attend = relattn_cuda.relative_attention
    at = which * embedder.config.num_layers + layer
    kept = []

    def hooked(*args, **kwargs):
        out = attend(*args, **kwargs)
        if hooked.calls == at:
            kept.extend(t.clone() for t in args[:3] + (out,))
        hooked.calls += 1
        return out

    hooked.calls, hooked.launches = 0, attend.launches
    relattn_cuda.relative_attention = hooked
    try:
        embedder.embed_pooled(seqs)
    finally:
        relattn_cuda.relative_attention = attend
        attend.launches = hooked.launches
    if not kept:
        return {}
    batch = embedder.batches(seqs)[which]
    return {seq: tuple(t[row, :, :len(seq) + 2] for t in kept)
            for row, seq in enumerate(batch.sequences)}


def release(state):
    """embed_search's release, after one more run of the window's first
    call through the window's embedder, keeping kernel L's inputs and
    output at CHECK_LAYER for every row of the batch that holds the call's
    longest protein (the check's first sample; every call holds the same
    lengths), padded rows included, as the window's encode computes them."""
    attn = {}
    if state["out"]:
        seqs = state["pool"][state["out"][0][0]]
        longest = max(seqs, key=len)[:state["max_len"]]
        batches = state["embedder"].batches(seqs)
        which = next(i for i, b in enumerate(batches)
                     if longest in b.sequences)
        attn = encode_contexts(state["embedder"], seqs, CHECK_LAYER, which)
    out = embed_search.release(state)
    out["attn"] = attn
    return out


@torch.no_grad()
def readings(ctx, out, control=False):
    """pooled_rel_err: the widest relative L2 gap of a sampled protein's
    pooled vector from the float32 reference's (the control: the reference
    on fp8 operands). attn_rel_err: the widest relative Frobenius gap of
    kernel L's context at CHECK_LAYER, for each row of the batch that holds
    the window's longest protein, as the window's encode computed it
    (release: the program's padded batch, its one R product, its slice of
    it), from the reference's float32 attention of that row's own q, k, v
    alone, with R projected by the reference from the layer's weights (the
    control: the same on fp8 operands); the pooled vectors barely see the
    position term (PERF.md §2), this number does. hit_err: as
    embed_search's, on the program's own pooled vectors."""
    proteins, queries = embed_search.sample(ctx, out)
    if not proteins or not out["attn"]:
        return {"pooled_rel_err": float("inf"), "attn_rel_err": float("inf"),
                "hit_err": float("inf")}
    cfg, dev, k = ctx.config, ctx.device, ctx.cell["hits"]
    max_len = out["max_len"]
    seqs = [out["pool"][out["out"][c][0]][p][:max_len] for c, p in proteins]
    want = ref_xlnet.pooled(out["weights"], seqs, cfg)
    if control:
        got = ref_xlnet.pooled(out["weights"], seqs, cfg,
                               quant=ref_xlnet.fp8_round)
    else:
        got = torch.from_numpy(np.stack(
            [out["out"][c][1][p] for c, p in proteins])).to(dev)
    rel = ((got.double() - want.double()).norm(dim=1)
           / want.double().norm(dim=1))
    attn, layer = 0.0, out["weights"]["layers"][CHECK_LAYER]
    for q, k_, v, ctx_got in out["attn"].values():
        ctx_want = ref_xlnet.attention_of(q, k_, v, layer, cfg)
        if control:
            ctx_got = ref_xlnet.attention_of(q, k_, v, layer, cfg,
                                             quant=ref_xlnet.fp8_round)
        gap = float((ctx_got.double() - ctx_want.double()).norm()
                    / ctx_want.double().norm())
        attn = max(attn, gap if math.isfinite(gap) else float("inf"))
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
    return {"pooled_rel_err": float(rel.max()), "attn_rel_err": attn,
            "hit_err": err}
