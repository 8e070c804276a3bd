"""ProtXLNet's fused route (models/xlnet.py): kernel L's plain version
(ops/relative_attention.py) against the plain reference's attention
(portbench/reference/xlnet.py, transformers' XLNetModel formulation) on
ragged masks; the fused route against the fp32 route; XLNetEmbedder's
device pooling against the reference's pooled vectors, where dropping or
shifting the position term fails the same tolerance; ProtT5's pooled
vectors as before the pooling moved into BatchedEmbedder; the spans and
counts of the shared embed_pooled. All on the CPU, at tiny widths."""

import dataclasses

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from knn_for_homology_tpu_torch.models import t5, xlnet
from knn_for_homology_tpu_torch.models.batching import make_batches, pad_tokens
from knn_for_homology_tpu_torch.models.pooling import mean_pool
from knn_for_homology_tpu_torch.models.registry import (
    ProtT5Embedder,
    XLNetEmbedder,
)
from knn_for_homology_tpu_torch.ops import relattn_cuda
from knn_for_homology_tpu_torch.ops.relative_attention import (
    relative_attention_plain,
)
from knn_for_homology_tpu_torch.utils import trace
from portbench.reference import xlnet as ref

AAS = "ACDEFGHIKLMNPQRSTVWY"
FP32_TOL = 1e-5
# fp32 widths at which every term of the layer is exercised
CONFIG = xlnet.XLNetConfig(vocab_size=37, d_model=32, d_inner=64,
                           num_layers=2, num_heads=4, use_kernel=True)
REF_CFG = {"d_model": 32, "n_head": 4, "d_head": 8, "layer_norm_eps": 1e-12}


def weights(seed=0, scale=0.3):
    """A tree of the port's layout; larger than XLNet's 0.02 so that the
    attention, and its position term, move the pooled vectors."""
    gen = torch.Generator().manual_seed(seed)
    d, f, n, h = 32, 64, 4, 8

    def w(*shape):
        return torch.randn(shape, generator=gen) * scale

    def layer():
        return {"q": w(d, n, h), "k": w(d, n, h), "v": w(d, n, h),
                "o": w(d, n, h), "r": w(d, n, h), "r_w_bias": w(n, h),
                "r_r_bias": w(n, h), "ln_attn": 1 + w(d), "ln_attn_b": w(d),
                "ff_w1": w(d, f), "ff_b1": w(f), "ff_w2": w(f, d),
                "ff_b2": w(d), "ln_ff": 1 + w(d), "ln_ff_b": w(d)}

    return {"embedding": w(37, d) * 3, "layers": [layer(), layer()]}


def sequences(seed, lengths):
    rng = np.random.RandomState(seed)
    return ["".join(rng.choice(list(AAS), n)) for n in lengths]


def rel_err(got, want):
    got, want = torch.as_tensor(got).double(), torch.as_tensor(want).double()
    return float(((got - want).norm(dim=-1) / want.norm(dim=-1)).max())


@pytest.mark.parametrize("lengths,block", [
    ([1], 512), ([5, 1], 2), ([13, 7, 2], 4), ([70, 33], 64),
    ([70, 70, 9], 16)])
def test_plain_attention_equals_reference(lengths, block):
    """Each row's real positions against the reference on that row alone
    (R's rows are relative offsets, so padding moves nothing); padded query
    rows stay finite."""
    gen = torch.Generator().manual_seed(len(lengths) + block)
    b, h, dh, d, l = len(lengths), 4, 8, 32, max(lengths)
    q, k, v = (torch.randn(b, h, l, dh, generator=gen) for _ in range(3))
    w_r = torch.randn(d, h * dh, generator=gen) * 0.3
    r_w, r_r = (torch.randn(h, dh, generator=gen) for _ in range(2))
    r = (ref.positional(l, d, "cpu") @ w_r).view(2 * l, h, dh)
    mask = torch.arange(l)[None] < torch.as_tensor(lengths)[:, None]
    got = relative_attention_plain(q, k, v, r, r_w, r_r, mask, block=block)
    assert torch.isfinite(got).all()
    for row, n in enumerate(lengths):
        r_n = (ref.positional(n, d, "cpu") @ w_r).view(2 * n, h, dh)
        want = ref.attention(q[row, :, :n], k[row, :, :n], v[row, :, :n],
                             r_n.transpose(0, 1), r_w, r_r)
        torch.testing.assert_close(got[row, :, :n], want, rtol=FP32_TOL,
                                   atol=FP32_TOL)


def test_wrapper_takes_the_plain_version_on_the_cpu():
    gen = torch.Generator().manual_seed(3)
    q, k, v = (torch.randn(2, 4, 9, 8, generator=gen) for _ in range(3))
    r = torch.randn(18, 4, 8, generator=gen)
    r_w, r_r = torch.zeros(4, 8), torch.ones(4, 8)
    mask = torch.ones(2, 9, dtype=torch.bool)
    before = relattn_cuda.relative_attention.launches
    got = relattn_cuda.relative_attention(q, k, v, r, r_w, r_r, mask)
    assert relattn_cuda.relative_attention.launches == before
    assert torch.equal(got, relative_attention_plain(q, k, v, r, r_w, r_r,
                                                     mask))
    with pytest.raises(ValueError, match="r is"):
        relattn_cuda.relative_attention(q, k, v, r[:17], r_w, r_r, mask)


def test_routes_resolve_from_the_dtype():
    assert not xlnet.fused_route(xlnet.PROTXLNET)
    assert xlnet.fused_route(dataclasses.replace(xlnet.PROTXLNET,
                                                 dtype=torch.bfloat16))
    assert not xlnet.fused_route(dataclasses.replace(
        xlnet.PROTXLNET, dtype=torch.bfloat16, use_kernel=False))
    assert xlnet.fused_route(CONFIG)


def test_sinusoid_equals_numpy_float64():
    inv_freq = 1.0 / (10000.0 ** (np.arange(0, 32, 2, dtype=np.float64) / 32))
    angles = np.outer(np.arange(37, -37, -1, dtype=np.float64), inv_freq)
    want = np.concatenate([np.sin(angles), np.cos(angles)], axis=-1)
    np.testing.assert_array_equal(xlnet.sinusoid(37, 32, "cpu").numpy(),
                                  want.astype(np.float32))


def test_fused_route_equals_fp32_route():
    """Every position, padding included: both routes let a padded key
    attend from its own row."""
    params = weights(1)
    rng = np.random.RandomState(2)
    lengths = [23, 9, 1]
    ids = rng.randint(7, 32, (3, 23)).astype(np.int64)
    mask = np.arange(23)[None] < np.asarray(lengths)[:, None]
    args = (torch.from_numpy(ids), torch.from_numpy(mask))
    fused = xlnet.encode(params, *args, CONFIG)
    plain = xlnet.encode(params, *args,
                         dataclasses.replace(CONFIG, use_kernel=False))
    torch.testing.assert_close(fused, plain, rtol=FP32_TOL, atol=FP32_TOL)


def embedder(params, config=CONFIG, **kw):
    return XLNetEmbedder(config=config, params=params, device="cpu",
                         token_budget=kw.pop("token_budget", 256), **kw)


def test_embed_pooled_equals_reference():
    """Batched, padded, pooled on the device, against the reference one
    protein at a time (both fp32)."""
    params = weights(4)
    seqs = sequences(5, [40, 3, 100, 17, 64, 1, 90])
    got = embedder(params).embed_pooled(seqs)
    want = ref.pooled(params, seqs, REF_CFG)
    assert got.shape == (7, 32) and got.dtype == np.float32
    assert rel_err(got, want) <= FP32_TOL


def test_embed_pooled_bf16_route_near_reference():
    """The serving dtype: bf16 weights and activations, the fp32 reference
    on the same bf16 weights widened."""
    config = dataclasses.replace(CONFIG, dtype=torch.bfloat16,
                                 use_kernel="auto")
    params = {"embedding": weights(6)["embedding"].bfloat16(),
              "layers": [{n: t.bfloat16() for n, t in layer.items()}
                         for layer in weights(6)["layers"]]}
    seqs = sequences(7, [30, 65, 5])
    got = embedder(params, config).embed_pooled(seqs)
    want = ref.pooled(params, seqs, REF_CFG)
    assert rel_err(got, want) <= 0.03


@pytest.mark.parametrize("fault", ["no position term", "shifted by one"])
def test_position_faults_fail_the_tolerance(monkeypatch, fault):
    """Kernel L's plain version with R zeroed, or one row off, fails the
    tolerance the fused route passes."""
    def broken(q, k, v, r, *rest, **kw):
        bad = torch.zeros_like(r) if fault == "no position term" else \
            torch.cat([r[1:], torch.zeros_like(r[:1])])
        return relative_attention_plain(q, k, v, bad, *rest, **kw)

    monkeypatch.setattr(relattn_cuda, "relative_attention_plain", broken)
    params = weights(4)
    seqs = sequences(5, [40, 3, 100, 17, 64, 1, 90])
    got = embedder(params).embed_pooled(seqs)
    assert rel_err(got, ref.pooled(params, seqs, REF_CFG)) > 100 * FP32_TOL


def test_per_residue_and_pooled_agree():
    params = weights(8)
    emb = embedder(params, token_budget=128)
    seqs = sequences(9, [50, 12, 77, 2])
    per_residue = list(emb.embed_per_residue(seqs))
    assert [e.shape for e in per_residue] == [(n, 32) for n in map(len, seqs)]
    np.testing.assert_allclose(
        np.stack([e.mean(0) for e in per_residue]), emb.embed_pooled(seqs),
        rtol=FP32_TOL, atol=FP32_TOL)


def test_prott5_pooled_bit_for_bit_as_before():
    """ProtT5's embed_pooled, now BatchedEmbedder's, equals the code it
    had: tokens with EOS, the residue mask without it, mean_pool, un-sort."""
    params = t5.init_params(t5.TINY, 0, "cpu")
    emb = ProtT5Embedder(config=t5.TINY, params=params, token_budget=512,
                         max_len=100, device="cpu")
    seqs = sequences(10, [5, 99, 140, 33, 60, 7, 100, 2])
    got = emb.embed_pooled(seqs)
    want = [None] * len(seqs)
    for batch in make_batches(seqs, 512, 100):
        tokens = [t5.tokenize(s) for s in batch.sequences]
        ids, mask = pad_tokens(tokens, batch.padded_len, t5.PAD_ID)
        res_mask = mask.copy()
        for row, seq in enumerate(batch.sequences):
            res_mask[row, len(seq):] = False
        hidden = emb.encoder(torch.from_numpy(ids), torch.from_numpy(mask))
        pooled = mean_pool(hidden, torch.from_numpy(res_mask)).numpy()
        for idx, row in zip(batch.indices, pooled):
            want[idx] = row
    np.testing.assert_array_equal(got, np.stack(want))


def test_xlnet_spans_and_counts():
    """embed_pooled's span tree as ProtT5's, with `embed.relpos` inside
    every `embed.encode`; the batch counts at the encoded length (the
    batch's padded length + <sep> <cls>)."""
    emb = embedder(weights(11), token_budget=300)
    seqs = sequences(12, [120, 7, 60, 33, 140])
    trace.spans()
    with profile(activities=[ProfilerActivity.CPU]):
        pooled = emb.embed_pooled(seqs)
    spans = trace.spans()
    np.testing.assert_array_equal(pooled, emb.embed_pooled(seqs))
    batches = make_batches(seqs, 300, emb.max_len)
    counts = [s.counts for s in spans if s.name == "embed.batch"]
    assert counts == [{
        "residues": sum(map(len, b.sequences)),
        "tokens": len(b.indices) * (b.padded_len + 2),
        "rows": len(b.indices), "padded_len": b.padded_len + 2,
        "residues_sq": sum(len(s) ** 2 for s in b.sequences)}
        for b in batches]
    encodes = [i for i, s in enumerate(spans) if s.name == "embed.encode"]
    relpos = [s for s in spans if s.name == "embed.relpos"]
    assert len(encodes) == len(relpos) == len(batches)
    assert [s.parent for s in relpos] == encodes
    assert all(s.counts == {} for s in relpos)


def test_reference_equals_transformers_xlnetmodel():
    """The plain reference is transformers' XLNetModel content stream
    (attn_type "bi", no segment ids), on perturbed weights."""
    transformers = pytest.importorskip("transformers")
    cfg = transformers.XLNetConfig(
        vocab_size=37, d_model=32, n_layer=2, n_head=4, d_inner=64,
        dropout=0.0, bi_data=False, attn_type="bi", ff_activation="gelu",
        layer_norm_eps=1e-12)
    torch.manual_seed(0)
    model = transformers.XLNetModel(cfg).eval()
    with torch.no_grad():
        for p in model.parameters():
            p.add_(torch.randn_like(p) * 0.05)
    sd = model.state_dict()
    attn = ("q", "k", "v", "o", "r", "r_w_bias", "r_r_bias")
    layers = []
    for i in range(2):
        b = f"layer.{i}."
        layers.append({
            **{n: sd[b + "rel_attn." + n] for n in attn},
            "ln_attn": sd[b + "rel_attn.layer_norm.weight"],
            "ln_attn_b": sd[b + "rel_attn.layer_norm.bias"],
            "ff_w1": sd[b + "ff.layer_1.weight"].T,
            "ff_b1": sd[b + "ff.layer_1.bias"],
            "ff_w2": sd[b + "ff.layer_2.weight"].T,
            "ff_b2": sd[b + "ff.layer_2.bias"],
            "ln_ff": sd[b + "ff.layer_norm.weight"],
            "ln_ff_b": sd[b + "ff.layer_norm.bias"]})
    weights = {"embedding": sd["word_embedding.weight"], "layers": layers}
    seq = "MKVLAGDWYQRSTAAKLU"
    with torch.no_grad():
        want = model(input_ids=torch.tensor([ref.tokens(seq)]))
    got = ref.encode_many(weights, [seq], {**REF_CFG, "n_head": 4,
                                           "d_head": 8})[0]
    torch.testing.assert_close(got, want.last_hidden_state[0], rtol=1e-5,
                               atol=1e-5)
