"""The port's embedding path against the JAX package: token-budget batches,
pooling, carrying weights across (params_to_torch, the .npz checkpoint),
ProtT5Embedder.embed_pooled, the `embed` CLI and the flagship forward step
(__graft_entry__.entry()'s forward_step).

Tolerances: pooling in fp32 is exact up to sum order (1e-6). Pooled bf16
encoder outputs differ by the encoder's bf16 rounding flips (tests/
test_torch_t5.py), averaged over residues: max difference ≤ 2^-6 of the
largest |value|. The JAX side runs its CPU routes ("auto" = XLA dense MLP
and blockwise scan), the port its one route (fused FFN, dense attention up
to blockwise_above and flash above, as plain versions on the CPU), so these
tests also hold the routes against each other.
"""

import dataclasses
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from knn_for_homology_tpu.models import batching as jbatching
from knn_for_homology_tpu.models import pooling as jpooling
from knn_for_homology_tpu.models import t5 as jt5
from knn_for_homology_tpu.models.convert import save_params as jsave_params
from knn_for_homology_tpu.models.registry import ProtT5Embedder as JEmbedder
from knn_for_homology_tpu_torch import entry
from knn_for_homology_tpu_torch.models import batching as tbatching
from knn_for_homology_tpu_torch.models import pooling as tpooling
from knn_for_homology_tpu_torch.models import t5 as tt5
from knn_for_homology_tpu_torch.models.convert import (
    load_t5_checkpoint,
    params_to_torch,
)
from knn_for_homology_tpu_torch.models.registry import (
    AACompositionEmbedder,
    ProtT5Embedder,
    get_embedder,
)
from knn_for_homology_tpu_torch.pipelines.embed import main as embed_main

AAS = "ACDEFGHIKLMNPQRSTVWYXUBZO"
# TINY with the blockwise threshold lowered, so that the lengths below
# cross it: batches padded to 128 run dense attention, to 256 the flash route
BLOCKWISE = {"blockwise_above": 128, "attention_chunk": 64}
TINY_META = {"config": {
    "vocab_size": 32, "d_model": 64, "d_kv": 16, "d_ff": 128,
    "num_layers": 2, "num_heads": 4, **BLOCKWISE,
}}


def _sequences(seed, n, lo=5, hi=200):
    rng = np.random.RandomState(seed)
    return ["".join(rng.choice(list(AAS), size=rng.randint(lo, hi)))
            for _ in range(n)]


def assert_pooled_close(got, want):
    err = np.abs(got - want).max()
    assert err <= 2.0**-6 * np.abs(want).max(), (err, np.abs(want).max())


@pytest.mark.parametrize("budget,max_len", [(7000, 3096), (300, 150), (1000, 3096)])
def test_make_batches_identical(budget, max_len):
    seqs = _sequences(0, 60, 1, 400)
    want = jbatching.make_batches(seqs, budget, max_len)
    got = tbatching.make_batches(seqs, budget, max_len)
    assert [(b.indices, b.sequences, b.padded_len) for b in got] == [
        (b.indices, b.sequences, b.padded_len) for b in want
    ]
    tokens = [jt5.tokenize(s) for s in want[0].sequences]
    for a, b in zip(tbatching.pad_tokens(tokens, want[0].padded_len),
                    jbatching.pad_tokens(tokens, want[0].padded_len)):
        np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("pool", ["mean_pool", "l2_then_mean_pool"])
def test_pooling_matches(pool):
    rng = np.random.RandomState(1)
    x = rng.randn(4, 30, 16).astype(np.float32)
    x[2, :5] = 0.0  # zero residue vectors stay zero in the L2 variant
    mask = rng.rand(4, 30) > 0.3
    mask[3] = False  # count clamped at 1: zeros, not NaN
    want = np.asarray(getattr(jpooling, pool)(jnp.asarray(x), jnp.asarray(mask)))
    got = getattr(tpooling, pool)(torch.from_numpy(x), torch.from_numpy(mask))
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=1e-6)
    per_residue = rng.randn(50, 8).astype(np.float32)
    ranges = [(1, 10), (20, 50), (7, 7)]
    np.testing.assert_array_equal(tpooling.pool_domains(per_residue, ranges),
                                  jpooling.pool_domains(per_residue, ranges))


def test_params_from_jax_round_trip():
    params = jt5.init_params(jt5.TINY, seed=0)
    tree = jax.tree.map(np.asarray, params)
    ported = params_to_torch(tree, "cpu", torch.bfloat16)
    pairs = zip(jax.tree_util.tree_leaves(params),
                jax.tree_util.tree_leaves(ported))
    for j, t in pairs:
        assert t.dtype == torch.bfloat16 and tuple(t.shape) == j.shape
        np.testing.assert_array_equal(t.float().numpy(), np.asarray(j, np.float32))
    encoder = tt5.T5Encoder(tt5.TINY, ported)
    # [in, out] layout kept: the port computes x @ w as the reference does
    assert tuple(encoder.layers[0].attn["q"].shape) == (64, 64)
    assert tuple(encoder.layers[1].mlp["wi"].shape) == (64, 128)


def _jax_params(seed=0):
    config = dataclasses.replace(jt5.TINY, **BLOCKWISE)
    return config, jt5.init_params(config, seed=seed)


@pytest.mark.parametrize("l2", [False, True], ids=["mean", "l2_mean"])
def test_embed_pooled_matches_jax(l2):
    config_j, params = _jax_params()
    config_t = dataclasses.replace(tt5.TINY, **BLOCKWISE)
    seqs = _sequences(2, 12, 5, 250)  # padded lengths 128 and 256
    want = JEmbedder(config=config_j, params=params, token_budget=1024,
                     l2_per_residue=l2).embed_pooled(seqs)
    ported = params_to_torch(jax.tree.map(np.asarray, params), "cpu", torch.bfloat16)
    embedder = ProtT5Embedder(config=config_t, params=ported, token_budget=1024,
                              l2_per_residue=l2, device="cpu")
    got = embedder.embed_pooled(seqs)
    assert got.shape == (12, 64) and got.dtype == np.float32
    assert_pooled_close(got, want)
    per_residue = list(embedder.embed_per_residue(seqs[:3]))
    assert [r.shape for r in per_residue] == [(len(s), 64) for s in seqs[:3]]


def test_embed_cli_end_to_end(tmp_path):
    config_j, params = _jax_params(seed=5)
    ckpt = tmp_path / "tiny_t5.npz"
    jsave_params(params, ckpt, meta=TINY_META)
    seqs = _sequences(3, 7, 10, 240)
    fasta = tmp_path / "in.fasta"
    fasta.write_text("".join(f">p{i} desc\n{s}\n" for i, s in enumerate(seqs)))
    npy = tmp_path / "out.npy"
    embed_main(["embed", str(fasta), str(npy), "--checkpoint", str(ckpt),
                "--batch-size", "600", "--device", "cpu"])
    got = np.load(npy)
    assert json.loads((tmp_path / "out.json").read_text()) == [
        f"p{i} desc" for i in range(7)
    ]
    assert float((tmp_path / "out.time.txt").read_text()) > 0
    want = JEmbedder(config=config_j, params=params,
                     token_budget=600).embed_pooled(seqs)
    assert_pooled_close(got, want)

    config, ported, vocab = load_t5_checkpoint(ckpt, device="cpu")
    assert vocab is None and config.blockwise_above == 128
    assert config.dtype == torch.bfloat16

    out = tmp_path / "one"
    embed_main(["embed-one", str(fasta), str(out), "--embedder",
                "AA Composition", "--device", "cpu"])
    np.testing.assert_array_equal(np.load(out / "AA Composition.npy"),
                                  AACompositionEmbedder().embed_pooled(seqs))
    assert (out / "AA Composition.time1.txt").exists()


def test_port_checkpoint_round_trip(tmp_path):
    """The port's own tensors save to the flat .npz (bf16 as fp32) and load
    back bit for bit, config and vocabulary included."""
    from knn_for_homology_tpu_torch.models.convert import save_params

    config = dataclasses.replace(tt5.TINY, **BLOCKWISE)
    params = tt5.init_params(config, seed=2, device="cpu")
    vocab = {aa: 3 + i for i, aa in enumerate("WYVTSRQPNMLKIHGFEDCA")}
    save_params(params, tmp_path / "ck.npz", meta={**TINY_META, "vocab": vocab})
    loaded_config, loaded, loaded_vocab = load_t5_checkpoint(
        tmp_path / "ck.npz", device="cpu")
    assert loaded_config == config and loaded_vocab == vocab
    for a, b in zip(jax.tree_util.tree_leaves(params),
                    jax.tree_util.tree_leaves(loaded)):
        assert torch.equal(a, b)


def _jax_meta():
    """A checkpoint meta as the JAX package's config gives it: every field
    but the dtype, its four route flags included."""
    config = dataclasses.replace(jt5.TINY, **BLOCKWISE)
    meta = {k: v for k, v in dataclasses.asdict(config).items() if k != "dtype"}
    assert {"use_flash_kernel", "use_short_kernel", "short_kernel_max",
            "use_fused_ffn"} <= set(meta)
    return meta


def test_checkpoint_meta_drops_the_jax_route_flags(tmp_path):
    """A .npz whose meta carries the JAX package's route flags (written by
    the JAX package, or by the port before it dropped them) loads: the
    four flags are dropped, every other field is kept."""
    params = jt5.init_params(jt5.TINY, seed=3)
    jsave_params(params, tmp_path / "ck.npz", meta={"config": _jax_meta()})
    config, _, vocab = load_t5_checkpoint(tmp_path / "ck.npz", device="cpu")
    assert config == dataclasses.replace(tt5.TINY, **BLOCKWISE) and vocab is None


def test_checkpoint_meta_unknown_field_raises(tmp_path):
    params = tt5.init_params(tt5.TINY, seed=3, device="cpu")
    from knn_for_homology_tpu_torch.models.convert import save_params

    meta = {"config": {**_jax_meta(), "no_such_field": 1}}
    save_params(params, tmp_path / "ck.npz", meta=meta)
    with pytest.raises(TypeError, match="no_such_field"):
        load_t5_checkpoint(tmp_path / "ck.npz", device="cpu")


def test_registry_names():
    assert isinstance(get_embedder("AA Composition"), AACompositionEmbedder)
    with pytest.raises(KeyError):
        get_embedder("No such embedder")
    with pytest.raises(ValueError):
        get_embedder("SeqVec", device="cpu")  # no weights
    with pytest.raises(ValueError):
        ProtT5Embedder(device="cpu")  # no weights


@pytest.mark.parametrize("fused", ["auto", False], ids=["auto", "dense_ffn"])
def test_forward_step_matches_graft_entry(fused):
    """Top-13 ids equal to the JAX program's except swaps of near-ties: a
    slot may hold another id only if the JAX side scores that id within
    TIE of its own pick there (the JAX cosines under its FFN flag `fused`;
    on the CPU both flags take its dense MLP, the route the JAX program
    takes). The port runs its one route, kernel G's plain version for the
    FFN; its pooled bf16 vectors differ from the JAX program's by rounding
    flips, which move cosines by up to ~5e-4."""
    import __graft_entry__ as graft
    from knn_for_homology_tpu.models.pooling import mean_pool
    from knn_for_homology_tpu.ops.distance import l2_normalize

    tie = 1e-3
    fn, (params, db, ids, mask) = graft.entry()
    want_sims, want_ids = (np.asarray(a) for a in fn(params, db, ids, mask))
    config = tt5.T5Config(vocab_size=32, d_model=128, d_kv=32, d_ff=256,
                          num_layers=2, num_heads=4)
    jconfig = jt5.T5Config(vocab_size=32, d_model=128, d_kv=32, d_ff=256,
                           num_layers=2, num_heads=4, use_fused_ffn=fused)
    pooled = l2_normalize(mean_pool(jt5.encode(params, ids, mask, jconfig), mask))
    want_all = np.asarray(pooled) @ np.asarray(db).T  # [16, 1024]
    encoder = tt5.T5Encoder(config, params_to_torch(
        jax.tree.map(np.asarray, params), "cpu", torch.bfloat16))
    sims, hit_ids = entry.forward_step(
        encoder, torch.tensor(np.asarray(db)), torch.tensor(np.asarray(ids)),
        torch.tensor(np.asarray(mask)), k=13,
    )
    assert hit_ids.shape == (16, 13) and hit_ids.dtype == torch.int32
    np.testing.assert_allclose(sims.numpy(), want_sims, rtol=0, atol=tie)
    got = hit_ids.numpy()
    rows, cols = np.nonzero(got != want_ids)
    assert len(rows) <= 0.05 * got.size, len(rows)
    for r, c in zip(rows, cols):
        assert abs(want_all[r, got[r, c]] - want_sims[r, c]) <= tie, (r, c)
    for row in got:
        assert len(set(row)) == 13
