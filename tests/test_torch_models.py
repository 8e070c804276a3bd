"""The port's other encoder families (knn_for_homology_tpu_torch/models/
{elmo,bert,xlnet,unirep,plus_rnn,cpcprot}.py) and its full embedder registry
against the JAX package's, on the CPU, at the TINY_* configs: the same numpy
parameter trees (the JAX package's init_params) and the same seeded padded
batches go through both packages' `encode` and registry embedders.

Tolerances (every family is fp32 in both packages):
  * encode, per layer output: |port - jax| ≤ 1e-5 · max(1, max|jax|). The
    two sides sum the same fp32 products in other orders (and use other
    exp/tanh/erf implementations), a few ulps apart per op; two layers and
    a dozen recurrent steps stay far inside this bound (measured ≤ 1.1e-6
    at magnitudes up to 3.2).
  * pooled vectors of the fp32 keys: the same bound; the ProtT5 keys are
    bf16 and held as tests/test_torch_embed.py holds them (≤ 2^-6 of the
    largest |value|); the AA-composition baseline: equal.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from knn_for_homology_tpu.models import bert as jbert
from knn_for_homology_tpu.models import cpcprot as jcpc
from knn_for_homology_tpu.models import elmo as jelmo
from knn_for_homology_tpu.models import plus_rnn as jplus
from knn_for_homology_tpu.models import registry as jregistry
from knn_for_homology_tpu.models import t5 as jt5
from knn_for_homology_tpu.models import unirep as junirep
from knn_for_homology_tpu.models import xlnet as jxlnet
from knn_for_homology_tpu_torch.models import bert as tbert
from knn_for_homology_tpu_torch.models import cpcprot as tcpc
from knn_for_homology_tpu_torch.models import elmo as telmo
from knn_for_homology_tpu_torch.models import plus_rnn as tplus
from knn_for_homology_tpu_torch.models import registry as tregistry
from knn_for_homology_tpu_torch.models import t5 as tt5
from knn_for_homology_tpu_torch.models import unirep as tunirep
from knn_for_homology_tpu_torch.models import xlnet as txlnet
from knn_for_homology_tpu_torch.models.convert import params_to_torch
from knn_for_homology_tpu_torch.models.module import TreeEncoder

FP32_TOL = 1e-5
AAS = "ACDEFGHIKLMNPQRSTVWY"

# family → (JAX module, port module, tiny config name, vocab for ids)
FAMILIES = {
    "elmo": (jelmo, telmo, "TINY_ELMO", len(jelmo.AA_ORDER)),
    "bert": (jbert, tbert, "TINY_BERT", 32),
    "xlnet": (jxlnet, txlnet, "TINY_XLNET", 32),
    "unirep": (junirep, tunirep, "TINY_UNIREP", 26),
    "plus_rnn": (jplus, tplus, "TINY_PLUS", 21),
}


def port_config(jconfig, tmodule_config_cls, **changes):
    """The port's config with the JAX config's fields (its own dtype)."""
    fields = {f.name: getattr(jconfig, f.name)
              for f in dataclasses.fields(jconfig) if f.name != "dtype"}
    fields.update(changes)
    return tmodule_config_cls(**fields)


def jax_tree(module, config, seed):
    return jax.tree.map(np.asarray, module.init_params(config, seed))


def assert_fp32_close(got, want, tol=FP32_TOL):
    got, want = np.asarray(got, np.float32), np.asarray(want, np.float32)
    assert got.shape == want.shape, (got.shape, want.shape)
    assert np.isfinite(got).all()
    err = np.abs(got - want).max()
    assert err <= tol * max(1.0, np.abs(want).max()), (err, np.abs(want).max())


def padded_batch(rng, vocab, lengths, lo=0):
    """Seeded ids [B, max(lengths)] (pad id 0 after each row's length) and
    the matching bool mask."""
    width = max(lengths)
    ids = rng.randint(lo, vocab, (len(lengths), width)).astype(np.int32)
    mask = np.arange(width)[None] < np.asarray(lengths)[:, None]
    return np.where(mask, ids, 0).astype(np.int32), mask


def run_both(family, params, ids, mask, jconfig, tconfig):
    jmod, tmod = FAMILIES[family][:2]
    want = jmod.encode(params, jnp.asarray(ids), jnp.asarray(mask), jconfig)
    got = tmod.encode(params_to_torch(params, "cpu"), torch.from_numpy(ids),
                      torch.from_numpy(mask), tconfig)
    return got.numpy(), np.asarray(want)


@pytest.mark.parametrize("family", list(FAMILIES))
def test_encode_equals_jax(family):
    """Rows of three lengths in one padded batch; every position compared
    (the padding positions too)."""
    jmod, tmod, name, vocab = FAMILIES[family]
    jconfig = getattr(jmod, name)
    tconfig = getattr(tmod, name)
    params = jax_tree(jmod, jconfig, 1)
    ids, mask = padded_batch(np.random.RandomState(0), vocab, [13, 7, 2])
    got, want = run_both(family, params, ids, mask, jconfig, tconfig)
    assert_fp32_close(got, want)


@pytest.mark.parametrize("family", ["elmo", "plus_rnn", "bert", "unirep"])
def test_padding_invariance(family):
    """A row's valid positions do not depend on the rows padded beside it:
    each row of a mixed-length batch equals that row encoded alone (the
    backward LSTMs of ELMo and PLUS run over each row's valid region)."""
    jmod, tmod, name, vocab = FAMILIES[family]
    tconfig = getattr(tmod, name)
    params = params_to_torch(jax_tree(jmod, getattr(jmod, name), 2), "cpu")
    lengths = [11, 4, 8]
    ids, mask = padded_batch(np.random.RandomState(3), vocab, lengths)
    batch = tmod.encode(params, torch.from_numpy(ids), torch.from_numpy(mask),
                        tconfig).numpy()
    for row, n in enumerate(lengths):
        alone = tmod.encode(params, torch.from_numpy(ids[row : row + 1, :n]),
                            torch.ones((1, n), dtype=torch.bool),
                            tconfig).numpy()
        if family == "elmo":  # [3, B, L, d]
            assert_fp32_close(batch[:, row, :n], alone[:, 0])
            assert not batch[:, row, n:].any()
        else:
            assert_fp32_close(batch[row, :n], alone[0])


def test_xlnet_end_specials_equal_jax():
    """XLNet's <sep> <cls> at the end of each tokenized row, then padding:
    the port equals JAX at every position of a mixed-length batch."""
    rng = np.random.RandomState(4)
    seqs = ["".join(rng.choice(list(AAS), n)) for n in (14, 5, 9)]
    tokens = [jxlnet.tokenize(s) for s in seqs]
    for s, tok in zip(seqs, tokens):
        np.testing.assert_array_equal(txlnet.tokenize(s), tok)
        assert list(tok[-2:]) == [txlnet.XLNET_SEP, txlnet.XLNET_CLS]
    width = max(len(t) for t in tokens)
    ids = np.full((3, width), txlnet.XLNET_PAD, np.int32)
    mask = np.zeros((3, width), bool)
    for row, tok in enumerate(tokens):
        ids[row, : len(tok)], mask[row, : len(tok)] = tok, True
    config = dataclasses.replace(jxlnet.TINY_XLNET, vocab_size=40)
    params = jax_tree(jxlnet, config, 5)
    got, want = run_both("xlnet", params, ids, mask, config,
                         port_config(config, txlnet.XLNetConfig))
    assert_fp32_close(got, want)


def test_xlnet_rel_shift_and_sinusoid_equal_jax():
    x = np.random.RandomState(6).randn(2, 3, 5, 10).astype(np.float32)
    np.testing.assert_array_equal(
        txlnet._rel_shift(torch.from_numpy(x), 5).numpy(),
        np.asarray(jxlnet._rel_shift(jnp.asarray(x), 5)))
    np.testing.assert_array_equal(
        txlnet._sinusoid_pos_emb(37, 32),
        np.asarray(jxlnet._sinusoid_pos_emb(37, 32)))


@pytest.mark.parametrize("conv_spec", [((8, 3), (16, 3)), ((8, 4), (16, 2))],
                         ids=["odd", "even"])
def test_cpcprot_encode_equals_jax(conv_spec):
    """z and c of a batch of patch ids; the even kernel widths pad
    ((k-1)//2, k//2) in both packages."""
    jconfig = dataclasses.replace(jcpc.TINY_CPCPROT, conv_spec=conv_spec)
    tconfig = port_config(jconfig, tcpc.CPCProtConfig)
    params = jax_tree(jcpc, jconfig, 7)
    ids = np.random.RandomState(8).randint(0, 30, (3, 5, 4)).astype(np.int32)
    zw, cw = jcpc.encode(params, jnp.asarray(ids), jconfig)
    zg, cg = tcpc.encode(params_to_torch(params, "cpu"),
                         torch.from_numpy(ids), tconfig)
    assert_fp32_close(zg.numpy(), zw)
    assert_fp32_close(cg.numpy(), cw)


def test_elmo_char_cnn_table_equals_jax():
    params = jax_tree(jelmo, jelmo.TINY_ELMO, 9)
    want = jelmo.char_cnn_table(params, jelmo.TINY_ELMO)
    got = telmo.char_cnn_table(params_to_torch(params, "cpu"), telmo.TINY_ELMO)
    assert got.shape == (len(telmo.AA_ORDER) + 2, telmo.TINY_ELMO.proj_dim)
    assert_fp32_close(got.numpy(), want)


def test_albert_layer_sharing():
    """ALBERT's one shared block runs num_layers times: the port equals the
    same block listed num_layers times without sharing, and equals JAX."""
    jconfig = jbert.BertConfig(
        vocab_size=30, d_model=32, d_ff=64, num_layers=3, num_heads=4,
        max_positions=64, pre_norm=False, share_layers=True, embed_dim=16,
        gelu_exact=False, layer_norm_eps=1e-12,
    )
    params = jax_tree(jbert, jconfig, 10)
    assert len(params["layers"]) == 1 and "emb_proj" in params
    ids, mask = padded_batch(np.random.RandomState(11), 30, [12, 6])
    tconfig = port_config(jconfig, tbert.BertConfig)
    got, want = run_both("bert", params, ids, mask, jconfig, tconfig)
    assert_fp32_close(got, want)
    unshared = dict(params, layers=params["layers"] * 3)
    again = tbert.encode(
        params_to_torch(unshared, "cpu"), torch.from_numpy(ids),
        torch.from_numpy(mask),
        dataclasses.replace(tconfig, share_layers=False)).numpy()
    np.testing.assert_array_equal(again, got)


def test_tokenizers_equal_jax_on_rare_residues():
    """Every tokenizer gives JAX's ids, rare residues X U Z B O (and an
    unknown letter J, lower case) included."""
    seqs = ["MKXUZBOAC", "xuzbojlm", "O", "ACDEFGHIKLMNPQRSTVWYXUZBOJ"]
    pairs = [
        (jelmo.tokenize, telmo.tokenize),
        (jbert.tokenize_esm, tbert.tokenize_esm),
        (jbert.tokenize_bert, tbert.tokenize_bert),
        (jxlnet.tokenize, txlnet.tokenize),
        (junirep.tokenize, tunirep.tokenize),
        (jplus.tokenize, tplus.tokenize),
        (jt5.tokenize, tt5.tokenize),
        (lambda s: jcpc.tokenize_patches(s, jcpc.TINY_CPCPROT),
         lambda s: tcpc.tokenize_patches(s, tcpc.TINY_CPCPROT)),
    ]
    for jfn, tfn in pairs:
        for seq in seqs:
            want, got = jfn(seq), tfn(seq)
            assert got.dtype == want.dtype
            np.testing.assert_array_equal(got, want)
    for name in ("ESM_VOCAB", "BERT_VOCAB"):
        assert getattr(tbert, name) == getattr(jbert, name)
    assert txlnet.XLNET_VOCAB == jxlnet.XLNET_VOCAB
    assert tunirep.UNIREP_VOCAB == junirep.UNIREP_VOCAB
    assert tplus.PLUS_VOCAB == jplus.PLUS_VOCAB
    assert tcpc.CPC_VOCAB == jcpc.CPC_VOCAB
    np.testing.assert_array_equal(telmo._char_ids_for_alphabet(),
                                  jelmo._char_ids_for_alphabet())


def test_published_configs_equal_jax():
    pairs = [(jelmo.SEQVEC, telmo.SEQVEC), (jbert.ESM1B, tbert.ESM1B),
             (jbert.PROTBERT, tbert.PROTBERT),
             (jbert.PROTALBERT, tbert.PROTALBERT),
             (jxlnet.PROTXLNET, txlnet.PROTXLNET),
             (junirep.UNIREP, tunirep.UNIREP),
             (jplus.PLUS_RNN, tplus.PLUS_RNN),
             (jcpc.CPCPROT, tcpc.CPCPROT)]
    for jc, tc in pairs:
        assert port_config(jc, type(tc)) == tc
        assert tc.dtype == torch.float32


def test_embedders_keys_equal_jax():
    assert list(tregistry.EMBEDDERS) == list(jregistry.EMBEDDERS)
    for name in tregistry.EMBEDDERS:
        if name == "AA Composition":
            continue
        with pytest.raises(ValueError, match="checkpoint"):
            tregistry.get_embedder(name, device="cpu")
    with pytest.raises(KeyError, match="available"):
        tregistry.get_embedder("No such embedder", device="cpu")


def test_tree_encoder_round_trip():
    params = params_to_torch(jax_tree(jelmo, jelmo.TINY_ELMO, 12), "cpu")
    encoder = telmo.ElmoEncoder(telmo.TINY_ELMO, params)
    assert isinstance(encoder, TreeEncoder)
    back = encoder.params()
    assert len(back["lstm_fwd"]) == 2 and len(back["convs"]) == 3
    assert torch.equal(back["lstm_bwd"][1]["w_proj"],
                       params["lstm_bwd"][1]["w_proj"])
    assert all(not p.requires_grad for p in encoder.parameters())
    n = sum(p.numel() for p in encoder.parameters())
    assert n == sum(np.size(x) for x in jax.tree.leaves(
        jax_tree(jelmo, jelmo.TINY_ELMO, 12)))


# --- the registry: all 13 keys ------------------------------------------------

ESM_TINY = dataclasses.replace(jbert.TINY_BERT, position_offset=2)
ALBERT_TINY = jbert.BertConfig(
    vocab_size=34, d_model=32, d_ff=64, num_layers=2, num_heads=4,
    max_positions=64, pre_norm=False, share_layers=True, embed_dim=16,
    gelu_exact=False, layer_norm_eps=1e-12,
)
PROTBERT_TINY = dataclasses.replace(jbert.TINY_BERT, pre_norm=False,
                                    layer_norm_eps=1e-12)
XLNET_TINY = dataclasses.replace(jxlnet.TINY_XLNET, vocab_size=40)

# key → (JAX module, JAX config, port config class, extra kwargs)
KEYS = {
    "ProtT5 XL U50": (jt5, jt5.TINY, tt5.T5Config, {}),
    "ProtT5-BFD": (jt5, jt5.TINY, tt5.T5Config, {}),
    "ProtT5 UniRef50": (jt5, jt5.TINY, tt5.T5Config, {}),
    "SeqVec": (jelmo, jelmo.TINY_ELMO, telmo.ElmoConfig,
               {"max_batch_tokens": 256}),
    "ESM": (jbert, ESM_TINY, tbert.BertConfig, {"token_budget": 256}),
    "ESM1b": (jbert, ESM_TINY, tbert.BertConfig, {"token_budget": 256}),
    "ProtBert BFD": (jbert, PROTBERT_TINY, tbert.BertConfig,
                     {"token_budget": 256}),
    "ProtAlbert BFD": (jbert, ALBERT_TINY, tbert.BertConfig,
                       {"token_budget": 256}),
    "UniRep": (junirep, junirep.TINY_UNIREP, tunirep.UniRepConfig,
               {"token_budget": 256}),
    "ProtXLNet UniRef100": (jxlnet, XLNET_TINY, txlnet.XLNetConfig,
                            {"token_budget": 256}),
    "CPCProt": (jcpc, jcpc.TINY_CPCPROT, tcpc.CPCProtConfig,
                {"batch_size": 3}),
    "PLUS": (jplus, jplus.TINY_PLUS, tplus.PlusRnnConfig,
             {"token_budget": 256}),
}


def mixed_sequences(seed=13, n=9):
    """Lengths 3..60 in no order, rare residues included, so batching
    sorts, splits (the small budgets above) and un-sorts."""
    rng = np.random.RandomState(seed)
    letters = list(AAS) + list("XUZBO")
    return ["".join(rng.choice(letters, int(k)))
            for k in rng.randint(3, 60, n)]


def port_config_for(key):
    _, jconfig, tcls, _ = KEYS[key]
    if tcls is tt5.T5Config:
        fields = {f: getattr(jconfig, f) for f in (
            "vocab_size", "d_model", "d_kv", "d_ff", "num_layers",
            "num_heads", "rel_buckets", "rel_max_distance")}
        return tt5.T5Config(**fields)
    return port_config(jconfig, tcls)


@pytest.mark.parametrize("key", list(KEYS))
def test_registry_key_pooled_equals_jax(key):
    """Each neural key, given the JAX init_params tree, pools to JAX's
    vectors; per-residue outputs keep their lengths and input order."""
    jmod, jconfig, _, kwargs = KEYS[key]
    params = jax_tree(jmod, jconfig, 14)
    seqs = mixed_sequences()
    jemb = jregistry.get_embedder(key, params=params, config=jconfig, **kwargs)
    temb = tregistry.get_embedder(key, params=params,
                                  config=port_config_for(key), device="cpu",
                                  **kwargs)
    assert temb.dim == jemb.dim and temb.name == jemb.name
    want = jemb.embed_pooled(seqs)
    got = temb.embed_pooled(seqs)
    if jmod is jt5:
        assert got.shape == want.shape
        err = np.abs(got - want).max()
        assert err <= 2.0**-6 * np.abs(want).max(), err
        return
    assert_fp32_close(got, want)
    per_residue = list(temb.embed_per_residue(seqs))
    for seq, emb, jemb_r in zip(seqs, per_residue,
                                jemb.embed_per_residue(seqs)):
        assert emb.shape == np.asarray(jemb_r).shape
        if key != "CPCProt":
            assert emb.shape[-2] == len(seq)


def test_registry_aa_composition_equals_jax():
    seqs = mixed_sequences()
    np.testing.assert_array_equal(
        tregistry.get_embedder("AA Composition").embed_pooled(seqs),
        jregistry.get_embedder("AA Composition").embed_pooled(seqs))


def test_seqvec_layer_variants_equal_jax():
    params = jax_tree(jelmo, jelmo.TINY_ELMO, 15)
    seqs = mixed_sequences(16)
    want = jregistry.SeqVecEmbedder(params=params, config=jelmo.TINY_ELMO,
                                    max_batch_tokens=256)
    got = tregistry.SeqVecEmbedder(params=params, config=telmo.TINY_ELMO,
                                   max_batch_tokens=256, device="cpu")
    jv, tv = want.embed_layer_variants(seqs), got.embed_layer_variants(seqs)
    assert list(tv) == ["SeqVec Sum", "SeqVec CharCNN", "SeqVec LSTM1",
                        "SeqVec LSTM2"] == list(jv)
    for name in tv:
        assert tv[name].shape == (len(seqs), 32)
        assert_fp32_close(tv[name], jv[name])
    np.testing.assert_allclose(tv["SeqVec Sum"], tv["SeqVec CharCNN"]
                               + tv["SeqVec LSTM1"] + tv["SeqVec LSTM2"],
                               rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("key", ["ESM1b", "ProtBert BFD"])
def test_bert_truncation_at_max_positions(key):
    """ESM's learned positions (1026 rows, offset 2) leave 1022 residues: a
    1100-aa protein is cut there, as in JAX; a BERT table of 64 rows leaves
    62 (cls + residues + sep)."""
    if key == "ESM1b":
        jconfig = dataclasses.replace(ESM_TINY, max_positions=1026)
        length, keep = 1100, 1022
    else:
        jconfig, length, keep = PROTBERT_TINY, 80, 62
    params = jax_tree(jbert, jconfig, 17)
    rng = np.random.RandomState(18)
    seqs = ["".join(rng.choice(list(AAS), length)), "MKVLA"]
    temb = tregistry.get_embedder(key, params=params,
                                  config=port_config(jconfig, tbert.BertConfig),
                                  device="cpu")
    jemb = jregistry.get_embedder(key, params=params, config=jconfig)
    assert temb.max_len == jemb.max_len == keep
    got = list(temb.embed_per_residue(seqs))
    want = list(jemb.embed_per_residue(seqs))
    assert got[0].shape == (keep, 32) and got[1].shape == (5, 32)
    for g, w in zip(got, want):
        assert_fp32_close(g, w)
