"""The port's checkpoint converters (knn_for_homology_tpu_torch/models/
convert.py) against the JAX package's, on synthetic checkpoint files this
file writes itself (random tiny HF / torch models, a bilm-tf hdf5, a
churchlab npy dump): the same file must give a bit-equal parameter tree
(same keys, same layout, every leaf the same fp32 bits; T5's the values
rounded to bf16 as the JAX converter rounds them) and an equal config.
Then the registry and `load_t5_checkpoint` take such a directory in place,
as the JAX package's do. The file writers are copies of those in
tests/test_hf_parity.py and tests/test_models.py.
"""

import dataclasses
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from knn_for_homology_tpu.models import convert as jconvert
from knn_for_homology_tpu.models import registry as jregistry
from knn_for_homology_tpu_torch.models import convert as tconvert
from knn_for_homology_tpu_torch.models import registry as tregistry

transformers = pytest.importorskip("transformers")


def _leaves(tree):
    """{path: fp32 numpy array} of a JAX or port tree."""
    out = {}
    for key, leaf in tconvert._flatten(tree).items():
        out[key] = np.ascontiguousarray(np.asarray(leaf).astype(np.float32))
    return out


def assert_trees_bit_equal(got, want):
    got, want = _leaves(got), _leaves(want)
    assert list(got) == list(want)
    for key in want:
        assert got[key].shape == want[key].shape, key
        assert np.array_equal(got[key].view(np.uint32),
                              want[key].view(np.uint32)), key


def assert_configs_equal(got, want):
    """Every field the two configs share, the dtype apart (torch vs jnp)."""
    own = {"dtype"}
    tfields = {f.name for f in dataclasses.fields(got)}
    shared = [f.name for f in dataclasses.fields(want)
              if f.name in tfields and f.name not in own]
    assert shared
    for name in shared:
        assert getattr(got, name) == getattr(want, name), name


def _dump(model, cfg, tmp_path):
    (tmp_path / "config.json").write_text(json.dumps(cfg.to_dict()))
    torch.save(model.state_dict(), tmp_path / "pytorch_model.bin")


# --- T5 (an HF directory converts in place) -------------------------------------


def _write_t5_dir(path, safetensors=False):
    hf_cfg = dict(
        vocab_size=32, d_model=16, d_kv=4, d_ff=32, num_layers=2,
        num_heads=4, relative_attention_num_buckets=8,
        relative_attention_max_distance=16,
    )
    path.mkdir(exist_ok=True)
    (path / "config.json").write_text(json.dumps(hf_cfg))
    g = torch.Generator().manual_seed(1)

    def t(*shape):
        return torch.randn(*shape, generator=g) * 0.1

    d, inner, f = 16, 16, 32
    sd = {"shared.weight": t(32, d),
          "encoder.final_layer_norm.weight": torch.ones(d) + t(d),
          "encoder.block.0.layer.0.SelfAttention"
          ".relative_attention_bias.weight": t(8, 4)}
    for i in range(2):
        base = f"encoder.block.{i}"
        sd.update({
            f"{base}.layer.0.SelfAttention.q.weight": t(inner, d),
            f"{base}.layer.0.SelfAttention.k.weight": t(inner, d),
            f"{base}.layer.0.SelfAttention.v.weight": t(inner, d),
            f"{base}.layer.0.SelfAttention.o.weight": t(d, inner),
            f"{base}.layer.0.layer_norm.weight": torch.ones(d),
            f"{base}.layer.1.DenseReluDense.wi.weight": t(f, d),
            f"{base}.layer.1.DenseReluDense.wo.weight": t(d, f),
            f"{base}.layer.1.layer_norm.weight": torch.ones(d),
        })
    if safetensors:
        from safetensors.torch import save_file

        save_file({k: v.contiguous() for k, v in sd.items()},
                  path / "model.safetensors")
    else:
        torch.save(sd, path / "pytorch_model.bin")
    return path


@pytest.mark.parametrize("fmt", ["bin", "safetensors"])
def test_convert_t5_from_hf_bit_equal(tmp_path, fmt):
    path = _write_t5_dir(tmp_path / "t5", safetensors=fmt == "safetensors")
    for jdt, tdt in ((None, None), (jnp.float32, torch.float32)):
        jcfg, jtree = jconvert.convert_t5_from_hf(path, dtype=jdt)
        tcfg, ttree = tconvert.convert_t5_from_hf(path, dtype=tdt)
        assert_configs_equal(tcfg, jcfg)
        assert tcfg.dtype == (tdt or torch.bfloat16)
        assert_trees_bit_equal(ttree, jtree)


def test_load_t5_checkpoint_converts_hf_dir_in_place(tmp_path):
    """The port's load_t5_checkpoint takes an HF directory as the JAX
    function does, with no JAX step between."""
    path = _write_t5_dir(tmp_path / "t5")
    jcfg, jparams, jvocab = jconvert.load_t5_checkpoint(path)
    tcfg, tparams, tvocab = tconvert.load_t5_checkpoint(path, device="cpu")
    assert tvocab is None and jvocab is None
    assert_configs_equal(tcfg, jcfg)
    assert tcfg.dtype == torch.bfloat16
    assert all(x.dtype == torch.bfloat16 for x in jax.tree.leaves(
        tparams, is_leaf=lambda x: isinstance(x, torch.Tensor)))
    assert_trees_bit_equal(tparams, jparams)
    # the registry embeds through it, equal to JAX's embedder
    seqs = ["MKVLAGDT", "PQRS"]
    got = tregistry.ProtT5Embedder(checkpoint=path, device="cpu")
    want = jregistry.ProtT5Embedder(checkpoint=path)
    np.testing.assert_array_equal(got.embed_pooled(seqs).shape, (2, 16))
    err = np.abs(got.embed_pooled(seqs) - want.embed_pooled(seqs)).max()
    assert err <= 2.0**-6 * np.abs(want.embed_pooled(seqs)).max()


# --- BERT family ------------------------------------------------------------------


def _write_bert_dir(path, token_types):
    """A synthetic HF BertModel checkpoint, written key by key."""
    path.mkdir(exist_ok=True)
    hf_cfg = dict(
        vocab_size=30, hidden_size=16, intermediate_size=32,
        num_hidden_layers=2, num_attention_heads=4,
        max_position_embeddings=24, layer_norm_eps=1e-12,
    )
    (path / "config.json").write_text(json.dumps(hf_cfg))
    g = torch.Generator().manual_seed(0)

    def t(*shape):
        return torch.randn(*shape, generator=g) * 0.1

    d, f = 16, 32
    sd = {
        "bert.embeddings.word_embeddings.weight": t(30, d),
        "bert.embeddings.position_embeddings.weight": t(24, d),
        "bert.embeddings.LayerNorm.weight": torch.ones(d) + t(d),
        "bert.embeddings.LayerNorm.bias": t(d),
    }
    if token_types:
        sd["bert.embeddings.token_type_embeddings.weight"] = t(2, d)
    for i in range(2):
        base = f"bert.encoder.layer.{i}"
        for name, shape in [
            ("attention.self.query", (d, d)), ("attention.self.key", (d, d)),
            ("attention.self.value", (d, d)),
            ("attention.output.dense", (d, d)),
            ("intermediate.dense", (f, d)), ("output.dense", (d, f)),
        ]:
            sd[f"{base}.{name}.weight"] = t(*shape)
            sd[f"{base}.{name}.bias"] = t(shape[0])
        for name in ("attention.output.LayerNorm", "output.LayerNorm"):
            sd[f"{base}.{name}.weight"] = torch.ones(d) + t(d)
            sd[f"{base}.{name}.bias"] = t(d)
    torch.save(sd, path / "pytorch_model.bin")
    return path


@pytest.mark.parametrize("token_types", [True, False])
def test_convert_bert_from_hf_bit_equal(tmp_path, token_types):
    path = _write_bert_dir(tmp_path / "bert", token_types)
    jcfg, jtree = jconvert.convert_bert_from_hf(path)
    tcfg, ttree = tconvert.convert_bert_from_hf(path)
    assert ("token_type_row" in ttree) == token_types
    assert_configs_equal(tcfg, jcfg)
    assert_trees_bit_equal(ttree, jtree)


def _write_esm_dir(path, token_dropout, vocab_txt=False):
    path.mkdir(exist_ok=True)
    cfg = transformers.EsmConfig(
        vocab_size=33, hidden_size=32, num_hidden_layers=2,
        num_attention_heads=4, intermediate_size=64,
        max_position_embeddings=40, position_embedding_type="absolute",
        emb_layer_norm_before=True, token_dropout=token_dropout,
        pad_token_id=1, mask_token_id=32, hidden_dropout_prob=0.0,
        attention_probs_dropout_prob=0.0,
    )
    torch.manual_seed(0)
    _dump(transformers.EsmModel(cfg, add_pooling_layer=False).eval(), cfg,
          path)
    if vocab_txt:
        (path / "vocab.txt").write_text(
            "\n".join(["<cls>", "<pad>", "<eos>", "<unk>"]
                      + list("ACDEFGHIKLMNPQRSTVWYXBUZO")))
    return path


@pytest.mark.parametrize("token_dropout", [False, True])
def test_convert_esm_from_hf_bit_equal(tmp_path, token_dropout):
    path = _write_esm_dir(tmp_path / "esm", token_dropout)
    jcfg, jtree = jconvert.convert_esm_from_hf(path)
    tcfg, ttree = tconvert.convert_esm_from_hf(path)
    assert tcfg.pre_norm and tcfg.position_offset == 2
    assert_configs_equal(tcfg, jcfg)
    assert_trees_bit_equal(ttree, jtree)


def test_convert_esm_refuses_rotary(tmp_path):
    cfg = transformers.EsmConfig(
        vocab_size=33, hidden_size=32, num_hidden_layers=1,
        num_attention_heads=4, intermediate_size=64,
        position_embedding_type="rotary",
    )
    _dump(transformers.EsmModel(cfg, add_pooling_layer=False), cfg, tmp_path)
    with pytest.raises(ValueError, match="rotary"):
        tconvert.convert_esm_from_hf(tmp_path)


def test_convert_albert_from_hf_bit_equal(tmp_path):
    cfg = transformers.AlbertConfig(
        vocab_size=30, embedding_size=16, hidden_size=32,
        num_hidden_layers=3, num_attention_heads=4, intermediate_size=64,
        max_position_embeddings=48, hidden_dropout_prob=0.0,
        attention_probs_dropout_prob=0.0, classifier_dropout_prob=0.0,
    )
    torch.manual_seed(0)
    _dump(transformers.AlbertModel(cfg).eval(), cfg, tmp_path)
    jcfg, jtree = jconvert.convert_albert_from_hf(tmp_path)
    tcfg, ttree = tconvert.convert_albert_from_hf(tmp_path)
    assert tcfg.share_layers and tcfg.embed_dim == 16
    assert len(ttree["layers"]) == 1
    assert_configs_equal(tcfg, jcfg)
    assert_trees_bit_equal(ttree, jtree)


def test_convert_xlnet_from_hf_bit_equal(tmp_path):
    cfg = transformers.XLNetConfig(
        vocab_size=30, d_model=32, n_layer=3, n_head=4, d_inner=64,
        dropout=0.0, bi_data=False, attn_type="bi", untie_r=True,
    )
    torch.manual_seed(0)
    _dump(transformers.XLNetModel(cfg).eval(), cfg, tmp_path)
    jcfg, jtree = jconvert.convert_xlnet_from_hf(tmp_path)
    tcfg, ttree = tconvert.convert_xlnet_from_hf(tmp_path)
    assert_configs_equal(tcfg, jcfg)
    assert_trees_bit_equal(ttree, jtree)


def test_read_hf_tokenizer_vocab_equal(tmp_path):
    d1 = tmp_path / "wp"
    d1.mkdir()
    (d1 / "vocab.txt").write_text(
        "\n".join(["[PAD]", "[UNK]", "[CLS]", "[SEP]", "[MASK]"]
                  + list("ACDEFGHIKLMNPQRSTVWY")))
    d2 = tmp_path / "sp"
    d2.mkdir()
    (d2 / "tokenizer.json").write_text(json.dumps({
        "model": {"vocab": [["<pad>", 0.0], ["▁L", -1.0], ["▁A", -2.0],
                            ["G", -3.0]]}}))
    d3 = tmp_path / "bpe"
    d3.mkdir()
    (d3 / "tokenizer.json").write_text(json.dumps({
        "model": {"vocab": {"<s>": 0, "▁m": 5, "K": 6, "ab": 7}}}))
    d4 = tmp_path / "none"
    d4.mkdir()
    for d in (d1, d2, d3, d4):
        assert tconvert.read_hf_tokenizer_vocab(d) == \
            jconvert.read_hf_tokenizer_vocab(d)
    assert tconvert.read_hf_tokenizer_vocab(d2) == {"L": 1, "A": 2, "G": 3}
    assert tconvert.read_hf_tokenizer_vocab(d4) is None


@pytest.mark.parametrize("arch", ["ESM1b", "ProtBert BFD", "ProtAlbert BFD"])
def test_bert_embedder_takes_hf_dir(tmp_path, arch):
    """The registry converts an HF directory in place (and reads its
    vocab.txt), pooling to the JAX embedder's vectors."""
    if arch == "ESM1b":
        path = _write_esm_dir(tmp_path / "m", True, vocab_txt=True)
    elif arch == "ProtBert BFD":
        path = _write_bert_dir(tmp_path / "m", True)
    else:
        cfg = transformers.AlbertConfig(
            vocab_size=30, embedding_size=16, hidden_size=32,
            num_hidden_layers=2, num_attention_heads=4, intermediate_size=64,
            max_position_embeddings=48)
        torch.manual_seed(1)
        path = tmp_path / "m"
        path.mkdir()
        _dump(transformers.AlbertModel(cfg).eval(), cfg, path)
    seqs = ["MKVLAGD", "AC", "WYQRSTAAKL"]
    got = tregistry.get_embedder(arch, checkpoint=path, device="cpu")
    want = jregistry.get_embedder(arch, checkpoint=path)
    assert got.vocab == want.vocab
    g, w = got.embed_pooled(seqs), want.embed_pooled(seqs)
    assert g.shape == w.shape
    assert np.abs(g - w).max() <= 1e-5 * max(1.0, np.abs(w).max())


def test_xlnet_embedder_takes_hf_dir(tmp_path):
    cfg = transformers.XLNetConfig(
        vocab_size=40, d_model=32, n_layer=2, n_head=4, d_inner=64,
        dropout=0.0, bi_data=False, attn_type="bi")
    torch.manual_seed(2)
    _dump(transformers.XLNetModel(cfg).eval(), cfg, tmp_path)
    seqs = ["MKVLAGD", "AC", "WYQRSTAAKL"]
    got = tregistry.XLNetEmbedder(checkpoint=tmp_path, device="cpu")
    want = jregistry.XLNetEmbedder(checkpoint=tmp_path)
    g, w = got.embed_pooled(seqs), want.embed_pooled(seqs)
    assert np.abs(g - w).max() <= 1e-5 * max(1.0, np.abs(w).max())


# --- CPCProt and PLUS (torch state dicts) -----------------------------------------


def _write_cpcprot(path, layers=2, kernel=3):
    torch.manual_seed(0)
    sd = {"encoder.embedding.weight": torch.randn(30, 8)}
    in_ch = 8
    for i in range(layers):
        out_ch = 8 + 4 * i
        conv = torch.nn.Conv1d(in_ch, out_ch, kernel)
        sd[f"encoder.conv{i}.weight"] = conv.weight.detach()
        sd[f"encoder.conv{i}.bias"] = conv.bias.detach()
        in_ch = out_ch
    gru = torch.nn.GRU(input_size=in_ch, hidden_size=6, batch_first=True)
    sd.update({f"autoregressor.{k}": v for k, v in gru.state_dict().items()})
    torch.save(sd, path)
    return path


@pytest.mark.parametrize("layers,kernel", [(2, 3), (11, 3), (2, 4)],
                         ids=["two", "eleven-natural-order", "even-width"])
def test_convert_cpcprot_from_torch_bit_equal(tmp_path, layers, kernel):
    path = _write_cpcprot(tmp_path / "cpc.pt", layers, kernel)
    jcfg, jtree = jconvert.convert_cpcprot_from_torch(path, patch_len=4)
    tcfg, ttree = tconvert.convert_cpcprot_from_torch(path, patch_len=4)
    assert tcfg.conv_spec == tuple((8 + 4 * i, kernel) for i in range(layers))
    assert_configs_equal(tcfg, jcfg)
    assert_trees_bit_equal(ttree, jtree)


def test_cpcprot_embedder_takes_pt(tmp_path):
    path = _write_cpcprot(tmp_path / "cpc.pt")
    seqs = ["MKVLAGDTWYQRSTAAKLMNP", "ACDEFGHIKLM", "MK"]
    got = tregistry.CPCProtEmbedder(checkpoint=path, device="cpu")
    want = jregistry.CPCProtEmbedder(checkpoint=path)
    g, w = got.embed_pooled(seqs), want.embed_pooled(seqs)
    assert g.shape == (3, 12)
    assert np.abs(g - w).max() <= 1e-5 * max(1.0, np.abs(w).max())


def _write_plus_rnn(path):
    torch.manual_seed(0)
    embed = torch.nn.Embedding(21, 8)
    rnn = torch.nn.LSTM(input_size=8, hidden_size=12, num_layers=2,
                        bidirectional=True, batch_first=True)
    sd = {"embed.weight": embed.weight.detach()}
    sd.update({f"rnn.{k}": v for k, v in rnn.state_dict().items()})
    torch.save(sd, path)
    return path


def test_convert_plus_rnn_from_torch_bit_equal(tmp_path):
    path = _write_plus_rnn(tmp_path / "plus_rnn.pt")
    jcfg, jtree = jconvert.convert_plus_rnn_from_torch(path)
    tcfg, ttree = tconvert.convert_plus_rnn_from_torch(path)
    assert tcfg.hidden_dim == 12 and tcfg.num_layers == 2
    assert_configs_equal(tcfg, jcfg)
    assert_trees_bit_equal(ttree, jtree)
    seqs = ["MKVLAGDTWYQ", "ACD", "RSTAAKLMNPXU"]
    got = tregistry.PlusRnnEmbedder(checkpoint=path, device="cpu")
    want = jregistry.PlusRnnEmbedder(checkpoint=path)
    g, w = got.embed_pooled(seqs), want.embed_pooled(seqs)
    assert np.abs(g - w).max() <= 1e-5 * max(1.0, np.abs(w).max())


# --- SeqVec ELMo (bilm-tf hdf5) ------------------------------------------------------


def _write_bilm(path):
    """A bilm-tf weights.hdf5 + options.json of a random tiny bi-LM (gate
    order [i, g, f, o], the forget bias left out of B, [in, 4H] kernels)."""
    h5py = pytest.importorskip("h5py")
    rng = np.random.RandomState(11)
    e, p, h, nh, n_layers = 4, 16, 32, 1, 2
    filters = [(1, 8), (2, 8), (3, 16)]
    total = sum(n for _, n in filters)
    options = {
        "char_cnn": {"embedding": {"dim": e},
                     "filters": [list(f) for f in filters],
                     "n_highway": nh},
        "lstm": {"projection_dim": p, "dim": h, "n_layers": n_layers,
                 "cell_clip": 3.0, "proj_clip": 3.0},
    }
    path.mkdir(exist_ok=True)
    (path / "options.json").write_text(json.dumps(options))

    def r(*shape, scale=0.1):
        return (rng.randn(*shape) * scale).astype(np.float32)

    with h5py.File(path / "weights.hdf5", "w") as fp:
        fp["char_embed"] = r(262, e, scale=0.5)
        for i, (width, n) in enumerate(filters):
            fp[f"CNN/W_cnn_{i}"] = r(1, width, e, n)
            fp[f"CNN/b_cnn_{i}"] = r(n)
        for i in range(nh):
            fp[f"CNN_high_{i}/W_carry"] = r(total, total)
            fp[f"CNN_high_{i}/b_carry"] = r(total)
            fp[f"CNN_high_{i}/W_transform"] = r(total, total)
            fp[f"CNN_high_{i}/b_transform"] = r(total)
        fp["CNN_proj/W_proj"] = r(total, p)
        fp["CNN_proj/b_proj"] = r(p)
        for name in ("RNN_0", "RNN_1"):
            for layer in range(n_layers):
                base = f"{name}/RNN/MultiRNNCell/Cell{layer}/LSTMCell"
                fp[f"{base}/W_0"] = r(p + p, 4 * h, scale=0.3)
                fp[f"{base}/B"] = r(4 * h)
                fp[f"{base}/W_P_0"] = r(h, p, scale=0.3)
    return path


def test_convert_elmo_from_hdf5_bit_equal(tmp_path):
    path = _write_bilm(tmp_path / "seqvec")
    jcfg, jtree = jconvert.convert_elmo_from_hdf5(
        path / "weights.hdf5", path / "options.json")
    tcfg, ttree = tconvert.convert_elmo_from_hdf5(
        path / "weights.hdf5", path / "options.json")
    assert tcfg.lstm_dim == 32 and tcfg.proj_dim == 16
    assert_configs_equal(tcfg, jcfg)
    assert_trees_bit_equal(ttree, jtree)
    # the +1 forget bias sits in [H:2H] of [i, f, g, o]
    with __import__("h5py").File(path / "weights.hdf5", "r") as fp:
        raw = np.asarray(fp["RNN_0/RNN/MultiRNNCell/Cell0/LSTMCell/B"])
    np.testing.assert_array_equal(ttree["lstm_fwd"][0]["b"][32:64],
                                  raw[64:96] + 1.0)


def test_seqvec_checkpoints_load_in_both_packages(tmp_path):
    """load_elmo_checkpoint takes the bilm-tf directory, and a .npz written
    by either package's save_params (config in its meta) loads in the
    other unchanged; the embedders agree on all of them."""
    path = _write_bilm(tmp_path / "seqvec")
    tcfg, ttree = tconvert.load_elmo_checkpoint(path)
    jcfg, jtree = jconvert.load_elmo_checkpoint(path)
    assert_trees_bit_equal(ttree, jtree)
    meta = {"config": {k: v for k, v in dataclasses.asdict(tcfg).items()
                       if k != "dtype"}}
    tconvert.save_params(ttree, tmp_path / "port.npz", meta=meta)
    jconvert.save_params(jtree, tmp_path / "jax.npz", meta=meta)
    for npz in ("port.npz", "jax.npz"):
        jc, jt = jconvert.load_elmo_checkpoint(tmp_path / npz)
        tc, tt = tconvert.load_elmo_checkpoint(tmp_path / npz)
        assert_configs_equal(tc, jc)
        assert_configs_equal(tc, tcfg)
        assert_trees_bit_equal(tt, jtree)
        assert_trees_bit_equal(jt, jtree)
    seqs = ["MKVLAGDTWY", "ACD", "RSTAAKLMNPXU"]
    want = jregistry.SeqVecEmbedder(checkpoint=path).embed_pooled(seqs)
    for ck in (path, tmp_path / "jax.npz"):
        got = tregistry.SeqVecEmbedder(checkpoint=ck,
                                       device="cpu").embed_pooled(seqs)
        assert np.abs(got - want).max() <= 1e-5 * max(1.0, np.abs(want).max())


# --- UniRep (churchlab npy dump) --------------------------------------------------------


def _unirep_tensors(seed, gains=True):
    rng = np.random.RandomState(seed)
    e, h = 6, 12
    tensors = {
        "embed_matrix:0": rng.randn(26, e).astype(np.float32),
        "rnn_mlstm_mlstm_wx:0": rng.randn(e, 4 * h).astype(np.float32),
        "rnn_mlstm_mlstm_wh:0": rng.randn(h, 4 * h).astype(np.float32),
        "rnn_mlstm_mlstm_wmx:0": rng.randn(e, h).astype(np.float32),
        "rnn_mlstm_mlstm_wmh:0": rng.randn(h, h).astype(np.float32),
        "rnn_mlstm_mlstm_b:0": rng.randn(4 * h).astype(np.float32),
    }
    if gains:
        tensors.update({
            "rnn_mlstm_mlstm_gx:0": rng.rand(4 * h).astype(np.float32) + 0.5,
            "rnn_mlstm_mlstm_gh:0": rng.rand(4 * h).astype(np.float32) + 0.5,
            "rnn_mlstm_mlstm_gmx:0": rng.rand(h).astype(np.float32) + 0.5,
            "rnn_mlstm_mlstm_gmh:0": rng.rand(h).astype(np.float32) + 0.5,
        })
    return tensors


@pytest.mark.parametrize("layout", ["npy-dir", "npy-dir-prefused", "npz"])
def test_convert_unirep_bit_equal(tmp_path, layout):
    tensors = _unirep_tensors(7, gains=layout != "npy-dir-prefused")
    if layout == "npz":
        path = tmp_path / "unirep.npz"
        np.savez(path, **{k.replace(":0", ""): v for k, v in tensors.items()})
    else:
        path = tmp_path / "1900_weights"
        path.mkdir()
        for name, arr in tensors.items():
            np.save(path / f"{name}.npy", arr)
    jcfg, jtree = jconvert.convert_unirep_from_npy(path)
    tcfg, ttree = tconvert.convert_unirep_from_npy(path)
    assert tcfg.hidden_dim == 12 and tcfg.embed_dim == 6
    assert_configs_equal(tcfg, jcfg)
    assert_trees_bit_equal(ttree, jtree)
    # load_unirep_checkpoint: the dump, then a save_params .npz of the tree
    lc, lt = tconvert.load_unirep_checkpoint(path)
    assert_trees_bit_equal(lt, jtree)
    meta = {"config": {k: v for k, v in dataclasses.asdict(tcfg).items()
                       if k != "dtype"}}
    tconvert.save_params(ttree, tmp_path / "ours.npz", meta=meta)
    jc, jt = jconvert.load_unirep_checkpoint(tmp_path / "ours.npz")
    assert_configs_equal(tcfg, jc)
    assert_trees_bit_equal(jt, jtree)
    seqs = ["MKVLAGDTWY", "ACD"]
    got = tregistry.UniRepEmbedder(checkpoint=path,
                                   device="cpu").embed_pooled(seqs)
    want = jregistry.UniRepEmbedder(checkpoint=path).embed_pooled(seqs)
    assert np.abs(got - want).max() <= 1e-5 * max(1.0, np.abs(want).max())


def test_params_to_torch_keeps_layout_and_values():
    tree = {"a": [np.ones((2, 3), np.float32), np.arange(4, dtype=np.float32)],
            "b": {"c": torch.full((5,), 0.5, dtype=torch.float64)},
            "d": np.asarray(jnp.asarray([1.5, -2.25], jnp.bfloat16))}
    out = tconvert.params_to_torch(tree, "cpu")
    assert out["a"][0].shape == (2, 3) and out["a"][1].dtype == torch.float32
    assert out["b"]["c"].dtype == torch.float32
    assert out["d"].tolist() == [1.5, -2.25]
    bf = tconvert.params_to_torch(tree, "cpu", torch.bfloat16)
    assert bf["a"][1].dtype == torch.bfloat16
