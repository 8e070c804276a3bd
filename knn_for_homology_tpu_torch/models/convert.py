"""Checkpoint conversion and the native checkpoint format (port of
knn_for_homology_tpu/models/convert.py).

A converted checkpoint is a flat .npz: one array per leaf of the parameter
tree, keyed by its path ("layers/0/attn/q"), bf16 leaves stored as fp32
(lossless), and the config and an optional vocabulary as JSON under
"__meta__". Both packages write and read the same files.

The converters read upstream checkpoints (no downloads: the files must be
local) and return (config, tree): the tree holds numpy fp32 arrays with the
same keys and layout as the JAX converters' trees ([in, out] weights), each
value the one the JAX converter holds (for T5, rounded to the config's
dtype). `params_to_torch` carries such a tree, or a JAX package's tree as
numpy arrays, into tensors on a device. The converters:

  * HF ProtT5 (pytorch_model.bin / model.safetensors) → T5
  * HF BERT / ESM-1b / ALBERT / XLNet → models/bert.py, models/xlnet.py
  * torch CPCProt and PLUS-RNN state dicts
  * SeqVec ELMo (bilm-tf weights.hdf5 + options.json)
  * UniRep (churchlab npy dump / npz)
"""

import json
import re
from pathlib import Path
from typing import Any, Dict, Optional, Tuple

import numpy as np
import torch

from ..device import resolve_device
from .module import flatten_tree, unflatten_tree
from .t5 import Params, T5Config

# --- flat npz checkpoint format -----------------------------------------------


def _flatten(tree: Any) -> Dict[str, np.ndarray]:
    out = {}
    for key, leaf in flatten_tree(tree).items():
        if isinstance(leaf, torch.Tensor):
            leaf = leaf.detach().float().cpu().numpy()
        arr = np.asarray(leaf)
        if arr.dtype.kind == "V" or arr.dtype.name == "bfloat16":
            arr = arr.astype(np.float32)  # bf16 saves as fp32, losslessly
        out[key] = arr
    return out


def save_params(params: Any, path: Path, meta: Dict[str, Any] = None) -> None:
    """Write a parameter tree (numpy arrays or tensors) as a flat .npz."""
    flat = _flatten(params)
    if meta:
        flat["__meta__"] = np.frombuffer(
            json.dumps(meta).encode(), dtype=np.uint8
        )
    np.savez(path, **flat)
    if Path(path).suffix != ".npz":
        Path(str(path) + ".npz").replace(path)


def load_params(path: Path) -> Tuple[Any, Dict[str, Any]]:
    """→ (tree of numpy arrays, meta)."""
    with np.load(path, allow_pickle=False) as data:
        flat = {k: data[k] for k in data.files}
    meta = {}
    if "__meta__" in flat:
        meta = json.loads(bytes(flat.pop("__meta__")).decode())
    return unflatten_tree(flat), meta


def params_to_torch(
    tree: Any, device="cuda", dtype: torch.dtype = torch.float32
) -> Any:
    """A parameter tree (numpy arrays of any float dtype, bf16 included, or
    tensors) → the same tree of `dtype` tensors on `device`, the layout
    unchanged. Every family's encoder takes its tree this way."""
    device = resolve_device(device)

    def convert(node):
        if isinstance(node, dict):
            return {k: convert(v) for k, v in node.items()}
        if isinstance(node, (list, tuple)):
            return [convert(v) for v in node]
        if isinstance(node, torch.Tensor):
            return node.to(device=device, dtype=dtype)
        arr = np.asarray(node).astype(np.float32)  # bf16 → fp32 is exact
        return torch.from_numpy(arr).to(device=device, dtype=dtype)

    return convert(tree)


def _round_to(arr: np.ndarray, dtype: torch.dtype) -> np.ndarray:
    """fp32 array holding the values of `arr` rounded to `dtype` (round to
    nearest even, as the JAX converter's cast rounds)."""
    arr = np.ascontiguousarray(arr, dtype=np.float32)
    if dtype == torch.float32:
        return arr
    return torch.from_numpy(arr).to(dtype).float().numpy()


def _meta_vocab(meta) -> Optional[Dict[str, int]]:
    vocab = meta.get("vocab")
    if vocab is None:
        return None
    return {str(k): int(v) for k, v in vocab.items()}


def load_converted(path: Path, config_cls, default=None):
    """A converted .npz → (config from its meta, else `default`, else
    config_cls(); tree of numpy arrays; vocab from its meta or None)."""
    tree, meta = load_params(path)
    cfg = dict(meta.get("config", {}))
    for key in ("filters", "conv_spec"):  # JSON lists back to tuples
        if key in cfg:
            cfg[key] = tuple(tuple(int(x) for x in row) for row in cfg[key])
    if cfg or default is None:
        config = config_cls(**cfg)
    else:
        config = default
    return config, tree, _meta_vocab(meta)


# --- HF ProtT5 → T5 params ------------------------------------------------------


def _read_hf_state_dict(model_dir: Path) -> Dict[str, np.ndarray]:
    model_dir = Path(model_dir)
    safetensors = sorted(model_dir.glob("*.safetensors"))
    if safetensors:
        from safetensors.numpy import load_file

        state: Dict[str, np.ndarray] = {}
        for f in safetensors:
            state.update(load_file(f))
        return state
    bins = sorted(model_dir.glob("pytorch_model*.bin"))
    if not bins:
        raise FileNotFoundError(f"no checkpoint files in {model_dir}")
    state = {}
    for f in bins:
        for key, val in _torch_load(f).items():
            state[key] = val.float().numpy()
    return state


def _torch_load(path):
    """torch.load restricted to tensors (weights_only), so converting an
    untrusted downloaded .bin cannot execute pickle code."""
    return torch.load(path, map_location="cpu", weights_only=True)


def _read_torch_state_dict(path: Path) -> Dict[str, np.ndarray]:
    """A checkpoint directory (HF layout) or one torch .pt/.bin file."""
    path = Path(path)
    if path.is_dir():
        return _read_hf_state_dict(path)
    return {k: v.float().numpy() for k, v in _torch_load(path).items()}


def _hf_config(model_dir: Path) -> Dict[str, Any]:
    cfg_file = Path(model_dir) / "config.json"
    return json.loads(cfg_file.read_text()) if cfg_file.exists() else {}


def convert_t5_from_hf(
    model_dir: Path, dtype: Optional[torch.dtype] = None
) -> Tuple[T5Config, Params]:
    """HF T5 encoder (e.g. Rostlab/prot_t5_xl_uniref50) → (config, tree).

    HF stores projection weights as [out, in]; ours are [in, out], so every
    matrix is transposed on the way in. Leaves hold the values rounded to
    `dtype` (bf16 by default, the config's dtype)."""
    dtype = dtype or torch.bfloat16
    sd = _read_hf_state_dict(model_dir)
    hf = _hf_config(model_dir)
    config = T5Config(
        vocab_size=hf.get("vocab_size", 128),
        d_model=hf.get("d_model", 1024),
        d_kv=hf.get("d_kv", 128),
        d_ff=hf.get("d_ff", 16384),
        num_layers=hf.get("num_layers", 24),
        num_heads=hf.get("num_heads", 32),
        rel_buckets=hf.get("relative_attention_num_buckets", 32),
        rel_max_distance=hf.get("relative_attention_max_distance", 128),
        dtype=dtype,
    )

    def get(name):
        key = name if name in sd else f"encoder.{name}"
        return np.asarray(sd[key], dtype=np.float32)

    def v(name):
        return _round_to(get(name), dtype)

    def w(name):  # transpose torch [out, in] → [in, out]
        return _round_to(get(name).T, dtype)

    layers = []
    for i in range(config.num_layers):
        base = f"encoder.block.{i}"
        layers.append({
            "attn": {
                "ln": v(f"{base}.layer.0.layer_norm.weight"),
                "q": w(f"{base}.layer.0.SelfAttention.q.weight"),
                "k": w(f"{base}.layer.0.SelfAttention.k.weight"),
                "v": w(f"{base}.layer.0.SelfAttention.v.weight"),
                "o": w(f"{base}.layer.0.SelfAttention.o.weight"),
            },
            "mlp": {
                "ln": v(f"{base}.layer.1.layer_norm.weight"),
                "wi": w(f"{base}.layer.1.DenseReluDense.wi.weight"),
                "wo": w(f"{base}.layer.1.DenseReluDense.wo.weight"),
            },
        })
    params = {
        "embedding": v("shared.weight"),
        "rel_embedding": v(
            "encoder.block.0.layer.0.SelfAttention"
            ".relative_attention_bias.weight"
        ),
        "layers": layers,
        "final_ln": v("encoder.final_layer_norm.weight"),
    }
    return config, params


# route fields of a T5 config that the JAX package keeps and the port
# does not (the port's kernels decide their own reach): a checkpoint's meta
# may carry them, and they are dropped on reading
T5_ROUTE_FIELDS = frozenset(
    {"use_flash_kernel", "use_short_kernel", "short_kernel_max",
     "use_fused_ffn"})


def load_t5_checkpoint(
    path: Path, device="cuda"
) -> Tuple[T5Config, Params, Optional[Dict[str, int]]]:
    """Load a converted .npz, or convert an HF directory in place →
    (config, params on `device` in bf16, vocab). The meta's config may
    carry T5_ROUTE_FIELDS, which are dropped; any other field T5Config
    lacks raises.

    `vocab` is the residue → token-id table stored in the checkpoint's meta
    (key "vocab") when the source tokenizer's ordering differs from the
    published prot_t5 layout, else None (callers fall back to
    t5.PROTT5_VOCAB); an HF directory gives None."""
    path = Path(path)
    if path.is_dir():
        config, tree = convert_t5_from_hf(path)
        return config, params_to_torch(tree, device, config.dtype), None
    tree, meta = load_params(path)
    cfg = {k: v for k, v in meta.get("config", {}).items()
           if k not in T5_ROUTE_FIELDS}
    config = T5Config(**{**cfg, "dtype": torch.bfloat16})
    return config, params_to_torch(tree, device, config.dtype), _meta_vocab(meta)


# --- HF BERT (ProtBert-style) → BertConfig params --------------------------------


def _bert_block(get, w, base: str, names: Dict[str, str]) -> Dict[str, Any]:
    """One encoder block's leaves: names maps our key → the checkpoint's
    name under `base` (weights transposed, vectors as they are)."""
    out = {}
    for ours, theirs in names.items():
        fn = get if theirs.endswith(".bias") or ours.startswith("ln") else w
        out[ours] = fn(f"{base}.{theirs}")
    return out


_BERT_BLOCK = {
    "q": "attention.self.query.weight", "q_b": "attention.self.query.bias",
    "k": "attention.self.key.weight", "k_b": "attention.self.key.bias",
    "v": "attention.self.value.weight", "v_b": "attention.self.value.bias",
    "o": "attention.output.dense.weight",
    "o_b": "attention.output.dense.bias",
    "ln1": "attention.output.LayerNorm.weight",
    "ln1_b": "attention.output.LayerNorm.bias",
    "wi": "intermediate.dense.weight", "wi_b": "intermediate.dense.bias",
    "wo": "output.dense.weight", "wo_b": "output.dense.bias",
    "ln2": "output.LayerNorm.weight", "ln2_b": "output.LayerNorm.bias",
}
# pre-LN ESM: ln1 normalises the attention input, ln2 the feed-forward input
_ESM_BLOCK = {
    **_BERT_BLOCK,
    "ln1": "attention.LayerNorm.weight", "ln1_b": "attention.LayerNorm.bias",
    "ln2": "LayerNorm.weight", "ln2_b": "LayerNorm.bias",
}
_ALBERT_BLOCK = {
    "q": "attention.query.weight", "q_b": "attention.query.bias",
    "k": "attention.key.weight", "k_b": "attention.key.bias",
    "v": "attention.value.weight", "v_b": "attention.value.bias",
    "o": "attention.dense.weight", "o_b": "attention.dense.bias",
    "ln1": "attention.LayerNorm.weight", "ln1_b": "attention.LayerNorm.bias",
    "wi": "ffn.weight", "wi_b": "ffn.bias",
    "wo": "ffn_output.weight", "wo_b": "ffn_output.bias",
    "ln2": "full_layer_layer_norm.weight",
    "ln2_b": "full_layer_layer_norm.bias",
}


def _getters(sd, prefix: str):
    """(has, get, w) over a state dict whose keys may carry `prefix`."""

    def key(name):
        return name if name in sd else f"{prefix}.{name}"

    def has(name):
        return key(name) in sd

    def get(name):
        return np.asarray(sd[key(name)], dtype=np.float32)

    def w(name):  # torch Linear [out, in] → [in, out]
        return np.ascontiguousarray(get(name).T)

    return has, get, w


def convert_bert_from_hf(model_dir: Path, pre_norm: bool = False):
    """HF BertModel state dict (e.g. Rostlab/prot_bert_bfd) → (BertConfig,
    tree of models/bert.py)."""
    from .bert import BertConfig

    sd = _read_hf_state_dict(model_dir)
    hf = _hf_config(model_dir)
    config = BertConfig(
        vocab_size=hf.get("vocab_size", 30),
        d_model=hf.get("hidden_size", 1024),
        d_ff=hf.get("intermediate_size", 4096),
        num_layers=hf.get("num_hidden_layers", 30),
        num_heads=hf.get("num_attention_heads", 16),
        max_positions=hf.get("max_position_embeddings", 40000),
        pre_norm=pre_norm,
        gelu_exact=hf.get("hidden_act", "gelu") == "gelu",
        layer_norm_eps=hf.get("layer_norm_eps", 1e-12),
    )
    has, get, w = _getters(sd, "bert")
    params = {
        "embedding": get("embeddings.word_embeddings.weight"),
        "position_embedding": get("embeddings.position_embeddings.weight"),
        "emb_ln": get("embeddings.LayerNorm.weight"),
        "emb_ln_b": get("embeddings.LayerNorm.bias"),
        "layers": [_bert_block(get, w, f"encoder.layer.{i}", _BERT_BLOCK)
                   for i in range(config.num_layers)],
    }
    # HF adds token_type_embeddings[0] everywhere when token types are 0
    if has("embeddings.token_type_embeddings.weight"):
        params["token_type_row"] = get(
            "embeddings.token_type_embeddings.weight")[0]
    return config, params


# --- HF tokenizer tables -----------------------------------------------------------


def read_hf_tokenizer_vocab(model_dir: Path):
    """Residue → token-id table from the tokenizer files of an HF
    checkpoint directory: tokenizer.json (fast tokenizers; BPE/WordPiece
    dict or unigram list) or vocab.txt (WordPiece). Only single-letter
    pieces are kept (the sentencepiece word-start marker ▁ is stripped),
    so special tokens keep their per-family constants. Returns None when
    no readable tokenizer file exists (e.g. a spiece.model-only checkpoint);
    callers then fall back to the documented default ordering, which must
    be verified against the real tokenizer before trusting embeddings.
    """
    model_dir = Path(model_dir)
    tj = model_dir / "tokenizer.json"
    if tj.exists():
        data = json.loads(tj.read_text())
        vocab = data.get("model", {}).get("vocab")
        table: Dict[str, int] = {}
        if isinstance(vocab, dict):  # BPE / WordPiece
            for tok, idx in vocab.items():
                t = tok.lstrip("▁")
                if len(t) == 1 and t.isalpha():
                    table.setdefault(t.upper(), int(idx))
        elif isinstance(vocab, list):  # unigram: [[piece, score], ...]
            for idx, item in enumerate(vocab):
                t = str(item[0]).lstrip("▁")
                if len(t) == 1 and t.isalpha():
                    table.setdefault(t.upper(), idx)
        if table:
            return table
    vt = model_dir / "vocab.txt"
    if vt.exists():
        table = {}
        for idx, line in enumerate(vt.read_text().splitlines()):
            tok = line.strip()
            if len(tok) == 1 and tok.isalpha():
                table.setdefault(tok.upper(), idx)
        return table or None
    return None


# --- HF ESM (ESM-1b) → BertConfig params ------------------------------------------


def convert_esm_from_hf(model_dir: Path):
    """HF EsmModel state dict (e.g. facebook/esm1b_t33_650M_UR50S) →
    (BertConfig, tree): pre-LN, learned positions offset by
    padding_idx+1=2 (the reference truncates inputs to 1022 residues for
    this model, reference: cath/embed.py:80-82).

    Only position_embedding_type="absolute" (ESM-1b) converts; ESM-2's
    rotary attention is a different architecture.
    """
    from .bert import BertConfig

    sd = _read_hf_state_dict(model_dir)
    hf = _hf_config(model_dir)
    if hf.get("position_embedding_type", "absolute") != "absolute":
        raise ValueError(
            "convert_esm_from_hf handles ESM-1b (absolute positions); "
            f"got position_embedding_type="
            f"{hf.get('position_embedding_type')!r} (ESM-2/rotary)"
        )
    config = BertConfig(
        vocab_size=hf.get("vocab_size", 33),
        d_model=hf.get("hidden_size", 1280),
        d_ff=hf.get("intermediate_size", 5120),
        num_layers=hf.get("num_hidden_layers", 33),
        num_heads=hf.get("num_attention_heads", 20),
        max_positions=hf.get("max_position_embeddings", 1026),
        pre_norm=True,
        gelu_exact=True,
        position_offset=hf.get("pad_token_id", 1) + 1,
        layer_norm_eps=hf.get("layer_norm_eps", 1e-5),
    )
    _, get, w = _getters(sd, "esm")
    embedding = get("embeddings.word_embeddings.weight")
    if hf.get("token_dropout", False):
        # ESM-1b trains with mask-token dropout; at inference with no
        # <mask> in the input HF scales word embeddings by (1 - 0.15*0.8)
        # BEFORE adding positions — folded into the table (the position
        # table is added after, so it stays unscaled)
        embedding = embedding * (1.0 - 0.15 * 0.8)
    params = {
        "embedding": embedding,
        "position_embedding": get("embeddings.position_embeddings.weight"),
        "emb_ln": get("embeddings.layer_norm.weight"),
        "emb_ln_b": get("embeddings.layer_norm.bias"),
        "final_ln": get("encoder.emb_layer_norm_after.weight"),
        "final_ln_b": get("encoder.emb_layer_norm_after.bias"),
        "layers": [_bert_block(get, w, f"encoder.layer.{i}", _ESM_BLOCK)
                   for i in range(config.num_layers)],
    }
    return config, params


# --- HF ALBERT (ProtAlbert-BFD) → BertConfig params -------------------------------


def convert_albert_from_hf(model_dir: Path):
    """HF AlbertModel state dict (e.g. Rostlab/prot_albert) → (BertConfig,
    tree): one shared layer block + the factorized-embedding projection
    (the reference uses bio_embeddings' ProtTransAlbertBFDEmbedder,
    reference: cath/embed.py:17,39)."""
    from .bert import BertConfig

    sd = _read_hf_state_dict(model_dir)
    hf = _hf_config(model_dir)
    config = BertConfig(
        vocab_size=hf.get("vocab_size", 30),
        d_model=hf.get("hidden_size", 4096),
        d_ff=hf.get("intermediate_size", 16384),
        num_layers=hf.get("num_hidden_layers", 12),
        num_heads=hf.get("num_attention_heads", 64),
        max_positions=hf.get("max_position_embeddings", 40000),
        pre_norm=False,
        share_layers=True,
        embed_dim=hf.get("embedding_size", 128),
        gelu_exact=hf.get("hidden_act", "gelu_new") == "gelu",
        layer_norm_eps=hf.get("layer_norm_eps", 1e-12),
    )
    _, get, w = _getters(sd, "albert")
    shared = _bert_block(get, w, "encoder.albert_layer_groups.0.albert_layers.0",
                         _ALBERT_BLOCK)
    params = {
        "embedding": get("embeddings.word_embeddings.weight"),
        "position_embedding": get("embeddings.position_embeddings.weight"),
        "token_type_row": get("embeddings.token_type_embeddings.weight")[0],
        "emb_ln": get("embeddings.LayerNorm.weight"),
        "emb_ln_b": get("embeddings.LayerNorm.bias"),
        "emb_proj": w("encoder.embedding_hidden_mapping_in.weight"),
        "emb_proj_b": get("encoder.embedding_hidden_mapping_in.bias"),
        "layers": [shared],
    }
    return config, params


# --- HF XLNet (ProtXLNet-UniRef100) → XLNetConfig params --------------------------


def convert_xlnet_from_hf(model_dir: Path):
    """HF XLNetModel state dict (e.g. Rostlab/prot_xlnet) → (XLNetConfig,
    tree of models/xlnet.py) (the reference embeds via bio_embeddings'
    XLNet wrapper, reference: cath/embed.py:19,41).

    XLNet's attention projections are stored as [d_model, n_head, d_head]
    Parameters (not Linear modules), so they load without transposition;
    only the feed-forward Linears flip [out, in] → [in, out].
    """
    from .xlnet import XLNetConfig

    sd = _read_hf_state_dict(model_dir)
    hf = _hf_config(model_dir)
    config = XLNetConfig(
        vocab_size=hf.get("vocab_size", 37),
        d_model=hf.get("d_model", 1024),
        d_inner=hf.get("d_inner", 4096),
        num_layers=hf.get("n_layer", 30),
        num_heads=hf.get("n_head", 16),
        layer_norm_eps=hf.get("layer_norm_eps", 1e-12),
    )
    _, get, w = _getters(sd, "transformer")
    attn = ("q", "k", "v", "o", "r", "r_w_bias", "r_r_bias", "r_s_bias",
            "seg_embed")
    layers = []
    for i in range(config.num_layers):
        base = f"layer.{i}"
        layer = {name: get(f"{base}.rel_attn.{name}") for name in attn}
        layer.update({
            "ln_attn": get(f"{base}.rel_attn.layer_norm.weight"),
            "ln_attn_b": get(f"{base}.rel_attn.layer_norm.bias"),
            "ff_w1": w(f"{base}.ff.layer_1.weight"),
            "ff_b1": get(f"{base}.ff.layer_1.bias"),
            "ff_w2": w(f"{base}.ff.layer_2.weight"),
            "ff_b2": get(f"{base}.ff.layer_2.bias"),
            "ln_ff": get(f"{base}.ff.layer_norm.weight"),
            "ln_ff_b": get(f"{base}.ff.layer_norm.bias"),
        })
        layers.append(layer)
    return config, {"embedding": get("word_embedding.weight"), "layers": layers}


# --- CPCProt (torch conv encoder + GRU) → CPCProtConfig params --------------------


def convert_cpcprot_from_torch(
    path: Path,
    embed_key: str = "encoder.embedding.weight",
    gru_prefix: str = "autoregressor.",
    patch_len: int = 11,
):
    """Torch CPCProt checkpoint → (CPCProtConfig, tree of models/cpcprot.py)
    (the reference embeds via bio_embeddings' CPCProtEmbedder, reference:
    cath/embed.py:13,35).

    The conv stack is introspected: every 3-d tensor under `encoder.`
    (torch Conv1d weight [out, in, k], in natural key order) becomes one
    conv layer, transposed to [k, in, out]; the GRU loads with torch's gate
    packing [r|z|n], biases kept apart because torch applies the reset gate
    to (W_hn h + b_hn).
    """
    from .cpcprot import CPCProtConfig

    sd = _read_torch_state_dict(path)

    def get(name):
        return np.asarray(sd[name], dtype=np.float32)

    def natural(key):  # conv10 must sort after conv2
        return [int(part) if part.isdigit() else part
                for part in re.split(r"(\d+)", key)]

    conv_keys = sorted(
        (k for k in sd
         if k.startswith("encoder.") and k.endswith(".weight")
         and np.ndim(sd[k]) == 3),
        key=natural,
    )
    convs, spec = [], []
    for key in conv_keys:
        w = get(key)  # [out, in, k]
        b = get(key[: -len(".weight")] + ".bias")
        convs.append({"w": np.ascontiguousarray(w.transpose(2, 1, 0)), "b": b})
        spec.append((w.shape[0], w.shape[2]))
    embedding = get(embed_key)
    w_ih = get(f"{gru_prefix}weight_ih_l0")  # [3c, z]
    w_hh = get(f"{gru_prefix}weight_hh_l0")
    config = CPCProtConfig(
        vocab_size=embedding.shape[0],
        embed_dim=embedding.shape[1],
        patch_len=patch_len,
        conv_spec=tuple(spec),
        z_dim=w_ih.shape[1],
        c_dim=w_hh.shape[1],
    )
    params = {
        "embedding": embedding,
        "convs": convs,
        "gru": {
            "w_x": np.ascontiguousarray(w_ih.T),
            "w_h": np.ascontiguousarray(w_hh.T),
            "b_x": get(f"{gru_prefix}bias_ih_l0"),
            "b_h": get(f"{gru_prefix}bias_hh_l0"),
        },
    }
    return config, params


# --- PLUS-RNN (torch biLSTM) → PlusRnnConfig params -------------------------------


def convert_plus_rnn_from_torch(
    path: Path, embed_key: str = "embed.weight", prefix: str = "rnn."
):
    """Torch PLUS-RNN checkpoint (embedding + bidirectional nn.LSTM) →
    (PlusRnnConfig, tree of models/plus_rnn.py) (the reference embeds via
    bio_embeddings' PLUSRNNEmbedder, reference: cath/embed.py:16,38).

    Dimensions are introspected from tensor shapes; torch packs gates
    [i|f|g|o] along the first axis of weight_ih/weight_hh [4h, in] —
    transposed here, with the two bias vectors summed (torch applies
    b_ih + b_hh every step).
    """
    from .plus_rnn import PlusRnnConfig

    sd = _read_torch_state_dict(path)

    def get(name):
        return np.asarray(sd[name], dtype=np.float32)

    embedding = get(embed_key)
    num_layers = sum(
        1 for k in sd
        if k.startswith(f"{prefix}weight_ih_l") and not k.endswith("_reverse")
    )
    config = PlusRnnConfig(
        vocab_size=embedding.shape[0],
        embed_dim=embedding.shape[1],
        hidden_dim=get(f"{prefix}weight_hh_l0").shape[1],
        num_layers=num_layers,
    )

    def cell(layer, rev):
        sfx = f"l{layer}" + ("_reverse" if rev else "")
        return {
            "w_x": np.ascontiguousarray(get(f"{prefix}weight_ih_{sfx}").T),
            "w_h": np.ascontiguousarray(get(f"{prefix}weight_hh_{sfx}").T),
            "b": get(f"{prefix}bias_ih_{sfx}") + get(f"{prefix}bias_hh_{sfx}"),
        }

    params = {
        "embedding": embedding,
        "fwd": [cell(i, False) for i in range(num_layers)],
        "bwd": [cell(i, True) for i in range(num_layers)],
    }
    return config, params


# --- SeqVec ELMo (bilm-tf hdf5) → ELMo params -----------------------------------


def convert_elmo_from_hdf5(weights_file: Path, options_file: Path):
    """bilm-tf weights.hdf5 → (ElmoConfig, tree of models/elmo.py).

    Conventions handled on the way in:
      * gate order: bilm-tf stores [input, cell, forget, output]; ours is
        [input, forget, cell, output] — columns permuted.
      * forget bias: TF's LSTMCell(forget_bias=1.0) adds +1 to the f gate at
        run time; the dumped B tensor does not contain it, so +1 is added to
        the forget block here (AllenNLP's converter does the same).
      * highway gate: bilm-tf computes y = g·relu(W_tr·x) + (1−g)·x with
        g = sigmoid(W_carry·x + b_carry) — the gate multiplies the transform
        branch despite the "carry" name. Our highway (models/elmo.py) also
        gates the relu branch, so W_carry/b_carry load verbatim: no
        negation, and TF kernels are already [in, out], so no transpose.
    """
    import h5py

    from .elmo import ElmoConfig

    options = json.loads(Path(options_file).read_text())
    cnn = options["char_cnn"]
    lstm = options["lstm"]
    config = ElmoConfig(
        char_embed_dim=cnn["embedding"]["dim"],
        filters=tuple(tuple(f) for f in cnn["filters"]),
        n_highway=cnn["n_highway"],
        proj_dim=lstm["projection_dim"],
        lstm_dim=lstm["dim"],
        n_lstm_layers=lstm["n_layers"],
        cell_clip=lstm.get("cell_clip", 3.0),
        proj_clip=lstm.get("proj_clip", 3.0),
    )

    def reorder_gates(w):
        # [.., 4H] bilm order i,g,f,o → ours i,f,g,o
        i, g, f, o = np.split(w, 4, axis=-1)
        return np.concatenate([i, f, g, o], axis=-1)

    with h5py.File(weights_file, "r") as fp:

        def get(name):
            return np.asarray(fp[name], dtype=np.float32)

        params = {
            "char_embedding": get("char_embed"),
            "convs": [{"w": get(f"CNN/W_cnn_{i}")[0], "b": get(f"CNN/b_cnn_{i}")}
                      for i in range(len(config.filters))],
            # the gate loads verbatim (see above); square matrices — a wrong
            # transpose or negation would not show as a shape error
            "highways": [
                {
                    "w_gate": get(f"CNN_high_{i}/W_carry"),
                    "b_gate": get(f"CNN_high_{i}/b_carry"),
                    "w_lin": get(f"CNN_high_{i}/W_transform"),
                    "b_lin": get(f"CNN_high_{i}/b_transform"),
                }
                for i in range(config.n_highway)
            ],
            "proj_w": get("CNN_proj/W_proj"),
            "proj_b": get("CNN_proj/b_proj"),
        }
        h = config.lstm_dim
        for direction, name in [("lstm_fwd", "RNN_0"), ("lstm_bwd", "RNN_1")]:
            cells = []
            for layer in range(config.n_lstm_layers):
                base = f"{name}/RNN/MultiRNNCell/Cell{layer}/LSTMCell"
                w = get(f"{base}/W_0")
                in_dim = w.shape[0] - config.proj_dim
                bias = reorder_gates(get(f"{base}/B")).copy()
                bias[h : 2 * h] += 1.0  # TF adds forget_bias=1.0 at run time
                cells.append({
                    "w_x": reorder_gates(w[:in_dim]),
                    "w_h": reorder_gates(w[in_dim:]),
                    "b": bias,
                    "w_proj": get(f"{base}/W_P_0"),
                })
            params[direction] = cells
    return config, params


# --- UniRep (churchlab babbler-1900 npy dump / jax-unirep npz) -------------------


def convert_unirep_from_npy(path: Path):
    """churchlab/UniRep weight dump → (UniRepConfig, tree of
    models/unirep.py) (the reference embeds UniRep through bio_embeddings
    → jax-unirep, reference: cath/embed.py:34-46).

    Accepted layouts:
      * a directory of per-tensor ``.npy`` files with the original TF
        variable names (``embed_matrix:0.npy``, ``rnn_mlstm_mlstm_wx:0.npy``,
        …) — the published 1900_weights download; ``:0``-less names load too
      * a single ``.npz`` with the same tensor names (any of the prefixes
        stripped)

    Conventions handled on the way in:
      * weight normalisation: the TF graph stores direction tensors plus
        gain vectors (gx/gh/gmx/gmh) and applies
        ``W_eff[:, j] = g[j] · W[:, j] / ‖W[:, j]‖₂`` at run time. The gains
        are fused into the weights here (mathematically identical; the
        device step stays gain-free). Dumps without gain tensors are taken
        as pre-fused and load verbatim.
      * gate order: [i, f, o, u], the same in the TF graph, jax-unirep and
        models/unirep.py, so gate columns load unpermuted.
    """
    from .unirep import UniRepConfig

    path = Path(path)
    if path.is_dir():
        tensors = {
            f.name[: -len(".npy")]: np.load(f).astype(np.float32)
            for f in path.glob("*.npy")
        }
    else:
        with np.load(path) as npz:
            tensors = {k: npz[k].astype(np.float32) for k in npz.files}

    def get(*names):
        for name in names:
            for key in (name, name + ":0", "rnn_mlstm_mlstm_" + name,
                        "rnn_mlstm_mlstm_" + name + ":0"):
                if key in tensors:
                    return tensors[key]
        return None

    def need(*names):
        t = get(*names)
        if t is None:
            raise KeyError(
                f"UniRep checkpoint {path} is missing {names[0]} "
                f"(has: {sorted(tensors)})"
            )
        return t

    def weight_norm(w, gain):
        if gain is None:
            return w
        norm = np.linalg.norm(w, axis=0, keepdims=True)
        return w / np.maximum(norm, 1e-12) * gain[None, :]

    embedding = need("embed_matrix", "embedding")
    wmh = weight_norm(need("wmh"), get("gmh"))
    params = {
        "embedding": embedding,
        "wmx": weight_norm(need("wmx"), get("gmx")),
        "wmh": wmh,
        "wx": weight_norm(need("wx"), get("gx")),
        "wh": weight_norm(need("wh"), get("gh")),
        "b": need("b"),
    }
    config = UniRepConfig(
        vocab_size=embedding.shape[0],
        embed_dim=embedding.shape[1],
        hidden_dim=wmh.shape[1],
    )
    return config, params


def load_unirep_checkpoint(path: Path):
    """Flat npz (save_params) or churchlab npy dir / raw npz UniRep weights
    → (UniRepConfig, tree)."""
    from .unirep import UniRepConfig

    path = Path(path)
    if path.is_dir():
        return convert_unirep_from_npy(path)
    with np.load(path, allow_pickle=False) as npz:
        ours = "wmx" in npz.files  # save_params layout vs raw TF names
    if not ours:
        return convert_unirep_from_npy(path)
    config, params, _ = load_converted(path, UniRepConfig)
    return config, params


def load_elmo_checkpoint(path: Path):
    """A bilm-tf directory (weights.hdf5 + options.json, converted in
    place) or a converted .npz → (ElmoConfig, tree)."""
    from .elmo import ElmoConfig

    path = Path(path)
    if path.is_dir():
        return convert_elmo_from_hdf5(path / "weights.hdf5",
                                      path / "options.json")
    config, params, _ = load_converted(path, ElmoConfig)
    return config, params
