"""Generic BERT-family encoder in PyTorch (port of
knn_for_homology_tpu/models/bert.py) — the reference's ESM / ESM1b /
ProtBert-BFD / ProtAlbert-BFD embedders (reference: cath/embed.py:34-46)
with one configurable architecture:

  * pre- or post-LayerNorm blocks (ESM1b is pre-LN, BERT/ALBERT post-LN)
  * learned absolute position embeddings (+ optional constant token-type row)
  * GELU feed-forward (exact erf or tanh approximation per config),
    scaled dot-product attention as a plain matmul + softmax, masked keys
    filled with -1e9
  * optional cross-layer parameter sharing + factorized embedding
    projection (ALBERT: [vocab, embed_dim] table → d_model)
  * final LN (pre-LN models)

ESM1b's 1022-residue truncation (reference: cath/embed.py:80-82) follows
from max_positions and position_offset (models/registry.py).
"""

import math
from dataclasses import dataclass
from typing import Any, Dict

import numpy as np
import torch
import torch.nn.functional as F

from ..device import resolve_device
from .module import TreeEncoder

Params = Dict[str, Any]
NEG = -1e9


@dataclass(frozen=True)
class BertConfig:
    vocab_size: int = 33
    d_model: int = 1280
    d_ff: int = 5120
    num_layers: int = 33
    num_heads: int = 20
    max_positions: int = 1026
    pre_norm: bool = True  # ESM1b style; False = BERT/ALBERT post-LN
    share_layers: bool = False  # ALBERT
    # ALBERT factorized embedding: tables live at embed_dim and are
    # projected to d_model by params["emb_proj"]; 0 = tables at d_model
    embed_dim: int = 0
    # HF "gelu" (erf-exact: BERT/ESM) vs "gelu_new" (tanh: ALBERT)
    gelu_exact: bool = True
    layer_norm_eps: float = 1e-5
    # first usable row of the learned position table: fairseq's
    # LearnedPositionalEmbedding starts real tokens at padding_idx+1=2
    # (its table has max_positions + pad_idx + 1 rows), BERT starts at 0
    position_offset: int = 0
    dtype: Any = torch.float32


# reference model shapes (weights via conversion; names match the registry)
ESM1B = BertConfig(position_offset=2)
PROTBERT = BertConfig(
    vocab_size=30, d_model=1024, d_ff=4096, num_layers=30, num_heads=16,
    max_positions=40000, pre_norm=False,
)
# ProtAlbert-BFD (Rostlab): ALBERT with a factorized [vocab, 128]
# embedding, 12 shared layers, tanh-approx GELU ("gelu_new"); its
# sentencepiece has 34 entries (conversion overrides every shape from the
# checkpoint's config.json, and the tokenizer table from its vocab files)
PROTALBERT = BertConfig(
    vocab_size=34, d_model=4096, d_ff=16384, num_layers=12, num_heads=64,
    max_positions=40000, pre_norm=False, share_layers=True, embed_dim=128,
    gelu_exact=False, layer_norm_eps=1e-12,
)
TINY_BERT = BertConfig(
    vocab_size=32, d_model=32, d_ff=64, num_layers=2, num_heads=4,
    max_positions=64,
)


def layer_norm(x, scale, bias, eps):
    """fp32 statistics, the normalised value cast to x's dtype, then the
    affine in that dtype (the JAX function's order)."""
    x32 = x.float()
    mean = x32.mean(dim=-1, keepdim=True)
    var = (x32 - mean).square().mean(dim=-1, keepdim=True)
    return ((x32 - mean) * torch.rsqrt(var + eps)).to(x.dtype) * scale + bias


def _attn(x, p, mask, config: BertConfig):
    b, length, d = x.shape
    h = config.num_heads
    dk = d // h

    def proj(w, bias):  # → [B, H, L, dk]
        return (x @ w + bias).reshape(b, length, h, dk).transpose(1, 2)

    q = proj(p["q"], p["q_b"]) / math.sqrt(dk)
    k = proj(p["k"], p["k_b"])
    v = proj(p["v"], p["v_b"])
    scores = torch.matmul(q.float(), k.float().transpose(-1, -2))
    scores = torch.where(mask[:, None, None, :], scores, NEG)
    probs = torch.softmax(scores, dim=-1).to(x.dtype)
    ctx = torch.matmul(probs, v).transpose(1, 2).reshape(b, length, d)
    return ctx @ p["o"] + p["o_b"]


def _ffn(x, p, config: BertConfig):
    hidden = F.gelu(x @ p["wi"] + p["wi_b"],
                    approximate="none" if config.gelu_exact else "tanh")
    return hidden @ p["wo"] + p["wo_b"]


def _block(x, p, mask, config: BertConfig):
    eps = config.layer_norm_eps
    if config.pre_norm:
        x = x + _attn(layer_norm(x, p["ln1"], p["ln1_b"], eps), p, mask, config)
        x = x + _ffn(layer_norm(x, p["ln2"], p["ln2_b"], eps), p, config)
    else:
        x = layer_norm(x + _attn(x, p, mask, config), p["ln1"], p["ln1_b"], eps)
        x = layer_norm(x + _ffn(x, p, config), p["ln2"], p["ln2_b"], eps)
    return x


def encode(
    params: Params,
    token_ids: torch.Tensor,  # [B, L]
    mask: torch.Tensor,  # [B, L] bool
    config: BertConfig,
) -> torch.Tensor:
    """Per-token hidden states [B, L, d_model]."""
    mask = mask.bool()
    length = token_ids.shape[1]
    x = params["embedding"][token_ids.long()]
    off = config.position_offset
    x = x + params["position_embedding"][off : off + length][None]
    if "token_type_row" in params:  # HF adds token_type_embeddings[0]
        x = x + params["token_type_row"][None, None]
    if "emb_ln" in params:
        x = layer_norm(x, params["emb_ln"], params["emb_ln_b"],
                       config.layer_norm_eps)
    if "emb_proj" in params:  # ALBERT embed_dim → d_model
        x = x @ params["emb_proj"] + params["emb_proj_b"]
    x = x.to(config.dtype) * mask[..., None].to(config.dtype)
    layers = params["layers"]
    for i in range(config.num_layers):
        p = layers[0] if config.share_layers else layers[i]
        x = _block(x, p, mask, config)
    if config.pre_norm and "final_ln" in params:
        x = layer_norm(x, params["final_ln"], params["final_ln_b"],
                       config.layer_norm_eps)
    return x


class BertEncoder(TreeEncoder):
    """forward(token_ids, mask) → [B, L, d_model] (`encode`)."""

    encode_fn = staticmethod(encode)


def init_params(config: BertConfig, seed: int = 0, device="cuda") -> Params:
    """Random init at the JAX init's scales (normal · 1/sqrt(fan_in); the
    embedding · 1.0, positions · 0.02; norms at 1, biases at 0), drawn in
    fp32 on `device` from torch.Generator(device).manual_seed(seed)."""
    device = resolve_device(device)
    gen = torch.Generator(device).manual_seed(seed)

    def w(*shape, scale=None):
        scale = scale or (1.0 / math.sqrt(shape[0]))
        out = torch.randn(shape, generator=gen, dtype=torch.float32,
                          device=device)
        return (out * scale).to(config.dtype)

    def zeros(n):
        return torch.zeros((n,), dtype=config.dtype, device=device)

    def ones(n):
        return torch.ones((n,), dtype=config.dtype, device=device)

    d, f = config.d_model, config.d_ff

    def block():
        return {
            "q": w(d, d), "q_b": zeros(d),
            "k": w(d, d), "k_b": zeros(d),
            "v": w(d, d), "v_b": zeros(d),
            "o": w(d, d), "o_b": zeros(d),
            "wi": w(d, f), "wi_b": zeros(f),
            "wo": w(f, d), "wo_b": zeros(d),
            "ln1": ones(d), "ln1_b": zeros(d),
            "ln2": ones(d), "ln2_b": zeros(d),
        }

    n_blocks = 1 if config.share_layers else config.num_layers
    e = config.embed_dim or d
    params = {
        "embedding": w(config.vocab_size, e, scale=1.0),
        "position_embedding": w(config.max_positions, e, scale=0.02),
        "emb_ln": ones(e),
        "emb_ln_b": zeros(e),
        "layers": [block() for _ in range(n_blocks)],
    }
    if config.embed_dim:
        params["emb_proj"] = w(e, d)
        params["emb_proj_b"] = zeros(d)
    if config.pre_norm:
        params["final_ln"] = ones(d)
        params["final_ln_b"] = zeros(d)
    return params


# ESM alphabet (the prepended specials of facebookresearch/esm):
# <cls> <pad> <eos> <unk> then residues by frequency
ESM_TOKENS = "LAGVSERTIDPKQNFYMHWCXBUZO"
ESM_VOCAB = {aa: i + 4 for i, aa in enumerate(ESM_TOKENS)}
ESM_CLS, ESM_PAD, ESM_EOS, ESM_UNK = 0, 1, 2, 3


def tokenize_esm(sequence: str, max_len: int = 1022, vocab=None) -> np.ndarray:
    """<cls> + residues (truncated to 1022, reference: cath/embed.py:80-82)
    + <eos>. `vocab` overrides the residue table (converted checkpoints)."""
    table = vocab or ESM_VOCAB
    ids = [ESM_CLS]
    for aa in sequence[:max_len].upper():
        ids.append(table.get(aa, ESM_UNK))
    ids.append(ESM_EOS)
    return np.asarray(ids, dtype=np.int32)


# ProtBert/ProtAlbert (Rostlab) WordPiece vocabulary:
# [PAD] [UNK] [CLS] [SEP] [MASK] then residues by frequency; the published
# ProtBert order is the default for both
BERT_TOKENS = "LAGVESIKRDTPNQFYMHCWXUBZO"
BERT_VOCAB = {aa: i + 5 for i, aa in enumerate(BERT_TOKENS)}
BERT_PAD, BERT_UNK, BERT_CLS, BERT_SEP = 0, 1, 2, 3


def tokenize_bert(sequence: str, max_len: int = 39998, vocab=None) -> np.ndarray:
    """[CLS] + residues + [SEP] (BERT-family pLMs). `vocab` overrides the
    residue table (converted checkpoints). Rare residues U/Z/O/B map to X,
    as bio_embeddings' ProtTrans preprocessing does; ESM keeps them, its
    alphabet covers them (tokenize_esm)."""
    table = vocab or BERT_VOCAB
    ids = [BERT_CLS]
    for aa in sequence[:max_len].upper():
        ids.append(table.get("X" if aa in "UZOB" else aa, BERT_UNK))
    ids.append(BERT_SEP)
    return np.asarray(ids, dtype=np.int32)
