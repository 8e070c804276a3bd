"""ProtXLNet encoder in PyTorch (port of knn_for_homology_tpu/models/xlnet.py)
— XLNet's inference path (content stream only).

The reference embeds with bio_embeddings' ProtTransXLNetUniRef100Embedder,
an HF XLNetModel forward pass (reference: cath/embed.py:19,41). At inference
XLNet reduces to a Transformer-XL encoder: per-layer relative attention
with the learned content and position biases (r_w, r_r), sinusoidal
relative position embeddings aligned by the reshape shift, post-LayerNorm
residuals and an exact-GELU feed-forward. The segment term is skipped, as
HF skips it when no token_type_ids are passed (bio_embeddings passes none).
The special tokens <sep> <cls> sit at the END of a sequence.
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


@dataclass(frozen=True)
class XLNetConfig:
    vocab_size: int = 37
    d_model: int = 1024
    d_inner: int = 4096
    num_layers: int = 30
    num_heads: int = 16
    layer_norm_eps: float = 1e-12
    dtype: Any = torch.float32

    @property
    def d_head(self) -> int:
        return self.d_model // self.num_heads


# Rostlab/prot_xlnet shape config (weights via conversion)
PROTXLNET = XLNetConfig()
TINY_XLNET = XLNetConfig(
    vocab_size=32, d_model=32, d_inner=64, num_layers=2, num_heads=4
)


def _layer_norm(x, scale, bias, eps):
    x32 = x.float()
    mean = x32.mean(dim=-1, keepdim=True)
    var = (x32 - mean).square().mean(dim=-1, keepdim=True)
    return ((x32 - mean) * torch.rsqrt(var + eps)).to(x.dtype) * scale + bias


def _rel_shift(x: torch.Tensor, klen: int) -> torch.Tensor:
    """Align the [B, H, L, 2L] position-score matrix so column j holds the
    sinusoid for relative distance i-j (XLNet's reshape trick)."""
    b, n, i, j = x.shape
    x = x.reshape(b, n, j, i)[:, :, 1:, :]
    return x.reshape(b, n, i, j - 1)[:, :, :, :klen]


def _sinusoid_pos_emb(length: int, d_model: int) -> np.ndarray:
    """Relative positions L .. -L+1 (bidirectional attention span) →
    [2L, d_model], built in float64 and cast to float32."""
    inv_freq = 1.0 / (
        10000.0 ** (np.arange(0, d_model, 2, dtype=np.float64) / d_model)
    )
    pos_seq = np.arange(length, -length, -1, dtype=np.float64)
    sinusoid = np.outer(pos_seq, inv_freq)
    return np.concatenate(
        [np.sin(sinusoid), np.cos(sinusoid)], axis=-1
    ).astype(np.float32)


def _rel_attn(x, pos_emb, mask_cost, p, config: XLNetConfig):
    scale = 1.0 / math.sqrt(config.d_head)
    q = torch.einsum("bld,dnh->blnh", x, p["q"])
    k = torch.einsum("bld,dnh->blnh", x, p["k"])
    v = torch.einsum("bld,dnh->blnh", x, p["v"])
    r = torch.einsum("jd,dnh->jnh", pos_emb, p["r"])
    ac = torch.einsum("binh,bjnh->bnij", (q + p["r_w_bias"]).float(), k.float())
    bd = torch.einsum("binh,jnh->bnij", (q + p["r_r_bias"]).float(), r.float())
    bd = _rel_shift(bd, klen=ac.shape[3])
    # segment term ef is skipped: HF sets it to 0 when token_type_ids=None
    score = (ac + bd) * scale - mask_cost
    prob = torch.softmax(score, dim=-1).to(x.dtype)
    vec = torch.einsum("bnij,bjnh->binh", prob, v)
    out = torch.einsum("binh,dnh->bid", vec, p["o"])
    return _layer_norm(x + out, p["ln_attn"], p["ln_attn_b"],
                       config.layer_norm_eps)


def _ff(x, p, config: XLNetConfig):
    h = F.gelu(x @ p["ff_w1"] + p["ff_b1"])  # exact (erf) GELU
    h = h @ p["ff_w2"] + p["ff_b2"]
    return _layer_norm(x + h, p["ln_ff"], p["ln_ff_b"], config.layer_norm_eps)


def encode(
    params: Params,
    token_ids: torch.Tensor,  # [B, L]
    mask: torch.Tensor,  # [B, L] True = real token
    config: XLNetConfig,
) -> torch.Tensor:
    """Per-token hidden states [B, L, d_model]."""
    mask = mask.bool()
    length = token_ids.shape[1]
    device = token_ids.device
    x = params["embedding"][token_ids.long()].to(config.dtype)
    pos_emb = torch.from_numpy(
        _sinusoid_pos_emb(length, config.d_model)
    ).to(device=device, dtype=config.dtype)
    # content stream: padded keys masked out, but the diagonal stays
    # attendable (HF's non_tgt_mask) so pad rows never go all -inf
    eye = torch.eye(length, dtype=torch.bool, device=device)
    allow = mask[:, None, None, :] | eye[None, None]
    mask_cost = torch.where(allow, 0.0, 1e30).to(torch.float32)
    for p in params["layers"]:
        x = _rel_attn(x, pos_emb, mask_cost, p, config)
        x = _ff(x, p, config)
    return x


class XLNetEncoder(TreeEncoder):
    """forward(token_ids, mask) → [B, L, d_model] (`encode`)."""

    encode_fn = staticmethod(encode)


def init_params(config: XLNetConfig, seed: int = 0, device="cuda") -> Params:
    """Random init at the JAX init's scales (normal · 0.02, the embedding
    · 1.0; norms at 1, biases at 0), drawn in fp32 on `device` from
    torch.Generator(device).manual_seed(seed)."""
    device = resolve_device(device)
    gen = torch.Generator(device).manual_seed(seed)
    d, f, n, h = (
        config.d_model, config.d_inner, config.num_heads, config.d_head
    )

    def w(*shape, scale=0.02):
        out = torch.randn(shape, generator=gen, dtype=torch.float32,
                          device=device)
        return (out * scale).to(config.dtype)

    def ones(k):
        return torch.ones((k,), dtype=config.dtype, device=device)

    def zeros(k):
        return torch.zeros((k,), dtype=config.dtype, device=device)

    def layer():
        return {
            "q": w(d, n, h), "k": w(d, n, h), "v": w(d, n, h),
            "o": w(d, n, h), "r": w(d, n, h),
            "r_w_bias": w(n, h), "r_r_bias": w(n, h), "r_s_bias": w(n, h),
            "seg_embed": w(2, n, h),
            "ln_attn": ones(d), "ln_attn_b": zeros(d),
            "ff_w1": w(d, f), "ff_b1": zeros(f),
            "ff_w2": w(f, d), "ff_b2": zeros(d),
            "ln_ff": ones(d), "ln_ff_b": zeros(d),
        }

    return {
        "embedding": w(config.vocab_size, d, scale=1.0),
        "layers": [layer() for _ in range(config.num_layers)],
    }


# XLNet sentencepiece special ids (HF XLNetTokenizer convention). Residue
# ids follow the ProtTrans frequency order as the documented default; a
# converted checkpoint overrides them through the tokenizer table stored in
# its meta (models/convert.py)
XLNET_UNK, XLNET_SEP, XLNET_PAD, XLNET_CLS = 0, 4, 5, 3
XLNET_TOKENS = "LAGVESIKRDTPNQFYMHCWXUBZO"
XLNET_VOCAB = {aa: i + 7 for i, aa in enumerate(XLNET_TOKENS)}


def tokenize(sequence: str, vocab=None) -> np.ndarray:
    """Residues + <sep> + <cls> — XLNet appends specials at the END.
    U/Z/O/B → X per bio_embeddings' ProtTrans preprocessing."""
    table = vocab or XLNET_VOCAB
    ids = [
        table.get("X" if aa in "UZOB" else aa, XLNET_UNK)
        for aa in sequence.upper()
    ]
    ids.extend([XLNET_SEP, XLNET_CLS])
    return np.asarray(ids, dtype=np.int32)
