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

Routes, chosen per encode from `use_kernel` ("auto" resolves from the
serving dtype):
  * the fused route ("auto" with a bf16 dtype, or True): R for every layer
    is one product of the sinusoid with all layers' W_r, made once per
    encode (span `embed.relpos`); each layer's attention goes through
    ops/relattn_cuda.py:relative_attention (kernel L on a CUDA tensor, its
    plain version on a CPU tensor), with no [B, H, L, L] or [B, H, L, 2L]
    tensor; q/k/v/o and the FFN (biases in the product) are cuBLAS products
    in the serving dtype, each LayerNorm one F.layer_norm (fp32 inside,
    one rounding), so few small launches sit between the products.
  * the plain route ("auto" with fp32, the published weights' dtype, or
    False): `_rel_attn`, the JAX package's formulation, with the dense
    content and position scores, the reshape shift and a [B, 1, L, L] mask.
Both let a padded key attend from its own row (XLNet's non_tgt_mask).
"""

import math
from dataclasses import dataclass
from typing import Any, Dict

import numpy as np
import torch
import torch.nn.functional as F

from ..device import resolve_device
from ..utils.trace import span
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
    dtype: Any = torch.float32  # the serving dtype
    use_kernel: Any = "auto"  # "auto" (= on for bf16) | True | False

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


def sinusoid(length: int, d_model: int, device) -> torch.Tensor:
    """Relative positions L .. -L+1 (bidirectional attention span) →
    [2L, d_model] on `device`, built in float64 and cast to float32."""
    inv_freq = 1.0 / (10000.0 ** (
        torch.arange(0, d_model, 2, dtype=torch.float64, device=device)
        / d_model))
    pos_seq = torch.arange(length, -length, -1, dtype=torch.float64,
                           device=device)
    angles = torch.outer(pos_seq, inv_freq)
    return torch.cat([torch.sin(angles), torch.cos(angles)], dim=-1).float()


def _sinusoid_pos_emb(length: int, d_model: int) -> np.ndarray:
    """`sinusoid` on the host, as a numpy array."""
    return sinusoid(length, d_model, "cpu").numpy()


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


def fused_route(config: XLNetConfig) -> bool:
    """True where encode takes kernel L's route (module docstring)."""
    if config.use_kernel == "auto":
        return config.dtype == torch.bfloat16
    return bool(config.use_kernel)


def _encode_fused(params, token_ids, mask, config: XLNetConfig):
    """The fused route: kernel L (or its plain version) for attention."""
    from ..ops.relattn_cuda import relative_attention

    b, length = token_ids.shape
    d, n, h = config.d_model, config.num_heads, config.d_head
    layers = params["layers"]
    x = params["embedding"][token_ids.long()].to(config.dtype)
    with span("embed.relpos"):
        pos_emb = sinusoid(length, d, x.device).to(config.dtype)
        w_r = torch.cat([p["r"].reshape(d, n * h) for p in layers], dim=1)
        r_all = torch.matmul(pos_emb, w_r)  # [2L, layers * H * d_head]
    for i, p in enumerate(layers):
        r = r_all[:, i * n * h:(i + 1) * n * h].view(2 * length, n, h)
        q, k, v = (
            torch.matmul(x, p[name].reshape(d, n * h)).view(b, length, n, h)
            .transpose(1, 2).contiguous()
            for name in ("q", "k", "v")
        )
        ctx = relative_attention(q, k, v, r, p["r_w_bias"], p["r_r_bias"],
                                 mask)
        ctx = ctx.transpose(1, 2).reshape(b * length, n * h)
        out = torch.matmul(ctx, p["o"].reshape(d, n * h).t())
        x = F.layer_norm(x + out.view(b, length, d), (d,), p["ln_attn"],
                         p["ln_attn_b"], config.layer_norm_eps)
        hidden = F.gelu(torch.addmm(p["ff_b1"], x.view(-1, d), p["ff_w1"]))
        out = torch.addmm(p["ff_b2"], hidden, p["ff_w2"])
        x = F.layer_norm(x + out.view(b, length, d), (d,), p["ln_ff"],
                         p["ln_ff_b"], config.layer_norm_eps)
    return x


def encode(
    params: Params,
    token_ids: torch.Tensor,  # [B, L]
    mask: torch.Tensor,  # [B, L] True = real token
    config: XLNetConfig,
) -> torch.Tensor:
    """Per-token hidden states [B, L, d_model] in config.dtype."""
    mask = mask.bool()
    if fused_route(config):
        return _encode_fused(params, token_ids, mask, config)
    length = token_ids.shape[1]
    device = token_ids.device
    x = params["embedding"][token_ids.long()].to(config.dtype)
    pos_emb = sinusoid(length, config.d_model, device).to(config.dtype)
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
