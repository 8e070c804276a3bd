"""ProtT5 encoder in PyTorch (port of knn_for_homology_tpu/models/t5.py).

T5 v1.0 encoder as ProtT5-XL uses it: RMSNorm (no bias, pre-norm), one
relative-position bias shared by all layers, unscaled QK^T, ReLU
feed-forward, final norm. Parameters keep the JAX package's tree and its
[in, out] weight layout, so every projection is `x @ w` as in the
reference; `T5Encoder` holds them as an nn.Module whose forward is
`encode`.

Attention has two formulations, chosen once per encode from its padded
length L alone (`attention_route`); both take the bias as one [H, 2L-1]
fp32 offset table per encode (`offset_bias_table`), shared by all layers:
  * L ≤ blockwise_above: dense attention, kernel I's wrapper
    (ops/short_cuda.py:short_attention_t5);
  * L > blockwise_above: flash attention, kernel H's wrapper
    (ops/flash_cuda.py:flash_attention_t5), whose plain version steps
    attention_chunk keys at a time.
The FFN is kernel G's wrapper (ops/ffn_cuda.py:fused_ffn_t5). Each wrapper
sends a CPU tensor to its plain version and a CUDA tensor to its kernel,
and raises, naming the kernel's limit, for a call the kernel cannot take
(a dtype other than bf16, other widths, L past its MAX_LEN): the encoder
never swaps a kernel for plain PyTorch on the card by itself. The wrappers
are looked up in their modules at each encode, so a caller that wants the
plain versions on the card swaps them (chip_smoke.py's plain_kernels
does). The q/k/v/o projections are torch.matmul.

Numerics follow the JAX code: rms_norm rounds to the model dtype and then
multiplies by the scale in that dtype; products that the JAX code asks in
fp32 (`preferred_element_type=jnp.float32`) are fp32 matmuls of the upcast
operands cast once; the mask fill is -1e9, so a row with every key masked
softmaxes to uniform (dense attention) or to zero (flash), never NaN.
"""

import functools
import math
from dataclasses import dataclass
from typing import Any, Dict, Optional

import numpy as np
import torch
from torch import nn

from ..device import resolve_device
from ..ops import ffn_cuda, flash_cuda, short_cuda

Params = Dict[str, Any]


@dataclass(frozen=True)
class T5Config:
    vocab_size: int = 128
    d_model: int = 1024
    d_kv: int = 128
    d_ff: int = 16384
    num_layers: int = 24
    num_heads: int = 32
    rel_buckets: int = 32
    rel_max_distance: int = 128
    layer_norm_eps: float = 1e-6
    dtype: Any = torch.bfloat16
    # key step of the flash attention's plain version, which takes over
    # from dense attention above blockwise_above
    attention_chunk: int = 512
    blockwise_above: int = 1024


# ProtT5-XL (t5-3b encoder): 24 layers, d_model 1024, 32 heads x 128, d_ff 16384
PROTT5_XL = T5Config()
# tiny config for tests
TINY = T5Config(
    vocab_size=32, d_model=64, d_kv=16, d_ff=128, num_layers=2, num_heads=4
)


def rms_norm(x: torch.Tensor, scale: torch.Tensor, eps: float) -> torch.Tensor:
    """T5 LayerNorm: no mean subtraction, no bias; fp32 accumulation, then
    the cast to x's dtype and the scale multiply in that dtype."""
    x32 = x.float()
    var = x32.square().mean(dim=-1, keepdim=True)
    return (x32 * torch.rsqrt(var + eps)).to(x.dtype) * scale


def relative_position_bucket(
    relative_position: torch.Tensor, num_buckets: int, max_distance: int
) -> torch.Tensor:
    """Bidirectional T5 bucketing of key_pos - query_pos (int32), in the
    JAX function's float32 arithmetic: log, divide by log(max_distance /
    max_exact) as a float32, multiply, truncate toward zero."""
    num_buckets //= 2
    ret = (relative_position > 0).to(torch.int32) * num_buckets
    n = relative_position.abs().to(torch.int32)
    max_exact = num_buckets // 2
    is_small = n < max_exact
    # a tensor divisor on n's device: a Python-scalar divisor may become a
    # multiply by its reciprocal, one ulp off the true quotient
    denom = torch.tensor(
        np.log(max_distance / max_exact), dtype=torch.float32, device=n.device
    )
    val_if_large = max_exact + (
        torch.log(n.float() / max_exact + 1e-6) / denom * (num_buckets - max_exact)
    ).to(torch.int32)
    val_if_large = torch.clamp(val_if_large, max=num_buckets - 1)
    return ret + torch.where(is_small, n, val_if_large)


def offset_bias_table(
    rel_embedding: torch.Tensor,  # [buckets, H]
    length: int,
    num_buckets: int,
    max_distance: int,
) -> torch.Tensor:
    """[H, 2·length − 1] fp32: table[h, d + length − 1] = the bias of
    offset d = k_pos − q_pos for head h, on rel_embedding's device. The
    buckets are computed on the CPU whatever the device, so the card's are
    the CPU's bit for bit."""
    offsets = torch.arange(-(length - 1), length, dtype=torch.int32)
    buckets = relative_position_bucket(offsets, num_buckets, max_distance)
    buckets = buckets.long().to(rel_embedding.device)
    return rel_embedding[buckets].float().t().contiguous()


def _projections(x, params, config: T5Config):
    """rms_norm(x) @ w for q, k, v, each [B, H, L, dk] contiguous."""
    b, l, _ = x.shape
    h, dk = config.num_heads, config.d_kv
    normed = rms_norm(x, params["ln"], config.layer_norm_eps)
    return [
        torch.matmul(normed, params[name]).reshape(b, l, h, dk)
        .transpose(1, 2).contiguous()
        for name in ("q", "k", "v")
    ]


def _attention(x, params, mask, table, context, config: T5Config,
               residual=True):
    """Self-attention block (pre-norm): the q/k/v projections here,
    `context(q, k, v, mask, table)` → [B, H, L, dk], then x + ctx @ o, the
    context cast to x's dtype first; without `residual` ctx @ o alone (a
    tensor-parallel rank's partial sum)."""
    b, l = x.shape[:2]
    q, k, v = _projections(x, params, config)
    ctx = context(q, k, v, mask, table)
    out = torch.matmul(ctx.transpose(1, 2).reshape(b, l, -1).to(x.dtype),
                       params["o"])
    return x + out if residual else out


def _mlp(x, params, config: T5Config, residual=True):
    """FFN block, on kernel G's wrapper."""
    b, l, d = x.shape
    out = ffn_cuda.fused_ffn_t5(x.reshape(b * l, d), params["ln"],
                                params["wi"], params["wo"],
                                eps=config.layer_norm_eps, residual=residual)
    return out.reshape(b, l, d)


def attention_route(config: T5Config, length: int) -> str:
    """The attention of an encode at padded length `length`: dense ("I",
    kernel I's wrapper) up to blockwise_above, flash ("H", kernel H's
    wrapper) above it."""
    return "I" if length <= config.blockwise_above else "H"


def encode(
    params: Params,
    token_ids: torch.Tensor,  # [B, L] int
    mask: torch.Tensor,  # [B, L] bool (True = real token)
    config: T5Config,
    reduce=None,
) -> torch.Tensor:
    """Per-token hidden states [B, L, d_model] in config.dtype.

    `reduce` runs the blocks tensor-parallel (parallel/encoder_sharding.py):
    `params` and `config` then hold one rank's heads and d_ff slice, each
    block returns its partial sum without x, and x is added once to
    `reduce(partial)` (the sum over ranks, in fp32) before the one cast to
    config.dtype."""
    x = params["embedding"][token_ids.long()].to(config.dtype)
    length = token_ids.shape[1]
    table = offset_bias_table(params["rel_embedding"], length,
                              config.rel_buckets, config.rel_max_distance)
    if attention_route(config, length) == "I":
        context = short_cuda.short_attention_t5
    else:
        context = functools.partial(flash_cuda.flash_attention_t5,
                                    block=config.attention_chunk)
    attend = functools.partial(_attention, mask=mask.to(torch.bool),
                               table=table, context=context)

    def block(fn, x, layer):
        if reduce is None:
            return fn(x, layer, config=config)
        partial = fn(x, layer, config=config, residual=False)
        return (x.float() + reduce(partial.float())).to(x.dtype)

    for layer in params["layers"]:
        x = block(attend, x, layer["attn"])
        x = block(_mlp, x, layer["mlp"])
    return rms_norm(x, params["final_ln"], config.layer_norm_eps)


class _Layer(nn.Module):
    def __init__(self, layer: Params):
        super().__init__()
        self.attn = nn.ParameterDict(
            {k: nn.Parameter(v, requires_grad=False) for k, v in layer["attn"].items()}
        )
        self.mlp = nn.ParameterDict(
            {k: nn.Parameter(v, requires_grad=False) for k, v in layer["mlp"].items()}
        )

    def params(self) -> Params:
        return {"attn": dict(self.attn.items()), "mlp": dict(self.mlp.items())}


class T5Encoder(nn.Module):
    """The encoder's weights as an nn.Module (inference only: no gradients);
    forward(token_ids, mask) is `encode`."""

    def __init__(self, config: T5Config, params: Params):
        super().__init__()
        self.config = config
        self.embedding = nn.Parameter(params["embedding"], requires_grad=False)
        self.rel_embedding = nn.Parameter(
            params["rel_embedding"], requires_grad=False
        )
        self.final_ln = nn.Parameter(params["final_ln"], requires_grad=False)
        self.layers = nn.ModuleList(_Layer(layer) for layer in params["layers"])

    def params(self) -> Params:
        return {
            "embedding": self.embedding,
            "rel_embedding": self.rel_embedding,
            "layers": [layer.params() for layer in self.layers],
            "final_ln": self.final_ln,
        }

    @torch.no_grad()
    def forward(self, token_ids: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
        return encode(self.params(), token_ids, mask, self.config)


def init_params(config: T5Config, seed: int = 0, device="cuda") -> Params:
    """Random init at the JAX init's scales (normal · 1/sqrt(fan_in);
    embedding 1.0, relative embedding 0.1; norms at 1), drawn in fp32 on
    `device` from torch.Generator(device).manual_seed(seed), then cast to
    config.dtype. Real weights come from models/convert.py."""
    device = resolve_device(device)
    gen = torch.Generator(device).manual_seed(seed)

    def w(*shape, scale=None):
        scale = scale or (1.0 / math.sqrt(shape[0]))
        out = torch.randn(shape, generator=gen, dtype=torch.float32, device=device)
        return (out * scale).to(config.dtype)

    def ones():
        return torch.ones((config.d_model,), dtype=config.dtype, device=device)

    inner = config.num_heads * config.d_kv

    def layer():
        return {
            "attn": {
                "ln": ones(),
                "q": w(config.d_model, inner),
                "k": w(config.d_model, inner),
                "v": w(config.d_model, inner),
                "o": w(inner, config.d_model),
            },
            "mlp": {
                "ln": ones(),
                "wi": w(config.d_model, config.d_ff),
                "wo": w(config.d_ff, config.d_model),
            },
        }

    return {
        "embedding": w(config.vocab_size, config.d_model, scale=1.0),
        "rel_embedding": w(config.rel_buckets, config.num_heads, scale=0.1),
        "layers": [layer() for _ in range(config.num_layers)],
        "final_ln": ones(),
    }


# --- ProtT5 tokenisation -----------------------------------------------------
# One token per residue; rare residues U, Z, O, B map to X before
# tokenisation. The published prot_t5 layout; a converted checkpoint whose
# tokenizer differs stores its table under meta["vocab"].
PAD_ID, EOS_ID, UNK_ID = 0, 1, 2
PROTT5_RESIDUE_ORDER = "ALGVSREDTIPKFQNYMHWC"  # ids 3..22
PROTT5_VOCAB = {aa: i + 3 for i, aa in enumerate(PROTT5_RESIDUE_ORDER)}
PROTT5_VOCAB["X"] = 23


def tokenize(sequence: str, vocab: Optional[Dict[str, int]] = None) -> np.ndarray:
    """Residue ids + EOS (reference preprocessing: UZOB → X)."""
    vocab = vocab or PROTT5_VOCAB
    seq = sequence.upper()
    ids = [vocab.get("X" if aa in "UZOB" else aa, UNK_ID) for aa in seq]
    ids.append(EOS_ID)
    return np.asarray(ids, dtype=np.int32)
