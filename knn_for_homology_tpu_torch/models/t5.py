"""ProtT5 encoder in PyTorch (port of knn_for_homology_tpu/models/t5.py).

T5 v1.0 encoder as ProtT5-XL uses it: RMSNorm (no bias, pre-norm), one
relative-position bias shared by all layers, unscaled QK^T, ReLU
feed-forward, final norm. Parameters keep the JAX package's tree and its
[in, out] weight layout, so every projection is `x @ w` as in the
reference; `T5Encoder` holds them as an nn.Module whose forward is
`encode`.

Routes, chosen per encode from the config flags and what the encode sees
(`attention_route`):
  * FFN: `use_fused_ffn` "auto"/True → ops/ffn_cuda.py:fused_ffn_t5
    (kernel G on a CUDA tensor, its plain version on a CPU tensor); False →
    the dense MLP (two matmuls, the [tokens, d_ff] intermediate in memory).
  * Attention for L > blockwise_above: `use_flash_kernel` "auto"/True →
    ops/flash_cuda.py:flash_attention_t5 (kernel H or its plain version)
    with one [H, 2L-1] offset-bias table per encode; False →
    `_attention_blockwise`, the JAX package's online-softmax loop.
  * Attention for L ≤ blockwise_above: ops/short_cuda.py:short_attention_t5
    (kernel I, or its plain version on a CPU tensor) with the [H, 2L-1]
    offset-bias table while L ≤ short_kernel_max, else dense `_attention`
    with the [1, H, L, L] position_bias. `use_short_kernel` True takes I
    on any device; "auto" takes it where kernel I runs (a CUDA tensor, a
    bf16 config, d_kv 128) and keeps the dense route elsewhere (the CPU,
    as in the JAX package; fp32 configs; other head widths); False keeps
    the dense route.
The q/k/v/o projections are torch.matmul on every route.

Numerics follow the JAX code: rms_norm rounds to the model dtype and then
multiplies by the scale in that dtype; products that the JAX code asks in
fp32 (`preferred_element_type=jnp.float32`) are fp32 matmuls of the upcast
operands cast once; the mask fill is -1e9, so a row with every key masked
softmaxes to uniform (dense routes) or to zero (flash routes), never NaN.
"""

import functools
import math
from dataclasses import dataclass
from typing import Any, Dict, Optional

import numpy as np
import torch
from torch import nn

from ..device import resolve_device

Params = Dict[str, Any]
NEG = -1e9


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
    # key/query block of the blockwise (flash False) route and of the flash
    # route's plain version; the flash route takes over above blockwise_above
    attention_chunk: int = 512
    blockwise_above: int = 1024
    use_flash_kernel: Any = "auto"  # "auto" (= on) | True | False
    use_short_kernel: Any = "auto"  # "auto" (= on where I runs) | True | False
    # kernel I's reach (ops/short_cuda.py:MAX_LEN); the JAX package's is 512
    short_kernel_max: int = 1024
    use_fused_ffn: Any = "auto"  # "auto" (= on) | True | False


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


def offset_buckets(
    q_len: int, k_len: int, num_buckets: int, max_distance: int
) -> torch.Tensor:
    """Buckets of every offset k - q in [-(q_len-1), k_len-1] (int64, CPU):
    computed on the CPU whatever the device, so the card's buckets are the
    CPU's bit for bit."""
    offsets = torch.arange(-(q_len - 1), k_len, dtype=torch.int32)
    return relative_position_bucket(offsets, num_buckets, max_distance).long()


def position_bias(
    rel_embedding: torch.Tensor, q_len: int, k_len: int, config: T5Config
) -> torch.Tensor:
    """[1, heads, q_len, k_len] fp32 additive attention bias."""
    buckets = offset_buckets(
        q_len, k_len, config.rel_buckets, config.rel_max_distance
    ).to(rel_embedding.device)
    table = rel_embedding[buckets].float()  # [q_len + k_len - 1, heads]
    ctx = torch.arange(q_len, device=rel_embedding.device)[:, None]
    mem = torch.arange(k_len, device=rel_embedding.device)[None, :]
    bias = table[mem - ctx + q_len - 1]  # [q, k, heads]
    return bias.permute(2, 0, 1)[None].contiguous()


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


def _output(x, ctx, params, residual=True):
    """x + ctx @ o for ctx [B, H, L, dk], cast to x's dtype first; without
    `residual` ctx @ o alone (a tensor-parallel rank's partial sum)."""
    b, l = x.shape[:2]
    ctx = ctx.transpose(1, 2).reshape(b, l, -1).to(x.dtype)
    out = torch.matmul(ctx, params["o"])
    return x + out if residual else out


def _attention(x, params, bias, mask, config: T5Config, residual=True):
    """Dense self-attention block (pre-norm). x [B, L, d]; bias [1, H, L, L]
    fp32; fp32 scores, softmax, probabilities in the model dtype, fp32 PV
    accumulation cast once."""
    q, k, v = _projections(x, params, config)
    scores = torch.matmul(q.float(), k.float().transpose(-1, -2))  # T5: no scale
    scores = scores + bias
    scores = torch.where(mask[:, None, None, :], scores, NEG)
    probs = torch.softmax(scores, dim=-1).to(x.dtype)
    ctx = torch.matmul(probs.float(), v.float()).to(x.dtype)
    return _output(x, ctx, params, residual)


def _attention_short(x, params, mask, table, config: T5Config,
                     residual=True):
    """Dense attention through kernel I (ops/short_cuda.py): projections
    here, scores + bias + softmax + PV fused. `table` [H, 2L-1] fp32 comes
    from ops/flash_attention.offset_bias_table, once per encode."""
    from ..ops.short_cuda import short_attention_t5

    q, k, v = _projections(x, params, config)
    ctx = short_attention_t5(q, k, v, mask, table)
    return _output(x, ctx, params, residual)


def _attention_flash(x, params, mask, table, config: T5Config,
                     residual=True):
    """Blockwise attention through kernel H (ops/flash_cuda.py): qkv
    projections here, the online softmax and the offset bias in the kernel.
    `table` [H, 2L-1] fp32 comes from ops/flash_attention.offset_bias_table,
    once per encode."""
    from ..ops.flash_cuda import flash_attention_t5

    q, k, v = _projections(x, params, config)
    ctx = flash_attention_t5(q, k, v, mask, table, block=config.attention_chunk)
    return _output(x, ctx, params, residual)


def _attention_blockwise(x, params, mask, table, config: T5Config,
                         residual=True):
    """The JAX package's XLA formulation of blockwise attention in plain
    torch: query chunks loop over key/value chunks carrying the online
    softmax state (running max from -inf, normaliser, fp32 accumulator);
    masked keys get the -1e9 fill and p multiplied by 0; p stays fp32 in
    the PV product. `table` [H, 2L-1] fp32 is the offset bias."""
    b, l, _ = x.shape
    h, dk = config.num_heads, config.d_kv
    chunk = min(config.attention_chunk, l)
    q, k, v = _projections(x, params, config)
    pos = torch.arange(l, device=x.device)
    ctx = torch.empty((b, h, l, dk), dtype=torch.float32, device=x.device)
    for q0 in range(0, l, chunk):
        q1 = min(l, q0 + chunk)
        qc = q[:, :, q0:q1].float()
        acc = torch.zeros((b, h, q1 - q0, dk), dtype=torch.float32, device=x.device)
        norm = torch.zeros((b, h, q1 - q0, 1), dtype=torch.float32, device=x.device)
        run_max = torch.full_like(norm, float("-inf"))
        for k0 in range(0, l, chunk):
            k1 = min(l, k0 + chunk)
            bias = table[:, pos[None, k0:k1] - pos[q0:q1, None] + l - 1]
            scores = torch.matmul(qc, k[:, :, k0:k1].float().transpose(-1, -2))
            scores = scores + bias[None]
            keep = mask[:, None, None, k0:k1]
            scores = torch.where(keep, scores, NEG)
            new_max = torch.maximum(run_max, scores.amax(dim=-1, keepdim=True))
            correction = torch.exp(run_max - new_max)
            p = torch.exp(scores - new_max) * keep.float()
            acc = acc * correction + torch.matmul(p, v[:, :, k0:k1].float())
            norm = norm * correction + p.sum(dim=-1, keepdim=True)
            run_max = new_max
        ctx[:, :, q0:q1] = acc / torch.clamp(norm, min=1e-30)
    return _output(x, ctx, params, residual)


def _mlp(x, params, config: T5Config, residual=True):
    if config.use_fused_ffn == "auto" or bool(config.use_fused_ffn):
        from ..ops.ffn_cuda import fused_ffn_t5

        b, l, d = x.shape
        out = fused_ffn_t5(
            x.reshape(b * l, d), params["ln"], params["wi"], params["wo"],
            eps=config.layer_norm_eps, residual=residual,
        )
        return out.reshape(b, l, d)
    normed = rms_norm(x, params["ln"], config.layer_norm_eps)
    hidden = torch.relu(torch.matmul(normed, params["wi"]))
    out = torch.matmul(hidden, params["wo"])
    return x + out if residual else out


def attention_route(config: T5Config, length: int, device) -> str:
    """The attention route of an encode at padded length `length` whose
    activations are on `device`: "flash" (kernel H) or "blockwise" above
    blockwise_above; below it "short" (kernel I) or "dense"."""
    if length > config.blockwise_above:
        flash = config.use_flash_kernel
        return "flash" if flash == "auto" or bool(flash) else "blockwise"
    short = config.use_short_kernel
    if short == "auto":
        short = (torch.device(device).type == "cuda"
                 and config.dtype == torch.bfloat16 and config.d_kv == 128)
    return "short" if short and length <= config.short_kernel_max else "dense"


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
    from ..ops.flash_attention import offset_bias_table

    x = params["embedding"][token_ids.long()].to(config.dtype)
    mask = mask.to(torch.bool)
    length = token_ids.shape[1]
    rel = params["rel_embedding"]
    route = attention_route(config, length, x.device)
    if route == "dense":
        bias = position_bias(rel, length, length, config)
        attend = functools.partial(_attention, bias=bias, mask=mask)
    else:
        table = offset_bias_table(
            rel, length, config.rel_buckets, config.rel_max_distance
        )
        fn = {"short": _attention_short, "flash": _attention_flash,
              "blockwise": _attention_blockwise}[route]
        attend = functools.partial(fn, mask=mask, table=table)

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
