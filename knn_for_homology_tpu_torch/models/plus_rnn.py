"""PLUS-RNN encoder in PyTorch (port of knn_for_homology_tpu/models/
plus_rnn.py) — stacked bidirectional LSTM protein LM.

The reference embeds with bio_embeddings' PLUSRNNEmbedder (reference:
cath/embed.py:16,38): an embedding layer feeding a multi-layer
bidirectional LSTM whose concatenated forward/backward hidden states
(2 x hidden_dim = 1024 for the published model) are the per-residue
representation.

The LSTM follows torch's cell (gate order i, f, g, o) with masked steps
carrying (h, c); padding is handled as pack_padded_sequence handles it:
the backward pass runs over each row's valid region only (a masked
reverse). The step is written out as in the JAX package, the input product
of all steps taken as one matmul before the time loop.
"""

from dataclasses import dataclass
from typing import Any, Dict

import numpy as np
import torch

from ..device import resolve_device
from .module import TreeEncoder

Params = Dict[str, Any]


@dataclass(frozen=True)
class PlusRnnConfig:
    vocab_size: int = 21
    embed_dim: int = 21
    hidden_dim: int = 512  # per direction; output is 2x
    num_layers: int = 3
    dtype: Any = torch.float32


PLUS_RNN = PlusRnnConfig()
TINY_PLUS = PlusRnnConfig(embed_dim=8, hidden_dim=12, num_layers=2)


def lstm_step(xw, h, c, keep, cell: Params, dtype):
    """One torch-convention LSTM step: `xw` = x_t @ w_x [B, 4H]; masked rows
    carry (h, c). → (h, c)."""
    gates = (xw + h @ cell["w_h"] + cell["b"]).float()
    i, f, g, o = gates.chunk(4, dim=-1)
    c_new = torch.sigmoid(f) * c + torch.sigmoid(i) * torch.tanh(g)
    h_new = (torch.sigmoid(o) * torch.tanh(c_new)).to(dtype)
    keep = keep[:, None]
    return torch.where(keep, h_new, h), torch.where(keep, c_new, c)


def _lstm_scan(x, mask, cell, hidden_dim, dtype):
    """Unidirectional LSTM over [B, L, in] → [B, L, hidden]."""
    b, length, _ = x.shape
    h = torch.zeros((b, hidden_dim), dtype=dtype, device=x.device)
    c = torch.zeros((b, hidden_dim), dtype=torch.float32, device=x.device)
    xw = x @ cell["w_x"]
    hs = []
    for t in range(length):
        h, c = lstm_step(xw[:, t], h, c, mask[:, t], cell, dtype)
        hs.append(h)
    return torch.stack(hs, dim=1)


def _reverse_padded(x, mask):
    """Flip only the valid prefix of each right-padded row of [B, L, d]."""
    lengths = mask.sum(dim=1)
    length = x.shape[1]
    idx = lengths[:, None] - 1 - torch.arange(length, device=x.device)[None]
    idx = torch.clamp(idx, 0, length - 1)
    return torch.gather(x, 1, idx[..., None].expand(-1, -1, x.shape[2]))


def encode(
    params: Params,
    token_ids: torch.Tensor,  # [B, L]
    mask: torch.Tensor,  # [B, L] bool
    config: PlusRnnConfig,
) -> torch.Tensor:
    """[B, L, 2*hidden_dim] per-residue representations."""
    mask = mask.bool()
    x = params["embedding"][token_ids.long()].to(config.dtype)
    h = config.hidden_dim
    for li in range(config.num_layers):
        fwd = _lstm_scan(x, mask, params["fwd"][li], h, config.dtype)
        bwd = _lstm_scan(_reverse_padded(x, mask), mask, params["bwd"][li], h,
                         config.dtype)
        x = torch.cat([fwd, _reverse_padded(bwd, mask)], dim=-1)
    return x * mask[..., None].to(config.dtype)


class PlusRnnEncoder(TreeEncoder):
    """forward(token_ids, mask) → [B, L, 2*hidden_dim] (`encode`)."""

    encode_fn = staticmethod(encode)


def init_params(config: PlusRnnConfig, seed: int = 0, device="cuda") -> Params:
    """Random init at the JAX init's scales (normal · 0.1, the embedding
    · 1.0, zero biases), drawn in fp32 on `device` from
    torch.Generator(device).manual_seed(seed)."""
    device = resolve_device(device)
    gen = torch.Generator(device).manual_seed(seed)

    def w(*shape, scale=0.1):
        out = torch.randn(shape, generator=gen, dtype=torch.float32,
                          device=device)
        return (out * scale).to(config.dtype)

    h = config.hidden_dim

    def cell(in_dim):
        return {
            "w_x": w(in_dim, 4 * h),
            "w_h": w(h, 4 * h),
            "b": torch.zeros((4 * h,), dtype=config.dtype, device=device),
        }

    fwd, bwd = [], []
    in_dim = config.embed_dim
    for _ in range(config.num_layers):
        fwd.append(cell(in_dim))
        bwd.append(cell(in_dim))
        in_dim = 2 * h
    return {
        "embedding": w(config.vocab_size, config.embed_dim, scale=1.0),
        "fwd": fwd,
        "bwd": bwd,
    }


# PLUS's 21-letter protein alphabet: the 20 standard residues + X for
# everything else (documented default; a converted checkpoint may override
# it through the vocab stored in its meta)
PLUS_TOKENS = "ARNDCQEGHILKMFPSTWYV"
PLUS_VOCAB = {aa: i for i, aa in enumerate(PLUS_TOKENS)}
PLUS_UNK = 20


def tokenize(sequence: str, vocab=None) -> np.ndarray:
    table = vocab or PLUS_VOCAB
    unk = table.get("X", PLUS_UNK)
    return np.asarray(
        [table.get(aa, unk) for aa in sequence.upper()], dtype=np.int32
    )
