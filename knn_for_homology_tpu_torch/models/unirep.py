"""UniRep — the babbler-1900 mLSTM in PyTorch (port of
knn_for_homology_tpu/models/unirep.py; reference registry entry "UniRep",
cath/embed.py:34-46).

Multiplicative LSTM (Krause et al.): an intermediate multiplicative state
m = (x·W_mx) ⊙ (h·W_mh) feeds the gate projections instead of h. Gates
[i, f, o, u]; masked steps carry (h, c) and emit zeros. The input products
of all steps are one matmul each before the time loop; the per-step
arithmetic is the JAX step's.
"""

from dataclasses import dataclass
from typing import Any, Dict

import numpy as np
import torch

from ..device import resolve_device
from .module import TreeEncoder

Params = Dict[str, Any]

# UniRep babbler-1900 aa_to_int layout (churchlab/UniRep): pad=0, residues
# M..L at 1..21, O=22, rare (X/Z/B/J)→23, start=24, stop=25
UNIREP_AAS = "MRHKDESTNQCUGPAVIFYWL"
UNIREP_VOCAB = {aa: i + 1 for i, aa in enumerate(UNIREP_AAS)}
UNIREP_VOCAB["O"] = 22
for _rare in "XZBJ":
    UNIREP_VOCAB[_rare] = 23
UNIREP_PAD, UNIREP_START, UNIREP_STOP = 0, 24, 25


@dataclass(frozen=True)
class UniRepConfig:
    vocab_size: int = 26
    embed_dim: int = 10
    hidden_dim: int = 1900
    dtype: Any = torch.float32


UNIREP = UniRepConfig()
TINY_UNIREP = UniRepConfig(embed_dim=4, hidden_dim=16)


def tokenize(sequence: str) -> np.ndarray:
    ids = [UNIREP_START]
    for aa in sequence.upper():
        ids.append(UNIREP_VOCAB.get(aa, UNIREP_VOCAB["X"]))
    return np.asarray(ids, dtype=np.int32)


def mlstm_step(xm, xw, h, c, keep, params: Params, config: UniRepConfig):
    """One mLSTM step of a batch: `xm` = x_t @ wmx [B, H], `xw` = x_t @ wx
    [B, 4H]; masked rows (keep False) carry (h, c). → (h, c, output)."""
    m = xm * (h @ params["wmh"])
    gates = (xw + m @ params["wh"] + params["b"]).float()
    i, f, o, u = gates.chunk(4, dim=-1)
    c_new = torch.sigmoid(f) * c + torch.sigmoid(i) * torch.tanh(u)
    h_new = (torch.sigmoid(o) * torch.tanh(c_new)).to(config.dtype)
    keep = keep[:, None]
    return (torch.where(keep, h_new, h), torch.where(keep, c_new, c),
            torch.where(keep, h_new, 0.0))


def encode(
    params: Params,
    token_ids: torch.Tensor,  # [B, L]
    mask: torch.Tensor,  # [B, L] bool
    config: UniRepConfig,
) -> torch.Tensor:
    """Per-position hidden states [B, L, hidden]."""
    mask = mask.bool()
    b, length = token_ids.shape
    x = params["embedding"][token_ids.long()].to(config.dtype)  # [B, L, E]
    h = torch.zeros((b, config.hidden_dim), dtype=config.dtype,
                    device=x.device)
    c = torch.zeros((b, config.hidden_dim), dtype=torch.float32,
                    device=x.device)
    xm, xw = x @ params["wmx"], x @ params["wx"]  # every step's at once
    outs = []
    for t in range(length):
        h, c, out = mlstm_step(xm[:, t], xw[:, t], h, c, mask[:, t], params,
                               config)
        outs.append(out)
    return torch.stack(outs, dim=1)


class UniRepEncoder(TreeEncoder):
    """forward(token_ids, mask) → [B, L, hidden] (`encode`)."""

    encode_fn = staticmethod(encode)


def init_params(config: UniRepConfig, seed: int = 0, device="cuda") -> Params:
    """Random init at the JAX init's scales (normal · 0.1, the embedding
    · 1.0, zero bias), drawn in fp32 on `device` from
    torch.Generator(device).manual_seed(seed)."""
    device = resolve_device(device)
    gen = torch.Generator(device).manual_seed(seed)

    def w(*shape, scale=0.1):
        out = torch.randn(shape, generator=gen, dtype=torch.float32,
                          device=device)
        return (out * scale).to(config.dtype)

    h = config.hidden_dim
    return {
        "embedding": w(config.vocab_size, config.embed_dim, scale=1.0),
        "wmx": w(config.embed_dim, h),
        "wmh": w(h, h),
        "wx": w(config.embed_dim, 4 * h),
        "wh": w(h, 4 * h),
        "b": torch.zeros((4 * h,), dtype=config.dtype, device=device),
    }
