"""CPCProt encoder in PyTorch (port of knn_for_homology_tpu/models/
cpcprot.py) — contrastive-predictive-coding protein embeddings.

The reference embeds with bio_embeddings' CPCProtEmbedder (reference:
cath/embed.py:13,35): CPCProt (Lu et al. 2020) splits the sequence into
non-overlapping patches of `patch_len` residues (11 in the published model,
remainder discarded; short sequences are padded up to one patch), maps each
patch to a z vector with an embedding + 1D-conv encoder, and runs a GRU
autoregressor over the patch sequence for context vectors c. The
protein-level embedding the reference consumes is z_mean, the mean of z
over patches (512-d for the published model).

The convs are torch Conv1d with "same" padding written as an explicit
F.pad of ((k-1)//2, k//2), so an even kernel width pads as the JAX package
pads it; the GRU step (gates [r, z, n], the reset gate applied to
W_hn h + b_hn) is written out, its input product taken once before the
loop. There is no mask: padded patches follow the real ones.
"""

from dataclasses import dataclass
from typing import Any, Dict, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from ..device import resolve_device
from .module import TreeEncoder

Params = Dict[str, Any]


@dataclass(frozen=True)
class CPCProtConfig:
    vocab_size: int = 30
    embed_dim: int = 32
    patch_len: int = 11
    # (out_channels, kernel) per conv layer; ReLU between, mean-pool after
    conv_spec: Tuple[Tuple[int, int], ...] = ((64, 3), (64, 3), (512, 3))
    z_dim: int = 512  # = last conv out_channels
    c_dim: int = 512  # GRU hidden
    dtype: Any = torch.float32


CPCPROT = CPCProtConfig()
TINY_CPCPROT = CPCProtConfig(
    embed_dim=8, patch_len=4, conv_spec=((8, 3), (16, 3)), z_dim=16, c_dim=12
)


def _conv1d_same(x, w, b):
    """torch Conv1d with zero padding ((k-1)//2, k//2); x [N, L, Cin],
    w [K, Cin, Cout] → [N, L, Cout]."""
    k = w.shape[0]
    xt = F.pad(x.transpose(1, 2), ((k - 1) // 2, k // 2))
    return F.conv1d(xt, w.permute(2, 1, 0)).transpose(1, 2) + b


def _encode_patches(params, patch_ids, config: CPCProtConfig):
    """[N, patch_len] token ids → [N, z_dim] patch codes."""
    x = params["embedding"][patch_ids.long()].to(config.dtype)
    for cell in params["convs"]:
        x = torch.relu(_conv1d_same(x, cell["w"], cell["b"]))
    return x.mean(dim=1)  # pool over patch positions


def gru_step(gx, h, cell: Params, dtype):
    """One torch-convention GRU step: `gx` = x_t @ w_x + b_x [B, 3C]."""
    gh = (h @ cell["w_h"] + cell["b_h"]).float()
    xr, xz, xn = gx.float().chunk(3, dim=-1)
    hr, hz, hn = gh.chunk(3, dim=-1)
    r = torch.sigmoid(xr + hr)
    u = torch.sigmoid(xz + hz)
    n = torch.tanh(xn + r * hn)
    return ((1.0 - u) * n + u * h.float()).to(dtype)


def _gru_scan(z, cell, c_dim, dtype):
    """torch-convention GRU over [B, T, z_dim] → [B, T, c_dim]."""
    b, steps, _ = z.shape
    h = torch.zeros((b, c_dim), dtype=dtype, device=z.device)
    gx = z @ cell["w_x"] + cell["b_x"]
    hs = []
    for t in range(steps):
        h = gru_step(gx[:, t], h, cell, dtype)
        hs.append(h)
    return torch.stack(hs, dim=1)


def encode(
    params: Params,
    patch_ids: torch.Tensor,  # [B, n_patches, patch_len]
    config: CPCProtConfig,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """→ (z [B, T, z_dim], c [B, T, c_dim]) per patch."""
    b, t, p = patch_ids.shape
    z = _encode_patches(params, patch_ids.reshape(b * t, p), config)
    z = z.reshape(b, t, -1)
    c = _gru_scan(z, params["gru"], config.c_dim, config.dtype)
    return z, c


class CPCProtEncoder(TreeEncoder):
    """forward(patch_ids) → (z, c) (`encode`)."""

    encode_fn = staticmethod(encode)


def init_params(config: CPCProtConfig, seed: int = 0, device="cuda") -> Params:
    """Random init at the JAX init's scales (normal · 0.1, the embedding
    · 1.0, zero biases), drawn in fp32 on `device` from
    torch.Generator(device).manual_seed(seed)."""
    device = resolve_device(device)
    gen = torch.Generator(device).manual_seed(seed)

    def w(*shape, scale=0.1):
        out = torch.randn(shape, generator=gen, dtype=torch.float32,
                          device=device)
        return (out * scale).to(config.dtype)

    def zeros(n):
        return torch.zeros((n,), dtype=config.dtype, device=device)

    convs = []
    in_ch = config.embed_dim
    for out_ch, k in config.conv_spec:
        convs.append({"w": w(k, in_ch, out_ch), "b": zeros(out_ch)})
        in_ch = out_ch
    c = config.c_dim
    return {
        "embedding": w(config.vocab_size, config.embed_dim, scale=1.0),
        "convs": convs,
        "gru": {
            "w_x": w(config.z_dim, 3 * c),
            "w_h": w(c, 3 * c),
            "b_x": zeros(3 * c),
            "b_h": zeros(3 * c),
        },
    }


# TAPE's IUPAC vocabulary (CPCProt tokenizes with TAPE): 5 specials then
# the 25 extended residue letters in alphabetical order
CPC_PAD, CPC_MASK, CPC_CLS, CPC_SEP, CPC_UNK = 0, 1, 2, 3, 4
CPC_TOKENS = "ABCDEFGHIKLMNOPQRSTUVWXYZ"
CPC_VOCAB = {aa: i + 5 for i, aa in enumerate(CPC_TOKENS)}


def tokenize_patches(sequence: str, config: CPCProtConfig = CPCPROT,
                     vocab=None) -> np.ndarray:
    """[n_patches, patch_len] ids: remainder discarded, short sequences
    padded up to a single patch (CPCProt's patching rule)."""
    table = vocab or CPC_VOCAB
    ids = [table.get(aa, CPC_UNK) for aa in sequence.upper()]
    p = config.patch_len
    if len(ids) < p:
        ids = ids + [CPC_PAD] * (p - len(ids))
    n = len(ids) // p
    return np.asarray(ids[: n * p], dtype=np.int32).reshape(n, p)
