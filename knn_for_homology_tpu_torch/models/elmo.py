"""SeqVec (ELMo bi-LM) encoder in PyTorch (port of
knn_for_homology_tpu/models/elmo.py).

The 3-layer protein language model whose layers the reference exposes as
SeqVec Sum / CharCNN / LSTM1 / LSTM2 (reference: cath/embed.py:100-105) and
whose LSTM1 slice [1024:2048] is the Pfam embedding (reference:
pfam/embed_pfam_seqvec.py:77-78).

Architecture = original ELMo: CharCNN token encoder (char embedding →
multi-width convs → max-pool → highways → 512 projection) + 2-layer
bidirectional LSTM (4096 cells, 512 projection, cell and projection clipping
at 3, residual between layers). Output: 3 layers of [L, 1024] (layer 0 = the
token representation duplicated; layers 1/2 = fwd‖bwd projections).

Each protein "word" is a single residue, so the CharCNN is a fixed function
of the residue: it is evaluated once over the alphabet into a [vocab, 512]
lookup table. The LSTM step is written out as in the JAX package (torch's
and cuDNN's LSTMs cannot clip): gates [i, f, g, o], fp32 cell state, masked
steps carry (h, c). The input product x @ w_x of all steps is one matmul
before the time loop; the per-step arithmetic is the JAX step's.
"""

from dataclasses import dataclass
from typing import Any, Dict, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from ..device import resolve_device
from .module import TreeEncoder

Params = Dict[str, Any]

# residue vocabulary: index = position in AA_ORDER; unknowns → X
AA_ORDER = "ACDEFGHIKLMNPQRSTVWYX"
AA_TO_ID = {aa: i for i, aa in enumerate(AA_ORDER)}


@dataclass(frozen=True)
class ElmoConfig:
    char_embed_dim: int = 16
    filters: Tuple[Tuple[int, int], ...] = (
        (1, 32), (2, 32), (3, 64), (4, 128), (5, 256), (6, 512), (7, 1024),
    )
    n_highway: int = 2
    proj_dim: int = 512  # per-direction output dim; layers are 2*proj
    lstm_dim: int = 4096
    n_lstm_layers: int = 2
    cell_clip: float = 3.0
    proj_clip: float = 3.0
    dtype: Any = torch.float32


SEQVEC = ElmoConfig()
TINY_ELMO = ElmoConfig(
    char_embed_dim=4,
    filters=((1, 8), (2, 8), (3, 16)),
    n_highway=1,
    proj_dim=16,
    lstm_dim=32,
    n_lstm_layers=2,
)


def tokenize(sequence: str) -> np.ndarray:
    return np.asarray(
        [AA_TO_ID.get(aa, AA_TO_ID["X"]) for aa in sequence.upper()],
        dtype=np.int32,
    )


# --- CharCNN → residue lookup table ------------------------------------------

# bilm-tf character conventions (raw byte values for characters; the special
# ids live above the byte range, and the converted char_embed table is
# indexed with exactly these raw ids)
BOS_CHAR, EOS_CHAR = 256, 257  # <S> / </S> sentence-boundary "words"
BOW, EOW, CHAR_PAD = 258, 259, 260
MAX_WORD_CHARS = 8  # a residue word is [BOW, char, EOW] + padding

# lookup-table rows appended after the residue alphabet for the boundary
# words AllenNLP always runs the bi-LSTMs through
BOS_ID = len(AA_ORDER)
EOS_ID = len(AA_ORDER) + 1


def _char_ids_for_alphabet() -> np.ndarray:
    """[vocab+2, MAX_WORD_CHARS] bilm-tf char ids: one single-char word per
    residue plus the <S>/</S> boundary words."""
    words = [ord(aa) for aa in AA_ORDER] + [BOS_CHAR, EOS_CHAR]
    out = np.full((len(words), MAX_WORD_CHARS), CHAR_PAD, dtype=np.int32)
    for i, char_id in enumerate(words):
        out[i, 0] = BOW
        out[i, 1] = char_id
        out[i, 2] = EOW
    return out


def char_cnn_table(params: Params, config: ElmoConfig) -> torch.Tensor:
    """Evaluate the CharCNN over the whole alphabet → [vocab+2, proj_dim]."""
    emb = params["char_embedding"]
    char_ids = torch.from_numpy(_char_ids_for_alphabet()).to(emb.device).long()
    x = emb[char_ids].float().transpose(1, 2)  # [V, E, W]
    feats = []
    for conv in params["convs"]:
        # VALID conv over the word's characters ([width, E, n_out] weights
        # → torch's [n_out, E, width]), then max over positions
        y = F.conv1d(x, conv["w"].float().permute(2, 1, 0)) + conv["b"][:, None]
        feats.append(torch.tanh(y).amax(dim=2))  # [V, n_out]
    h = torch.cat(feats, dim=1)  # [V, total_filters]
    for hw in params["highways"]:
        gate = torch.sigmoid(h @ hw["w_gate"] + hw["b_gate"])
        lin = torch.relu(h @ hw["w_lin"] + hw["b_lin"])
        h = gate * lin + (1.0 - gate) * h
    return (h @ params["proj_w"] + params["proj_b"]).to(config.dtype)


# --- LSTM with projection (ELMo flavour) --------------------------------------


def lstm_step(xw, h, c, keep, cell: Params, config: ElmoConfig):
    """One LSTMP step of a batch: `xw` = x_t @ w_x [B, 4H]; masked rows
    (keep False) carry (h, c). → (h, c)."""
    gates = (xw + h @ cell["w_h"] + cell["b"]).float()
    i, f, g, o = gates.chunk(4, dim=-1)
    c_new = torch.sigmoid(f) * c + torch.sigmoid(i) * torch.tanh(g)
    c_new = torch.clamp(c_new, -config.cell_clip, config.cell_clip)
    h_full = torch.sigmoid(o) * torch.tanh(c_new)
    h_new = (h_full @ cell["w_proj"].float()).to(config.dtype)
    h_new = torch.clamp(h_new, -config.proj_clip, config.proj_clip)
    keep = keep[:, None]
    return torch.where(keep, h_new, h), torch.where(keep, c_new, c)


def _lstm_scan(
    x: torch.Tensor,  # [B, L, in_dim]
    mask: torch.Tensor,  # [B, L] bool
    cell: Params,
    config: ElmoConfig,
) -> torch.Tensor:
    """Unidirectional LSTMP over the sequence → [B, L, proj]."""
    b, length, _ = x.shape
    h = torch.zeros((b, config.proj_dim), dtype=config.dtype, device=x.device)
    c = torch.zeros((b, config.lstm_dim), dtype=torch.float32, device=x.device)
    xw = x @ cell["w_x"]  # every step's input product at once
    hs = []
    for t in range(length):
        h, c = lstm_step(xw[:, t], h, c, mask[:, t], cell, config)
        hs.append(h)
    return torch.stack(hs, dim=1)


def _reverse_padded(x: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
    """Flip only the valid prefix of each right-padded row."""
    lengths = mask.sum(dim=1)
    length = x.shape[1]
    idx = lengths[:, None] - 1 - torch.arange(length, device=x.device)[None]
    idx = torch.clamp(idx, 0, length - 1)
    if x.ndim == 3:
        idx = idx[..., None].expand(-1, -1, x.shape[2])
    return torch.gather(x, 1, idx)


def encode(
    params: Params,
    token_ids: torch.Tensor,  # [B, L] residue ids
    mask: torch.Tensor,  # [B, L] bool
    config: ElmoConfig,
) -> torch.Tensor:
    """→ [3, B, L, 2*proj_dim] layer activations (CharCNN, LSTM1, LSTM2).

    As in AllenNLP's ElmoEmbedder (what the reference's bio_embeddings ran),
    the bi-LSTMs process the sequence wrapped in <S>/</S> boundary words,
    whose positions are stripped from every output layer."""
    token_ids, mask = token_ids.long(), mask.bool()
    length = token_ids.shape[1]
    table = char_cnn_table(params, config)  # [V+2, proj]
    lengths = mask.sum(dim=1)  # [B]

    # extended sequence: <S> x_1 … x_len </S> (EOS at a per-row position)
    pos = torch.arange(length + 2, device=token_ids.device)[None]
    ids_ext = F.pad(token_ids, (1, 1))
    ids_ext = torch.where(pos == 0, BOS_ID, ids_ext)
    ids_ext = torch.where(pos == lengths[:, None] + 1, EOS_ID, ids_ext)
    mask_ext = pos <= lengths[:, None] + 1
    repr_ext = table[ids_ext] * mask_ext[..., None].to(config.dtype)

    token_repr = table[token_ids] * mask[..., None].to(config.dtype)
    layer0 = torch.cat([token_repr, token_repr], dim=-1)

    fwd_in, bwd_in = repr_ext, _reverse_padded(repr_ext, mask_ext)
    layers = [layer0]
    mask_f = mask[..., None].to(config.dtype)
    for li in range(config.n_lstm_layers):
        fwd = _lstm_scan(fwd_in, mask_ext, params["lstm_fwd"][li], config)
        bwd = _lstm_scan(bwd_in, mask_ext, params["lstm_bwd"][li], config)
        if li > 0:  # ELMo residual connections between LSTM layers
            fwd = fwd + fwd_in
            bwd = bwd + bwd_in
        bwd_aligned = _reverse_padded(bwd, mask_ext)
        # strip the boundary positions; zero the padding
        layers.append(torch.cat(
            [fwd[:, 1 : length + 1] * mask_f,
             bwd_aligned[:, 1 : length + 1] * mask_f],
            dim=-1,
        ))
        fwd_in, bwd_in = fwd, bwd
    return torch.stack(layers, dim=0)


class ElmoEncoder(TreeEncoder):
    """forward(token_ids, mask) → [3, B, L, 2*proj_dim] (`encode`)."""

    encode_fn = staticmethod(encode)


def init_params(config: ElmoConfig, seed: int = 0, device="cuda") -> Params:
    """Random init at the JAX init's scales (normal · 0.1, the char
    embedding · 1.0, zero biases), drawn in fp32 on `device` from
    torch.Generator(device).manual_seed(seed). Real SeqVec weights come
    from models/convert.py."""
    device = resolve_device(device)
    gen = torch.Generator(device).manual_seed(seed)

    def w(*shape, scale=0.1):
        out = torch.randn(shape, generator=gen, dtype=torch.float32,
                          device=device)
        return (out * scale).to(config.dtype)

    def zeros(n, dtype=config.dtype):
        return torch.zeros((n,), dtype=dtype, device=device)

    total_filters = sum(n for _, n in config.filters)

    def lstm_cell(in_dim):
        return {
            "w_x": w(in_dim, 4 * config.lstm_dim),
            "w_h": w(config.proj_dim, 4 * config.lstm_dim),
            "b": zeros(4 * config.lstm_dim),
            "w_proj": w(config.lstm_dim, config.proj_dim),
        }

    return {
        "char_embedding": w(262, config.char_embed_dim, scale=1.0),
        "convs": [
            {"w": w(width, config.char_embed_dim, n),
             "b": zeros(n, torch.float32)}
            for width, n in config.filters
        ],
        "highways": [
            {
                "w_gate": w(total_filters, total_filters),
                "b_gate": zeros(total_filters, torch.float32),
                "w_lin": w(total_filters, total_filters),
                "b_lin": zeros(total_filters, torch.float32),
            }
            for _ in range(config.n_highway)
        ],
        "proj_w": w(total_filters, config.proj_dim),
        "proj_b": zeros(config.proj_dim, torch.float32),
        "lstm_fwd": [lstm_cell(config.proj_dim)
                     for _ in range(config.n_lstm_layers)],
        "lstm_bwd": [lstm_cell(config.proj_dim)
                     for _ in range(config.n_lstm_layers)],
    }
