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
lookup table. Each LSTM layer is one product a direction for x · w_x + b of
every step, then one call that runs both directions' recurrences (torch's
and cuDNN's LSTMs cannot clip): ops/lstm.py's step loop, gates [i, f, g,
o], fp32 cell state, as the JAX step computes it. A bf16 config serves on
the recurrence kernel M instead (ops/lstm_cuda.py:lstmp_bidir; `encode`
routes by dtype alone), which on the CPU runs that same step loop. Both
walk the backward direction over each row's own prefix reversed, so no
reversal is materialised.
"""

from dataclasses import dataclass
from typing import Any, Dict, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from ..device import resolve_device
from ..ops import lstm_cuda
from ..ops.lstm import lstmp_bidir_plain
from ..utils.trace import span
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


# byte -> residue id, unknown bytes -> X
_BYTE_TO_ID = np.full(256, AA_TO_ID["X"], dtype=np.int32)
for _aa, _i in AA_TO_ID.items():
    _BYTE_TO_ID[ord(_aa)] = _i


def tokenize(sequence: str) -> np.ndarray:
    """Residue ids of the upper-cased sequence; any other letter is X."""
    raw = sequence.upper().encode("ascii", errors="replace")
    return _BYTE_TO_ID[np.frombuffer(raw, dtype=np.uint8)]


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
    """Evaluate the CharCNN over the whole alphabet → [vocab+2, proj_dim],
    in fp32 whatever the weights' dtype, rounded to the config's once."""
    emb = params["char_embedding"]
    char_ids = torch.from_numpy(_char_ids_for_alphabet()).to(emb.device).long()
    x = emb[char_ids].float()  # [V, W, E]
    feats = []
    for conv in params["convs"]:
        # VALID conv over the word's characters as one fp32 product of the
        # windows with the [width, E, n_out] weights, then max over
        # positions (a product, not cuDNN: no TF32, no per-call set-up)
        w = conv["w"].float()
        windows = x.unfold(1, w.shape[0], 1)  # [V, positions, E, width]
        y = torch.einsum("vpew,wen->vpn", windows, w) + conv["b"].float()
        feats.append(torch.tanh(y).amax(dim=1))  # [V, n_out]
    h = torch.cat(feats, dim=1)  # [V, total_filters]
    for hw in params["highways"]:
        gate = torch.sigmoid(h @ hw["w_gate"].float() + hw["b_gate"].float())
        lin = torch.relu(h @ hw["w_lin"].float() + hw["b_lin"].float())
        h = gate * lin + (1.0 - gate) * h
    return (h @ params["proj_w"].float()
            + params["proj_b"].float()).to(config.dtype)


# --- LSTM with projection (ELMo flavour) --------------------------------------


def serves_on_kernel(config: ElmoConfig) -> bool:
    """The recurrence runs on kernel M's wrapper for a bf16 config."""
    return config.dtype == torch.bfloat16


def recurrent_weights(params: Params, config: ElmoConfig) -> list:
    """Each LSTM layer's recurrent weights of both directions, as
    ops/lstm_cuda.py:lstmp_bidir takes them (packed for the kernel where
    it runs)."""
    return [lstm_cuda.lstmp_weights(
        [params[side][li]["w_h"] for side in ("lstm_fwd", "lstm_bwd")],
        [params[side][li]["w_proj"] for side in ("lstm_fwd", "lstm_bwd")])
        for li in range(config.n_lstm_layers)]


def encode(
    params: Params,
    token_ids: torch.Tensor,  # [B, L] residue ids
    mask: torch.Tensor,  # [B, L] bool
    config: ElmoConfig,
    lengths=None,  # [B] residues of each row, on the host
    recurrent=None,  # recurrent_weights(params, config)
) -> torch.Tensor:
    """→ [3, B, L, 2*proj_dim] layer activations (CharCNN, LSTM1, LSTM2).

    As in AllenNLP's ElmoEmbedder (what the reference's bio_embeddings ran),
    the bi-LSTMs process the sequence wrapped in <S>/</S> boundary words,
    whose positions are stripped from every output layer. Every family's
    encode takes (params, ids, mask, config); ElmoEncoder passes the
    rows' `lengths` and the packed `recurrent` weights as well, which are
    otherwise read from `mask` (a wait for the card) and packed anew."""
    token_ids, mask = token_ids.long(), mask.bool()
    length = token_ids.shape[1]
    table = char_cnn_table(params, config)  # [V+2, proj]
    row_lengths = mask.sum(dim=1)  # [B], on the device
    if lengths is None:
        lengths = row_lengths.tolist()
    if recurrent is None:
        recurrent = recurrent_weights(params, config)
    ext_lengths = [int(n) + 2 for n in lengths]

    # extended sequence: <S> x_1 … x_len </S> (EOS at a per-row position)
    pos = torch.arange(length + 2, device=token_ids.device)[None]
    ids_ext = F.pad(token_ids, (1, 1))
    ids_ext = torch.where(pos == 0, BOS_ID, ids_ext)
    ids_ext = torch.where(pos == row_lengths[:, None] + 1, EOS_ID, ids_ext)
    mask_ext = pos <= row_lengths[:, None] + 1
    repr_ext = table[ids_ext] * mask_ext[..., None].to(config.dtype)

    token_repr = table[token_ids] * mask[..., None].to(config.dtype)
    layers = [torch.cat([token_repr, token_repr], dim=-1)]
    b, steps, proj = repr_ext.shape
    gates = 4 * config.lstm_dim
    inputs = (repr_ext, repr_ext)
    mask_f = mask[..., None].to(config.dtype)
    for li in range(config.n_lstm_layers):
        cells = (params["lstm_fwd"][li], params["lstm_bwd"][li])
        with span("embed.lstm_input"):
            xw = torch.empty((2, b, steps, gates), dtype=config.dtype,
                             device=repr_ext.device)
            for d, cell in enumerate(cells):
                torch.addmm(cell["b"], inputs[d].reshape(-1, proj),
                            cell["w_x"], out=xw[d].view(-1, gates))
        with span("embed.lstm"):
            if serves_on_kernel(config):
                out = lstm_cuda.lstmp_bidir(xw, recurrent[li], ext_lengths,
                                            config.cell_clip,
                                            config.proj_clip)
            else:
                out = lstmp_bidir_plain(xw, recurrent[li].w_h,
                                        recurrent[li].w_proj, ext_lengths,
                                        config.cell_clip, config.proj_clip)
        del xw
        if li > 0:  # ELMo residual connections between LSTM layers
            out = out + below
        # outputs stay aligned, the backward one too: strip the boundary
        # positions, zero the padding; the next layer reads them as they are
        layers.append(out[:, 1:length + 1] * mask_f)
        below = out
        inputs = (out[..., :proj], out[..., proj:])
    return torch.stack(layers, dim=0)


class ElmoEncoder(TreeEncoder):
    """forward(token_ids, mask, lengths=None) → [3, B, L, 2*proj_dim]
    (`encode`), with the recurrent weights packed once, here."""

    def __init__(self, config, params: Params):
        super().__init__(config, params)
        self.recurrent = recurrent_weights(self.params(), config)

    def _apply(self, fn, *args, **kwargs):  # .to() and the like: repack
        out = super()._apply(fn, *args, **kwargs)
        self.recurrent = recurrent_weights(self.params(), self.config)
        return out

    @torch.no_grad()
    def forward(self, token_ids, mask, lengths=None):
        return encode(self.params(), token_ids, mask, self.config, lengths,
                      self.recurrent)


def init_params(config: ElmoConfig, seed: int = 0, device="cuda") -> Params:
    """Random init at the JAX init's scales (normal · 0.1, the char
    embedding · 1.0, zero biases), drawn in fp32 on `device` from
    torch.Generator(device).manual_seed(seed). Real SeqVec weights come
    from models/convert.py.

    At the published widths this scale makes the recurrence chaotic: a
    4096-cell LSTM whose 16384 x 512 recurrent weights have a spread of
    0.1 (gate sums of spread ~2 from h alone) amplifies any difference
    from step to step, so a one-ulp change of the weights, or fp32 against
    fp64, grows to an O(1) relative gap within ~64 steps (scripts/
    torch_recurrence_drift.py). Such weights can test a route only over a
    few steps. The benchmark (portbench/drivers/embed_seqvec.py) draws the
    LSTMs at TF1's Glorot-uniform default instead, bilm-tf's
    initialisation, where the same change stays at rounding size over
    thousands of steps (tests/test_torch_seqvec.py)."""
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
