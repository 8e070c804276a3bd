"""Kernel M: one layer of SeqVec's bidirectional LSTMP recurrence in one
persistent launch (csrc/lstm_bidir.cu).

A CUDA tensor goes to the kernel; a CPU tensor to
ops/lstm.py:lstmp_bidir_plain. The kernel takes bf16 xw [2, B, T, 4H]
(x · W_x + b of both directions, contiguous), bf16 W_h [P, 4H] and W_proj
[H, P] of each direction, and the rows' lengths; its reach is P = 512 and
H = 4096 (SeqVec's widths), any rows and steps. The recurrent weights come
as an `LSTMPWeights`, made once (`lstmp_weights`): on the card it holds
them in the order the kernel's lanes read them too. The lengths come from
the host: the wrapper sorts the rows longest first there (a [B] index the
kernel reads through; no row is moved) and sends index and lengths up
without waiting for the card.
"""

from typing import NamedTuple, Optional, Sequence, Tuple

import numpy as np
import torch

from . import _build
from .lstm import lstmp_bidir_plain

KERNEL_PROJ = 512  # the widths the kernel is built for
KERNEL_CELLS = 4096
BLOCKS = 64  # a direction's blocks (csrc/lstm_bidir.cu: NB)
WARPS = 8


class LSTMPWeights(NamedTuple):
    """One layer's recurrent weights of both directions: (fwd, bwd) W_h
    [P, 4H] and W_proj [H, P] as given, and on the card the same stacked
    in the kernel's fragment order ([2, ...] each), else None."""

    w_h: Tuple[torch.Tensor, torch.Tensor]
    w_proj: Tuple[torch.Tensor, torch.Tensor]
    packed: Optional[Tuple[torch.Tensor, torch.Tensor]]


def lstmp_weights(w_h: Sequence[torch.Tensor],
                  w_proj: Sequence[torch.Tensor]) -> LSTMPWeights:
    """The layer's weights as lstmp_bidir takes them, packed for the
    kernel (one permuted copy each, 42 MB at SeqVec's widths) where they
    are bf16 on the card at the kernel's widths."""
    if len(w_h) != 2 or len(w_proj) != 2:
        raise ValueError("kernel M: one W_h and one W_proj a direction")
    proj, gates = w_h[0].shape
    for name, mats, shape in (("w_h", w_h, (proj, gates)),
                              ("w_proj", w_proj, (gates // 4, proj))):
        for m in mats:
            if tuple(m.shape) != shape:
                raise ValueError(f"kernel M: {name} is {tuple(m.shape)}, "
                                 f"expected {shape}")
    packed = None
    if (w_h[0].is_cuda and w_h[0].dtype == torch.bfloat16
            and (proj, gates // 4) == (KERNEL_PROJ, KERNEL_CELLS)):
        packed = (torch.stack([pack_w_h(w) for w in w_h]),
                  torch.stack([pack_w_proj(w) for w in w_proj]))
    return LSTMPWeights(tuple(w_h), tuple(w_proj), packed)


def _check(xw, weights, lengths):
    """Shapes and devices of both routes; dtype, layout and widths of the
    kernel's (CUDA tensors only)."""
    if xw.ndim != 4 or xw.shape[0] != 2:
        raise ValueError(f"kernel M: xw must be [2, B, T, 4H], got "
                         f"{tuple(xw.shape)}")
    _, b, steps, gates = xw.shape
    proj = weights.w_h[0].shape[0]
    if tuple(weights.w_h[0].shape) != (proj, gates):
        raise ValueError(f"kernel M: xw's {gates} gates do not match W_h "
                         f"{tuple(weights.w_h[0].shape)}")
    if len(lengths) != b:
        raise ValueError(f"kernel M: {len(lengths)} lengths for {b} rows")
    devices = {t.device for t in (xw, *weights.w_h, *weights.w_proj)}
    if len(devices) != 1:
        raise ValueError(f"kernel M: inputs on several devices: {devices}")
    if xw.device.type == "cpu":
        return
    if xw.dtype != torch.bfloat16 or weights.w_h[0].dtype != torch.bfloat16:
        raise TypeError(f"kernel M takes bf16; xw is {xw.dtype}, W_h "
                        f"{weights.w_h[0].dtype}")
    if not xw.is_contiguous():
        raise ValueError("kernel M needs a contiguous xw")
    if weights.packed is None:
        raise ValueError(f"kernel M is built for projection {KERNEL_PROJ} "
                         f"and {KERNEL_CELLS} cells, got {proj} and "
                         f"{gates // 4}")


def pack_w_h(w: torch.Tensor) -> torch.Tensor:
    """W_h [P, 4H] in the kernel's fragment order [block, warp, k-tile,
    lane, gate, register, half]: lane (g, t) of warp w in block b holds
    W_h[16·kt + 8·r + 2·t + half, gate·H + 64·b + 8·w + g]."""
    kt, cells = w.shape[0] // 16, w.shape[1] // 4
    v = w.reshape(kt, 2, 4, 2, 4, BLOCKS, WARPS, cells // (BLOCKS * WARPS))
    # dims: kt, r, t, half, gate, block, warp, g
    return v.permute(5, 6, 0, 7, 2, 4, 1, 3).contiguous()


def pack_w_proj(w: torch.Tensor) -> torch.Tensor:
    """W_proj [H, P] in the kernel's fragment order [block, warp, k-tile,
    lane, n-tile, register, half]: lane (g, t) of warp w in block b holds
    W_proj[64·b + 16·kt + 8·r + 2·t + half, 64·w + 8·j + g]."""
    cells, proj = w.shape
    per = cells // BLOCKS
    v = w.reshape(BLOCKS, per // 16, 2, 4, 2, WARPS, proj // (8 * WARPS), 8)
    # dims: block, kt, r, t, half, warp, j, g
    return v.permute(0, 5, 1, 7, 3, 6, 2, 4).contiguous()


def lstmp_bidir(
    xw: torch.Tensor,  # [2, B, T, 4H]
    weights: LSTMPWeights,  # lstmp_weights(w_h, w_proj)
    lengths: Sequence[int],  # [B] valid positions of each row, on the host
    cell_clip: float,
    proj_clip: float,
) -> torch.Tensor:
    """→ [B, T, 2P] in xw's dtype: forward ‖ backward h, aligned with the
    input (ops/lstm.py says what is computed)."""
    lens = np.asarray(lengths, dtype=np.int64).reshape(-1)
    _check(xw, weights, lens)
    if xw.device.type == "cpu":
        return lstmp_bidir_plain(xw, weights.w_h, weights.w_proj, lens,
                                 cell_clip, proj_clip)
    _, b, steps, gates = xw.shape
    cells, proj = gates // 4, weights.w_h[0].shape[0]
    out = torch.zeros((b, steps, 2 * proj), dtype=xw.dtype, device=xw.device)
    if b == 0 or steps == 0:
        return out
    dev = xw.device
    order = np.argsort(-lens, kind="stable")
    longest, shortest = int(lens[order[0]]), int(lens[order[-1]])
    if shortest < 0 or longest > steps:
        raise ValueError(f"kernel M: lengths must lie in [0, {steps}]")
    # [order; lengths in that order], one page-locked copy up, queued
    index = torch.from_numpy(np.stack([order, lens[order]]).astype(np.int32))
    index = index.pin_memory().to(dev, non_blocking=True)
    # scratch: sums [3, 2, B, P] and cells [2, B, H] f32, two counters
    floats = 6 * b * proj + 2 * b * cells
    scratch = torch.zeros(floats + 4, dtype=torch.float32, device=dev)
    sums, cell_state = scratch[:6 * b * proj], scratch[6 * b * proj:floats]
    counters = scratch[floats:]
    packed_h, packed_p = weights.packed
    code = _build.library().knn_lstmp_bidir(
        xw.data_ptr(), packed_h.data_ptr(), packed_p.data_ptr(),
        index[0].data_ptr(), index[1].data_ptr(), out.data_ptr(),
        sums.data_ptr(), cell_state.data_ptr(), counters.data_ptr(), b,
        steps, float(cell_clip), float(proj_clip), _build.stream_ptr(dev),
    )
    _build.check(code, "knn_lstmp_bidir")
    lstmp_bidir.launches += 1
    lstmp_bidir.steps += longest  # the kernel stops at the longest row
    return out


lstmp_bidir.launches = 0
lstmp_bidir.steps = 0
