"""SeqVec's bidirectional LSTMP recurrence over one layer, plain version of
kernel M (csrc/lstm_bidir.cu, wrapper ops/lstm_cuda.py).

Per step and direction, with xw_t = x_t · W_x + b given for every step:

    gates = xw_t + h_{t-1} · W_h                gates [i, f, g, o]
    c_t   = clip(σ(f)·c_{t-1} + σ(i)·tanh(g), ±cell_clip)
    h_t   = clip(bf16(σ(o)·tanh(c_t)) · W_proj, ±proj_clip), in xw's dtype

It rounds where the kernel rounds: xw and h in their dtype (bf16 on the
serving route), the gate sums, the cell state and the projection's sums in
fp32, the projection's operand in h's dtype. The forward direction walks
positions 0 … len−1 of each row, the backward direction the row's own
valid prefix reversed (len−1 … 0); each writes h_t at the position it
read, so both outputs are aligned with the input. A row's state stops at
its length; positions past it stay zero.
"""

from typing import Sequence

import torch


@torch.no_grad()
def lstmp_bidir_plain(
    xw: torch.Tensor,  # [2, B, T, 4H]: x · W_x + b of each direction
    w_h: Sequence[torch.Tensor],  # (fwd, bwd), each [P, 4H]
    w_proj: Sequence[torch.Tensor],  # (fwd, bwd), each [H, P]
    lengths,  # [B] valid positions of each row (a tensor or host ints)
    cell_clip: float,
    proj_clip: float,
) -> torch.Tensor:
    """→ [B, T, 2P] in xw's dtype: forward ‖ backward h at each position."""
    _, b, steps, gates = xw.shape
    cells, proj = gates // 4, w_proj[0].shape[1]
    dtype, dev = xw.dtype, xw.device
    lengths = torch.as_tensor(lengths, device=dev).long()
    out = torch.zeros((b, steps, 2 * proj), dtype=dtype, device=dev)
    rows = torch.arange(b, device=dev)
    run = int(lengths.max()) if b else 0
    for d in range(2):
        wh, wp = w_h[d].float(), w_proj[d].float()
        h = torch.zeros((b, proj), dtype=dtype, device=dev)
        c = torch.zeros((b, cells), dtype=torch.float32, device=dev)
        for t in range(run):
            live = lengths > t
            pos = t if d == 0 else torch.clamp(lengths - 1 - t, min=0)
            x_t = xw[d, rows, pos].float()
            i, f, g, o = (x_t + h.float() @ wh).chunk(4, dim=-1)
            c_new = torch.clamp(torch.sigmoid(f) * c
                                + torch.sigmoid(i) * torch.tanh(g),
                                -cell_clip, cell_clip)
            h_full = (torch.sigmoid(o) * torch.tanh(c_new)).to(dtype)
            h_new = torch.clamp(h_full.float() @ wp, -proj_clip,
                                proj_clip).to(dtype)
            h = torch.where(live[:, None], h_new, h)
            c = torch.where(live[:, None], c_new, c)
            at = rows[live]
            at_pos = pos if d == 0 else pos[live]
            out[at, at_pos, d * proj:(d + 1) * proj] = h_new[live]
    return out
