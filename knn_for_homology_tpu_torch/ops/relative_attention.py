"""XLNet's relative-position attention, plain version of kernel L
(csrc/flash_xlnet.cu, wrapper ops/relattn_cuda.py).

Per (query i, key j), with R the [2L, H, d_head] projection of the
sinusoid of relative positions L ... -L+1 (row L - i + j holds offset
i - j, what XLNet's reshape shift aligns):

    score = ((q_i + r_w).k_j + (q_i + r_r).R[L - i + j]) / sqrt(d_head)

q + r_w and q + r_r are rounded to q's dtype, as the model adds them. The
online softmax is kernel H's (ops/flash_attention.py): running max from
-1e9, masked keys filled with -1e9 AND their p multiplied by 0, p cast to
v's dtype before the PV product with fp32 sums, the normaliser summed from
the fp32 p, acc / max(l, 1e-30) cast once. A padded key stays attendable
from its own row (the diagonal rule of models/xlnet.py's fp32 route), so a
padded query row is never NaN. Keys stream in `block` steps; the position
scores of a step are one product of (q + r_r) with the rows of R the
step's offsets reach, gathered to (i, j), so no [L, 2L] tensor is held.
"""

import math

import torch

NEG = -1e9


def relative_attention_plain(
    q: torch.Tensor,  # [B, H, L, dh]
    k: torch.Tensor,
    v: torch.Tensor,
    r: torch.Tensor,  # [2L, H, dh]
    r_w: torch.Tensor,  # [H, dh]
    r_r: torch.Tensor,  # [H, dh]
    mask: torch.Tensor,  # [B, L] bool
    block: int = 512,
) -> torch.Tensor:
    """→ context [B, H, L, dh] in q's dtype."""
    b, h, l, dh = q.shape
    scale = 1.0 / math.sqrt(dh)
    qw = (q + r_w[None, :, None]).float()
    qr = (q + r_r[None, :, None]).float()
    rows = r.permute(1, 0, 2).float()  # [H, 2L, dh]
    pos = torch.arange(l, device=q.device)
    run_max = torch.full((b, h, l, 1), NEG, dtype=torch.float32, device=q.device)
    norm = torch.zeros_like(run_max)
    acc = torch.zeros((b, h, l, dh), dtype=torch.float32, device=q.device)
    for k0 in range(0, l, block):
        k1 = min(l, k0 + block)
        ac = torch.matmul(qw, k[:, :, k0:k1].float().transpose(-1, -2))
        # offsets L - i + j of this step lie in [k0 + 1, L + k1 - 1]
        near = torch.matmul(qr, rows[None, :, k0 + 1:l + k1].transpose(-1, -2))
        at = (l - pos[:, None] + pos[None, k0:k1]) - (k0 + 1)
        bd = near.gather(-1, at.expand(b, h, l, k1 - k0))
        scores = (ac + bd) * scale
        keep = (mask[:, None, None, k0:k1]
                | (pos[:, None] == pos[None, k0:k1])[None, None])
        scores = torch.where(keep, scores, NEG)
        new_max = torch.maximum(run_max, scores.amax(dim=-1, keepdim=True))
        correction = torch.exp(run_max - new_max)
        p = torch.exp(scores - new_max) * keep.float()
        norm = norm * correction + p.sum(dim=-1, keepdim=True)
        pv = torch.matmul(p.to(v.dtype).float(), v[:, :, k0:k1].float())
        acc = acc * correction + pv
        run_max = new_max
    return (acc / torch.clamp(norm, min=1e-30)).to(q.dtype)
