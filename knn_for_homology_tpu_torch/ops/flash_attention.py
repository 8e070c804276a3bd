"""T5 flash attention, plain version, and its offset-bias table (port of
knn_for_homology_tpu/ops/flash_attention.py:flash_attention_t5).

T5's relative-position bias depends only on k_pos - q_pos. The JAX kernel
feeds it as Toeplitz [n_rel, H, block, block] blocks (a Mosaic workaround);
here one [H, 2L-1] fp32 table per encode, shared by all layers, holds the
bias of every offset: table[h, k - q + L - 1].

The online softmax is the Pallas kernel's: running max from -1e9, masked
keys filled with -1e9 AND their p multiplied by 0 (a row with no real key
gives 0, not NaN), p cast to v's dtype before the PV product with fp32
sums, the normaliser summed from the fp32 p, and acc / max(l, 1e-30) cast
once. Kernel H (csrc/flash_t5.cu, wrapper ops/flash_cuda.py) computes the
same with 64-key steps.
"""

import torch

from ..models.t5 import offset_buckets

NEG = -1e9


def offset_bias_table(
    rel_embedding: torch.Tensor,  # [buckets, H]
    length: int,
    num_buckets: int,
    max_distance: int,
) -> torch.Tensor:
    """[H, 2·length − 1] fp32: table[h, d + length − 1] = the bias of
    offset d = k_pos − q_pos for head h, on rel_embedding's device."""
    buckets = offset_buckets(length, length, num_buckets, max_distance)
    buckets = buckets.to(rel_embedding.device)
    return rel_embedding[buckets].float().t().contiguous()


def flash_attention_plain(
    q: torch.Tensor,  # [B, H, L, dk]
    k: torch.Tensor,
    v: torch.Tensor,
    mask: torch.Tensor,  # [B, L] bool
    table: torch.Tensor,  # [H, 2L-1] fp32
    block: int = 512,
) -> torch.Tensor:
    """→ context [B, H, L, dk] in q's dtype; keys stream in `block` steps."""
    b, h, l, dk = q.shape
    pos = torch.arange(l, device=q.device)
    q32 = q.float()
    run_max = torch.full((b, h, l, 1), NEG, dtype=torch.float32, device=q.device)
    norm = torch.zeros_like(run_max)
    acc = torch.zeros((b, h, l, dk), dtype=torch.float32, device=q.device)
    for k0 in range(0, l, block):
        k1 = min(l, k0 + block)
        scores = torch.matmul(q32, k[:, :, k0:k1].float().transpose(-1, -2))
        scores = scores + table[:, pos[None, k0:k1] - pos[:, None] + l - 1][None]
        keep = mask[:, None, None, k0:k1]
        scores = torch.where(keep, scores, NEG)
        new_max = torch.maximum(run_max, scores.amax(dim=-1, keepdim=True))
        correction = torch.exp(run_max - new_max)
        p = torch.exp(scores - new_max) * keep.float()
        norm = norm * correction + p.sum(dim=-1, keepdim=True)
        pv = torch.matmul(p.to(v.dtype).float(), v[:, :, k0:k1].float())
        acc = acc * correction + pv
        run_max = new_max
    return (acc / torch.clamp(norm, min=1e-30)).to(q.dtype)
