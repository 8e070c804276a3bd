"""Dense T5 attention for short sequences, plain version (port of
knn_for_homology_tpu/ops/short_attention.py:short_attention_t5).

Numerics of models/t5.py:_attention: exact fp32 scores plus the [H, L, L]
fp32 bias, the -1e9 mask fill (p is not zeroed, so a row with every key
masked softmaxes to uniform), max, exp, sum and divide in fp32, p cast to
v's dtype, PV summed in fp32 and cast once. Kernel I (csrc/short_t5.cu,
wrapper ops/short_cuda.py) computes the same for L ≤ 512.
"""

import torch

NEG = -1e9


def short_attention_plain(
    q: torch.Tensor,  # [B, H, L, dk]
    k: torch.Tensor,
    v: torch.Tensor,
    mask: torch.Tensor,  # [B, L] bool
    bias: torch.Tensor,  # [H, L, L] fp32
) -> torch.Tensor:
    scores = torch.matmul(q.float(), k.float().transpose(-1, -2)) + bias[None]
    scores = torch.where(mask[:, None, None, :], scores, NEG)
    m = scores.amax(dim=-1, keepdim=True)
    p = torch.exp(scores - m)
    p = p / p.sum(dim=-1, keepdim=True)
    return torch.matmul(p.to(v.dtype).float(), v.float()).to(q.dtype)
