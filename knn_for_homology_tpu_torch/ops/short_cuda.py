"""Kernel I: dense T5 attention for L ≤ 512 (csrc/short_t5.cu).

Port of knn_for_homology_tpu/ops/short_attention.py:_short_kernel (entry
short_attention_t5). A CUDA tensor goes to the kernel; a CPU tensor to
ops/short_attention.py:short_attention_plain. The kernel takes bf16 q/k/v
with d_kv = 128, a bool mask and the fp32 [H, L, L] bias.
"""

import torch

from . import _build
from .attention_checks import check_qkv
from .short_attention import short_attention_plain

MAX_LEN = 512  # the kernel's [64, L] fp32 score tile lives in shared memory


def short_attention_t5(
    q: torch.Tensor,  # [B, H, L, dk]
    k: torch.Tensor,
    v: torch.Tensor,
    mask: torch.Tensor,  # [B, L] bool
    bias: torch.Tensor,  # [H, L, L] fp32
) -> torch.Tensor:
    """→ context [B, H, L, dk] in q's dtype."""
    b, h, l, _ = q.shape
    check_qkv("kernel I", q, k, v, mask, bias, (h, l, l))
    if q.device.type == "cpu":
        return short_attention_plain(q, k, v, mask, bias)
    if l > MAX_LEN:
        raise ValueError(f"kernel I handles L ≤ {MAX_LEN}, got {l}")
    out = torch.empty_like(q)
    if out.numel() == 0:
        return out
    code = _build.library().knn_short_t5(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), mask.data_ptr(),
        bias.data_ptr(), out.data_ptr(), b, h, l, _build.stream_ptr(q.device),
    )
    _build.check(code, "knn_short_t5")
    short_attention_t5.launches += 1
    return out


short_attention_t5.launches = 0
