"""Kernel L: XLNet's relative-position flash attention (csrc/flash_xlnet.cu).

A CUDA tensor goes to the kernel; a CPU tensor to
ops/relative_attention.py:relative_attention_plain. The kernel takes bf16
q, k, v [B, H, L, 64], bf16 R [2L, H, 64] whose rows may lie any multiple
of 8 elements apart (one layer's slice of every layer's R, say), bf16 r_w
and r_r [H, 64] and a bool key mask [B, L]; no [L, L] or [L, 2L] tensor is
made.
"""

import torch

from . import _build
from .relative_attention import relative_attention_plain

KERNEL_DH = 64  # head width the kernel is built for
# an L whose key bits fit beside the kernel's ~186 KB of shared memory
MAX_LEN = 65536


def _check(q, k, v, r, r_w, r_r, mask):
    """Shapes and devices of both routes; dtype, layout and head width of
    the kernel's (CUDA tensors only)."""
    b, h, l, dh = q.shape
    if k.shape != q.shape or v.shape != q.shape:
        raise ValueError("kernel L: q, k, v shapes differ")
    if tuple(r.shape) != (2 * l, h, dh):
        raise ValueError(f"kernel L: r is {tuple(r.shape)}, expected "
                         f"{(2 * l, h, dh)}")
    for name, bias in (("r_w", r_w), ("r_r", r_r)):
        if tuple(bias.shape) != (h, dh):
            raise ValueError(f"kernel L: {name} must be [{h}, {dh}]")
    if mask.shape != (b, l) or mask.dtype != torch.bool:
        raise ValueError(f"kernel L: mask must be bool [{b}, {l}]")
    devices = {a.device for a in (q, k, v, r, r_w, r_r, mask)}
    if len(devices) != 1:
        raise ValueError(f"kernel L: inputs on several devices: {devices}")
    if q.device.type == "cpu":
        return
    for name, a in (("q", q), ("k", k), ("v", v), ("r", r), ("r_w", r_w),
                    ("r_r", r_r)):
        if a.dtype != torch.bfloat16:
            raise TypeError(f"kernel L takes bf16; {name} is {a.dtype}")
    for name, a in (("q", q), ("k", k), ("v", v), ("r_w", r_w), ("r_r", r_r),
                    ("mask", mask)):
        if not a.is_contiguous():
            raise ValueError(f"kernel L needs contiguous inputs; {name} is not")
    if r.stride(2) != 1 or r.stride(1) != dh or r.stride(0) % 8:
        raise ValueError(f"kernel L: r's heads must be contiguous rows a "
                         f"multiple of 8 apart; strides {r.stride()}")
    if dh != KERNEL_DH:
        raise ValueError(f"kernel L is built for d_head {KERNEL_DH}, got {dh}")
    if l > MAX_LEN:
        raise ValueError(f"kernel L takes L ≤ {MAX_LEN}, got {l}")


def relative_attention(
    q: torch.Tensor,  # [B, H, L, dh]
    k: torch.Tensor,
    v: torch.Tensor,
    r: torch.Tensor,  # [2L, H, dh]
    r_w: torch.Tensor,  # [H, dh]
    r_r: torch.Tensor,  # [H, dh]
    mask: torch.Tensor,  # [B, L] bool
    block: int = 512,
) -> torch.Tensor:
    """→ context [B, H, L, dh] in q's dtype. `block` is the plain version's
    key step; the kernel steps 64 keys at a time."""
    _check(q, k, v, r, r_w, r_r, mask)
    if q.device.type == "cpu":
        return relative_attention_plain(q, k, v, r, r_w, r_r, mask, block)
    b, h, l, _ = q.shape
    out = torch.empty_like(q)
    if out.numel() == 0:
        return out
    code = _build.library().knn_flash_xlnet(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), r.data_ptr(), r.stride(0),
        mask.data_ptr(), r_w.data_ptr(), r_r.data_ptr(), out.data_ptr(), b, h,
        l, _build.stream_ptr(q.device),
    )
    _build.check(code, "knn_flash_xlnet")
    relative_attention.launches += 1
    return out


relative_attention.launches = 0
