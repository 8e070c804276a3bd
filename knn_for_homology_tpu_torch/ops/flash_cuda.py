"""Kernel H: T5 flash attention with the offset-bias table (csrc/flash_t5.cu).

Port of knn_for_homology_tpu/ops/flash_attention.py:_flash_kernel (entry
flash_attention_t5). A CUDA tensor goes to the kernel; a CPU tensor to
ops/flash_attention.py:flash_attention_plain. The kernel takes bf16 q/k/v
with d_kv = 128, a bool mask and the fp32 [H, 2L-1] table; each block
holds the window of its head's row that its 128 queries reach, (L + 191)·4
bytes, in shared memory beside 128 KB of q and k/v tiles, up to MAX_LEN.
"""

import torch

from . import _build
from .attention_checks import check_qkv
from .flash_attention import flash_attention_plain

# an L whose table window and key bits fit beside the kernel's 128 KB of
# tiles in the 227 KB of shared memory a block may use (up to 24128 would)
MAX_LEN = 24000


def flash_attention_t5(
    q: torch.Tensor,  # [B, H, L, dk]
    k: torch.Tensor,
    v: torch.Tensor,
    mask: torch.Tensor,  # [B, L] bool
    table: torch.Tensor,  # [H, 2L-1] fp32
    block: int = 512,
) -> torch.Tensor:
    """→ context [B, H, L, dk] in q's dtype. `block` is the plain
    version's key step; the kernel steps 64 keys at a time."""
    b, h, l, _ = q.shape
    check_qkv("kernel H", q, k, v, mask, table, (h, 2 * l - 1))
    if q.device.type == "cpu":
        return flash_attention_plain(q, k, v, mask, table, block)
    if l > MAX_LEN:
        raise ValueError(f"kernel H holds its bias table for L ≤ {MAX_LEN}, got {l}")
    out = torch.empty_like(q)
    if out.numel() == 0:
        return out
    code = _build.library().knn_flash_t5(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), mask.data_ptr(),
        table.data_ptr(), out.data_ptr(), b, h, l, _build.stream_ptr(q.device),
    )
    _build.check(code, "knn_flash_t5")
    flash_attention_t5.launches += 1
    return out


flash_attention_t5.launches = 0


def blocks_per_sm(length: int) -> int:
    """Blocks of the kernel that fit on one SM at this length (the CUDA
    occupancy query, registers and shared memory together)."""
    return _build.library().knn_flash_t5_blocks_per_sm(length)
