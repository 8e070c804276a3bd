"""Argument checks shared by the attention kernels' wrappers (H, I)."""

import torch

KERNEL_DK = 128  # head width the attention kernels are built for


def check_qkv(name, q, k, v, mask, bias, bias_shape):
    """Shapes and devices of every route; dtype, contiguity and head width
    of the kernels' (CUDA tensors only)."""
    b, h, l, dk = q.shape
    if k.shape != q.shape or v.shape != q.shape:
        raise ValueError(f"{name}: q, k, v shapes differ")
    if mask.shape != (b, l) or mask.dtype != torch.bool:
        raise ValueError(f"{name}: mask must be bool [{b}, {l}]")
    if tuple(bias.shape) != bias_shape:
        raise ValueError(
            f"{name}: bias is {tuple(bias.shape)}, expected {bias_shape}"
        )
    devices = {a.device for a in (q, k, v, mask, bias)}
    if len(devices) != 1:
        raise ValueError(f"{name}: inputs on several devices: {devices}")
    if q.device.type == "cpu":
        return
    for arg, a in (("q", q), ("k", k), ("v", v)):
        if a.dtype != torch.bfloat16:
            raise TypeError(f"{name} takes bf16; {arg} is {a.dtype}")
    if bias.dtype != torch.float32:
        raise TypeError(f"{name}: bias must be fp32, is {bias.dtype}")
    for arg, a in (("q", q), ("k", k), ("v", v), ("mask", mask), ("bias", bias)):
        if not a.is_contiguous():
            raise ValueError(f"{name} needs contiguous inputs; {arg} is not")
    if dk != KERNEL_DK:
        raise ValueError(f"{name} is built for d_kv {KERNEL_DK}, got {dk}")
