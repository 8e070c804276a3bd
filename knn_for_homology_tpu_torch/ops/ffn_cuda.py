"""Kernel G: the fused T5 FFN block (csrc/ffn_fused.cu).

Port of knn_for_homology_tpu/ops/ffn_pallas.py:_ffn_kernel (entry
fused_ffn_t5). A CUDA tensor goes to the kernel; a CPU tensor to
ops/ffn.py:fused_ffn_plain. The kernel takes bf16 (the model dtype) only.
On the card one call runs three CUDA kernels (the row norm and two wgmma
GEMMs) through two scratch tensors allocated here: normed [T, D] and the
intermediate h [T, F] in bf16 (229 MB at T = 7000, F = 16384). The launch
count is one per call.
"""

import torch

from . import _build
from .ffn import fused_ffn_plain

KERNEL_D = (128, 256, 512, 1024)  # d_model values the kernel is built for
F_SLICE = 128  # d_ff must be a multiple of the GEMMs' narrowest N tile


def fused_ffn_t5(
    x: torch.Tensor,  # [T, D]
    ln_scale: torch.Tensor,  # [D]
    wi: torch.Tensor,  # [D, F]
    wo: torch.Tensor,  # [F, D]
    eps: float = 1e-6,
) -> torch.Tensor:
    """→ x + relu(rms_norm(x, ln_scale)·wi)·wo, [T, D] in x's dtype."""
    t, d = x.shape
    f = wi.shape[1]
    if ln_scale.shape != (d,) or wi.shape != (d, f) or wo.shape != (f, d):
        raise ValueError(
            f"shapes x {tuple(x.shape)}, ln {tuple(ln_scale.shape)},"
            f" wi {tuple(wi.shape)}, wo {tuple(wo.shape)} do not chain"
        )
    devices = {a.device for a in (x, ln_scale, wi, wo)}
    if len(devices) != 1:
        raise ValueError(f"inputs on several devices: {devices}")
    if x.device.type == "cpu":
        return fused_ffn_plain(x, ln_scale, wi, wo, eps)
    for name, a in (("x", x), ("ln_scale", ln_scale), ("wi", wi), ("wo", wo)):
        if a.dtype != torch.bfloat16:
            raise TypeError(f"kernel G takes bf16; {name} is {a.dtype}")
        if not a.is_contiguous():
            raise ValueError(f"kernel G needs contiguous inputs; {name} is not")
    if d not in KERNEL_D or f % F_SLICE:
        raise ValueError(
            f"kernel G handles d_model in {KERNEL_D} and d_ff a multiple of"
            f" {F_SLICE}; got {d}, {f}"
        )
    out = torch.empty_like(x)
    if t == 0:
        return out
    normed = torch.empty_like(x)
    h = torch.empty((t, f), dtype=x.dtype, device=x.device)
    code = _build.library().knn_ffn_fused(
        x.data_ptr(), ln_scale.data_ptr(), wi.data_ptr(), wo.data_ptr(),
        normed.data_ptr(), h.data_ptr(), out.data_ptr(), t, d, f, float(eps),
        _build.stream_ptr(x.device),
    )
    _build.check(code, "knn_ffn_fused")
    fused_ffn_t5.launches += 1
    return out


fused_ffn_t5.launches = 0
