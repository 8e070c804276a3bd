"""Fused T5 FFN block, plain version (port of
knn_for_homology_tpu/ops/ffn_pallas.py:fused_ffn_t5).

    out = x + relu(rms_norm(x, ln) · wi) · wo

with the Pallas kernel's roundings: normed = bf16(bf16(x32·rsqrt(mean(x32²)
+ eps)) · ln), h = bf16(relu(normed · wi)) from fp32 sums, the second
product summed in fp32 and added to x32 before the one cast to x's dtype.
This version materialises the [T, d_ff] intermediate; kernel G
(csrc/ffn_fused.cu, wrapper ops/ffn_cuda.py) never writes it.
"""

import torch


def fused_ffn_plain(
    x: torch.Tensor,  # [T, D]
    ln_scale: torch.Tensor,  # [D]
    wi: torch.Tensor,  # [D, F]
    wo: torch.Tensor,  # [F, D]
    eps: float = 1e-6,
) -> torch.Tensor:
    x32 = x.float()
    var = x32.square().mean(dim=-1, keepdim=True)
    normed = (x32 * torch.rsqrt(var + eps)).to(x.dtype) * ln_scale.to(x.dtype)
    # bf16 products are exact in fp32, so fp32 matmuls of the upcast
    # operands are the kernel's products with fp32 accumulation
    h = torch.relu(torch.matmul(normed.float(), wi.float())).to(x.dtype)
    return (x32 + torch.matmul(h.float(), wo.float())).to(x.dtype)
