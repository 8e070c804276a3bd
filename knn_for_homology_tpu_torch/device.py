"""Explicit device selection: "cuda" means the card or an error."""

import torch


def resolve_device(name="cuda") -> torch.device:
    """torch.device for `name` ("cuda", "cuda:N", "cpu" or a torch.device).
    Raises when CUDA is asked for and absent — no silent CPU fallback."""
    device = torch.device(name)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"device {name!r} requested but torch.cuda.is_available() is False"
        )
    if device.type not in ("cuda", "cpu"):
        raise ValueError(f"unsupported device {name!r}")
    return device
