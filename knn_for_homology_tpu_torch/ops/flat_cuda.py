"""Kernel A: fused distance + exact small-k top-k (csrc/flat_topk.cu).

Port of knn_for_homology_tpu/ops/flat_pallas.py:pallas_flat_topk. A CUDA
tensor goes to the kernel; a CPU tensor to the plain version, which is
ops/topk.py's `plain_topk` (the same function in plain PyTorch).
"""

from typing import Tuple

import torch

from . import _build
from .distance import check_search_inputs
from .topk import NEG_INF, pad_k, plain_topk

MAX_KERNEL_K = 32


def flat_topk_plain(
    db: torch.Tensor, queries: torch.Tensor, k: int, metric: str = "cosine"
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain PyTorch version of the kernel: (sims [Q, k], ids [Q, k] int32),
    value descending, lower id first on ties, (-inf, -1) past N."""
    return plain_topk(db, queries, k, metric=metric)


def flat_topk_kernel(
    db: torch.Tensor, queries: torch.Tensor, k: int, metric: str = "cosine"
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Exact top-k (k ≤ MAX_KERNEL_K) of every query against the whole
    database, internal bigger-is-better convention (cosine inputs must be
    normalised). Returns (sims [Q, k] f32, ids [Q, k] int32)."""
    if k > MAX_KERNEL_K:
        raise ValueError(f"flat_topk_kernel handles k ≤ {MAX_KERNEL_K}, got {k}")
    check_search_inputs(db, queries, metric)
    if db.device.type == "cpu":
        return flat_topk_plain(db, queries, k, metric)
    n, d = db.shape
    q_n = queries.shape[0]
    dev = db.device
    if q_n == 0 or n == 0:
        return (
            torch.full((q_n, k), NEG_INF, device=dev),
            torch.full((q_n, k), -1, dtype=torch.int32, device=dev),
        )
    k_eff = min(k, n)
    # enough (query tile, db split) blocks to give every SM a few
    q_tiles = -(-q_n // 64)
    n_tiles = -(-n // 64)
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    splits = max(1, min(n_tiles, -(-4 * sms // q_tiles)))
    part_v = torch.empty((q_n, splits, k_eff), dtype=torch.float32, device=dev)
    part_i = torch.empty((q_n, splits, k_eff), dtype=torch.int32, device=dev)
    vals = torch.empty((q_n, k_eff), dtype=torch.float32, device=dev)
    ids = torch.empty((q_n, k_eff), dtype=torch.int32, device=dev)
    lib = _build.library()
    code = lib.knn_flat_topk(
        queries.data_ptr(), db.data_ptr(), vals.data_ptr(), ids.data_ptr(),
        part_v.data_ptr(), part_i.data_ptr(), q_n, n, d, k_eff, splits,
        int(metric == "l2"), _build.stream_ptr(dev),
    )
    _build.check(code, "knn_flat_topk")
    flat_topk_kernel.launches += 1
    return pad_k(vals, ids, k)


flat_topk_kernel.launches = 0
