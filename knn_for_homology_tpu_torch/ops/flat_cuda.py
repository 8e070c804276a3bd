"""Kernel A: fused distance + exact small-k top-k (csrc/flat_topk.cu).

Port of knn_for_homology_tpu/ops/flat_pallas.py:pallas_flat_topk. A CUDA
tensor goes to the kernel; a CPU tensor to the plain version, which is
ops/topk.py's `plain_topk` (the same function in plain PyTorch).
"""

from typing import Tuple

import torch

from . import _build
from .distance import check_search_inputs
from .exact_cuda import pad_columns
from .topk import NEG_INF, pad_k, plain_topk

MAX_KERNEL_K = 32
# a block of the kernel: 128 queries x 128 db rows a step, two blocks an SM
# (csrc/flat_topk.cu)
FLAT_QUERIES, FLAT_ROWS, FLAT_BLOCKS_PER_SM = 128, 128, 2
MAX_SPLITS = 256
SPLIT_OVERHEAD = 2  # in 128-row steps


def plan_splits(q_n: int, n: int, sms: int = 132) -> int:
    """Database splits (blockIdx.y) of kernel A: the count that finishes
    soonest, with (Q / 128) x splits blocks in waves of 2 x `sms` (two
    blocks an SM), each wave as long as a split's 128-row steps plus
    SPLIT_OVERHEAD steps (the first steps' flood of winners, writing and
    merging the split's lists); the fewest splits among equals."""
    q_tiles = -(-q_n // FLAT_QUERIES)
    n_tiles = -(-n // FLAT_ROWS)
    best, best_cost = 1, None
    for splits in range(1, min(n_tiles, MAX_SPLITS) + 1):
        waves = -(-q_tiles * splits // (FLAT_BLOCKS_PER_SM * sms))
        cost = waves * (-(-n_tiles // splits) + SPLIT_OVERHEAD)
        if best_cost is None or cost < best_cost:
            best, best_cost = splits, cost
    return best


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
    normalised). Returns (sims [Q, k] f32, ids [Q, k] int32). On the card,
    a d that is not a multiple of 4 is zero-padded (`pad_columns`): a copy
    of both operands, the whole db included, on every call."""
    if k > MAX_KERNEL_K:
        raise ValueError(f"flat_topk_kernel handles k ≤ {MAX_KERNEL_K}, got {k}")
    check_search_inputs(db, queries, metric)
    if db.device.type == "cpu":
        return flat_topk_plain(db, queries, k, metric)
    n = db.shape[0]
    q_n = queries.shape[0]
    dev = db.device
    if q_n == 0 or n == 0:
        return (
            torch.full((q_n, k), NEG_INF, device=dev),
            torch.full((q_n, k), -1, dtype=torch.int32, device=dev),
        )
    k_eff = min(k, n)
    # d % 4 != 0 copies both operands, the whole db included, on every call
    # (no configuration of the repo has such a d: all are 1024)
    db, queries = pad_columns(db, queries)
    d = db.shape[1]
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    splits = plan_splits(q_n, n, sms)
    part_v = torch.empty((q_n, splits, k_eff), dtype=torch.float32, device=dev)
    part_i = torch.empty((q_n, splits, k_eff), dtype=torch.int32, device=dev)
    vals = torch.empty((q_n, k_eff), dtype=torch.float32, device=dev)
    ids = torch.empty((q_n, k_eff), dtype=torch.int32, device=dev)
    # l2: the kernel's squared row norms of the queries, then of the db
    norms = (torch.empty(q_n + n, dtype=torch.float32, device=dev)
             if metric == "l2" else None)
    code = _build.library().knn_flat_topk(
        queries.data_ptr(), db.data_ptr(),
        None if norms is None else norms.data_ptr(), vals.data_ptr(),
        ids.data_ptr(), part_v.data_ptr(), part_i.data_ptr(), q_n, n, d,
        k_eff, splits, int(metric == "l2"), _build.stream_ptr(dev),
    )
    _build.check(code, "knn_flat_topk")
    flat_topk_kernel.launches += 1
    return pad_k(vals, ids, k)


flat_topk_kernel.launches = 0
