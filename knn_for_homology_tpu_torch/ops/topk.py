"""Distance → top-k: the device router and the plain exact path (port of
knn_for_homology_tpu/ops/topk.py).

`flat_topk` is the one place that picks what serves a search. On a CUDA
tensor: exact (and approx with k ≤ 32) k ≤ 32 → kernel A (ops/flat_cuda.py),
exact k > 32 → kernel B (ops/exact_cuda.py), approx k > 32 and the sq8
storages → kernels D/E/F (ops/packed_cuda.py). On a CPU tensor the packed
route runs its plain version and the exact route runs `plain_topk`.

`plain_topk` is the formulation the JAX package runs off-TPU, and the plain
reference of kernels A and B:

  * one-shot  — one [QB, N] similarity block, one selection over the row;
  * streaming — a loop over database tiles carrying a [QB, k] winner set,
                O(QB·k) memory, for blocks too large for one-shot.

Selection order is the reference's `lax.top_k` contract: value descending,
LOWER id first on ties. `torch.topk` promises no tie order, so selection is
a stable descending sort (equal values keep their column order). If k > N
the surplus slots hold (-inf, -1), FAISS's missing-hit sentinel.
"""

from typing import Tuple

import torch

from .distance import similarity_block

NEG_INF = float("-inf")

# Largest [QB, N] fp32 similarity block the one-shot path materialises. The
# stable sort holds the block, its sorted copy and int64 indices (~4x the
# block), so 4 GiB keeps the peak near 16 GiB of the card's 80 GB, beside a
# multi-GB database.
ONESHOT_SIM_BYTES = 4 << 30

QUERY_BLOCK = 4096  # queries a block of plain_topk, unless one-shot halves it
APPROX_EXACT_K = 32  # approx searches up to this k take the exact route


def stable_topk(sims: torch.Tensor, k: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """(vals, idx) of the k largest per row; ties → lower column first."""
    vals, idx = torch.sort(sims, dim=1, descending=True, stable=True)
    return vals[:, :k], idx[:, :k]


def pad_k(vals, ids, k):
    """Pad [Q, k'] results to k columns with (-inf, -1)."""
    short = k - vals.shape[1]
    if short <= 0:
        return vals, ids
    q = vals.shape[0]
    return (
        torch.cat([vals, vals.new_full((q, short), NEG_INF)], dim=1),
        torch.cat([ids, ids.new_full((q, short), -1)], dim=1),
    )


def oneshot_topk(
    db: torch.Tensor,
    queries: torch.Tensor,
    k: int,
    metric: str = "cosine",
    n_valid: int = None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Single [Q, N] similarity block + one full-row selection. Returns
    (sims [Q, k] fp32 descending, ids [Q, k] int32). Rows ≥ n_valid are
    excluded before selection."""
    n = db.shape[0]
    k_eff = min(k, n)
    sims = similarity_block(queries, db, metric)
    if n_valid is not None and n_valid < n:
        sims[:, n_valid:] = NEG_INF
    vals, ids = stable_topk(sims, k_eff)
    return pad_k(vals, ids.to(torch.int32), k)


def streaming_topk(
    db: torch.Tensor,
    queries: torch.Tensor,
    k: int,
    metric: str = "cosine",
    db_tile: int = 8192,
    n_valid: int = None,
    sim_fn=None,  # custom (queries, tile) → bigger-is-better sims override
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Top-k against the whole database, one db tile at a time, merging
    into a carried [Q, k] winner set (the carried set holds lower ids than
    the tile, so a stable merge keeps the tie order). `sim_fn` replaces the
    metric's similarity (ops/lsh.py plugs in the ±1 sketch product)."""
    n = db.shape[0]
    q_n = queries.shape[0]
    k_eff = min(k, n)
    bound = n if n_valid is None else min(n_valid, n)
    q_sq = torch.sum(queries * queries, dim=-1) if metric == "l2" else None
    best_vals = queries.new_full((q_n, k_eff), NEG_INF)
    best_ids = torch.full(
        (q_n, k_eff), -1, dtype=torch.int32, device=queries.device
    )
    for start in range(0, n, db_tile):
        tile = db[start : start + db_tile]
        sims = (
            sim_fn(queries, tile)
            if sim_fn is not None
            else similarity_block(queries, tile, metric, q_sq)
        )
        col = torch.arange(
            start, start + tile.shape[0], dtype=torch.int32,
            device=queries.device,
        )
        sims = torch.where(col[None, :] < bound, sims, NEG_INF)
        merged_vals = torch.cat([best_vals, sims], dim=1)
        merged_ids = torch.cat([best_ids, col.expand(q_n, -1)], dim=1)
        best_vals, idx = stable_topk(merged_vals, k_eff)
        best_ids = torch.gather(merged_ids, 1, idx)
    return pad_k(best_vals, best_ids, k)


def plain_topk(
    db: torch.Tensor,
    queries: torch.Tensor,
    k: int,
    metric: str = "cosine",
    db_tile: int = 8192,
    query_block: int = QUERY_BLOCK,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Exact top-k in plain PyTorch, on either device: blocks queries and
    picks one-shot vs streaming per block by similarity-buffer size."""
    n = db.shape[0]
    q_n = queries.shape[0]
    qb = min(query_block, q_n) or 1
    while qb > 256 and qb * n * 4 > ONESHOT_SIM_BYTES:
        qb //= 2
    oneshot = qb * n * 4 <= ONESHOT_SIM_BYTES
    vals_out, ids_out = [], []
    for start in range(0, q_n, qb):
        block = queries[start : start + qb]
        if oneshot:
            vals, ids = oneshot_topk(db, block, k, metric=metric)
        else:
            vals, ids = streaming_topk(
                db, block, k, metric=metric, db_tile=db_tile
            )
        vals_out.append(vals)
        ids_out.append(ids)
    return torch.cat(vals_out, dim=0), torch.cat(ids_out, dim=0)


def flat_topk(
    db,
    queries: torch.Tensor,
    k: int,
    metric: str = "cosine",
    approx: bool = False,
    recall_target: float = 0.95,
    db_tile: int = 8192,
    query_block: int = QUERY_BLOCK,
    storage: str = "native",
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Strategy dispatcher. Returns (sims, ids) in the internal
    bigger-is-better convention.

    Routing follows the reference's accelerator route on every device:
    `storage` "sq8" / "sq8-sym" / "sq8-sym2" (approx only; `db` may be an
    `SQ8Database`, whose default storage is "sq8-sym", or "sq8" for l2) and
    `approx=True` with k > 32 go to `packed_topk` (kernels D/E/F on a CUDA
    tensor, their plain version on a CPU one). Approx with k ≤ 32 runs the
    exact path: the reference used `approx_max_k` there, which torch lacks,
    and an exact result is a valid approx one. The exact path is kernel A
    (k ≤ 32) or B (k > 32) on a CUDA tensor (both take fp32) and
    `plain_topk` on a CPU one.
    `db_tile` and `query_block` shape `plain_topk` only."""
    from .packed_cuda import SQ8Database, packed_topk

    if isinstance(db, SQ8Database):
        if storage == "native":
            storage = "sq8-sym" if metric != "l2" else "sq8"
    q_n = queries.shape[0]
    if q_n == 0:
        return (
            torch.zeros((0, k), dtype=torch.float32, device=queries.device),
            torch.zeros((0, k), dtype=torch.int32, device=queries.device),
        )
    if storage in ("sq8", "sq8-sym", "sq8-sym2"):
        if not approx:
            raise ValueError(
                "storage='sq8' is an approx-mode storage (quantised scores"
                " carry no exactness certificate)"
            )
        return packed_topk(
            db, queries, k, metric=metric, recall_target=recall_target,
            storage=storage,
        )
    if storage != "native":
        raise ValueError(f"unknown storage {storage!r}")
    if approx and k > APPROX_EXACT_K:
        return packed_topk(
            db, queries, k, metric=metric, recall_target=recall_target
        )
    if queries.device.type != "cuda":
        return plain_topk(db, queries, k, metric, db_tile, query_block)
    from .exact_cuda import exact_topk
    from .flat_cuda import MAX_KERNEL_K, flat_topk_kernel

    if k <= MAX_KERNEL_K:
        return flat_topk_kernel(db, queries, k, metric=metric)
    return exact_topk(db, queries, k, metric=metric)
