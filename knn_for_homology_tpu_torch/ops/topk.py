"""Plain PyTorch distance → top-k (port of knn_for_homology_tpu/ops/topk.py).

This is the formulation the JAX package runs off-TPU, and it is the plain
reference of both top-k kernels (ops/flat_cuda.py, ops/exact_cuda.py):

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
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Top-k against the whole database, one db tile at a time, merging
    into a carried [Q, k] winner set (the carried set holds lower ids than
    the tile, so a stable merge keeps the tie order)."""
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
        sims = similarity_block(queries, tile, metric, q_sq)
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


def flat_topk(
    db: torch.Tensor,
    queries: torch.Tensor,
    k: int,
    metric: str = "cosine",
    approx: bool = False,
    db_tile: int = 8192,
    query_block: int = 4096,
    storage: str = "native",
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Exact top-k dispatcher over native fp32 storage: blocks queries and
    picks one-shot vs streaming per block by similarity-buffer size.
    Returns (sims, ids) in the internal bigger-is-better convention."""
    if approx or storage != "native":
        raise NotImplementedError(
            "approx / sq8 selection is not ported yet (ROADMAP: packed and"
            " sq8 segment kernels)"
        )
    n = db.shape[0]
    q_n = queries.shape[0]
    if q_n == 0:
        return (
            queries.new_zeros((0, k)),
            torch.zeros((0, k), dtype=torch.int32, device=queries.device),
        )
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
