"""Sharded exact search over a device mesh (port of
knn_for_homology_tpu/parallel/sharded.py).

Two SPMD layouts; every rank of the mesh calls the function with the same
replicated arguments and gets the whole result back:

  * db-sharded    — database rows split over the mesh's data axis,
                    queries replicated. Each rank runs the local top-k on
                    its shard, the [Q, k] winner sets with global ids are
                    all-gathered and merged with one selection.
                    Communication is O(k·Q), independent of the database.
  * query-sharded — queries split over the data axis, database replicated;
                    the per-rank results are all-gathered.

Both give the global row ids of the single-device search. The merge keeps
the reference's order, value descending and the lower id first on ties:
each shard's list is in that order already, the gathered lists are
concatenated shard by shard (ascending ids), and one stable descending
sort picks the k best.

The shard-local route is chosen by the tensors' device (the reference
probed its TPU compiler for it, `KNN_TPU_SHARDED_PALLAS`, which the port
does not carry): the sq8 storages go to the packed kernels E / F, exact
and approx k > 32 with d % 128 == 0 to kernel B's traced entry
(`exact_topk_traced`, the packed kernels for approx), the rest to the
one-shot or streaming plain top-k. The kernels run on CUDA tensors and
their plain versions on CPU ones; each takes the shard's `n_valid`, so a
shard's pad rows never win and the plan (W, R, pass bits) stays that of
the padded shard, as the reference plans it.
"""

from typing import Tuple

import torch

from ..ops.distance import pad_rows
from ..ops.topk import (
    NEG_INF,
    ONESHOT_SIM_BYTES,
    oneshot_topk,
    pad_k,
    stable_topk,
    streaming_topk,
)
from .mesh import DATA_AXIS, all_gather


def _local_topk(db_shard, q, k, metric, db_tile, approx, n_valid=None,
                storage="native", recall_target=0.95):
    """One shard's top-k (the route rule of the module docstring).
    `n_valid` masks this shard's pad rows before selection: a pad row's
    0-vector can outscore real rows (negative cosines; l2 distance to the
    origin). The sq8 storages plan for `recall_target`."""
    if storage != "native":
        if not approx:
            raise ValueError("sq8 storage is approx-only (no certificate)")
        from ..ops.packed_cuda import packed_topk

        return packed_topk(db_shard, q, k, metric=metric, storage=storage,
                           n_valid=n_valid, recall_target=recall_target)
    if k > 32 and db_shard.shape[1] % 128 == 0:
        from ..ops.exact_cuda import exact_topk_traced

        return exact_topk_traced(db_shard, q, k, metric=metric,
                                 n_valid=n_valid, exact=not approx)
    if q.shape[0] * db_shard.shape[0] * 4 <= ONESHOT_SIM_BYTES:
        return oneshot_topk(db_shard, q, k, metric=metric, n_valid=n_valid)
    return streaming_topk(db_shard, q, k, metric=metric, db_tile=db_tile,
                          n_valid=n_valid)


def merge_shards(vals, ids, row0: int, n: int, k: int, group
                 ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Merge per-shard winner sets: local ids → global (id + row0), ids ≥ n
    (pad rows) and missing hits → (-inf, -1), one all_gather over `group`
    and a stable descending selection of min(k, candidates) columns (the
    caller pads to k). Bigger-is-better values."""
    ids = ids.to(torch.int64)
    gids = torch.where(ids >= 0, ids + row0, -1)
    valid = (gids >= 0) & (gids < n)
    vals = torch.where(valid, vals, NEG_INF)
    gids = torch.where(valid, gids, -1).to(torch.int32)
    q_n = vals.shape[0]
    all_vals = all_gather(vals, group)  # [S, Q, k_local]
    all_ids = all_gather(gids, group)
    cand_vals = all_vals.transpose(0, 1).reshape(q_n, -1)
    cand_ids = all_ids.transpose(0, 1).reshape(q_n, -1)
    top, sel = stable_topk(cand_vals, min(k, cand_vals.shape[1]))
    return top, torch.gather(cand_ids, 1, sel)


def db_sharded_topk(
    db: torch.Tensor,
    queries: torch.Tensor,
    k: int,
    mesh,
    metric: str = "cosine",
    db_tile: int = 8192,
    approx: bool = False,
    n_valid: int = None,
    storage: str = "native",
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Top-k with the database sharded over the mesh's data axis.

    db [N, d] (padded to a multiple of the axis size; pad rows lose with
    -inf), queries [Q, d] replicated. Returns global (sims [Q, k] desc,
    ids [Q, k] int32) equal to the single-device result, on every rank.
    Pass `n_valid` when db arrives pre-padded (rows ≥ n_valid never win).
    """
    n = n_valid if n_valid is not None else db.shape[0]
    n_shards = mesh.size(mesh.mesh_dim_names.index(DATA_AXIS))
    db_p = pad_rows(db, n_shards)
    rows = db_p.shape[0] // n_shards
    s = mesh.get_local_rank(DATA_AXIS)
    return shard_topk(
        db_p[s * rows : (s + 1) * rows], queries, k, s, n,
        mesh.get_group(DATA_AXIS), metric=metric, db_tile=db_tile,
        approx=approx, storage=storage,
    )


def shard_topk(shard, queries, k: int, s: int, n: int, group,
               metric="cosine", db_tile=8192, approx=False,
               storage="native", recall_target=0.95
               ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The db-sharded search from one rank's side: `shard` holds rows
    [s·rows, (s+1)·rows) of a database of `n` real rows (the rest pad),
    and the winner sets merge over `group`. k > n pads FAISS-style. An
    sq8 storage's shard may come quantised once (an `SQ8Database`), so
    that repeated searches skip its quantisation."""
    from ..ops.packed_cuda import SQ8Database

    rows = shard.n if isinstance(shard, SQ8Database) else shard.shape[0]
    row0 = s * rows
    n_local = min(max(n - row0, 0), rows)
    vals, ids = _local_topk(
        shard, queries, min(k, rows), metric, min(db_tile, rows), approx,
        n_valid=n_local, storage=storage, recall_target=recall_target,
    )
    return pad_k(*merge_shards(vals, ids, row0, n, k, group), k)


def shard_topk_to_host(shard, queries, k: int, s: int, n: int, group,
                       dst: int = 0, **kw):
    """shard_topk from one rank's side, with the merged (scores, ids)
    delivered to the host of shard `dst` as numpy arrays (None on the
    other ranks): on a CUDA device one copy each into page-locked memory
    of this call, queued behind the merge, then one wait."""
    vals, ids = shard_topk(shard, queries, k, s, n, group, **kw)
    if s != dst:
        return None
    if vals.device.type != "cuda":
        return vals.numpy(), ids.numpy()
    host = [torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
            for t in (vals, ids)]
    for h, t in zip(host, (vals, ids)):
        h.copy_(t, non_blocking=True)
    torch.cuda.current_stream(vals.device).synchronize()
    return host[0].numpy(), host[1].numpy()


def query_sharded_topk(
    db: torch.Tensor,
    queries: torch.Tensor,
    k: int,
    mesh,
    metric: str = "cosine",
    db_tile: int = 8192,
    approx: bool = False,
    storage: str = "native",
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Top-k with queries sharded, database replicated. Q is padded to the
    axis size; padded query rows are dropped before returning."""
    q_n = queries.shape[0]
    n_shards = mesh.size(mesh.mesh_dim_names.index(DATA_AXIS))
    q_p = pad_rows(queries, n_shards)
    rows = q_p.shape[0] // n_shards
    s = mesh.get_local_rank(DATA_AXIS)
    vals, ids = _local_topk(db, q_p[s * rows : (s + 1) * rows], k, metric,
                            db_tile, approx, storage=storage)
    group = mesh.get_group(DATA_AXIS)
    vals = all_gather(vals, group).reshape(-1, vals.shape[1])
    ids = all_gather(ids.to(torch.int32), group).reshape(-1, ids.shape[1])
    return vals[:q_n], ids[:q_n]


def sharded_search(db, queries, k: int, mesh, metric: str = "cosine",
                   layout: str = "auto", **kw):
    """Pick a layout: shard whichever side is large. Returns (sims, ids)."""
    if layout == "auto":
        layout = "db" if db.shape[0] >= queries.shape[0] else "query"
    fn = db_sharded_topk if layout == "db" else query_sharded_topk
    return fn(torch.as_tensor(db), torch.as_tensor(queries), k, mesh,
              metric=metric, **kw)
