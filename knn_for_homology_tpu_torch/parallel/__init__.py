"""Sharded search, sharded indexes and the tensor-parallel encoder over
torch.distributed (port of knn_for_homology_tpu/parallel/). The JAX
package's compile probe (`pallas_probe.py`) has no counterpart: the
shard-local route is chosen by device."""

from .mesh import DATA_AXIS, MODEL_AXIS, make_mesh, replicated, row_sharded
from .scale import (
    DCN_AXIS,
    ShardedFlatIndex,
    ShardedGraphIndex,
    ShardedIVFIndex,
    ShardedLSHIndex,
    make_pod_mesh,
    stream_add,
)
from .sharded import db_sharded_topk, query_sharded_topk, sharded_search

__all__ = [
    "make_mesh",
    "DATA_AXIS",
    "MODEL_AXIS",
    "replicated",
    "row_sharded",
    "db_sharded_topk",
    "query_sharded_topk",
    "sharded_search",
    "DCN_AXIS",
    "ShardedFlatIndex",
    "ShardedGraphIndex",
    "ShardedIVFIndex",
    "ShardedLSHIndex",
    "make_pod_mesh",
    "stream_add",
]
