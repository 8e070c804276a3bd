"""Encoder sharding: data-parallel batches + tensor-parallel T5 weights
(port of knn_for_homology_tpu/parallel/encoder_sharding.py).

The encoder is laid out on a 2-D mesh (DATA_AXIS × MODEL_AXIS):

  * the batch splits over DATA_AXIS (each data rank encodes its rows);
  * attention heads and the d_ff intermediate split over MODEL_AXIS, the
    Megatron split: q, k, v and wi are column-parallel, o and wo
    row-parallel, and the relative-position table keeps the rank's heads,
    so each rank's [H / tp, 2L-1] offset-bias table is its slice.

Each block (attention, FFN) returns the rank's partial sum without the
residual x; one all_reduce over MODEL_AXIS (in fp32) sums the partials and
x is added once (models/t5.py:encode's `reduce`). Kernel G takes the
rank's d_ff slice with its residual flag off, kernels H / I the rank's
heads. The JAX package lets GSPMD insert the same all-reduces.
"""

import dataclasses
from typing import Any

import torch

from ..models import t5
from .mesh import DATA_AXIS, MODEL_AXIS, all_gather, all_reduce_sum


def t5_param_specs(params: Any) -> Any:
    """Per-leaf split spec, the JAX PartitionSpec pytree's counterpart: a
    tuple naming the mesh axis each dimension splits over (None: whole),
    () for a replicated leaf."""

    def layer_spec():
        return {
            "attn": {
                "ln": (),
                "q": (None, MODEL_AXIS),  # column-parallel
                "k": (None, MODEL_AXIS),
                "v": (None, MODEL_AXIS),
                "o": (MODEL_AXIS, None),  # row-parallel → all-reduce
            },
            "mlp": {
                "ln": (),
                "wi": (None, MODEL_AXIS),
                "wo": (MODEL_AXIS, None),
            },
        }

    return {
        "embedding": (),
        "rel_embedding": (None, MODEL_AXIS),  # [buckets, heads]
        "layers": [layer_spec() for _ in params["layers"]],
        "final_ln": (),
    }


def _axis(mesh, name: str):
    """(size, this rank's index) of a mesh axis; (1, 0) where absent."""
    if name not in mesh.mesh_dim_names:
        return 1, 0
    return (mesh.size(mesh.mesh_dim_names.index(name)),
            mesh.get_local_rank(name))


def shard_t5_params(params: Any, mesh) -> Any:
    """This rank's slice of every leaf along MODEL_AXIS (contiguous
    copies): heads [r·H/tp, (r+1)·H/tp) and the same block of d_ff."""
    tp, r = _axis(mesh, MODEL_AXIS)

    def cut(x, spec):
        for dim, name in enumerate(spec):
            if name == MODEL_AXIS:
                size = x.shape[dim] // tp
                x = x.narrow(dim, r * size, size)
        return x.contiguous()

    def walk(tree, spec):
        if isinstance(tree, dict):
            return {key: walk(tree[key], spec[key]) for key in tree}
        if isinstance(tree, list):
            return [walk(a, b) for a, b in zip(tree, spec)]
        return cut(tree, spec)

    return walk(params, t5_param_specs(params))


def local_config(config: t5.T5Config, mesh) -> t5.T5Config:
    """The config of one model rank: H / tp heads, d_ff / tp."""
    tp, _ = _axis(mesh, MODEL_AXIS)
    if config.num_heads % tp or config.d_ff % tp:
        raise ValueError(
            f"{config.num_heads} heads and d_ff {config.d_ff} do not split"
            f" over {tp} model ranks")
    return dataclasses.replace(config, num_heads=config.num_heads // tp,
                               d_ff=config.d_ff // tp)


@torch.no_grad()
def encode_sharded(params, token_ids: torch.Tensor, mask: torch.Tensor,
                   config: t5.T5Config, mesh) -> torch.Tensor:
    """Hidden states [B, L, d_model] of the whole batch, on every rank.
    `params` is this rank's `shard_t5_params` slice. The batch is padded to
    a multiple of the data axis (pad rows masked, dropped after the
    all_gather)."""
    tp, _ = _axis(mesh, MODEL_AXIS)
    dp, di = _axis(mesh, DATA_AXIS)
    cfg = local_config(config, mesh)
    b = token_ids.shape[0]
    rows = -(-b // dp)
    ids = torch.nn.functional.pad(token_ids, (0, 0, 0, rows * dp - b))
    keep = torch.nn.functional.pad(mask.to(torch.bool),
                                   (0, 0, 0, rows * dp - b))
    reduce = None
    if tp > 1:
        group = mesh.get_group(MODEL_AXIS)
        reduce = lambda part: all_reduce_sum(part, group)  # noqa: E731
    hidden = t5.encode(params, ids[di * rows : (di + 1) * rows],
                       keep[di * rows : (di + 1) * rows], cfg, reduce)
    if dp > 1:  # gathered in fp32: exact, and any backend takes it
        hidden = all_gather(hidden.float(), mesh.get_group(DATA_AXIS)
                            ).flatten(0, 1).to(hidden.dtype)
    return hidden[:b]
