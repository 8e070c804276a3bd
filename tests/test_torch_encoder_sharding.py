"""The port's tensor- and data-parallel ProtT5 encoder
(parallel/encoder_sharding.py) on four gloo ranks of the CPU, a 2 x 2
(data, model) mesh, against the JAX package's `encode_sharded` on four
devices of the conftest's virtual mesh, on the same numpy weights (TINY,
fp32) and tokens.

Each model rank holds half the heads and half of d_ff; each block's
partial sums meet in one fp32 all_reduce and x is added once (the port's
kernel G runs its plain version here, residual flag off). Tolerance: 1e-5
(fp32 sums in other orders: the two halves of every block are summed
apart, and the JAX side's XLA fuses its own way), the bound
tests/test_torch_t5.py holds the unsharded encoders to."""

import dataclasses
import sys

import numpy as np
import pytest
import torch

from knn_for_homology_tpu_torch.models import t5 as tt5
from knn_for_homology_tpu_torch.models.convert import params_to_torch
from knn_for_homology_tpu_torch.parallel import DATA_AXIS, MODEL_AXIS, make_mesh
from knn_for_homology_tpu_torch.parallel.encoder_sharding import (
    encode_sharded,
    shard_t5_params,
    t5_param_specs,
)
from knn_for_homology_tpu_torch.parallel.mesh import spawn

RANKS = 4
TOL = 1e-5
# (length, fields of both configs, the JAX config's route flags): dense
# attention + the fused FFN on both sides; flash attention (L >
# blockwise_above) on both sides, held to the JAX package's flash kernel
# and dense MLP (the port has one FFN, kernel G's plain version here)
ROUTES = {
    "dense_fused": (24, {}, {}),
    "flash_mlp": (40, {"blockwise_above": 16, "attention_chunk": 16},
                  {"use_flash_kernel": True, "use_fused_ffn": False}),
}


def _inputs(length):
    rng = np.random.RandomState(length)
    ids = rng.randint(3, 24, size=(6, length)).astype(np.int32)
    mask = np.ones((6, length), dtype=bool)
    mask[1, length // 2 :] = False
    mask[4, length - 3 :] = False
    return ids, mask


def _rank_encode(params_np):
    mesh = make_mesh(RANKS, axis_names=(DATA_AXIS, MODEL_AXIS), shape=(2, 2))
    full = params_to_torch(params_np, "cpu", torch.float32)
    local = shard_t5_params(full, mesh)
    out = {"shapes": {k: tuple(v.shape) for k, v in
                      local["layers"][0]["attn"].items()}
                     | {k: tuple(v.shape) for k, v in
                        local["layers"][0]["mlp"].items()}
                     | {"rel": tuple(local["rel_embedding"].shape)}}
    for name, (length, shared, _) in ROUTES.items():
        config = dataclasses.replace(tt5.TINY, dtype=torch.float32, **shared)
        ids, mask = (torch.from_numpy(a) for a in _inputs(length))
        out[name] = (encode_sharded(local, ids, mask, config, mesh).numpy(),
                     tt5.encode(full, ids, mask, config).numpy())
    out["jax_modules"] = sorted(
        m for m in sys.modules
        if m.split(".")[0] in ("jax", "knn_for_homology_tpu"))
    return out


@pytest.fixture(scope="module")
def jax_params():
    import jax
    import jax.numpy as jnp

    from knn_for_homology_tpu.models import t5 as jt5

    config = dataclasses.replace(jt5.TINY, dtype=jnp.float32)
    return jax.tree.map(np.asarray, jt5.init_params(config, seed=0))


@pytest.fixture(scope="module")
def ranks(jax_params):
    return spawn(_rank_encode, RANKS, device="cpu", args=(jax_params,))


def test_ranks_agree_and_import_no_jax(ranks):
    for rank in ranks:
        assert rank["jax_modules"] == []
        for name in ROUTES:  # every rank returns the whole batch
            np.testing.assert_array_equal(rank[name][0], ranks[0][name][0])


def test_model_ranks_hold_half_the_heads_and_d_ff(ranks):
    # TINY: 4 heads x 16, d_model 64, d_ff 128, 32 buckets
    assert ranks[0]["shapes"] == {
        "ln": (64,), "q": (64, 32), "k": (64, 32), "v": (64, 32),
        "o": (32, 64), "wi": (64, 64), "wo": (64, 64), "rel": (32, 2)}


@pytest.mark.parametrize("route", list(ROUTES))
def test_encode_sharded_equals_jax(ranks, jax_params, route):
    import jax.numpy as jnp

    from knn_for_homology_tpu.models import t5 as jt5
    from knn_for_homology_tpu.parallel import make_mesh as jmesh
    from knn_for_homology_tpu.parallel.encoder_sharding import (
        encode_sharded as jencode,
        shard_t5_params as jshard,
    )

    length, shared, jax_flags = ROUTES[route]
    config = dataclasses.replace(jt5.TINY, dtype=jnp.float32, **shared,
                                 **jax_flags)
    mesh = jmesh(RANKS, axis_names=("data", "model"), shape=(2, 2))
    ids, mask = _inputs(length)
    want = np.asarray(jencode(jshard(jax_params, mesh), jnp.asarray(ids),
                              jnp.asarray(mask), config, mesh))
    got, unsharded = ranks[0][route]
    assert got.shape == want.shape
    assert np.abs(got - want).max() <= TOL
    assert np.abs(got - unsharded).max() <= TOL


def test_param_specs_follow_the_megatron_split(jax_params):
    specs = t5_param_specs(jax_params)
    attn, mlp = specs["layers"][0]["attn"], specs["layers"][0]["mlp"]
    assert attn["q"] == attn["k"] == attn["v"] == (None, MODEL_AXIS)
    assert attn["o"] == mlp["wo"] == (MODEL_AXIS, None)
    assert mlp["wi"] == (None, MODEL_AXIS)
    assert specs["embedding"] == specs["final_ln"] == attn["ln"] == ()
    assert len(specs["layers"]) == len(jax_params["layers"])
