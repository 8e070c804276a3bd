"""The port's sharded search (parallel/sharded.py) on four gloo ranks of
the CPU against the JAX package's on four devices of the conftest's
8-device virtual mesh (`make_mesh(4)`), the calls of tests/test_sharded.py.

One world of four ranks (parallel/mesh.py:spawn) runs every case once for
the module; the ranks are children that import this file, so it imports
jax only inside the tests (the children report any jax module they hold).

Tolerances: exact modes — ids equal, values within 1e-6 (the shard-local
products sum in another order). The kernel route at k > 32, d % 128 == 0
is held to the reference's Pallas route (KNN_TPU_SHARDED_PALLAS=always,
interpret mode): exact — ids equal; approx on grid data (entries k/8,
every fp32 sum exact) — ids equal, values within the packed truncation;
sq8-sym — ids and values equal (int8 dots are exact, the per-shard plan is
the reference's); sq8 — ids equal, values within rtol 1e-5."""

import sys

import numpy as np
import pytest
import torch

from knn_for_homology_tpu_torch.parallel import (
    db_sharded_topk,
    make_mesh,
    query_sharded_topk,
    sharded_search,
)
from knn_for_homology_tpu_torch.parallel.mesh import spawn

RANKS = 4


def _normed(x):
    return (x / np.linalg.norm(x, axis=1, keepdims=True)).astype(np.float32)


def _cases():
    """name -> (layout, db, queries, k, kwargs), as tests/test_sharded.py
    builds them."""
    cases = {}
    for metric in ("cosine", "ip", "l2"):
        rng = np.random.RandomState(11)
        db = rng.randn(530, 64).astype(np.float32)
        q = rng.randn(37, 64).astype(np.float32)
        if metric == "cosine":
            db, q = _normed(db), _normed(q)
        cases[f"db_{metric}"] = ("db", db, q, 13, dict(metric=metric))
    rng = np.random.RandomState(12)
    cases["query"] = ("query", rng.randn(200, 32).astype(np.float32),
                      rng.randn(99, 32).astype(np.float32), 7,
                      dict(metric="ip"))
    rng = np.random.RandomState(13)
    cases["uneven"] = ("db", rng.randn(101, 16).astype(np.float32),
                       rng.randn(9, 16).astype(np.float32), 5,
                       dict(metric="ip"))
    rng = np.random.RandomState(14)
    cases["k_beyond_n"] = ("db", rng.randn(20, 8).astype(np.float32),
                           rng.randn(3, 8).astype(np.float32), 50,
                           dict(metric="ip"))
    rng = np.random.RandomState(21)
    db, q = _normed(rng.randn(530, 128)), _normed(rng.randn(24, 128))
    cases["route_exact"] = ("db", db, q, 48, dict(metric="ip"))
    rng = np.random.RandomState(21)
    grid = lambda *s: (rng.randint(-8, 9, size=s) / 8.0).astype(  # noqa: E731
        np.float32)
    cases["route_approx"] = ("db", grid(530, 128), grid(24, 128), 48,
                             dict(metric="ip", approx=True))
    rng = np.random.RandomState(21)
    db = _normed(rng.randn(1030, 128))
    for storage in ("sq8", "sq8-sym"):
        cases[f"db_{storage}"] = ("db", db, db[:64], 40, dict(
            metric="ip", approx=True, storage=storage))
    rng = np.random.RandomState(22)
    db = _normed(rng.randn(512, 128))
    cases["query_sq8-sym"] = ("query", db, db[:48], 20, dict(
        metric="ip", approx=True, storage="sq8-sym"))
    rng = np.random.RandomState(23)
    cases["auto"] = ("auto", rng.randn(50, 16).astype(np.float32),
                     rng.randn(80, 16).astype(np.float32), 6,
                     dict(metric="ip"))
    return cases


def _rank_cases(cases):
    """Every case on this rank (run in the spawned children)."""
    mesh = make_mesh(RANKS)
    out = {}
    for name, (layout, db, q, k, kw) in cases.items():
        db, q = torch.from_numpy(db), torch.from_numpy(q)
        if layout == "db":
            sims, ids = db_sharded_topk(db, q, k, mesh, **kw)
        elif layout == "query":
            sims, ids = query_sharded_topk(db, q, k, mesh, **kw)
        else:
            sims, ids = sharded_search(db, q, k, mesh, **kw)
        out[name] = (sims.numpy(), ids.numpy())
    try:
        db_sharded_topk(torch.zeros(64, 128), torch.zeros(8, 128), 5, mesh,
                        approx=False, storage="sq8")
        out["reject"] = None
    except ValueError as err:
        out["reject"] = str(err)
    out["jax_modules"] = sorted(
        m for m in sys.modules
        if m.split(".")[0] in ("jax", "knn_for_homology_tpu"))
    return out


@pytest.fixture(scope="module")
def ranks():
    return spawn(_rank_cases, RANKS, device="cpu", args=(_cases(),))


@pytest.fixture(scope="module")
def jax_results():
    """The reference's results of every case on make_mesh(4)."""
    import os

    import jax.numpy as jnp

    from knn_for_homology_tpu.parallel import (
        db_sharded_topk as jdb,
        make_mesh as jmesh,
        query_sharded_topk as jquery,
        sharded_search as jsearch,
    )

    mesh = jmesh(RANKS)
    fns = {"db": jdb, "query": jquery}
    before = os.environ.get("KNN_TPU_SHARDED_PALLAS")
    os.environ["KNN_TPU_SHARDED_PALLAS"] = "always"  # the kernel route
    try:
        out = {}
        for name, (layout, db, q, k, kw) in _cases().items():
            if layout == "auto":
                res = jsearch(db, q, k, mesh, **kw)
            else:
                res = fns[layout](jnp.asarray(db), jnp.asarray(q), k, mesh,
                                  **kw)
            out[name] = tuple(np.asarray(a) for a in res)
        return out
    finally:
        if before is None:
            os.environ.pop("KNN_TPU_SHARDED_PALLAS")
        else:
            os.environ["KNN_TPU_SHARDED_PALLAS"] = before


def test_ranks_agree_and_import_no_jax(ranks):
    for rank in ranks:
        assert rank["jax_modules"] == []
    for name in _cases():
        for rank in ranks[1:]:
            np.testing.assert_array_equal(rank[name][1], ranks[0][name][1])
            np.testing.assert_array_equal(rank[name][0], ranks[0][name][0])


@pytest.mark.parametrize("name", [
    "db_cosine", "db_ip", "db_l2", "query", "uneven", "k_beyond_n",
    "route_exact", "auto"])
def test_exact_layouts_equal_jax(ranks, jax_results, name):
    got_s, got_i = ranks[0][name]
    want_s, want_i = jax_results[name]
    assert got_i.shape == want_i.shape and got_i.dtype == np.int32
    np.testing.assert_array_equal(got_i, want_i)
    finite = np.isfinite(want_s)
    np.testing.assert_array_equal(np.isfinite(got_s), finite)
    np.testing.assert_allclose(got_s[finite], want_s[finite], rtol=1e-6,
                               atol=1e-6)


def test_uneven_and_k_beyond_n_keep_pad_rows_out(ranks):
    assert ranks[0]["uneven"][1].max() < 101
    ids = ranks[0]["k_beyond_n"][1]
    assert ids.shape == (3, 50) and (ids[:, 20:] == -1).all()
    for row in ids[:, :20]:
        assert sorted(row.tolist()) == list(range(20))


def test_approx_kernel_route_equals_jax(ranks, jax_results):
    got_s, got_i = ranks[0]["route_approx"]
    want_s, want_i = jax_results["route_approx"]
    np.testing.assert_array_equal(got_i, want_i)
    # packed truncation of a 133-row shard's plan: 2^jbits ulps, jbits 1
    np.testing.assert_allclose(got_s, want_s, rtol=2.0**-22, atol=0)


@pytest.mark.parametrize("name", ["db_sq8", "db_sq8-sym", "query_sq8-sym"])
def test_sq8_storages_equal_jax(ranks, jax_results, name):
    got_s, got_i = ranks[0][name]
    want_s, want_i = jax_results[name]
    np.testing.assert_array_equal(got_i, want_i)
    if name.endswith("sym"):
        np.testing.assert_array_equal(got_s, want_s)
    else:
        np.testing.assert_allclose(got_s, want_s, rtol=1e-5)
    if name.startswith("db"):
        np.testing.assert_array_equal(got_i[:, 0], np.arange(64))


def test_sq8_rejects_exact_mode(ranks):
    assert "approx-only" in ranks[0]["reject"]
