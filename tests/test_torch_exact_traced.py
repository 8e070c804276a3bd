"""The n_valid row bound of kernels B, D, E, F (their plain versions, on
the CPU) and kernel B's traced entry (ops/exact_cuda.py:exact_topk_traced)
against the JAX package, whose Pallas kernels run in interpret mode.

Rows ≥ n_valid (a shard's pad rows) never enter a slot, while the plan —
W, R and the packed pass bits — stays that of all N rows, as the
reference plans it; so the candidate sets, not only the final ids, match
the reference's.

Tolerances: exact modes — ids equal, values within rtol 1e-6 (fp32 sums in
another order). Packed modes on grid data (entries k/8, every fp32 sum
exact) and on the int8 storages — ids equal, values within the packed
truncation (2^jbits float32 ulps of the largest value, as in
tests/test_torch_packed.py); sq8-sym bit-equal."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from knn_for_homology_tpu.ops import exact_pallas as jexact
from knn_for_homology_tpu_torch.ops import exact_cuda, packed_cuda


def _grid(seed, n, q, d):
    rng = np.random.RandomState(seed)
    return ((rng.randint(-8, 9, size=(n, d)) / 8.0).astype(np.float32),
            (rng.randint(-8, 9, size=(q, d)) / 8.0).astype(np.float32))


def _gauss(seed, n, q, d):
    rng = np.random.RandomState(seed)
    return (rng.randn(n, d).astype(np.float32),
            rng.randn(q, d).astype(np.float32))


def _t(x):
    return torch.from_numpy(np.array(x))


def _packed_tol(vals, n, w):
    finite = np.isfinite(vals)
    top = np.abs(vals[finite]).max() if finite.any() else 0.0
    return top * 2.0 ** (packed_cuda.pass_bits(n, w) - 23)


@pytest.mark.parametrize("metric", ["ip", "l2"])
@pytest.mark.parametrize("n_valid", [0, 300, 599, 640])
def test_candidates_with_n_valid_equal_jax(metric, n_valid):
    # the kernel's candidate set + epilogue: vals, ids and the certificate
    db, qs = _gauss(0, 640, 20, 64)
    w, r, k = 128, 4, 40
    want = jexact._candidates_and_topk(
        jnp.asarray(db), jnp.asarray(qs), k, r, metric, w, 8, True, True,
        jnp.int32(n_valid))
    got = exact_cuda.candidates_and_topk(_t(db), _t(qs), k, r, metric, w,
                                         n_valid)
    np.testing.assert_array_equal(got[1].numpy(), np.asarray(want[1]))
    np.testing.assert_allclose(got[0].numpy(), np.asarray(want[0]),
                               rtol=1e-6, atol=1e-6)
    np.testing.assert_array_equal(got[2].numpy(), np.asarray(want[2]))


@pytest.mark.parametrize("n_valid", [0, 500, 1000])
def test_packed_candidates_with_n_valid_equal_jax(n_valid):
    db, qs = _grid(1, 1000, 24, 64)
    w, r, k = 128, 3, 30
    jbits = packed_cuda.pass_bits(1000, w)
    want = jexact._packed_candidates_topk(
        jnp.asarray(db), jnp.asarray(qs), k, r, "ip", w, 8, True, True,
        jnp.int32(n_valid))
    buf = packed_cuda.segment_packed_plain(_t(qs), _t(db), w, r, "ip",
                                           n_valid=n_valid)
    got = packed_cuda.decode_packed(buf, k, w, jbits)
    np.testing.assert_array_equal(got[1].numpy(), np.asarray(want[1]))
    np.testing.assert_array_equal(got[0].numpy(), np.asarray(want[0]))
    assert int(got[1].max()) < max(n_valid, 1)


@pytest.mark.parametrize("metric", ["ip", "cosine", "l2"])
@pytest.mark.parametrize("n_valid", [None, 500])
def test_exact_topk_traced_equals_jax(metric, n_valid):
    db, qs = _gauss(3, 640, 16, 128)
    k = 40
    nv = None if n_valid is None else jnp.int32(n_valid)
    want = jax.jit(lambda a, b, m: jexact.exact_pallas_topk_traced(
        a, b, k, metric=metric, n_valid=m, interpret=True,
        highest_precision=True))(jnp.asarray(db), jnp.asarray(qs), nv)
    got = exact_cuda.exact_topk_traced(_t(db), _t(qs), k, metric=metric,
                                       n_valid=n_valid)
    np.testing.assert_array_equal(got[1].numpy(), np.asarray(want[1]))
    np.testing.assert_allclose(got[0].numpy(), np.asarray(want[0]),
                               rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("n,k", [(640, 40), (131072, 1000), (5000, 300)])
def test_traced_plan_equals_jax(n, k):
    # the traced entry's stricter slot default (1e-6 a row): the same W, R
    w0 = exact_cuda.default_db_tile(k)
    want = jexact._plan(n, 128, k, w0, 512, None, True, 0.95, 4,
                        exact_row_target=1e-6)
    assert exact_cuda.plan(n, k, w0, exact_row_target=1e-6) == (want[0],
                                                                 want[2])


def test_exact_topk_traced_fallback_recomputes_the_block():
    # ten planted winners all in segment 0 (more than R slots): every row
    # is suspect. The reference recomputes the whole block; the port
    # re-runs each suspect row (2R, then a full sort): the same ids
    rng = np.random.RandomState(4)
    n, d, k, tile = 10240, 128, 10, 1024
    db = rng.randn(n, d).astype(np.float32) * 0.01
    probe = rng.randn(d).astype(np.float32)
    probe /= np.linalg.norm(probe)
    for rank, row in enumerate(range(0, n, tile)):
        db[row] = probe * (20.0 - rank)
    q = probe[None, :].repeat(8, axis=0)
    want = jax.jit(lambda a, b: jexact.exact_pallas_topk_traced(
        a, b, k, metric="ip", db_tile=tile, interpret=True,
        highest_precision=True))(jnp.asarray(db), jnp.asarray(q))
    _, _, suspect = exact_cuda.candidates_and_topk(
        _t(db), _t(q), k, exact_cuda.plan(n, k, tile, None, 1e-6)[1], "ip",
        tile)
    assert bool(suspect.all())
    got = exact_cuda.exact_topk_traced(_t(db), _t(q), k, metric="ip",
                                       db_tile=tile)
    np.testing.assert_array_equal(got[1].numpy(), np.asarray(want[1]))
    np.testing.assert_allclose(got[0].numpy(), np.asarray(want[0]),
                               rtol=1e-6)


@pytest.mark.parametrize("n_valid", [None, 700])
def test_exact_topk_traced_approx_goes_packed(n_valid):
    db, qs = _grid(5, 1000, 24, 128)
    k = 48
    nv = None if n_valid is None else jnp.int32(n_valid)
    want = jax.jit(lambda a, b, m: jexact.exact_pallas_topk_traced(
        a, b, k, metric="ip", n_valid=m, exact=False, interpret=True,
        highest_precision=True))(jnp.asarray(db), jnp.asarray(qs), nv)
    got = exact_cuda.exact_topk_traced(_t(db), _t(qs), k, metric="ip",
                                       n_valid=n_valid, exact=False)
    np.testing.assert_array_equal(got[1].numpy(), np.asarray(want[1]))
    np.testing.assert_allclose(got[0].numpy(), np.asarray(want[0]), rtol=0,
                               atol=_packed_tol(np.asarray(want[0]), 1000,
                                                256))


@pytest.mark.parametrize("metric", ["ip", "l2"])
def test_exact_topk_with_n_valid_equals_jax(metric):
    # the host entry with n_valid: the same ids as the reference's traced
    # entry (the reference's host entry takes no n_valid)
    db, qs = _gauss(6, 900, 12, 64)
    want = jax.jit(lambda a, b: jexact.exact_pallas_topk_traced(
        a, b, 100, metric=metric, n_valid=jnp.int32(611), interpret=True,
        highest_precision=True))(jnp.asarray(db), jnp.asarray(qs))
    got = exact_cuda.exact_topk(_t(db), _t(qs), 100, metric=metric,
                                n_valid=611)
    np.testing.assert_array_equal(got[1].numpy(), np.asarray(want[1]))
    np.testing.assert_allclose(got[0].numpy(), np.asarray(want[0]),
                               rtol=1e-6, atol=1e-6)
    assert int(got[1].max()) < 611


@pytest.mark.parametrize("storage,metric", [
    ("native", "ip"), ("native", "l2"), ("sq8", "ip"), ("sq8-sym", "ip"),
    ("sq8-sym2", "ip")])
@pytest.mark.parametrize("n_valid", [0, 333, 1000])
def test_packed_topk_with_n_valid_equals_jax(storage, metric, n_valid):
    db, qs = _grid(7, 1000, 20, 64)
    k = 40
    want = jexact.packed_pallas_topk(
        jnp.asarray(db), jnp.asarray(qs), k, metric=metric,
        n_valid=jnp.int32(n_valid), storage=storage, interpret=True)
    got = packed_cuda.packed_topk(_t(db), _t(qs), k, metric=metric,
                                  storage=storage, n_valid=n_valid)
    wv, wi = np.asarray(want[0]), np.asarray(want[1])
    np.testing.assert_array_equal(got[1].numpy(), wi)
    if storage == "sq8-sym":
        np.testing.assert_array_equal(got[0].numpy(), wv)
    else:
        np.testing.assert_allclose(got[0].numpy(), wv, rtol=1e-5,
                                   atol=_packed_tol(wv, 1000, 256))
    assert (got[1].numpy() < max(n_valid, 1)).all()
