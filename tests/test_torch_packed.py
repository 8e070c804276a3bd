"""The port's packed approx top-k (ops/packed_cuda.py: kernels D, E, F's
plain versions, the decode and packed_topk), its planner and its sq8
quantisation against the JAX package on the CPU, with the Pallas kernels
in interpret mode.

Tolerances:
  * sq8-sym / sq8-sym2: ids AND values equal. The int8 dots are exact in
    both packages, and the scales are computed alike, so every packed slot
    is the same int32.
  * native and sq8: on grid data (entries k/8, |k| ≤ 8, bf16-exact) every
    fp32 sum is exact in any order, so ids must be equal and values agree
    within rtol 1e-5 plus the packed truncation (2^jbits float32 ulps of
    the largest value): the decoded value is the similarity truncated to
    32 - jbits bits. On Gaussian data torch and XLA sum in different
    orders; a rounding difference can move a value across a truncation
    step, so ids may then differ only by swaps among values within that
    tolerance.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from knn_for_homology_tpu.ops import exact_pallas as jexact
from knn_for_homology_tpu.ops.graph_pallas import quantize_int8 as jquantize
from knn_for_homology_tpu.search import flat as jflat
from knn_for_homology_tpu_torch.ops import exact_cuda, packed_cuda
from knn_for_homology_tpu_torch.ops import topk as ttopk
from knn_for_homology_tpu_torch.search import flat as tflat

RTOL = 1e-5


def _grid(seed, n, q, d):
    rng = np.random.RandomState(seed)
    db = (rng.randint(-8, 9, size=(n, d)) / 8.0).astype(np.float32)
    qs = (rng.randint(-8, 9, size=(q, d)) / 8.0).astype(np.float32)
    return db, qs


def _gauss(seed, n, q, d):
    rng = np.random.RandomState(seed)
    return (rng.randn(n, d).astype(np.float32),
            rng.randn(q, d).astype(np.float32))


def _t(x):
    return torch.from_numpy(np.array(x))


def _tol(want_vals, n, w):
    jbits = packed_cuda.pass_bits(n, w)
    finite = np.isfinite(want_vals)
    top = np.abs(want_vals[finite]).max() if finite.any() else 0.0
    return top * 2.0 ** (jbits - 23)


def _same(got, want, n, w, exact_ids=True):
    """ids equal (or, for Gaussian data, equal up to near-tie swaps);
    values within rtol 1e-5 + the packed truncation."""
    gv, gi = (np.asarray(x) for x in got)
    wv, wi = (np.asarray(x) for x in want)
    assert gv.shape == wv.shape and gi.dtype == np.int32
    np.testing.assert_array_equal(np.isfinite(gv), np.isfinite(wv))
    atol = _tol(wv, n, w)
    np.testing.assert_allclose(gv, wv, rtol=RTOL, atol=atol)
    if exact_ids:
        np.testing.assert_array_equal(gi, wi)
        return
    for r, c in zip(*np.nonzero(gi != wi)):
        near = np.abs(wv[r] - wv[r, c]) <= atol + RTOL * abs(wv[r, c])
        assert gi[r, c] in set(wi[r][near]), (r, c)


def _jax(db, qs, k, **kw):
    return jexact.packed_pallas_topk(
        jnp.asarray(db), jnp.asarray(qs), k, interpret=True, **kw
    )


def test_quantize_matches_jax():
    db, _ = _gauss(0, 300, 1, 64)
    db[5] = 0.0  # an all-zero row takes the 1e-30 floor
    db[6, :4] = [0.5, -0.5, 1.5, 127.0]  # .5 codes round half to even
    got = packed_cuda.quantize_database(_t(db))
    want = jexact.quantize_database(jnp.asarray(db))
    np.testing.assert_array_equal(got.db_i8.numpy(), np.asarray(want.db_i8))
    np.testing.assert_array_equal(got.scales.numpy(), np.asarray(want.scales))
    assert got.n == want.n == 300
    # the form XLA compiles inside jit: codes equal, scales bit-equal too
    import jax

    q8, sc = packed_cuda.quantize_int8(_t(db), reciprocal=True)
    j8, jsc = jax.jit(jquantize)(jnp.asarray(db))
    np.testing.assert_array_equal(q8.numpy(), np.asarray(j8))
    np.testing.assert_array_equal(sc.numpy(), np.asarray(jsc))
    np.testing.assert_array_equal(q8.numpy(), got.db_i8.numpy())


@pytest.mark.parametrize("target", [0.95, 0.995])
def test_plan_matches_jax(target):
    for n in (100, 3000, 131072, 2**21):
        for k in (5, 100, 1000):
            for storage in ("native", "sq8", "sq8-sym", "sq8-sym2"):
                want = jexact.plan_fingerprint(
                    n, 1024, k, storage=storage, recall_target=target
                )
                got = exact_cuda.plan_fingerprint(
                    n, 1024, k, storage=storage, recall_target=target
                )
                key = (n, k, storage)
                assert got["db_tile"] == want["db_tile"], key
                assert got["r_slots"] == want["r_slots"], key
                assert got["storage"] == storage
                assert got["query_block"] == (
                    exact_cuda.SYM_PACKED_QUERIES
                    if storage in ("sq8-sym", "sq8-sym2")
                    else exact_cuda.SEGMENT_PACKED_QUERIES)
    for k in (5, 1000):
        want = jexact.plan_fingerprint(131072, 1024, k, exact=True)
        got = exact_cuda.plan_fingerprint(131072, 1024, k, exact=True)
        assert (got["db_tile"], got["r_slots"]) == (
            want["db_tile"], want["r_slots"]
        )
    assert exact_cuda.r_for_recall(1000, 256, 0.98) == jexact.r_for_recall(
        1000, 256, 0.98
    )


# n = 2900 is not a multiple of W = 256: the last pass is ragged
CASES = [
    # (storage, metric, dtype, k)
    ("native", "ip", "float32", 300),
    ("native", "cosine", "float32", 50),
    ("native", "l2", "float32", 300),
    ("native", "ip", "bfloat16", 300),
    ("native", "l2", "bfloat16", 50),
    ("sq8", "ip", "float32", 300),
    ("sq8", "cosine", "float32", 50),
    ("sq8", "l2", "float32", 300),
    ("sq8-sym", "ip", "float32", 300),
    ("sq8-sym", "cosine", "bfloat16", 50),
    ("sq8-sym", "l2", "float32", 50),  # falls back to the sq8 kernel
    ("sq8-sym2", "ip", "float32", 300),
    ("sq8-sym2", "cosine", "float32", 50),
]


@pytest.mark.parametrize("storage,metric,dtype,k", CASES)
def test_packed_topk_matches_pallas(storage, metric, dtype, k):
    n = 2900
    db, qs = _grid(1, n, 16, 128)
    if storage in ("sq8-sym", "sq8-sym2"):
        db, qs = _gauss(1, n, 16, 128)  # exact either way: any data
    tdt = torch.bfloat16 if dtype == "bfloat16" else torch.float32
    jdt = jnp.bfloat16 if dtype == "bfloat16" else jnp.float32
    got = packed_cuda.packed_topk(
        _t(db).to(tdt), _t(qs).to(tdt), k, metric=metric, storage=storage,
        recall_target=0.95,
    )
    want = jexact.packed_pallas_topk(
        jnp.asarray(db, jdt), jnp.asarray(qs, jdt), k, metric=metric,
        storage=storage, recall_target=0.95, interpret=True,
    )
    if storage in ("sq8-sym", "sq8-sym2") and metric != "l2":
        np.testing.assert_array_equal(got[1].numpy(), np.asarray(want[1]))
        np.testing.assert_array_equal(got[0].numpy(), np.asarray(want[0]))
    else:
        _same(got, want, n, 256)


@pytest.mark.parametrize("metric", ["ip", "l2"])
def test_prequantised_database_matches_pallas(metric):
    # default storage of an SQ8Database: sq8-sym for ip, sq8 for l2
    n = 1000
    db, qs = _gauss(2, n, 16, 128)
    got = packed_cuda.packed_topk(
        packed_cuda.quantize_database(_t(db)), _t(qs), 300, metric=metric
    )
    want = jexact.packed_pallas_topk(
        jexact.quantize_database(jnp.asarray(db)), jnp.asarray(qs), 300,
        metric=metric, interpret=True,
    )
    if metric == "ip":
        np.testing.assert_array_equal(got[1].numpy(), np.asarray(want[1]))
        np.testing.assert_array_equal(got[0].numpy(), np.asarray(want[0]))
    else:
        _same(got, want, n, 256, exact_ids=False)


@pytest.mark.parametrize("storage", ["native", "sq8", "sq8-sym2"])
def test_k_beyond_n_pads(storage):
    n = 200
    db, qs = _grid(3, n, 5, 128)
    got = packed_cuda.packed_topk(_t(db), _t(qs), 300, metric="ip",
                                  storage=storage)
    want = _jax(db, qs, 300, metric="ip", storage=storage)
    np.testing.assert_array_equal(got[1].numpy(), np.asarray(want[1]))
    assert np.all(got[1].numpy()[:, n:] == -1)
    assert np.all(np.isneginf(got[0].numpy()[:, n:]))
    _same(got, want, n, 256)


@pytest.mark.parametrize("storage", ["native", "sq8", "sq8-sym", "sq8-sym2"])
def test_packed_topk_gaussian_near_ties(storage):
    n = 2500
    db, qs = _gauss(4, n, 16, 128)
    got = packed_cuda.packed_topk(_t(db), _t(qs), 300, metric="l2"
                                  if storage == "sq8" else "ip",
                                  storage=storage)
    want = _jax(db, qs, 300, metric="l2" if storage == "sq8" else "ip",
                storage=storage)
    _same(got, want, n, 256, exact_ids=False)


@pytest.mark.parametrize("storage", ["native", "sq8-sym"])
def test_decode_tie_order_matches_pallas(storage):
    # 40 distinct integer rows repeated 6 times: copies 40 rows apart share
    # a pass at W = 128, so equal packed values sit in different lanes and
    # the decode must put the lower buffer position first (lax.top_k)
    rng = np.random.RandomState(5)
    base = rng.randint(-2, 3, size=(40, 16)).astype(np.float32)
    db = np.tile(base, (6, 1))
    qs = rng.randint(-2, 3, size=(9, 16)).astype(np.float32)
    got = packed_cuda.packed_topk(_t(db), _t(qs), 60, metric="ip",
                                  db_tile=128, storage=storage)
    want = _jax(db, qs, 60, metric="ip", db_tile=128, storage=storage)
    np.testing.assert_array_equal(got[1].numpy(), np.asarray(want[1]))
    np.testing.assert_array_equal(got[0].numpy(), np.asarray(want[0]))
    v = got[0].numpy()
    assert (v[:, 1:] == v[:, :-1]).any()


def test_segment_packed_buffer_layout():
    # slot r of lane w at column r*W + w, each lane sorted descending, the
    # kept passes are the lane's best, empty slots INT32_MIN
    db, qs = _grid(6, 200, 3, 8)
    buf = packed_cuda.segment_packed_kernel(_t(qs), _t(db), 64, 5, "ip")
    v = buf.numpy().reshape(3, 5, 64)
    assert np.all(v[:, 1:] <= v[:, :-1])
    # 200 rows over W = 64 lanes: lanes < 8 see 4 passes, the others 3
    assert np.all(v[:, 4, :] == exact_cuda.INT32_MIN)
    assert np.all(v[:, 3, 8:] == exact_cuda.INT32_MIN)
    assert np.all(v[:, 3, :8] > exact_cuda.INT32_MIN)
    jmax = (1 << packed_cuda.pass_bits(200, 64)) - 1
    sims = qs @ db.T
    for lane in (0, 9, 63):
        kept = v[0, :, lane][v[0, :, lane] > exact_cuda.INT32_MIN]
        passes = jmax - (kept & jmax)
        col = sims[0, lane::64]
        order = np.lexsort((np.arange(len(col)), -col))
        np.testing.assert_array_equal(passes, order[: len(passes)])


@pytest.mark.parametrize("metric", ["ip", "l2"])
def test_flat_and_exact_topk_approx_match_pallas(metric):
    n = 2900
    db, qs = _grid(7, n, 16, 128)
    want = jexact.exact_pallas_topk(
        jnp.asarray(db), jnp.asarray(qs), 300, metric=metric, exact=False,
        recall_target=0.98, interpret=True,
    )
    for got in (
        ttopk.flat_topk(_t(db), _t(qs), 300, metric=metric, approx=True,
                        recall_target=0.98),
        exact_cuda.exact_topk(_t(db), _t(qs), 300, metric=metric,
                              exact=False, recall_target=0.98),
    ):
        _same(got, want, n, 256)


def test_flat_topk_storage_routes():
    db, qs = _grid(8, 600, 7, 32)
    tdb = _t(db)
    # approx with k ≤ 32 runs the exact path
    exact = ttopk.flat_topk(tdb, _t(qs), 20, metric="ip")
    approx = ttopk.flat_topk(tdb, _t(qs), 20, metric="ip", approx=True)
    np.testing.assert_array_equal(approx[1].numpy(), exact[1].numpy())
    # an SQ8Database defaults to sq8-sym (ip) / sq8 (l2)
    pq = packed_cuda.quantize_database(tdb)
    for metric, storage in (("ip", "sq8-sym"), ("l2", "sq8")):
        a = ttopk.flat_topk(pq, _t(qs), 50, metric=metric, approx=True)
        b = ttopk.flat_topk(tdb, _t(qs), 50, metric=metric, approx=True,
                            storage=storage)
        np.testing.assert_array_equal(a[1].numpy(), b[1].numpy())
    with pytest.raises(ValueError, match="approx-mode"):
        ttopk.flat_topk(tdb, _t(qs), 50, storage="sq8")
    with pytest.raises(ValueError, match="quantises internally"):
        packed_cuda.packed_topk(tdb.to(torch.int8), _t(qs), 50, storage="sq8")
    with pytest.raises(ValueError, match="unknown storage"):
        packed_cuda.packed_topk(tdb, _t(qs), 50, storage="pq")
    with pytest.raises(ValueError, match="ip / cosine"):
        packed_cuda.segment_packed_kernel(
            _t(qs).to(torch.int8), tdb.to(torch.int8), 256, 3, "l2",
            "sq8-sym", scales=torch.ones(600),
        )
    with pytest.raises(TypeError):
        packed_cuda.segment_packed_kernel(_t(qs), tdb.to(torch.int8), 256, 3)


@pytest.mark.parametrize("metric", ["cosine", "l2"])
def test_flat_index_sq8_matches_jax(metric):
    rng = np.random.RandomState(9)
    train = rng.randn(1500, 64).astype(np.float32)
    test = rng.randn(12, 64).astype(np.float32)
    j = jflat.FlatIndex(metric=metric, backend="sq8").add(train[:1000])
    t = tflat.FlatIndex(metric=metric, backend="sq8", device="cpu").add(
        train[:1000]
    )
    exact_ids = metric != "l2"  # l2 runs the sq8 kernel: Gaussian sums
    _same(t.search(test, 100), j.search(test, 100), 1000, 256, exact_ids)
    assert t._db_sq8 is not None
    # add() invalidates the quantize-once cache in both packages
    j.add(train[1000:])
    t.add(train[1000:])
    assert t._db_sq8 is None
    _same(t.search(test, 100), j.search(test, 100), 1500, 256, exact_ids)
    assert t._db_sq8.n == 1500


def test_flat_index_approx_matches_pallas():
    db, qs = _grid(10, 1500, 9, 64)
    got = tflat.FlatIndex(metric="ip", backend="approx", device="cpu").add(
        db
    ).search(qs, 100)
    want = jexact.exact_pallas_topk(
        jnp.asarray(db), jnp.asarray(qs), 100, metric="ip", exact=False,
        recall_target=0.95, interpret=True,
    )
    _same(got, want, 1500, 256)
