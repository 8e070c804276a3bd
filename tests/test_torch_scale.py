"""The port's pod meshes and sharded indexes (parallel/scale.py) on four
gloo ranks of the CPU against the JAX package's on four devices of the
conftest's virtual mesh (`make_pod_mesh(n_ici=2, n_dcn=2)`,
`make_mesh(4)`), the cases of tests/test_scale.py; and ShardSweep (one
process) against the JAX ShardSweep.

One world of four ranks (parallel/mesh.py:spawn) builds and searches
every index once for the module; the ranks are children that import this
file, so it imports jax only inside the tests.

Tolerances: ids equal everywhere (the per-shard builds are the reference's:
k-means, balanced cells, the exact kNN graph with its Threefry edges);
flat and IVF scores within 1e-6 (rtol 1e-5 for cosine flat, as
tests/test_scale.py holds the reference to its single-device index; atol
1e-5 for l2 self distances, which cancel terms of ~16);
LSH distances bit-equal, to the JAX sharded index and to the port's
single-device LSHIndex."""

import sys

import numpy as np
import pytest
import torch

from knn_for_homology_tpu_torch.parallel import (
    ShardedFlatIndex,
    ShardedGraphIndex,
    ShardedIVFIndex,
    ShardedLSHIndex,
    make_mesh,
    make_pod_mesh,
    stream_add,
)
from knn_for_homology_tpu_torch.parallel.mesh import spawn
from knn_for_homology_tpu_torch.parallel.scale import (
    DCN_AXIS,
    ShardSweep,
    data_axis_size,
)
from knn_for_homology_tpu_torch.search.lsh import LSHIndex

RANKS = 4
IVF_CASES = [  # (name, kwargs)
    ("ivf_probe", dict(nprobe=8)),
    ("ivf_probe_lean", dict(nprobe=8, rescore=False)),
    ("ivf_union", dict(nprobe=8, union_budget=4096)),
    ("ivf_union_lean", dict(nprobe=8, union_budget=4096, rescore=False)),
    ("ivf_union_small", dict(nprobe=4, union_budget=2)),
]


def _data():
    rng = np.random.RandomState(41)
    out = {"flat": (rng.randn(333, 32).astype(np.float32),
                    rng.randn(19, 32).astype(np.float32))}
    rng = np.random.RandomState(42)
    out["stream"] = rng.randn(100, 16).astype(np.float32)
    rng = np.random.RandomState(43)
    out["spill"] = (rng.randn(64, 16).astype(np.float32),
                    rng.randn(7, 16).astype(np.float32))
    rng = np.random.RandomState(44)
    fams = np.repeat(np.arange(20), 40)
    db = ((rng.randn(20, 32) * 8)[fams] + rng.randn(800, 32)).astype(
        np.float32)
    out["graph"] = (db, db[:32] + rng.randn(32, 32).astype(np.float32) * 0.1)
    rng = np.random.RandomState(17)
    out["lsh"] = (rng.randn(333, 32).astype(np.float32),
                  rng.randn(23, 32).astype(np.float32))
    rng = np.random.RandomState(5)
    out["sq8"] = rng.randn(700, 128).astype(np.float32)
    rng = np.random.RandomState(9)
    centers = rng.randn(32, 64).astype(np.float32)
    db = centers[rng.randint(0, 32, 1030)] + 0.08 * rng.randn(
        1030, 64).astype(np.float32)
    out["ivf"] = (db / np.linalg.norm(db, axis=1, keepdims=True)).astype(
        np.float32)
    return out


def _rank_scale(data, spill_dir):
    """Every sharded index of the module on this rank (run in the
    spawned children)."""
    dev = "cpu"
    pod = make_pod_mesh(n_ici=2, n_dcn=2)
    mesh = make_mesh(RANKS)
    out = {"pod": (pod.mesh_dim_names, tuple(pod.mesh.shape),
                   data_axis_size(pod))}
    db, q = data["flat"]
    index = ShardedFlatIndex(pod, metric="cosine", device=dev)
    index.add(db[:100]).add(db[100:250]).add(db[250:]).finalize()
    out["flat"] = index.search(q, 9)
    db = data["stream"]
    index = stream_add(ShardedFlatIndex(pod, metric="l2", device=dev),
                       (db[i : i + 17] for i in range(0, 100, 17)))
    out["stream"] = (index.ntotal, index.search(db[:5], 1))
    db, q = data["spill"]
    index = ShardedFlatIndex(pod, metric="cosine", device=dev).add(db)
    first = index.finalize().search(q, 5)
    index.save_shards(spill_dir)
    loaded = ShardedFlatIndex.load_shards(spill_dir, pod, device=dev)
    out["spill"] = (first, loaded.search(q, 5))
    db, q = data["lsh"]
    index = ShardedLSHIndex(pod, dim=32, nbits=128, device=dev)
    index.add(db[:100]).add(db[100:250]).add(db[250:]).finalize()
    single = LSHIndex(dim=32, nbits=128, device=dev).add(db)
    out["lsh"] = (index.search(q, 9), single.search(q, 9))
    out["lsh_big"] = (index.search(q[:3], 340), single.search(q[:3], 340))
    db = data["sq8"]
    out["sq8"] = ShardedFlatIndex(mesh, metric="cosine", storage="sq8-sym",
                                  device=dev).add(db).search(db[:40], 20)
    db, q = data["graph"]
    out["graph"] = ShardedGraphIndex(pod, metric="cosine", degree=16,
                                     beam_width=64, device=dev).build(
                                         db).search(q, 10)
    db = data["ivf"]
    for name, kw in IVF_CASES:
        out[name] = ShardedIVFIndex(mesh, metric="cosine", device=dev,
                                    **kw).build(db).search(db[:64], 10)
    out["jax_modules"] = sorted(
        m for m in sys.modules
        if m.split(".")[0] in ("jax", "knn_for_homology_tpu"))
    return out


@pytest.fixture(scope="module")
def spill_dir(tmp_path_factory):
    return tmp_path_factory.mktemp("spill") / "shards"


@pytest.fixture(scope="module")
def ranks(spill_dir):
    return spawn(_rank_scale, RANKS, device="cpu",
                 args=(_data(), str(spill_dir)))


@pytest.fixture(scope="module")
def meshes():
    from knn_for_homology_tpu.parallel import make_mesh as jmesh
    from knn_for_homology_tpu.parallel import make_pod_mesh as jpod

    return jpod(n_ici=2, n_dcn=2), jmesh(RANKS)


def _same(got, want, atol=1e-6, rtol=1e-6):
    np.testing.assert_array_equal(got[1], np.asarray(want[1]))
    want_s = np.asarray(want[0])
    finite = np.isfinite(want_s)
    np.testing.assert_array_equal(np.isfinite(got[0]), finite)
    np.testing.assert_allclose(got[0][finite], want_s[finite], rtol=rtol,
                               atol=atol)


def test_ranks_agree_and_import_no_jax(ranks):
    for rank in ranks:
        assert rank["jax_modules"] == []
    for key in ("flat", "graph", "ivf_probe", "ivf_union", "lsh"):
        for rank in ranks[1:]:
            np.testing.assert_array_equal(np.asarray(rank[key][1]),
                                          np.asarray(ranks[0][key][1]))


def test_pod_mesh_shape(ranks, meshes):
    names, shape, size = ranks[0]["pod"]
    assert names == (DCN_AXIS, "data") and shape == (2, 2) and size == 4
    assert dict(meshes[0].shape) == {"dcn": 2, "data": 2}


def test_flat_index_equals_jax(ranks, meshes):
    from knn_for_homology_tpu.parallel import ShardedFlatIndex as JFlat

    db, q = _data()["flat"]
    want = JFlat(meshes[0], metric="cosine").add(db[:100]).add(
        db[100:250]).add(db[250:]).finalize().search(q, 9)
    _same(ranks[0]["flat"], want, rtol=1e-5)


def test_stream_add_equals_jax(ranks, meshes):
    from knn_for_homology_tpu.parallel import ShardedFlatIndex as JFlat
    from knn_for_homology_tpu.parallel import stream_add as jstream

    db = _data()["stream"]
    want = jstream(JFlat(meshes[0], metric="l2"),
                   (db[i : i + 17] for i in range(0, 100, 17))).search(
                       db[:5], 1)
    n, got = ranks[0]["stream"]
    assert n == 100
    # a self distance is 2qd - |q|^2 - |d|^2 with |d|^2 ~ 16: a few fp32
    # ulps of 32 (3.8e-6 each) in any summation order
    _same(got, want, atol=1e-5)
    np.testing.assert_array_equal(got[1][:, 0], np.arange(5))


def test_shard_spill_round_trip_both_ways(ranks, meshes, spill_dir):
    from knn_for_homology_tpu.parallel import ShardedFlatIndex as JFlat

    first, loaded = ranks[0]["spill"]
    assert len(list(spill_dir.glob("shard_*.npz"))) == RANKS
    _same(loaded, first)
    # the reference reads the port's shard files
    _, q = _data()["spill"]
    _same(first, JFlat.load_shards(spill_dir, meshes[0]).search(q, 5),
          rtol=1e-5)


def test_lsh_bit_equal_to_single_device_and_jax(ranks, meshes):
    from knn_for_homology_tpu.parallel import ShardedLSHIndex as JLSH

    db, q = _data()["lsh"]
    jindex = JLSH(meshes[0], dim=32, nbits=128)
    jindex.add(db[:100]).add(db[100:250]).add(db[250:]).finalize()
    for key, queries, k in (("lsh", q, 9), ("lsh_big", q[:3], 340)):
        got, single = ranks[0][key]
        want = jindex.search(queries, k)
        for a, b in ((got, single), (got, want)):
            np.testing.assert_array_equal(a[1], np.asarray(b[1]))
            np.testing.assert_array_equal(a[0], np.asarray(b[0]))
            assert a[0].dtype == np.float32
    assert (ranks[0]["lsh_big"][0][1][:, 333:] == -1).all()


def test_sq8_flat_index_equals_jax(ranks, meshes):
    from knn_for_homology_tpu.parallel import ShardedFlatIndex as JFlat

    db = _data()["sq8"]
    want = JFlat(meshes[1], metric="cosine", storage="sq8-sym").add(
        db).finalize().search(db[:40], 20)
    got = ranks[0]["sq8"]
    # each package normalises the cosine rows itself (torch and XLA may
    # round a quotient apart by an ulp), so the int8 scales, not the
    # codes, may differ in the last bit: values within 1e-6
    _same(got, want)
    np.testing.assert_array_equal(got[1][:, 0], np.arange(40))


def test_graph_index_equals_jax(ranks, meshes):
    from knn_for_homology_tpu.parallel import ShardedGraphIndex as JGraph

    db, q = _data()["graph"]
    want = JGraph(meshes[0], metric="cosine", degree=16,
                  beam_width=64).build(db).search(q, 10)
    got = ranks[0]["graph"]
    _same(got, want)
    assert got[1].shape == (32, 10) and (got[1] < 800).all()


@pytest.mark.parametrize("name,kw", IVF_CASES)
def test_ivf_index_equals_jax(ranks, meshes, name, kw):
    from knn_for_homology_tpu.parallel.scale import ShardedIVFIndex as JIVF

    db = _data()["ivf"]
    want = JIVF(meshes[1], metric="cosine", **kw).build(db).search(
        db[:64], 10)
    got = ranks[0][name]
    _same(got, want)
    assert (got[1] < 1030).all() and (got[1] >= -1).all()


@pytest.mark.parametrize("index", ["graph", "ivf"])
def test_shard_sweep_equals_jax(tmp_path, index):
    from knn_for_homology_tpu.parallel.scale import ShardSweep as JSweep

    rng = np.random.RandomState(0 if index == "graph" else 1)
    chunks = [(rng.randn(256, 32) / np.sqrt(32)).astype(np.float32)
              for _ in range(3)]
    queries = chunks[1][:17] + 0.01 * rng.randn(17, 32).astype(np.float32)
    kw = (dict(degree=12, beam_width=64, expand=8, iters=8)
          if index == "graph" else dict(index="ivf", nprobe=8))
    sweep = ShardSweep(tmp_path / "port", device="cpu", **kw)
    jsweep = JSweep(tmp_path / "jax", **kw)
    for c in chunks:
        assert sweep.build_shard(c) > 0
        jsweep.build_shard(c)
    assert sweep.ntotal == 3 * 256
    got_s, got_i, secs = sweep.search(queries, 5)
    want_s, want_i, _ = jsweep.search(queries, 5)
    assert len(secs) == 3
    np.testing.assert_array_equal(got_i, want_i)
    np.testing.assert_allclose(got_s, want_s, rtol=1e-6, atol=1e-6)
    if index == "ivf":  # the lean layout: no fp32 rows in the shard files
        with np.load(sweep._path(0), allow_pickle=False) as data:
            assert "vectors" not in data.files
            assert "packed_vecs" in data.files


@pytest.fixture(scope="module")
def jax_graph():
    """A JAX-built graph over 300 clustered rows (d = 128), carried to the
    port (its packed slabs are the reference's layout)."""
    from knn_for_homology_tpu.search import graph as jg

    from knn_for_homology_tpu_torch.search import graph as tg

    rng = np.random.RandomState(45)
    fams = np.repeat(np.arange(10), 30)
    db = _normed_rows((rng.randn(10, 128) * 6)[fams] + rng.randn(300, 128))
    q = _normed_rows(db[::15] + 0.1 * rng.randn(20, 128))
    j = jg.GraphIndex(metric="ip", degree=16).add(db)
    return j, tg.GraphIndex.from_state(j.state(), device="cpu"), q


def _normed_rows(x):
    return (x / np.linalg.norm(x, axis=1, keepdims=True)).astype(np.float32)


@pytest.mark.parametrize("packed", [False, True])
@pytest.mark.parametrize("rescore", [True, False])
def test_beam_search_n_valid_and_rescore_equal_jax(jax_graph, packed,
                                                   rescore):
    # the sharded graph's arguments: rows >= n_valid never score (entry
    # seeding, the beam, the rescore); rescore=False returns the beam's
    # traversal scores
    import jax.numpy as jnp

    from knn_for_homology_tpu.search import graph as jg

    from knn_for_homology_tpu_torch.search import graph as tg

    j, t, q = jax_graph
    n_valid, k = 250, 12
    piv = np.arange(0, 300, 10, dtype=np.int32)
    want_e = np.asarray(jg._seed_entries(j._db, jnp.asarray(piv),
                                         jnp.asarray(q), 8, "ip",
                                         n_valid=jnp.int32(n_valid)))
    got_e = tg._seed_entries(t._db, torch.from_numpy(piv),
                             torch.from_numpy(q), 8, "ip", n_valid=n_valid)
    np.testing.assert_array_equal(got_e.numpy(), want_e)
    assert (want_e < n_valid).all()
    kw = dict(beam_width=32, expand=4, iters=6, rescore=rescore)
    qt = torch.from_numpy(q)
    if packed:
        pv, pi, sc, deg_p = t._packed_state()
        jpv, jpi, jsc, jdeg = j._packed_state()
        want = jg.beam_search_packed(
            j._db, jpv, jpi, jsc, jnp.asarray(q), jnp.asarray(want_e), k,
            jdeg, 16, n_valid=jnp.int32(n_valid), interpret=True, **kw)
        got = tg.beam_search_packed(t._db, pv, pi, sc, qt, got_e, k, deg_p,
                                    16, n_valid=n_valid, **kw)
    else:
        want = jg.beam_search(j._db, j._graph, jnp.asarray(q),
                              jnp.asarray(want_e), k, metric="ip",
                              n_valid=jnp.int32(n_valid), **kw)
        got = tg.beam_search(t._db, t._graph, qt, got_e, k, metric="ip",
                             n_valid=n_valid, **kw)
    np.testing.assert_array_equal(got[1].numpy(), np.asarray(want[1]))
    np.testing.assert_allclose(got[0].numpy(), np.asarray(want[0]),
                               rtol=0, atol=1e-5)
    assert (got[1].numpy() < n_valid).all()
