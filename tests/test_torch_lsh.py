"""The port's LSH index (ops/lsh.py, search/lsh.py), its persistence and the
index CLI (search/cli.py) against the JAX package on the CPU.

Tolerances:
  * sketches: a sign of x·p is a rounding of a sum taken in another order
    by XLA and by torch, so it may flip where |x·p| is within a few ulps of
    zero. Signs are held bit-equal wherever |x·p| in fp64 exceeds EPS; the
    flips below it are counted (none at these sizes).
  * Hamming distances and ids: bit-equal given equal sketches (the ±1
    products are exact integers in both packages, and both select distance
    ascending, lower id first on ties).
"""

import numpy as np
import pytest
import torch

from knn_for_homology_tpu.ops import lsh as jlsh
from knn_for_homology_tpu.search import cli as jcli
from knn_for_homology_tpu.search import io as jio
from knn_for_homology_tpu.search import lsh as jsearch
from knn_for_homology_tpu_torch.ops import lsh as tlsh
from knn_for_homology_tpu_torch.search import cli as tcli
from knn_for_homology_tpu_torch.search import graph as tgraph
from knn_for_homology_tpu_torch.search import io as tio
from knn_for_homology_tpu_torch.search import ivf as tivf
from knn_for_homology_tpu_torch.search import lsh as tsearch

EPS = 1e-4  # |x·p| in fp64 above which the two packages' signs must agree


def _vectors(n, d, seed):
    return np.random.RandomState(seed).randn(n, d).astype(np.float32)


@pytest.mark.parametrize("n, d, nbits, seed", [
    (512, 64, 1024, 0), (300, 48, 100, 1), (512, 16, 2048, 2),
])
def test_compute_signs_bit_equal_above_eps(n, d, nbits, seed):
    x = _vectors(n, d, seed)
    proj = tlsh.projection_matrix(d, nbits, seed)
    np.testing.assert_array_equal(proj, jlsh.projection_matrix(d, nbits, seed))
    want = np.asarray(jlsh.compute_signs(x, proj))
    got = tlsh.compute_signs(torch.from_numpy(x), torch.from_numpy(proj))
    assert got.dtype == torch.int8 and got.shape == (n, nbits)
    got = got.numpy()
    exact = x.astype(np.float64) @ proj.astype(np.float64)
    far = np.abs(exact) > EPS
    np.testing.assert_array_equal(got[far], want[far])
    np.testing.assert_array_equal(got[far], np.where(exact[far] >= 0, 1, -1))
    assert int((got != want).sum()) == 0  # flips below EPS: none here


@pytest.mark.parametrize("nbits", [64, 100, 1024])
def test_pack_unpack_round_trip(nbits):
    signs = np.where(np.random.RandomState(3).rand(37, nbits) < 0.5, 1, -1)
    signs = signs.astype(np.int8)
    packed = tlsh.pack_signs(signs)
    assert packed.dtype == np.uint8 and packed.shape == (37, -(-nbits // 8))
    np.testing.assert_array_equal(packed, jlsh.pack_signs(signs))
    back = tlsh.unpack_signs(packed, nbits)
    np.testing.assert_array_equal(back, signs)
    np.testing.assert_array_equal(back, jlsh.unpack_signs(packed, nbits))


def _sketches(case):
    """(db signs, query signs) from the JAX package: k < N, k > N, and
    forced ties (every db row three times, so each distance ties)."""
    rng = np.random.RandomState(4)
    x = _vectors(400, 32, 5)
    proj = jlsh.projection_matrix(32, 256, 6)
    signs = np.array(jlsh.compute_signs(x, proj))
    if case == "ties":
        return np.concatenate([signs[:100]] * 3), signs[rng.permutation(400)[:60]]
    return signs[:340], signs[340:]


@pytest.mark.parametrize("case, k, db_tile", [
    ("k<N", 25, 8192), ("k<N", 25, 128), ("k>N", 400, 8192),
    ("ties", 50, 8192), ("ties", 300, 128),
])
def test_hamming_topk_bit_equal(case, k, db_tile):
    db, q = _sketches(case)
    want_d, want_i = (np.asarray(a) for a in jlsh.hamming_topk(db, q, k))
    tdb, tq = torch.from_numpy(db), torch.from_numpy(q)
    for got_d, got_i in (tlsh.hamming_topk(tdb, tq, k, db_tile=db_tile),
                         tlsh.hamming_topk_int(tdb, tq, k),
                         tlsh.hamming_topk_int(tdb, tq, k, torch.int64)):
        assert got_d.dtype == torch.float32 and got_i.dtype == torch.int32
        np.testing.assert_array_equal(got_i.numpy(), want_i)
        np.testing.assert_array_equal(got_d.numpy(), want_d)
    if case == "k>N":
        assert np.isinf(want_d[:, 340:]).all() and (want_i[:, 340:] == -1).all()
    if case == "ties":  # each tie resolves to the lower id, in order
        assert (np.diff(want_d, axis=1) >= 0).all()


def test_key_dtype_from_shapes():
    assert tlsh.key_dtype(131072, 1024) == torch.int32  # 12 + 17 bits
    assert tlsh.key_dtype(131072, 2048) == torch.int32  # 13 + 17
    assert tlsh.key_dtype(1 << 18, 2048) == torch.int32  # 13 + 18
    assert tlsh.key_dtype(1 << 19, 2048) == torch.int64  # 13 + 19 > 31
    assert tlsh.key_dtype(1, 8) == torch.int32


def test_hamming_topk_checks_inputs():
    db = torch.ones((4, 8), dtype=torch.int8)
    with pytest.raises(ValueError):
        tlsh.hamming_topk(db, torch.ones((2, 16), dtype=torch.int8), 2)
    with pytest.raises(TypeError):
        tlsh.hamming_topk(db, torch.ones((2, 8)), 2)


def test_lsh_index_search_matches_jax():
    train, test = _vectors(500, 40, 7), _vectors(60, 40, 8)
    j = jsearch.LSHIndex(40, nbits=512).add(train[:300]).add(train[300:])
    t = tsearch.LSHIndex(40, nbits=512, device="cpu")
    t.add(train[:300]).add(train[300:])
    assert t.ntotal == j.ntotal == 500
    np.testing.assert_array_equal(t.state()["packed_signs"],
                                  j.state()["packed_signs"])
    for k in (1, 30, 600):
        got, want = t.search(test, k), j.search(test, k)
        np.testing.assert_array_equal(got[1], np.asarray(want[1]))
        np.testing.assert_array_equal(got[0], np.asarray(want[0]))
    with pytest.raises(ValueError, match="empty"):
        tsearch.LSHIndex(40, device="cpu").search(test, 3)


def test_lsh_index_file_moves_both_ways(tmp_path):
    train, test = _vectors(200, 24, 9), _vectors(20, 24, 10)
    j = jsearch.LSHIndex(24, nbits=256, seed=77).add(train)
    jio.write_index(j, tmp_path / "jax.index")
    from_jax = tio.read_index(tmp_path / "jax.index", device="cpu")
    assert isinstance(from_jax, tsearch.LSHIndex)
    assert (from_jax.dim, from_jax.nbits, from_jax.seed) == (24, 256, 77)
    want = j.search(test, 15)
    got = from_jax.search(test, 15)
    np.testing.assert_array_equal(got[1], np.asarray(want[1]))
    np.testing.assert_array_equal(got[0], np.asarray(want[0]))
    tio.write_index(from_jax, tmp_path / "torch.index")
    back = jio.read_index(tmp_path / "torch.index")
    assert isinstance(back, jsearch.LSHIndex)
    got = back.search(test, 15)
    np.testing.assert_array_equal(np.asarray(got[1]), np.asarray(want[1]))
    with np.load(tmp_path / "jax.index") as a, np.load(
        tmp_path / "torch.index"
    ) as b:
        assert sorted(a.files) == sorted(b.files)
        for key in a.files:
            np.testing.assert_array_equal(a[key], b[key])
    empty = tsearch.LSHIndex(24, nbits=256, device="cpu")
    tio.write_index(empty, tmp_path / "empty.index")
    assert jio.read_index(tmp_path / "empty.index").ntotal == 0


@pytest.fixture()
def train_dir(tmp_path):
    np.save(tmp_path / "train.npy", _vectors(300, 32, 11))
    return tmp_path


def test_create_index_cli_lsh_matches_jax(train_dir):
    tcli.create_index_main(["--dir", str(train_dir), "--index",
                            str(train_dir / "t.index"), "--kind", "lsh",
                            "--param", "512", "--device", "cpu"])
    jcli.create_index_main(["--dir", str(train_dir), "--index",
                            str(train_dir / "j.index"), "--param", "512"])
    with np.load(train_dir / "t.index") as a, np.load(
        train_dir / "j.index"
    ) as b:
        assert str(a["kind"]) == "lsh" and int(a["nbits"]) == 512
        for key in b.files:
            np.testing.assert_array_equal(a[key], b[key])


@pytest.mark.parametrize("lean", [False, True])
def test_create_index_cli_ivf(train_dir, lean):
    out = train_dir / "ivf.index"
    tcli.create_index_main(["--dir", str(train_dir), "--index", str(out),
                            "--kind", "ivf", "--param", "256",
                            "--device", "cpu"] + (["--lean"] if lean else []))
    index = tio.read_index(out, device="cpu")
    assert isinstance(index, tivf.IVFIndex)
    assert index.nprobe == 4 and index.store_fp32 is not lean
    assert index.ntotal == 300
    # the JAX package reads the port's file
    assert jio.read_index(out).ntotal == 300


def test_create_index_cli_graph_matches_jax(train_dir):
    """--kind graph, --param = the beam width: the file holds the JAX
    package's graph and loads in both packages."""
    tcli.create_index_main(["--dir", str(train_dir), "--index",
                            str(train_dir / "t.index"), "--kind", "graph",
                            "--param", "64", "--device", "cpu"])
    jcli.create_index_main(["--dir", str(train_dir), "--index",
                            str(train_dir / "j.index"), "--kind", "graph",
                            "--param", "64"])
    with np.load(train_dir / "t.index") as a, np.load(
        train_dir / "j.index"
    ) as b:
        assert sorted(a.files) == sorted(b.files)
        assert str(a["kind"]) == "graph" and int(a["beam_width"]) == 64
        for key in b.files:
            if key == "vectors":  # the normalisation's fp32 sums
                np.testing.assert_allclose(a[key], b[key], rtol=0, atol=1e-6)
            else:
                np.testing.assert_array_equal(a[key], b[key])
    index = tio.read_index(train_dir / "t.index", device="cpu")
    assert isinstance(index, tgraph.GraphIndex) and index.beam_width == 64
    assert jio.read_index(train_dir / "t.index").ntotal == 300


def test_create_index_cli_refusals(train_dir):
    with pytest.raises(SystemExit):
        tcli.create_index_main(["--dir", str(train_dir), "--index",
                                str(train_dir / "l.index"), "--lean",
                                "--kind", "graph", "--device", "cpu"])
    with pytest.raises(SystemExit):
        tcli.create_index_main(["--dir", str(train_dir), "--index",
                                str(train_dir / "l.index"), "--lean",
                                "--device", "cpu"])
    assert not (train_dir / "l.index").exists()
