"""The port's FlatIndex / knn_search / index files against the JAX package on
the repo's fixtures (CPU, plain versions): ids equal, and .npz index files
written by either package load in the other.

Scores agree within rtol 1e-5 and an absolute 1e-6 of the operands' scale
(|q|·|d| for ip, |q|² + |d|² for l2, 1 for cosine): torch's CPU matmul and
XLA sum in different orders, and the clustered fixture's raw vectors have
norms near 56, so a score near 0 carries the rounding of terms near 3000.

A search of several blocks (the block size patched small) returns the
one-block search's answers bit for bit, but for the plain backend's scores:
there a CPU matmul of another row count may round differently."""

import numpy as np
import pytest
import torch

from knn_for_homology_tpu.data import Dataset
from knn_for_homology_tpu.data.fixtures import make_clustered, make_small_random
from knn_for_homology_tpu.search import flat as jflat
from knn_for_homology_tpu.search import graph as jgraph
from knn_for_homology_tpu.ops import topk as jtopk
from knn_for_homology_tpu.search import io as jio
from knn_for_homology_tpu_torch.device import resolve_device
from knn_for_homology_tpu_torch.ops import topk as ttopk
from knn_for_homology_tpu_torch.ops.packed_cuda import packed_plan
from knn_for_homology_tpu_torch.search import flat as tflat
from knn_for_homology_tpu_torch.search import graph as tgraph
from knn_for_homology_tpu_torch.search import io as tio

RTOL, ATOL = 1e-5, 1e-6


def _scale(metric, *arrays):
    norm = max([float(np.linalg.norm(a, axis=1).max()) for a in arrays] + [1.0])
    return {"cosine": 1.0, "ip": norm * norm, "l2": 2 * norm * norm}[metric]


def _same(got, want, scale=1.0):
    np.testing.assert_array_equal(got[1], want[1])
    np.testing.assert_allclose(got[0], want[0], rtol=RTOL, atol=ATOL * scale)


@pytest.fixture(scope="module")
def clustered(tmp_path_factory):
    path = tmp_path_factory.mktemp("clustered")
    make_clustered(path, seed=1234, n_families=8, n_train=6, n_test=3, dim=32)
    return Dataset.from_dir(path)


@pytest.fixture(scope="module")
def small_random(tmp_path_factory):
    path = tmp_path_factory.mktemp("random")
    make_small_random(path)
    return Dataset.from_dir(path)


@pytest.mark.parametrize("metric", ["cosine", "ip", "l2"])
@pytest.mark.parametrize("k", [13, 40])
def test_flat_index_matches_jax(clustered, metric, k):
    train, test = clustered.load_train(), clustered.load_test()
    want = jflat.FlatIndex(metric=metric).add(train).search(test, k)
    got = tflat.FlatIndex(metric=metric, device="cpu").add(train).search(test, k)
    _same(got, want, _scale(metric, train, test))


def test_knn_search_small_random_matches_jax(small_random):
    train, test = small_random.load_train(), small_random.load_test()
    j_ids, j_scores, _ = jflat.knn_search(train, test, 13)
    t_ids, t_scores, secs = tflat.knn_search(train, test, 13, device="cpu")
    _same((t_scores, t_ids), (j_scores, j_ids), _scale("cosine"))
    assert np.all(t_ids[:, 11:] == -1)  # 11 train rows, k = 13
    assert secs >= 0.0


def test_search_self_matches_jax(clustered):
    train = clustered.load_train()
    want = jflat.FlatIndex().add(train).search_self(5)
    got = tflat.FlatIndex(device="cpu").add(train).search_self(5)
    np.testing.assert_array_equal(got[0], want[0])
    np.testing.assert_allclose(got[1], want[1], rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize("backend", ["auto", "plain", "approx", "sq8"])
@pytest.mark.parametrize("metric", ["cosine", "ip", "l2"])
@pytest.mark.parametrize("q_n, k", [(9, 13), (100, 40), (300, 60),
                                    ("self", 5), ("self", 40)])
def test_blocked_search_equals_one_block(clustered, monkeypatch, backend,
                                         metric, q_n, k):
    """Blocks of 7 queries: 9-300 queries (or the 48 rows' self-search) in
    several blocks, the last one short; k = 60 > 48 rows pads with -1. Each
    call counts its route once."""
    train = clustered.load_train()
    rng = np.random.RandomState(k)
    index = tflat.FlatIndex(metric, backend=backend, device="cpu").add(train)
    if q_n == "self":
        def run():
            return index.search_self(k)[::-1]
        queries = train
    else:
        queries = (train[rng.randint(len(train), size=q_n)]
                   + rng.randn(q_n, train.shape[1]).astype(np.float32))

        def run():
            return index.search(queries, k)
    routes = dict(tflat.FlatIndex.copy_routes)
    want = run()
    monkeypatch.setattr(tflat.FlatIndex, "_block_rows", lambda self, k: 7)
    got = run()
    assert {r: tflat.FlatIndex.copy_routes[r] - routes[r] for r in routes} \
        == {"pipelined": 1, "direct": 1}
    for g, w in zip(got, want):
        assert g.dtype == w.dtype and g.shape == w.shape
    if backend == "plain":
        _same(got, want, _scale(metric, train, queries))
    else:
        np.testing.assert_array_equal(got[0], want[0])
        np.testing.assert_array_equal(got[1], want[1])
    if k > len(train):
        assert np.all(want[1][:, len(train):] == -1)
        assert np.all(np.isinf(want[0][:, len(train):]))


@pytest.mark.parametrize("backend, k, inner", [
    ("auto", 1000, ttopk.QUERY_BLOCK), ("plain", 13, ttopk.QUERY_BLOCK),
    ("approx", 13, ttopk.QUERY_BLOCK), ("approx", 1000, None),
    ("sq8", 13, None), ("sq8", 1000, None)])
def test_block_rows_are_whole_route_blocks(backend, k, inner):
    """A block is a whole multiple of the route's own query block (packed
    routes: packed_topk's launch block), and one search of a few hundred
    queries stays a single block."""
    n, d = 131080, 8
    index = tflat.FlatIndex(backend=backend, device="cpu")
    index._db = torch.zeros((n, d))
    if inner is None:
        inner = packed_plan(n, k, recall_target=index.config.recall_target)[2]
    rows = index._block_rows(k)
    assert rows % inner == 0 and rows >= 256


def test_add_twice_and_dims(clustered):
    train = clustered.load_train()
    index = tflat.FlatIndex(device="cpu").add(train[:20]).add(train[20:])
    assert index.ntotal == train.shape[0] and index.dim == train.shape[1]
    whole = tflat.FlatIndex(device="cpu").add(train)
    _same(index.search(train[:4], 7), whole.search(train[:4], 7))


@pytest.mark.parametrize("direction", ["jax_to_torch", "torch_to_jax"])
def test_npz_round_trip_across_packages(clustered, tmp_path, direction):
    train, test = clustered.load_train(), clustered.load_test()
    path = tmp_path / "index.faiss"  # any suffix: the exact name is kept
    if direction == "jax_to_torch":
        jio.write_index(jflat.FlatIndex(metric="l2").add(train), path)
        loaded = tio.read_index(path, device="cpu")
        assert isinstance(loaded, tflat.FlatIndex)
    else:
        tio.write_index(
            tflat.FlatIndex(metric="l2", device="cpu").add(train), path
        )
        loaded = jio.read_index(path)
        assert isinstance(loaded, jflat.FlatIndex)
    assert path.exists() and loaded.metric == "l2"
    want = jflat.FlatIndex(metric="l2").add(train).search(test, 9)
    _same(loaded.search(test, 9), want, _scale("l2", train, test))


def test_unported_backends_and_kinds_raise(tmp_path):
    # approx and sq8 are ported (tests/test_torch_packed.py); an unknown
    # storage raises as in the JAX package, and so does the TPU-only
    # "pallas" backend; every index kind is ported (a graph file loads,
    # tests/test_torch_graph.py), and an unknown kind raises
    train = np.random.RandomState(0).randn(40, 8).astype(np.float32)
    db = torch.from_numpy(train)
    with pytest.raises(ValueError, match="unknown storage"):
        ttopk.flat_topk(db, db[:3], 5, approx=True, storage="pq")
    with pytest.raises(ValueError, match="unknown storage"):
        jtopk.flat_topk(train, train[:3], 5, approx=True, storage="pq")
    with pytest.raises(ValueError):
        tflat.FlatIndex(backend="pallas", device="cpu")
    jio.write_index(jgraph.GraphIndex(degree=4).add(train), tmp_path / "g")
    graph = tio.read_index(tmp_path / "g", device="cpu")
    assert isinstance(graph, tgraph.GraphIndex) and graph.ntotal == 40
    np.savez(tmp_path / "pq.npz", kind="pq")
    with pytest.raises(ValueError, match="unknown index kind"):
        tio.read_index(tmp_path / "pq.npz", device="cpu")
    with pytest.raises(ValueError, match="empty"):
        tflat.FlatIndex(device="cpu").search(np.zeros((1, 4), np.float32), 3)


def test_resolve_device():
    assert resolve_device("cpu") == torch.device("cpu")
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="cuda"):
            resolve_device("cuda")
    with pytest.raises(ValueError):
        resolve_device("meta")
