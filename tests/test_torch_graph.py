"""The port's graph ANN index (search/graph.py) and its Threefry draw
(utils/threefry.py) against the JAX package on the CPU, with the Pallas
kernel K in interpret mode and the port's K through its plain version.

Search is compared on identical graphs: the JAX package builds the index
and its state is carried across (GraphIndex.from_state), as index files
are. Separate tests compare the two builds.

Tolerances:
  * the Threefry draw, the graph assembly from equal kNN ids and the
    long-range edges: bit-equal.
  * search: scores within ATOL of the operands' scale at every rank
    (`_scale`; fp32 sums of the same products in other orders), ids equal
    but where the reference's scores are near-tied: two ids whose fp32
    rescores lie within ATOL may come in either order (the fp32 sums
    differ by an ulp or two), and so may the k-th place. At most 2% of the
    ids may differ so; the tie-breaking itself (lower id first) is held
    bit for bit on rows with exactly equal scores
    (test_exact_ties_keep_the_lower_id).
  * the builds from raw vectors: XLA and torch sum the normalisation and
    the kNN products in other orders, so neighbours whose scores lie
    within NEAR of each other may swap. Every differing entry must be such
    a near-tie, checked in fp64. kNN-descent repeats its rounds on the
    graph it made, so a swap in one round can change later candidates:
    one round is held to near-ties, six rounds to at most 2% of rows
    differing and equal recall against the exact graph.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from knn_for_homology_tpu.data.fixtures import make_clustered
from knn_for_homology_tpu.ops.topk import flat_topk as jflat_topk
from knn_for_homology_tpu.search import graph as jg
from knn_for_homology_tpu.search import io as jio
from knn_for_homology_tpu_torch.ops import slab_cuda
from knn_for_homology_tpu_torch.search import graph as tg
from knn_for_homology_tpu_torch.search import io as tio
from knn_for_homology_tpu_torch.utils import threefry

ATOL = 1e-5  # of the scores' scale
NEAR = 1e-5  # of the scores' scale: a near-tie of the builds


@pytest.fixture(scope="module")
def clustered(tmp_path_factory):
    """32 families of 40 rows at d = 128 (centroids x 10 + unit noise)."""
    path = tmp_path_factory.mktemp("graph")
    make_clustered(path, seed=3, n_families=32, n_train=40, n_test=2, dim=128)
    return np.load(path / "train.npy"), np.load(path / "test.npy")


def _scale(metric, x):
    norm = float(np.linalg.norm(x, axis=1).max())
    return {"cosine": 1.0, "ip": norm * norm, "l2": 4 * norm * norm}[metric]


def _same(got, want, scale, exact=False):
    (gs, gi), (ws, wi) = got, want
    assert gs.shape == ws.shape and gi.shape == wi.shape
    np.testing.assert_array_equal(np.isfinite(gs), np.isfinite(ws))
    fin = np.isfinite(ws)
    np.testing.assert_allclose(gs[fin], ws[fin], rtol=0, atol=ATOL * scale)
    if exact:
        np.testing.assert_array_equal(gi, wi)
        return
    diff = gi != wi
    assert diff.mean() <= 0.02, diff.mean()
    for r, c in zip(*np.nonzero(diff)):
        near = np.abs(ws[r] - ws[r, c]) <= ATOL * scale
        assert gi[r, c] in set(wi[r][near]) or near[-1], (r, c)


def _sims64(x, metric):
    """fp64 bigger-is-better similarities of the rows of x."""
    x = x.astype(np.float64)
    if metric == "cosine":
        x = x / np.linalg.norm(x, axis=1, keepdims=True)
    s = x @ x.T
    if metric == "l2":
        sq = np.sum(x * x, axis=1)
        s = 2 * s - sq[:, None] - sq[None, :]
    return s


def _near_tie_rows(got, want, sims, tol):
    """Rows where two neighbour lists differ; each must hold neighbours of
    the same fp64 similarities, within tol, rank by rank."""
    rows = np.nonzero((got != want).any(axis=1))[0]
    for r in rows:
        a = np.sort(sims[r, got[r]])
        b = np.sort(sims[r, want[r]])
        np.testing.assert_allclose(a, b, rtol=0, atol=tol, err_msg=str(r))
    return rows


# ------------------------------------------------------------- threefry
@pytest.mark.parametrize("seed,shape,lo,hi", [
    (0x5EED, (131072, 4), 0, 131072),  # the pfam-proteins graph's edges
    (0x5EED, (1280, 4), 0, 1280),
    (7, (33, 5), -5, 70000),
    (0, (1000, 3), 0, 65536),  # a span of exactly 2^16
    (3, (5,), 3, 3),  # empty span: minval
    (2**40 + 3, (3, 2, 5), 0, 1000),  # seeds are cut to 32 bits
])
def test_threefry_randint_bit_equal(seed, shape, lo, hi):
    want = np.asarray(jax.random.randint(jax.random.PRNGKey(seed), shape,
                                         lo, hi, dtype=jnp.int32))
    got = threefry.randint(threefry.prng_key(seed), shape, lo, hi)
    assert got.dtype == np.int32 and got.shape == shape
    np.testing.assert_array_equal(got, want)


def test_threefry_split_bit_equal():
    want = np.asarray(jax.random.split(jax.random.PRNGKey(11), 5))
    got = np.asarray(threefry.split(threefry.prng_key(11), 5))
    np.testing.assert_array_equal(got, want)


# --------------------------------------------------------------- builds
@pytest.mark.parametrize("metric", ["cosine", "l2"])
@pytest.mark.parametrize("r", [0, 4])
def test_assemble_graph_bit_equal(clustered, metric, r):
    """From the same exact kNN ids: the self column stripped wherever it
    sits, self-loops where hits are missing, the seeded long-range edges."""
    train = clustered[0][:300]
    _, ids = jflat_topk(jnp.asarray(train), jnp.asarray(train), 17,
                        metric=metric)
    ids = np.asarray(ids).copy()
    ids[::7, -1] = -1  # missing hits become self-loops
    ids[::5] = np.roll(ids[::5], 3, axis=1)  # the self hit off column 0
    want = np.asarray(jg._assemble_graph(jnp.asarray(ids), 300, 16, r))
    got = tg._assemble_graph(torch.from_numpy(ids), 300, 16, r)
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("metric", ["cosine", "ip", "l2"])
@pytest.mark.parametrize("r", [0, 4])
def test_exact_build_matches_jax(clustered, metric, r):
    train = clustered[0]
    j = jg.GraphIndex(metric=metric, degree=16, random_edges=r).add(train)
    t = tg.GraphIndex(metric=metric, degree=16, random_edges=r,
                      device="cpu").add(train)
    want, got = np.asarray(j._graph), t._graph.numpy()
    assert got.shape == want.shape == (len(train), 16)
    # the long-range edges bit for bit; the kNN columns but near-ties
    np.testing.assert_array_equal(got[:, 16 - r:], want[:, 16 - r:])
    rows = _near_tie_rows(got[:, :16 - r], want[:, :16 - r],
                          _sims64(train, metric), NEAR * _scale(metric, train))
    assert len(rows) <= 0.02 * len(train)
    if metric == "ip":  # no normalisation, no near-ties in this data
        assert len(rows) == 0


@pytest.mark.parametrize("metric", ["cosine", "ip", "l2"])
def test_nn_descent_matches_jax(clustered, metric):
    train = clustered[0]
    x = train / np.linalg.norm(train, axis=1, keepdims=True) if (
        metric == "cosine") else train
    sims = _sims64(x, metric)
    tol = NEAR * _scale(metric, x)
    kw = dict(metric=metric, block=512)
    one = (np.asarray(jg.nn_descent_build(jnp.asarray(x), 16, iters=1, **kw)),
           tg.nn_descent_build(torch.from_numpy(x), 16, iters=1, **kw))
    assert one[1].dtype == np.int32
    assert len(_near_tie_rows(one[1], one[0], sims, tol)) <= 0.02 * len(x)
    want = jg.nn_descent_build(jnp.asarray(x), 16, **kw)
    got = tg.nn_descent_build(torch.from_numpy(x), 16, **kw)
    assert (got != want).any(axis=1).mean() <= 0.02
    exact = np.argsort(-(sims - 1e9 * np.eye(len(x))), axis=1,
                       kind="stable")[:, :16]

    def recall(g):
        return np.mean([len(set(a) & set(b)) / 16 for a, b in zip(g, exact)])

    assert abs(recall(got) - recall(want)) <= 0.01
    assert recall(got) > 0.9


def test_nn_descent_build_through_the_index(clustered):
    train = clustered[0][:400]
    j = jg.GraphIndex(degree=12, build="nn-descent").add(train)
    t = tg.GraphIndex(degree=12, build="nn-descent", device="cpu").add(train)
    want, got = np.asarray(j._graph), t._graph.numpy()
    np.testing.assert_array_equal(got[:, -4:], want[:, -4:])
    assert (got != want).any(axis=1).mean() <= 0.02


# --------------------------------------------------------------- search
_JAX_INDEX = {}


def _jax_index(train, metric, packed, **kw):
    key = (metric, packed, len(train), tuple(sorted(kw.items())))
    if key not in _JAX_INDEX:
        _JAX_INDEX[key] = jg.GraphIndex(metric=metric, degree=16,
                                        packed=packed, **kw).add(train)
    return _JAX_INDEX[key]


# (n_pivots, iters, beam_width, k): pivot seeding, shared strided entries,
# no expansion at all, and a beam narrower than k
CASES = {
    "pivots": (64, 6, 32, 20),
    "strided": (0, 6, 32, 20),
    "iters0": (64, 0, 32, 10),
    "k_over_beam": (64, 4, 16, 40),
}


# every case on the unpacked route in each metric; the packed route (the
# interpret-mode Pallas kernel is slow) in cosine, and ip on one case
SEARCHES = ([(m, "never", c) for m in ("cosine", "ip", "l2") for c in CASES]
            + [("cosine", "always", c) for c in CASES]
            + [("ip", "always", "pivots")])


@pytest.mark.parametrize("metric,packed,case", SEARCHES)
def test_search_on_jax_graph_matches(clustered, metric, packed, case):
    """packed="never": the unpacked route (bf16 gathers) against JAX's XLA
    route; packed="always": kernel K's plain version against JAX's
    interpret-mode Pallas kernel."""
    train, test = clustered
    n_pivots, iters, beam, k = CASES[case]
    j = _jax_index(train, metric, packed)
    j.n_pivots, j.iters, j.beam_width = n_pivots, iters, beam
    t = tg.GraphIndex.from_state(j.state(), device="cpu")
    assert t._use_packed() is (packed == "always")
    _same(t.search(test, k), j.search(test, k), _scale(metric, train))


def test_search_pads_k_beyond_ntotal(clustered):
    train, test = clustered
    for metric, packed in (("cosine", "always"), ("l2", "never")):
        j = jg.GraphIndex(metric=metric, degree=8, packed=packed,
                          iters=3).add(train[:40])
        t = tg.GraphIndex.from_state(j.state(), device="cpu")
        got, want = t.search(test[:8], 50), j.search(test[:8], 50)
        _same(got, want, _scale(metric, train))
        assert (got[1][:, 40:] == -1).all()


def test_exact_ties_keep_the_lower_id(clustered):
    """Every row four times over: equal scores everywhere, so the expand
    pick, the beam rebuild, the entry seeding and the final (score, id)
    sort all decide by id, as lax.top_k and the two-key sort do."""
    train, test = clustered
    rows = np.repeat(train[::20], 4, axis=0)
    for metric, packed in (("cosine", "never"), ("ip", "always")):
        j = jg.GraphIndex(metric=metric, degree=12, packed=packed, iters=4,
                          beam_width=24, n_pivots=16).add(rows)
        t = tg.GraphIndex(metric=metric, degree=12, packed=packed, iters=4,
                          beam_width=24, n_pivots=16, device="cpu").add(rows)
        np.testing.assert_array_equal(t._graph.numpy(), np.asarray(j._graph))
        _same(t.search(test, 16), j.search(test, 16), _scale(metric, rows),
              exact=True)


def test_query_blocks_do_not_change_results(clustered):
    train, test = clustered
    j = _jax_index(train, "cosine", "always")
    j.n_pivots, j.iters, j.beam_width = 64, 6, 32
    t = tg.GraphIndex.from_state(j.state(), device="cpu")
    whole = t.search(test, 20)
    t.QUERY_BLOCK = 16  # below the 256 floor of the budget rule
    assert t.query_block(20) == 16
    parts = t.search(test, 20)
    np.testing.assert_array_equal(parts[1], whole[1])
    np.testing.assert_array_equal(parts[0], whole[0])


def test_query_block_budget():
    t = tg.GraphIndex(device="cpu")
    t._db = torch.zeros((8, 1024))
    # the reference's CPU budget: 2e9 bytes of [qb, beam, d] fp32, beam =
    # max(beam_width = 128, k)
    assert t.query_block(10) == 2048
    assert t.query_block(1000) == 256
    t.CPU_RESCORE_BYTES = 1e12
    assert t.query_block(1000) == 4096


def test_route_rules_match_jax(clustered):
    train = clustered[0][:200]
    for kw in (dict(metric="l2"), dict(degree=130)):
        for mod, dev in ((jg, {}), (tg, {"device": "cpu"})):
            index = mod.GraphIndex(packed="always", **kw, **dev).add(train)
            with pytest.raises(ValueError, match="cannot be honoured"):
                index._use_packed()
    narrow = train[:, :96]
    for mod, dev in ((jg, {}), (tg, {"device": "cpu"})):
        with pytest.raises(ValueError, match="cannot be honoured"):
            mod.GraphIndex(packed="always", **dev).add(narrow).search(
                narrow[:2], 3)
        assert not mod.GraphIndex(packed="never", **dev).add(
            train)._use_packed()
    # "auto": the card only, as JAX's means the TPU only
    assert not tg.GraphIndex(device="cpu").add(train)._use_packed()
    assert not jg.GraphIndex().add(train)._use_packed()


def test_packed_state_is_the_reference_layout(clustered):
    train = clustered[0][:300]
    j = jg.GraphIndex(degree=42).add(train)
    t = tg.GraphIndex.from_state(j.state(), device="cpu")
    want, got = j._packed_state(), t._packed_state()
    assert got[3] == want[3] == slab_cuda.pad_degree(42) == 64
    for g, w in zip(got[:3], want[:3]):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))


# ---------------------------------------------------------- persistence
@pytest.mark.parametrize("direction", ["jax_to_torch", "torch_to_jax"])
def test_index_file_moves_both_ways(clustered, tmp_path, direction):
    train, test = clustered
    path = tmp_path / "graph.index"
    kw = dict(metric="ip", degree=12, iters=5, beam_width=24, n_pivots=32,
              build="exact", packed="never", random_edges=3)
    j = jg.GraphIndex(**kw).add(train[:400])
    if direction == "jax_to_torch":
        jio.write_index(j, path)
        loaded = tio.read_index(path, device="cpu")
        assert isinstance(loaded, tg.GraphIndex)
        got = loaded.search(test, 10)
    else:
        tio.write_index(tg.GraphIndex.from_state(j.state(), device="cpu"),
                        path)
        loaded = jio.read_index(path)
        assert isinstance(loaded, jg.GraphIndex)
        got = loaded.search(test, 10)
    for key, value in kw.items():
        assert getattr(loaded, key) == value, key
    _same(got, j.search(test, 10), _scale("ip", train))


def test_from_state_defaults_of_older_files(clustered):
    """Files without the later keys load with the reference's defaults."""
    state = jg.GraphIndex(degree=8).add(clustered[0][:50]).state()
    for key in ("iters", "n_pivots", "build", "packed", "random_edges"):
        del state[key]
    want = jg.GraphIndex.from_state(state)
    got = tg.GraphIndex.from_state(state, device="cpu")
    for key in ("iters", "n_pivots", "build", "packed", "random_edges"):
        assert getattr(got, key) == getattr(want, key), key


def test_empty_index_raises():
    with pytest.raises(ValueError, match="empty"):
        tg.GraphIndex(device="cpu").search(np.zeros((1, 4), np.float32), 3)
    with pytest.raises(ValueError, match="metric"):
        tg.GraphIndex(metric="hamming", device="cpu")
