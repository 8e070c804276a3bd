"""The port's IVF index (search/ivf.py) and full-protein pipeline
(pipelines/pfam_proteins.py) against the JAX package on the CPU, with the
Pallas kernels in interpret mode and the port's kernels J and K through
their plain versions.

Search is compared on identical cells: the JAX package builds the index
and its state is carried across (IVFIndex.from_state), as the pipeline's
index files are. A separate test compares the two builds.

Tolerances:
  * "ip" and "l2" at k > RESCORE_MAX_K through the union scan (kernel J,
    sym2): values and ids equal. Its int8 dots are exact in both packages
    and the scales are computed alike.
  * Everywhere else (the fp32 rescores of k ≤ RESCORE_MAX_K, kernel K's
    fp32 sums, cosine's row normalisation, which XLA and torch sum in other
    orders): scores agree within ATOL = 1e-5 at every rank, at most 2% of
    the ids differ, and each differing id sits among reference scores
    within ATOL of its own (a near-tie swap, or the k-th place).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from knn_for_homology_tpu.data.pfam import get_homologous_proteins as jhomologs
from knn_for_homology_tpu.eval import analysis as janalysis
from knn_for_homology_tpu.pipelines import pfam_proteins as jpp
from knn_for_homology_tpu.search import io as jio
from knn_for_homology_tpu.search import ivf as jivf
from knn_for_homology_tpu_torch.data.pfam import (
    get_homologous_proteins as thomologs,
)
from knn_for_homology_tpu_torch.eval import analysis as tanalysis
from knn_for_homology_tpu_torch.pipelines import pfam_proteins as tpp
from knn_for_homology_tpu_torch.search import io as tio
from knn_for_homology_tpu_torch.search import ivf as tivf

ATOL = 1e-5


def _clustered(n, d, n_clusters, seed=0, scale=0.08):
    rng = np.random.RandomState(seed)
    centers = rng.randn(n_clusters, d).astype(np.float32)
    assign = rng.randint(0, n_clusters, n)
    x = centers[assign] + scale * rng.randn(n, d).astype(np.float32)
    return (x / np.linalg.norm(x, axis=1, keepdims=True)).astype(np.float32)


def _assert_same(got, want, atol=ATOL, exact=False):
    (gs, gi), (ws, wi) = (tuple(np.asarray(a) for a in p) for p in (got, want))
    assert gs.shape == ws.shape and gi.shape == wi.shape
    if exact:
        np.testing.assert_array_equal(gi, wi)
        np.testing.assert_array_equal(gs, ws)
        return
    np.testing.assert_array_equal(np.isfinite(gs), np.isfinite(ws))
    fin = np.isfinite(ws)
    np.testing.assert_allclose(gs[fin], ws[fin], rtol=0, atol=atol)
    diff = gi != wi
    assert diff.mean() <= 0.02, diff.mean()
    for r, c in zip(*np.nonzero(diff)):
        near = np.abs(ws[r] - ws[r, c]) <= atol
        assert gi[r, c] in set(wi[r][near]) or near[-1], (r, c)


@pytest.fixture(scope="module")
def db():
    return _clustered(2048, 96, 32, seed=13)


_BUILT = {}


def _jax_index(db, metric, lean):
    key = (metric, lean)
    if key not in _BUILT:
        _BUILT[key] = jivf.IVFIndex(metric=metric, nprobe=4,
                                    store_fp32=not lean).add(db)
    return _BUILT[key]


def _both(db, metric, lean, union_min_q=None, query_block=None):
    j = _jax_index(db, metric, lean)
    t = tivf.IVFIndex.from_state(j.state(), device="cpu")
    for index in (j, t):
        index.UNION_MIN_Q = union_min_q or jivf.IVFIndex.UNION_MIN_Q
        index.QUERY_BLOCK = query_block or jivf.IVFIndex.QUERY_BLOCK
    return j, t


# (queries, k, UNION_MIN_Q, QUERY_BLOCK): the per-probe path (kernel K)
# below UNION_MIN_Q; the union scan (kernel J, or the l2 gather route) in
# one block, padded to QUERY_BLOCK; and several blocks (the locality sort,
# a short tail block)
ROUTES = {
    "per_probe": (100, 10, None, None),
    "per_probe_k200": (100, 200, None, None),
    "union": (600, 10, None, None),
    "union_k200": (600, 200, None, None),
    "union_blocks": (200, 10, 32, 64),
    "union_blocks_k200": (200, 200, 32, 64),
}


@pytest.mark.parametrize("route", sorted(ROUTES))
@pytest.mark.parametrize("metric", ["cosine", "ip", "l2"])
def test_search_on_jax_state_matches(db, metric, route):
    n_q, k, umq, qb = ROUTES[route]
    j, t = _both(db, metric, False, umq, qb)
    exact = metric == "ip" and k == 200 and route.startswith("union")
    _assert_same(t.search(db[:n_q], k), j.search(db[:n_q], k), exact=exact)


@pytest.mark.parametrize("route", ["per_probe", "union", "union_k200",
                                   "union_blocks"])
@pytest.mark.parametrize("metric", ["cosine", "l2"])
def test_lean_layout_search_matches(db, metric, route):
    n_q, k, umq, qb = ROUTES[route]
    j, t = _both(db, metric, True, umq, qb)
    assert t._db is None and t.plan_blocks(k)[2] in (False, "slab")
    _assert_same(t.search(db[:n_q], k), j.search(db[:n_q], k))


def test_union_budget_and_forced_gather_route(db):
    """A fixed union_budget smaller than the union (least popular cells
    dropped) and the bf16 gather route forced for cosine."""
    j, t = _both(db, "ip", False)
    for ix in (j, t):
        ix.INT8_UNION_MIN_ROWS = 10**9
    _assert_same(t.search(db[:520], 10), j.search(db[:520], 10))
    for ix in (j, t):
        ix.INT8_UNION_MIN_ROWS = 0
    _assert_same(t.search(db[:520], 200, union_budget=8),
                 j.search(db[:520], 200, union_budget=8), exact=True)


def test_balanced_members_equal():
    """Contended preferences (many rows want few cells): the pass order,
    the in-group row order and the spill into free slots are the
    reference's, and every row is stored exactly once."""
    rng = np.random.RandomState(4)
    n, c, cap = 3000, 40, 128
    order2 = np.stack([rng.randint(0, 6, n), rng.randint(0, c, n),
                       rng.randint(0, 3, n)], axis=1).astype(np.int32)
    want = np.asarray(jivf._balanced_members(jnp.asarray(order2), c, cap))
    got = tivf._balanced_members(torch.from_numpy(order2), c, cap).numpy()
    np.testing.assert_array_equal(got, want)
    assert sorted(got[got >= 0].tolist()) == list(range(n))


@pytest.mark.parametrize("metric,n_clusters", [("l2", 0), ("cosine", 0),
                                               ("ip", 64)])
def test_build_matches_jax(db, metric, n_clusters):
    """The two builds (k-means with empty-cluster reseeding when there are
    more cells than natural clusters, preferences, balancing, packing) on
    the same rows: the same members and slabs. Centroids differ by fp32
    summation order only; cosine's scales by the normalisation's."""
    j = jivf.IVFIndex(metric=metric, n_clusters=n_clusters).add(db)
    t = tivf.IVFIndex(metric=metric, n_clusters=n_clusters,
                      device="cpu").add(db)
    np.testing.assert_allclose(t._centroids.numpy(), np.asarray(j._centroids),
                               rtol=0, atol=1e-6)
    np.testing.assert_array_equal(t._members.numpy(), np.asarray(j._members))
    for g, w in zip(t._packed[:2], j._packed[:2]):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))
    np.testing.assert_allclose(t._packed[2].numpy(), np.asarray(j._packed[2]),
                               rtol=1e-6, atol=0)
    members = t._members.numpy()
    assert sorted(members[members >= 0].tolist()) == list(range(len(db)))


def test_add_chunks_matches_jax_and_lean_add(db):
    """The streamed lean build: one chunk with stride-1 sampling equals the
    port's in-memory lean build (slabs, members; scales within an ulp: the
    chunk is quantised eagerly, the in-memory pack by the reference's
    jitted form), and three uneven chunks equal the JAX package's streamed
    build."""
    lean = tivf.IVFIndex(metric="l2", nprobe=8, store_fp32=False,
                         device="cpu").add(db)
    one = tivf.IVFIndex(metric="l2", nprobe=8, store_fp32=False,
                        device="cpu").add_chunks(lambda: [db], n_total=2048,
                                                 kmeans_sample=4096)
    for g, w in zip(one._packed[:2], lean._packed[:2]):
        np.testing.assert_array_equal(g.numpy(), w.numpy())
    np.testing.assert_allclose(one._packed[2].numpy(), lean._packed[2].numpy(),
                               rtol=3e-7)

    def chunks():
        yield db[:900]
        yield db[900:1800]
        yield db[1800:]

    j = jivf.IVFIndex(metric="l2", nprobe=8, store_fp32=False).add_chunks(
        chunks, n_total=2048, kmeans_sample=512)
    t = tivf.IVFIndex(metric="l2", nprobe=8, store_fp32=False,
                      device="cpu").add_chunks(chunks, n_total=2048,
                                               kmeans_sample=512)
    np.testing.assert_array_equal(t._members.numpy(), np.asarray(j._members))
    for g, w in zip(t._packed, j._packed):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))
    np.testing.assert_allclose(t._row_sq.numpy(), np.asarray(j._row_sq),
                               rtol=1e-6)
    _assert_same(t.search(db[:64], 10), j.search(db[:64], 10))
    with pytest.raises(ValueError, match="yielded"):
        tivf.IVFIndex(store_fp32=False, device="cpu").add_chunks(chunks, 99)
    with pytest.raises(ValueError, match="store_fp32"):
        tivf.IVFIndex(device="cpu").add_chunks(chunks, n_total=2048)
    with pytest.raises(ValueError, match="lean"):
        t.add(db[:10])


@pytest.mark.parametrize("lean", [False, True])
def test_npz_round_trip_both_ways(db, tmp_path, lean):
    """An index written by either package loads in the other and gives the
    same ids; the lean layout's slabs travel bit for bit."""
    j = _jax_index(db, "cosine", lean)
    jio.write_index(j, tmp_path / "from_jax.index")
    t = tio.read_index(tmp_path / "from_jax.index", device="cpu")
    assert isinstance(t, tivf.IVFIndex) and t.ntotal == 2048
    _assert_same(t.search(db[:32], 9), j.search(db[:32], 9))
    tio.write_index(t, tmp_path / "from_torch.index")
    back = jio.read_index(tmp_path / "from_torch.index")
    assert isinstance(back, jivf.IVFIndex)
    _assert_same(back.search(db[:32], 9), j.search(db[:32], 9), exact=True)
    if lean:
        for g, w in zip(t._packed, j._packed):
            np.testing.assert_array_equal(g.numpy(), np.asarray(w))


def _proteins(seed=9, n_fam=12, per=24, d=32):
    """Family-clustered full-protein embeddings; one domain per protein,
    its family, plus a second shared domain on every fifth protein."""
    rng = np.random.RandomState(seed)
    fams = np.repeat(np.arange(n_fam), per)
    emb = ((rng.randn(n_fam, d) * 10)[fams]
           + rng.randn(n_fam * per, d)).astype(np.float32)
    ids = [f"P{i}" for i in range(len(fams))]
    p2d = {f"P{i}": [(f"F{f}", (0, 50))] for i, f in enumerate(fams)}
    for i in range(0, len(fams), 5):
        p2d[f"P{i}"].append(("Fshared", (60, 90)))
    return emb, ids, p2d


@pytest.mark.parametrize("mode", ["flat", "ivf"])
def test_build_and_search_matches_jax(mode):
    emb, _, _ = _proteins()
    want = jpp.build_and_search(emb, mode, k=40)
    got = tpp.build_and_search(emb, mode, k=40, device="cpu")
    _assert_same((got["scores"], got["hits"]),
                 (want["scores"], want["hits"]))
    assert got["index_bytes"] is None
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        tpp.build_and_search(emb, "lsh", device="cpu")
    with pytest.raises(ValueError):
        tpp.build_and_search(emb, "pq", device="cpu")


def test_evaluate_protein_hits_matches_jax():
    """Equal metrics and flags, -1 hits, duplicate names and queries
    without homologs included."""
    emb, ids, p2d = _proteins()
    ids = ids[:-1] + [ids[0]]  # a repeated name
    homologous = thomologs(p2d)
    assert homologous == jhomologs(p2d)
    homologous.pop("P7")
    rng = np.random.RandomState(1)
    hits = rng.randint(-1, len(ids), size=(len(ids), 30))
    for recall_k in (5, 300):
        want = jpp.evaluate_protein_hits(hits, ids, homologous, recall_k,
                                         return_flags=True)
        got = tpp.evaluate_protein_hits(hits, ids, homologous, recall_k,
                                        return_flags=True)
        assert got[0] == want[0]
        np.testing.assert_array_equal(got[1], want[1])
        np.testing.assert_array_equal(got[2], want[2])


def test_run_matches_jax(tmp_path):
    """The whole pipeline on the IVF index (self-hit repair, homologs,
    AUC1 / recall@300) and on the flat index with the merged ranking and
    the figures."""
    emb, ids, p2d = _proteins()
    npy = tmp_path / "full_sequences.npy"
    np.save(npy, emb)
    want = jpp.run(npy, ids, p2d, index_mode="ivf", k=40)
    got = tpp.run(npy, ids, p2d, index_mode="ivf", k=40, device="cpu")
    for key in ("auc1", "recall@300"):
        assert abs(got[key] - want[key]) <= 1e-9, key
    n = len(ids)
    mm = {"hits": [np.asarray([(i + 1) % n, (i + 2) % n]) for i in range(n)],
          "e_values": [np.asarray([1e-30, 1e-20])] * n}
    evs = [np.arange(40, dtype=np.float64) * 1e-3 + 1e-8] * n
    kw = dict(index_mode="flat", k=40, mmseqs_results=mm, knn_e_values=evs,
              sequence_lengths=np.arange(n) * 7 + 50)
    want = jpp.run(npy, ids, p2d, figures_dir=tmp_path / "jfigs", **kw)
    got = tpp.run(npy, ids, p2d, figures_dir=tmp_path / "tfigs", device="cpu",
                  **kw)
    for key in ("auc1", "recall@300", "merged_auc1"):
        assert abs(got[key] - want[key]) <= 1e-9, key
    made = sorted(p.name for p in (tmp_path / "tfigs").iterdir())
    assert made == sorted(p.name for p in (tmp_path / "jfigs").iterdir())


def test_main_cli_matches_jax_and_reads_its_index(tmp_path):
    """`main <mode> --device cpu` writes the reference's files; the port's
    run over a directory holding the JAX package's index file loads that
    index and gives the same hits."""
    emb = _clustered(300, 24, 6, seed=3).astype(np.float16)
    jdir, tdir = tmp_path / "jax", tmp_path / "torch"
    for d in (jdir, tdir):
        d.mkdir()
        np.save(d / "full_sequences.npy", emb)
    for mode in ("flat", "ivf"):
        jpp.main([mode, "--data", str(jdir), "--k", "20"])
        (tdir / f"full_sequences_{mode}.index").write_bytes(
            (jdir / f"full_sequences_{mode}.index").read_bytes())
        tpp.main([mode, "--data", str(tdir), "--k", "20", "--device", "cpu"])
        names = (f"full_sequences_{mode}_scores.npy",
                 f"full_sequences_{mode}_hits.npy")
        got, want = ((np.load(d / nm) for nm in names) for d in (tdir, jdir))
        _assert_same(tuple(got), tuple(want))
    (tdir / "full_sequences_ivf.index").unlink()
    tpp.main(["ivf", "--data", str(tdir), "--k", "20", "--device", "cpu"])
    assert (tdir / "full_sequences_ivf.index").exists()
    assert isinstance(jio.read_index(tdir / "full_sequences_ivf.index"),
                      jivf.IVFIndex)
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        tpp.main(["hnsw", "--data", str(tdir), "--device", "cpu"])


def test_self_hit_repair_copy_matches_jax():
    rng = np.random.RandomState(2)
    hits = rng.randint(0, 50, size=(50, 12))
    hits[::3, 4] = np.arange(50)[::3]
    scores = -np.sort(-rng.rand(50, 12), axis=1)
    want = janalysis.remove_self_hit_lossy(hits, scores, np.arange(50))
    got = tanalysis.remove_self_hit_lossy(hits, scores, np.arange(50))
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)
