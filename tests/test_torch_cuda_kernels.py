"""The CUDA kernels against their plain PyTorch versions, on the card.

Every test here needs a CUDA device and skips without one. The file imports
no jax (the machine with the card has none), so it runs without the suite's
conftest:

    python -m pytest --noconftest -m cuda tests/test_torch_cuda_kernels.py

Inputs with small-integer entries make every fp32 dot exact whatever the
summation order, so the top-k kernels must then match their plain versions
bit for bit, ties included; on Gaussian data ids may only differ by swaps
of scores within 1e-5.
"""

import numpy as np
import pytest
import torch

from knn_for_homology_tpu_torch.ops import (
    align_cuda,
    exact_cuda,
    flat_cuda,
    ivf_cuda,
    packed_cuda,
    slab_cuda,
)
from knn_for_homology_tpu_torch.ops.align import encode_sequence
from knn_for_homology_tpu_torch.ops.topk import oneshot_topk
from knn_for_homology_tpu_torch.search.flat import FlatIndex
from knn_for_homology_tpu_torch.search.ivf import IVFIndex

pytestmark = pytest.mark.cuda
METRICS = ["cosine", "ip", "l2"]
AAS = "ACDEFGHIKLMNPQRSTVWYX"


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels have no CPU mode")
    return torch.device("cuda")


def _ints(seed, n, q, d, device):
    rng = np.random.RandomState(seed)
    db = rng.randint(-3, 4, size=(n, d)).astype(np.float32)
    qs = rng.randint(-3, 4, size=(q, d)).astype(np.float32)
    return torch.from_numpy(db).to(device), torch.from_numpy(qs).to(device)


def assert_ids_match(got_vals, got_ids, want_vals, want_ids, atol=1e-5):
    """Ids equal, except swaps among scores within `atol` of each other."""
    gv, gi = got_vals.cpu().numpy(), got_ids.cpu().numpy()
    wv, wi = want_vals.cpu().numpy(), want_ids.cpu().numpy()
    np.testing.assert_allclose(gv, wv, rtol=0, atol=atol)
    for r in np.flatnonzero((gi != wi).any(axis=1)):
        for c in np.flatnonzero(gi[r] != wi[r]):
            near = np.abs(wv[r] - wv[r, c]) <= atol
            assert gi[r, c] in set(wi[r][near]), (r, c)


@pytest.mark.parametrize("metric", ["ip", "l2"])
@pytest.mark.parametrize("k", [1, 13, 32])
def test_kernel_a_exact_on_integer_data(cuda, metric, k):
    db, qs = _ints(0, 3001, 70, 40, cuda)
    got = flat_cuda.flat_topk_kernel(db, qs, k, metric=metric)
    want = flat_cuda.flat_topk_plain(db, qs, k, metric=metric)
    torch.testing.assert_close(got[0], want[0], rtol=0, atol=0)
    torch.testing.assert_close(got[1], want[1], rtol=0, atol=0)


def test_kernel_a_k_beyond_n(cuda):
    db, qs = _ints(1, 20, 5, 16, cuda)
    vals, ids = flat_cuda.flat_topk_kernel(db, qs, 25, metric="ip")
    want = flat_cuda.flat_topk_plain(db, qs, 25, metric="ip")
    torch.testing.assert_close(ids, want[1], rtol=0, atol=0)
    assert torch.all(ids[:, 20:] == -1) and torch.all(torch.isneginf(vals[:, 20:]))


@pytest.mark.parametrize("metric", METRICS)
def test_kernel_a_gaussian(cuda, metric):
    rng = np.random.RandomState(2)
    db = torch.from_numpy(rng.randn(20000, 100).astype(np.float32)).to(cuda)
    qs = torch.from_numpy(rng.randn(130, 100).astype(np.float32)).to(cuda)
    if metric == "cosine":
        db = torch.nn.functional.normalize(db, dim=1)
        qs = torch.nn.functional.normalize(qs, dim=1)
    got = flat_cuda.flat_topk_kernel(db, qs, 13, metric=metric)
    want = flat_cuda.flat_topk_plain(db, qs, 13, metric=metric)
    atol = 1e-3 if metric == "l2" else 1e-5  # l2 scores are ~200 here
    assert_ids_match(*got, *want, atol=atol)


@pytest.mark.parametrize("metric", ["ip", "l2"])
def test_kernel_b_buffers_bit_equal_on_integer_data(cuda, metric):
    db, qs = _ints(3, 5000, 45, 24, cuda)
    got = exact_cuda.segment_topr_kernel(db, qs, 256, 6, metric)
    want = exact_cuda.segment_topr_plain(db, qs, 256, 6, metric)
    torch.testing.assert_close(got[0], want[0], rtol=0, atol=0)
    torch.testing.assert_close(got[1], want[1], rtol=0, atol=0)


@pytest.mark.parametrize("k,kw", [(300, {}), (100, {"r_slots": 2})])
def test_exact_topk_ids_equal_full_sort(cuda, k, kw):
    db, qs = _ints(4, 6000, 33, 24, cuda)
    before = exact_cuda.segment_topr_kernel.launches
    vals, ids = exact_cuda.exact_topk(db, qs, k, metric="ip", **kw)
    assert exact_cuda.segment_topr_kernel.launches > before
    want = oneshot_topk(db, qs, k, metric="ip")
    torch.testing.assert_close(ids, want[1], rtol=0, atol=0)
    torch.testing.assert_close(vals, want[0], rtol=0, atol=0)


def _sw_workload(seed, g, k, lq, lt, ragged, min_tl=5, max_tl=60):
    rng = np.random.RandomState(seed)
    qs = [
        "".join(rng.choice(list(AAS), rng.randint(10, lq))) for _ in range(g)
    ]
    q = np.stack([encode_sequence(s, lq) for s in qs])
    t = np.full((g, k, lt), -1, np.int32)
    for gi in range(g):
        for ki in range(k):
            pos = 0
            while True:
                tl = int(rng.randint(min_tl, lt if not ragged else max_tl))
                if pos + tl > lt:
                    break
                s = "".join(rng.choice(list(AAS), tl))
                t[gi, ki, pos : pos + tl] = encode_sequence(s, tl)
                pos += tl + 1
                if not ragged:
                    break
    return torch.from_numpy(q), torch.from_numpy(t)


@pytest.mark.parametrize("convention", ["blast", "mmseqs"])
@pytest.mark.parametrize("segments", [1, 4, 63])
def test_sw_kernel_bit_equal_to_plain(cuda, convention, segments):
    # segments = 63, the planner's cap: 2-4 residue targets fill a
    # 190-column lane with up to 63 of them
    if segments == 63:
        q, t = _sw_workload(5, g=5, k=160, lq=90, lt=190, ragged=True,
                            min_tl=2, max_tl=5)
        assert ((t[..., :-1] >= 0) & (t[..., 1:] < 0)).sum(-1).max() >= 33
    else:
        q, t = _sw_workload(5, g=5, k=160, lq=90, lt=200, ragged=segments > 1)
    q[1, 20] = -1  # interior query pad row: gaps still run through it
    if segments == 1:
        t[2, :, 30] = -1  # interior target pad column
    before = align_cuda.sw_scores_grouped.launches
    got = align_cuda.sw_scores_grouped(
        q.to(cuda), t.to(cuda), convention=convention, segments=segments
    )
    assert align_cuda.sw_scores_grouped.launches == before + 1
    want = align_cuda.sw_scores_grouped_plain(
        q, t, convention=convention, segments=segments
    )
    assert (want > 0).float().mean() > 0.5
    np.testing.assert_array_equal(got.cpu().numpy(), want.numpy())


def _packed_operands(seed, storage, n, q, d, device):
    """Integer-valued operands of one packed storage: every dot is exact,
    and the scale multiplies once, so kernel and plain buffers must be
    bit-equal."""
    rng = np.random.RandomState(seed)
    ints = lambda lo, hi, shape: torch.from_numpy(  # noqa: E731
        rng.randint(lo, hi, size=shape).astype(np.int8)
    ).to(device)
    if storage in ("f32", "bf16"):
        dt = torch.float32 if storage == "f32" else torch.bfloat16
        return dict(queries=ints(-3, 4, (q, d)).to(dt),
                    db=ints(-3, 4, (n, d)).to(dt), storage="native")
    scales = torch.from_numpy(
        rng.uniform(0.001, 0.01, n).astype(np.float32)
    ).to(device)
    if storage == "sq8":
        queries = ints(-3, 4, (q, d)).to(torch.bfloat16)
    else:
        queries = ints(-127, 128, (q, d))
    out = dict(queries=queries, db=ints(-127, 128, (n, d)), scales=scales,
               storage=storage)
    if storage == "sq8-sym2":
        out["q_lo"] = ints(-64, 65, (q, d))
    return out


@pytest.mark.parametrize(
    "storage,metric,d",
    [("f32", "ip", 40), ("f32", "l2", 40), ("bf16", "ip", 40),
     ("bf16", "l2", 40), ("sq8", "ip", 40), ("sq8", "l2", 40),
     ("sq8-sym", "ip", 40), ("sq8-sym2", "ip", 40), ("sq8-sym2", "ip", 30)],
)
def test_packed_kernels_bit_equal_on_integer_data(cuda, storage, metric, d):
    # n not a multiple of W: the last pass is ragged; d = 30 pads the
    # int8 rows to 4-byte words
    ops = _packed_operands(6, storage, 5000, 45, d, cuda)
    name = packed_cuda.KERNEL_OF[ops["storage"]]
    before = packed_cuda.segment_packed_kernel.launches[name]
    got = packed_cuda.segment_packed_kernel(
        db_tile=256, r_slots=7, metric=metric, **ops
    )
    assert packed_cuda.segment_packed_kernel.launches[name] == before + 1
    want = packed_cuda.segment_packed_plain(
        db_tile=256, r_slots=7, metric=metric, **ops
    )
    torch.testing.assert_close(got, want, rtol=0, atol=0)


@pytest.mark.parametrize("q_n", [1, 63, 65, 2200])
@pytest.mark.parametrize("storage,r_slots,d", [
    ("sq8-sym", 7, 48), ("sq8-sym2", 9, 48), ("sq8-sym2", 30, 48),
    ("sq8-sym2", 7, 2048)])
def test_packed_sym_tile_edges(cuda, storage, r_slots, d, q_n):
    # kernel F's 64-query tiles at one query, the edges of a tile and 2200
    # queries (35 query tiles); the routes: query rows resident with
    # 32-lane tiles (R = 7, 9) or 16-lane tiles (R = 30); d = 2048 streams
    # the query rows with 64-lane tiles
    ops = _packed_operands(14, storage, 5000, q_n, d, cuda)
    got = packed_cuda.segment_packed_kernel(
        db_tile=256, r_slots=r_slots, metric="ip", **ops
    )
    want = packed_cuda.segment_packed_plain(
        db_tile=256, r_slots=r_slots, metric="ip", **ops
    )
    torch.testing.assert_close(got, want, rtol=0, atol=0)


@pytest.mark.parametrize("r_slots", [25, 26, 35, 130])
@pytest.mark.parametrize("storage", ["f32", "sq8-sym2"])
def test_packed_large_r_routes(cuda, storage, r_slots):
    # f32 (kernel D): R = 25 is the largest R whose slots fit shared
    # memory; R ≥ 26: slots in the output buffer (R = 130: more slots than
    # passes, so empty ones stay INT32_MIN); sym2 (kernel F): 16-lane tiles
    # with resident query rows at R = 25 and 26, slots in device memory
    # from R = 35
    ops = _packed_operands(7, storage, 30000, 40, 24, cuda)
    got = packed_cuda.segment_packed_kernel(
        db_tile=256, r_slots=r_slots, metric="ip", **ops
    )
    want = packed_cuda.segment_packed_plain(
        db_tile=256, r_slots=r_slots, metric="ip", **ops
    )
    torch.testing.assert_close(got, want, rtol=0, atol=0)


def test_packed_topk_high_recall_plan(cuda):
    # the planner's R ≥ 32 at k = 6000 of 10000, target 0.999
    w, r = exact_cuda.plan(10000, 6000, 256, exact=False, recall_target=0.999)
    assert r >= 32
    db, qs = _ints(8, 10000, 20, 24, cuda)
    for storage in ("native", "sq8-sym2"):
        got = packed_cuda.packed_topk(
            db, qs, 6000, metric="ip", recall_target=0.999, storage=storage
        )
        want = packed_cuda.packed_topk(
            db.cpu(), qs.cpu(), 6000, metric="ip", recall_target=0.999,
            storage=storage,
        )
        torch.testing.assert_close(got[1].cpu(), want[1], rtol=0, atol=0)
        torch.testing.assert_close(got[0].cpu(), want[0], rtol=0, atol=0)


def _launches(kernel):
    if kernel == "A":
        return flat_cuda.flat_topk_kernel.launches
    if kernel == "B":
        return exact_cuda.segment_topr_kernel.launches
    return packed_cuda.segment_packed_kernel.launches[kernel]


@pytest.mark.parametrize(
    "backend,metric,k,kernel",
    [("auto", "ip", 13, "A"), ("approx", "ip", 13, "A"),
     ("auto", "ip", 100, "B"), ("approx", "l2", 100, "D"),
     ("sq8", "ip", 13, "F"), ("sq8", "l2", 100, "E")],
)
def test_flat_index_backends_launch_their_kernel(cuda, backend, metric, k,
                                                 kernel):
    # each backend reaches its kernel on the card (approx with k ≤ 32 is
    # kernel A's exact search), and equals the CPU's plain versions on
    # integer data, where every kernel is bit-equal to its plain version
    db, qs = (t.numpy() for t in _ints(9, 3000, 20, 64, "cpu"))
    before = _launches(kernel)
    got = FlatIndex(metric, backend=backend, device="cuda").add(db).search(qs, k)
    assert _launches(kernel) > before
    want = FlatIndex(metric, backend=backend, device="cpu").add(db).search(qs, k)
    np.testing.assert_array_equal(got[1], want[1])
    np.testing.assert_array_equal(got[0], want[0])


def _slab_table(seed, c, d, fill, device, deg_p=128, degree=None):
    """Packed slabs of Gaussian rows: `c` groups of `fill` members each
    (the rest padding), d not a multiple of 128 so the lane padding runs."""
    rng = np.random.RandomState(seed)
    degree = degree or deg_p
    n = c * fill
    db = torch.from_numpy(rng.randn(n, d).astype(np.float32))
    members = np.full((c, degree), -1, np.int32)
    members[:, :fill] = rng.permutation(n).reshape(c, fill)
    packed = slab_cuda.pack_neighbours(db, torch.from_numpy(members), deg_p)
    return db.to(device), tuple(t.to(device) for t in packed), rng


def _check_kernel_j(device, budget, r_slots, two_level, q_n, cells_n=300,
                    d=96):
    """Kernel J's buffer for `q_n` of the table's own rows against the
    union of `budget` random cells equals the plain version's; one launch."""
    db, (pv, pi, sc), rng = _slab_table(10, cells_n, d, 90, device)
    cells = torch.from_numpy(
        rng.choice(cells_n, budget, replace=False).astype(np.int32)).to(device)
    q = torch.nn.functional.pad(db[:q_n], (0, 32))  # to the table's width
    q8, q_lo, _ = packed_cuda.quantize_queries(q, two_level)
    tile = min(8, budget) * 128
    before = ivf_cuda.segment_packed_indirect_kernel.launches
    got = ivf_cuda.segment_packed_indirect_kernel(q8, pv, sc, pi, cells, tile,
                                                  r_slots, q_lo)
    assert ivf_cuda.segment_packed_indirect_kernel.launches == before + 1
    want = ivf_cuda.segment_packed_indirect_plain(q8, pv, sc, pi, cells, tile,
                                                  r_slots, q_lo)
    torch.testing.assert_close(got, want, rtol=0, atol=0)


@pytest.mark.parametrize(
    "budget,r_slots,two_level,q_n",
    [(256, 5, False, 70), (256, 5, True, 70), (4, 3, True, 70),
     (16, 30, True, 70), (2, 4, True, 1), (8, 4, False, 63),
     (32, 5, True, 65), (256, 4, True, 600), (64, 4, False, 600)],
)
def test_kernel_j_bit_equal_to_plain(cuda, budget, r_slots, two_level, q_n):
    # rows of 128 int8 columns, so the query rows stay in shared memory:
    # budget < 8 narrows the tile (W = budget·128); R = 30 narrows the lane
    # tile from 32 to 16 (the slots of 32 lanes leave too little room for
    # the ring); 1, 63 and 65 queries sit at the 64-query tile's edges, 600
    # make ten query tiles; every pass moves each lane tile to another cell
    # of the table
    _check_kernel_j(cuda, budget, r_slots, two_level, q_n)


@pytest.mark.parametrize(
    "budget,r_slots,two_level,cells_n,d",
    [(400, 32, True, 400, 96), (400, 40, False, 400, 96),
     (40, 4, True, 40, 2016), (40, 4, False, 40, 3040)],
)
def test_kernel_j_streamed_routes(cuda, budget, r_slots, two_level, cells_n,
                                  d):
    # where the query rows do not stay in shared memory, each ring stage
    # streams their box beside a 64-lane box of one cell's rows: at d = 128
    # when R's slots leave no room for them (R = 32 two-level, 40 one-level;
    # the slots then live in the output buffer, 50 passes against R), and
    # at d = 2048 (two-level) or 3072 (one-level) with R = 4 (slots in
    # shared memory, 5 passes)
    _check_kernel_j(cuda, budget, r_slots, two_level, 65, cells_n, d)


@pytest.mark.parametrize("compute,k", [("sym", 10), ("sym2", 10),
                                       ("sym2", 1000)])
def test_ivf_union_topk_equals_cpu(cuda, compute, k):
    # k = 1000 exceeds the 2 cells' real rows: (-inf, -1, -1) padding
    db, (pv, pi, sc), _ = _slab_table(11, 40, 96, 60, cuda)
    for cells in (torch.arange(16, dtype=torch.int32),
                  torch.tensor([3, 7], dtype=torch.int32)):
        got = ivf_cuda.ivf_union_topk(pv, sc, pi, cells.to(cuda), db[:50], k,
                                      compute=compute)
        want = ivf_cuda.ivf_union_topk(pv.cpu(), sc.cpu(), pi.cpu(), cells,
                                       db[:50].cpu(), k, compute=compute)
        for g, w in zip(got, want):
            torch.testing.assert_close(g.cpu(), w, rtol=0, atol=0)
    assert bool((got[2][:, 120:] == -1).all())


@pytest.mark.parametrize("deg_p,degree,d", [(128, 128, 96), (32, 20, 96),
                                            (128, 100, 1024)])
def test_kernel_k_matches_plain(cuda, deg_p, degree, d):
    # pad lanes ≥ deg_p are -inf; ids equal; sums in another order than
    # the plain version's: 1e-5 relative
    _, (pv, pi, sc), rng = _slab_table(12, 50, d, min(degree, 20), cuda,
                                       deg_p, degree)
    sel = torch.from_numpy(rng.randint(0, 50, size=(33, 7)).astype(
        np.int32)).to(cuda)
    q = torch.from_numpy(rng.randn(33, d).astype(np.float32)).to(cuda)
    before = slab_cuda.beam_expand.launches
    got_s, got_n = slab_cuda.beam_expand(sel, q, pv, pi, sc, deg_p)
    assert slab_cuda.beam_expand.launches == before + 1
    want_s, want_n = slab_cuda.beam_expand_plain(sel, q, pv, pi, sc, deg_p)
    assert torch.equal(got_n, want_n)
    assert torch.equal(torch.isneginf(got_s), torch.isneginf(want_s))
    assert bool(torch.isneginf(got_s[:, :, deg_p:]).all())
    fin = torch.isfinite(want_s)
    torch.testing.assert_close(got_s[fin], want_s[fin], rtol=1e-5,
                               atol=1e-5 * float(want_s[fin].abs().max()))


@pytest.mark.parametrize("n_q,k,kernel", [(100, 10, "K"), (600, 10, "J"),
                                          (600, 200, "J")])
def test_ivf_index_on_the_card_equals_cpu(cuda, n_q, k, kernel):
    # one index state on both devices: the per-probe path (K) below
    # UNION_MIN_Q queries, the union scan (J) above; ids equal but near-ties
    # (K's and the rescore's fp32 sums)
    rng = np.random.RandomState(13)
    centers = rng.randn(32, 96).astype(np.float32)
    db = centers[rng.randint(0, 32, 2048)] + 0.08 * rng.randn(
        2048, 96).astype(np.float32)
    cpu = IVFIndex(metric="cosine", nprobe=4, device="cpu").add(db)
    card = IVFIndex.from_state(cpu.state(), device="cuda")
    counter = (slab_cuda.beam_expand if kernel == "K"
               else ivf_cuda.segment_packed_indirect_kernel)
    before = counter.launches
    got = card.search(db[:n_q], k)
    assert counter.launches > before
    (gv, gi), (wv, wi) = got, cpu.search(db[:n_q], k)
    np.testing.assert_allclose(gv, wv, rtol=0, atol=1e-5)
    for r, c in zip(*np.nonzero(gi != wi)):
        # a near-tie swap, or a near-tie at the k-th place
        near = np.abs(wv[r] - wv[r, c]) <= 1e-5
        assert gi[r, c] in set(wi[r][near]) or near[-1], (r, c)
