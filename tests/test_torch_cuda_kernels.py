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

import dataclasses

import numpy as np
import pytest
import torch

from knn_for_homology_tpu_torch.models import elmo, xlnet
from knn_for_homology_tpu_torch.models.registry import get_embedder
from knn_for_homology_tpu_torch.ops import (
    _build,
    align_cuda,
    exact_cuda,
    ffn_cuda,
    flat_cuda,
    ivf_cuda,
    lstm_cuda,
    packed_cuda,
    relattn_cuda,
    slab_cuda,
)
from knn_for_homology_tpu_torch.ops import align as align_ops
from knn_for_homology_tpu_torch.ops.align import encode_sequence
from knn_for_homology_tpu_torch.ops.ffn import fused_ffn_plain
from knn_for_homology_tpu_torch.ops.lstm import lstmp_bidir_plain
from knn_for_homology_tpu_torch.ops.distance import similarity_block
from knn_for_homology_tpu_torch.ops.relative_attention import (
    relative_attention_plain,
)
from knn_for_homology_tpu_torch.ops.topk import oneshot_topk, plain_topk
from knn_for_homology_tpu_torch.search import graph as graph_mod
from knn_for_homology_tpu_torch.search.flat import FlatIndex
from knn_for_homology_tpu_torch.search.graph import GraphIndex
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


# Kernel B's routes (ops/exact_cuda.py:topr_plan): Q not a multiple of 64
# and up to 2200 (35 query tiles), n not a multiple of W, W = 256 and 1024,
# R = 1, 2, 16 (slots in shared memory, five to eight ring stages) and R =
# 32, 64 (slots in the output buffers), d = 33 and 45 (zero-padded to whole
# 16-byte rows) up to 1024
@pytest.mark.parametrize("q_n,n,w,r_slots,d,metric", [
    (70, 5000, 256, 16, 33, "l2"),
    (1, 5000, 256, 1, 1024, "cosine"),
    (130, 9000, 1024, 16, 40, "ip"),
    (64, 3000, 256, 1, 1024, "l2"),
    (65, 3001, 256, 32, 45, "l2"),
    (200, 20000, 1024, 64, 100, "cosine"),
    (1500, 3000, 256, 2, 40, "l2"),
    (2200, 3000, 256, 2, 40, "ip"),
])
def test_kernel_b_routes_bit_equal_on_integer_data(cuda, q_n, n, w, r_slots,
                                                   d, metric):
    db, qs = _ints(5, n, q_n, d, cuda)
    got = exact_cuda.segment_topr_kernel(db, qs, w, r_slots, metric)
    want = exact_cuda.segment_topr_plain(db, qs, w, r_slots, metric)
    torch.testing.assert_close(got[0], want[0], rtol=0, atol=0)
    torch.testing.assert_close(got[1], want[1], rtol=0, atol=0)


def _gaussian_cosine(seed, n, q, d, device):
    rng = np.random.RandomState(seed)
    db = torch.from_numpy(rng.randn(n, d).astype(np.float32)).to(device)
    qs = torch.from_numpy(rng.randn(q, d).astype(np.float32)).to(device)
    return (torch.nn.functional.normalize(db, dim=1),
            torch.nn.functional.normalize(qs, dim=1))


# Gaussian cosine rows at d = 1024: the kernels' 3xTF32 products drop
# small.small (~2^-22 of a product) and sum in another order than the plain
# version's fp32 matmul; the cosines then differ by ~1e-7, so ids may only
# swap among scores within 1e-5 (the near-tie tolerance of the other tests)
def test_kernel_a_gaussian_cosine_d1024(cuda):
    db, qs = _gaussian_cosine(6, 20000, 130, 1024, cuda)
    got = flat_cuda.flat_topk_kernel(db, qs, 13, metric="cosine")
    want = flat_cuda.flat_topk_plain(db, qs, 13, metric="cosine")
    assert_ids_match(*got, *want, atol=1e-5)


def test_kernel_b_gaussian_cosine_d1024(cuda):
    db, qs = _gaussian_cosine(7, 20000, 130, 1024, cuda)
    w, r = 256, 16
    got = exact_cuda.epilogue(
        *exact_cuda.segment_topr_kernel(db, qs, w, r, "cosine"), 300, w, r)
    want = exact_cuda.epilogue(
        *exact_cuda.segment_topr_plain(db, qs, w, r, "cosine"), 300, w, r)
    assert_ids_match(got[0], got[1], want[0], want[1], atol=1e-5)


# Unnormalised Gaussian rows, the inputs of test_kernel_a_gaussian: B's
# 3xTF32 scores and the plain fp32 route's both round, in other orders, and
# may sit several ulps apart (3.05e-5 at inner products up to 57;
# scripts/torch_tf32x3_accuracy.py). So B is held to fp64: no score further
# from the fp64 similarity of its id than the plain route's farthest score
# is, plus one ulp of the largest |score|; ids those of the fp64 sort but
# for swaps among scores within twice that (each side of a swap may be off
# by the tolerance)
@pytest.mark.parametrize("metric", ["ip", "l2"])
def test_kernel_b_gaussian(cuda, metric):
    rng = np.random.RandomState(2)
    db = torch.from_numpy(rng.randn(20000, 100).astype(np.float32)).to(cuda)
    qs = torch.from_numpy(rng.randn(130, 100).astype(np.float32)).to(cuda)
    w, r, k = 256, 16, 300
    got_v, got_i, suspect = exact_cuda.epilogue(
        *exact_cuda.segment_topr_kernel(db, qs, w, r, metric), k, w, r)
    plain_v, plain_i, _ = exact_cuda.epilogue(
        *exact_cuda.segment_topr_plain(db, qs, w, r, metric), k, w, r)
    assert not bool(suspect.any())
    exact = similarity_block(qs.double(), db.double(), metric)

    def off(vals, ids):
        return float((vals.double() - exact.gather(1, ids.long())).abs().max())

    ulp = float(np.spacing(np.float32(plain_v.abs().max().item())))
    tol = off(plain_v, plain_i) + ulp
    assert off(got_v, got_i) <= tol
    want_v, want_i = oneshot_topk(db.double(), qs.double(), k, metric=metric)
    assert_ids_match(got_v.double(), got_i, want_v, want_i, atol=2 * tol)


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


def _sw_edge_case(case, seed=21):
    """(q [G, Lq], t [G, K, Lt], segments) of one edge of kernel C's warp
    wavefront: 256-row strips (32 threads x 8 rows), live-lane lists,
    separators, pads, and launches of more lanes than the card holds warps
    (each warp then takes several lanes of one or two strips, in turn)."""
    rng = np.random.RandomState(seed)

    def codes(n):
        return encode_sequence("".join(rng.choice(list(AAS), n)), n)

    lq_eff, g, k, lt, segments = {
        "lq1": (1, 3, 6, 40, 1), "strip": (256, 2, 5, 90, 1),
        "strip+1": (257, 2, 5, 90, 1), "lq2048": (2048, 1, 4, 160, 1),
        "lq3500": (3500, 1, 3, 120, 1), "empty_lanes": (300, 4, 9, 70, 1),
        "pad_row": (600, 2, 4, 80, 1), "lt1": (180, 2, 5, 1, 1),
        "ragged_strips": (700, 2, 6, 240, 8), "seg63": (300, 2, 3, 190, 63),
        "many_lanes": (300, 2048, 13, 48, 1),
        "many_ragged": (300, 2048, 13, 64, 8),
    }[case]
    lq = -(-lq_eff // 128) * 128  # the planner's bucket
    q = np.full((g, lq), -1, np.int32)
    t = np.full((g, k, lt), -1, np.int32)
    for gi in range(g):
        # many lanes: queries of 1 to 300 residues, one strip or two
        n_q = (int(rng.randint(1, lq_eff + 1)) if case.startswith("many")
               else lq_eff)
        q[gi, :n_q] = codes(n_q)
        for ki in range(k):
            if segments == 1:
                n = lt if case == "lt1" else int(rng.randint(lt // 2, lt + 1))
                t[gi, ki, :n] = codes(n)
                continue
            pos = 0
            lo, hi = (2, 5) if segments == 63 else (10, 50)
            while True:
                n = int(rng.randint(lo, hi))
                if pos + n > lt:
                    break
                t[gi, ki, pos : pos + n] = codes(n)
                pos += n + 1
    if case == "empty_lanes":
        t[:, 1::2] = -1  # empty lanes between live ones
        t[2] = -1  # an all-empty group
    if case == "pad_row":
        q[:, [0, 255, 256, 400]] = -1  # interior query pad rows, at a strip edge
        t[0, 1, 7] = -1  # an interior target pad column
    if segments == 63:
        assert ((t[..., :-1] >= 0) & (t[..., 1:] < 0)).sum(-1).max() >= 33
    return torch.from_numpy(q), torch.from_numpy(t), segments


@pytest.mark.parametrize("convention", ["blast", "mmseqs"])
@pytest.mark.parametrize("case", [
    "lq1", "strip", "strip+1", "lq2048", "lq3500", "empty_lanes", "pad_row",
    "lt1", "ragged_strips", "seg63", "many_lanes", "many_ragged"])
def test_sw_kernel_edges_bit_equal(cuda, convention, case):
    # Lq = 1; a query of exactly one strip and one row past it; 2048 and
    # 3500 rows (8 and 14 strips through the boundary scratch); empty lanes
    # between live ones and an all-empty group (nothing in the live list);
    # interior query pad rows at a strip edge; Lt = 1; ragged lanes across
    # strips; 63 segments; 2048 x 13 short classic or ragged lanes, more
    # than the persistent grid's warps (each reuses its boundary scratch and
    # segment slots from lane to lane)
    q, t, segments = _sw_edge_case(case)
    kw = dict(convention=convention, segments=segments)
    plain_on = "cpu"
    if case.startswith("many"):
        g, k = t.shape[:2]
        assert g * k > _build.library().knn_sw_grouped_warps(g, k)
        # the plain version on the card (its float32 state holds exact
        # integers, so either device gives the same scores; the CPU takes
        # ~20 s a call at 2048 groups)
        plain_on = cuda
    want = align_cuda.sw_scores_grouped_plain(
        q.to(plain_on), t.to(plain_on), **kw).cpu()
    for codes in (t, t.to(torch.int8)):  # any integer dtype, int8 as is
        got = align_cuda.sw_scores_grouped(q.to(cuda), codes.to(cuda), **kw)
        np.testing.assert_array_equal(got.cpu().numpy(), want.numpy())
    assert float(want.max()) > 0
    if case == "empty_lanes":
        assert float(want[:, 1::2].abs().max()) == 0.0
        assert float(want[2].abs().max()) == 0.0


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


@pytest.mark.parametrize("q_n", [1, 63, 65, 2200])
@pytest.mark.parametrize("d,r_slots", [(40, 7), (1000, 7), (40, 30),
                                       (1000, 30)])
@pytest.mark.parametrize("storage,metric", [
    ("bf16", "ip"), ("bf16", "l2"), ("sq8", "ip"), ("sq8", "l2")])
def test_packed_bf16_tile_edges(cuda, storage, metric, d, r_slots, q_n):
    # kernels D (bf16) and E on bf16 wgmma at the 64-query tile's edges and
    # past 32 query tiles; d = 40 pads to 48 (one box) and keeps the query
    # rows resident (32- or 16-lane tiles), d = 1000 pads to 1008 (16 bf16
    # boxes: resident at R = 7, streamed 64-lane tiles with the slots in
    # device memory at R = 30); E widens its int8 boxes to bf16 on the way
    ops = _packed_operands(15, storage, 5000, q_n, d, cuda)
    name = packed_cuda.KERNEL_OF[ops["storage"]]
    before = packed_cuda.segment_packed_kernel.launches[name]
    got = packed_cuda.segment_packed_kernel(
        db_tile=256, r_slots=r_slots, metric=metric, **ops
    )
    assert packed_cuda.segment_packed_kernel.launches[name] == before + 1
    want = packed_cuda.segment_packed_plain(
        db_tile=256, r_slots=r_slots, metric=metric, **ops
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


def test_passes_per_product_plan(cuda):
    # the plan's passes a product (csrc/segment_packed.cu plan_group): more
    # than one for F (sym, sym2) at the all-vs-all's plan and for J (sym) at
    # the IVF union scan's; always one for D (fp32, bf16) and E
    w, r, _ = packed_cuda.packed_plan(131080, 1000, recall_target=0.98)
    _, r_hi, _ = packed_cuda.packed_plan(131080, 1000, recall_target=0.995)
    assert packed_cuda.passes_per_product("sq8-sym", 131080, 1024, w, r) > 1
    assert packed_cuda.passes_per_product("sq8-sym2", 131080, 1024, w,
                                          r_hi) > 1
    tile, r_j, _ = ivf_cuda.union_plan(256, 1000, 0.995)
    assert ivf_cuda.passes_per_product(256, 1024, tile, r_j, False) > 1
    for storage, dtype in (("native", torch.float32),
                           ("native", torch.bfloat16), ("sq8", None)):
        for r_slots in (r, r_hi):
            assert packed_cuda.passes_per_product(
                storage, 131080, 1024, w, r_slots, dtype) == 1


@pytest.mark.parametrize("storage,r_slots,d", [
    ("sq8-sym", 7, 48), ("sq8-sym", 7, 1024), ("sq8-sym", 16, 1024),
    ("sq8-sym2", 9, 1024)])
@pytest.mark.parametrize("case", range(5))
def test_packed_grouped_pass_counts(cuda, storage, r_slots, d, case):
    # kernel F at 1, P - 1, P, P + 1 and 2P + 1 passes of its plan's P
    # passes a product: fewer than P passes take one pass a product, a last
    # group short of P passes masks the rest; 70 queries (a ragged query
    # tile); d = 48 (one box: a group's passes all entered after its one
    # stage) and 1024 (a pass entered after each stage); 32-lane tiles, and
    # 16-lane ones (sym R = 16, sym2 R = 9)
    group = packed_cuda.passes_per_product(storage, 64 * 256, d, 256, r_slots)
    assert group > 1
    passes = [1, group - 1, group, group + 1, 2 * group + 1][case]
    n = passes * 256
    want_group = group if passes >= group else 1
    assert packed_cuda.passes_per_product(storage, n, d, 256,
                                          r_slots) == want_group
    ops = _packed_operands(30 + case, storage, n, 70, d, cuda)
    by_group = packed_cuda.segment_packed_kernel.launches_by_group["F"]
    before = by_group.get(want_group, 0)
    got = packed_cuda.segment_packed_kernel(
        db_tile=256, r_slots=r_slots, metric="ip", **ops)
    assert by_group[want_group] == before + 1
    want = packed_cuda.segment_packed_plain(
        db_tile=256, r_slots=r_slots, metric="ip", **ops)
    torch.testing.assert_close(got, want, rtol=0, atol=0)


@pytest.mark.parametrize("n_valid", [None, 2000, 2500])
@pytest.mark.parametrize("storage,r_slots", [("sq8-sym", 7), ("sq8-sym2", 9)])
def test_packed_grouped_ragged_columns(cuda, storage, r_slots, n_valid):
    # 2P + 1 passes, the last ragged (n not a multiple of W), and columns
    # from n_valid on masked: inside a full group (2000), in the last (2500)
    group = packed_cuda.passes_per_product(storage, 64 * 256, 1024, 256,
                                           r_slots)
    n = (2 * group + 1) * 256 - 100
    ops = _packed_operands(40, storage, n, 130, 1024, cuda)
    kw = dict(db_tile=256, r_slots=r_slots, metric="ip", n_valid=n_valid,
              **ops)
    got = packed_cuda.segment_packed_kernel(**kw)
    torch.testing.assert_close(got, packed_cuda.segment_packed_plain(**kw),
                               rtol=0, atol=0)


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


def test_flat_search_pipelined_copies(cuda, monkeypatch):
    """A search of three blocks (the block size patched to 1000 queries)
    stages its queries through page-locked buffers and copies on a side
    stream: it returns page-locked arrays of its own, which a second search
    leaves untouched, equal bit for bit to the one-block route's."""
    rng = np.random.RandomState(11)
    db = rng.randn(20000, 256).astype(np.float32)
    qs = rng.randn(2500, 256).astype(np.float32)
    index = FlatIndex("cosine", backend="sq8", device="cuda").add(db)
    want = index.search(qs, 300)
    monkeypatch.setattr(FlatIndex, "_block_rows", lambda self, k: 1000)
    before = FlatIndex.copy_routes["pipelined"]
    first = index.search(qs, 300)
    assert FlatIndex.copy_routes["pipelined"] == before + 1
    kept = [a.copy() for a in first]
    second = index.search(qs[::-1].copy(), 300)
    for a, b, c, w in zip(first, kept, second, want):
        assert torch.from_numpy(a).is_pinned()
        assert a.dtype == w.dtype and a.shape == w.shape
        assert not np.shares_memory(a, c)
        np.testing.assert_array_equal(a, b)
        np.testing.assert_array_equal(a, w)
        np.testing.assert_array_equal(c, w[::-1])


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


@pytest.mark.parametrize("q_n", [1, 70])
@pytest.mark.parametrize("case", range(3))
def test_kernel_j_grouped_tail(cuda, case, q_n):
    # J (sym) with 1024-lane tiles over P, P + 1 and 2P + 1 passes of its
    # plan's P passes a product (a short last group, its columns masked),
    # each pass's box at its own cell, 38 of 128 ids a cell -1
    group = ivf_cuda.passes_per_product(64, 128, 1024, 4, False)
    assert group > 1
    budget = 8 * [group, group + 1, 2 * group + 1][case]
    assert ivf_cuda.passes_per_product(budget, 128, 1024, 4, False) == group
    by_group = ivf_cuda.segment_packed_indirect_kernel.launches_by_group
    before = by_group.get(group, 0)
    _check_kernel_j(cuda, budget, 4, False, q_n)
    assert by_group[group] == before + 1


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


def _k_sel(case, n_nodes, rng):
    """[Q, E] node ids of one sharing pattern (kernel K tiles up to
    slab_cuda.NQ = 64 pairs of one node)."""
    if case == "random":
        return rng.randint(0, n_nodes, size=(33, 7))
    if case == "one_node":  # every query probes one node: 10 tiles
        return np.full((150, 4), n_nodes // 2)
    if case == "crowded":  # one node probed by 150 queries: 3 tiles
        sel = rng.randint(0, n_nodes, size=(150, 5))
        sel[:, 0] = 7
        return sel
    if case == "each_once":  # every node probed once: tiles of one pair
        return rng.permutation(n_nodes).reshape(10, n_nodes // 10)
    if case == "repeats":  # a node repeated within a query's selection
        sel = rng.randint(0, n_nodes, size=(40, 6))
        sel[:, 2] = sel[:, 0]
        sel[::3, 5] = sel[::3, 0]
        return sel
    if case == "out_of_range":  # ids the kernel clamps to the table
        sel = rng.randint(0, n_nodes, size=(30, 6))
        sel[:, 1] = -3
        sel[::2, 4] = n_nodes
        sel[1::2, 5] = n_nodes + 100
        return sel
    raise ValueError(case)


K_SHAPES = [(128, 128, 96), (32, 20, 96), (128, 100, 1024), (32, 32, 1024),
            (96, 90, 1024)]
K_CASES = [
    pytest.param(*shape, case, id="-".join(
        map(str, shape if case == "random" else (case, *shape))))
    for case in ("random", "one_node", "crowded", "each_once", "repeats",
                 "out_of_range")
    for shape in K_SHAPES
]


def _check_kernel_k(monkeypatch, device, deg_p, degree, d, case, route,
                    reps=1):
    """Kernel K held to `route` on one sharing pattern of a 50-node table,
    `reps` times on the same inputs: ids and -inf lanes equal to plain,
    sims within 1e-5 of the largest |sim|; one launch a call."""
    monkeypatch.setattr(slab_cuda, "slab_route", lambda *shape: route)
    _, (pv, pi, sc), rng = _slab_table(12, 50, d, min(degree, 20), device,
                                       deg_p, degree)
    sel = torch.from_numpy(_k_sel(case, 50, rng).astype(np.int32)).to(device)
    q = torch.from_numpy(rng.randn(sel.shape[0], d).astype(np.float32)).to(
        device)
    want_s, want_n = slab_cuda.beam_expand_plain(sel, q, pv, pi, sc, deg_p)
    fin = torch.isfinite(want_s)
    for _ in range(reps):
        before = slab_cuda.beam_expand.launches
        on_route = slab_cuda.beam_expand.routes[route]
        got_s, got_n = slab_cuda.beam_expand(sel, q, pv, pi, sc, deg_p)
        assert slab_cuda.beam_expand.launches == before + 1
        assert slab_cuda.beam_expand.routes[route] == on_route + 1
        assert torch.equal(got_n, want_n)
        assert torch.equal(torch.isneginf(got_s), torch.isneginf(want_s))
        assert bool(torch.isneginf(got_s[:, :, deg_p:]).all())
        torch.testing.assert_close(got_s[fin], want_s[fin], rtol=1e-5,
                                   atol=1e-5 * float(want_s[fin].abs().max()))


@pytest.mark.parametrize("deg_p,degree,d,case", K_CASES)
def test_kernel_k_matches_plain(monkeypatch, cuda, deg_p, degree, d, case):
    # pad lanes >= deg_p are -inf; ids equal; sums in another order than
    # the plain version's (two TF32 products): 1e-5 of the largest |sim|.
    # Sharing from every query on one node (tiles of 64 pairs) to every
    # node once (n8 tiles of one pair); deg_p 96 leaves rows 96-127 dead,
    # deg_p 32 rows 32-63
    _check_kernel_k(monkeypatch, cuda, deg_p, degree, d, case, "tiles")


@pytest.mark.parametrize("deg_p,degree,d,case", K_CASES)
def test_kernel_k_pair_route_matches_plain(monkeypatch, cuda, deg_p, degree,
                                           d, case):
    # the pair route (a block a query, fp32 FFMA) on the same patterns
    _check_kernel_k(monkeypatch, cuda, deg_p, degree, d, case, "pairs")


@pytest.mark.parametrize("d", [96, 1024])
@pytest.mark.parametrize("case", ["crowded", "out_of_range"])
def test_kernel_k_repeated_wide_tiles(monkeypatch, cuda, case, d):
    # deg_p 128, tiles of 22-64 pairs: the wide launch's two warpgroups
    # share each query stage, so a stage written before the other
    # warpgroup's products are done shows as wrong rows in some runs;
    # every one of 50 runs must match
    _check_kernel_k(monkeypatch, cuda, 128, 128, d, case, "tiles", reps=50)


@pytest.mark.parametrize("case", ["random", "one_node", "crowded",
                                  "each_once", "repeats", "out_of_range"])
def test_kernel_k_plan_equals_plain(cuda, case):
    # the tile kernel claims its slots in no fixed order: compared by start
    sel = torch.from_numpy(_k_sel(case, 50, np.random.RandomState(3)).astype(
        np.int32))
    got = slab_cuda.slab_plan(sel.to(cuda), 50)
    want = slab_cuda.slab_plan(sel, 50)
    for g, w in zip(got[:2], want[:2]):
        assert torch.equal(g.cpu(), w)

    def rows(tiles, kind):  # the wide (0) or narrow (1) list
        n, at = int(tiles[kind]), 2 + (tiles.numel() - 2) // 2 * kind
        return sorted(map(tuple, tiles[at:at + 2 * n].view(n, 2).tolist()))

    for kind in (0, 1):
        assert rows(got[2].cpu(), kind) == rows(want[2], kind)


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


def _graph_rows(n=4096, d=128, seed=17):
    """n rows around 64 centres, d a multiple of 128 (the packed route's
    rule)."""
    rng = np.random.RandomState(seed)
    centers = rng.randn(64, d).astype(np.float32)
    return (centers[rng.randint(0, 64, n)]
            + 0.3 * rng.randn(n, d)).astype(np.float32)


def test_graph_build_through_kernel_b(cuda, monkeypatch):
    # the exact kNN graph (k = degree + 1 = 43 > 32: kernel B) against the
    # same build over the plain exact top-k on the card: the long-range
    # edges equal, the kNN columns equal but near-ties of B's 3xTF32
    # products (fp64 similarities within 1e-5, rank by rank)
    db = _graph_rows()
    before = exact_cuda.segment_topr_kernel.launches
    card = GraphIndex(degree=42, device="cuda").add(db)
    assert exact_cuda.segment_topr_kernel.launches > before
    monkeypatch.setattr(graph_mod, "flat_topk",
                        lambda x, q, k, metric: plain_topk(x, q, k, metric))
    plain = GraphIndex(degree=42, device="cuda").add(db)
    got, want = card._graph.cpu().numpy(), plain._graph.cpu().numpy()
    np.testing.assert_array_equal(got[:, -4:], want[:, -4:])
    x = card._db.cpu().double().numpy()
    rows = np.flatnonzero((got != want).any(axis=1))
    assert rows.size <= 0.02 * len(db)
    for r in rows:
        np.testing.assert_allclose(np.sort(x[got[r, :-4]] @ x[r]),
                                   np.sort(x[want[r, :-4]] @ x[r]),
                                   rtol=0, atol=1e-5)


@pytest.mark.parametrize("route", slab_cuda.ROUTES)
def test_graph_search_on_the_card_equals_plain(cuda, monkeypatch, route):
    # K held to one route, then the same index searched with K's plain
    # version on the card, and on the CPU: scores within 1e-5, ids equal
    # but near-ties (K's sums can turn a beam at a near-tie)
    db = _graph_rows()
    index = GraphIndex(degree=42, beam_width=64, packed="always",
                       device="cuda").add(db)
    monkeypatch.setattr(slab_cuda, "slab_route", lambda *shape: route)
    before = slab_cuda.beam_expand.routes[route]
    got = index.search(db[:300], 20)
    assert slab_cuda.beam_expand.routes[route] > before
    cpu = GraphIndex.from_state(index.state(), device="cpu").search(
        db[:300], 20)
    monkeypatch.setattr(slab_cuda, "beam_expand", slab_cuda.beam_expand_plain)
    for want in (index.search(db[:300], 20), cpu):
        (gv, gi), (wv, wi) = got, want
        np.testing.assert_allclose(gv, wv, rtol=0, atol=1e-5)
        assert (gi != wi).mean() <= 0.01
        for r, c in zip(*np.nonzero(gi != wi)):
            near = np.abs(wv[r] - wv[r, c]) <= 1e-5
            assert gi[r, c] in set(wi[r][near]) or near[-1], (r, c)


def test_graph_search_replays_captured_blocks(cuda, monkeypatch):
    # every card block runs as a captured CUDA graph of its size padded to
    # a power of two: answers those of the plain beam search on the CPU
    # (scores within 1e-5, ids but near-ties); K counts only its eager
    # warm-up launches, GraphIndex.graph_replays the replays; one graph a
    # padded size, k and route, at most MAX_GRAPHS, and searching many
    # sizes again reserves no more memory
    db = _graph_rows()
    index = GraphIndex(degree=42, beam_width=64, packed="always",
                       device="cuda").add(db)
    cpu = GraphIndex.from_state(index.state(), device="cpu")
    for block in (db[:300], db[300:600], db[600:637], db[637:638]):
        launches, replays = (slab_cuda.beam_expand.launches,
                             GraphIndex.graph_replays)
        captured = len(index._graphs)
        (gv, gi), (wv, wi) = index.search(block, 20), cpu.search(block, 20)
        assert GraphIndex.graph_replays == replays + 1
        moved = slab_cuda.beam_expand.launches - launches
        assert (moved > 0) == (len(index._graphs) > captured)
        np.testing.assert_allclose(gv, wv, rtol=0, atol=1e-5)
        assert (gi != wi).mean() <= 0.01
        for r, c in zip(*np.nonzero(gi != wi)):
            near = np.abs(wv[r] - wv[r, c]) <= 1e-5
            assert gi[r, c] in set(wi[r][near]) or near[-1], (r, c)
    assert len(index._graphs) == 3  # 512, 64, 1
    sizes = range(1, 301)
    for n in sizes:
        index.search(db[:n], 20)
    torch.cuda.synchronize()
    reserved = torch.cuda.memory_reserved()
    assert len(index._graphs) == 10  # 1, 2, 4, ..., 512
    for n in sizes:
        index.search(db[n:2 * n], 20)
    torch.cuda.synchronize()
    assert torch.cuda.memory_reserved() <= reserved + 2**21
    for k in range(1, 2 * GraphIndex.MAX_GRAPHS):
        index.search(db[:8], k)
    assert len(index._graphs) == GraphIndex.MAX_GRAPHS
    monkeypatch.setattr(slab_cuda, "slab_route", lambda *shape: "tiles")
    index.search(db[:8], 20)
    assert len(index._graphs) == GraphIndex.MAX_GRAPHS
    assert list(index._graphs)[-1][-1] is slab_cuda.slab_route


@pytest.mark.parametrize("route", slab_cuda.ROUTES)
def test_graph_beam_loop_makes_no_host_sync(cuda, monkeypatch, route):
    # the beam loop, K's route choice and its tile plan stay on the device:
    # no torch operation in beam_search_packed waits for the card
    index = GraphIndex(degree=42, beam_width=64, packed="always",
                       device="cuda").add(_graph_rows(2048))
    pv, pi, sc, deg_p = index._packed_state()
    monkeypatch.setattr(slab_cuda, "slab_route", lambda *shape: route)
    args = (index._db, pv, pi, sc, index._db[:300].contiguous(),
            index._entry_points())
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        sims, ids = graph_mod.beam_search_packed(
            *args, k=20, deg_p=deg_p, degree=42, beam_width=64, iters=8)
    finally:
        torch.cuda.set_sync_debug_mode(0)
    assert ids.shape == (300, 20) and bool((ids[:, 0] >= 0).all())


# --- the n_valid row bound (a shard's pad rows): columns >= n_valid never
# enter a slot, the passes (and jbits) stay those of all n rows

@pytest.mark.parametrize("n_valid", [0, 1, 257, 3100, 5000, 9000])
@pytest.mark.parametrize("metric,r_slots", [("ip", 6), ("l2", 32)])
def test_kernel_b_n_valid_bit_equal(cuda, n_valid, metric, r_slots):
    db, qs = _ints(21, 5000, 70, 40, cuda)
    got = exact_cuda.segment_topr_kernel(db, qs, 256, r_slots, metric,
                                         n_valid)
    want = exact_cuda.segment_topr_plain(db, qs, 256, r_slots, metric,
                                         n_valid)
    torch.testing.assert_close(got[0], want[0], rtol=0, atol=0)
    torch.testing.assert_close(got[1], want[1], rtol=0, atol=0)
    live = got[1][got[1] >= 0]  # pass indices of filled slots
    assert live.numel() == 0 or int(live.max()) < -(-min(n_valid, 5000) // 256)


@pytest.mark.parametrize("n_valid", [0, 3100, 5000])
@pytest.mark.parametrize("storage,metric", [
    ("f32", "l2"), ("bf16", "ip"), ("sq8", "l2"), ("sq8-sym", "ip"),
    ("sq8-sym2", "ip")])
def test_packed_kernels_n_valid_bit_equal(cuda, storage, metric, n_valid):
    ops = _packed_operands(22, storage, 5000, 70, 48, cuda)
    kw = dict(db_tile=256, r_slots=7, metric=metric, n_valid=n_valid, **ops)
    got = packed_cuda.segment_packed_kernel(**kw)
    torch.testing.assert_close(got, packed_cuda.segment_packed_plain(**kw),
                               rtol=0, atol=0)


@pytest.mark.parametrize("exact", [True, False])
def test_exact_topk_traced_n_valid_on_the_card(cuda, exact):
    # integer data: every dot exact, so the card's ids equal the CPU's
    db, qs = _ints(23, 3000, 90, 128, cuda)
    before = exact_cuda.segment_topr_kernel.launches
    got = exact_cuda.exact_topk_traced(db, qs, 100, metric="ip",
                                       n_valid=2500, exact=exact)
    want = exact_cuda.exact_topk_traced(db.cpu(), qs.cpu(), 100, metric="ip",
                                        n_valid=2500, exact=exact)
    assert exact_cuda.segment_topr_kernel.launches == before + int(exact)
    torch.testing.assert_close(got[0].cpu(), want[0], rtol=0, atol=0)
    torch.testing.assert_close(got[1].cpu(), want[1], rtol=0, atol=0)
    assert int(got[1].max()) < 2500


@pytest.mark.parametrize("t,d,f", [(1, 128, 256), (300, 1024, 512),
                                   (129, 256, 384), (7000, 1024, 8192)])
def test_kernel_g_without_residual(cuda, t, d, f):
    # the tensor-parallel block: relu(norm(x) wi) wo, x left out (F =
    # 8192 is ProtT5-XL's d_ff over two model ranks)
    rng = np.random.RandomState(24)

    def bf16(*shape, scale=1.0):
        return torch.from_numpy((rng.randn(*shape) * scale).astype(
            np.float32)).to(device=cuda, dtype=torch.bfloat16)

    x, ln = bf16(t, d, scale=2.0), bf16(d) + 1.0
    wi, wo = bf16(d, f, scale=d**-0.5), bf16(f, d, scale=f**-0.5)
    before = ffn_cuda.fused_ffn_t5.launches
    got = ffn_cuda.fused_ffn_t5(x, ln, wi, wo, residual=False)
    assert ffn_cuda.fused_ffn_t5.launches == before + 1
    want = fused_ffn_plain(x, ln, wi, wo, residual=False)
    err = float((got.float() - want.float()).abs().max())
    assert err <= 2.0**-6 * float(want.float().abs().max()), err
    with_x = ffn_cuda.fused_ffn_t5(x, ln, wi, wo)
    assert float((with_x.float() - x.float() - got.float()).abs().max()) \
        <= 2.0**-6 * float(with_x.float().abs().max())


@pytest.mark.parametrize("convention", ["blast", "mmseqs"])
def test_sw_scores_pairs_through_kernel_c(cuda, convention):
    # the pair-batched entry: B groups of one lane (K = 1), ragged lengths
    rng = np.random.RandomState(25)
    seqs = ["".join(rng.choice(list(AAS), rng.randint(1, 300)))
            for _ in range(2 * 700)]
    q = torch.from_numpy(np.stack([encode_sequence(s, 320)
                                   for s in seqs[:700]]))
    t = torch.from_numpy(np.stack([encode_sequence(s, 300)
                                   for s in seqs[700:]]))
    before = align_cuda.sw_scores_grouped.launches
    got = align_ops.sw_scores(q.to(cuda), t.to(cuda), convention=convention)
    assert align_cuda.sw_scores_grouped.launches == before + 1
    want = align_ops.sw_scores(q, t, convention=convention)
    torch.testing.assert_close(got.cpu(), want, rtol=0, atol=0)
    scores, evs = align_ops.align_pairs(seqs[:700], seqs[700:],
                                        convention=convention, device="cuda")
    assert np.array_equal(scores, want.numpy())
    assert evs.shape == (700,) and np.isfinite(evs).all()


def _relattn_inputs(seed, b, h, l, lengths, device, layers=3):
    """bf16 q, k, v [B, H, L, 64] at unit spread, R as the middle layer's
    slice of a [2L, layers * H * 64] product (rows layers * H * 64 apart,
    as the encoder passes it), r_w, r_r and the mask of `lengths`."""
    rng = np.random.RandomState(seed)

    def bf16(*shape, scale=1.0):
        return torch.from_numpy((rng.randn(*shape) * scale).astype(
            np.float32)).to(device=device, dtype=torch.bfloat16)

    q, k, v = (bf16(b, h, l, 64) for _ in range(3))
    r_all = bf16(2 * l, layers * h * 64)
    r = r_all[:, h * 64:2 * h * 64].view(2 * l, h, 64)
    mask = torch.arange(l)[None] < torch.as_tensor(lengths)[:, None]
    return q, k, v, r, bf16(h, 64, scale=0.5), bf16(h, 64, scale=0.5), \
        mask.to(device)


# the ragged edges of L's 64-key tiles and 128-query blocks, ragged rows
# (padded keys and query rows), and the published shape
@pytest.mark.parametrize("b,h,l,lengths", [
    (1, 2, 1, [1]), (2, 3, 65, [65, 30]), (3, 2, 127, [127, 64, 1]),
    (2, 2, 129, [100, 129]), (2, 2, 200, [200, 131]),
    (2, 16, 3098, [3098, 3098]), (3, 16, 2306, [2306, 2100, 1025])])
def test_kernel_l_matches_plain(cuda, b, h, l, lengths):
    q, k, v, r, r_w, r_r, mask = _relattn_inputs(31, b, h, l, lengths, cuda)
    before = relattn_cuda.relative_attention.launches
    got = relattn_cuda.relative_attention(q, k, v, r, r_w, r_r, mask)
    torch.cuda.synchronize()
    assert relattn_cuda.relative_attention.launches == before + 1
    want = relative_attention_plain(q, k, v, r, r_w, r_r, mask, block=64)
    assert torch.isfinite(got.float()).all()  # padded rows too
    err = float((got.float() - want.float()).abs().max())
    assert err <= 2.0**-6 * float(want.float().abs().max()), err


@pytest.mark.parametrize("fault", ["no position term", "shifted by one"])
def test_kernel_l_faults_fail_the_tolerance(cuda, fault):
    """The comparison above sees the position term: the kernel given R
    zeroed, or R one row off, is far outside its tolerance."""
    q, k, v, r, r_w, r_r, mask = _relattn_inputs(32, 2, 16, 700, [700, 500],
                                                 cuda)
    want = relative_attention_plain(q, k, v, r, r_w, r_r, mask, block=64)
    bad = torch.zeros_like(r) if fault == "no position term" else \
        torch.cat([r[1:], torch.zeros_like(r[:1])])
    got = relattn_cuda.relative_attention(q, k, v, bad, r_w, r_r, mask)
    err = float((got.float() - want.float()).abs().max())
    assert err > 4 * 2.0**-6 * float(want.float().abs().max()), err


def test_kernel_l_refuses_what_it_cannot_take(cuda):
    q, k, v, r, r_w, r_r, mask = _relattn_inputs(33, 1, 2, 64, [64], cuda)
    with pytest.raises(TypeError):
        relattn_cuda.relative_attention(q.float(), k.float(), v.float(), r,
                                        r_w, r_r, mask)
    with pytest.raises(ValueError):
        relattn_cuda.relative_attention(q[..., :32].contiguous(),
                                        k[..., :32].contiguous(),
                                        v[..., :32].contiguous(),
                                        r[..., :32], r_w[:, :32],
                                        r_r[:, :32], mask)


def test_xlnet_encode_runs_kernel_l_within_a_gib(cuda):
    """ProtXLNet at its published widths in bf16, a batch of 2 x 3098
    tokens: one launch of L a layer, and the encode's peak allocation above
    the weights under 1 GiB (no [B, H, L, L] or [L, 2L] fp32 tensor)."""
    config = dataclasses.replace(xlnet.PROTXLNET, dtype=torch.bfloat16)
    params = xlnet.init_params(config, seed=3, device=cuda)
    embedder = get_embedder("ProtXLNet UniRef100", config=config,
                            params=params, device=cuda)
    del params
    rng = np.random.RandomState(34)
    seqs = ["".join(rng.choice(list(AAS[:20]), 3096)) for _ in range(2)]
    embedder.embed_pooled(seqs[:1])  # the library built, cuBLAS warm
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    before = relattn_cuda.relative_attention.launches
    ids = torch.from_numpy(np.stack([xlnet.tokenize(s) for s in seqs])).to(
        cuda)
    mask = torch.ones(ids.shape, dtype=torch.bool, device=cuda)
    hidden = embedder.encoder(ids, mask)
    torch.cuda.synchronize()
    assert hidden.shape == (2, 3098, 1024)
    assert torch.isfinite(hidden.float()).all()
    assert relattn_cuda.relative_attention.launches == before + 30
    assert torch.cuda.max_memory_allocated() - base < 2**30


def _lstm_inputs(seed, lengths, device, steps=None):
    """(xw [2, B, T, 16384] of x ~ N(0, 1), SeqVec-width recurrent weights
    at TF1's Glorot-uniform default (bilm-tf's LSTMCell), all bf16, packed
    for the kernel; the lengths as a host list)."""
    gen = torch.Generator(device).manual_seed(seed)
    p, cells = 512, 4096

    def glorot(shape, fan):
        return ((torch.rand(shape, generator=gen, device=device) * 2 - 1)
                * (6.0 / fan) ** 0.5).to(torch.bfloat16)

    w_x = [glorot((p, 4 * cells), 2 * p + 4 * cells) for _ in range(2)]
    w_h = [glorot((p, 4 * cells), 2 * p + 4 * cells) for _ in range(2)]
    w_p = [glorot((cells, p), cells + p) for _ in range(2)]
    b, t = len(lengths), steps or max(max(lengths), 1)
    x = torch.randn((b * t, p), generator=gen, device=device).bfloat16()
    xw = torch.stack([(x @ w).view(b, t, 4 * cells) for w in w_x])
    return xw.contiguous(), lstm_cuda.lstmp_weights(w_h, w_p), list(lengths)


def _widest_position_err(got, want, lengths):
    """The widest relative L2 error of a valid position's [1024] vector;
    inf where the kernel wrote past a row's length."""
    worst = 0.0
    for r, n in enumerate(lengths):
        if bool((got[r, n:] != 0).any()):
            return float("inf")
        if n:
            gap = (got[r, :n].double() - want[r, :n].double()).norm(dim=-1)
            ref = want[r, :n].double().norm(dim=-1).clamp_min(1e-30)
            worst = max(worst, float((gap / ref).max()))
    return worst


# ragged rows of kernel M: one row; rows ending at step 1 and unsorted;
# a row of length 0 and steps beyond the longest row; more rows than a
# 64-row chunk; the widest and the longest batch of seqvec.mix
@pytest.mark.parametrize("lengths,steps", [
    ([33], None), ([3, 17, 1, 9, 17], None), ([12, 0, 5], 20),
    ([40 - (i % 37) for i in range(70)], None),
    ([272 - round(87 * i / 55) for i in range(56)], None),
    ([1616 - round(733 * i / 9) for i in range(10)], None),
], ids=["one row", "unsorted", "zero length", "two chunks", "B56 T272",
        "B10 T1616"])
def test_kernel_m_matches_plain(cuda, lengths, steps):
    """Kernel M against its plain version on the card: every position of
    both directions within 2^-6 relative (both round h to bf16 each step,
    but sum in other orders, so a bf16 rounding may differ and carry on;
    the plain route itself sits ~2e-3 from an fp32 recurrence), nothing
    written past a row's length, one launch."""
    xw, weights, lens = _lstm_inputs(41, lengths, cuda, steps)
    before = (lstm_cuda.lstmp_bidir.launches, lstm_cuda.lstmp_bidir.steps)
    got = lstm_cuda.lstmp_bidir(xw, weights, lens, 3.0, 3.0)
    assert lstm_cuda.lstmp_bidir.launches == before[0] + 1
    assert lstm_cuda.lstmp_bidir.steps == before[1] + max(lengths)
    want = lstmp_bidir_plain(xw, weights.w_h, weights.w_proj, lens, 3.0, 3.0)
    assert _widest_position_err(got, want, lengths) < 2.0**-6


@pytest.mark.parametrize("fault", ["backward not reversed", "one step late"])
def test_kernel_m_faults_fail_the_tolerance(cuda, fault):
    """The comparison above sees the backward direction's walk and the
    step a position is written at."""
    lengths = [300, 250, 120]
    xw, weights, lens = _lstm_inputs(42, lengths, cuda)
    want = lstmp_bidir_plain(xw, weights.w_h, weights.w_proj, lens, 3.0, 3.0)
    if fault == "backward not reversed":
        got = lstm_cuda.lstmp_bidir(xw, weights, lens, 3.0, 3.0)
        got[..., 512:] = got[..., 512:].flip(1)
    else:
        got = lstm_cuda.lstmp_bidir(xw, weights, lens, 3.0, 3.0)
        got[:, 1:] = got[:, :-1].clone()
    assert _widest_position_err(got, want, lengths) > 4 * 2.0**-6


def test_kernel_m_refuses_what_it_cannot_take(cuda):
    xw, weights, lens = _lstm_inputs(43, [5, 3], cuda)
    with pytest.raises(TypeError):
        lstm_cuda.lstmp_bidir(xw.float(), weights, lens, 3.0, 3.0)
    narrow = lstm_cuda.lstmp_weights([w[:, :8192] for w in weights.w_h],
                                     [w[:2048] for w in weights.w_proj])
    with pytest.raises(ValueError):  # other widths than SeqVec's
        lstm_cuda.lstmp_bidir(xw[..., :8192].contiguous(), narrow, lens, 3.0,
                              3.0)
    with pytest.raises(ValueError):  # a row longer than the steps
        lstm_cuda.lstmp_bidir(xw, weights, [n + 10 for n in lens], 3.0, 3.0)


def test_seqvec_embedder_runs_kernel_m(cuda):
    """SeqVec at its published widths in bf16 through the registry: two
    launches of M a batch, the pooled vectors within 2^-6 relative of the
    same route on M's plain version on the card."""
    config = dataclasses.replace(elmo.SEQVEC, dtype=torch.bfloat16)
    params = elmo.init_params(config, seed=4, device=cuda)
    gen = torch.Generator(cuda).manual_seed(44)
    for cell in params["lstm_fwd"] + params["lstm_bwd"]:  # bilm-tf's init
        for name, fan in (("w_x", 17408), ("w_h", 17408), ("w_proj", 4608)):
            w = cell[name]
            cell[name] = ((torch.rand(w.shape, generator=gen, device=cuda)
                           * 2 - 1) * (6.0 / fan) ** 0.5).to(w.dtype)
    embedder = get_embedder("SeqVec", config=config, params=params,
                            max_batch_tokens=2048, device=cuda)
    rng = np.random.RandomState(45)
    seqs = ["".join(rng.choice(list(AAS[:20]), n))
            for n in (1, 7, 300, 64, 900, 33)]
    before = lstm_cuda.lstmp_bidir.launches
    got = embedder.embed_pooled(seqs)
    launches = lstm_cuda.lstmp_bidir.launches - before
    assert launches == 2 * len(embedder.batches(seqs))
    kernel = lstm_cuda.lstmp_bidir
    lstm_cuda.lstmp_bidir = lambda xw, w, lens, *clips: lstmp_bidir_plain(
        xw, w.w_h, w.w_proj, lens, *clips)
    try:
        want = embedder.embed_pooled(seqs)
    finally:
        lstm_cuda.lstmp_bidir = kernel
    gap = np.linalg.norm(got - want, axis=1) / np.linalg.norm(want, axis=1)
    assert gap.max() < 2.0**-6, gap
