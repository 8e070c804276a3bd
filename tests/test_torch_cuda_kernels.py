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
    packed_cuda,
)
from knn_for_homology_tpu_torch.ops.align import encode_sequence
from knn_for_homology_tpu_torch.ops.topk import oneshot_topk
from knn_for_homology_tpu_torch.search.flat import FlatIndex

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


def _sw_workload(seed, g, k, lq, lt, ragged):
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
                tl = int(rng.randint(5, lt if not ragged else 60))
                if pos + tl > lt:
                    break
                s = "".join(rng.choice(list(AAS), tl))
                t[gi, ki, pos : pos + tl] = encode_sequence(s, tl)
                pos += tl + 1
                if not ragged:
                    break
    return torch.from_numpy(q), torch.from_numpy(t)


@pytest.mark.parametrize("convention", ["blast", "mmseqs"])
@pytest.mark.parametrize("segments", [1, 4])
def test_sw_kernel_bit_equal_to_plain(cuda, convention, segments):
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


@pytest.mark.parametrize("r_slots", [25, 26, 35, 130])
@pytest.mark.parametrize("storage", ["f32", "sq8-sym2"])
def test_packed_large_r_routes(cuda, storage, r_slots):
    # R = 25: the largest R whose slots fit shared memory; R ≥ 26: slots in
    # the output buffer (R = 130: more slots than passes, so empty ones
    # stay INT32_MIN)
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
