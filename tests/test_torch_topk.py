"""The port's distance and top-k layers against the JAX package, on the
CPU: the plain PyTorch top-k (the reference of kernels A and B), kernel A's
plain version against the Pallas kernel in interpret mode, and kernel B's
plain candidates + epilogue + certificate against `_candidates_and_topk`
in interpret mode. Ids must be equal; scores agree within rtol 1e-5 /
atol 1e-6, because torch's CPU matmul and XLA sum in different orders."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from knn_for_homology_tpu.ops import distance as jdist
from knn_for_homology_tpu.ops import exact_pallas as jexact
from knn_for_homology_tpu.ops import topk as jtopk
from knn_for_homology_tpu.ops.flat_pallas import pallas_flat_topk
from knn_for_homology_tpu_torch.ops import distance as tdist
from knn_for_homology_tpu_torch.ops import exact_cuda, flat_cuda
from knn_for_homology_tpu_torch.ops import topk as ttopk

METRICS = ["cosine", "ip", "l2"]
RTOL, ATOL = 1e-5, 1e-6


def _data(seed, n, q, d, metric="ip"):
    rng = np.random.RandomState(seed)
    db = rng.randn(n, d).astype(np.float32)
    qs = rng.randn(q, d).astype(np.float32)
    if metric == "cosine":
        db = np.asarray(jdist.l2_normalize(jnp.asarray(db)))
        qs = np.asarray(jdist.l2_normalize(jnp.asarray(qs)))
    return db, qs


def _t(x):
    return torch.from_numpy(np.array(x, dtype=np.asarray(x).dtype))


def _same(got, want):
    (gv, gi), (wv, wi) = got, want
    np.testing.assert_array_equal(np.asarray(gi), np.asarray(wi))
    np.testing.assert_allclose(
        np.asarray(gv), np.asarray(wv), rtol=RTOL, atol=ATOL
    )


@pytest.mark.parametrize("metric", METRICS)
def test_distance_matches_jax(metric):
    db, qs = _data(0, 40, 7, 24)
    db[3] = 0.0  # zero rows stay zero under normalisation
    np.testing.assert_allclose(
        tdist.l2_normalize(_t(db)).numpy(),
        np.asarray(jdist.l2_normalize(jnp.asarray(db))), rtol=1e-6, atol=1e-7,
    )
    got = tdist.similarity_block(_t(qs), _t(db), metric)
    want = jdist.similarity_block(jnp.asarray(qs), jnp.asarray(db), metric)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=RTOL, atol=ATOL)
    np.testing.assert_array_equal(
        tdist.finalize_scores(got, metric).numpy(),
        np.asarray(jdist.finalize_scores(jnp.asarray(got.numpy()), metric)),
    )
    assert tdist.pad_rows(_t(db), 16).shape == (48, 24)


@pytest.mark.parametrize("metric", METRICS)
def test_flat_topk_matches_jax(metric):
    db, qs = _data(1, 500, 19, 32, metric)
    _same(
        ttopk.flat_topk(_t(db), _t(qs), 13, metric=metric),
        jtopk.flat_topk(jnp.asarray(db), jnp.asarray(qs), 13, metric=metric),
    )


def test_streaming_equals_oneshot_and_jax():
    db, qs = _data(2, 700, 9, 16)
    want = jtopk.streaming_topk(
        jnp.asarray(db), jnp.asarray(qs), 50, metric="ip", db_tile=128
    )
    got = ttopk.streaming_topk(_t(db), _t(qs), 50, metric="ip", db_tile=128)
    _same(got, want)
    _same(ttopk.oneshot_topk(_t(db), _t(qs), 50, metric="ip"), got)


def test_k_beyond_n_pads_with_sentinels():
    db, qs = _data(3, 10, 4, 8)
    vals, ids = ttopk.flat_topk(_t(db), _t(qs), 15, metric="ip")
    want_vals, want_ids = jtopk.flat_topk(
        jnp.asarray(db), jnp.asarray(qs), 15, metric="ip"
    )
    np.testing.assert_array_equal(ids.numpy(), np.asarray(want_ids))
    assert np.all(ids.numpy()[:, 10:] == -1)
    assert np.all(np.isneginf(vals.numpy()[:, 10:]))
    kv, ki = flat_cuda.flat_topk_kernel(_t(db), _t(qs), 15, metric="ip")
    np.testing.assert_array_equal(ki.numpy(), ids.numpy())


def _tied(seed):
    # small integer vectors: every dot is an exact integer, so duplicated
    # rows tie bit-exactly whatever the summation order
    rng = np.random.RandomState(seed)
    base = rng.randint(-2, 3, size=(40, 16)).astype(np.float32)
    db = np.tile(base, (6, 1))  # 240 rows, 6-fold ties
    qs = rng.randint(-2, 3, size=(9, 16)).astype(np.float32)
    return db, qs


def test_tie_order_lower_id_first():
    db, qs = _tied(4)
    vals, ids = ttopk.flat_topk(_t(db), _t(qs), 30, metric="ip")
    want = jtopk.flat_topk(jnp.asarray(db), jnp.asarray(qs), 30, metric="ip")
    np.testing.assert_array_equal(ids.numpy(), np.asarray(want[1]))
    v, i = vals.numpy(), ids.numpy()
    tie = v[:, 1:] == v[:, :-1]
    assert tie.any() and np.all(i[:, 1:][tie] > i[:, :-1][tie])


@pytest.mark.parametrize("metric", METRICS)
def test_kernel_a_plain_matches_pallas(metric):
    db, qs = _data(5, 300, 20, 32, metric)
    _same(
        flat_cuda.flat_topk_kernel(_t(db), _t(qs), 13, metric=metric),
        pallas_flat_topk(
            jnp.asarray(db), jnp.asarray(qs), 13, metric=metric,
            db_tile=128, query_block=8, interpret=True,
        ),
    )


def test_kernel_a_ties_match_pallas():
    db, qs = _tied(6)
    _same(
        flat_cuda.flat_topk_kernel(_t(db), _t(qs), 32, metric="ip"),
        pallas_flat_topk(
            jnp.asarray(db), jnp.asarray(qs), 32, metric="ip", db_tile=128,
            query_block=8, interpret=True,
        ),
    )


@pytest.mark.parametrize("metric", METRICS)
def test_kernel_b_candidates_match_pallas(metric):
    db, qs = _data(7, 1000, 11, 32, metric)
    k, r_slots, w = 100, 4, 128
    got = exact_cuda.candidates_and_topk(_t(db), _t(qs), k, r_slots, metric, w)
    want = jexact._candidates_and_topk(
        jnp.asarray(db), jnp.asarray(qs), k, r_slots, metric, w, 8, True, True
    )
    _same(got[:2], want[:2])
    np.testing.assert_array_equal(got[2].numpy(), np.asarray(want[2]))


def _adversarial():
    # > R of the top-k planted in ONE strided segment (ids ≡ 3 mod 128)
    rng = np.random.RandomState(4)
    d = 16
    db = rng.randn(2048, d).astype(np.float32) * 0.01
    spike = rng.randn(d).astype(np.float32)
    spike /= np.linalg.norm(spike)
    for row in range(3, 2048, 128):
        db[row] = spike * (1.0 + 0.001 * row)
    return db, spike[None, :]


def test_kernel_b_forced_suspect_matches_pallas():
    db, qs = _adversarial()
    got = exact_cuda.candidates_and_topk(_t(db), _t(qs), 8, 2, "ip", 128)
    want = jexact._candidates_and_topk(
        jnp.asarray(db), jnp.asarray(qs), 8, 2, "ip", 128, 8, True, True
    )
    assert bool(got[2][0]), "the certificate must flag this row"
    _same(got[:2], want[:2])
    np.testing.assert_array_equal(got[2].numpy(), np.asarray(want[2]))


def test_kernel_b_buffer_layout():
    # slot r of lane w at column r*W + w, pass index ids, empty slots
    # INT32_MIN / -1, each lane sorted descending
    db, qs = _data(8, 200, 3, 8)
    buf_v, buf_i = exact_cuda.segment_topr_kernel(_t(db), _t(qs), 64, 5, "ip")
    v = buf_v.numpy().reshape(3, 5, 64)
    i = buf_i.numpy().reshape(3, 5, 64)
    assert np.all(v[:, 1:] <= v[:, :-1])
    # 200 rows over W=64 lanes: lanes < 8 see 4 passes, the others 3
    assert np.all(i[:, 4, 8:] == -1) and np.all(v[:, 4, 8:] == exact_cuda.INT32_MIN)
    assert np.all(i[:, 3, :8] >= 0)
    sims = qs @ db.T
    for lane in (0, 9, 63):
        passes = i[0, :, lane][i[0, :, lane] >= 0]
        want = np.argsort(-sims[0, lane::64], kind="stable")[: len(passes)]
        np.testing.assert_array_equal(passes, want)


@pytest.mark.parametrize(
    "n,q,k,metric,kw",
    [
        (2000, 37, 300, "ip", {}),
        (1500, 16, 200, "l2", {}),
        (333, 5, 400, "cosine", {}),  # k > n: sentinel padding
        (2048, 1, 8, "ip", {"db_tile": 128, "r_slots": 2}),  # rescue runs
    ],
)
def test_exact_topk_matches_jax(n, q, k, metric, kw):
    if kw:
        db, qs = _adversarial()
    else:
        db, qs = _data(9, n, q, 48, metric)
    _same(
        exact_cuda.exact_topk(_t(db), _t(qs), k, metric=metric, **kw),
        jexact.exact_pallas_topk(
            jnp.asarray(db), jnp.asarray(qs), k, metric=metric,
            interpret=True, **kw,
        ),
    )


def test_exact_plan_matches_jax():
    for n, k in [(131072, 1000), (2000, 300), (333, 333), (4096, 40)]:
        w0 = exact_cuda.default_db_tile(k)
        assert w0 == jexact.default_plan_inputs(n, k, exact=True)[0]
        jw, _, jr, _ = jexact._plan(n, 1024, k, w0, 320, None, True, 0.95, 4)
        assert exact_cuda.plan(n, k, w0) == (jw, jr)
    assert exact_cuda.r_for_exact(1000, 256) == jexact.r_for_exact(1000, 256)


def test_ordered_int_matches_jax():
    x = np.asarray([-np.inf, -2.5, -0.0, 0.0, 1e-30, 3.0, np.inf], np.float32)
    got = exact_cuda._ordered_int(_t(x).view(torch.int32)).numpy()
    want = np.asarray(jexact._ordered_int(jnp.asarray(x.view(np.int32))))
    np.testing.assert_array_equal(got, want)
    assert np.all(np.diff(got[[0, 1, 3, 4, 5, 6]]) > 0)


@pytest.mark.parametrize("passes", [1, 2, 17, 512, 0xFFFF, 0x10000])
@pytest.mark.parametrize("w,r", [(128, 1), (256, 2), (256, 6), (256, 16),
                                 (1024, 16), (256, 25), (256, 32),
                                 (1024, 64)])
def test_kernel_b_plan_fits_and_covers_w(passes, w, r):
    # every plan of kernel B's planner fits the card's 227 KB a block with
    # at least three ring stages, its 16-lane tile divides W, and the slots
    # stay in shared memory wherever they fit and every pass index fits
    # their uint16 field (0xFFFF marks an empty slot)
    assert w % exact_cuda.TOPR_LANES == 0
    for n in (passes * w - w // 2, passes * w):
        stages, global_slots = exact_cuda.topr_plan(n, w, r)
        assert exact_cuda.TOPR_MIN_STAGES <= stages <= exact_cuda.TOPR_MAX_STAGES
        smem = exact_cuda.topr_smem_bytes(stages, r, global_slots)
        assert smem <= exact_cuda.TOPR_SMEM_LIMIT
        assert smem + exact_cuda.TOPR_STAGE_BYTES > exact_cuda.TOPR_SMEM_LIMIT \
            or stages == exact_cuda.TOPR_MAX_STAGES
        shared_fits = exact_cuda.topr_smem_bytes(
            exact_cuda.TOPR_MIN_STAGES, r, False
        ) <= exact_cuda.TOPR_SMEM_LIMIT
        assert global_slots == (not shared_fits or passes > 0xFFFF)


def test_kernel_b_plan_at_the_exact_search_shapes():
    # phase 3 / phase 5 / the bench's exact mode: W = 256, R = 16 keeps 96
    # KB of slots in shared memory beside five stages (8 x 16 = 128 blocks
    # at 512 queries); the rescue at R = 32 moves them to device memory
    assert exact_cuda.plan(131072, 1000, 256) == (256, 16)
    assert exact_cuda.topr_plan(131072, 256, 16) == (5, False)
    assert exact_cuda.topr_plan(131072, 256, 32) == (8, True)
    # few slots: the ring takes its full eight stages beside them
    assert exact_cuda.topr_plan(3000, 256, 2) == (8, False)


@pytest.mark.parametrize("q_n,n", [(1, 20), (70, 3001), (1024, 131072),
                                   (4096, 131072), (131072, 131072)])
def test_kernel_a_split_plan(q_n, n):
    # every split holds at least one 128-row step, and no plan is slower
    # (in the planner's own model) than one split or one wave
    splits = flat_cuda.plan_splits(q_n, n)
    n_tiles = -(-n // flat_cuda.FLAT_ROWS)
    assert 1 <= splits <= min(n_tiles, flat_cuda.MAX_SPLITS)
    per_split = -(-n_tiles // splits)
    assert (splits - 1) * per_split < n_tiles  # no split is empty

    q_tiles = -(-q_n // flat_cuda.FLAT_QUERIES)

    slots = flat_cuda.FLAT_BLOCKS_PER_SM * 132

    def cost(s):
        waves = -(-q_tiles * s // slots)
        return waves * (-(-n_tiles // s) + flat_cuda.SPLIT_OVERHEAD)

    assert cost(splits) <= min(cost(1), cost(min(n_tiles, slots)))
    if (q_n, n) == (1024, 131072):  # phase 3: one wave, most SMs busy
        assert slots // 2 < q_tiles * splits <= slots


@pytest.mark.parametrize("d", [33, 45, 100])
def test_padded_columns_give_the_same_plain_results(d):
    # the card wrappers zero-pad d to whole 16-byte rows; the padded
    # operands give the plain versions' results unchanged
    rng = np.random.RandomState(d)
    db = torch.from_numpy(rng.randint(-3, 4, (700, d)).astype(np.float32))
    qs = torch.from_numpy(rng.randint(-3, 4, (9, d)).astype(np.float32))
    pdb, pqs = exact_cuda.pad_columns(db, qs)
    assert pdb.shape[1] % 4 == 0 and pdb.shape[1] - d < 4
    assert torch.equal(pdb[:, :d], db) and not pdb[:, d:].any()
    for metric in ("ip", "l2"):
        for got, want in zip(
            exact_cuda.segment_topr_plain(pdb, pqs, 128, 5, metric),
            exact_cuda.segment_topr_plain(db, qs, 128, 5, metric),
        ):
            assert torch.equal(got, want)
        for got, want in zip(
            flat_cuda.flat_topk_plain(pdb, pqs, 13, metric),
            flat_cuda.flat_topk_plain(db, qs, 13, metric),
        ):
            assert torch.equal(got, want)
    assert exact_cuda.pad_columns(pdb)[0] is pdb


def test_wrappers_reject_what_the_kernels_do_not_take():
    db, qs = _data(10, 50, 3, 8)
    with pytest.raises(ValueError, match="k ≤ 32"):
        flat_cuda.flat_topk_kernel(_t(db), _t(qs), 33)
    with pytest.raises(TypeError):
        flat_cuda.flat_topk_kernel(_t(db).double(), _t(qs).double(), 5)
    with pytest.raises(ValueError, match="d]"):
        flat_cuda.flat_topk_kernel(_t(db), _t(qs[:, :4]), 5)
    with pytest.raises(ValueError, match="W % 64"):
        exact_cuda.segment_topr_kernel(_t(db), _t(qs), 100, 4)
    with pytest.raises(ValueError, match="unknown storage"):
        ttopk.flat_topk(_t(db), _t(qs), 5, approx=True, storage="fp8")
    with pytest.raises(ValueError, match="approx-mode"):
        ttopk.flat_topk(_t(db), _t(qs), 5, storage="sq8-sym")

