"""The plain versions of the IVF path's two kernels against the JAX package
on the CPU, with the Pallas kernels in interpret mode:

  * J (ops/ivf_cuda.py): the indirect sq8-sym union scan. Its [Q, R·W]
    packed buffer must equal the Pallas kernel's bit for bit, and so must
    `ivf_union_topk`'s values, positions and ids (sym and sym2): the int8
    dots are exact in both packages and the scales are computed alike.
  * K (ops/slab_cuda.py): the slab expansion. Ids equal; similarities
    within 1e-5 relative (fp32 sums of the same products in other orders).
  * The packed slab layout (pack_neighbours): bit-equal.

Sizes stay small (d = 96 so the lane padding to 128 runs; budgets 8 and
16, and below SLABS_PER_STEP).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from knn_for_homology_tpu.ops import exact_pallas as jexact
from knn_for_homology_tpu.ops import graph_pallas as gp
from knn_for_homology_tpu.ops import ivf_pallas as jivf
from knn_for_homology_tpu_torch.ops import ivf_cuda, packed_cuda, slab_cuda

K_RTOL = 1e-5  # kernel K's fp32 sums, in another order than XLA's


def _t(x):
    return torch.from_numpy(np.array(x))


def _packed_fixture(seed=0, c=64, d=96, per_cell=100):
    """Normalised Gaussian rows in `c` cells of `per_cell` members (the
    rest capacity padding), packed by the JAX package."""
    rng = np.random.RandomState(seed)
    n = c * per_cell
    db = rng.randn(n, d).astype(np.float32)
    db /= np.linalg.norm(db, axis=1, keepdims=True)
    members = np.full((c, 128), -1, np.int32)
    perm = rng.permutation(n)
    for cell in range(c):
        members[cell, :per_cell] = perm[cell * per_cell : (cell + 1) * per_cell]
    pv, pi, sc = gp.pack_neighbours(jnp.asarray(db), jnp.asarray(members), 128)
    return db, members, (np.asarray(pv), np.asarray(pi), np.asarray(sc)), rng


@pytest.mark.parametrize("deg,deg_p", [(100, 128), (20, 32)])
def test_pack_neighbours_bit_equal(deg, deg_p):
    """The jitted JAX packer quantises with a multiply by f32(1/127)
    (reciprocal=True); pad rows zero, pad ids -1, pad scales 1.0, d = 96
    lane-padded to 128."""
    rng = np.random.RandomState(1)
    db = rng.randn(500, 96).astype(np.float32)
    graph = rng.randint(-1, 500, size=(40, deg)).astype(np.int32)
    want = gp.pack_neighbours(jnp.asarray(db), jnp.asarray(graph), deg_p)
    got = slab_cuda.pack_neighbours(_t(db), _t(graph), deg_p)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))
    assert got[0].shape == (40 * deg_p, 128)


def test_pack_neighbours_prequant_bit_equal():
    """The streamed build quantises eagerly (a division: reciprocal=False)
    and packs the int8 copy."""
    rng = np.random.RandomState(2)
    db = rng.randn(300, 64).astype(np.float32)
    graph = rng.randint(-1, 300, size=(12, 128)).astype(np.int32)
    jq8, jsc = gp.quantize_int8(jnp.asarray(db))  # eager
    tq8, tsc = packed_cuda.quantize_int8(_t(db), reciprocal=False)
    np.testing.assert_array_equal(tsc.numpy(), np.asarray(jsc))
    want = gp.pack_neighbours_prequant(jq8, jsc, jnp.asarray(graph), 128)
    got = slab_cuda.pack_neighbours_prequant(tq8, tsc, _t(graph), 128)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))
    with pytest.raises(ValueError, match="degree"):
        slab_cuda.pack_neighbours_prequant(tq8, tsc, _t(graph), 160)


@pytest.mark.parametrize("two_level", [False, True])
@pytest.mark.parametrize("budget", [8, 16, 4])
def test_indirect_buffer_bit_equal_to_pallas(budget, two_level):
    """Kernel J's plain version builds the Pallas kernel's packed buffer,
    slot for slot (capacity padding masked, lanes by cell slot)."""
    db, _, (pv, pi, sc), rng = _packed_fixture(seed=3)
    cells = rng.choice(pi.shape[0], budget, replace=False).astype(np.int32)
    q32 = np.pad(db[:40], ((0, 0), (0, 32)))
    q8, q_lo, _ = packed_cuda.quantize_queries(_t(q32), two_level, False)
    e = min(jivf.SLABS_PER_STEP, budget)
    tile = e * 128
    r = 3
    jbits = packed_cuda.pass_bits(budget * 128, tile)
    want = jivf._indirect_candidates(
        jnp.asarray(pv), jnp.asarray(sc), jnp.asarray(pi), jnp.asarray(cells),
        jnp.asarray(q8.numpy()),
        None if q_lo is None else jnp.asarray(q_lo.numpy()),
        10, r, 8, e, jbits, True,
    )
    got = ivf_cuda.segment_packed_indirect_kernel(
        q8, _t(pv), _t(sc), _t(pi), _t(cells), tile, r, q_lo
    )
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


@pytest.mark.parametrize("compute", ["sym", "sym2"])
@pytest.mark.parametrize("budget", [8, 16])
def test_ivf_union_topk_matches_pallas(budget, compute):
    """Eager form (reciprocal=False), as tests/test_ivf_pallas.py calls the
    reference: values, positions and ids all equal."""
    db, _, (pv, pi, sc), rng = _packed_fixture(seed=budget)
    cells = rng.choice(pi.shape[0], budget, replace=False).astype(np.int32)
    q = db[:32]
    want = jivf.ivf_union_topk(
        jnp.asarray(pv), jnp.asarray(sc), jnp.asarray(pi), jnp.asarray(cells),
        jnp.asarray(q), 10, compute=compute, interpret=True,
    )
    got = ivf_cuda.ivf_union_topk(
        _t(pv), _t(sc), _t(pi), _t(cells), _t(q), 10, compute=compute,
    )
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))
    vals, pos, ids = (g.numpy() for g in got)
    assert (ids >= 0).all()  # capacity padding never surfaces
    np.testing.assert_array_equal(pi[cells[pos // 128], pos % 128], ids)


def test_ivf_union_topk_small_budgets_and_k_beyond_candidates():
    """budget < SLABS_PER_STEP narrows the tile; k above the real rows pads
    with (-inf, -1, -1). Equal to the reference in both cases."""
    db, _, (pv, pi, sc), _ = _packed_fixture(seed=5, c=16, per_cell=20)
    args = [jnp.asarray(pv), jnp.asarray(sc), jnp.asarray(pi)]
    for budget, k in ((1, 5), (2, 5), (4, 5), (2, 100)):
        cells = np.arange(budget, dtype=np.int32)
        want = jivf.ivf_union_topk(*args, jnp.asarray(cells),
                                   jnp.asarray(db[:8]), k, interpret=True)
        got = ivf_cuda.ivf_union_topk(_t(pv), _t(sc), _t(pi), _t(cells),
                                      _t(db[:8]), k)
        for g, w in zip(got, want):
            np.testing.assert_array_equal(g.numpy(), np.asarray(w))
    vals, _, ids = (g.numpy() for g in got)
    assert ((ids >= 0).sum(axis=1) <= 40).all()
    assert np.isneginf(vals[ids < 0]).all()


def test_union_plan_matches_reference_plan():
    """e = min(8, budget), W = e·128, R from the recall target grown until
    R·W ≥ k: the reference's approx _plan."""
    for budget, k in ((1, 5), (8, 10), (16, 1000), (256, 1001), (2048, 1001)):
        tile, r, k_eff = ivf_cuda.union_plan(budget, k, 0.995)
        want = jexact._plan(budget * 128, 128, k_eff, min(8, budget) * 128,
                            512, jexact.DEFAULT_R, False, 0.995, 1)
        assert tile == min(8, budget) * 128
        assert (tile, r) == (want[0], want[2])
    with pytest.raises(ValueError):
        ivf_cuda.union_plan(12, 10, 0.995)


@pytest.mark.parametrize("deg,deg_p,d", [(100, 128, 96), (20, 32, 96),
                                         (128, 128, 128)])
def test_beam_expand_matches_pallas_and_reference(deg, deg_p, d):
    """Kernel K's plain version against the Pallas kernel (interpret) and
    the numpy oracle: ids equal, -inf in lanes ≥ deg_p, sims within
    K_RTOL."""
    rng = np.random.RandomState(deg)
    db = rng.randn(400, d).astype(np.float32)
    graph = rng.randint(-1, 400, size=(60, deg)).astype(np.int32)
    pv, pi, sc = gp.pack_neighbours(jnp.asarray(db), jnp.asarray(graph), deg_p)
    sel = rng.randint(0, 60, size=(24, 5)).astype(np.int32)
    q = rng.randn(24, d).astype(np.float32)
    want_s, want_n = gp.beam_expand(jnp.asarray(sel), jnp.asarray(q), pv, pi,
                                    sc, deg_p, interpret=True)
    ref_s, ref_n = gp.beam_expand_reference(sel, q, np.asarray(pv),
                                            np.asarray(pi), np.asarray(sc),
                                            deg_p)
    got_s, got_n = slab_cuda.beam_expand(_t(sel), _t(q), _t(pv), _t(pi),
                                         _t(sc), deg_p)
    got_s, got_n = got_s.numpy(), got_n.numpy()
    assert got_s.shape == (24, 5, 128) and got_n.dtype == np.int32
    for s, n in ((np.asarray(want_s), np.asarray(want_n)), (ref_s, ref_n)):
        np.testing.assert_array_equal(got_n, n)
        np.testing.assert_array_equal(np.isneginf(got_s), np.isneginf(s))
        fin = np.isfinite(s)
        np.testing.assert_allclose(got_s[fin], s[fin], rtol=K_RTOL,
                                   atol=K_RTOL * np.abs(s[fin]).max())
    assert np.isneginf(got_s[:, :, deg_p:]).all()


def test_wrappers_check_their_operands():
    db, _, (pv, pi, sc), _ = _packed_fixture(seed=6, c=8, per_cell=10)
    q8 = torch.zeros((4, 128), dtype=torch.int8)
    cells = torch.arange(3, dtype=torch.int32)
    with pytest.raises(ValueError, match="W % 128"):
        ivf_cuda.segment_packed_indirect_kernel(q8, _t(pv), _t(sc), _t(pi),
                                                cells, 256, 2)
    with pytest.raises(TypeError):
        ivf_cuda.segment_packed_indirect_kernel(q8.float(), _t(pv), _t(sc),
                                                _t(pi), cells[:2], 256, 2)
    with pytest.raises(ValueError, match="unknown compute"):
        ivf_cuda.ivf_union_topk(_t(pv), _t(sc), _t(pi), cells[:2],
                                _t(db[:2]), 3, compute="pq")
    sel = torch.zeros((2, 3), dtype=torch.int32)
    with pytest.raises(ValueError, match="slab layout"):
        slab_cuda.beam_expand(sel, _t(db[:2]), _t(pv), _t(pi), _t(sc), 32)
    with pytest.raises(TypeError):
        slab_cuda.beam_expand(sel, _t(db[:2]), _t(pv).float(), _t(pi),
                              _t(sc), 128)
