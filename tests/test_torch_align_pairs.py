"""The port's pair-batched and query-grouped Smith-Waterman entries
(ops/align.py: sw_scores, sw_scores_grouped, align_pairs; kernel C's plain
version on the CPU) against the JAX package's XLA scans, on the CPU.

Tolerances: scores are small integers in float32, so they are held
bit-equal, both gap conventions; E-values within rtol 1e-6 (XLA's and
torch's float32 exp may differ in the last ulp, as in
tests/test_torch_align.py)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from knn_for_homology_tpu.ops import align as jalign
from knn_for_homology_tpu_torch import ops as tops
from knn_for_homology_tpu_torch.ops import align as talign

AAS = "ACDEFGHIKLMNPQRSTVWYX"


def _seqs(seed, count, lo, hi):
    rng = np.random.RandomState(seed)
    return ["".join(rng.choice(list(AAS), rng.randint(lo, hi)))
            for _ in range(count)]


def _codes(seqs, length):
    return np.stack([jalign.encode_sequence(s, length) for s in seqs])


@pytest.mark.parametrize("convention", ["blast", "mmseqs"])
def test_sw_scores_bit_equal(convention):
    q = _codes(_seqs(0, 24, 1, 60), 64)
    t = _codes(_seqs(1, 24, 1, 50), 50)
    q[3, 10] = -1  # an interior query pad row
    want = np.asarray(jalign.sw_scores(jnp.asarray(q), jnp.asarray(t),
                                       convention=convention))
    got = talign.sw_scores(torch.from_numpy(q), torch.from_numpy(t),
                           convention=convention)
    np.testing.assert_array_equal(got.numpy(), want)
    assert want.max() > 0


def test_sw_scores_defaults_and_ignored_scan_options():
    q = _codes(_seqs(2, 8, 5, 40), 40)
    t = _codes(_seqs(3, 8, 5, 40), 40)
    want = np.asarray(jalign.sw_scores(jnp.asarray(q), jnp.asarray(t),
                                       unroll=4, scan_chunk=8))
    for kw in ({}, {"unroll": 4, "scan_chunk": 8}):
        got = talign.sw_scores(torch.from_numpy(q), torch.from_numpy(t), **kw)
        np.testing.assert_array_equal(got.numpy(), want)  # "blast" default


@pytest.mark.parametrize("convention", ["blast", "mmseqs"])
def test_sw_scores_grouped_bit_equal(convention):
    q = _codes(_seqs(4, 5, 10, 70), 70)
    t = np.stack([_codes(_seqs(10 + g, 6, 1, 40), 40) for g in range(5)])
    t[1, 2] = -1  # an empty lane
    want = np.asarray(jalign.sw_scores_grouped(
        jnp.asarray(q), jnp.asarray(t), convention=convention))
    got = talign.sw_scores_grouped(torch.from_numpy(q), torch.from_numpy(t),
                                   convention=convention, scan_chunk=7)
    np.testing.assert_array_equal(got.numpy(), want)
    assert want[1, 2] == 0


@pytest.mark.parametrize("convention", [None, "blast", "mmseqs"])
@pytest.mark.parametrize("kw", [{}, {"pair_batch": 16, "db_residues": 1e6}])
def test_align_pairs_equal_jax(convention, kw):
    queries, targets = _seqs(5, 40, 1, 90), _seqs(6, 40, 1, 300)
    if convention is not None:  # None: both packages' default ("mmseqs")
        kw = dict(kw, convention=convention)
    want_s, want_e = jalign.align_pairs(queries, targets, bucket=128, **kw)
    got_s, got_e = talign.align_pairs(queries, targets, bucket=128,
                                      device="cpu", **kw)
    assert got_s.dtype == np.float32 and got_e.dtype == np.float32
    np.testing.assert_array_equal(got_s, want_s)
    np.testing.assert_allclose(got_e, want_e, rtol=1e-6)


def test_align_pairs_empty_and_mismatched():
    s, e = talign.align_pairs([], [], device="cpu")
    assert s.shape == e.shape == (0,)
    with pytest.raises(ValueError):
        talign.align_pairs(["ACD"], [], device="cpu")


def test_ops_exports_the_jax_names():
    for name in ("align_pairs", "sw_scores", "sw_scores_grouped",
                 "exact_topk_traced", "align_hits", "flat_topk",
                 "oneshot_topk", "streaming_topk", "hamming_topk"):
        assert name in tops.__all__ and callable(getattr(tops, name)), name
