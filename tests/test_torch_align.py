"""The port's Smith-Waterman layer against the JAX package, on the CPU:
tables and encoding equal, kernel C's plain version BIT-equal to the Pallas
kernel in interpret mode (both conventions, classic and ragged lanes), the
host planners emitting identical cells, and align_hits giving equal scores
and E-values within rtol 1e-6 (XLA's and torch's float32 exp differ in the
last ulp)."""

import re
from pathlib import Path

import numpy as np
import pytest
import torch

from knn_for_homology_tpu.ops import align as jalign
from knn_for_homology_tpu.ops import align_pallas as jpallas
from knn_for_homology_tpu_torch.ops import align as talign
from knn_for_homology_tpu_torch.ops import align_cuda
from test_align_pallas import _ragged_workload, _workload

AAS = "ACDEFGHIKLMNPQRSTVWY"


def test_tables_and_constants_equal_jax():
    np.testing.assert_array_equal(talign.BLOSUM62, jalign.BLOSUM62)
    assert talign.BLOSUM62.dtype == jalign.BLOSUM62.dtype
    assert talign.ALIGN_ALPHABET == jalign.ALIGN_ALPHABET
    assert talign.AA_INDEX == jalign.AA_INDEX
    assert talign.GAP_FIRST == jalign.GAP_FIRST
    assert (talign.GAP_OPEN, talign.GAP_EXT) == (jalign.GAP_OPEN, jalign.GAP_EXT)
    assert (talign.KA_LAMBDA, talign.KA_K) == (jalign.KA_LAMBDA, jalign.KA_K)
    assert talign.NEG == jalign.NEG
    assert talign.MAX_LT_K_HBM == jpallas.MAX_LT_K_HBM
    assert talign.MAX_SEGMENTS == jpallas.MAX_SEGMENTS
    assert align_cuda.SEG_BIG == jpallas.SEG_BIG


@pytest.mark.parametrize(
    "seq,length", [("ACDW", 6), ("acdwxz*", 7), ("BJOU?", 5), ("MKV" * 9, 10)]
)
def test_encode_sequence_equal(seq, length):
    np.testing.assert_array_equal(
        talign.encode_sequence(seq, length), jalign.encode_sequence(seq, length)
    )


@pytest.mark.parametrize("convention", ["blast", "mmseqs"])
def test_plain_sw_bit_equal_to_pallas(convention):
    q, t = _workload()
    want = np.asarray(jpallas.sw_scores_grouped_pallas(
        q, t, convention=convention, interpret=True
    ))
    got = align_cuda.sw_scores_grouped(
        torch.from_numpy(q), torch.from_numpy(t), convention=convention
    ).numpy()
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("convention", ["blast", "mmseqs"])
def test_plain_sw_ragged_bit_equal_to_pallas(convention):
    _, q, t, _ = _ragged_workload()
    want = np.asarray(jpallas.sw_scores_grouped_pallas(
        q, t, convention=convention, segments=4, max_seg_len=64,
        interpret=True,
    ))
    got = align_cuda.sw_scores_grouped(
        torch.from_numpy(q), torch.from_numpy(t), convention=convention,
        segments=4, max_seg_len=64,
    ).numpy()
    assert got.shape == (3, 4, 128)
    np.testing.assert_array_equal(got, want)


def test_plain_sw_default_convention_is_blast():
    q, t = _workload(seed=9, g=2, lq=64, lt=96)
    tq, tt = torch.from_numpy(q), torch.from_numpy(t)
    np.testing.assert_array_equal(
        align_cuda.sw_scores_grouped(tq, tt).numpy(),
        align_cuda.sw_scores_grouped(tq, tt, convention="blast").numpy(),
    )


def test_plain_sw_interior_pads_match_xla_kernel():
    # a query pad row knocks out substitutions but gaps run through it;
    # an interior target pad is a knocked-out column (classic lanes)
    q, t = _workload(seed=19, g=2, lq=48, lt=64)
    q[:, 7] = -1
    t[:, :, 11] = -1
    want = np.asarray(jalign.sw_scores_grouped(q, t, convention="mmseqs"))
    got = align_cuda.sw_scores_grouped(
        torch.from_numpy(q), torch.from_numpy(t), convention="mmseqs"
    ).numpy()
    np.testing.assert_array_equal(got, want)


def _pairs(seed, n_q=30, k=13):
    rng = np.random.RandomState(seed)
    lens = np.clip(rng.lognormal(np.log(120), 0.55, size=n_q * (k + 1)), 20, 700)
    seqs = ["".join(rng.choice(list(AAS), int(n))) for n in lens]
    queries = seqs[:n_q]
    hits = [
        [seqs[n_q + (i * k + j) % (len(seqs) - n_q)] for j in range(k)]
        for i in range(n_q)
    ]
    hits[3] = []  # a query without hits
    # one long query with many short hits: its group packs ragged lanes
    queries[0] = "".join(rng.choice(list(AAS), 900))
    hits[0] = [
        "".join(rng.choice(list(AAS), int(n)))
        for n in rng.randint(15, 130, size=300)
    ]
    return queries, hits


@pytest.mark.parametrize("ragged", [True, False])
def test_planners_emit_identical_cells(ragged):
    queries, hits = _pairs(1)
    want = jalign.plan_align_cells(queries, hits, ragged=ragged)
    got = talign.plan_align_cells(queries, hits, ragged=ragged)
    assert got == want
    assert list(talign.iter_align_blocks(got)) == list(
        jalign.iter_align_blocks(want)
    )
    if ragged:
        assert any(s_b > 1 for (_, _, s_b) in got)


def test_align_hits_matches_jax():
    # short sequences keep every cell at the 128 bucket: two dispatch
    # blocks (one classic, one ragged) in the JAX interpret run
    rng = np.random.RandomState(2)
    seq = lambda lo, hi: "".join(rng.choice(list(AAS), rng.randint(lo, hi)))
    queries = [seq(20, 100) for _ in range(6)]
    hits = [[seq(20, 100) for _ in range(4)] for _ in range(6)]
    hits[2] = []
    hits[0] = [seq(10, 20) for _ in range(140)]
    cells = talign.plan_align_cells(queries, hits)
    assert {key[:2] for key in cells} == {(128, 128)}
    assert any(s_b > 1 for (_, _, s_b) in cells)
    want_s, want_e = jalign.align_hits(queries, hits)
    got_s, got_e = talign.align_hits(queries, hits, device="cpu")
    assert len(got_s) == len(want_s)
    for gs, ws, ge, we in zip(got_s, want_s, got_e, want_e):
        np.testing.assert_array_equal(gs, ws)
        np.testing.assert_allclose(ge, we, rtol=1e-6)
        assert ge.dtype == np.float32


def test_e_values_float32():
    s = np.asarray([0.0, 25.0, 80.0, 300.0], np.float32)
    m = np.asarray([50, 330, 1, 0], np.float32)
    got = talign.e_values(torch.from_numpy(s), torch.from_numpy(m), 4.2e7)
    want = np.asarray(jalign.e_values(s, m, 4.2e7))
    assert got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-6)


def test_sw_wrapper_rejects_bad_inputs():
    q = torch.zeros((2, 8), dtype=torch.int32)
    t = torch.zeros((2, 4, 8), dtype=torch.int32)
    with pytest.raises(ValueError, match="segments"):
        align_cuda.sw_scores_grouped(q, t, segments=64)
    with pytest.raises(TypeError):
        align_cuda.sw_scores_grouped(q.float(), t)
    with pytest.raises(ValueError, match="disagree"):
        align_cuda.sw_scores_grouped(q[:1], t)
    with pytest.raises(ValueError, match="convention"):
        align_cuda.sw_scores_grouped(q, t, convention="nw")


def test_kernel_sources_name_what_they_replace():
    csrc = Path(align_cuda.__file__).resolve().parent.parent / "csrc"
    for name, replaces in [
        ("flat_topk.cu", "flat_pallas.py:_flat_topk_kernel"),
        ("segment_topr.cu", "exact_pallas.py:_segment_topr_kernel"),
        ("sw_grouped.cu", "align_pallas.py:_sw_kernel"),
    ]:
        text = (csrc / name).read_text()
        assert replaces in text
        assert re.search(r'extern "C" int knn_\w+\(', text)

