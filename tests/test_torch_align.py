"""The port's Smith-Waterman layer against the JAX package, on the CPU:
tables and encoding equal, kernel C's plain version BIT-equal to the Pallas
kernel in interpret mode (both conventions, classic and ragged lanes), the
host planners emitting identical cells, and align_hits giving equal scores
and E-values within rtol 1e-6 (XLA's and torch's float32 exp differ in the
last ulp)."""

import functools
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


def _crowded_lane_pairs(seed=5):
    """One 300-aa row with 300 two-residue hits: ragged packing puts 42
    targets (3 residues each with the separator) into a 128-residue lane."""
    rng = np.random.RandomState(seed)
    seq = lambda n: "".join(rng.choice(list(AAS), n))  # noqa: E731
    return [seq(300), seq(60)], [[seq(2) for _ in range(300)], [seq(50)]]


def test_crowded_lane_plans_at_most_63_segments(monkeypatch):
    # the reference rounds 33-63 targets up to 64 segments, which no
    # kernel takes; the port caps the row at MAX_SEGMENTS and otherwise
    # plans as the reference does
    queries, hits = _crowded_lane_pairs()
    want = jalign.plan_align_cells(queries, hits)
    got = talign.plan_align_cells(queries, hits)
    fullest = max(len(lane) for cells in got.values() for _, lanes in cells
                  for lane in lanes)
    assert 33 <= fullest <= talign.MAX_SEGMENTS
    assert {key[2] for key in want} == {1, 64}
    assert {key[2] for key in got} == {1, talign.MAX_SEGMENTS}
    assert {k: v for k, v in got.items() if k[2] == 1} == {
        k: v for k, v in want.items() if k[2] == 1}
    assert [v for k, v in got.items() if k[2] > 1] == [
        v for k, v in want.items() if k[2] > 1]

    ragged_s, ragged_e = talign.align_hits(queries, hits, device="cpu")
    plan = talign.plan_align_cells
    monkeypatch.setattr(talign, "plan_align_cells",
                        lambda *a, **kw: plan(*a, **kw, ragged=False))
    classic_s, classic_e = talign.align_hits(queries, hits, device="cpu")
    assert (ragged_s[0] > 0).mean() > 0.5
    for rs, cs, re_, ce in zip(ragged_s, classic_s, ragged_e, classic_e):
        np.testing.assert_array_equal(rs, cs)
        np.testing.assert_array_equal(re_, ce)


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


def _family_pairs(seed=3, n_fam=6, members=14):
    """make_clustered-style families: each family's sequences are mutated
    copies of one ancestor (30% substitutions, ends trimmed), and each
    family's first member is a query whose hits are the other 13; plus one
    long query with 150 short hits, whose group packs ragged lanes."""
    rng = np.random.RandomState(seed)
    queries, hits = [], []
    for _ in range(n_fam):
        n = int(rng.randint(30, 110))
        ancestor = rng.choice(list(AAS), n)
        family = []
        for _ in range(members):
            seq = ancestor.copy()
            mutate = rng.rand(n) < 0.3
            seq[mutate] = rng.choice(list(AAS), int(mutate.sum()))
            lo, hi = rng.randint(0, 5, 2)
            family.append("".join(seq[lo : n - hi]))
        queries.append(family[0])
        hits.append(family[1:])
    queries.append("".join(rng.choice(list(AAS), 120)))
    hits.append(["".join(rng.choice(list(AAS), int(n)))
                 for n in rng.randint(8, 30, size=150)])
    return queries, hits


@functools.lru_cache(maxsize=None)
def _family_reference():
    """(queries, hits, JAX align_hits scores and E-values, the port's
    scores through the reference's blocks), once per process."""
    queries, hits = _family_pairs()
    want_s, want_e = jalign.align_hits(queries, hits)
    plain_s, _ = talign.align_hits(queries, hits, device="cpu")
    return queries, hits, want_s, want_e, plain_s


@pytest.mark.parametrize("max_bytes", [talign.CARD_BLOCK_BYTES, 3 * 128 * 128])
def test_card_plan_scores_equal_jax_plan(monkeypatch, max_bytes):
    # the card's blocks (a cell's groups in as few launches as max_bytes of
    # int8 lane codes allow, no padding groups; here also three groups a
    # launch) through the plain version score every pair as the JAX plan's
    # blocks and the JAX align_hits do: the scores are exact integers
    queries, hits, want_s, want_e, plain_s = _family_reference()
    monkeypatch.setattr(talign, "CARD_BLOCK_BYTES", max_bytes)
    cells = talign.plan_align_cells(queries, hits)
    assert {key[2] > 1 for key in cells} == {True, False}
    card = list(talign.iter_card_blocks(cells, 128))
    jax_blocks = list(talign.iter_align_blocks(cells))
    assert [b[4] for b in card] != [b[4] for b in jax_blocks]
    assert sum(b[4] for b in card) == sum(len(rows) for rows in cells.values())
    monkeypatch.setattr(talign, "iter_align_blocks", lambda cells, g_block:
                        talign.iter_card_blocks(cells, 128))
    got_s, got_e = talign.align_hits(queries, hits, device="cpu")
    assert (np.concatenate(want_s) > 0).mean() > 0.9
    for gs, ps, ws, ge, we in zip(got_s, plain_s, want_s, got_e, want_e):
        np.testing.assert_array_equal(gs, ws)
        np.testing.assert_array_equal(ps, ws)
        np.testing.assert_allclose(ge, we, rtol=1e-6)


def test_lane_codes_int8_layout():
    # [G, K, Lt] int8: a lane's targets contiguous, -1 separators and pads;
    # K is the fullest group's lane count, g_pad rows past the block pad
    block = [("ACDE", [[("KLM", 0, 0), ("W", 0, 1)], [("PQRS", 1, 0)]]),
             ("MKV", [[("GG", 2, 0)]])]
    q, t = talign.lane_codes(block, 8, 10, 3)
    assert q.dtype == np.int32 and q.shape == (3, 8)
    assert t.dtype == np.int8 and t.shape == (3, 2, 10)
    np.testing.assert_array_equal(q[0], talign.encode_sequence("ACDE", 8))
    enc = lambda x: list(talign.encode_sequence(x, len(x)))  # noqa: E731
    assert list(t[0, 0]) == enc("KLM") + [-1] + enc("W") + [-1] * 5
    assert list(t[0, 1]) == enc("PQRS") + [-1] * 6
    assert list(t[1, 0]) == enc("GG") + [-1] * 8 and (t[1, 1] == -1).all()
    assert (t[2] == -1).all() and (q[2] == -1).all()


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

