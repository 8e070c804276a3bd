"""The plain references: Smith-Waterman against a direct Gotoh recursion,
the T5 reference against the port's encoder in float32, the quantisation
against the port's, TF32 rounding; and that no reference module can load
JAX, the JAX package or the port."""

import ast
import random
import subprocess
import sys

import numpy as np
import pytest
import torch

from portbench.lib import harness, traffic
from portbench.reference import search as ref_search
from portbench.reference import sw as ref_sw
from portbench.reference import t5 as ref_t5

REF_DIR = harness.ROOT / "portbench" / "reference"
BANNED = {"jax", "jaxlib", "flax", "knn_for_homology_tpu",
          "knn_for_homology_tpu_torch"}


def gotoh(a: str, b: str, cap=None) -> int:
    """Direct O(n·m) local alignment with gaps 11 + (n - 1)."""
    sub = ref_sw.BLOSUM62
    ix = {c: i for i, c in enumerate(ref_sw.ALPHABET)}
    neg = -10**9
    h = [[0] * (len(b) + 1) for _ in range(len(a) + 1)]
    e = [[neg] * (len(b) + 1) for _ in range(len(a) + 1)]
    f = [[neg] * (len(b) + 1) for _ in range(len(a) + 1)]
    best = 0
    for i in range(1, len(a) + 1):
        for j in range(1, len(b) + 1):
            e[i][j] = max(h[i - 1][j] - 11, e[i - 1][j] - 1)
            f[i][j] = max(h[i][j - 1] - 11, f[i][j - 1] - 1)
            v = max(0, h[i - 1][j - 1] + int(sub[ix[a[i - 1]], ix[b[j - 1]]]),
                    e[i][j], f[i][j])
            h[i][j] = v if cap is None else min(v, cap)
            best = max(best, h[i][j])
    return best


def test_sw_matches_gotoh():
    rnd = random.Random(3)
    aas = "ACDEFGHIKLMNPQRSTVWY"
    qs, ts = [], []
    for n in range(40):
        base = "".join(rnd.choice(aas) for _ in range(rnd.randint(1, 40)))
        other = "".join(c if rnd.random() > 0.3 else rnd.choice(aas)
                        for c in base)
        cut = rnd.randint(0, len(other) // 2)
        qs.append(base)
        ts.append(other[cut:] + "".join(rnd.choice(aas) for _ in range(
            rnd.randint(0, 9))))
    got = ref_sw.scores(qs, ts, "cpu")
    assert list(got) == [gotoh(a, b) for a, b in zip(qs, ts)]
    assert list(ref_sw.scores(qs, ts, "cpu", cap=20)) == [
        gotoh(a, b, cap=20) for a, b in zip(qs, ts)]


def test_sw_matches_program_plain_route():
    from knn_for_homology_tpu_torch.ops.align import align_hits

    gen = np.random.default_rng(5)
    seqs = traffic.family_sequences(5, [30, 50, 70], 5, 0.3, 0.05, "cpu")
    members = [s for i, s in enumerate(seqs) if i % 5 < 4]
    held = seqs[4::5]
    hits = [members[4 * f:4 * f + 4] for f in range(3)]
    sw, evs = align_hits(held, hits, db_residues=1e6, device="cpu")
    flat_q = [q for q, row in zip(held, hits) for _ in row]
    flat_t = [t for row in hits for t in row]
    want = ref_sw.scores(flat_q, flat_t, "cpu")
    assert np.array_equal(np.concatenate(sw), want)
    ev = ref_sw.e_values(want, [len(q) for q in flat_q], 1e6)
    np.testing.assert_allclose(np.concatenate(evs), ev, rtol=1e-6)
    del gen


def test_t5_reference_matches_port_in_float32():
    from knn_for_homology_tpu_torch.models import t5

    cfg = {"vocab_size": 128, "d_model": 32, "d_kv": 8, "d_ff": 64,
           "num_layers": 2, "num_heads": 4,
           "relative_attention_num_buckets": 32,
           "relative_attention_max_distance": 128,
           "layer_norm_epsilon": 1e-6}
    weights = traffic.t5_weights(cfg, 4, "cpu", torch.float32)
    seqs = traffic.random_sequences(np.random.default_rng(1), [5, 17, 40])
    want = ref_t5.pooled(weights, seqs, cfg)
    tcfg = t5.T5Config(vocab_size=128, d_model=32, d_kv=8, d_ff=64,
                       num_layers=2, num_heads=4, dtype=torch.float32)
    got = []
    for s in seqs:
        ids = torch.from_numpy(t5.tokenize(s))[None].long()
        hidden = t5.encode(weights, ids, torch.ones_like(ids, dtype=bool),
                           tcfg)
        got.append(hidden[0, :-1].mean(0))
    torch.testing.assert_close(torch.stack(got), want, rtol=1e-4,
                               atol=1e-5)
    # the fp8 control lies well away from float32
    ctl = ref_t5.pooled(weights, seqs, cfg, quant=ref_t5.fp8_round)
    assert float((ctl - want).norm(dim=1).max()) > 1e-3


def test_quantize_matches_port_codes():
    from knn_for_homology_tpu_torch.ops.packed_cuda import quantize_int8

    x = torch.randn(64, 48, generator=torch.Generator().manual_seed(2))
    codes, scale = ref_search.quantize(x, 127)
    port, pscale = quantize_int8(x)
    assert torch.equal(codes.to(torch.int8), port)
    torch.testing.assert_close(scale, pscale.double(), rtol=1e-6, atol=0)


def test_tf32_round():
    x = torch.tensor([1.0, 1.0 + 2**-11, 1.0 + 2**-10, 3.14159265])
    y = ref_search.tf32_round(x)
    assert y[0] == 1.0 and y[1] == 1.0 + 2**-10 and y[2] == 1.0 + 2**-10
    assert abs(float(y[3]) - 3.14159265) <= 2**-10 * 2


def test_hit_gap_reads_ties_as_zero_and_repeats_as_misses():
    rows = torch.tensor([[1.0, 0.0], [1.0, 0.0], [0.0, 1.0], [1.0, 1.0]])
    q = torch.tensor([[1.0, 0.0]])
    assert ref_search.hit_gap(q, rows, torch.tensor([[1, 0]]), 2) == 0.0
    assert ref_search.hit_gap(q, rows, torch.tensor([[0, 0]]), 2) == \
        float("inf")
    assert ref_search.hit_gap(q, rows, torch.tensor([[0, 3]]), 2) == \
        pytest.approx(1 - 2**-0.5)


def test_hit_err_reads_returned_scores_against_exact_cosines():
    rows = torch.tensor([[1.0, 0.0], [1.0, 1.0], [0.0, 1.0]])
    q = torch.tensor([[1.0, 0.0]])
    ids = torch.tensor([[0, 1]])
    exact = [[1.0, 2**-0.5]]
    assert ref_search.hit_err(q, rows, ids, exact, 2) == pytest.approx(
        0.0, abs=1e-15)
    assert ref_search.hit_err(q, rows, ids, [[1.0, 2**-0.5 + 1e-4]],
                              2) == pytest.approx(1e-4)
    assert ref_search.hit_err(q, rows, torch.tensor([[0, 2]]),
                              [[1.0, 0.0]], 2) == pytest.approx(2**-0.5)


@pytest.mark.parametrize("path", sorted(REF_DIR.glob("*.py")),
                         ids=lambda p: p.name)
def test_reference_imports_nothing_banned(path):
    tree = ast.parse(path.read_text())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names = [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom):
            names = [node.module or ""] if node.level == 0 else []
        else:
            continue
        for name in names:
            assert name.split(".")[0] not in BANNED, (path.name, name)


def test_reference_loads_nothing_banned():
    code = (
        "import sys; sys.path.insert(0, sys.argv[1]);"
        "import portbench.reference.t5, portbench.reference.search,"
        " portbench.reference.sw;"
        "print(sorted({m.split('.')[0] for m in sys.modules}"
        " & set(sys.argv[2:])))")
    out = subprocess.run([sys.executable, "-c", code, str(harness.ROOT),
                          *sorted(BANNED)], capture_output=True, text=True,
                         timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "[]"
