"""The port's own copies of the JAX package's numpy modules (config, data,
eval, interop, utils) against the originals: the same inputs must give
equal outputs, and the MMseqs2 writers byte-equal files. The copies that
are verbatim (data/pfam.py, eval/analysis.py, eval/render.py,
utils/io.py) must also stay byte-equal to the originals."""

import dataclasses
from pathlib import Path

import numpy as np
import pytest

from knn_for_homology_tpu import config as jconfig
from knn_for_homology_tpu import interop as jinterop
from knn_for_homology_tpu.data import pfam as jpfam
from knn_for_homology_tpu.eval import analysis as janalysis
from knn_for_homology_tpu.data.dataset import Dataset as JDataset
from knn_for_homology_tpu.data.fasta import read_fasta as jread_fasta
from knn_for_homology_tpu.data.fixtures import make_clustered
from knn_for_homology_tpu.eval import metrics as jmetrics
from knn_for_homology_tpu_torch import config as tconfig
from knn_for_homology_tpu_torch import interop as tinterop
from knn_for_homology_tpu_torch.data import pfam as tpfam
from knn_for_homology_tpu_torch.eval import analysis as tanalysis
from knn_for_homology_tpu_torch.data.dataset import Dataset as TDataset
from knn_for_homology_tpu_torch.data.fasta import read_fasta as tread_fasta
from knn_for_homology_tpu_torch.eval import metrics as tmetrics

SEQS = {
    "q1 first query": "MKTAYIAKQRQISFVKSHFSRQ",
    "q2": "GSHMLEDPVAGK\nAQLLY",
    "t1 target": "MKTAYIAKQRQ",
    "t2": "XUZOBacdefgh",
}


@pytest.fixture()
def clustered(tmp_path):
    make_clustered(tmp_path, seed=7, n_families=6, n_train=5, n_test=3, dim=16)
    return tmp_path


def test_config_constants_equal():
    for name in ("DEFAULT_HITS", "E_VALUE_CUTOFF", "MAX_SEQ_LEN",
                 "DEFAULT_TOKEN_BATCH", "SENTINEL_E_VALUE"):
        assert getattr(tconfig, name) == getattr(jconfig, name), name
    assert dataclasses.asdict(tconfig.SearchConfig()) == dataclasses.asdict(
        jconfig.SearchConfig()
    )


def test_dataset_from_dir_equal(clustered):
    j, t = JDataset.from_dir(clustered, hits=7), TDataset.from_dir(clustered, hits=7)
    for field in ("path", "train", "train_ids", "test", "test_ids",
                  "ids_to_family", "train_sequences", "test_sequences", "hits"):
        assert getattr(t, field) == getattr(j, field), field
    assert t.family_names == j.family_names
    np.testing.assert_array_equal(t.train_family_codes, j.train_family_codes)
    np.testing.assert_array_equal(t.test_family_codes, j.test_family_codes)
    np.testing.assert_array_equal(t.train_family_sizes, j.train_family_sizes)
    np.testing.assert_array_equal(t.load_train(), j.load_train())


def test_evaluate_rows_equal(clustered):
    j, t = JDataset.from_dir(clustered, hits=5), TDataset.from_dir(clustered, hits=5)
    rng = np.random.RandomState(3)
    n_train, n_test = len(j.train_ids), len(j.test_ids)
    ids = rng.randint(-1, n_train, size=(n_test, 5))
    for a, b in zip(tmetrics.evaluate_rows(t, ids), jmetrics.evaluate_rows(j, ids)):
        np.testing.assert_array_equal(a, b)
    results = {q: [j.train_ids[i] for i in row if i >= 0]
               for q, row in zip(j.test_ids, ids)}
    for a, b in zip(tmetrics.evaluate_string_results(t, results.items()),
                    jmetrics.evaluate_string_results(j, results.items())):
        np.testing.assert_array_equal(a, b)


def test_read_fasta_equal(tmp_path):
    path = tmp_path / "x.fasta"
    path.write_text("".join(f">{h}\n{s}\n" for h, s in SEQS.items()))
    assert tread_fasta(path) == jread_fasta(path)
    assert tread_fasta(path, rename=lambda h: h.split()[0]) == jread_fasta(
        path, rename=lambda h: h.split()[0]
    )


def _files(root: Path):
    return {p.relative_to(root): p.read_bytes()
            for p in sorted(root.rglob("*")) if p.is_file()}


def test_mmseqs_writers_byte_equal(tmp_path):
    rng = np.random.RandomState(5)
    hits = rng.randint(-1, 40, size=(6, 4))
    scores = rng.randn(6, 4).astype(np.float32) * 50
    queries = np.arange(6)
    test_map, train_map = np.arange(6) + 100, np.arange(40) * 3
    entries = [(h, s.replace("\n", "")) for h, s in SEQS.items()]
    for name, mod in (("jax", jinterop), ("torch", tinterop)):
        out = tmp_path / name
        mod.write_prefilter_db(hits, out / "prefilter", queries, scores,
                               test_map, train_map)
        mod.write_sequence_db(entries, out / "seqdb")
    jfiles, tfiles = _files(tmp_path / "jax"), _files(tmp_path / "torch")
    assert sorted(jfiles) == sorted(tfiles)
    assert len(jfiles) >= 8
    for name in jfiles:
        assert tfiles[name] == jfiles[name], name


ROOT = Path(__file__).resolve().parent.parent


@pytest.mark.parametrize(
    "module", ["data/pfam.py", "eval/analysis.py", "eval/render.py",
               "utils/io.py"],
)
def test_verbatim_copies_byte_equal(module):
    port = ROOT / "knn_for_homology_tpu_torch" / module
    assert port.read_bytes() == (ROOT / "knn_for_homology_tpu" / module).read_bytes()


def test_pfam_homologs_and_analysis_equal():
    """get_homologous_proteins, remove_self_hit_lossy, score_calibration
    and per_query_precision_recall of the copies against the originals."""
    rng = np.random.RandomState(8)
    p2d = {f"P{i}": [(f"F{rng.randint(0, 5)}", (0, 40))]
           + ([(f"F{rng.randint(5, 8)}", (50, 90))] if i % 3 == 0 else [])
           for i in range(40)}
    assert tpfam.get_homologous_proteins(p2d) == jpfam.get_homologous_proteins(p2d)
    hits = rng.randint(-1, 40, size=(40, 15))
    hits[::4, 6] = np.arange(40)[::4]
    scores = -np.sort(-rng.rand(40, 15), axis=1)
    for a, b in zip(tanalysis.remove_self_hit_lossy(hits, scores, np.arange(40)),
                    janalysis.remove_self_hit_lossy(hits, scores, np.arange(40))):
        np.testing.assert_array_equal(a, b)
    correct = rng.rand(40, 15) < 0.4
    got = tanalysis.score_calibration(scores, correct)
    want = janalysis.score_calibration(scores, correct)
    assert sorted(got) == sorted(want)
    for key in want:
        np.testing.assert_array_equal(got[key], want[key])
    totals = rng.randint(0, 20, size=40)
    for a, b in zip(tanalysis.per_query_precision_recall(scores, correct, totals),
                    janalysis.per_query_precision_recall(scores, correct, totals)):
        np.testing.assert_array_equal(a, b)
