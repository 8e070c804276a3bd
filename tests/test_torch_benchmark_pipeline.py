"""The slice as a whole: the reference's `seqvec_search` benchmark
(kNN → AUC1/TP → Smith-Waterman rescoring → AUC1/TP) through the JAX
package and through the port (CPU, plain versions) on the clustered
fixture. kNN ids, the E-value order of the aligned hits and every AUC1/TP
value must be identical. The JAX side runs once per module (its aligner
runs the Pallas kernel in interpret mode, the slow part)."""

import numpy as np
import pytest

from knn_for_homology_tpu.data import Dataset
from knn_for_homology_tpu.data.fixtures import make_clustered
from knn_for_homology_tpu.eval.metrics import (
    evaluate_rows,
    evaluate_string_results,
)
from knn_for_homology_tpu.search.flat import knn_search as j_knn
from knn_for_homology_tpu.search.rescore import align_rescore as j_rescore
from knn_for_homology_tpu_torch.pipelines import benchmark as tbench
from knn_for_homology_tpu_torch.search.flat import knn_search as t_knn
from knn_for_homology_tpu_torch.search.rescore import (
    align_evalues_row_aligned,
    align_rescore as t_rescore,
)


@pytest.fixture(scope="module")
def dataset_dir(tmp_path_factory):
    path = tmp_path_factory.mktemp("clustered")
    make_clustered(path, seed=1234, n_families=8, n_train=6, n_test=3, dim=32)
    return path


@pytest.fixture(scope="module")
def jax_side(dataset_dir):
    """The reference path's intermediate results, hits = 13."""
    data = Dataset.from_dir(dataset_dir)
    ids, _, _ = j_knn(data.load_train(), data.load_test(), 13)
    hits, evs, _ = j_rescore(data, ids)
    return data, ids, hits, evs


def test_knn_ids_and_aligned_order_match_jax(jax_side):
    data, j_ids, j_hits, j_evs = jax_side
    t_ids, _, _ = t_knn(data.load_train(), data.load_test(), 13, device="cpu")
    np.testing.assert_array_equal(t_ids, j_ids)
    t_hits, t_evs, _ = t_rescore(data, t_ids, device="cpu")
    assert t_hits == j_hits  # same hits, same E-value order, same cutoff
    for name in j_evs:
        np.testing.assert_allclose(t_evs[name], j_evs[name], rtol=1e-6)
    rows = align_evalues_row_aligned(data, t_ids, device="cpu")
    assert rows.shape == t_ids.shape and np.all(np.isfinite(rows))


def test_benchmark_run_matches_jax(dataset_dir, jax_side):
    # the reference run() scores exactly these two result sets
    data, j_ids, j_hits, _ = jax_side
    want = [evaluate_rows(data, j_ids),
            evaluate_string_results(data, j_hits.items())]
    got = tbench.run(dataset_dir, hits=13, figures=False, device="cpu")
    assert [r[0] for r in got] == ["k-NN", "k-NN + Alignment"]
    for (_, auc1s, tps, seconds), (w_auc1s, w_tps) in zip(got, want):
        assert auc1s == w_auc1s and tps == w_tps
        assert seconds >= 0.0


def test_knn_k40_matches_jax(dataset_dir):
    data = Dataset.from_dir(dataset_dir)
    train, test = data.load_train(), data.load_test()
    j_ids, j_scores, _ = j_knn(train, test, 40)
    t_ids, t_scores, _ = t_knn(train, test, 40, device="cpu")
    np.testing.assert_array_equal(t_ids, j_ids)
    np.testing.assert_allclose(t_scores, j_scores, rtol=1e-5, atol=1e-6)
    assert evaluate_rows(data, t_ids) == evaluate_rows(data, j_ids)


def test_cli_main_runs_on_cpu(dataset_dir, capsys):
    tbench.main([str(dataset_dir), "--no-figures", "--device", "cpu"])
    out = capsys.readouterr().out
    assert "k-NN + Alignment" in out and "name" in out
