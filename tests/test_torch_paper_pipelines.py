"""The port's paper pipelines against the JAX package on the CPU, each on one
seeded input: the Pfam20 domain workload (pipelines/pfam_domains.py, with
the fake `mmseqs` of tests/fake_mmseqs.py), CATH20 (pipelines/cath.py), the
harness sweeps, the slices pipeline, the scrambled-sequence control, the
layer-mix sweep, the full-protein pipeline's lsh mode and the CLI hub.

Tolerances:
  * metrics computed from equal ids (kNN, MMseqs2, overlaps, top-1
    accuracies): within 1e-9, i.e. equal but for summation order;
  * metrics of alignment-rescored hits: the same bound. They depend only on
    the order of the aligned hits, which the port reproduces exactly
    (tests/test_torch_benchmark_pipeline.py holds the E-values to rtol
    1e-6 and the order exactly);
  * cosine / l2 scores of the flat search: rtol 1e-5 (fp32 sums of d
    products in another order); their ids equal.
"""

import shutil
import stat
import sys
from pathlib import Path

import numpy as np
import pytest

from knn_for_homology_tpu.data import Dataset as JDataset
from knn_for_homology_tpu.data.fixtures import make_clustered
from knn_for_homology_tpu.pipelines import cath as jcath
from knn_for_homology_tpu.pipelines import harness as jharness
from knn_for_homology_tpu.pipelines import layer_mix as jmix
from knn_for_homology_tpu.pipelines import pfam_domains as jdomains
from knn_for_homology_tpu.pipelines import pfam_proteins as jproteins
from knn_for_homology_tpu.pipelines import reverse as jreverse
from knn_for_homology_tpu.pipelines import slices_pipeline as jslices
from knn_for_homology_tpu.search import io as jio
from knn_for_homology_tpu.search.lsh import LSHIndex as JLSHIndex
from knn_for_homology_tpu_torch import __main__ as thub
from knn_for_homology_tpu_torch.data.dataset import Dataset as TDataset
from knn_for_homology_tpu_torch.pipelines import cath as tcath
from knn_for_homology_tpu_torch.pipelines import harness as tharness
from knn_for_homology_tpu_torch.pipelines import layer_mix as tmix
from knn_for_homology_tpu_torch.pipelines import pfam_domains as tdomains
from knn_for_homology_tpu_torch.pipelines import pfam_proteins as tproteins
from knn_for_homology_tpu_torch.pipelines import reverse as treverse
from knn_for_homology_tpu_torch.pipelines import slices_pipeline as tslices
from knn_for_homology_tpu_torch.search.lsh import LSHIndex as TLSHIndex

TOL = 1e-9
RTOL = 1e-5


def _clustered(path):
    make_clustered(path, seed=1234, n_families=8, n_train=6, n_test=3, dim=32)
    return path


@pytest.fixture()
def fake_mmseqs(tmp_path, monkeypatch):
    """The fake binary, installed as tests/test_pipelines.py does."""
    stub = tmp_path / "mmseqs"
    fake = Path(__file__).parent / "fake_mmseqs.py"
    stub.write_text(f"#!/bin/sh\nexec {sys.executable} {fake} \"$@\"\n")
    stub.chmod(stub.stat().st_mode | stat.S_IEXEC)
    monkeypatch.setenv("MMSEQS_PATH", str(stub))
    return stub


def _same_summary(got, want, keys=None):
    keys = sorted(want) if keys is None else keys
    for key in keys:
        assert abs(got[key] - want[key]) <= TOL, (key, got[key], want[key])


def test_pfam_domains_run_matches_jax(tmp_path, fake_mmseqs, monkeypatch):
    """LSH search, alignment rescoring, the (fake) MMseqs2 baselines, the
    E-value cutoff sweep, the TP overlap and the merged ranking; then the
    port on the JAX package's index file, and without the binary."""
    kw = dict(hits=40, lsh_bits=256, rescore_hits=5)
    want = jdomains.run(_clustered(tmp_path / "j"), **kw)
    got = tdomains.run(_clustered(tmp_path / "t"), device="cpu", **kw)
    assert sorted(got) == sorted(want)
    assert "combined_auc1" in want and "tp_overlap_both" in want
    _same_summary(got, want)

    data = JDataset.from_dir(tmp_path / "j")
    index = JLSHIndex(32, nbits=256).add(data.load_train())
    jio.write_index(index, tmp_path / "lsh.index")
    monkeypatch.delenv("MMSEQS_PATH")
    alone = tdomains.run(tmp_path / "t", index_path=tmp_path / "lsh.index",
                         device="cpu", **kw)
    assert sorted(alone) == sorted(k for k in want if k.startswith("knn"))
    _same_summary(alone, want, sorted(alone))


def test_pad_ragged_matches_jax():
    hits = [np.asarray([3, 1]), np.zeros(0, np.int64), np.asarray([7])]
    evs = [np.asarray([1e-3, 2.0]), np.zeros(0), np.asarray([5.0])]
    for a, b in zip(tdomains._pad_ragged(hits, evs),
                    jdomains._pad_ragged(hits, evs)):
        np.testing.assert_array_equal(a, b)


def _cath_dir(root, rng_seed=8, n=60, d=16):
    rng = np.random.RandomState(rng_seed)
    fams = np.repeat(np.arange(10), 6)
    emb = (rng.randn(10, d) * 9)[fams] + rng.randn(n, d)
    ids = [f"dom{i:03d}" for i in range(n)]
    data_dir = root / "data"
    data_dir.mkdir(parents=True)
    np.save(data_dir / "MethodA.npy", emb.astype(np.float16))
    np.save(data_dir / "MethodB.npy", rng.randn(n, d).astype(np.float32))
    import json

    (data_dir / "ids.json").write_text(
        json.dumps([f"cath|4_2_0|{i}/1-50" for i in ids])
    )
    clf = root / "clf.txt"
    with open(clf, "w") as fp:
        for i, name in enumerate(ids):
            c, a, t, h = 1 + i % 3, 10 + fams[i] % 4, 8, int(fams[i]) + 1
            fp.write(
                f"{name:<7}{c:>6}{a:>6}{t:>6}{h:>6}     1     1     1     1"
                "     1    50 1.000\n"
            )
    mm = {"is_correct_top1": rng.rand(n) > 0.5,
          "e_values_top1": 10.0 ** rng.uniform(-10, 2, n)}
    return data_dir, clf, mm


@pytest.mark.parametrize("metric", ["cosine", "l2"])
def test_cath_search_and_report_match_jax(tmp_path, metric):
    j_dir, clf, mm = _cath_dir(tmp_path / "j")
    t_dir, _, _ = _cath_dir(tmp_path / "t")
    jcath.search_and_save(j_dir, hits=5)
    tcath.search_and_save(t_dir, hits=5, device="cpu")
    name = "cosine" if metric == "cosine" else "euclidean"
    for kind in ("hits", "scores"):
        with np.load(j_dir / f"{kind}_{name}.npz") as a, np.load(
            t_dir / f"{kind}_{name}.npz"
        ) as b:
            assert sorted(a.files) == sorted(b.files) == ["MethodA", "MethodB"]
            for key in a.files:
                assert b[key].shape == a[key].shape == (60, 5)
                if kind == "hits":
                    np.testing.assert_array_equal(b[key], a[key])
                else:  # l2: 2q·d − |q|² − |d|², so ulps of the norms
                    x = np.load(t_dir / f"{key}.npy").astype(np.float32)
                    scale = 2 * float((x * x).sum(1).max()) if (
                        metric == "l2") else 1.0
                    np.testing.assert_allclose(b[key], a[key], rtol=RTOL,
                                               atol=RTOL * scale)
    assert (t_dir / f"MethodA.{name}-search-time.txt").exists()

    # the evaluation on the same hits and scores: a rank correlation over
    # the queries' top scores sees their ulps (and fp16 rows tie exactly)
    for kind in ("hits", "scores"):
        shutil.copy(j_dir / f"{kind}_{name}.npz", t_dir / f"{kind}_{name}.npz")
    kw = dict(metric=metric, mmseqs_results=mm, render=False)
    want = jcath.evaluate_and_report(j_dir, clf, tmp_path / "jf", **kw)
    got = tcath.evaluate_and_report(t_dir, clf, tmp_path / "tf", **kw)
    assert sorted(got) == sorted(want)
    for key in want:
        assert got[key] == want[key], key
    assert ("correlation" in want) == (metric == "cosine")
    assert ((tmp_path / "tf" / "accuracies.md").read_text()
            == (tmp_path / "jf" / "accuracies.md").read_text())
    for path in sorted((tmp_path / "jf").glob("*.npz")):
        with np.load(path) as a, np.load(tmp_path / "tf" / path.name) as b:
            for key in a.files:
                np.testing.assert_array_equal(b[key], a[key])


def test_cath_evaluation_top1_matches_jax():
    rng = np.random.RandomState(12)
    ids = np.asarray([f"d{i}" for i in range(40)])
    fams = rng.randint(0, 9, 40)  # nine superfamilies, some of one domain
    codes = [f"{1 + f % 2}.{f % 3}.{f % 4}.{f}" for f in fams]
    levels = {i: tuple(c.rsplit(".", k)[0] for k in range(4))
              for i, c in zip(ids, codes)}
    array = np.asarray([levels[i] for i in ids])
    hits = rng.randint(-1, 40, size=(40, 4))
    t, j = (mod.CathEvaluation(ids, levels, array) for mod in (tcath, jcath))
    ct, cj = t.compute_is_correct(hits), j.compute_is_correct(hits)
    np.testing.assert_array_equal(ct, cj)
    assert t.top1(ct) == j.top1(cj) and 0 < t.top1(ct)[0] < 1
    assert t.per_level_accuracy(ct) == j.per_level_accuracy(cj)
    assert t.format_table(t.accuracy_table({"M": hits})) == j.format_table(
        j.accuracy_table({"M": hits}))


@pytest.fixture(scope="module")
def harness_data(tmp_path_factory):
    return _clustered(tmp_path_factory.mktemp("harness"))


@pytest.mark.parametrize("rescore, counts", [(False, (20, 5)), (True, (6,))])
def test_hit_count_sweep_matches_jax(harness_data, rescore, counts):
    j_ds, t_ds = JDataset.from_dir(harness_data), TDataset.from_dir(harness_data)
    j_index = JLSHIndex(32, nbits=256).add(j_ds.load_train())
    t_index = TLSHIndex(32, nbits=256, device="cpu").add(t_ds.load_train())
    want = jharness.hit_count_sweep(j_ds, j_index, counts, rescore=rescore)
    got = tharness.hit_count_sweep(t_ds, t_index, counts, rescore=rescore,
                                   device="cpu")
    assert [r["hits"] for r in got] == list(counts)
    for g, w in zip(got, want):
        assert sorted(g) == sorted(w)
        assert abs(g["auc1"] - w["auc1"]) <= TOL
        assert abs(g["tp"] - w["tp"]) <= TOL
        assert (g["align_time"] > 0) == rescore


def test_layer_transform_sweep_matches_jax(harness_data):
    ds = TDataset.from_dir(harness_data, hits=6)
    train, test = ds.load_train(), ds.load_test()
    rng = np.random.RandomState(7)
    train_l = np.stack([rng.randn(*train.shape), train, rng.randn(*train.shape)])
    test_l = np.stack([rng.randn(*test.shape), test, rng.randn(*test.shape)])
    want = jharness.layer_transform_sweep(JDataset.from_dir(harness_data, hits=6),
                                          train_l, test_l, hits=6)
    got = tharness.layer_transform_sweep(ds, train_l, test_l, hits=6,
                                         device="cpu")
    assert [r[0] for r in got] == [r[0] for r in want]
    for g, w in zip(got, want):
        assert abs(g[1] - w[1]) <= TOL and abs(g[2] - w[2]) <= TOL


def _slices(seed=6, n_prot=12, per=3, d=16):
    rng = np.random.RandomState(seed)
    fams = np.arange(n_prot) % 4
    slice_ids = [f"P{p}-{s * 400}" for p in range(n_prot) for s in range(per)]
    centroids = rng.randn(4, d) * 6
    emb = np.stack([centroids[fams[p]] + rng.randn(d)
                    for p in range(n_prot) for _ in range(per)])
    homologous = {f"P{p}": {f"P{q}" for q in range(n_prot)
                            if fams[q] == fams[p] and q != p}
                  for p in range(n_prot)}
    p2d = {f"P{p}": [(f"F{fams[p]}", (10 + 400 * (p % per), 300 + 400 * (p % per)))]
           for p in range(n_prot)}
    return emb.astype(np.float32), slice_ids, p2d, homologous


def test_slices_search_and_run_match_jax(tmp_path):
    emb, slice_ids, p2d, homologous = _slices()
    want_ids, want_scores = jslices.search_slices(emb, k=12)
    got_ids, got_scores = tslices.search_slices(emb, k=12, device="cpu")
    np.testing.assert_array_equal(got_ids, want_ids)
    np.testing.assert_allclose(got_scores, want_scores, rtol=RTOL, atol=RTOL)
    for sid in ("P0-0", "P1-400", "P2-800"):
        assert tslices.slice_domains(sid, p2d) == jslices.slice_domains(sid, p2d)
    npy = tmp_path / "slices.npy"
    np.save(npy, emb)
    want = jslices.run(None, npy, slice_ids, p2d, homologous,
                       out_dir=tmp_path / "j", k=12)
    got = tslices.run(None, npy, slice_ids, p2d, homologous,
                      out_dir=tmp_path / "t", k=12, device="cpu")
    assert sorted(got) == sorted(want) and got["n_evaluated"] > 0
    _same_summary(got, want)
    with np.load(tmp_path / "j" / "slices-assembled.npz") as a, np.load(
        tmp_path / "t" / "slices-assembled.npz"
    ) as b:
        for key in a.files:
            np.testing.assert_array_equal(b[key], a[key])


def test_reverse_control_matches_jax(tmp_path):
    src = tmp_path / "src.fasta"
    rng = np.random.RandomState(4)
    aas = list("ACDEFGHIKLMNPQRSTVWY")
    src.write_text("".join(f">P{i}\n" + "".join(rng.choice(aas, 40)) + "\n"
                           for i in range(30)))
    want = jreverse.make_control_fastas(src, tmp_path / "j", n_samples=20, seed=1)
    got = treverse.make_control_fastas(src, tmp_path / "t", n_samples=20, seed=1)
    assert sorted(got) == sorted(want) == ["forward", "reversed", "shuffled"]
    for tag in want:
        assert got[tag].read_bytes() == want[tag].read_bytes()
    emb = {"forward": rng.randn(50, 8), "reversed": rng.randn(50, 8) + 5,
           "shuffled": rng.randn(50, 8) - 5}
    assert treverse.separation_analysis(emb) == jreverse.separation_analysis(emb)


def test_layer_mix_sweep_matches_jax():
    rng = np.random.RandomState(3)
    n, d = 60, 16
    fams = np.repeat(np.arange(6), 10)
    informative = (rng.randn(6, d) * 8)[fams] + rng.randn(n, d)
    layers = [rng.randn(n, d), informative, rng.randn(n, d) + 0.3 * informative]
    want_w, want_acc = jmix.layer_mix_sweep(layers, fams, step=0.25)
    got_w, got_acc = tmix.layer_mix_sweep(layers, fams, step=0.25, device="cpu")
    np.testing.assert_array_equal(got_w, np.asarray(want_w))
    assert got_acc.shape == (15,) and got_acc.dtype == np.float32
    # fp32 means of n flags, reduced in other orders: an ulp apart at most,
    # where one flag more or less moves a mean by 1/n
    np.testing.assert_allclose(got_acc, np.asarray(want_acc), rtol=0,
                               atol=1e-6)
    assert np.array_equal(np.rint(got_acc * n), np.rint(np.asarray(want_acc) * n))


def test_pfam_proteins_run_lsh_matches_jax(tmp_path):
    """The full-protein pipeline's lsh mode (2048 bits): Hamming distances
    reach the self-hit repair ascending, as in the JAX package."""
    rng = np.random.RandomState(9)
    fams = np.repeat(np.arange(8), 12)
    emb = ((rng.randn(8, 24) * 10)[fams] + rng.randn(96, 24)).astype(np.float32)
    ids = [f"P{i}" for i in range(96)]
    p2d = {f"P{i}": [(f"F{f}", (0, 50))] for i, f in enumerate(fams)}
    npy = tmp_path / "full_sequences.npy"
    np.save(npy, emb)
    want = jproteins.run(npy, ids, p2d, index_mode="lsh", k=30)
    got = tproteins.run(npy, ids, p2d, index_mode="lsh", k=30, device="cpu")
    for key in ("auc1", "recall@300"):
        assert abs(got[key] - want[key]) <= TOL, key


def test_cli_hub(tmp_path, capsys):
    from knn_for_homology_tpu import __main__ as jhub

    assert list(thub.COMMANDS) == list(jhub.COMMANDS)
    with pytest.raises(SystemExit) as exit_info:
        thub.main(["--help"])
    assert exit_info.value.code == 0
    out = capsys.readouterr().out
    assert all(name in out for name in thub.COMMANDS)
    with pytest.raises(SystemExit) as exit_info:  # a workload is required
        thub.main(["reproduce"])
    assert exit_info.value.code == 2
    with pytest.raises(SystemExit):
        thub.main(["no-such-command"])
    np.save(tmp_path / "M.npy",
            np.random.RandomState(10).randn(30, 8).astype(np.float32))
    thub.main(["cath-search", "--data", str(tmp_path), "--hits", "4",
               "--device", "cpu"])
    with np.load(tmp_path / "hits_cosine.npz") as hits:
        assert hits["M"].shape == (30, 4)
    assert (tmp_path / "hits_euclidean.npz").exists()
