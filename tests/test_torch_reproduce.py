"""The port's `embed-all`, `embed-domains` (pipelines/embed.py), the
registry's ProtT5 aliases and `reproduce` (pipelines/reproduce.py, the
hub's command) against the JAX package on the CPU, on tiny random T5
weights saved as a converted .npz checkpoint (no real checkpoint is in the
repository).

Tolerances: pooled bf16 encoder outputs as tests/test_torch_embed.py
(max difference ≤ 2^-6 of the largest |value|); the AA-composition
baseline, the tables and the metrics computed from equal hits: equal.
"""

import json

import numpy as np
import pytest

from knn_for_homology_tpu.models import t5 as jt5
from knn_for_homology_tpu.models.convert import save_params as jsave_params
from knn_for_homology_tpu.models import registry as jregistry
from knn_for_homology_tpu.pipelines import cath as jcath
from knn_for_homology_tpu.pipelines import embed as jembed
from knn_for_homology_tpu.pipelines import reproduce as jreproduce
from knn_for_homology_tpu.search import io as jio
from knn_for_homology_tpu_torch import __main__ as thub
from knn_for_homology_tpu_torch.models import registry as tregistry
from knn_for_homology_tpu_torch.pipelines import embed as tembed
from knn_for_homology_tpu_torch.pipelines import reproduce as treproduce

AAS = "ACDEFGHIKLMNPQRSTVWY"
TINY = {"vocab_size": 32, "d_model": 64, "d_kv": 16, "d_ff": 128,
        "num_layers": 2, "num_heads": 4}


def assert_pooled_close(got, want):
    assert got.shape == want.shape
    err = np.abs(got - want).max()
    assert err <= 2.0**-6 * np.abs(want).max(), (err, np.abs(want).max())


@pytest.fixture(scope="module")
def checkpoints(tmp_path_factory):
    """A directory holding one converted checkpoint, "ProtT5 XL U50":
    JAX's TINY T5 on seeded random weights."""
    path = tmp_path_factory.mktemp("checkpoints")
    jsave_params(jt5.init_params(jt5.TINY, 0), path / "ProtT5 XL U50",
                 meta={"config": TINY})
    return path


def _jax_embedder(checkpoints):
    return jregistry.ProtT5Embedder(checkpoint=checkpoints / "ProtT5 XL U50")


def _write_fasta(path, seqs, names):
    path.write_text("".join(f">{n}\n{s}\n" for n, s in zip(names, seqs)))


def test_registry_aliases(checkpoints):
    """The ProtT5 variants share one architecture: every port key is a JAX
    key with the same embedder class."""
    assert set(tregistry.EMBEDDERS) <= set(jregistry.EMBEDDERS)
    for name in ("ProtT5 XL U50", "ProtT5-BFD", "ProtT5 UniRef50"):
        assert tregistry.EMBEDDERS[name] is tregistry.ProtT5Embedder
        assert jregistry.EMBEDDERS[name] is jregistry.ProtT5Embedder
        embedder = tregistry.get_embedder(
            name, checkpoint=checkpoints / "ProtT5 XL U50", device="cpu")
        assert embedder.name == "ProtT5 XL U50" and embedder.dim == 64
    assert set(tregistry.EMBEDDERS) == set(jregistry.EMBEDDERS)
    with pytest.raises(ValueError, match="checkpoint"):
        tregistry.get_embedder("SeqVec", device="cpu")
    with pytest.raises(KeyError, match="available"):
        tregistry.get_embedder("No such embedder", device="cpu")


def test_embed_all_skips_keys_without_checkpoint(tmp_path, checkpoints):
    """One `embed-one` subprocess for "ProtT5 XL U50" (its checkpoint is
    there), none for the aliases (theirs are not), the AA-composition
    baseline inline; a second run finds everything done."""
    rng = np.random.RandomState(1)
    seqs = ["".join(rng.choice(list(AAS), rng.randint(8, 60)))
            for _ in range(9)]
    fasta = tmp_path / "in.fasta"
    _write_fasta(fasta, seqs, [f"d{i}" for i in range(9)])
    out = tmp_path / "out"
    argv = ["embed-all", str(fasta), str(out), "--checkpoints",
            str(checkpoints), "--device", "cpu"]
    tembed.main(argv)
    assert sorted(p.name for p in out.iterdir()) == [
        "AA Composition.npy", "AA Composition.time2.txt", "ProtT5 XL U50.npy",
        "ProtT5 XL U50.time1.txt", "ProtT5 XL U50.time2.txt", "ids.json",
    ]
    assert json.loads((out / "ids.json").read_text()) == [
        f"d{i}" for i in range(9)]
    np.testing.assert_array_equal(
        np.load(out / "AA Composition.npy"),
        jregistry.AACompositionEmbedder().embed_pooled(seqs))
    assert_pooled_close(np.load(out / "ProtT5 XL U50.npy"),
                        _jax_embedder(checkpoints).embed_pooled(seqs))
    stamp = (out / "ProtT5 XL U50.time2.txt").stat().st_mtime_ns
    tembed.main(argv)
    assert (out / "ProtT5 XL U50.time2.txt").stat().st_mtime_ns == stamp


def test_embed_domains_matches_jax(tmp_path, checkpoints):
    rng = np.random.RandomState(2)
    seqs = ["".join(rng.choice(list(AAS), rng.randint(40, 90)))
            for _ in range(6)]
    full = tmp_path / "full.fasta"
    _write_fasta(full, seqs, [f"P{i}" for i in range(6)])
    train = tmp_path / "train.fasta"
    test = tmp_path / "test.fasta"
    _write_fasta(train, ["X"] * 5, ["P0/1-20", "P0/21-40", "P1/5-30",
                                    "P3/2-39", "P5/10-35"])
    _write_fasta(test, ["X"] * 2, ["P2/1-33", "P4/7-18"])
    argv = [str(full), str(train), str(test)]
    tail = ["--embedder", "ProtT5 XL U50", "--checkpoint",
            str(checkpoints / "ProtT5 XL U50"), "--feature-slice", "8", "40"]
    tembed.main(["embed-domains", *argv, str(tmp_path / "t"), *tail,
                 "--device", "cpu"])
    jembed.main(["embed-domains", *argv, str(tmp_path / "j"), *tail])
    for split in ("train", "test"):
        assert (tmp_path / "t" / f"{split}.json").read_text() == (
            tmp_path / "j" / f"{split}.json").read_text()
        for suffix, width in (("_full", 64), ("", 32)):
            got = np.load(tmp_path / "t" / f"{split}{suffix}.npy")
            want = np.load(tmp_path / "j" / f"{split}{suffix}.npy")
            assert got.shape[1] == width
            assert_pooled_close(got, want)
    assert json.loads((tmp_path / "t" / "train.json").read_text())[:2] == [
        "P0/1-20", "P0/21-40"]


def _pfam_inputs(tmp_path):
    """The JAX package's reproduce fixture: 4 families of 8 identical
    40-residue proteins, a Pfam-A header for each."""
    n_fam, per_fam, length = 4, 8, 40
    full_fasta = tmp_path / "full.fasta"
    pfam_a = tmp_path / "pfam_a.fasta"
    with open(full_fasta, "w") as full, open(pfam_a, "w") as pa:
        for i in range(n_fam * per_fam):
            fam = i // per_fam
            seq = "".join(AAS[j] for j in
                          np.random.RandomState(fam).randint(0, 20, length))
            full.write(f">P{i:03d}\n{seq}\n")
            pa.write(f">P{i:03d}/1-{length} P{i:03d}.1 PF{fam:05d}.1;Fam{fam};"
                     f"\n{seq}\n")
    return full_fasta, pfam_a


@pytest.mark.parametrize("mode", ["flat", "graph"])
def test_reproduce_pfam_proteins_matches_jax(tmp_path, checkpoints, mode):
    """The hub's `reproduce pfam-proteins`: embed → index → k-search →
    proteins-figures/; the metrics equal the JAX package's."""
    full_fasta, pfam_a = _pfam_inputs(tmp_path)
    thub.main(["reproduce", "--device", "cpu", "pfam-proteins",
               "--full-fasta", str(full_fasta), "--pfam-a", str(pfam_a),
               "--out", str(tmp_path / "t"), "--checkpoints",
               str(checkpoints), "--embedder", "ProtT5 XL U50",
               "--index-mode", mode, "--k", "20"])
    want = jreproduce.reproduce_pfam_proteins(
        full_fasta, pfam_a, tmp_path / "j", checkpoints=checkpoints,
        index_mode=mode, k=20)
    figures = tmp_path / "t" / "proteins-figures"
    got = json.loads((figures / "metrics.json").read_text())
    for key in ("auc1", "recall@300"):
        assert abs(got[key] - want[key]) <= 1e-9, key
    assert got["auc1"] > 0.9
    assert (figures / "accuracy_over_hits-data.npz").exists()
    assert_pooled_close(
        np.load(tmp_path / "t" / "proteins-data" / "full_sequences.npy"),
        np.load(tmp_path / "j" / "proteins-data" / "full_sequences.npy"))
    index = tmp_path / "t" / "proteins-data" / f"full_sequences_{mode}.index"
    assert jio.read_index(index).ntotal == 32


def test_reproduce_uniref90_matches_jax(tmp_path):
    knn = {"T0001": ["a", "b", "c", "d"], "T0002": ["x", "y"]}
    mm = {"T0001": ["b", "c", "z"], "T0002": ["q"]}
    neff = {"T0001": 24806.6, "T0002": 1.5}
    paths = []
    for name, data in (("knn", knn), ("mm", mm), ("neff", neff)):
        paths.append(tmp_path / f"{name}.json")
        paths[-1].write_text(json.dumps(data))
    kj, mj, nj = paths
    thub.main(["reproduce", "uniref90", "--knn-hits", str(kj),
               "--mmseqs-hits", str(mj), "--out", str(tmp_path / "t"),
               "--neff", str(nj)])
    jreproduce.reproduce_uniref90(kj, mj, tmp_path / "j", neff_json=nj)
    for name in ("uniref90-overlap.md", "uniref90-neff-hits.md"):
        got = (tmp_path / "t" / "uniref90-figures" / name).read_text()
        assert got == (tmp_path / "j" / "uniref90-figures" / name).read_text()
    treproduce.reproduce_uniref90(kj, mj, tmp_path / "c", cutoffs=(2, 3))
    rows = (tmp_path / "c" / "uniref90-figures" / "uniref90-overlap.md"
            ).read_text().strip().splitlines()
    assert [c.strip() for c in rows[2].split("|")[1:-1]] == ["2", "3", "1", "3"]


def test_reproduce_cath_tree(tmp_path, checkpoints):
    """`reproduce cath`: embed-all (the ProtT5 checkpoint and the baseline),
    the all-vs-all search in both metrics, the leaderboards; the JAX
    package's evaluation of the port's hits gives the same tables."""
    rng = np.random.RandomState(0)
    n_fam, per_fam, length = 6, 6, 30
    fams = np.repeat(np.arange(n_fam), per_fam)
    fasta = tmp_path / "cath20.fasta"
    clf = tmp_path / "clf.txt"
    with open(fasta, "w") as fp, open(clf, "w") as cp:
        for i, fam in enumerate(fams):
            base = np.random.RandomState(int(fam)).randint(0, 20, length)
            seq = "".join(AAS[j] for j in (base + rng.randint(0, 3, length))
                          % 20)
            fp.write(f">cath|4_2_0|dom{i:03d}/1-{length}\n{seq}\n")
            cp.write(f"dom{i:03d}      1    10     8{int(fam) + 1:>6}     1"
                     f"     1     1     1     1  {length}.000\n")
    out = tmp_path / "more_sensitive"
    report = treproduce.reproduce_cath(fasta, clf, out,
                                       checkpoints=checkpoints, hits=5,
                                       device="cpu")
    figures = out / "cath-figures"
    acc = (figures / "accuracies.md").read_text()
    assert "ProtT5 XL U50" in acc and "AA Composition" in acc
    assert (figures / "accuracies_euclidean.md").exists()
    assert (figures / "superfamily-vs-accuracy-data.npz").exists()
    with np.load(out / "cath-data" / "hits_cosine.npz") as hits:
        assert sorted(hits.files) == ["AA Composition", "ProtT5 XL U50"]
    want = jcath.evaluate_and_report(out / "cath-data", clf,
                                     tmp_path / "jfigs", metric="cosine")
    assert report["cosine"]["accuracies"] == want["accuracies"]
    again = treproduce.reproduce_cath(fasta, clf, out,
                                      checkpoints=checkpoints, hits=5,
                                      device="cpu")
    assert again["cosine"]["accuracies"] == report["cosine"]["accuracies"]


def test_new_entry_points_default_to_the_card(monkeypatch):
    """The graph index, `reproduce` and the new embed commands run on
    "cuda" unless the caller asks for the CPU, with no silent fallback."""
    import inspect

    import torch

    from knn_for_homology_tpu_torch.search.graph import GraphIndex

    for fn in (GraphIndex.__init__, GraphIndex.from_state,
               treproduce.reproduce_cath, treproduce.reproduce_pfam_proteins):
        assert inspect.signature(fn).parameters["device"].default == "cuda"
    parsed = []
    monkeypatch.setattr(tembed, "cmd_embed_all", parsed.append)
    monkeypatch.setattr(tembed, "cmd_embed_domains", parsed.append)
    tembed.main(["embed-all", "a", "b"])
    tembed.main(["embed-domains", "a", "b", "c", "d"])
    assert [args.device for args in parsed] == ["cuda", "cuda"]
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="cuda"):
            GraphIndex()
