"""The port's embed CLI (pipelines/embed.py) with SeqVec, against the JAX
package's on the CPU: `embed-one --embedder SeqVec` writes the four layer
files, `embed-domains` runs with its default embedder (SeqVec, its [3, L, d]
layers concatenated to [L, 3d]) and `embed-all` takes "SeqVec Sum.npy" as
SeqVec's done-file. The checkpoint is the JAX package's TINY_ELMO on seeded
random weights, saved with its config as a converted .npz.

Tolerance: the fp32 bound of tests/test_torch_models.py,
|port - jax| ≤ 1e-5 · max(1, max|jax|).
"""

import json

import numpy as np
import pytest

from knn_for_homology_tpu.models import elmo as jelmo
from knn_for_homology_tpu.models.convert import save_params as jsave_params
from knn_for_homology_tpu.pipelines import embed as jembed
from knn_for_homology_tpu_torch.pipelines import embed as tembed

AAS = "ACDEFGHIKLMNPQRSTVWY"
VARIANTS = ["SeqVec Sum", "SeqVec CharCNN", "SeqVec LSTM1", "SeqVec LSTM2"]
TINY = {"char_embed_dim": 4, "filters": [[1, 8], [2, 8], [3, 16]],
        "n_highway": 1, "proj_dim": 16, "lstm_dim": 32, "n_lstm_layers": 2}


def assert_close(got, want):
    assert got.shape == want.shape, (got.shape, want.shape)
    err = np.abs(got - want).max()
    assert err <= 1e-5 * max(1.0, np.abs(want).max()), err


@pytest.fixture(scope="module")
def checkpoints(tmp_path_factory):
    """A directory holding one converted checkpoint, "SeqVec"."""
    path = tmp_path_factory.mktemp("checkpoints")
    jsave_params(jelmo.init_params(jelmo.TINY_ELMO, 0), path / "SeqVec",
                 meta={"config": TINY})
    return path


def _write_fasta(path, seqs, names):
    path.write_text("".join(f">{n}\n{s}\n" for n, s in zip(names, seqs)))


def _sequences(seed, n, lo, hi):
    rng = np.random.RandomState(seed)
    return ["".join(rng.choice(list(AAS), rng.randint(lo, hi)))
            for _ in range(n)]


def test_embed_one_seqvec_writes_four_layer_files(tmp_path, checkpoints):
    seqs = _sequences(0, 7, 5, 70)
    fasta = tmp_path / "in.fasta"
    _write_fasta(fasta, seqs, [f"d{i}" for i in range(7)])
    tail = ["--embedder", "SeqVec", "--checkpoint",
            str(checkpoints / "SeqVec")]
    tembed.main(["embed-one", str(fasta), str(tmp_path / "t"), *tail,
                 "--device", "cpu"])
    jembed.main(["embed-one", str(fasta), str(tmp_path / "j"), *tail])
    names = sorted(p.name for p in (tmp_path / "t").iterdir())
    assert names == sorted([f"{v}.npy" for v in VARIANTS]
                           + ["SeqVec.time1.txt", "ids.json"])
    assert names == sorted(p.name for p in (tmp_path / "j").iterdir())
    for v in VARIANTS:
        got = np.load(tmp_path / "t" / f"{v}.npy")
        assert got.shape == (7, 32)
        assert_close(got, np.load(tmp_path / "j" / f"{v}.npy"))
    assert (tmp_path / "t" / "ids.json").read_text() == (
        tmp_path / "j" / "ids.json").read_text()


def test_embed_domains_default_embedder_matches_jax(tmp_path, checkpoints):
    """No --embedder: SeqVec. Its [3, L, 32] layers concatenate to 96
    features a residue; 32:64 is the tiny model's LSTM1 slice (1024:2048
    at SeqVec's width)."""
    seqs = _sequences(2, 6, 40, 90)
    full = tmp_path / "full.fasta"
    _write_fasta(full, seqs, [f"P{i}" for i in range(6)])
    train, test = tmp_path / "train.fasta", tmp_path / "test.fasta"
    _write_fasta(train, ["X"] * 5, ["P0/1-20", "P0/21-40", "P1/5-30",
                                    "P3/2-39", "P5/10-35"])
    _write_fasta(test, ["X"] * 2, ["P2/1-33", "P4/7-18"])
    argv = [str(full), str(train), str(test)]
    tail = ["--checkpoint", str(checkpoints / "SeqVec"),
            "--feature-slice", "32", "64"]
    tembed.main(["embed-domains", *argv, str(tmp_path / "t"), *tail,
                 "--device", "cpu"])
    jembed.main(["embed-domains", *argv, str(tmp_path / "j"), *tail])
    for split in ("train", "test"):
        assert (tmp_path / "t" / f"{split}.json").read_text() == (
            tmp_path / "j" / f"{split}.json").read_text()
        for suffix, width in (("_full", 96), ("", 32)):
            got = np.load(tmp_path / "t" / f"{split}{suffix}.npy")
            assert got.shape[1] == width
            assert_close(got, np.load(tmp_path / "j" / f"{split}{suffix}.npy"))
    full_t = np.load(tmp_path / "t" / "train_full.npy")
    np.testing.assert_array_equal(np.load(tmp_path / "t" / "train.npy"),
                                  full_t[:, 32:64])


def test_embed_all_takes_seqvec_sum_as_done_file(tmp_path, checkpoints):
    """One `embed-one` worker writes SeqVec's four files; a second run finds
    "SeqVec Sum.npy" and skips SeqVec (its time2 stamp stays)."""
    seqs = _sequences(3, 5, 8, 40)
    fasta = tmp_path / "in.fasta"
    _write_fasta(fasta, seqs, [f"c{i}" for i in range(5)])
    out = tmp_path / "out"
    argv = ["embed-all", str(fasta), str(out), "--checkpoints",
            str(checkpoints), "--device", "cpu"]
    tembed.main(argv)
    assert sorted(p.name for p in out.iterdir()) == sorted(
        ["AA Composition.npy", "AA Composition.time2.txt", "ids.json",
         "SeqVec.time1.txt", "SeqVec.time2.txt"]
        + [f"{v}.npy" for v in VARIANTS])
    assert not (out / "SeqVec.npy").exists()
    stamp = (out / "SeqVec.time2.txt").stat().st_mtime_ns
    tembed.main(argv)
    assert (out / "SeqVec.time2.txt").stat().st_mtime_ns == stamp
    assert json.loads((out / "ids.json").read_text()) == [
        f"c{i}" for i in range(5)]
