"""Deterministic test-fixture generators.

Parity with the reference's committed fixture makers
(reference: test-data/small-random/generate_arrays.py — seeded random
vectors with a synthetic id→family map; test-data/*/make_pfam_subset.py —
real subsets via the seeded builder). Fixtures are generated, not committed:
same seed → byte-identical arrays.

CLI: python -m knn_for_homology_tpu_torch.data.fixtures <outdir>
         [--kind random|clustered] [--seed 7]
"""

import argparse
import json
from pathlib import Path
from typing import Optional, Sequence

import numpy as np

AAS = "ACDEFGHIKLMNPQRSTVWY"


def _write_dataset(out, train, test, train_ids, test_ids, fam_map, rng):
    out = Path(out)
    out.mkdir(parents=True, exist_ok=True)
    np.save(out / "train.npy", train)
    np.save(out / "test.npy", test)
    (out / "train.json").write_text(json.dumps(train_ids))
    (out / "test.json").write_text(json.dumps(test_ids))
    (out / "ids_to_family.json").write_text(json.dumps(fam_map))
    for split, ids in [("train", train_ids), ("test", test_ids)]:
        with open(out / f"{split}.fasta", "w") as fp:
            for name in ids:
                seq = "".join(rng.choice(list(AAS), size=60))
                fp.write(f">{name}\n{seq}\n")


def make_small_random(
    out: Path, seed: int = 7, n_train: int = 11, n_test: int = 6, dim: int = 1024
) -> None:
    """Seeded uniform-random vectors in the dataset layout
    (reference: test-data/small-random/generate_arrays.py: seed 7,
    test 6×1024 then train 11×1024 drawn in that order)."""
    rng = np.random.RandomState(seed)
    test = rng.rand(n_test, dim).astype(np.float32)
    train = rng.rand(n_train, dim).astype(np.float32)
    train_ids = [f"train{i}" for i in range(n_train)]
    test_ids = [f"test{i}" for i in range(n_test)]
    fam_map = {name: f"F{i % 3}" for i, name in enumerate(train_ids)}
    fam_map.update({name: f"F{i % 3}" for i, name in enumerate(test_ids)})
    _write_dataset(out, train, test, train_ids, test_ids, fam_map, rng)


def make_clustered(
    out: Path,
    seed: int = 1234,
    n_families: int = 8,
    n_train: int = 6,
    n_test: int = 3,
    dim: int = 32,
) -> None:
    """Well-separated family centroids + Gaussian noise — the fixture shape
    used throughout tests/ (perfect recall expected from exact search)."""
    rng = np.random.RandomState(seed)
    centroids = rng.randn(n_families, dim) * 10.0
    train, test, train_ids, test_ids, fam_map = [], [], [], [], {}
    for f in range(n_families):
        for j in range(n_train):
            train.append(centroids[f] + rng.randn(dim))
            name = f"fam{f}_train{j}"
            train_ids.append(name)
            fam_map[name] = f"F{f}"
        for j in range(n_test):
            test.append(centroids[f] + rng.randn(dim))
            name = f"fam{f}_test{j}"
            test_ids.append(name)
            fam_map[name] = f"F{f}"
    _write_dataset(
        out,
        np.asarray(train, dtype=np.float32),
        np.asarray(test, dtype=np.float32),
        train_ids,
        test_ids,
        fam_map,
        rng,
    )


def main(argv: Optional[Sequence[str]] = None) -> None:
    parser = argparse.ArgumentParser()
    parser.add_argument("outdir", type=Path)
    parser.add_argument("--kind", choices=["random", "clustered"], default="random")
    parser.add_argument("--seed", type=int, default=None)
    args = parser.parse_args(argv)
    if args.kind == "random":
        make_small_random(args.outdir, seed=args.seed or 7)
    else:
        make_clustered(args.outdir, seed=args.seed or 1234)


if __name__ == "__main__":
    main()
