"""Scrambled-sequence control — forward vs reversed vs shuffled embeddings;
port of knn_for_homology_tpu/pipelines/reverse.py.

Parity with the reference (reference: pfam/reverse_embed.py:19-44,
reverse_evaluate.py:34-118): sample proteins, build forward / reversed /
residue-shuffled variants, embed each, and test 2-D PCA separation of the
three populations (the control showing pLM embeddings encode order, not
just composition). PCA via numpy SVD — no sklearn dependency.
"""

import random
from pathlib import Path
from typing import Dict, Optional, Tuple

import numpy as np

from ..data.fasta import read_fasta, write_fasta


def make_control_fastas(
    source_fasta: Path,
    out_dir: Path,
    n_samples: int = 10000,
    seed: int = 42,
) -> Dict[str, Path]:
    """forward.fasta / reversed.fasta / shuffled.fasta
    (reference: pfam/reverse_embed.py:19-29)."""
    out_dir = Path(out_dir)
    out_dir.mkdir(parents=True, exist_ok=True)
    sequences = read_fasta(source_fasta)
    rng = random.Random(seed)
    names = list(sequences)
    if len(names) > n_samples:
        names = rng.sample(names, n_samples)
    forward = {name: sequences[name] for name in names}
    reverse = {name: sequences[name][::-1] for name in names}
    shuffled = {}
    for name in names:
        chars = list(sequences[name])
        rng.shuffle(chars)
        shuffled[name] = "".join(chars)
    paths = {}
    for tag, data in [
        ("forward", forward), ("reversed", reverse), ("shuffled", shuffled)
    ]:
        path = out_dir / f"{tag}.fasta"
        write_fasta(path, data)
        paths[tag] = path
    return paths


def pca2(x: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
    """2-component PCA: (projected [N, 2], explained variance ratio [2])."""
    x = np.asarray(x, dtype=np.float64)
    centered = x - x.mean(axis=0, keepdims=True)
    _, s, vt = np.linalg.svd(centered, full_matrices=False)
    projected = centered @ vt[:2].T
    var = (s**2) / (s**2).sum()
    return projected, var[:2]


def separation_analysis(
    embeddings: Dict[str, np.ndarray],
    figures_dir: Optional[Path] = None,
) -> Dict[str, float]:
    """Project all populations into the joint PCA plane; report the
    centroid separations (reference: reverse_evaluate.py:34-118)."""
    tags = list(embeddings)
    stacked = np.concatenate([embeddings[t] for t in tags], axis=0)
    projected, var = pca2(stacked)
    bounds = np.cumsum([0] + [len(embeddings[t]) for t in tags])
    centroids = {
        tag: projected[bounds[i] : bounds[i + 1]].mean(axis=0)
        for i, tag in enumerate(tags)
    }
    out = {"explained_var_2d": float(var.sum())}
    for i, a in enumerate(tags):
        for b in tags[i + 1 :]:
            out[f"centroid_dist_{a}_{b}"] = float(
                np.linalg.norm(centroids[a] - centroids[b])
            )
    if figures_dir is not None:
        from ..eval.figures import _plt, endfig, save_raw

        save_raw(
            figures_dir,
            "reverse-pca-data",
            **{t: projected[bounds[i] : bounds[i + 1]] for i, t in enumerate(tags)},
        )
        plt = _plt()
        for i, tag in enumerate(tags):
            pts = projected[bounds[i] : bounds[i + 1]]
            plt.scatter(pts[:, 0], pts[:, 1], s=2, label=tag, alpha=0.5)
        plt.legend()
        plt.xlabel("PC1")
        plt.ylabel("PC2")
        endfig(figures_dir, "reverse-pca")
    return out


def main(argv=None):
    """CLI parity with `python -m pfam.reverse_embed`
    (reference: pfam/reverse_embed.py:19-44): sample proteins, write the
    forward/reversed/shuffled controls, and embed each variant via the embed
    CLI in a subprocess (same crash-isolation pattern)."""
    import argparse
    import subprocess
    import sys

    parser = argparse.ArgumentParser()
    parser.add_argument("source_fasta", type=Path)
    parser.add_argument("out_dir", type=Path)
    parser.add_argument("--samples", type=int, default=10000)
    parser.add_argument("--seed", type=int, default=42)
    parser.add_argument("--checkpoint", type=Path)
    parser.add_argument("--embedder", default="ProtT5 XL U50")
    parser.add_argument("--device", default="cuda",
                        help="cuda (default) or cpu")
    args = parser.parse_args(argv)
    paths = make_control_fastas(
        args.source_fasta, args.out_dir, args.samples, args.seed
    )
    for tag, fasta in paths.items():
        npy = args.out_dir / f"{tag}.npy"
        if npy.is_file():
            continue
        cmd = [
            sys.executable, "-m", "knn_for_homology_tpu_torch.pipelines.embed",
            "embed", str(fasta), str(npy), "--embedder", args.embedder,
            "--device", args.device,
        ]
        if args.checkpoint:
            cmd += ["--checkpoint", str(args.checkpoint)]
        subprocess.check_call(cmd)
    embeddings = {
        tag: np.load(args.out_dir / f"{tag}.npy") for tag in paths
    }
    out = separation_analysis(embeddings, figures_dir=args.out_dir)
    print(out)


if __name__ == "__main__":
    main()
