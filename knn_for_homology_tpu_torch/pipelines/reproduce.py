"""One-command paper reproduction (port of
knn_for_homology_tpu/pipelines/reproduce.py).

`python -m knn_for_homology_tpu_torch reproduce <workload> --checkpoints
DIR …` chains embed → search → evaluate → render into the reference's
`more_sensitive/` output layout, so that given converted pLM checkpoints a
single command regenerates the published tables/figures:

  * cath          — every embedder with a checkpoint (+ the AA-composition
                    baseline) over the CATH20 fasta → all-vs-all search in
                    both metrics → `cath-figures/` with the accuracies.md
                    leaderboard (reference:
                    more_sensitive/cath-figures/accuracies.md:1-23) and
                    accuracies_euclidean.md, plus every rendered endfig
                    family (pipelines/cath.py:evaluate_and_report).
  * pfam-proteins — full-sequence embeddings → index build + k=1000
                    search → `proteins-figures/` (pipelines/pfam_proteins).
  * uniref90      — overlap/neff tables from hit files
                    (eval/overlap.py; reference:
                    more_sensitive/uniref90-figures/uniref90-overlap.md).

Every stage is file-existence idempotent like the reference's drivers
(skip what already exists), so a crashed run resumes where it stopped. The
device is explicit (`--device`, "cuda" unless the caller asks for the
CPU), and the embedders are the port's registry's (models/registry.py).
"""

import argparse
import json
import logging
import shutil
from pathlib import Path
from types import SimpleNamespace
from typing import Optional, Sequence

from ..utils.logging import configure_logging

logger = logging.getLogger(__name__)


def reproduce_cath(
    fasta: Path,
    domain_list: Path,
    out_dir: Path,
    checkpoints: Optional[Path] = None,
    hits: int = 10,
    bootstrap: bool = False,
    device="cuda",
) -> dict:
    """fasta + checkpoints → cath-figures/ tree (the leaderboard pipeline:
    reference Readme.md:29-33 embed_all → search → cath)."""
    from .cath import evaluate_and_report, search_and_save
    from .embed import cmd_embed_all

    out_dir = Path(out_dir)
    data_dir = out_dir / "cath-data"
    figures = out_dir / "cath-figures"
    data_dir.mkdir(parents=True, exist_ok=True)

    # 1) embed every available method (subprocess-isolated, idempotent)
    cmd_embed_all(
        SimpleNamespace(
            fasta=str(fasta),
            outdir=str(data_dir),
            checkpoints=checkpoints,
            device=device,
        )
    )
    # the evaluation joins on the fasta for length analyses
    target_fasta = data_dir / "cath-20.fasta"
    if not target_fasta.exists():
        shutil.copy(fasta, target_fasta)

    # 2) all-vs-all search, both metrics (cosine + euclidean npz)
    if not (data_dir / "hits_cosine.npz").exists():
        search_and_save(data_dir, hits, device=device)

    # 3) evaluate + render. euclidean first so its leaderboard can be
    # renamed before the cosine run writes the canonical accuracies.md
    report = {}
    report["euclidean"] = evaluate_and_report(
        data_dir, domain_list, figures, metric="l2", bootstrap=bootstrap
    )
    (figures / "accuracies.md").replace(figures / "accuracies_euclidean.md")
    report["cosine"] = evaluate_and_report(
        data_dir, domain_list, figures, metric="cosine", bootstrap=bootstrap
    )
    logger.info("CATH reproduction tree at %s", figures)
    return report


def reproduce_pfam_proteins(
    full_fasta: Path,
    pfam_a: Path,
    out_dir: Path,
    checkpoints: Optional[Path] = None,
    embedder: str = "ProtT5 XL U50",
    index_mode: str = "flat",
    k: int = 1000,
    device="cuda",
) -> dict:
    """Full-protein chain (reference Readme.md:37-43): embed full
    sequences → index + k=1000 all-vs-all → proteins-figures/. The
    domain ground truth comes from Pfam-A headers
    (data/pfam.py:get_protein_to_domain, cached beside the data)."""
    from ..data.pfam import get_protein_to_domain
    from .embed import cmd_embed
    from .pfam_proteins import run as proteins_run

    out_dir = Path(out_dir)
    data_dir = out_dir / "proteins-data"
    figures = out_dir / "proteins-figures"
    data_dir.mkdir(parents=True, exist_ok=True)

    npy = data_dir / "full_sequences.npy"
    if not npy.exists():
        checkpoint = None
        if checkpoints is not None:
            cand = Path(checkpoints) / embedder
            checkpoint = cand if cand.exists() else None
        cmd_embed(
            SimpleNamespace(
                fasta=str(full_fasta),
                npy=str(npy),
                embedder=embedder,
                checkpoint=checkpoint,
                batch_size=4096,
                max_len=3096,
                l2=False,
                device=device,
            )
        )
    ids = json.loads(npy.with_suffix(".json").read_text())
    p2d = get_protein_to_domain(
        set(ids), Path(pfam_a), cache=data_dir / "protein_to_domain.json"
    )
    metrics = proteins_run(
        npy, ids, p2d, index_mode=index_mode,
        figures_dir=figures, k=min(k, max(len(ids) - 1, 1)),
        index_file=data_dir / f"full_sequences_{index_mode}.index",
        device=device,
    )
    (figures / "metrics.json").write_text(json.dumps(metrics, indent=2))
    logger.info("Pfam full-protein reproduction tree at %s", figures)
    return metrics


def reproduce_uniref90(
    knn_hits_json: Path,
    mmseqs_hits_json: Path,
    out_dir: Path,
    neff_json: Optional[Path] = None,
    cutoffs: Sequence[int] = (300, 1000, 10000),
) -> None:
    """Hit files → uniref90-figures/ overlap + neff tables.

    Input: json mapping query/target id → hit id list (kNN lists
    rank-ordered)."""
    from ..eval.overlap import neff_hits_table, overlap_table

    out_dir = Path(out_dir)
    figures = out_dir / "uniref90-figures"
    figures.mkdir(parents=True, exist_ok=True)
    knn = json.loads(Path(knn_hits_json).read_text())
    mm = json.loads(Path(mmseqs_hits_json).read_text())
    (figures / "uniref90-overlap.md").write_text(
        overlap_table(knn, mm, cutoffs) + "\n"
    )
    if neff_json is not None:
        neff = json.loads(Path(neff_json).read_text())
        (figures / "uniref90-neff-hits.md").write_text(
            neff_hits_table(sorted(knn), neff, knn, mm, cutoffs) + "\n"
        )
    logger.info("UniRef90 tables at %s", figures)


def main(argv: Optional[Sequence[str]] = None) -> None:
    configure_logging()
    parser = argparse.ArgumentParser(
        prog="knn_for_homology_tpu_torch reproduce",
        description=__doc__.split("\n\n")[1],
    )
    parser.add_argument("--device", default="cuda",
                        help="cuda (default) or cpu")
    sub = parser.add_subparsers(dest="workload", required=True)

    p = sub.add_parser("cath")
    p.add_argument("--fasta", type=Path, required=True)
    p.add_argument("--domain-list", type=Path, required=True)
    p.add_argument("--out", type=Path, required=True)
    p.add_argument("--checkpoints", type=Path)
    p.add_argument("--hits", type=int, default=10)
    p.add_argument("--bootstrap", action="store_true")

    p = sub.add_parser("pfam-proteins")
    p.add_argument("--full-fasta", type=Path, required=True)
    p.add_argument("--pfam-a", type=Path, required=True)
    p.add_argument("--out", type=Path, required=True)
    p.add_argument("--checkpoints", type=Path)
    p.add_argument("--embedder", default="ProtT5 XL U50")
    p.add_argument("--index-mode", default="flat",
                   choices=["flat", "lsh", "graph", "ivf"])
    p.add_argument("--k", type=int, default=1000)

    p = sub.add_parser("uniref90")
    p.add_argument("--knn-hits", type=Path, required=True)
    p.add_argument("--mmseqs-hits", type=Path, required=True)
    p.add_argument("--out", type=Path, required=True)
    p.add_argument("--neff", type=Path)

    args = parser.parse_args(argv)
    if args.workload == "cath":
        reproduce_cath(
            args.fasta, args.domain_list, args.out,
            checkpoints=args.checkpoints, hits=args.hits,
            bootstrap=args.bootstrap, device=args.device,
        )
    elif args.workload == "pfam-proteins":
        reproduce_pfam_proteins(
            args.full_fasta, args.pfam_a, args.out,
            checkpoints=args.checkpoints, embedder=args.embedder,
            index_mode=args.index_mode, k=args.k, device=args.device,
        )
    else:
        reproduce_uniref90(
            args.knn_hits, args.mmseqs_hits, args.out, neff_json=args.neff
        )


if __name__ == "__main__":
    main()
