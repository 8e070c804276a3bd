"""End-to-end benchmark CLI — the reference's `seqvec_search` entry point
(port of knn_for_homology_tpu/pipelines/benchmark.py).

kNN search (flat or a saved index) → AUC1/TP + figure; kNN + alignment
(native Smith-Waterman by default, `mmseqs align` through the port's
copy of the interop bridge when the binary is installed); the full MMseqs2 search when
available; a printed summary table.

Usage: python -m knn_for_homology_tpu_torch.pipelines.benchmark <dataset>
       [--knn-index X] [--hits N] [--aligner native|mmseqs] [--no-figures]
       [--device cuda|cpu]
"""

import argparse
import logging
from pathlib import Path
from typing import Optional, Sequence

import numpy as np

from ..config import DEFAULT_HITS
from ..data.dataset import Dataset
from ..device import resolve_device
from ..search.flat import knn_search
from ..search.io import read_index
from ..eval.metrics import evaluate_rows, evaluate_string_results
from ..search.rescore import align_rescore
from ..utils.logging import configure_logging

logger = logging.getLogger(__name__)


def run(
    dataset_path: Path,
    hits: int = DEFAULT_HITS,
    knn_index: Optional[Path] = None,
    aligner: str = "native",
    figures: bool = True,
    device="cuda",
):
    """Returns [(name, auc1s, tps, cumulative seconds), ...] for k-NN,
    k-NN + Alignment and (with the binary) MMseqs2."""
    device = resolve_device(device)
    data = Dataset.from_dir(dataset_path, hits, knn_index)
    queries = data.load_test()
    results = []

    # --- kNN ---
    haystack = (
        read_index(knn_index, device=device) if knn_index
        else data.load_train()
    )
    ids, scores, search_time = knn_search(
        haystack, queries, data.hits, device=device
    )
    auc1s_knn, tps_knn = evaluate_rows(data, ids)
    logger.info(
        "Mean AUC1 for k-NN: %f, Mean TP: %f, Time: %ds",
        np.mean(auc1s_knn), np.mean(tps_knn), int(search_time),
    )
    results.append(("k-NN", auc1s_knn, tps_knn, search_time))

    # --- kNN + alignment ---
    if aligner == "mmseqs":
        from .. import interop

        interop.write_prefilter_db_data(
            data, np.arange(queries.shape[0]), ids, scores
        )
        align_time = interop.align(data)
        aligned = interop.read_result_db(
            data, data.mmseqs_dir / "result_combined"
        )
    else:
        aligned, _, align_time = align_rescore(data, ids, device=device)
    auc1s_al, tps_al = evaluate_string_results(data, aligned.items())
    logger.info(
        "Mean AUC1 for k-NN + Alignment: %f, Mean TP: %f, Time: %ds",
        np.mean(auc1s_al), np.mean(tps_al), int(search_time + align_time),
    )
    results.append(
        ("k-NN + Alignment", auc1s_al, tps_al, search_time + align_time)
    )

    # --- MMseqs2 full search (only with the binary) ---
    from ..interop import find_mmseqs

    if find_mmseqs():
        from .. import interop

        mmseqs_time = interop.search(data)
        mm_hits = interop.read_result_db(
            data, data.mmseqs_dir / "result_mmseqs2"
        )
        auc1s_mm, tps_mm = evaluate_string_results(data, mm_hits.items())
        results.append(("MMseqs2", auc1s_mm, tps_mm, mmseqs_time))
    else:
        logger.info("mmseqs binary not found — skipping the MMseqs2 baseline")

    if figures:
        from ..eval.figures import make_figure

        make_figure(data.path, [auc1s_knn], ["k-NN"], "AUC1", "auc1_knn.jpg")
        make_figure(
            data.path, [auc1s_al], ["k-NN + Alignment"], "AUC1",
            "auc1_knn_alignment.jpg",
        )
        make_figure(
            data.path, [r[1] for r in results], [r[0] for r in results],
            "AUC1", "auc1.jpg",
        )

    print("name                 AUC1  SD    time")
    for name, auc1s, _tps, seconds in results:
        print(
            f"{name:20} {np.mean(auc1s):.3f} {np.std(auc1s):.3f} {int(seconds)}s"
        )
    return results


def main(argv: Optional[Sequence[str]] = None) -> None:
    configure_logging()
    parser = argparse.ArgumentParser(
        description="Benchmark kNN homology search on a CUDA GPU"
        " (vs MMseqs2 when installed)"
    )
    parser.add_argument("dataset", type=Path)
    parser.add_argument("--knn-index", type=Path)
    parser.add_argument("--hits", type=int, default=DEFAULT_HITS)
    parser.add_argument(
        "--aligner", choices=["native", "mmseqs"], default="native"
    )
    parser.add_argument("--no-figures", action="store_true")
    parser.add_argument("--device", choices=["cuda", "cpu"], default="cuda")
    args = parser.parse_args(argv)
    run(
        args.dataset,
        hits=args.hits,
        knn_index=args.knn_index,
        aligner=args.aligner,
        figures=not args.no_figures,
        device=args.device,
    )


if __name__ == "__main__":
    main()
