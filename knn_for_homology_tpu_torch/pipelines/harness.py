"""Benchmark harness sweeps — tradeoff studies behind the paper's figures;
port of knn_for_homology_tpu/pipelines/harness.py.

Parity with the reference's figure scripts
(reference: seqvec_search/figures/ + benchmark_mmseqs.sh):
  * hit-count sweep ↔ figures/novel_benchmark.py:19-92 — LSH hits ∈
    {2000…50}, each rescored by alignment, AUC1/TP/time table → csv+md
  * AUC1-vs-time + prefilter-size-vs-AUC1 curves ↔ figures/auc1_vs_time.py,
    figures/prefilter_size_vs_auc1.py
  * MMseqs2 sensitivity sweep ↔ benchmark_mmseqs.sh — wall time of
    search / prefilter+align per -s ∈ {1..8} (needs the binary)
  * layer-combination sweep ↔ figures/layers.py:36-48 — transforms of the
    3 SeqVec layers searched + evaluated
  * lstm1-vs-sum comparison ↔ seqvec_search/lstm1_vs_sum.py

Searches and alignments run on an explicit device, "cuda" unless the
caller asks for the CPU; a prebuilt `index` searches on its own device.
"""

import csv
import logging
import time
from pathlib import Path
from typing import Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np

from ..data.dataset import Dataset
from ..eval.metrics import evaluate_rows, evaluate_string_results
from ..search.flat import knn_search
from ..search.rescore import align_rescore

logger = logging.getLogger(__name__)


def hit_count_sweep(
    data: Dataset,
    index,
    hit_counts: Sequence[int] = (2000, 1000, 500, 300, 200, 100, 50),
    rescore: bool = True,
    device="cuda",
) -> List[Dict]:
    """kNN with varying hit counts, optionally alignment-rescored
    (reference: figures/novel_benchmark.py:34-59). Returns one record per
    count: {hits, auc1, tp, search_time, align_time}."""
    records = []
    queries = data.load_test()
    for hits in hit_counts:
        k = min(hits, index.ntotal)
        start = time.time()
        scores, ids = index.search(queries, k)
        search_time = time.time() - start
        if rescore:
            aligned, _, align_time = align_rescore(data, ids, device=device)
            auc1s, tps = evaluate_string_results(data, aligned.items())
        else:
            align_time = 0.0
            auc1s, tps = evaluate_rows(data, ids)
        records.append(
            {
                "hits": hits,
                "auc1": float(np.mean(auc1s)),
                "tp": float(np.mean(tps)),
                "search_time": search_time,
                "align_time": align_time,
            }
        )
        logger.info("hits=%d → %s", hits, records[-1])
    return records


def write_sweep_table(records: List[Dict], out_base: Path) -> None:
    """csv + markdown table next to each other
    (reference: figures/novel_benchmark.py:60-92)."""
    out_base = Path(out_base)
    out_base.parent.mkdir(parents=True, exist_ok=True)
    keys = list(records[0])
    with open(str(out_base) + ".csv", "w", newline="") as fp:
        writer = csv.DictWriter(fp, fieldnames=keys)
        writer.writeheader()
        writer.writerows(records)
    lines = [
        "| " + " | ".join(keys) + " |",
        "|" + "---|" * len(keys),
    ]
    for rec in records:
        lines.append(
            "| "
            + " | ".join(
                f"{rec[k]:.3f}" if isinstance(rec[k], float) else str(rec[k])
                for k in keys
            )
            + " |"
        )
    Path(str(out_base) + ".md").write_text("\n".join(lines) + "\n")


def figure_auc1_vs_time(
    records: List[Dict], figures_dir: Path, name: str = "auc1_vs_time"
) -> None:
    """(reference: figures/auc1_vs_time.py)"""
    from ..eval.figures import _plt, endfig, save_raw

    times = [r["search_time"] + r["align_time"] for r in records]
    auc1s = [r["auc1"] for r in records]
    labels = [str(r["hits"]) for r in records]
    save_raw(figures_dir, name + "-data", times=times, auc1s=auc1s)
    plt = _plt()
    plt.plot(times, auc1s, marker="o")
    for t, a, label in zip(times, auc1s, labels):
        plt.annotate(label, (t, a))
    plt.xlabel("time (s)")
    plt.ylabel("mean AUC1")
    plt.grid()
    endfig(figures_dir, name)


def figure_prefilter_size_vs_auc1(
    records: List[Dict], figures_dir: Path, name: str = "prefilter_size_vs_auc1"
) -> None:
    """(reference: figures/prefilter_size_vs_auc1.py)"""
    from ..eval.figures import _plt, endfig, save_raw

    sizes = [r["hits"] for r in records]
    auc1s = [r["auc1"] for r in records]
    save_raw(figures_dir, name + "-data", sizes=sizes, auc1s=auc1s)
    plt = _plt()
    plt.plot(sizes, auc1s, marker="o")
    plt.xscale("log")
    plt.xlabel("prefilter size (hits)")
    plt.ylabel("mean AUC1")
    plt.grid()
    endfig(figures_dir, name)


# the reference's 8 layer-combination transforms (figures/layers.py:36-48)
LAYER_TRANSFORMS: Dict[str, Callable[[np.ndarray], np.ndarray]] = {
    "CharCNN": lambda layers: layers[0],
    "LSTM1": lambda layers: layers[1],
    "LSTM2": lambda layers: layers[2],
    "Sum": lambda layers: layers.sum(axis=0),
    "Mean": lambda layers: layers.mean(axis=0),
    "LSTM1+LSTM2": lambda layers: layers[1] + layers[2],
    "Concat": lambda layers: np.concatenate(list(layers), axis=-1),
    "Max": lambda layers: layers.max(axis=0),
}


def layer_transform_sweep(
    data: Dataset,
    train_layers: np.ndarray,  # [3, N, d]
    test_layers: np.ndarray,  # [3, Q, d]
    hits: int = 13,
    device="cuda",
) -> List[Tuple[str, float, float]]:
    """AUC1/TP of each layer transform (reference: figures/layers.py)."""
    records = []
    for name, transform in LAYER_TRANSFORMS.items():
        train = transform(np.asarray(train_layers))
        test = transform(np.asarray(test_layers))
        ids, _, _ = knn_search(train, test, hits, device=device)
        auc1s, tps = evaluate_rows(data, ids)
        records.append((name, float(np.mean(auc1s)), float(np.mean(tps))))
    records.sort(key=lambda r: -r[1])
    return records


def lstm1_vs_sum(
    dataset_lstm1: Dataset,
    dataset_sum: Dataset,
    figures_dir: Optional[Path] = None,
    hits: int = 13,
    device="cuda",
) -> Dict[str, float]:
    """Compare the LSTM1-only and summed-layer embeddings of the same data
    (reference: seqvec_search/lstm1_vs_sum.py; fixtures pfam-20-10 vs
    pfam-20-10-sum)."""
    out = {}
    curves = []
    for tag, ds in [("LSTM1", dataset_lstm1), ("Sum", dataset_sum)]:
        ids, _, _ = knn_search(
            ds.load_train(), ds.load_test(), hits, device=device
        )
        auc1s, _ = evaluate_rows(ds, ids)
        out[tag] = float(np.mean(auc1s))
        curves.append(auc1s)
    if figures_dir is not None:
        from ..eval.figures import make_figure

        make_figure(
            figures_dir, curves, ["LSTM1", "Sum"], "AUC1", "lstm1_vs_sum.jpg"
        )
    return out


def mmseqs_sensitivity_sweep(
    data: Dataset, sensitivities: Sequence[float] = tuple(range(1, 9))
) -> List[Dict]:
    """Wall time + AUC1 per -s (reference: benchmark_mmseqs.sh +
    figures/mmseqs_benchmark.py). Needs the mmseqs binary."""
    from .. import interop

    records = []
    for s in sensitivities:
        seconds = interop.search(data, sensitivity=float(s))
        hits = interop.read_result_db(
            data, data.mmseqs_dir / "result_mmseqs2"
        )
        auc1s, tps = evaluate_string_results(data, hits.items())
        records.append(
            {
                "sensitivity": float(s),
                "auc1": float(np.mean(auc1s)),
                "tp": float(np.mean(tps)),
                "search_time": seconds,
            }
        )
    return records
