"""Figure utilities — reproducible outputs + raw-data-alongside contract.

Parity with the reference (reference: seqvec_search/utils.py:18,89-100,
seqvec_search/main.py:85-111, seqvec_search/tp_cumulative.py:37-54):
deterministic svg (hashsalt 42, empty Date metadata), jpg at 600 dpi q85,
eps; every figure's raw data saved as npz next to it so plots re-render
without recompute. matplotlib is imported lazily so headless/metric-only
runs never pay for it.
"""

from pathlib import Path
from typing import Dict, Iterable, List

import numpy as np


def _plt():
    import matplotlib

    matplotlib.use("Agg")
    matplotlib.rcParams["svg.hashsalt"] = "42"
    from matplotlib import pyplot as plt

    return plt


def endfig(base_dir: Path, name: str) -> None:
    """svg+jpg+eps with deterministic metadata
    (reference: seqvec_search/utils.py:89-100)."""
    plt = _plt()
    base_dir = Path(base_dir)
    base_dir.mkdir(parents=True, exist_ok=True)
    plt.savefig(str(base_dir / f"{name}.svg"), metadata={"Date": ""})
    plt.savefig(str(base_dir / f"{name}.jpg"), dpi=600, pil_kwargs=dict(quality=85))
    plt.savefig(str(base_dir / f"{name}.eps"))
    plt.close()


def make_figure(
    figure_dir: Path,
    scores_list: List[List[float]],
    labels: List[str],
    score: str,
    filename: str,
    svg: bool = False,
) -> None:
    """Sorted-CDF comparison plot + npz raw dump
    (reference: seqvec_search/main.py:85-111)."""
    plt = _plt()
    figure_dir = Path(figure_dir)
    figure_dir.mkdir(parents=True, exist_ok=True)
    datafile = figure_dir / (filename.split(".")[0] + "-data.npz")
    np.savez(
        str(datafile),
        **{key: np.asarray(val) for key, val in zip(labels, scores_list)},
    )
    for scores_row, label in zip(scores_list, labels):
        sorted_scores = np.flip(np.sort(np.asarray(scores_row)))
        plt.plot(np.linspace(0, 1, len(sorted_scores)), sorted_scores, label=label)
    plt.xlabel(
        f"Fraction of queries with at least this {score} (n={len(scores_list[0])})"
    )
    plt.ylabel(score)
    plt.legend()
    plt.grid()
    plt.savefig(str(figure_dir / filename))
    if svg:
        plt.savefig(str((figure_dir / filename).with_suffix(".svg")))
    plt.close()


def figure_tp_cumulative(
    figure_dir: Path,
    names: Iterable[str],
    tp_cumulatives: Iterable[np.ndarray],
    filename: str,
) -> None:
    """(reference: seqvec_search/tp_cumulative.py:37-54)"""
    plt = _plt()
    figure_dir = Path(figure_dir)
    figure_dir.mkdir(parents=True, exist_ok=True)
    names = list(names)
    curves = list(tp_cumulatives)
    np.savez(str(figure_dir / f"{filename}.npz"), **dict(zip(names, curves)))
    for name, curve in sorted(
        zip(names, curves), key=lambda x: -np.sum(x[1])
    ):
        plt.plot(curve, label=name)
    plt.xlabel("Number of hits")
    plt.ylabel("Mean fraction of TP found")
    plt.ylim((0, 1))
    plt.legend()
    plt.grid()
    plt.savefig(str(figure_dir / f"{filename}.jpg"))
    plt.savefig(str(figure_dir / f"{filename}.svg"))
    plt.close()


def save_raw(figure_dir: Path, name: str, **arrays: Dict) -> None:
    """Raw-data npz next to a figure (the reproduce-without-recompute
    contract, reference: cath/cath.py:317 et al.)."""
    figure_dir = Path(figure_dir)
    figure_dir.mkdir(parents=True, exist_ok=True)
    np.savez(
        str(figure_dir / f"{name}.npz"),
        **{k: np.asarray(v) for k, v in arrays.items()},
    )
