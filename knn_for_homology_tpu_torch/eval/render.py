"""Rendered figure families — the reference's full `endfig` inventory.

Each function renders one figure family (svg+jpg+eps via eval.figures.endfig)
and drops the raw arrays as npz beside it (the reproduce-without-recompute
contract). Reference call sites:
  * CATH:    cath/cath.py:326,586,622,785,819,857,896,947
  * Pfam domains:   pfam/pfam.py:199,241,273,313,557,598,713
  * Pfam proteins:  pfam/proteins.py:519,538,564,600,684,729

All inputs are plain numpy arrays/dicts so the renderers are callable with
data reloaded from the npz dumps. matplotlib is imported lazily (headless
metric-only runs never pay for it).
"""

from pathlib import Path
from typing import Dict, Optional, Sequence, Tuple

import numpy as np

from .analysis import rolling_mean
from .figures import _plt, endfig, save_raw

FIGSIZE = (5, 5 * (4.8 / 6.4))  # the reference's standard frame


def _new_figure():
    plt = _plt()
    plt.figure(figsize=FIGSIZE)
    return plt


# --- CATH ----------------------------------------------------------------------


def figure_superfamily_vs_accuracy(
    figures_dir: Path,
    per_method: Dict[str, Tuple[np.ndarray, np.ndarray]],  # label -> (size, acc)
    name: str = "superfamily-vs-accuracy",
) -> None:
    """Scatter of per-superfamily size vs accuracy
    (reference: cath/cath.py:296-326)."""
    plt = _new_figure()
    raw = {}
    for label, (sizes, accs) in per_method.items():
        plt.scatter(sizes, accs, s=4, label=label)
        raw[f"{label}_size"] = sizes
        raw[f"{label}_accuracy"] = accs
    plt.xlabel("Superfamily size")
    plt.ylabel("QrawTop1")
    plt.legend()
    plt.grid()
    save_raw(figures_dir, name, **raw)
    endfig(figures_dir, name)


def figure_superfamily_vs_delta(
    figures_dir: Path,
    sizes: np.ndarray,
    delta: np.ndarray,
    best_label: str,
    name: str = "superfamily-vs-delta-accuracy",
) -> None:
    """(reference: cath/cath.py:567-586)"""
    plt = _new_figure()
    plt.scatter(sizes, delta)
    plt.xlabel("Superamily size")  # sic — the reference's label
    plt.ylabel(f"QrawTop1 {best_label} - QrawTop1 MMseqs2")
    plt.grid()
    plt.hlines(0, 0, max(float(np.max(sizes)), 250), colors="black")
    save_raw(figures_dir, name, sizes=sizes, delta=delta)
    endfig(figures_dir, name)


def figure_accuracy_combined(
    figures_dir: Path,
    cutoffs: np.ndarray,
    simple: np.ndarray,
    combined: np.ndarray,
    knn_level: float,
    mmseqs_level: float,
    name: str,
    y_label: str,
    best_label: str = "knn",
) -> None:
    """MMseqs2/kNN E-value-cutoff merge curves
    (reference: cath/cath.py:592-622 plot_accuracy_combined)."""
    plt = _new_figure()
    plt.plot(cutoffs, combined, label=f"MMseqs2 with cutoff + {best_label}")
    plt.axhline(knn_level, color="green", label=best_label)
    plt.axhline(mmseqs_level, color="black", label="MMseqs2 baseline")
    plt.plot(cutoffs, simple, label="MMseqs2 with cutoff")
    plt.xscale("log")
    plt.ylim((0, 1))
    plt.xlabel("E-Value cutoff")
    plt.ylabel(y_label)
    plt.legend()
    plt.grid()
    save_raw(
        figures_dir, name,
        cutoffs=cutoffs, e_accuracy_simple_=simple,
        e_accuracy_combined_=combined,
        knn_level=knn_level, mmseqs_level=mmseqs_level,
    )
    endfig(figures_dir, name)


def figure_coverage_vs_accuracy(
    figures_dir: Path,
    curves: Dict[str, Tuple[np.ndarray, np.ndarray]],  # label -> (x, y)
    diagonal: bool = False,
    xlabel: str = "Fraction of annotated queries",
    ylabel: str = "QrawTop1",
    name: str = "coverage-vs-accuracy",
) -> None:
    """Cumulative accuracy over best-first annotation order
    (reference: cath/cath.py:726-785, pfam/pfam.py:210-241)."""
    plt = _new_figure()
    raw = {}
    for label, (x, y) in curves.items():
        plt.plot(x, y, label=label)
        raw[f"{label}_x"] = x
        raw[f"{label}_y"] = y
    if diagonal:
        plt.plot([0, 1], [0, 1], color="grey", linestyle="dashed",
                 label="Perfect method")
        plt.xlim((0, 1))
        plt.ylim((0, 1))
    plt.xlabel(xlabel)
    plt.ylabel(ylabel)
    plt.legend()
    plt.grid()
    save_raw(figures_dir, name, **raw)
    endfig(figures_dir, name)


def figure_length_vs_accuracy(
    figures_dir: Path,
    lengths: np.ndarray,
    correct_per_method: Dict[str, np.ndarray],
    window_size: int = 1000,
    name: str = "length-vs-accuracy",
) -> None:
    """Rolling-mean accuracy over length-sorted queries
    (reference: cath/cath.py:789-819)."""
    plt = _new_figure()
    order = np.argsort(lengths)
    window = min(window_size, max(len(lengths) // 4, 1))
    raw = {"lengths": lengths}
    for label, correct in correct_per_method.items():
        y = rolling_mean(correct[order].astype(np.float64), window)
        x = rolling_mean(lengths[order].astype(np.float64), window)
        plt.plot(x, y, label=label)
        raw[f"{label}_correct"] = correct
    plt.ylim((0, 1))
    plt.xlabel(f"Rolling mean length over {window} entries")
    plt.ylabel(f"Rolling mean accuracy over {window} entries")
    plt.legend(loc="lower right")
    plt.grid()
    save_raw(figures_dir, name, **raw)
    endfig(figures_dir, name)


def _errorbar_bins(plt, x_ticks, ys, label, marker=None):
    y = [float(np.mean(b)) if len(b) else np.nan for b in ys]
    yerr = [
        float(np.std(b) / np.sqrt(len(b))) if len(b) else 0.0 for b in ys
    ]
    plt.errorbar(x=x_ticks, y=y, yerr=yerr, label=label, marker=marker)
    return y, yerr


def figure_length_binned(
    figures_dir: Path,
    lengths: np.ndarray,
    correct_per_method: Dict[str, np.ndarray],
    bin_size: int = 50,
    buckets: int = 6,
    name: str = "length-vs-accuracy-binned",
) -> None:
    """Fixed-width length bins with standard errors
    (reference: cath/cath.py:823-857)."""
    plt = _new_figure()
    edges = np.arange(0, bin_size * (buckets - 1), bin_size)
    x_ticks = [f"{i}-{i + bin_size}" for i in edges] + [
        f">{bin_size * (buckets - 1)}"
    ]
    raw = {"lengths": lengths}
    for label, correct in correct_per_method.items():
        ys = [
            correct[(lengths >= s) & (lengths < s + bin_size)] for s in edges
        ]
        ys.append(correct[lengths >= bin_size * (buckets - 1)])
        _errorbar_bins(plt, x_ticks, ys, label)
        raw[f"{label}_correct"] = correct
    plt.legend()
    plt.ylim((0, 1))
    plt.grid(axis="y")
    plt.xlabel("Length bin")
    plt.ylabel("QrawTop1")
    plt.tight_layout()
    save_raw(figures_dir, name, **raw)
    endfig(figures_dir, name)


def hist_evenly_bins(
    sorted_x: np.ndarray, sorted_y: np.ndarray, bins: int,
    fmt: str = "{:.0f}",
):
    """Quantile bins: 1/(bins+1) of the data each
    (reference: cath/cath.py:862-875, pfam/pfam.py:282-296)."""
    ys, ticks = [], []
    n = len(sorted_x)
    for i in range(bins):
        start = n * i // (bins + 1)
        stop = n * (i + 1) // (bins + 1)
        ys.append(sorted_y[start:stop])
        ticks.append(
            f"{fmt.format(sorted_x[start])}-"
            f"{fmt.format(sorted_x[min(stop, n - 1)])}"
        )
    return ticks, ys


def figure_length_binned_even(
    figures_dir: Path,
    lengths: np.ndarray,
    correct_per_method: Dict[str, np.ndarray],
    bins: int = 7,
    name: str = "length-vs-accuracy-binned2",
) -> None:
    """Even-occupancy length bins (reference: cath/cath.py:878-896)."""
    plt = _new_figure()
    order = np.argsort(lengths)
    raw = {"lengths": lengths}
    for label, correct in correct_per_method.items():
        ticks, ys = hist_evenly_bins(lengths[order], correct[order], bins)
        _errorbar_bins(plt, ticks, ys, label)
        raw[f"{label}_correct"] = correct
    plt.legend()
    plt.ylim((0, 1))
    plt.grid(axis="y")
    plt.xlabel(f"Length bin (1/{bins} of sequences per bin)")
    plt.ylabel("QrawTop1")
    plt.tight_layout()
    save_raw(figures_dir, name, **raw)
    endfig(figures_dir, name)


def figure_evalue_vs_score_scatter(
    figures_dir: Path,
    scores: np.ndarray,
    e_values: np.ndarray,
    name: str = "e_value_vs_cosine_scatter",
) -> None:
    """(reference: cath/cath.py:936-947)"""
    plt = _new_figure()
    plt.scatter(scores, e_values, s=0.1)
    plt.yscale("log")
    plt.ylim(top=10**3, bottom=10**-7)
    plt.ylabel("E-value")
    plt.xlabel("Cosine similarity")
    plt.grid()
    plt.tight_layout()
    save_raw(figures_dir, name, scores=scores, e_values=e_values)
    endfig(figures_dir, name)


# --- Pfam domains ---------------------------------------------------------------


def figure_combining_cutoff(
    figures_dir: Path,
    e_value_sorted: np.ndarray,
    mmseqs_with_cutoff: np.ndarray,
    combined: np.ndarray,
    mmseqs_level: float,
    knn_level: float,
    name: str = "combining-mmseqs-and-knn",
) -> None:
    """(reference: pfam/pfam.py:166-199)"""
    plt = _new_figure()
    plt.axhline(mmseqs_level, color="black", label="MMSeqs2 baseline")
    plt.axhline(knn_level, color="green", label="k-nn")
    plt.plot(e_value_sorted, mmseqs_with_cutoff, label="MMseqs2 with cutoff")
    plt.plot(e_value_sorted, combined, label="MMSeqs2 E<1 + k-nn")
    plt.xlim((10**-12, 10**6))
    plt.ylim((0, 1))
    plt.grid()
    plt.xlabel("E-value cutoff")
    plt.ylabel("Accuracy")
    plt.xscale("log")
    plt.legend()
    save_raw(
        figures_dir, name,
        e_value_sorted=e_value_sorted,
        combined_accuracy=combined,
        mmseqs_with_cutoff_accuracy=mmseqs_with_cutoff,
        top_hit_correct=mmseqs_level,
        knn_1_correct=knn_level,
    )
    endfig(figures_dir, name)


def figure_accuracy_by_evalue(
    figures_dir: Path,
    top_hit_e_value: np.ndarray,
    correct_per_method: Dict[str, np.ndarray],
    window_size: int = 1000,
    xlim: bool = True,
    name: str = "accuracy-by-e-value",
) -> None:
    """Rolling accuracy over E-value-sorted top hits
    (reference: pfam/pfam.py:248-273)."""
    plt = _new_figure()
    order = np.argsort(-top_hit_e_value)
    window = min(window_size, max(len(order) // 4, 1))
    x = rolling_mean(top_hit_e_value[order], window)
    raw = {"top_hit_e_value": top_hit_e_value, "window_size": window}
    for label, correct in correct_per_method.items():
        plt.plot(x, rolling_mean(correct[order].astype(np.float64), window),
                 label=label)
        raw[f"{label}_correct"] = correct
    plt.xscale("log")
    plt.xlabel(f"Rolling mean E-value over {window} hits")
    plt.ylabel(f"Rolling mean accuracy over {window} hits")
    plt.ylim((-0.05, 1.05))
    if xlim:
        plt.xlim((10**-10, 10**3))
    plt.grid()
    plt.legend()
    save_raw(figures_dir, name, **raw)
    endfig(figures_dir, name)


def figure_accuracy_by_evalue_binned(
    figures_dir: Path,
    top_hit_e_value: np.ndarray,
    correct_per_method: Dict[str, np.ndarray],
    bins: int = 10,
    name: str = "accuracy-by-e-value-binned",
) -> None:
    """(reference: pfam/pfam.py:279-313)"""
    plt = _new_figure()
    order = np.argsort(-top_hit_e_value)
    raw = {"top_hit_e_value": top_hit_e_value}
    for label, correct in correct_per_method.items():
        ticks, ys = hist_evenly_bins(
            top_hit_e_value[order], correct[order], bins, fmt="{:0.0E}"
        )
        plt.xticks(rotation=30)
        _errorbar_bins(plt, ticks, ys, label, marker="v")
        raw[f"{label}_correct"] = correct
    plt.tight_layout()
    plt.subplots_adjust(bottom=0.2, left=0.1)
    plt.grid(axis="y")
    plt.xlabel(f"E-value bucket (1/{bins} of sequences per bucket)")
    plt.ylabel("Accuracy")
    plt.ylim((-0.05, 1.05))
    plt.legend()
    save_raw(figures_dir, name, **raw)
    endfig(figures_dir, name)


def figure_tp(
    figures_dir: Path,
    curves: Dict[str, np.ndarray],
    xlim: Optional[Tuple[float, float]] = (0, 300),
    name: str = "tp",
) -> None:
    """Cumulative-TP by rank (reference: pfam/pfam.py:540-557)."""
    plt = _new_figure()
    for label, curve in curves.items():
        plt.plot(curve, label=label)
    plt.xlabel("Number of hits")
    plt.ylabel("Fraction of TP")
    if xlim is not None:
        plt.xlim(xlim)
    plt.legend()
    plt.grid()
    save_raw(figures_dir, name, **curves)
    endfig(figures_dir, name)


def figure_precision_recall(
    figures_dir: Path,
    curves: Dict[str, Tuple[np.ndarray, np.ndarray]],  # label -> (recall, precision)
    name: str = "precision_recall",
    legend_loc: str = "best",
) -> None:
    """(reference: pfam/pfam.py:561-598, pfam/proteins.py:605-684)"""
    plt = _new_figure()
    raw = {}
    for label, (recall, precision) in curves.items():
        plt.plot(recall, precision, label=label)
        raw[f"{label}_recall"] = recall
        raw[f"{label}_precision"] = precision
    plt.xlabel("Recall")
    plt.ylabel("Precision")
    plt.legend(loc=legend_loc)
    plt.xlim((0, 1))
    plt.ylim((0, 1))
    plt.grid()
    plt.tight_layout()
    save_raw(figures_dir, name, **raw)
    endfig(figures_dir, name)


def figure_auc1_reverse_cdf(
    figures_dir: Path,
    auc1s_per_method: Dict[str, np.ndarray],
    name: str = "auc1",
) -> None:
    """Reverse-cumulative AUC1 histogram (reference: pfam/pfam.py:671-713)."""
    plt = _new_figure()
    raw = {}
    for label, auc1s in auc1s_per_method.items():
        auc1s = np.asarray(auc1s, dtype=np.float64)
        bins = sorted(set(auc1s.tolist()))
        if len(bins) < 2:
            bins = [0.0, 1.0]
        plt.hist(auc1s, bins=bins, cumulative=-1, histtype="step", label=label)
        raw[label] = auc1s
    plt.xlabel("AUC1")
    plt.ylabel("Number of queries reaching this AUC1")
    plt.legend()
    plt.grid()
    save_raw(figures_dir, name, **raw)
    endfig(figures_dir, name)


# --- Pfam full proteins -----------------------------------------------------------


def figure_accuracy_over_hits(
    figures_dir: Path,
    curves: Dict[str, np.ndarray],  # label -> mean fraction found per rank
    name: str = "accuracy_over_hits",
) -> None:
    """(reference: pfam/proteins.py:502-519)"""
    plt = _new_figure()
    for label, curve in curves.items():
        plt.plot(curve, label=label)
    plt.ylim((0, 1))
    plt.xlabel("Number of hits")
    plt.ylabel("Mean fraction of homologous sequences found")
    plt.grid()
    plt.legend()
    plt.tight_layout()
    save_raw(figures_dir, name, **curves)
    endfig(figures_dir, name)


def figure_auc1_sorted_cdf(
    figures_dir: Path,
    auc1s_per_method: Dict[str, np.ndarray],
    name: str = "auc1",
) -> None:
    """Sorted per-query AUC1 curves (reference: pfam/proteins.py:523-538)."""
    plt = _new_figure()
    styles = [("C1", "dashdot"), ("C0", "solid"), ("C2", "dotted"),
              ("C3", "solid")]
    raw = {}
    for (label, auc1s), (color, ls) in zip(
        auc1s_per_method.items(), styles * 8
    ):
        auc1s = np.asarray(auc1s, dtype=np.float64)
        plt.plot(
            np.linspace(0, 1, len(auc1s)),
            auc1s[np.argsort(-auc1s)],
            label=f"{label} (mean: {auc1s.mean():.3f})",
            color=color, linestyle=ls,
        )
        raw[label] = auc1s
    plt.xlabel("AUC1 sensitivity")
    plt.ylabel("Fraction of queries with at least this AUC1")
    plt.grid()
    plt.legend(loc="lower center")
    plt.tight_layout()
    save_raw(figures_dir, name, **raw)
    endfig(figures_dir, name)


def figure_length_vs_auc1(
    figures_dir: Path,
    lengths: np.ndarray,
    auc1s_per_method: Dict[str, np.ndarray],
    name: str = "protein_length_vs_auc1",
) -> None:
    """Running mean AUC1 over length-descending queries
    (reference: pfam/proteins.py:542-564)."""
    plt = _new_figure()
    order = np.argsort(-lengths)
    meanifier = np.arange(1, len(lengths) + 1)
    styles = [("C1", "dashdot"), ("C0", "solid"), ("C2", "dotted"),
              ("C3", "solid")]
    raw = {"lengths": lengths}
    for (label, auc1s), (color, ls) in zip(
        auc1s_per_method.items(), styles * 8
    ):
        plt.plot(
            lengths[order],
            np.asarray(auc1s)[order].cumsum() / meanifier,
            label=label, color=color, linestyle=ls,
        )
        raw[label] = np.asarray(auc1s)
    median_length = float(np.median(lengths))
    plt.vlines([median_length], 0, 1, color="black",
               label="Median protein length")
    plt.xlim((0, max(1000.0, median_length * 2)))
    plt.xlabel("Protein length (lower limit)")
    plt.ylabel("AUC1")
    plt.grid()
    plt.legend()
    plt.tight_layout()
    save_raw(figures_dir, name, **raw)
    endfig(figures_dir, name)


def figure_length_bucketed_auc1(
    figures_dir: Path,
    lengths: np.ndarray,
    auc1s_per_method: Dict[str, np.ndarray],
    limits: Sequence[int] = (200, 400, 600, 800, 1000),
    name: str = "length_bucketed_auc1",
) -> None:
    """(reference: pfam/proteins.py:568-600)"""
    plt = _new_figure()
    limits = list(limits)
    x_ticks = [f"<{limits[0]}"]
    x_ticks += [f"{a}-{b}" for a, b in zip(limits[:-1], limits[1:])]
    x_ticks.append(f">{limits[-1]}")
    raw = {"lengths": lengths}
    for label, auc1s in auc1s_per_method.items():
        auc1s = np.asarray(auc1s)
        ys = [auc1s[lengths < limits[0]]]
        for a, b in zip(limits[:-1], limits[1:]):
            ys.append(auc1s[(lengths >= a) & (lengths < b)])
        ys.append(auc1s[lengths >= limits[-1]])
        _errorbar_bins(plt, x_ticks, ys, label)
        raw[label] = auc1s
    plt.xlabel("Length bucket")
    plt.ylabel("AUC1 sensitivity")
    plt.grid()
    plt.legend()
    plt.tight_layout()
    save_raw(figures_dir, name, **raw)
    endfig(figures_dir, name)


def figure_cosine_bucketed_accuracy(
    figures_dir: Path,
    bucket_centers: np.ndarray,
    precision: np.ndarray,
    sem: np.ndarray,
    smoothness: int = 100,
    label: str = "ProtT5 knn",
    name: str = "cosine_bucketed_accuracy",
) -> None:
    """Score-calibration scatter (reference: pfam/proteins.py:688-729)."""
    plt = _new_figure()
    plt.scatter(bucket_centers, precision, s=0.5, label=label)
    plt.errorbar(bucket_centers, precision, yerr=sem, linestyle="none")
    plt.xlabel(f"cosine similarity bucket (1/{smoothness})")
    plt.ylabel("Accuracy")
    plt.legend()
    plt.grid()
    plt.tight_layout()
    save_raw(
        figures_dir, name,
        bucket_centers=bucket_centers, precision=precision, sem=sem,
    )
    endfig(figures_dir, name)
