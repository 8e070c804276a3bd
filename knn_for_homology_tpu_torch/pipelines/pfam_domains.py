"""Pfam20 domain-level pipeline (subset10); port of
knn_for_homology_tpu/pipelines/pfam_domains.py.

Parity with the reference's domain workload (reference: pfam/pfam.py):
kNN (LSH or flat) over domain embeddings, optional MMseqs2 baselines
(plain + --num-iterations 3) when the binary exists, the kNN→alignment
rescoring path, E-value-cutoff combination sweep, TP-set overlap stats,
precision-recall and cumulative-TP curves.

Published anchors (reference: pfam/pfam.py:456-459,536): kNN AUC1 0.565,
MMseqs2 0.659, iterated 0.743, combined E<1 0.738, kNN+align 0.69.

The device is explicit ("cuda" unless the caller asks for the CPU): the LSH
index and the Smith-Waterman rescoring (kernel C) run there. Without an
`mmseqs` binary the MMseqs2 baselines are skipped, as in the JAX package.
"""

import logging
from pathlib import Path
from typing import Dict, Optional

import numpy as np

from ..config import DEFAULT_HITS
from ..data.dataset import Dataset
from ..device import resolve_device
from ..eval import analysis
from ..eval.metrics import (
    correctness_matrix,
    evaluate_rows,
    evaluate_string_results,
    hit_family_codes,
    precision_recall_curve,
    tp_cumulative,
)

from ..search.io import read_index
from ..search.lsh import LSHIndex
from ..search.rescore import align_rescore

logger = logging.getLogger(__name__)


def run(
    dataset_path: Path,
    hits: int = 1000,
    index_path: Optional[Path] = None,
    lsh_bits: int = 1024,
    figures_dir: Optional[Path] = None,
    rescore_hits: int = DEFAULT_HITS,
    device="cuda",
) -> Dict[str, float]:
    """Returns the summary metrics dict (the reference prints these as
    result comments, pfam/pfam.py:456-459)."""
    device = resolve_device(device)
    data = Dataset.from_dir(dataset_path, hits)
    queries = data.load_test()
    summary: Dict[str, float] = {}
    sizes = data.train_family_sizes[data.test_family_codes].astype(np.float64)
    total_relevant = float(sizes.sum())  # pfam/pfam.py:562 total_to_be_found

    def tp_at(correct: np.ndarray, at: int) -> float:
        return float((correct[:, : min(at, correct.shape[1])].sum(1) / sizes).mean())

    # --- kNN over LSH (the reference's precomputed path, pfam/pfam.py:49-50)
    if index_path is not None and Path(index_path).exists():
        index = read_index(index_path, device=device)
    else:
        index = LSHIndex(queries.shape[1], nbits=lsh_bits, device=device).add(
            data.load_train()
        )
    k = min(hits, index.ntotal)
    knn_scores, knn_hits = index.search(queries, k)
    auc1s, tps = evaluate_rows(data, knn_hits)
    summary["knn_auc1"] = float(np.mean(auc1s))
    summary["knn_tp"] = float(np.mean(tps))
    knn_correct = correctness_matrix(
        data.test_family_codes,
        hit_family_codes(knn_hits, data.train_family_codes),
    )
    summary["knn_tp10"] = tp_at(knn_correct, 10)
    # the published anchor is TP@300 ("Mean TP (300): 0.839",
    # pfam/pfam.py:459)
    summary["knn_tp300"] = tp_at(knn_correct, 300)

    # --- kNN + alignment rescoring (pfam/pfam.py:468-533) ---
    aligned, aligned_evs, _ = align_rescore(
        data, knn_hits[:, :rescore_hits], device=device
    )
    auc1s_al, tps_al = evaluate_string_results(data, aligned.items())
    summary["knn_align_auc1"] = float(np.mean(auc1s_al))
    summary["knn_align_tp"] = float(np.mean(tps_al))

    # integer-row form of the aligned lists (ragged, ascending E)
    train_row = {tid: i for i, tid in enumerate(data.train_ids)}
    al_hits = [
        np.asarray(
            [train_row[t] for t in aligned.get(qid, [])], dtype=np.int64
        )
        for qid in data.test_ids
    ]
    al_evs = [
        np.asarray(aligned_evs.get(qid, []), dtype=np.float64)
        for qid in data.test_ids
    ]
    al_rows, al_ev_arr = _pad_ragged(al_hits, al_evs)
    al_correct = correctness_matrix(
        data.test_family_codes,
        hit_family_codes(al_rows, data.train_family_codes),
    )
    summary["knn_align_tp10"] = tp_at(al_correct, 10)
    summary["knn_align_tp300"] = tp_at(al_correct, 300)

    # --- MMseqs2 baselines when available (pfam/pfam.py:56-122) ---
    from ..interop import find_mmseqs

    extra_cumulative = []  # (label, hit rows) for the cumulative-TP figure
    if not find_mmseqs():
        logger.info("no mmseqs binary: the MMseqs2 baselines are skipped")
    else:
        from .. import interop

        for tag, kwargs in [
            ("mmseqs", {}),
            ("mmseqs_iterated", {"num_iterations": 3}),
        ]:
            interop.search(data, **kwargs)
            mm_hits, mm_evs = interop.read_result_db_with_e_value(
                data.train_ids, data.mmseqs_train, data.test_ids,
                data.mmseqs_test, data.mmseqs_dir / "result_mmseqs2",
            )
            hit_arr, ev_arr = interop.results_to_array(mm_hits, mm_evs)
            a, t = evaluate_rows(data, hit_arr)
            summary[f"{tag}_auc1"] = float(np.mean(a))
            summary[f"{tag}_tp"] = float(np.mean(t))
            mm_correct = correctness_matrix(
                data.test_family_codes,
                hit_family_codes(hit_arr, data.train_family_codes),
            )
            summary[f"{tag}_tp10"] = tp_at(mm_correct, 10)
            summary[f"{tag}_tp300"] = tp_at(mm_correct, 300)
            if tag == "mmseqs":
                # E-value cutoff combination sweep (pfam/pfam.py:166-199)
                e_sorted, combined, simple = analysis.top1_cutoff_sweep(
                    ev_arr[:, 0], mm_correct[:, 0], knn_correct[:, 0]
                )
                summary["combined_best"] = float(combined.max())
                if figures_dir is not None:
                    from ..eval import render as R

                    R.figure_combining_cutoff(
                        figures_dir, e_sorted, simple, combined,
                        mmseqs_level=float(mm_correct[:, 0].mean()),
                        knn_level=float(knn_correct[:, 0].mean()),
                    )
                    # coverage-vs-accuracy: accuracy among annotated
                    # queries, annotated best-first (pfam/pfam.py:210-241)
                    def _cov(correct, key):
                        order = np.argsort(key, kind="stable")
                        flags = np.asarray(correct, np.float64)[order]
                        return (
                            np.linspace(0, 1, len(flags)),
                            np.cumsum(flags) / np.arange(1, len(flags) + 1),
                        )

                    e_cut = 1.0
                    top_e = ev_arr[:, 0]
                    comb_correct = np.where(
                        top_e < e_cut, mm_correct[:, 0], knn_correct[:, 0]
                    )
                    # one comparable confidence scale for the interleave
                    # (reference pfam.py:207-227 keys both methods on a
                    # shared -E / -score axis; its knn scores are distances,
                    # ours are cosines): E-1 maps mmseqs E<1 keys onto
                    # [-1, 0) and -cos maps knn onto [-1, 1], so confident
                    # hits of BOTH methods interleave near -1 instead of
                    # every knn-annotated query outranking every mmseqs hit
                    comb_key = np.where(
                        top_e < e_cut, top_e - 1.0, -knn_scores[:, 0]
                    )
                    R.figure_coverage_vs_accuracy(
                        figures_dir,
                        {
                            "MMseqs2": _cov(mm_correct[:, 0], top_e),
                            "MMseqs2 E<1 + k-nn": _cov(
                                comb_correct, comb_key
                            ),
                            # cosine is higher-is-better: negate so the
                            # annotation order is best-first like the others
                            "k-nn": _cov(
                                knn_correct[:, 0], -knn_scores[:, 0]
                            ),
                        },
                        ylabel="Accuracy of annotated queries",
                    )
                    # rolling + binned accuracy over top-hit E-value
                    # (pfam/pfam.py:248-313)
                    by_e = {
                        "MMseqs2": mm_correct[:, 0],
                        "k-nn": knn_correct[:, 0],
                    }
                    R.figure_accuracy_by_evalue(figures_dir, top_e, by_e)
                    R.figure_accuracy_by_evalue_binned(
                        figures_dir, top_e, by_e
                    )

                # TP-set overlap (pfam/pfam.py:349-370): which correct hits
                # each method finds, as fractions of all relevant pairs
                knn_tp_sets = [
                    row[flag] for row, flag in zip(knn_hits, knn_correct)
                ]
                mm_tp_sets = [
                    np.asarray(mm_hits[i])[
                        np.asarray(mm_correct[i][: len(mm_hits[i])], bool)
                    ]
                    for i in range(len(mm_hits))
                ]
                overlap = analysis.hit_set_overlap(knn_tp_sets, mm_tp_sets)
                summary["tp_overlap_only_knn"] = overlap["only_a"] / total_relevant
                summary["tp_overlap_both"] = overlap["both"] / total_relevant
                summary["tp_overlap_only_mmseqs"] = (
                    overlap["only_b"] / total_relevant
                )

                # merged-by-E-value combined ranking of kNN+alignment and
                # MMseqs2 (pfam/pfam.py:629-667 + the "combined" result line)
                mm_hit_list = [np.asarray(mm_hits[i]) for i in range(len(mm_hits))]
                mm_ev_list = [np.asarray(mm_evs[i]) for i in range(len(mm_evs))]
                combined_auc1s = analysis.merged_auc1(
                    al_hits, al_evs, mm_hit_list, mm_ev_list,
                    data.train_family_codes, data.test_family_codes,
                    data.train_family_sizes,
                )
                summary["combined_auc1"] = float(np.mean(combined_auc1s))
                combined_rows = analysis.merge_ranked_rows(
                    al_hits, al_evs, mm_hit_list, mm_ev_list, max(k, 300)
                )
                combined_correct = correctness_matrix(
                    data.test_family_codes,
                    hit_family_codes(combined_rows, data.train_family_codes),
                )
                summary["combined_tp10"] = tp_at(combined_correct, 10)
                summary["combined_tp300"] = tp_at(combined_correct, 300)
                extra_cumulative.append(("MMseqs2", hit_arr))
                extra_cumulative.append(("Combined", combined_rows))

                # precision-recall over pooled (query, hit) pairs for the
                # three methods at both rank limits (pfam/pfam.py:561-598)
                # — figure-only data: six O(Q·k log) sorts, skip when no
                # figures_dir (metric-only runs)
                pr_raw = {}
                for limit_name, limit in (
                    [("first_10", 10), ("300", 300)]
                    if figures_dir is not None else []
                ):
                    for label, scores_m, correct_m, hib in [
                        ("mmseqs", ev_arr, mm_correct, False),
                        ("knn", knn_scores, knn_correct, True),
                        ("knn_aligned", al_ev_arr, al_correct, False),
                    ]:
                        lim = min(limit, scores_m.shape[1], correct_m.shape[1])
                        precision, recall = precision_recall_curve(
                            scores_m[:, :lim],
                            correct_m[:, :lim],
                            higher_is_better=hib,
                            total_relevant=total_relevant,
                        )
                        pr_raw[f"{label}_{limit_name}_precision"] = precision
                        pr_raw[f"{label}_{limit_name}_recall"] = recall
                if figures_dir is not None:
                    from ..eval import render as R
                    from ..eval.figures import save_raw

                    save_raw(figures_dir, "precision_recall", **pr_raw)
                    # rendered PR curves, one per rank limit
                    # (pfam/pfam.py:561-598 endfig precision_recall_*)
                    label_map = {
                        "mmseqs": "mmseqs",
                        "knn": "k-nn",
                        "knn_aligned": "k-nn + alignment",
                    }
                    for limit_name in ("first_10", "300"):
                        R.figure_precision_recall(
                            figures_dir,
                            {
                                nice: (
                                    pr_raw[f"{key}_{limit_name}_recall"],
                                    pr_raw[f"{key}_{limit_name}_precision"],
                                )
                                for key, nice in label_map.items()
                            },
                            name=f"precision_recall_{limit_name}",
                        )
                    # AUC1 reverse-cumulative histogram (pfam/pfam.py:713)
                    R.figure_auc1_reverse_cdf(
                        figures_dir,
                        {
                            "MMSeqs + k-nn aligned": combined_auc1s,
                            "MMSeqs2": a,
                            "k-nn": auc1s,
                        },
                    )

    if figures_dir is not None:
        from ..eval import render as R
        from ..eval.figures import figure_tp_cumulative, make_figure

        make_figure(
            figures_dir, [auc1s, auc1s_al],
            ["k-NN", "k-NN + Alignment"], "AUC1", "pfam_auc1.jpg",
        )
        # cumulative TP for every method that ran (pfam/pfam.py:540-557)
        curve_labels = ["k-NN", "k-NN + Alignment"]
        curves = [tp_cumulative(data, knn_hits), tp_cumulative(data, al_rows)]
        for label, rows in extra_cumulative:
            curve_labels.append(label)
            curves.append(tp_cumulative(data, rows))
        figure_tp_cumulative(figures_dir, curve_labels, curves, "tp_cumulative")
        # the reference's "tp" frame: svg+jpg+eps, rank-limited to 300
        R.figure_tp(
            figures_dir, dict(zip(curve_labels, curves)),
            xlim=(0, min(300, max(len(c) for c in curves))),
        )
    logger.info("pfam domain summary: %s", summary)
    return summary


def _pad_ragged(hit_lists, ev_lists, sentinel_e: float = 1e5):
    """Ragged per-query (hits, E-values) → rectangular arrays, -1 / sentinel
    padded (the engine-wide missing-hit convention)."""
    width = max(1, max(len(h) for h in hit_lists))
    rows = np.full((len(hit_lists), width), -1, dtype=np.int64)
    evs = np.full((len(hit_lists), width), sentinel_e, dtype=np.float64)
    for i, (h, e) in enumerate(zip(hit_lists, ev_lists)):
        rows[i, : len(h)] = h
        evs[i, : len(e)] = e
    return rows, evs
