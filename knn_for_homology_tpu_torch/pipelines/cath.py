"""CATH20 pipeline: all-vs-all search + top-1 evaluation suite; port
of knn_for_homology_tpu/pipelines/cath.py.

Parity with the reference's CATH workload:
  * search_and_save — every `<data>/*.npy` embedding × {cosine, euclidean},
    self-hit-stripped all-vs-all, hits/scores npz + per-method search-time
    sidecars (reference: cath/search.py:29-53)
  * CathEvaluation — per-level correctness tensors, possibility mask,
    superfamily normalisation, QrawTop1/QnormTop1 accuracy tables with
    bootstrap CIs, confusion matrix, E-value merge sweeps,
    coverage-vs-accuracy, length analyses
    (reference: cath/cath.py:76-114,250-343,404-563,625-896)

Level tuple ordering: index 0 = H (superfamily), 3 = C (class) — see
data/cath.load_mapping.

The search runs on an explicit device, "cuda" unless the caller asks for
the CPU (kernel A serves k = CATH_HITS + 1 on the card).

Usage: python -m knn_for_homology_tpu_torch.pipelines.cath [--data DIR]
       [--hits 10] [--device cuda|cpu]
"""

import time
from collections import Counter
from pathlib import Path
from typing import Dict, List, Optional, Tuple

import numpy as np

from ..data.cath import load_mapping, read_ids
from ..eval import analysis
from ..search.flat import FlatIndex
from ..utils.timing import write_time_sidecar

CATH_HITS = 10  # reference: cath/search.py:14


def search_and_save(
    cath_data: Path, hits: int = CATH_HITS, device="cuda"
) -> None:
    """(reference: cath/search.py:29-53)"""
    cath_data = Path(cath_data)
    for name, metric in [("Cosine", "cosine"), ("Euclidean", "l2")]:
        hit_arrays: Dict[str, np.ndarray] = {}
        score_arrays: Dict[str, np.ndarray] = {}
        for file_path in sorted(cath_data.glob("*.npy")):
            if file_path.stem.startswith(("hits_", "scores_")):
                continue
            embeddings = np.load(file_path).astype(np.float32)
            start = time.time()
            index = FlatIndex(metric=metric, device=device).add(embeddings)
            ids, scores = index.search_self(hits)
            seconds = time.time() - start
            hit_arrays[file_path.stem] = ids
            score_arrays[file_path.stem] = scores
            write_time_sidecar(
                file_path.with_suffix(f".{name.lower()}-search-time.txt"),
                seconds,
            )
        np.savez(cath_data / f"hits_{name.lower()}.npz", **hit_arrays)
        np.savez(cath_data / f"scores_{name.lower()}.npz", **score_arrays)


class CathEvaluation:
    """Holds the level metadata and correctness tensors of one CATH run."""

    def __init__(
        self,
        ids: np.ndarray,
        mapping_levels: Dict[str, Tuple[str, ...]],
        mapping_array: np.ndarray,
    ):
        self.ids = np.asarray(ids)
        self.mapping_levels = mapping_levels
        self.mapping_array = np.asarray(mapping_array)  # [N, 4] level codes
        # family (H-level) sizes over the evaluated id set
        # (reference: cath/cath.py:93-100)
        self.family_sizes = [
            Counter(levels[level] for levels in mapping_levels.values())
            for level in range(4)
        ]
        self.is_possible = np.asarray(
            [self.family_sizes[0][mapping_levels[i][0]] > 1 for i in ids]
        )
        normalization = np.asarray(
            [1.0 / self.family_sizes[0][mapping_levels[i][0]] for i in ids]
        )
        normalization[~self.is_possible] = 0.0
        self.normalization = normalization
        self.families_count = sum(
            1 for size in self.family_sizes[0].values() if size > 1
        )

    @classmethod
    def from_data_dir(
        cls, cath_data: Path, domain_list: Path, ids: Optional[np.ndarray] = None
    ) -> "CathEvaluation":
        ids = read_ids(Path(cath_data)) if ids is None else ids
        levels, array = load_mapping(
            ids, domain_list, cache=Path(cath_data) / "cath-mapping.json"
        )
        return cls(ids, levels, array)

    def compute_is_correct(self, results: np.ndarray) -> np.ndarray:
        """[Q, 4, k] level-match tensor (reference: cath/cath.py:76-90),
        vectorised: compare every hit's level codes with the query's.
        FAISS-style -1 padding counts as wrong at every level (raw indexing
        would wrap to the last domain's codes)."""
        results = np.asarray(results)
        safe = np.clip(results, 0, len(self.mapping_array) - 1)
        hit_levels = self.mapping_array[safe]  # [Q, k, 4]
        query_levels = self.mapping_array[:, None, :]  # [Q, 1, 4]
        correct = hit_levels == query_levels
        correct &= (results >= 0)[:, :, None]
        return np.swapaxes(correct, 1, 2)

    def top1(self, is_correct_all: np.ndarray) -> Tuple[float, float]:
        """(QrawTop1, QnormTop1) of the first non-self hit at H level
        (reference: cath/cath.py:364-398)."""
        top1 = is_correct_all[:, 0, 0]
        raw = float(top1[self.is_possible].mean())
        norm = float((top1 * self.normalization).sum() / self.families_count)
        return raw, norm

    def accuracy_table(
        self,
        hits_per_method: Dict[str, np.ndarray],
        bootstrap: bool = False,
        correct_per_method: Optional[Dict[str, np.ndarray]] = None,
    ) -> List[Tuple]:
        """Method → (QrawTop1, QnormTop1[, ±raw, ±norm]) records sorted by
        QnormTop1 (reference: cath/cath.py:478-563). Pass precomputed
        correctness tensors to avoid recomputation."""
        records = []
        for name, results in hits_per_method.items():
            correct_all = (
                correct_per_method[name]
                if correct_per_method is not None
                else self.compute_is_correct(results)
            )
            raw, norm = self.top1(correct_all)
            if bootstrap:
                fams = self.mapping_array[self.is_possible, 0]
                pm_norm, pm_raw = analysis.bootstrap_top1(
                    correct_all[self.is_possible, 0, 0], fams, norm
                )
                records.append((name, raw, norm, pm_raw, pm_norm))
            else:
                records.append((name, raw, norm))
        records.sort(key=lambda r: -r[2])
        return records

    def per_level_accuracy(self, is_correct_all: np.ndarray) -> Dict[str, float]:
        """Raw top-1 accuracy at each of the 4 CATH levels (H, T, A, C)."""
        out = {}
        for idx, level in enumerate("HTAC"):
            out[level] = float(
                is_correct_all[self.is_possible, idx, 0].mean()
            )
        return out

    def format_table(self, records: List[Tuple]) -> str:
        """The reference's accuracies.md layout (pandas.to_markdown pipe
        table: blank-header name column, then `normalized | raw`, sorted
        by normalized — reference:
        more_sensitive/cath-figures/accuracies.md:1-23)."""
        rows = []
        for rec in records:
            if len(rec) == 5:
                name, raw, norm, pm_raw, pm_norm = rec
                rows.append(
                    (name, f"{norm:.1%}±{pm_norm:.1%}",
                     f"{raw:.1%}±{pm_raw:.1%}")
                )
            else:
                name, raw, norm = rec
                rows.append((name, f"{norm:.1%}", f"{raw:.1%}"))
        headers = ("", "normalized", "raw")
        widths = [
            max(len(h), *(len(r[c]) for r in rows)) if rows else len(h)
            for c, h in enumerate(headers)
        ]

        def line(cells):
            return "| " + " | ".join(
                c.ljust(w) for c, w in zip(cells, widths)
            ) + " |"

        sep = "|" + "|".join(":" + "-" * (w + 1) for w in widths) + "|"
        return "\n".join([line(headers), sep] + [line(r) for r in rows])


def evaluate_and_report(
    cath_data: Path,
    domain_list: Path,
    figures_dir: Path,
    metric: str = "cosine",
    bootstrap: bool = False,
    mmseqs_results: Optional[dict] = None,
    render: bool = True,
) -> dict:
    """The CATH paper-layer entry point: load hits/scores npz, produce the
    accuracy leaderboard (accuracies.md-style), per-level table, confusion
    matrix + merge sweep when MMseqs2 results are supplied, length analysis,
    superfamily scatter — each figure rendered svg+jpg+eps with its raw data
    npz beside it (reference: cath/cath.py end-to-end; outputs mirror
    more_sensitive/cath-figures/: superfamily-vs-accuracy,
    superfamily-vs-delta-accuracy, combining-mmseqs-and-knn-raw/-normalized,
    coverage-vs-accuracy, length-vs-accuracy{,-binned,-binned2},
    e_value_vs_cosine_scatter). `render=False` keeps the npz-only fast
    path for metric-only runs."""
    from ..eval import render as R
    from ..eval.figures import save_raw

    cath_data = Path(cath_data)
    figures_dir = Path(figures_dir)
    figures_dir.mkdir(parents=True, exist_ok=True)
    if metric == "l2":  # search_and_save writes the reference's file name
        metric = "euclidean"
    evaluation = CathEvaluation.from_data_dir(cath_data, domain_list)
    hits_per_method = dict(np.load(cath_data / f"hits_{metric}.npz"))
    scores_per_method = dict(np.load(cath_data / f"scores_{metric}.npz"))

    # correctness tensors are the expensive part — compute once per method
    correct_per_method = {
        name: evaluation.compute_is_correct(hits)
        for name, hits in hits_per_method.items()
    }
    records = evaluation.accuracy_table(
        hits_per_method, bootstrap=bootstrap,
        correct_per_method=correct_per_method,
    )
    (figures_dir / "accuracies.md").write_text(
        evaluation.format_table(records) + "\n"
    )
    report = {"accuracies": records}

    report["per_level"] = {
        name: evaluation.per_level_accuracy(correct)
        for name, correct in correct_per_method.items()
    }

    best_name = records[0][0]
    best_correct = correct_per_method[best_name]
    best_scores = scores_per_method[best_name][:, 0]

    # per-CATH-class imbalance stats (reference: cath/cath.py:250-292)
    class_codes = evaluation.mapping_array[:, 3]
    report["class_imbalance"] = analysis.class_imbalance_table(
        class_codes,
        evaluation.is_possible,
        {name: c[:, 0, 0] for name, c in correct_per_method.items()},
    )

    # superfamily-size vs accuracy scatter (reference: cath/cath.py:296-326):
    # per-family accuracy points for the best method (+ MMseqs2 below)
    fams = evaluation.mapping_array[:, 0]
    top1 = best_correct[:, 0, 0]
    sizes = np.asarray([evaluation.family_sizes[0][f] for f in fams])
    save_raw(
        figures_dir, "superfamily-vs-accuracy-data",
        family_size=sizes, correct=top1.astype(np.float64),
    )

    def family_points(correct_top1: np.ndarray):
        """Per-superfamily (size, accuracy) points."""
        fam_correct: Dict = {}
        for fam, c in zip(fams, correct_top1):
            fam_correct[fam] = fam_correct.get(fam, 0) + int(c)
        keys = sorted(fam_correct)
        f_sizes = np.asarray([evaluation.family_sizes[0][f] for f in keys])
        f_acc = np.asarray([fam_correct[f] for f in keys]) / f_sizes
        return f_sizes, f_acc, keys

    # length analysis when the fasta is present
    lengths = None
    fasta = cath_data / "cath-20.fasta"
    if fasta.exists():
        from ..data.fasta import read_fasta

        seqs = read_fasta(fasta, lambda h: h.split("|")[2].split("/")[0])
        lengths = np.asarray(
            [len(seqs.get(i, "")) for i in evaluation.ids]
        )
        la = analysis.length_analysis(
            lengths[evaluation.is_possible], top1[evaluation.is_possible]
        )
        save_raw(figures_dir, "length-vs-accuracy-data", **la)
        report["length_analysis"] = True

    if mmseqs_results is None:
        if render:
            s, a, _ = family_points(top1)
            R.figure_superfamily_vs_accuracy(
                figures_dir, {best_name: (s, a)}
            )
            if lengths is not None:
                poss = evaluation.is_possible
                R.figure_length_vs_accuracy(
                    figures_dir, lengths[poss],
                    {n: c[poss, 0, 0] for n, c in correct_per_method.items()},
                )
                R.figure_length_binned(
                    figures_dir, lengths[poss],
                    {n: c[poss, 0, 0] for n, c in correct_per_method.items()},
                )
                R.figure_length_binned_even(
                    figures_dir, lengths[poss],
                    {n: c[poss, 0, 0] for n, c in correct_per_method.items()},
                )
        return report

    mm_correct = mmseqs_results["is_correct_top1"]
    e_values = mmseqs_results["e_values_top1"]
    poss = evaluation.is_possible
    report["confusion"] = analysis.confusion_counts(
        top1[poss], mm_correct[poss]
    ).tolist()
    cutoffs, simple, combined = analysis.cath_evalue_sweep(
        e_values, mm_correct, top1, poss
    )
    save_raw(
        figures_dir, "combining-mmseqs-and-knn-raw-data",
        cutoffs=cutoffs, simple=simple, combined=combined,
    )
    cutoffs_n, simple_n, combined_n = analysis.cath_evalue_sweep(
        e_values, mm_correct, top1, poss,
        normalization=evaluation.normalization,
        families_count=evaluation.families_count,
    )
    # annotation order: best first — descending similarity for cosine,
    # ascending squared distance for euclidean
    sort_key = best_scores if metric == "euclidean" else -best_scores
    x, y = analysis.coverage_accuracy(top1[poss], sort_key[poss])
    save_raw(figures_dir, "coverage-vs-accuracy-data", x=x, y=y)
    if metric == "cosine":  # the reference's correlation is cosine↔E
        report["correlation"] = analysis.score_evalue_correlation(
            best_scores[poss], e_values[poss]
        )

    if render:
        # the 9 CATH endfig families (reference: cath/cath.py:326-947)
        s_best, a_best, keys = family_points(top1)
        s_mm, a_mm, _ = family_points(mm_correct)
        R.figure_superfamily_vs_accuracy(
            figures_dir, {best_name: (s_best, a_best), "MMseqs2": (s_mm, a_mm)}
        )
        R.figure_superfamily_vs_delta(
            figures_dir, s_best, a_best - a_mm, best_name
        )
        R.figure_accuracy_combined(
            figures_dir, cutoffs, simple, combined,
            knn_level=float(top1[poss].mean()),
            mmseqs_level=float(mm_correct[poss].mean()),
            name="combining-mmseqs-and-knn-raw",
            y_label="QrawTop1", best_label=best_name,
        )
        R.figure_accuracy_combined(
            figures_dir, cutoffs_n, simple_n, combined_n,
            knn_level=float(
                (top1 * evaluation.normalization).sum()
                / evaluation.families_count
            ),
            mmseqs_level=float(
                (mm_correct * evaluation.normalization).sum()
                / evaluation.families_count
            ),
            name="combining-mmseqs-and-knn-normalized",
            y_label="QnormTop1", best_label=best_name,
        )
        mm_x, mm_y = analysis.coverage_accuracy(
            mm_correct[poss], e_values[poss]
        )
        R.figure_coverage_vs_accuracy(
            figures_dir,
            {best_name: (x, y), "MMseqs2": (mm_x, mm_y)},
            diagonal=True,
        )
        if lengths is not None:
            length_methods = {
                n: c[poss, 0, 0] for n, c in correct_per_method.items()
            }
            length_methods["MMseqs2"] = mm_correct[poss]
            R.figure_length_vs_accuracy(
                figures_dir, lengths[poss], length_methods
            )
            R.figure_length_binned(
                figures_dir, lengths[poss], length_methods
            )
            R.figure_length_binned_even(
                figures_dir, lengths[poss], length_methods
            )
        if metric == "cosine":
            R.figure_evalue_vs_score_scatter(
                figures_dir, best_scores[poss], e_values[poss]
            )
    return report


def main(argv=None):
    """CLI parity with `python -m cath.search` (reference: cath/search.py:56-57)."""
    import argparse

    from ..utils.logging import configure_logging

    configure_logging()
    parser = argparse.ArgumentParser()
    parser.add_argument("--data", type=Path, default=Path("cath/data"))
    parser.add_argument("--hits", type=int, default=CATH_HITS)
    parser.add_argument("--device", default="cuda",
                        help="cuda (default) or cpu")
    args = parser.parse_args(argv)
    search_and_save(args.data, args.hits, device=args.device)


if __name__ == "__main__":
    main()
