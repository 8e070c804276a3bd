"""Analysis routines behind the paper figures — vectorised where the
reference loops.

Each function mirrors a specific reference analysis (cited per function);
pipelines compose these over dataset directories and dump raw npz next to
every figure so plots regenerate without recompute (the reference's
contract, e.g. cath/cath.py:317).
"""

from collections import Counter
from typing import Dict, List, Sequence, Set, Tuple

import numpy as np


def confusion_counts(
    correct_a: np.ndarray, correct_b: np.ndarray
) -> np.ndarray:
    """2×2 confusion of two methods' top-1 correctness
    (reference: cath/cath.py:335-343): rows = B correct/wrong,
    cols = A correct/wrong."""
    a = np.asarray(correct_a, bool)
    b = np.asarray(correct_b, bool)
    return np.asarray(
        [
            [(a & b).sum(), (~a & b).sum()],
            [(a & ~b).sum(), (~a & ~b).sum()],
        ]
    )


def top1_cutoff_sweep(
    top_e_values: np.ndarray,
    mmseqs_top1_correct: np.ndarray,
    knn_top1_correct: np.ndarray,
) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Pfam-style combined-accuracy sweep over every possible E-value cutoff
    (reference: pfam/pfam.py:166-199): below the cutoff take MMseqs2's top
    hit, above it the kNN top hit. Vectorised to two cumsums. Returns
    (e_sorted, combined_accuracy, mmseqs_with_cutoff_accuracy)."""
    order = np.argsort(top_e_values, kind="stable")
    mm = np.asarray(mmseqs_top1_correct, dtype=np.float64)[order]
    knn = np.asarray(knn_top1_correct, dtype=np.float64)[order]
    n = len(order)
    combined = np.cumsum(mm) + np.cumsum(knn[::-1])[::-1]
    return (
        np.asarray(top_e_values)[order],
        combined / n,
        np.cumsum(mm) / n,
    )


def cath_evalue_sweep(
    e_values: np.ndarray,  # [Q] top-hit E-values (∞/sentinel when no hit)
    correct_mmseqs: np.ndarray,  # [Q] top-1 correctness
    correct_knn: np.ndarray,  # [Q]
    possible: np.ndarray,  # [Q] bool
    cutoffs: np.ndarray = None,
    normalization: np.ndarray = None,
    families_count: int = None,
) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """CATH merge sweep over logspace cutoffs
    (reference: cath/cath.py:625-718): combined(c) = MMseqs2 top-1 where
    E<c else kNN top-1. Returns (cutoffs, simple, combined); normalised
    variant when normalization/families_count given."""
    if cutoffs is None:
        cutoffs = np.logspace(-10, 2, 50)
    ev = np.asarray(e_values)[None, :]  # [1, Q]
    cut = np.asarray(cutoffs)[:, None]  # [C, 1]
    mm = np.asarray(correct_mmseqs, bool)[None, :]
    knn = np.asarray(correct_knn, bool)[None, :]
    simple_mask = (ev < cut) & mm
    combined_mask = simple_mask | ((ev > cut) & knn)
    if normalization is not None:
        w = np.asarray(normalization)[None, :]
        simple = (simple_mask * w).sum(axis=1) / families_count
        combined = (combined_mask * w).sum(axis=1) / families_count
    else:
        simple = simple_mask[:, possible].mean(axis=1)
        combined = combined_mask[:, possible].mean(axis=1)
    return np.asarray(cutoffs), simple, combined


def bootstrap_top1(
    is_correct: np.ndarray,
    families: np.ndarray,
    normalized_point: float,
    n_rounds: int = 500,
    seed: int = 42,
) -> Tuple[float, float]:
    """500× bootstrap ±CI half-widths for (QnormTop1, QrawTop1)
    (reference: cath/cath.py:404-438): resample queries, recompute the
    family-size normalisation inside each resample."""
    rng = np.random.default_rng(seed)
    is_correct = np.asarray(is_correct, dtype=np.float64)
    families = np.asarray(families)
    boot_norm, boot_raw = [], []
    for _ in range(n_rounds):
        sample = rng.choice(len(is_correct), len(is_correct))
        fams = families[sample]
        counts = Counter(fams.tolist())
        weights = np.asarray([1.0 / counts[f] for f in fams.tolist()])
        boot_norm.append((is_correct[sample] * weights).sum() / len(counts))
        boot_raw.append(is_correct[sample].mean())
    boot_norm = np.sort(boot_norm)
    boot_raw = np.sort(boot_raw)
    lo_n = boot_norm[int(n_rounds * 0.025)]
    hi_n = boot_norm[int(n_rounds * 0.975)]
    lo_r = boot_raw[int(n_rounds * 0.025)]
    hi_r = boot_raw[int(n_rounds * 0.975)]
    raw_point = is_correct.mean()
    return (
        max(normalized_point - lo_n, hi_n - normalized_point),
        max(raw_point - lo_r, hi_r - raw_point),
    )


def merged_auc1(
    hits_a: Sequence[np.ndarray],
    evs_a: Sequence[np.ndarray],
    hits_b: Sequence[np.ndarray],
    evs_b: Sequence[np.ndarray],
    train_codes: np.ndarray,
    query_codes: np.ndarray,
    family_sizes: np.ndarray,
) -> np.ndarray:
    """Merge two ranked hit lists per query by ascending E-value, dedup,
    AUC1 of the merged list (reference: pfam/proteins.py:629-667)."""
    auc1s = []
    for qi in range(len(query_codes)):
        a_h, a_e = hits_a[qi], evs_a[qi]
        b_h, b_e = hits_b[qi], evs_b[qi]
        i = j = auc1 = 0
        picked: Set[int] = set()
        correct = query_codes[qi]
        while i < len(a_h) or j < len(b_h):
            if j == len(b_h) or (i < len(a_h) and a_e[i] <= b_e[j]):
                chosen = int(a_h[i])
                i += 1
            else:
                chosen = int(b_h[j])
                j += 1
            if chosen in picked:
                continue
            picked.add(chosen)
            if train_codes[chosen] == correct:
                auc1 += 1
            else:
                break
        auc1s.append(auc1 / family_sizes[correct])
    return np.asarray(auc1s)


def merge_ranked_rows(
    hits_a: Sequence[np.ndarray],
    evs_a: Sequence[np.ndarray],
    hits_b: Sequence[np.ndarray],
    evs_b: Sequence[np.ndarray],
    k: int,
) -> np.ndarray:
    """The merged ranking itself (same two-pointer ascending-E merge with
    dedup as merged_auc1) as padded [Q, k] hit rows, -1 beyond the merged
    length — so TP@k / cumulative-TP of the *combined* method can be
    computed with the standard row evaluators
    (reference: pfam/pfam.py:456-459 "combined" result line)."""
    out = np.full((len(hits_a), k), -1, dtype=np.int64)
    for qi in range(len(hits_a)):
        a_h, a_e = hits_a[qi], evs_a[qi]
        b_h, b_e = hits_b[qi], evs_b[qi]
        i = j = pos = 0
        picked: Set[int] = set()
        while pos < k and (i < len(a_h) or j < len(b_h)):
            if j == len(b_h) or (i < len(a_h) and a_e[i] <= b_e[j]):
                chosen = int(a_h[i])
                i += 1
            else:
                chosen = int(b_h[j])
                j += 1
            if chosen in picked or chosen < 0:
                continue
            picked.add(chosen)
            out[qi, pos] = chosen
            pos += 1
    return out


def remove_self_hit_lossy(
    hits: np.ndarray, scores: np.ndarray, self_ids: np.ndarray
) -> Tuple[np.ndarray, np.ndarray, int]:
    """Self-hit stripping tolerant of lossy ANN (the self hit may not be
    ranked first, or missing entirely) — reference: pfam/proteins.py:85-122.
    Rotates the self hit (or the last hit when absent) to the front, then
    drops column 0. Returns (hits, scores, n_missing_self)."""
    hits = np.array(hits, copy=True)
    scores = np.array(scores, copy=True)
    self_ids = np.asarray(self_ids)
    misplaced = np.nonzero(hits[:, 0] != self_ids)[0]
    bogus = 0
    for row in misplaced:
        matches = np.nonzero(hits[row] == self_ids[row])[0]
        if len(matches):
            index = int(matches[0])
        else:
            index = hits.shape[1] - 1
            bogus += 1
        hits[row, 0], hits[row, 1 : index + 1] = (
            hits[row, index].copy(),
            hits[row, 0:index].copy(),
        )
        scores[row, 0], scores[row, 1 : index + 1] = (
            scores[row, index].copy(),
            scores[row, 0:index].copy(),
        )
    return hits[:, 1:], scores[:, 1:], bogus


def assemble_slices(
    slice_hits: np.ndarray,  # [S, k] rows into the slice set
    slice_scores: np.ndarray,  # [S, k] descending scores
    slice_proteins: List[str],  # protein of each slice row
    homologous: Dict[str, Set[str]],
) -> Tuple[List[str], np.ndarray, np.ndarray]:
    """Merge per-slice hit lists back to per-protein rankings
    (reference: pfam/slices/slices.py:257-305): flatten all slices' hits,
    sort by score, dedup hit proteins, truncate/pad to k. Returns
    (proteins, is_correct [P, k], auc1 [P])."""
    k = slice_hits.shape[1]
    per_protein: Dict[str, List[int]] = {}
    for row, protein in enumerate(slice_proteins):
        per_protein.setdefault(protein, []).append(row)
    proteins, correct_rows, auc1s = [], [], []
    for protein, rows in per_protein.items():
        flat_hits = slice_hits[rows].ravel()
        flat_scores = slice_scores[rows].ravel()
        ranked = flat_hits[np.argsort(-flat_scores, kind="stable")]
        all_correct = homologous.get(protein, set())
        picked: Set[str] = set()
        is_correct: List[bool] = []
        for hit in ranked[:k]:
            if hit < 0:  # FAISS-style missing-hit padding
                continue
            hit_protein = slice_proteins[int(hit)]
            if hit_protein in picked:
                continue
            picked.add(hit_protein)
            is_correct.append(hit_protein in all_correct)
        is_correct += [False] * (k - len(is_correct))
        proteins.append(protein)
        correct_rows.append(is_correct)
        flags = np.asarray(is_correct)
        leading = int(np.argmin(flags)) if not flags.all() else len(flags)
        auc1s.append(leading / max(len(all_correct), 1))
    return proteins, np.asarray(correct_rows), np.asarray(auc1s)


def coverage_accuracy(
    correct: np.ndarray, sort_key: np.ndarray
) -> Tuple[np.ndarray, np.ndarray]:
    """Cumulative correct fraction when annotating queries in sort_key
    order (reference: cath/cath.py:722-785). Returns (x 0..1, y)."""
    order = np.argsort(sort_key, kind="stable")
    flags = np.asarray(correct, dtype=np.float64)[order]
    y = np.cumsum(flags) / (len(flags) + 1)
    x = np.linspace(0, 1, len(flags))
    return x, y


def merged_coverage_curve(
    e_values: np.ndarray,  # [Q] MMseqs top-hit E-values
    knn_scores: np.ndarray,  # [Q] kNN top-hit similarities (higher better)
    correct_mmseqs: np.ndarray,
    correct_knn: np.ndarray,
    e_cutoff: float = 0.01,
) -> Tuple[np.ndarray, np.ndarray]:
    """Coverage curve of the merged method (reference: cath/cath.py:718-760):
    below the cutoff annotate with MMseqs2 ordered by log E, above it with
    kNN ordered by descending similarity; the log keeps every E-value score
    below every similarity score."""
    e_values = np.asarray(e_values, dtype=np.float64)
    combined_scores = np.log(np.maximum(e_values, 1e-300))
    use_knn = e_values > e_cutoff
    combined_scores[use_knn] = -np.asarray(knn_scores, dtype=np.float64)[use_knn]
    combined_correct = np.where(use_knn, correct_knn, correct_mmseqs)
    return coverage_accuracy(combined_correct, combined_scores)


def rolling_mean(data: np.ndarray, window_size: int) -> np.ndarray:
    """(reference: seqvec_search/utils.py:103-113)"""
    return np.convolve(
        np.asarray(data, dtype=np.float64),
        np.ones(window_size) / window_size,
        mode="valid",
    )


def length_analysis(
    lengths: np.ndarray,
    correct: np.ndarray,
    window: int = 1000,
    n_bins: int = 10,
) -> Dict[str, np.ndarray]:
    """Accuracy vs sequence length: rolling window over length-sorted
    queries + equal-count bins (reference: cath/cath.py:789-896)."""
    lengths = np.asarray(lengths)
    correct = np.asarray(correct, dtype=np.float64)
    order = np.argsort(lengths, kind="stable")
    sorted_lengths = lengths[order]
    sorted_correct = correct[order]
    window = min(window, len(correct))
    rolling = rolling_mean(sorted_correct, window)
    rolling_x = rolling_mean(sorted_lengths.astype(np.float64), window)
    bounds = np.linspace(0, len(correct), n_bins + 1, dtype=int)
    bin_acc = np.asarray(
        [sorted_correct[bounds[i] : bounds[i + 1]].mean() for i in range(n_bins)]
    )
    bin_len = np.asarray(
        [sorted_lengths[bounds[i] : bounds[i + 1]].mean() for i in range(n_bins)]
    )
    return {
        "rolling_length": rolling_x,
        "rolling_accuracy": rolling,
        "bin_length": bin_len,
        "bin_accuracy": bin_acc,
    }


def score_evalue_correlation(
    scores: np.ndarray, e_values: np.ndarray
) -> Dict[str, float]:
    """Pearson (on log E) + Spearman correlation between kNN scores and
    alignment E-values (reference: cath/cath.py:938-952)."""
    from scipy.stats import pearsonr, spearmanr

    # E-value 0 (mmseqs reports exact 0 for overwhelming hits) would warn
    # and produce -inf; clamp like merged_coverage_curve does
    logged = np.log(np.maximum(np.asarray(e_values, dtype=np.float64), 1e-300))
    pearson = pearsonr(scores, logged)
    spearman = spearmanr(scores, e_values)
    return {
        "pearson_r": float(pearson[0]),
        "pearson_p": float(pearson[1]),
        "spearman_r": float(spearman[0]),
        "spearman_p": float(spearman[1]),
    }


def score_calibration(
    scores: np.ndarray,
    correct: np.ndarray,
    smoothness: int = 20,
) -> Dict[str, np.ndarray]:
    """Score → accuracy calibration: bucket the similarity scores, report
    per-bucket mean correctness + SEM
    (reference: pfam/proteins.py:688-729 cosine_bucketed_accuracy)."""
    scores = np.asarray(scores).ravel()
    correct = np.asarray(correct, dtype=np.float64).ravel()
    edges = np.linspace(0, 1 - 1 / smoothness, smoothness)
    centers, precision, sems = [], [], []
    for lo in edges:
        mask = (lo < scores) & (scores <= lo + 1 / smoothness)
        if not mask.any():
            continue
        vals = correct[mask]
        centers.append(lo + 1 / (2 * smoothness))
        precision.append(vals.mean())
        sems.append(vals.std(ddof=1) / np.sqrt(len(vals)) if len(vals) > 1 else 0.0)
    return {
        "bucket_center": np.asarray(centers),
        "precision": np.asarray(precision),
        "sem": np.asarray(sems),
    }


def per_query_precision_recall(
    scores: np.ndarray,  # [Q, K] higher = better
    correct: np.ndarray,  # [Q, K] bool
    totals: np.ndarray,  # [Q] relevant count per query
    smoothness: int = 100,
) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Mean-per-query precision/recall over score-quantile thresholds
    (reference: pfam/proteins.py:605-652 — precision per query is 1.0 when
    nothing is selected; recall = tp / that query's relevant total).
    Returns (recall, precision, thresholds)."""
    scores = np.asarray(scores, dtype=np.float64)
    correct = np.asarray(correct, dtype=np.float64)
    totals = np.maximum(np.asarray(totals, dtype=np.float64), 1.0)
    thresholds = np.quantile(scores, np.linspace(0, 1, smoothness + 1))
    precision, recall = [], []
    for thr in thresholds:
        sel = scores > thr  # [Q, K]
        n_sel = sel.sum(axis=1)
        tp = (correct * sel).sum(axis=1)
        p = np.where(n_sel > 0, tp / np.maximum(n_sel, 1), 1.0)
        precision.append(p.mean())
        recall.append((tp / totals).mean())
    return np.asarray(recall), np.asarray(precision), thresholds


def hit_set_overlap(
    hits_a: Sequence[np.ndarray], hits_b: Sequence[np.ndarray]
) -> Dict[str, int]:
    """Per-query hit-set overlap totals: A-only / both / B-only — the
    UniRef90 case-study tables (reference:
    more_sensitive/uniref90-figures/uniref90-overlap.md, e.g. kNN-only 422 /
    both 1184 / MMseqs2-only 50598 at k=300)."""
    only_a = both = only_b = 0
    for a_row, b_row in zip(hits_a, hits_b):
        a = set(np.asarray(a_row).tolist()) - {-1}
        b = set(np.asarray(b_row).tolist()) - {-1}
        both += len(a & b)
        only_a += len(a - b)
        only_b += len(b - a)
    return {"only_a": only_a, "both": both, "only_b": only_b}


def class_imbalance_table(
    class_codes: np.ndarray,
    possible: np.ndarray,
    correct_per_method: Dict[str, np.ndarray],
) -> Dict[str, Dict[str, float]]:
    """Per-CATH-class counts + top-1 accuracy per method
    (reference: cath/cath.py:250-292). class_codes: the C-level code per
    query ('1'..'4'); correct arrays are top-1 H-level correctness."""
    out: Dict[str, Dict[str, float]] = {"counts": {}, "counts_possible": {}}
    class_codes = np.asarray(class_codes)
    for klass in sorted(set(class_codes.tolist())):
        mask = class_codes == klass
        out["counts"][klass] = int(mask.sum())
        out["counts_possible"][klass] = int((mask & possible).sum())
    for name, correct in correct_per_method.items():
        out[name] = {}
        for klass in out["counts"]:
            mask = (class_codes == klass) & possible
            out[name][klass] = (
                float(np.asarray(correct)[mask].mean()) if mask.any() else 0.0
            )
    return out
