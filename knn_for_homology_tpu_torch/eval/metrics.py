"""Vectorised evaluation metrics.

Replaces the reference's O(queries × hits) pure-Python loops
(reference: seqvec_search/main.py:64-82, seqvec_search/tp_cumulative.py:15-34,
cath/cath.py:76-114) with array programs. Counting runs as int ops (device
or host); final divisions happen in float64 on the host so golden means such
as 0.871 / 0.91 (reference: tests/test_main.py:26-27) reproduce exactly.

Semantics contract:
  AUC1(q) = (# correct hits before the first wrong hit) / |family(q) in train|
  TP(q)   = (# correct hits anywhere in the list)        / |family(q) in train|
(reference: seqvec_search/main.py:64-82). Padded entries (hit id -1) are
treated as wrong, which matches the ragged reference lists: padding only
occurs after the real hits, so leading-run and total counts are unchanged.
"""

from typing import Dict, Iterable, List, Tuple

import numpy as np

from ..data.dataset import Dataset


def hit_family_codes(hit_rows: np.ndarray, train_codes: np.ndarray) -> np.ndarray:
    """Map hit row-indices into the train set → family codes; -1 stays -1."""
    hit_rows = np.asarray(hit_rows)
    codes = train_codes[np.clip(hit_rows, 0, len(train_codes) - 1)]
    return np.where(hit_rows < 0, -1, codes)


def correctness_matrix(
    query_codes: np.ndarray, hit_codes: np.ndarray
) -> np.ndarray:
    """[Q, k] bool: does hit j of query i share the query's family?"""
    return hit_codes == np.asarray(query_codes)[:, None]


def auc1_tp_counts(correct: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
    """Leading-run length and total count per query, as int64 [Q]."""
    correct = np.asarray(correct, dtype=bool)
    leading = np.cumprod(correct, axis=1)  # 1 until the first wrong hit
    return leading.sum(axis=1), correct.sum(axis=1)


def evaluate_rows(
    dataset: Dataset, hit_rows: np.ndarray
) -> Tuple[List[float], List[float]]:
    """AUC1/TP per query from integer hit rows (train-set row indices).

    Drop-in for the reference's ``evaluate_faiss``
    (reference: seqvec_search/main.py:53-61) without the string round-trip.
    """
    hit_codes = hit_family_codes(hit_rows, dataset.train_family_codes)
    correct = correctness_matrix(dataset.test_family_codes, hit_codes)
    auc1_n, tp_n = auc1_tp_counts(correct)
    sizes = dataset.train_family_sizes[dataset.test_family_codes].astype(np.float64)
    return (auc1_n / sizes).tolist(), (tp_n / sizes).tolist()


def evaluate_string_results(
    dataset: Dataset, results: Iterable[Tuple[str, Iterable[str]]]
) -> Tuple[List[float], List[float]]:
    """AUC1/TP from (query id, [hit ids]) pairs — ragged string-land input,
    mirroring the reference's ``evaluate`` (reference: seqvec_search/main.py:64-82).
    Used for alignment/MMseqs2 result lists whose hit counts vary per query.
    """
    fam = dataset.ids_to_family
    sizes: Dict[str, int] = {}
    for i in dataset.train_ids:
        sizes[fam[i]] = sizes.get(fam[i], 0) + 1
    auc1s, tps = [], []
    for name, matches in results:
        correct_family = fam[name]
        flags = np.fromiter(
            (fam[m] == correct_family for m in matches), dtype=bool
        )
        tp = int(flags.sum())
        auc1 = int(np.argmin(flags)) if not flags.all() else len(flags)
        auc1s.append(auc1 / sizes[correct_family])
        tps.append(tp / sizes[correct_family])
    return auc1s, tps


def tp_cumulative(dataset: Dataset, hit_rows: np.ndarray) -> np.ndarray:
    """Mean cumulative TP-fraction per rank, [k] float64
    (reference: seqvec_search/tp_cumulative.py:15-34)."""
    hit_codes = hit_family_codes(hit_rows, dataset.train_family_codes)
    correct = correctness_matrix(dataset.test_family_codes, hit_codes)
    sizes = dataset.train_family_sizes[dataset.test_family_codes].astype(np.float64)
    return (np.cumsum(correct, axis=1) / sizes[:, None]).mean(axis=0)


def top1_accuracy(
    correct_top1: np.ndarray,
    possible: np.ndarray,
    normalization: np.ndarray,
    families_count: int,
) -> Tuple[float, float]:
    """CATH-style QrawTop1 / QnormTop1 (reference: cath/cath.py:76-114).

    correct_top1 [Q] — first non-self hit matches at the judged level
    possible     [Q] — query's family has >1 member (a hit exists at all)
    normalization[Q] — 1/|family| for possible queries, 0 otherwise
    families_count   — number of families with >1 member
    """
    raw = float(np.mean(correct_top1[possible]))
    norm = float(np.sum(correct_top1 * normalization) / families_count)
    return raw, norm


def recall_at(
    hit_rows: np.ndarray, relevant_counts: np.ndarray, correct: np.ndarray, k: int
) -> np.ndarray:
    """Recall@k per query: fraction of the query's relevant set found in the
    first k hits (reference: pfam/proteins.py AUC1 + recall@300 reporting)."""
    found = np.asarray(correct)[:, :k].sum(axis=1)
    return found / np.maximum(relevant_counts, 1)


def precision_recall_curve(
    scores: np.ndarray,
    correct: np.ndarray,
    higher_is_better: bool = True,
    total_relevant: float = None,
) -> Tuple[np.ndarray, np.ndarray]:
    """Micro-averaged PR curve over all (query, hit) pairs pooled and ranked
    by score (reference: pfam/pfam.py:561-598 figure semantics).

    `total_relevant` is the recall denominator; the reference uses ALL
    relevant pairs in the dataset (total_to_be_found = Q * family size,
    pfam/pfam.py:562) so curves of methods that miss hits do not reach
    recall 1. Defaults to the number of relevant pairs present in `correct`.
    """
    flat_scores = np.asarray(scores).ravel()
    flat_correct = np.asarray(correct).ravel().astype(np.float64)
    order = np.argsort(-flat_scores if higher_is_better else flat_scores)
    flags = flat_correct[order]
    tp_cum = np.cumsum(flags)
    precision = tp_cum / np.arange(1, len(flags) + 1)
    if total_relevant is None:
        total_relevant = flags.sum()
    recall = tp_cum / max(total_relevant, 1.0)
    return precision, recall
