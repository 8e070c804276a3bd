"""kNN hits rescored by Smith-Waterman alignment — the native replacement
of `mmseqs align` (port of knn_for_homology_tpu/search/rescore.py).

The reference's hybrid configuration takes the kNN hit lists and re-scores
each (query, hit) pair with gapped-alignment E-values
(reference: seqvec_search/main.py:146-151 → mmseqs/_align.py).
"""

import time
from typing import Dict, List, Tuple

import numpy as np

from ..config import E_VALUE_CUTOFF
from ..data.dataset import Dataset
from ..data.fasta import read_fasta
from ..ops.align import align_hits


def align_evalues_row_aligned(
    dataset: Dataset, hit_rows: np.ndarray, device="cuda"
) -> np.ndarray:
    """[Q, k] alignment E-values aligned with hit_rows' column order
    (missing hits get +inf)."""
    train_seqs = read_fasta(dataset.train_sequences)
    test_seqs = read_fasta(dataset.test_sequences)
    db_residues = float(sum(len(s) for s in train_seqs.values()))
    hit_rows = np.asarray(hit_rows)
    q_n, k = hit_rows.shape
    queries = [test_seqs[dataset.test_ids[qi]] for qi in range(q_n)]
    hits = [
        [train_seqs[dataset.train_ids[h]] for h in row if h >= 0]
        for row in hit_rows
    ]
    _, evs = align_hits(queries, hits, db_residues=db_residues, device=device)
    out = np.full((q_n, k), np.inf, dtype=np.float64)
    for qi, row in enumerate(hit_rows):
        cols = [c for c, h in enumerate(row) if h >= 0]
        out[qi, cols] = evs[qi]
    return out


def align_rescore(
    dataset: Dataset,
    hit_rows: np.ndarray,
    e_value_cutoff: float = E_VALUE_CUTOFF,
    device="cuda",
) -> Tuple[Dict[str, List[str]], Dict[str, np.ndarray], float]:
    """Re-score kNN hits with gapped alignment; order hits by E-value.

    hit_rows [Q, k] — train-set row indices (-1 = missing). Returns (hits:
    query id → hit ids by ascending E-value (ties keep kNN order), e_values
    per query, wall seconds); hits above the cutoff are dropped like
    `mmseqs align -e` does."""
    start = time.time()
    train_seqs = read_fasta(dataset.train_sequences)
    test_seqs = read_fasta(dataset.test_sequences)
    db_residues = float(sum(len(s) for s in train_seqs.values()))

    hit_rows = np.asarray(hit_rows)
    queries = [
        test_seqs[dataset.test_ids[qi]] for qi in range(hit_rows.shape[0])
    ]
    row_hits = [[int(h) for h in row if h >= 0] for row in hit_rows]
    target_seqs = [
        [train_seqs[dataset.train_ids[h]] for h in row] for row in row_hits
    ]
    _, evs_rows = align_hits(
        queries, target_seqs, db_residues=db_residues, device=device
    )

    hits: Dict[str, List[str]] = {}
    e_values: Dict[str, np.ndarray] = {}
    for qi in range(len(dataset.test_ids)):
        evs = evs_rows[qi] if qi < len(evs_rows) else np.zeros(0, np.float32)
        if evs.shape[0] == 0:
            hits[dataset.test_ids[qi]] = []
            e_values[dataset.test_ids[qi]] = np.zeros(0, np.float32)
            continue
        order = np.argsort(evs, kind="stable")
        keep = order[evs[order] <= e_value_cutoff]
        hits[dataset.test_ids[qi]] = [
            dataset.train_ids[row_hits[qi][p]] for p in keep
        ]
        e_values[dataset.test_ids[qi]] = evs[keep]
    return hits, e_values, time.time() - start
