"""UniRef90/CASP hit-overlap tables — the `uniref90-figures` computations.

The reference publishes two tables for the UniRef90 case study
(reference: more_sensitive/uniref90-figures/uniref90-overlap.md:1-5 and
uniref90-neff-hits.md) but keeps no generating script in the repo (the
experiment ran externally). This module implements the computations from
the tables' semantics so the case study is reproducible here:

  * `overlap_table` — for each kNN rank cutoff (300/1000/10000), the
    three-way split of found homolog pairs: found only by kNN's top-N,
    by both methods, or only by MMseqs2. Totals over all queries.
  * `neff_hits_table` — per CASP target: MSA Neff, the MMseqs2 hit
    count, and |top-N kNN hits ∩ MMseqs2 hits| per cutoff (how much of
    the profile-search signal pure embedding kNN recovers).

Both emit the reference's pandas.to_markdown pipe-table layout
(right-aligned numeric columns).
"""

from typing import Dict, Iterable, List, Sequence, Set

import numpy as np

DEFAULT_CUTOFFS = (300, 1000, 10000)


def _md_table(
    headers: Sequence[str], rows: List[Sequence], aligns: Sequence[str]
) -> str:
    """pandas.to_markdown-style pipe table; aligns: 'l' or 'r' per col."""
    cells = [[str(c) for c in row] for row in rows]
    widths = [
        max(len(h), *(len(r[i]) for r in cells)) if cells else len(h)
        for i, h in enumerate(headers)
    ]

    def fmt(row):
        out = []
        for c, w, a in zip(row, widths, aligns):
            out.append(c.rjust(w) if a == "r" else c.ljust(w))
        return "| " + " | ".join(out) + " |"

    sep = "|" + "|".join(
        ("-" * (w + 1) + ":") if a == "r" else (":" + "-" * (w + 1))
        for w, a in zip(widths, aligns)
    ) + "|"
    return "\n".join([fmt(headers), sep] + [fmt(r) for r in cells])


def overlap_counts(
    knn_hits: Dict[str, Sequence],
    mmseqs_hits: Dict[str, Iterable],
    cutoffs: Sequence[int] = DEFAULT_CUTOFFS,
) -> List[dict]:
    """Three-way split per rank cutoff, summed over queries.

    knn_hits: query -> rank-ordered hit ids; mmseqs_hits: query -> hit id
    collection (order irrelevant)."""
    out = []
    for n in cutoffs:
        knn_only = both = mm_only = 0
        for query, ranked in knn_hits.items():
            mm: Set = set(mmseqs_hits.get(query, ()))
            top = set(h for h in list(ranked)[:n] if h is not None)
            top.discard(-1)
            inter = len(top & mm)
            both += inter
            knn_only += len(top) - inter
            mm_only += len(mm) - inter
        out.append(
            {"hits": n, "knn_only": knn_only, "both": both, "mm_only": mm_only}
        )
    return out


def overlap_table(
    knn_hits: Dict[str, Sequence],
    mmseqs_hits: Dict[str, Iterable],
    cutoffs: Sequence[int] = DEFAULT_CUTOFFS,
) -> str:
    """reference: more_sensitive/uniref90-figures/uniref90-overlap.md."""
    counts = overlap_counts(knn_hits, mmseqs_hits, cutoffs)
    rows = [
        (c["hits"], c["knn_only"], c["both"], c["mm_only"]) for c in counts
    ]
    return _md_table(
        ["hits", "k-nn only", "both", "MMseqs2 only"], rows, "rrrr"
    )


def neff_hits_table(
    targets: Sequence[str],
    neff: Dict[str, float],
    knn_hits: Dict[str, Sequence],
    mmseqs_hits: Dict[str, Iterable],
    cutoffs: Sequence[int] = DEFAULT_CUTOFFS,
) -> str:
    """reference: more_sensitive/uniref90-figures/uniref90-neff-hits.md:
    per target — MSA Neff, MMseqs2 hit count, |top-N kNN ∩ MMseqs2|."""
    rows = []
    for t in targets:
        mm = set(mmseqs_hits.get(t, ()))
        ranked = [h for h in list(knn_hits.get(t, ())) if h != -1]
        cells = [t, _fmt_neff(neff.get(t, float("nan"))), len(mm)]
        for n in cutoffs:
            cells.append(len(set(ranked[:n]) & mm))
        rows.append(cells)
    headers = ["", "MSA neff", "MMseqs2"] + [f"k-nn {n}" for n in cutoffs]
    return _md_table(headers, rows, "l" + "r" * (len(headers) - 1))


def _fmt_neff(x: float) -> str:
    if np.isnan(x):
        return "nan"
    return f"{x:g}"
