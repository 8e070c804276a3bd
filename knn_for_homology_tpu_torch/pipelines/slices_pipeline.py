"""Slices pipeline — long multi-domain proteins as overlapping windows; port
of knn_for_homology_tpu/pipelines/slices_pipeline.py.

Parity with the reference (reference: pfam/slices/): slice → embed → flat
all-vs-all search → per-slice evaluation with matching/intersecting-domain
distinction → assembly of per-slice hit lists into per-protein rankings →
full-protein vs assembled comparison (reference: pfam/slices/slices.py).
The search runs on an explicit device, "cuda" unless the caller asks for
the CPU.
"""

import logging
from pathlib import Path
from typing import Dict, List, Optional, Set, Tuple

import numpy as np

from ..data.slices import slice_id_to_protein
from ..eval import analysis
from ..search.flat import FlatIndex

logger = logging.getLogger(__name__)


def search_slices(
    slice_embeddings: np.ndarray, k: int = 1000, device="cuda"
) -> Tuple[np.ndarray, np.ndarray]:
    """Flat all-vs-all over slice vectors with self-hit stripping
    (reference: pfam/slices/slices_search.py:14-31 — 2540 s single-core
    there; one fused search here)."""
    index = FlatIndex(metric="cosine", device=device).add(
        np.asarray(slice_embeddings, dtype=np.float32)
    )
    ids, scores = index.search_self(min(k, index.ntotal - 1))
    return ids, scores


def slice_domains(
    slice_id: str,
    protein_to_domain: Dict[str, List],
    slice_len: int = 600,
) -> Tuple[Set[str], Set[str]]:
    """(matching, intersecting) domain families of a slice: matching =
    domain fully inside the window, intersecting = any overlap
    (reference: pfam/slices/slices.py:49-68)."""
    protein, start = slice_id_to_protein(slice_id)
    end = start + slice_len
    matching, intersecting = set(), set()
    for family, (d_start, d_stop) in protein_to_domain.get(protein, []):
        if d_start >= start and d_stop <= end:
            matching.add(family)
        if d_start < end and d_stop > start:
            intersecting.add(family)
    return matching, intersecting


def evaluate_slice_hits(
    slice_ids: List[str],
    hits: np.ndarray,
    protein_to_domain: Dict[str, List],
    homologous: Dict[str, Set[str]],
    slice_len: int = 600,
) -> Dict[str, float]:
    """Per-slice AUC1 where a hit counts if the hit slice's protein is a
    homolog; slices with no fully-contained domain are ignored
    (reference: pfam/slices/slices.py:101-142)."""
    auc1s = []
    for qi, row in enumerate(np.asarray(hits)):
        matching, _ = slice_domains(slice_ids[qi], protein_to_domain, slice_len)
        if not matching:
            continue  # ignore set: no domain fully inside this window
        protein, _ = slice_id_to_protein(slice_ids[qi])
        truth = homologous.get(protein, set())
        denom = max(len(truth), 1)
        auc1 = 0
        seen: Set[str] = set()
        for hit in row:
            if hit < 0:
                break
            hit_protein, _ = slice_id_to_protein(slice_ids[int(hit)])
            if hit_protein == protein or hit_protein in seen:
                continue
            seen.add(hit_protein)
            if hit_protein in truth:
                auc1 += 1
            else:
                break
        auc1s.append(min(auc1, denom) / denom)
    return {"slice_auc1": float(np.mean(auc1s)), "n_evaluated": len(auc1s)}


def mmseqs_slice_baseline(
    slices_fasta: Path,
    full_sequences_fasta: Path,
    work_dir: Path,
    sensitivity: float = 7.5,
) -> Dict[str, float]:
    """MMseqs2 search of slices against full sequences — the classical
    baseline of the slices study (reference: pfam/slices/slices.py:196-205;
    980 s there). Gated on the binary (or the fake in tests)."""
    import json

    from ..data.dataset import Dataset
    from ..data.fasta import iter_fasta
    from .. import interop

    work_dir = Path(work_dir)
    work_dir.mkdir(parents=True, exist_ok=True)
    # adapt to the Dataset contract: slices = queries, full sequences = db
    for split, fasta in [("test", slices_fasta), ("train", full_sequences_fasta)]:
        ids = []
        with open(work_dir / f"{split}.fasta", "w") as out:
            for header, seq in iter_fasta(Path(fasta)):
                ids.append(header)
                out.write(f">{header}\n{seq}\n")
        (work_dir / f"{split}.json").write_text(json.dumps(ids))
    (work_dir / "ids_to_family.json").write_text("{}")
    np.save(work_dir / "train.npy", np.zeros((1, 1), np.float32))
    np.save(work_dir / "test.npy", np.zeros((1, 1), np.float32))
    data = Dataset.from_dir(work_dir)
    seconds = interop.search(data, sensitivity=sensitivity)
    hits, evs = interop.read_result_db_with_e_value(
        data.train_ids, data.mmseqs_train, data.test_ids, data.mmseqs_test,
        data.mmseqs_dir / "result_mmseqs2",
    )
    return {
        "search_seconds": seconds,
        "n_queries_with_hits": sum(1 for h in hits.values() if len(h)),
        "hits": hits,
        "e_values": evs,
    }


def run(
    full_sequences_fasta: Path,
    slice_embeddings_npy: Path,
    slice_ids: List[str],
    protein_to_domain: Dict[str, List],
    homologous: Dict[str, Set[str]],
    out_dir: Optional[Path] = None,
    k: int = 1000,
    device="cuda",
) -> Dict[str, float]:
    hits, scores = search_slices(np.load(slice_embeddings_npy), k, device)
    metrics = evaluate_slice_hits(
        slice_ids, hits, protein_to_domain, homologous
    )
    # assembly back to protein-level ranking
    slice_proteins = [slice_id_to_protein(s)[0] for s in slice_ids]
    proteins, is_correct, auc1s = analysis.assemble_slices(
        hits, scores, slice_proteins, homologous
    )
    metrics["assembled_auc1"] = float(np.mean(auc1s))
    if out_dir is not None:
        from ..eval.figures import save_raw

        save_raw(
            out_dir,
            "slices-assembled",
            proteins=np.asarray(proteins),
            auc1s=auc1s,
        )
    return metrics
