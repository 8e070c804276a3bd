"""Pfam20 full-protein pipeline (multi-domain ground truth, k=1000); port
of knn_for_homology_tpu/pipelines/pfam_proteins.py.

Parity with the reference's full-sequence workload
(reference: pfam/proteins_search.py + pfam/proteins.py): index build over
full-sequence embeddings, all-vs-all k=1000 search with lossy-ANN self-hit
repair, homologous-protein ground truth via the shared-domain closure,
AUC1 + recall@300, merged rankings. The port builds the flat, the LSH
(2048 bits, as the reference's FAISS IndexLSH), the graph (search/graph.py,
the stand-in for the reference's FAISS-HNSW, the default; "hnsw" is its
alias on the command line) and the IVF index (search/ivf.py). The device
is explicit: "cuda" unless the caller asks for the CPU.

Usage: python -m knn_for_homology_tpu_torch.pipelines.pfam_proteins
       {flat|lsh|graph|hnsw|ivf} [--data DIR] [--npy full_sequences.npy]
       [--k 1000] [--device cuda|cpu]
"""

import logging
import time
from collections import defaultdict
from pathlib import Path
from typing import Dict, List, Optional, Set

import numpy as np

from ..data.pfam import get_homologous_proteins
from ..device import resolve_device
from ..eval import analysis
from ..search.flat import FlatIndex
from ..search.graph import GraphIndex
from ..search.io import read_index, write_index
from ..search.ivf import IVFIndex
from ..search.lsh import LSHIndex

logger = logging.getLogger(__name__)

INDEX_MODES = ("flat", "lsh", "graph", "ivf")


def build_and_search(
    embeddings: np.ndarray,
    index_mode: str,
    index_file: Optional[Path] = None,
    k: int = 1000,
    device="cuda",
) -> Dict:
    """Index build + all-vs-all search, with persistence + size report
    (reference: pfam/proteins_search.py:11-57). index_mode: flat | lsh |
    graph | ivf (graph: beam-search ANN with M=42 / ef=256 equivalents).
    LSH scores are Hamming distances, ascending (FAISS's convention)."""
    device = resolve_device(device)
    embeddings = np.asarray(embeddings, dtype=np.float32)
    if index_mode not in INDEX_MODES:
        raise ValueError(index_mode)
    start = time.time()
    if index_file is not None and Path(index_file).exists():
        index = read_index(index_file, device=device)
        build_seconds = 0.0
    else:
        if index_mode == "flat":
            index = FlatIndex(metric="cosine", device=device).add(embeddings)
        elif index_mode == "lsh":
            index = LSHIndex(
                embeddings.shape[1], nbits=2048, device=device
            ).add(embeddings)
        elif index_mode == "graph":
            index = GraphIndex(
                metric="cosine", degree=42, beam_width=256, device=device
            ).add(embeddings)
        else:
            index = IVFIndex(metric="cosine", nprobe=32, device=device).add(
                embeddings
            )
        build_seconds = time.time() - start
        if index_file is not None:
            write_index(index, index_file)
    start = time.time()
    scores, hits = index.search(embeddings, min(k, index.ntotal))
    search_seconds = time.time() - start
    logger.info(
        "%s: build %ds, search %ds", index_mode, build_seconds, search_seconds
    )
    return {
        "hits": hits,
        "scores": scores,
        "build_seconds": build_seconds,
        "search_seconds": search_seconds,
        "index_bytes": index_file.stat().st_size if index_file else None,
    }


def evaluate_protein_hits(
    hits: np.ndarray,
    protein_ids: List[str],
    homologous: Dict[str, Set[str]],
    recall_k: int = 300,
    return_flags: bool = False,
):
    """Protein-level AUC1 + recall@k with set-based ground truth
    (reference: pfam/proteins_shared.py:139-157: max(len,1) guards).
    With return_flags the per-hit correctness matrix comes back too.
    A hit is correct when its protein's name is among the query's homologs;
    the names become row indices once, so each row is one sorted lookup."""
    rows_of = defaultdict(list)  # protein name -> its rows in protein_ids
    for i, name in enumerate(protein_ids):
        rows_of[name].append(i)
    auc1s, recalls, flag_rows = [], [], []
    for qi, row in enumerate(np.asarray(hits)):
        truth = homologous.get(protein_ids[qi], set())
        good = np.sort(np.asarray(
            [i for name in truth for i in rows_of.get(name, ())], np.int64
        ))
        if good.size:
            at = np.minimum(np.searchsorted(good, row), good.size - 1)
            flags = (row >= 0) & (good[at] == row)
        else:
            flags = np.zeros(row.shape, bool)
        denom = max(len(truth), 1)
        leading = int(np.argmin(flags)) if not flags.all() else len(flags)
        auc1s.append(min(leading, denom) / denom)
        recalls.append(flags[:recall_k].sum() / denom)
        flag_rows.append(flags)
    metrics = {
        "auc1": float(np.mean(auc1s)),
        f"recall@{recall_k}": float(np.mean(recalls)),
    }
    if return_flags:
        return metrics, np.asarray(flag_rows), np.asarray(auc1s)
    return metrics


def run(
    full_sequences_npy: Path,
    full_sequences_ids: List[str],
    protein_to_domain: Dict,
    index_mode: str = "graph",
    index_file: Optional[Path] = None,
    k: int = 1000,
    mmseqs_results: Optional[Dict] = None,
    knn_e_values: Optional[List[np.ndarray]] = None,
    figures_dir: Optional[Path] = None,
    sequence_lengths: Optional[np.ndarray] = None,
    device="cuda",
) -> Dict[str, float]:
    """Full-protein workload. `mmseqs_results` (optional):
    {"hits": [Q ragged arrays], "e_values": [...]} from the bridge —
    together with `knn_e_values` (real alignment E-values aligned with each
    hits row) unlocks the merged ranking + combined AUC1 (reference:
    pfam/proteins.py:213-240, 335-372) and the calibration/coverage figure
    data (reference: proteins.py:502-729). The index defaults to the graph,
    as in the reference."""
    embeddings = np.load(full_sequences_npy)
    result = build_and_search(embeddings, index_mode, index_file, k + 1,
                              device=device)
    # lossy-ANN self-hit repair (reference: pfam/proteins.py:85-122)
    hits, scores, bogus = analysis.remove_self_hit_lossy(
        result["hits"], result["scores"], np.arange(len(full_sequences_ids))
    )
    logger.info("%d missing self hits", bogus)
    homologous = get_homologous_proteins(protein_to_domain)
    metrics, correct, auc1s = evaluate_protein_hits(
        hits, full_sequences_ids, homologous, return_flags=True
    )
    metrics["build_seconds"] = result["build_seconds"]
    metrics["search_seconds"] = result["search_seconds"]
    auc1s_plot = {f"knn ({index_mode})": auc1s}
    if figures_dir is not None:
        from ..eval import render as R
        from ..eval.figures import save_raw

        # cosine-bucket score calibration (reference: proteins.py:688-729)
        calib = analysis.score_calibration(scores, correct)
        save_raw(figures_dir, "cosine_bucketed_accuracy-data", **calib)
        R.figure_cosine_bucketed_accuracy(
            figures_dir,
            bucket_centers=np.asarray(calib["bucket_center"]),
            precision=np.asarray(calib["precision"]),
            sem=np.asarray(calib["sem"]),
        )
        # accuracy-over-hits: mean fraction of each query's homologs found
        # by rank r (reference: proteins.py:502-519), over the query's
        # TOTAL homolog count
        totals = np.asarray(
            [max(len(homologous.get(q, ())), 1) for q in full_sequences_ids]
        )[:, None]
        over_hits = (correct.cumsum(axis=1) / totals).mean(axis=0)
        save_raw(
            figures_dir,
            "accuracy_over_hits-data",
            rank_accuracy=correct.mean(axis=0),
            fraction_found=over_hits,
        )
        R.figure_accuracy_over_hits(
            figures_dir, {f"knn ({index_mode})": over_hits[:300]}
        )

    if mmseqs_results is not None and knn_e_values is None:
        logger.warning(
            "merged ranking skipped: pass knn_e_values (row-aligned real "
            "alignment E-values) — the reference's merge (proteins.py:629-667)"
            " interleaves by actual E-values and pseudo-values would misorder"
            " against MMseqs2's"
        )
    if mmseqs_results is not None and knn_e_values is not None:
        # merged kNN+MMseqs ranking by E-value (reference: proteins.py:629-667);
        # knn_e_values[qi] aligns with hits[qi] row order — each side is
        # E-sorted before the two-pointer interleave
        merged_auc1s = []
        for qi, q in enumerate(full_sequences_ids):
            truth = homologous.get(q, set())
            denom = max(len(truth), 1)
            picked = set()
            auc1 = 0
            real = [int(h) for h in hits[qi] if h >= 0]
            evs_row = np.asarray(knn_e_values[qi])[: len(real)]
            order = np.argsort(evs_row, kind="stable")
            a_h = [real[o] for o in order]
            a_e = evs_row[order]
            b_h = [int(h) for h in mmseqs_results["hits"][qi]]
            b_e = np.asarray(mmseqs_results["e_values"][qi])
            i = j = 0
            while i < len(a_h) or j < len(b_h):
                if j == len(b_h) or (i < len(a_h) and a_e[i] <= b_e[j]):
                    chosen = a_h[i]
                    i += 1
                else:
                    chosen = b_h[j]
                    j += 1
                if chosen in picked:
                    continue
                picked.add(chosen)
                if full_sequences_ids[chosen] in truth:
                    auc1 += 1
                else:
                    break
            merged_auc1s.append(min(auc1, denom) / denom)
        metrics["merged_auc1"] = float(np.mean(merged_auc1s))
        auc1s_plot["MMseqs2 + knn merged"] = np.asarray(merged_auc1s)

    if figures_dir is not None:
        from ..eval import render as R

        # sorted per-query AUC1 CDF (reference: proteins.py:523-538)
        R.figure_auc1_sorted_cdf(figures_dir, auc1s_plot)
        # precision-recall over per-query means (proteins.py:605-684)
        totals = np.asarray(
            [max(len(homologous.get(q, ())), 1) for q in full_sequences_ids]
        )
        recall, precision, _ = analysis.per_query_precision_recall(
            scores, correct, totals
        )
        R.figure_precision_recall(
            figures_dir,
            {f"knn ({index_mode}) cosine": (recall, precision)},
            name="precision_recall_curve",
            legend_loc="lower left",
        )
        if sequence_lengths is not None:
            lengths = np.asarray(sequence_lengths)
            R.figure_length_vs_auc1(figures_dir, lengths, auc1s_plot)
            R.figure_length_bucketed_auc1(figures_dir, lengths, auc1s_plot)
    return metrics


def main(argv=None):
    """CLI parity with `python -m pfam.proteins_search {flat|lsh|hnsw}`
    (reference: pfam/proteins_search.py:11-57): build+persist the index over
    full_sequences.npy, search all-vs-all k=1000, save hits/scores npy and
    report index size vs raw embeddings."""
    import argparse

    from ..utils.logging import configure_logging

    configure_logging()
    parser = argparse.ArgumentParser()
    parser.add_argument(
        "index_mode", choices=["flat", "lsh", "graph", "hnsw", "ivf"],
        help="'hnsw' is an alias for the graph ANN index; 'ivf' is the"
        " sub-linear index of int8 cluster slabs",
    )
    parser.add_argument("--data", type=Path, default=Path("."))
    parser.add_argument("--npy", default="full_sequences.npy")
    parser.add_argument("--k", type=int, default=1000)
    parser.add_argument("--device", default="cuda",
                        help="cuda (default) or cpu")
    args = parser.parse_args(argv)
    mode = "graph" if args.index_mode == "hnsw" else args.index_mode

    npy = args.data / args.npy
    embeddings = np.load(npy).astype(np.float32)
    print("full_sequences", embeddings.shape)
    index_file = args.data / f"{npy.stem}_{args.index_mode}.index"
    result = build_and_search(embeddings, mode, index_file, args.k,
                              device=args.device)
    print(f"Index creation took {int(result['build_seconds'])}s")
    if result["index_bytes"]:
        print(
            f"Embeddings: {npy.stat().st_size} B"
            f" Index: {result['index_bytes']} B"
            f" Difference: {result['index_bytes'] - npy.stat().st_size} B"
        )
    print(f"Search took {int(result['search_seconds'])}s")
    np.save(args.data / f"{npy.stem}_{args.index_mode}_scores.npy", result["scores"])
    np.save(args.data / f"{npy.stem}_{args.index_mode}_hits.npy", result["hits"])


if __name__ == "__main__":
    main()
