"""Embedding CLI — fasta → per-protein vectors (.npy + .json + .time.txt)
(port of knn_for_homology_tpu/pipelines/embed.py, `embed` and `embed-one`).

  * `embed` ↔ pfam/embed_t5_fp16.py / embed_pfam_t5.py / embed_t5_l2.py:
    cut to 3096, length-sorted token-budget batches, mean-pool (or the
    per-residue-L2 variant), un-sort, npy + ids json + wall-time sidecar
  * `embed-one`: one embedder over one fasta into a directory (ids.json,
    <embedder>.npy, <embedder>.time1.txt), as cath/embed.py's main

Usage:
  python -m knn_for_homology_tpu_torch.pipelines.embed embed <fasta> <npy>
      [--embedder "ProtT5 XL U50"] [--checkpoint NPZ] [--batch-size 7000]
      [--l2] [--max-len 3096] [--device cuda|cpu]
  python -m knn_for_homology_tpu_torch.pipelines.embed embed-one <fasta>
      <outdir> --embedder NAME [--checkpoint NPZ] [--device cuda|cpu]
"""

import argparse
import json
import logging
import time
from pathlib import Path
from typing import Optional, Sequence

import numpy as np

from ..config import DEFAULT_TOKEN_BATCH, MAX_SEQ_LEN
from ..data.fasta import read_fasta
from ..models.registry import AACompositionEmbedder, get_embedder
from ..utils.logging import configure_logging
from ..utils.timing import write_time_sidecar

logger = logging.getLogger(__name__)


def _make_embedder(name: str, checkpoint: Optional[Path], device, **kw):
    if name == "AA Composition":
        return AACompositionEmbedder()
    return get_embedder(name, checkpoint=checkpoint, device=device, **kw)


def _read(fasta):
    sequences_by_id = read_fasta(Path(fasta))
    ids = list(sequences_by_id)
    return ids, [sequences_by_id[i] for i in ids]


def cmd_embed(args) -> None:
    ids, sequences = _read(args.fasta)
    too_long = sum(len(s) > args.max_len for s in sequences)
    logger.info(
        "Cutting %d of %d (%.1f%%) proteins longer than %d amino acids",
        too_long, len(sequences), 100 * too_long / max(len(sequences), 1),
        args.max_len,
    )
    embedder = _make_embedder(
        args.embedder,
        args.checkpoint,
        args.device,
        token_budget=args.batch_size,
        max_len=args.max_len,
        l2_per_residue=args.l2,
    )
    start = time.time()
    embeddings = embedder.embed_pooled(sequences)
    seconds = time.time() - start
    np.save(args.npy, embeddings)
    Path(args.npy).with_suffix(".time.txt").write_text(str(seconds))
    Path(args.npy).with_suffix(".json").write_text(json.dumps(ids))
    logger.info("Embedded %s in %.1fs → %s", embeddings.shape, seconds, args.npy)


def cmd_embed_one(args) -> None:
    out_dir = Path(args.outdir)
    out_dir.mkdir(parents=True, exist_ok=True)
    ids, sequences = _read(args.fasta)
    (out_dir / "ids.json").write_text(json.dumps(ids))
    embedder = _make_embedder(args.embedder, args.checkpoint, args.device)
    start = time.time()
    np.save(out_dir / f"{args.embedder}.npy", embedder.embed_pooled(sequences))
    write_time_sidecar(
        out_dir / f"{args.embedder}.time1.txt", time.time() - start
    )


def main(argv: Optional[Sequence[str]] = None) -> None:
    configure_logging()
    parser = argparse.ArgumentParser(
        description="Embed a fasta with a protein language model on a CUDA GPU"
    )
    sub = parser.add_subparsers(dest="command", required=True)

    p = sub.add_parser("embed")
    p.add_argument("fasta")
    p.add_argument("npy")
    p.add_argument("--embedder", default="ProtT5 XL U50")
    p.add_argument("--checkpoint", type=Path)
    p.add_argument("--batch-size", type=int, default=DEFAULT_TOKEN_BATCH)
    p.add_argument("--max-len", type=int, default=MAX_SEQ_LEN)
    p.add_argument("--l2", action="store_true")
    p.add_argument("--device", choices=["cuda", "cpu"], default="cuda")
    p.set_defaults(func=cmd_embed)

    p = sub.add_parser("embed-one")
    p.add_argument("fasta")
    p.add_argument("outdir")
    p.add_argument("--embedder", required=True)
    p.add_argument("--checkpoint", type=Path)
    p.add_argument("--device", choices=["cuda", "cpu"], default="cuda")
    p.set_defaults(func=cmd_embed_one)

    args = parser.parse_args(argv)
    args.func(args)


if __name__ == "__main__":
    main()
