"""Embedding CLI — fasta → per-protein vectors (.npy + .json + .time.txt)
(port of knn_for_homology_tpu/pipelines/embed.py).

  * `embed` ↔ pfam/embed_t5_fp16.py / embed_pfam_t5.py / embed_t5_l2.py:
    cut to 3096, length-sorted token-budget batches, mean-pool (or the
    per-residue-L2 variant), un-sort, npy + ids json + wall-time sidecar
  * `embed-one`: one embedder over one fasta into a directory (ids.json,
    <embedder>.npy, <embedder>.time1.txt; SeqVec saved as its 4 layer
    variants, "SeqVec Sum.npy" etc., reference: cath/embed.py:100-107),
    as cath/embed.py's main
  * `embed-all` ↔ cath/embed_all.py: every registry embedder over one
    fasta, each in an `embed-one` subprocess (one embedder's crash does
    not stop the sweep; reference rationale: cath/embed_all.py:1-11),
    file-existence idempotency, the AA-composition baseline inline; keys
    with no checkpoint under --checkpoints are skipped
  * `embed-domains` ↔ pfam/embed_pfam_seqvec.py: embed full sequences
    (SeqVec by default, its [3, L, d] layers concatenated to [L, 3d]),
    mean-pool each domain range, emit the dataset-contract npy/json pairs

Usage:
  python -m knn_for_homology_tpu_torch.pipelines.embed embed <fasta> <npy>
      [--embedder "ProtT5 XL U50"] [--checkpoint NPZ] [--batch-size 7000]
      [--l2] [--max-len 3096] [--device cuda|cpu]
  python -m knn_for_homology_tpu_torch.pipelines.embed embed-one <fasta>
      <outdir> --embedder NAME [--checkpoint NPZ] [--device cuda|cpu]
  python -m knn_for_homology_tpu_torch.pipelines.embed embed-all <fasta>
      <outdir> [--checkpoints DIR] [--device cuda|cpu]
  python -m knn_for_homology_tpu_torch.pipelines.embed embed-domains
      <full_fasta> <train_fasta> <test_fasta> <outdir> [--embedder NAME]
      [--checkpoint NPZ] [--feature-slice 1024 2048] [--device cuda|cpu]
"""

import argparse
import functools
import inspect
import json
import logging
import subprocess
import sys
import time
from pathlib import Path
from typing import Optional, Sequence

import numpy as np

from ..config import DEFAULT_TOKEN_BATCH, MAX_SEQ_LEN
from ..data.fasta import read_fasta
from ..data.pfam import build_domain_ranges
from ..models.pooling import pool_domain_range
from ..models.registry import (
    EMBEDDERS,
    AACompositionEmbedder,
    SeqVecEmbedder,
    get_embedder,
)
from ..utils.logging import configure_logging
from ..utils.timing import write_time_sidecar

logger = logging.getLogger(__name__)


def _make_embedder(name: str, checkpoint: Optional[Path], device, **kw):
    if name == "AA Composition":
        return AACompositionEmbedder()
    ctor = EMBEDDERS.get(name)
    if ctor is not None:
        # the constructors take different knobs (token_budget /
        # max_batch_tokens / max_len …): pass only what each one takes
        target = ctor.func if isinstance(ctor, functools.partial) else ctor
        accepted = set(inspect.signature(target.__init__).parameters)
        kw = {k: v for k, v in kw.items() if k in accepted}
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
        **({"l2_per_residue": True} if args.l2 else {}),
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
    if isinstance(embedder, SeqVecEmbedder):
        for name, arr in embedder.embed_layer_variants(sequences).items():
            np.save(out_dir / f"{name}.npy", arr)
    else:
        np.save(out_dir / f"{args.embedder}.npy",
                embedder.embed_pooled(sequences))
    write_time_sidecar(
        out_dir / f"{args.embedder}.time1.txt", time.time() - start
    )


def cmd_embed_all(args) -> None:
    """(reference: cath/embed_all.py:47-65)"""
    out_dir = Path(args.outdir)
    out_dir.mkdir(parents=True, exist_ok=True)

    # AA-composition baseline, inline (reference: cath/embed_all.py:23-44)
    aa_npy = out_dir / "AA Composition.npy"
    if not aa_npy.is_file():
        _, sequences = _read(args.fasta)
        start = time.time()
        np.save(aa_npy, AACompositionEmbedder().embed_pooled(sequences))
        write_time_sidecar(
            out_dir / "AA Composition.time2.txt", time.time() - start
        )

    for name in sorted(EMBEDDERS):
        if name == "AA Composition":
            continue
        done_file = out_dir / (
            "SeqVec Sum.npy" if name == "SeqVec" else f"{name}.npy")
        if done_file.is_file():
            logger.info("%s already done, skipping", name)
            continue
        checkpoint = (
            Path(args.checkpoints) / name if args.checkpoints else None
        )
        if checkpoint is not None and not checkpoint.exists():
            logger.info("%s: no checkpoint at %s, skipping", name, checkpoint)
            continue
        cmd = [sys.executable, "-m", "knn_for_homology_tpu_torch.pipelines.embed",
               "embed-one", args.fasta, str(out_dir), "--embedder", name,
               "--device", str(args.device)]
        if checkpoint is not None:
            cmd += ["--checkpoint", str(checkpoint)]
        try:
            start = time.time()
            subprocess.check_call(cmd)
            write_time_sidecar(
                out_dir / f"{name}.time2.txt", time.time() - start
            )
        except subprocess.CalledProcessError as err:
            logger.warning("Failed to embed with %s: %s", name, err)


def cmd_embed_domains(args) -> None:
    """(reference: pfam/embed_pfam_seqvec.py:29-82)"""
    domain_ranges_train = build_domain_ranges(Path(args.train_fasta))
    domain_ranges_test = build_domain_ranges(Path(args.test_fasta))
    ids, sequences = _read(args.full_fasta)
    embedder = _make_embedder(args.embedder, args.checkpoint, args.device)

    data_train, data_test = {}, {}
    for seq_id, per_residue in zip(ids, embedder.embed_per_residue(sequences)):
        if per_residue.ndim == 3:  # SeqVec [3, L, d] → concat layer features
            per_residue = np.concatenate(list(per_residue), axis=-1)
        for start, stop, annotation in domain_ranges_train.get(seq_id, []):
            data_train[annotation] = pool_domain_range(per_residue, start, stop)
        for start, stop, annotation in domain_ranges_test.get(seq_id, []):
            data_test[annotation] = pool_domain_range(per_residue, start, stop)

    out = Path(args.outdir)
    out.mkdir(parents=True, exist_ok=True)
    for split, data in [("train", data_train), ("test", data_test)]:
        (out / f"{split}.json").write_text(json.dumps(list(data)))
        full = np.asarray(list(data.values()))
        np.save(out / f"{split}_full.npy", full)
        # LSTM1 slice = dims 1024:2048 of SeqVec's concatenated layers
        # (reference: pfam/embed_pfam_seqvec.py:77-78)
        lo, hi = args.feature_slice
        np.save(out / f"{split}.npy", full[:, lo:hi] if hi > lo else full)


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

    p = sub.add_parser("embed-all")
    p.add_argument("fasta")
    p.add_argument("outdir")
    p.add_argument("--checkpoints", type=Path)
    p.add_argument("--device", choices=["cuda", "cpu"], default="cuda",
                   help="forwarded to every embed-one worker")
    p.set_defaults(func=cmd_embed_all)

    p = sub.add_parser("embed-domains")
    p.add_argument("full_fasta")
    p.add_argument("train_fasta")
    p.add_argument("test_fasta")
    p.add_argument("outdir")
    p.add_argument("--embedder", default="SeqVec")
    p.add_argument("--checkpoint", type=Path)
    p.add_argument(
        "--feature-slice", type=int, nargs=2, default=(1024, 2048)
    )
    p.add_argument("--device", choices=["cuda", "cpu"], default="cuda")
    p.set_defaults(func=cmd_embed_domains)

    args = parser.parse_args(argv)
    args.func(args)


if __name__ == "__main__":
    main()
