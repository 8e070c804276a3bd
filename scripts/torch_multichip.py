#!/usr/bin/env python3
"""The port's sharded path across cards: NCCL ranks, one a card.

    python3 scripts/torch_multichip.py [--ranks 4] [--seed 0]

Needs a host with at least `--ranks` CUDA cards (chip_smoke.py phase 12
runs the same code on one card: one NCCL rank, and two gloo ranks sharing
it). Steps:

  1. dryrun_multichip(ranks, "cuda") on NCCL: the seven steps and their
     goldens (entry.py);
  2. chip_smoke.sharded_rank on `ranks` NCCL ranks over phase 4's dataset
     (131072 x 1024 vectors, 4096 queries; a shard a card, the IVF at a
     nprobe and budget covering a shard's cells), then encode_sharded at
     ProtT5-XL width with the heads and d_ff split over the ranks, held to
     the unsharded counterparts computed on card 0 (chip_smoke.check_ranks:
     ids of the exact top-k but near-tie swaps within 1e-5, LSH bit-equal,
     the encoder within phase 8's bound).

Prints every card's name and power limit, a line per step and, last, one
JSON line of the seconds.
"""

import argparse
import json
import subprocess
import sys
import tempfile
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))

import chip_smoke as cs  # noqa: E402


def main():
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--ranks", type=int, default=4)
    p.add_argument("--seed", type=int, default=0)
    args = p.parse_args()

    import torch

    if torch.cuda.device_count() < args.ranks:
        raise SystemExit(f"needs {args.ranks} cards, found"
                         f" {torch.cuda.device_count()}")
    from knn_for_homology_tpu_torch.entry import dryrun_multichip
    from knn_for_homology_tpu_torch.ops import _build
    from knn_for_homology_tpu_torch.parallel.mesh import spawn

    cards = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip().splitlines()
    cs.log(f"cards: {' | '.join(cards)} | torch {torch.__version__}")
    cs.log(f"build: {_build.timed_build():.1f} s")

    t0 = time.perf_counter()
    dry = dryrun_multichip(args.ranks, device="cuda")
    dry_s = time.perf_counter() - t0
    cs.log(f"dryrun_multichip({args.ranks}, cuda) on nccl: {dry['steps']}"
           f" steps held to their goldens in {dry_s:.1f} s (encoder vs"
           f" unsharded max |diff| {dry['encoder_max_abs']:.3g}, bf16)")

    with tempfile.TemporaryDirectory(prefix="knn_multichip_") as tmp:
        train, test, _, test_seqs = cs.write_dataset(Path(tmp) / "ds",
                                                     args.seed)
        seqs = cs.encoder_proteins(test_seqs, args.seed)
        refs = cs.rank_refs(train, test, seqs, args.seed,
                            world=args.ranks)
        t0 = time.perf_counter()
        ranks = spawn(cs.sharded_rank, args.ranks, device="cuda",
                      backend="nccl",
                      args=(cs.rank_data(Path(tmp), refs), seqs, args.seed))
        wall = time.perf_counter() - t0
        cs.check_ranks("sharded_rank on nccl", ranks, refs, wall, cards[0])
    print(json.dumps({"ranks": args.ranks, "dryrun_s": dry_s,
                      "sharded_wall_s": wall, "rank0_s": ranks[0]["secs"]}))


if __name__ == "__main__":
    main()
