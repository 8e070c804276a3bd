#!/usr/bin/env python3
"""Kernel M of the PyTorch port (csrc/lstm_bidir.cu) on one NVIDIA GPU:
what ptxas reports for it, and its time a launch and a step at the batch
shapes of the benchmark's seqvec.mix cell beside the fp32 route's step
loop (ops/lstm.py:lstmp_bidir_plain); with --cell-call, one call of the cell's
proteins through SeqVecEmbedder on M and on the fp32 step loop. The card
tests (tests/test_torch_cuda_kernels.py -k kernel_m) hold M to its plain
version.

    python3 scripts/torch_lstm_probe.py [--no-ptxas] [--cell-call]

Weights are drawn as the benchmark draws them (TF1's Glorot-uniform
default of bilm-tf's LSTMCell), inputs x ~ N(0, 1).
"""

import argparse
import json
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))

from chip_smoke import card_line, cuda_ms  # noqa: E402

P, H = 512, 4096
# seqvec.mix's batches (rows, shortest, longest residues): the ext lengths
# (+2) of the widest and the longest batch
TIMED = [("B 56, T 272", 56, 185, 272), ("B 10, T 1616", 10, 883, 1616),
         ("B 36, T 184", 36, 69, 184), ("B 24, T 647", 24, 525, 647)]


def weights(gen, device):
    import torch

    def uniform(shape, fan):
        limit = (6.0 / fan) ** 0.5
        return ((torch.rand(shape, generator=gen, device=device) * 2 - 1)
                * limit).to(torch.bfloat16)

    w_x = [uniform((P, 4 * H), P + P + 4 * H) for _ in range(2)]
    w_h = [uniform((P, 4 * H), P + P + 4 * H) for _ in range(2)]
    w_p = [uniform((H, P), H + P) for _ in range(2)]
    return w_x, w_h, w_p


def inputs(gen, lengths, w_x, device):
    import torch

    b, steps = len(lengths), max(max(lengths), 1)
    x = torch.randn((b, steps, P), generator=gen, device=device)
    xw = torch.stack([(x.reshape(-1, P).to(torch.bfloat16) @ w)
                      .view(b, steps, 4 * H) for w in w_x])
    return xw.contiguous(), list(lengths)


def spread(b, lo, hi):
    """b lengths evenly from hi down to lo."""
    return [int(round(hi - (hi - lo) * i / max(b - 1, 1))) for i in range(b)]


def ptxas_report():
    from knn_for_homology_tpu_torch.ops import _build

    out = subprocess.run(
        [_build._nvcc(), *_build.NVCC_FLAGS, "-Xptxas", "-v", "-c",
         str(_build.CSRC / "lstm_bidir.cu"), "-o", "/dev/null"],
        capture_output=True, text=True)
    for line in (out.stdout + out.stderr).splitlines():
        if any(w in line for w in ("registers", "spill", "error", "C75",
                                   "warning")):
            print("ptxas:", line.strip())


def cell_call(dev) -> None:
    """One call of seqvec.mix (256 proteins of the length mix, 16384-token
    batches) through SeqVecEmbedder.embed_pooled on the benchmark's
    weights: the bf16 route on kernel M, and the fp32 config's step loop
    (the route the fp32 published weights take), each timed warm."""
    import dataclasses
    import time

    import torch

    from knn_for_homology_tpu_torch.models.registry import SeqVecEmbedder
    from portbench.drivers.embed_seqvec import elmo_config, seqvec_weights
    from portbench.lib import harness, traffic

    cfg = harness.load_json(harness.BENCH_DIR / "configs" / "seqvec.json")
    cell = harness.load_json(harness.BENCH_DIR / "cells" / "seqvec.mix.json")
    lengths = traffic.lengths_of(cell["lengths"])
    seqs = traffic.random_sequences(traffic.rng(1, 4), lengths)
    weights = seqvec_weights(cfg, 1, dev)
    config = elmo_config(cfg)
    for name, dtype in (("bf16 on M", torch.bfloat16),
                        ("fp32 step loop", torch.float32)):
        emb = SeqVecEmbedder(config=dataclasses.replace(config, dtype=dtype),
                             params=weights,
                             max_batch_tokens=cell["token_budget"],
                             device=dev)
        emb.embed_pooled(seqs[:8])
        torch.cuda.synchronize()
        start = time.perf_counter()
        emb.embed_pooled(seqs)
        secs = time.perf_counter() - start
        print(json.dumps({"cell_call": name, "seconds": secs,
                          "residues_per_s": float(lengths.sum()) / secs}),
              flush=True)
        del emb


def main() -> int:
    import torch

    from knn_for_homology_tpu_torch.ops import _build, lstm_cuda
    from knn_for_homology_tpu_torch.ops.lstm import lstmp_bidir_plain

    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--no-ptxas", action="store_true")
    p.add_argument("--cell-call", action="store_true",
                   help="also time one call of seqvec.mix's proteins "
                        "through the embedder, bf16 on M against the fp32 "
                        "step loop")
    args = p.parse_args()
    dev = torch.device("cuda")
    print("card:", card_line())
    print("build s:", round(_build.timed_build(), 1))
    if not args.no_ptxas:
        ptxas_report()
    gen = torch.Generator(dev).manual_seed(5)
    w_x, w_h, w_p = weights(gen, dev)
    packed = lstm_cuda.lstmp_weights(w_h, w_p)
    w_h32, w_p32 = [w.float() for w in w_h], [w.float() for w in w_p]
    for name, b, lo, hi in TIMED:
        lengths = spread(b, lo, hi)
        xw, lens = inputs(gen, lengths, w_x, dev)
        ms = cuda_ms(lambda: lstm_cuda.lstmp_bidir(xw, packed, lens, 3.0,
                                                   3.0), reps=3, windows=3)
        line = {"time": name, "kernel_ms": ms, "us_a_step": 1e3 * ms / hi}
        # the fp32 step loop, both directions, 64 steps of the same rows
        xw32 = xw[:, :, :64].float()
        loop = cuda_ms(lambda: lstmp_bidir_plain(xw32, w_h32, w_p32,
                                                 [64] * b, 3.0, 3.0),
                       reps=1, windows=3)
        line["fp32_loop_us_a_step_both_dirs"] = 1e3 * loop / 64
        print(json.dumps(line), flush=True)
    if args.cell_call:
        cell_call(dev)
    return 0


if __name__ == "__main__":
    sys.exit(main())
