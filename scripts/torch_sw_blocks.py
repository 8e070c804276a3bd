#!/usr/bin/env python3
"""Kernel C (csrc/sw_grouped.cu) on every block of the main path's card plan.

    python3 scripts/torch_sw_blocks.py [--seed 0] [--out sw_blocks.txt]

Needs one CUDA card. Writes chip_smoke.py's seeded dataset (4096 families,
the repo's length mix), plans every test query against its family's first
13 train members with align.plan_align_cells and iter_card_blocks (the card
route of align_hits), and for each block prints its shape, lanes, real DP
cells, and three times of kernel C: its first call after the block's codes
reach the card (one call, CUDA events, as align_hits makes it), the median
of warm back-to-back calls (chip_smoke.cuda_ms), and its device time in one
pass over all blocks under torch.profiler (sw_lanes + sw_wavefront). The
totals say whether C's device time on the main path is set by its warm rate
on the large blocks or by the rest of the plan.
"""

import argparse
import sys
import tempfile
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))


def main() -> None:
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--out", default=None, help="also write the lines here")
    args = p.parse_args()

    import torch

    if not torch.cuda.is_available():
        raise SystemExit("torch_sw_blocks: needs a CUDA device")
    import chip_smoke as smoke
    from knn_for_homology_tpu_torch.ops import _build
    from knn_for_homology_tpu_torch.ops import align as align_ops
    from knn_for_homology_tpu_torch.ops import align_cuda

    lines = []

    def log(msg):
        print(msg, flush=True)
        lines.append(msg)

    log(f"card: {smoke.card_line()}")
    with tempfile.TemporaryDirectory(prefix="knn_sw_blocks_") as tmp:
        _, _, train_seqs, test_seqs = smoke.write_dataset(Path(tmp), args.seed)
    hits = [train_seqs[i * smoke.FAMILY_TRAIN:i * smoke.FAMILY_TRAIN + smoke.HITS]
            for i in range(len(test_seqs))]
    cells = align_ops.plan_align_cells(list(test_seqs), hits)
    blocks = list(align_ops.iter_card_blocks(cells))
    dev = torch.device("cuda")
    _build.library()  # the build, before any timed call
    smoke.warm_card()

    kw = dict(convention="mmseqs")
    on_card = []
    rows = []
    for lq_b, lt_b, s_b, _, g, block in blocks:
        qc, tc = align_ops.lane_codes(block, lq_b, lt_b, g)
        qd, td = torch.from_numpy(qc).to(dev), torch.from_numpy(tc).to(dev)
        torch.cuda.synchronize()
        time.sleep(0.02)  # the host's gap between blocks on the main path
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        align_cuda.sw_scores_grouped(qd, td, segments=s_b, **kw)
        end.record()
        torch.cuda.synchronize()
        first = start.elapsed_time(end)
        warm = smoke.cuda_ms(
            lambda: align_cuda.sw_scores_grouped(qd, td, segments=s_b, **kw),
            reps=5, windows=3,
        )
        on_card.append((qd, td, s_b))
        rows.append((lq_b, lt_b, s_b, g, tc.shape[1],
                     smoke.real_cells(block), first, warm))

    from torch.autograd import DeviceType

    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    torch.cuda.synchronize()
    with torch.profiler.profile(activities=acts) as prof:
        for qd, td, s_b in on_card:
            align_cuda.sw_scores_grouped(qd, td, segments=s_b, **kw)
        torch.cuda.synchronize()
    # device events in launch order: sw_lanes then sw_wavefront per block
    kern = sorted(
        (ev for ev in prof.events() if ev.device_type == DeviceType.CUDA
         and ("sw_lanes" in ev.name or "sw_wavefront" in ev.name)),
        key=lambda ev: ev.time_range.start,
    )
    prof_ms = [0.0] * len(rows)
    for i, ev in enumerate(kern[: 2 * len(rows)]):
        prof_ms[i // 2] += ev.time_range.elapsed_us() / 1e3

    tot = dict(cells=0, first=0.0, warm=0.0, prof=0.0)
    for (lq_b, lt_b, s_b, g, k, cells_n, first, warm), pm in zip(rows, prof_ms):
        log(f"block Lq={lq_b} Lt={lt_b} S={s_b} G={g} K={k} lanes={g * k}"
            f" cells={cells_n}: first {first:.3f} ms, warm {warm:.3f} ms,"
            f" profiled {pm:.3f} ms, warm {cells_n / warm / 1e6:.1f} GCUPS")
        tot["cells"] += cells_n
        tot["first"] += first
        tot["warm"] += warm
        tot["prof"] += pm
    log(f"total: {len(rows)} blocks, {tot['cells']} real cells | first calls"
        f" {tot['first']:.3f} ms ({tot['cells'] / tot['first'] / 1e6:.1f} GCUPS)"
        f" | warm {tot['warm']:.3f} ms ({tot['cells'] / tot['warm'] / 1e6:.1f}"
        f" GCUPS) | profiled pass {tot['prof']:.3f} ms"
        f" ({len(kern)} kernel events)")
    if args.out:
        Path(args.out).parent.mkdir(parents=True, exist_ok=True)
        Path(args.out).write_text("\n".join(lines) + "\n")


if __name__ == "__main__":
    main()
