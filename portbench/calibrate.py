"""Readings that the limits of a cell's check are set from, in one process:
the program's numbers on many seeds and the control's on some of them, at
the cell's own sizes, each after a short window.

    python3 portbench/calibrate.py --workload <cell> --seconds 5 \
        --seeds 11,12,13 --control-seeds 11,12,13 [--out chiprun_out/x.jsonl]

Prints one JSON line a seed: {"seed", "readings", "control"?}, and the
largest program reading and smallest control reading of each number.
"""

import argparse
import json
import os
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
os.environ["USE_FLAX"] = "0"
sys.path.insert(0, str(ROOT))

from portbench.lib import harness  # noqa: E402


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seconds", type=float, default=5.0)
    p.add_argument("--seeds", required=True)
    p.add_argument("--control-seeds", default="")
    p.add_argument("--out", default=None)
    args = p.parse_args(argv)
    seeds = [int(s) for s in args.seeds.split(",") if s]
    controls = {int(s) for s in args.control_seeds.split(",") if s}
    lines, worst, least = [], {}, {}
    for seed in seeds:
        res = harness.run_cell(args.workload, seed, args.seconds, False,
                               "cuda", control=seed in controls)
        line = {"seed": seed, "correct": res["correct"],
                "readings": {k: c["value"] for k, c in res["checks"].items()},
                "metrics": {k: m["value"] for k, m in res["metrics"].items()}}
        if "control" in res:
            line["control"] = res["control"]
            for k, v in res["control"].items():
                v = float(v)
                least[k] = min(least.get(k, float("inf")), v)
        for k, v in line["readings"].items():
            worst[k] = max(worst.get(k, 0.0), float(v))
        print(json.dumps(line), flush=True)
        lines.append(line)
    summary = {"workload": args.workload, "program_max": worst,
               "control_min": least, "device": res["device"]}
    print(json.dumps(summary), flush=True)
    if args.out:
        Path(args.out).parent.mkdir(parents=True, exist_ok=True)
        with open(args.out, "w") as fp:
            for line in lines + [summary]:
                fp.write(json.dumps(line) + "\n")
    loaded = harness.forbidden_modules()
    if loaded:
        print(f"calibrate: the run loaded {loaded}", file=sys.stderr)
        return 4
    return 0


if __name__ == "__main__":
    sys.exit(main())
