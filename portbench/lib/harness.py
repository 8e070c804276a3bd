"""One run of one cell: set-up, the measured window, the check of what the
window produced, and the result line.

Everything that belongs to one cell, configuration or metric is found by
name: `BENCHMARK.json` names the cell's configuration and its metrics,
`portbench/cells/<cell>.json` holds the traffic and the driver's name and
the limits of the check, `portbench/configs/<config>.json` the sizes,
`portbench/drivers/<driver>.py` the code that runs the program, and
`portbench/metrics/<metric>.py` the reader of each metric.

A driver module has:
  setup(ctx) -> state          build the program's objects, make the inputs
                               from ctx.seed, warm every shape up (marking
                               its phases with ctx.mark(name));
  step(state, i) -> dict       one call into the program: {"units": n, ...}
                               (the work it completed, in the cell's unit);
  release(state) -> outputs    free the program, keep what it produced;
  readings(ctx, outputs, control=False) -> {name: number}
                               the reference's comparison (with `control`,
                               the reference in a lower precision put in the
                               program's place), each number to stay at or
                               under the cell's limit of that name.
A state may hold "info": what the metric readers need of the calls
(their lengths, batch shapes, DP cells).
"""

import gc
import importlib.util
import json
import math
import os
import subprocess
import sys
import time
import traceback
from dataclasses import dataclass, field
from pathlib import Path
from typing import Dict, List, Optional

from .record import DeviceTrace, Recorder, breakdown, read_profile

ROOT = Path(__file__).resolve().parents[2]
BENCH_DIR = ROOT / "portbench"
# top-level module names that no run may have loaded (compared whole: the
# port's name begins with the JAX package's)
FORBIDDEN = ("jax", "jaxlib", "flax", "knn_for_homology_tpu")


def process_start() -> float:
    """time.time() at which this process started (Linux /proc; else now)."""
    try:
        with open("/proc/self/stat") as fp:
            ticks = int(fp.read().rsplit(")", 1)[1].split()[19])
        with open("/proc/uptime") as fp:
            uptime = float(fp.read().split()[0])
        return time.time() - uptime + ticks / os.sysconf("SC_CLK_TCK")
    except (OSError, ValueError, IndexError):
        return time.time()


PROCESS_START = process_start()
# set-up phases before a run starts: the harness imported, then torch
EARLY_PHASES = {"python": round(time.time() - PROCESS_START, 3)}


def load_json(path: Path) -> dict:
    with open(path) as fp:
        return json.load(fp)


def load_module(path: Path, tag: str):
    """Import a file of the benchmark by path (its name may hold dots)."""
    spec = importlib.util.spec_from_file_location(tag, path)
    if spec is None:
        raise FileNotFoundError(path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def forbidden_modules() -> List[str]:
    return sorted({n.split(".")[0] for n in list(sys.modules)
                   if n.split(".")[0] in FORBIDDEN})


@dataclass
class Context:
    """What a driver is given: its cell, its configuration, the seed."""

    name: str
    cell: dict
    config: dict
    seed: int
    device: object
    recorder: Recorder
    overrides: dict = field(default_factory=dict)
    phases: Dict[str, float] = field(default_factory=dict)

    def mark(self, name: str) -> None:
        """Notes that a phase of set-up ended: seconds since process
        start, printed with the result to show where set-up goes."""
        self.phases[name] = round(time.time() - PROCESS_START, 3)

    def config_of(self, name: str) -> dict:
        """Another configuration by name (a cell's database, say)."""
        cfg = load_json(BENCH_DIR / "configs" / f"{name}.json")
        cfg.update(self.overrides.get("configs", {}).get(name, {}))
        return cfg


@dataclass
class Run:
    """What the metric readers see of one run."""

    name: str
    cell: dict
    config: dict
    calls: List[dict]
    window: tuple
    setup_s: float
    trace: Optional[DeviceTrace] = None
    info: Dict[str, object] = field(default_factory=dict)

    def window_s(self) -> float:
        """From the window's start to the end of its last completed call."""
        ends = [c["t1"] for c in self.calls if not c.get("failed")]
        return (max(ends) if ends else self.window[1]) - self.window[0]

    def total(self, key: str) -> float:
        return float(sum(c.get(key, 0) for c in self.calls
                         if not c.get("failed")))


def workload_entry(bench: dict, name: str) -> dict:
    for entry in bench["workloads"]:
        if entry["name"] == name:
            return entry
    raise KeyError(f"no workload {name!r} in BENCHMARK.json")


def metric_entries(bench: dict, name: str, traced: bool) -> List[dict]:
    """The cell's end-to-end metrics (untraced) or per-layer ones (traced):
    those that list the cell, or list no cells."""
    entries = bench["per_layer"] if traced else bench["end_to_end"]
    return [m for m in entries if name in m.get("workloads", [name])]


def card_line(device) -> dict:
    """Name, count and power limit of the card(s) the run used."""
    import torch

    if device.type != "cuda":
        return {"platform": "cpu", "kind": "cpu", "count": 0}
    info = {"platform": "gpu", "kind": torch.cuda.get_device_name(0)}
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=power.limit",
             "--format=csv,noheader,nounits", "-i", "0"],
            capture_output=True, text=True, timeout=30, check=True)
        info["power_limit_w"] = float(out.stdout.split()[0])
    except (OSError, subprocess.SubprocessError, ValueError, IndexError):
        info["power_limit_w"] = None
    return info


def _finite(x):
    return x if isinstance(x, (int, float)) and math.isfinite(x) else str(x)


def run_cell(name: str, seed: int, seconds: float, traced: bool, device,
             overrides: Optional[dict] = None, bench: Optional[dict] = None,
             patch=None, control: bool = False) -> dict:
    """Runs one cell and returns its result line as a dict. `overrides`
    ({"cell": {...}, "config": {...}, "configs": {name: {...}}}) resize a
    cell for tests on the CPU; `patch(driver_module)` lets a test break the
    timed path underneath; `control` adds the control's readings on the
    same inputs under "control" (portbench/calibrate.py: the benchmark's
    own runs never compute them)."""
    import torch

    overrides = overrides or {}
    bench = bench or load_json(ROOT / "BENCHMARK.json")
    entry = workload_entry(bench, name)
    cell = load_json(BENCH_DIR / "cells" / f"{name}.json")
    cell.update(overrides.get("cell", {}))
    config = load_json(BENCH_DIR / "configs" / f"{entry['config']}.json")
    config.update(overrides.get("config", {}))
    driver = load_module(BENCH_DIR / "drivers" / f"{cell['driver']}.py",
                         f"portbench_driver_{cell['driver']}")
    if patch is not None:
        patch(driver)
    device = torch.device(device)
    recorder = Recorder(traced)
    ctx = Context(name, cell, config, int(seed), device, recorder, overrides,
                  dict(EARLY_PHASES))
    ctx.mark("imports")
    if device.type == "cuda":
        torch.cuda.init()
    ctx.mark("cuda")

    state = driver.setup(ctx)
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    setup_s = time.time() - PROCESS_START
    ctx.mark("warm")
    # The collector leaves what set-up made (torch, the inputs, the
    # program's state) out of the window's full collections, which
    # otherwise scan ~170k objects every ~1 s and stall a call by ~100 ms.
    gc.collect()
    gc.freeze()
    prof = None
    if traced:
        from torch.profiler import ProfilerActivity, profile

        acts = [ProfilerActivity.CPU]
        if device.type == "cuda":
            acts.append(ProfilerActivity.CUDA)
        prof = profile(activities=acts)
        prof.start()
    calls, failed, first_error = [], 0, None
    with recorder.span("window"):
        start = time.perf_counter()
        i = 0
        while time.perf_counter() - start < seconds:
            t0 = time.perf_counter()
            try:
                work = driver.step(state, i)
            except Exception:  # a failed call is counted, not fatal
                work = {"units": cell["units_per_call"], "failed": True}
                failed += cell["units_per_call"]
                first_error = first_error or traceback.format_exc()
            calls.append(dict(work, t0=t0, t1=time.perf_counter()))
            i += 1
        end = time.perf_counter()
    gc.unfreeze()
    trace = None
    if prof is not None:
        prof.stop()
        trace = read_profile(prof)
        del prof
    peak = (torch.cuda.max_memory_allocated(device)
            if device.type == "cuda" else 0)
    if first_error:
        print(first_error, file=sys.stderr)

    run = Run(name, cell, config, calls, (start, end), setup_s, trace,
              state.get("info", {}))
    outputs = driver.release(state)
    del state
    gc.collect()
    if device.type == "cuda":
        torch.cuda.empty_cache()

    readings = driver.readings(ctx, outputs, control=False)
    limits = cell["limits"]
    if set(readings) != set(limits):
        raise KeyError(f"readings {sorted(readings)} vs limits {sorted(limits)}")
    checks = {k: {"value": _finite(float(readings[k])), "limit": limits[k]}
              for k in sorted(readings)}
    checks_ok = all(isinstance(c["value"], float) and c["value"] <= c["limit"]
                    for c in checks.values())
    attempted = int(sum(c["units"] for c in calls))

    metrics = {}
    for m in metric_entries(bench, name, traced):
        reader = load_module(BENCH_DIR / "metrics" / f"{m['name']}.py",
                             "portbench_metric_" + m["name"].replace(".", "_"))
        value = reader.read(run)
        if value is not None:
            metrics[m["name"]] = {"value": float(value), "unit": m["unit"]}
    dev = card_line(device)
    dev["count"] = entry["chips"] if device.type == "cuda" else 0
    dev["memory_peak_bytes"] = int(peak)
    result = {
        "correct": bool(checks_ok and failed == 0 and attempted > 0),
        "attempted": attempted,
        "failed": int(failed),
        "metrics": metrics,
        "device": dev,
    }
    if trace is not None:
        dev["busy_s"] = trace.busy_s()
        dev["window_s"] = trace.window_s()
        result["breakdown"] = breakdown(trace)
    result["setup_phases"] = ctx.phases
    if control:
        result["control"] = {k: _finite(float(v)) for k, v in
                             driver.readings(ctx, outputs, True).items()}
    result["checks"] = checks
    return result


def print_result(result: dict) -> None:
    """The checks as the last lines of stderr, the result as the last line
    of stdout."""
    for key, c in result["checks"].items():
        print(f"check {key} = {c['value']} (limit {c['limit']})",
              file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(result), flush=True)


def main(argv=None) -> int:
    import argparse

    p = argparse.ArgumentParser(description="Run one benchmark cell.")
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = p.parse_args(argv)

    import torch

    EARLY_PHASES["torch"] = round(time.time() - PROCESS_START, 3)
    bench = load_json(ROOT / "BENCHMARK.json")
    chips = workload_entry(bench, args.workload)["chips"]
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        print(f"portbench: needs {chips} CUDA device(s); found"
              f" {torch.cuda.device_count() if torch.cuda.is_available() else 0}",
              file=sys.stderr)
        return 3
    result = run_cell(args.workload, args.seed, args.seconds,
                      bool(args.trace), "cuda", bench=bench)
    loaded = forbidden_modules()
    if loaded:
        print(f"portbench: the run loaded {loaded}", file=sys.stderr)
        return 4
    print_result(result)
    return 0
