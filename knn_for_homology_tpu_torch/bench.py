"""Headline benchmark of the port: flat all-vs-all kNN at Pfam-full-sequence
scale (the counterpart of the repository's bench.py, same flags, modes and
JSON keys).

    python -m knn_for_homology_tpu_torch.bench               # n=131072 d=1024 k=1000
    python -m knn_for_homology_tpu_torch.bench --quick --device cpu

Every database vector is a query (all-vs-all, rows L2-normalised, so
cosine is ip). Every mode goes through ops/topk.py:flat_topk, as bench.py's
do. Modes (`--modes`, the first is the headline):
  * sq8-pq  — int8 database quantised ONCE outside the timed search, int8
              queries: kernel F (ops/packed_cuda.py);
  * approx  — packed segment-top-R over the native (bf16) vectors: kernel D;
  * exact   — the certificate-carrying segment-top-R search: kernel B
              (ops/exact_cuda.py), exact;
  * sq8     — int8 database quantised per call, bf16 queries: kernel E;
  * sq8-sym — int8 database and queries, quantised per call: kernel F.
The high-recall point (`--hi-recall-target`, 0 disables) runs the
prequantised database with two-level int8 queries (sq8-sym2, kernel F).

Each mode runs once untimed, then `--reps` timed runs, each ending in a
device synchronise; the minimum is reported. Recall is measured against
the exact top-k on a 2048-query subsample. vs_baseline = the reference's
FAISS-HNSW time (77 s on CPU for the same query count) / ours, so > 1 is
faster. Prints ONE JSON line on stdout; progress goes to stderr. Nothing
touches CUDA or builds a kernel until main() runs.
"""

import argparse
import json
import sys
import time
from pathlib import Path

import torch

from .device import resolve_device
from .ops.distance import l2_normalize
from .ops.exact_cuda import plan_fingerprint
from .ops.packed_cuda import quantize_database
from .ops.topk import flat_topk

REFERENCE_SECONDS = 77.0  # FAISS HNSW, all queries, k=1000 (BASELINE.md)
RECALL_QUERIES = 2048

# mode name → (approx, storage) for flat_topk
MODE_ARGS = {
    "approx": (True, "native"),
    "exact": (False, "native"),
    "sq8": (True, "sq8"),
    "sq8-sym": (True, "sq8-sym"),
    "sq8-pq": (True, "sq8-sym"),
}


def parse_args(argv=None) -> argparse.Namespace:
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--n", type=int, default=131072)
    p.add_argument("--d", type=int, default=1024)
    p.add_argument("--k", type=int, default=1000)
    p.add_argument("--recall-target", type=float, default=0.98,
                   help="recall target of the packed kernels' Poisson slot"
                   " bound; the measured recall is reported")
    p.add_argument("--dtype", default="bfloat16",
                   choices=["bfloat16", "float32"],
                   help="embedding storage dtype (bf16 products sum in fp32)")
    p.add_argument("--modes", default="sq8-pq,approx,exact,sq8-sym",
                   help="comma list of " + "|".join(MODE_ARGS)
                   + "; the first is the headline metric")
    p.add_argument("--reps", type=int, default=3,
                   help="timed repetitions per mode; the MIN is reported")
    p.add_argument("--hi-recall-target", type=float, default=0.995,
                   help="recall target of the sq8-sym2 high-recall point,"
                   " emitted as hi_recall_qps / hi_recall; 0 disables")
    p.add_argument("--quick", action="store_true",
                   help="tiny shapes: n=2048, d=128, k=100")
    p.add_argument("--profile-dir", default=None,
                   help="write a torch.profiler trace of the head mode's"
                   " first timed run here")
    p.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    args = p.parse_args(argv)
    if args.quick:
        args.n, args.d, args.k = 2048, 128, 100
    modes = [m.strip() for m in args.modes.split(",") if m.strip()]
    unknown = [m for m in modes if m not in MODE_ARGS]
    if not modes or unknown:
        p.error(f"--modes: unknown or empty {unknown or args.modes!r}")
    args.mode_list = modes
    return args


def _log(msg: str) -> None:
    print(msg, file=sys.stderr, flush=True)


def recall(got: torch.Tensor, want: torch.Tensor, k: int) -> float:
    """Mean over rows of |got ∩ want| / k (bench.py's set overlap)."""
    return sum(
        len(set(a) & set(b)) / k
        for a, b in zip(got.cpu().tolist(), want.cpu().tolist())
    ) / got.shape[0]


def run(args: argparse.Namespace) -> dict:
    """Runs the benchmark; returns the JSON result as a dict."""
    device = resolve_device(args.device)

    def sync():
        if device.type == "cuda":
            torch.cuda.synchronize(device)

    dtype = torch.bfloat16 if args.dtype == "bfloat16" else torch.float32
    gen = torch.Generator(device=device).manual_seed(0)
    db = l2_normalize(
        torch.randn(args.n, args.d, generator=gen, device=device)
    ).to(dtype)
    modes = args.mode_list
    # index build, outside every timed search: the prequantised database,
    # and the fp32 copy the exact mode's kernel B takes (flat_topk would
    # widen a bf16 database on every call). The copy is exact: bf16
    # products are exact in fp32, which is what the TPU's DEFAULT-precision
    # bf16 dot summed.
    db_pq = None
    if "sq8-pq" in modes or args.hi_recall_target:
        db_pq = quantize_database(db)
    db32 = db.to(torch.float32)
    sync()

    def search(mode: str):
        """One synchronised search; mode "hi" is the sq8-sym2 point."""
        hi = mode == "hi"
        approx, storage = (True, "sq8-sym2") if hi else MODE_ARGS[mode]
        queries = db if approx else db32
        _, ids = flat_topk(
            db_pq if mode in ("sq8-pq", "hi") else queries, queries, args.k,
            metric="ip", approx=approx,
            recall_target=args.hi_recall_target if hi else args.recall_target,
            storage=storage,
        )
        sync()
        return ids

    def timed(mode: str, profile: bool = False):
        search(mode)  # warm-up (kernel build on first use)
        best, ids = float("inf"), None
        for rep in range(max(1, args.reps)):
            start = time.perf_counter()
            if profile and rep == 0:
                ids = _profiled(lambda: search(mode), args.profile_dir, mode,
                                device)
            else:
                ids = search(mode)
            best = min(best, time.perf_counter() - start)
        _log(f"bench {mode}: {args.n / best:.1f} queries/s (min of"
             f" {max(1, args.reps)})")
        return best, ids

    stats, ids_by_mode = {}, {}
    for mode in modes:
        stats[mode], ids_by_mode[mode] = timed(
            mode, profile=bool(args.profile_dir) and mode == modes[0]
        )

    # recall against the exact top-k of a query subsample
    sub = min(RECALL_QUERIES, args.n)
    approx_modes = [m for m in modes if MODE_ARGS[m][0]]
    exact_ids = None
    if approx_modes or args.hi_recall_target:
        exact_ids = (
            ids_by_mode["exact"][:sub] if "exact" in ids_by_mode
            else flat_topk(db32, db32[:sub], args.k, metric="ip")[1]
        )
    recalls = {
        mode: recall(ids_by_mode[mode][:sub], exact_ids, args.k)
        for mode in approx_modes
    }

    reference_qps = args.n / REFERENCE_SECONDS
    hi = {}
    if args.hi_recall_target:
        best, hi_ids = timed("hi")
        hi = {
            "hi_recall_qps": round(args.n / best, 2),
            "hi_recall_vs_baseline": round((args.n / best) / reference_qps, 2),
            "hi_recall": round(
                recall(hi_ids[:sub], exact_ids, args.k), 4
            ),
            "hi_recall_target": args.hi_recall_target,
        }

    head = modes[0]
    head_qps = args.n / stats[head]
    result = {
        "metric": f"flat_{head}_allvsall_n{args.n}_k{args.k}_qps",
        "value": round(head_qps, 2),
        "unit": "queries/s",
        "vs_baseline": round(head_qps / reference_qps, 2),
    }
    for mode in modes:
        qps = args.n / stats[mode]
        result[f"{mode}_qps"] = round(qps, 2)
        result[f"{mode}_vs_baseline"] = round(qps / reference_qps, 2)
    if head in recalls:
        result["recall_vs_exact"] = round(recalls[head], 4)
    for mode, rec in recalls.items():
        if mode != head:
            result[f"{mode}_recall"] = round(rec, 4)
    result.update(hi)
    approx_h, storage_h = MODE_ARGS[head]
    result["config"] = dict(
        plan_fingerprint(
            args.n, args.d, args.k, exact=not approx_h, storage=storage_h,
            recall_target=args.recall_target,
            itemsize=2 if args.dtype == "bfloat16" else 4,
        ),
        dtype=args.dtype,
        recall_target=args.recall_target,
        reps=args.reps,
        timing="min",
        device=(torch.cuda.get_device_name(device) if device.type == "cuda"
                else "cpu"),
    )
    return result


def _profiled(fn, out_dir: str, mode: str, device: torch.device):
    """Runs fn under torch.profiler. Writes its chrome trace and a summary
    of the same call (wall ms, device ms by kernel name, busy share = device
    / wall) to out_dir, and logs the summary."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if device.type == "cuda":
        activities.append(ProfilerActivity.CUDA)
    with profile(activities=activities) as prof:
        start = time.perf_counter()
        out = fn()
        wall_ms = (time.perf_counter() - start) * 1e3
    by_name = {
        e.key: {"ms": e.self_device_time_total / 1e3, "count": e.count}
        for e in prof.key_averages()
        if e.device_type == DeviceType.CUDA and not e.is_user_annotation
    }
    device_ms = sum(v["ms"] for v in by_name.values())
    summary = dict(mode=mode, wall_ms=wall_ms, device_ms=device_ms,
                   busy=device_ms / wall_ms, device_by_name=by_name)
    path = Path(out_dir)
    path.mkdir(parents=True, exist_ok=True)
    prof.export_chrome_trace(str(path / f"bench_{mode}_trace.json"))
    (path / f"bench_{mode}_summary.json").write_text(
        json.dumps(summary, indent=1)
    )
    top = sorted(by_name.items(), key=lambda kv: -kv[1]["ms"])[:4]
    _log(f"profile {mode}: wall {wall_ms:.3f} ms, device {device_ms:.3f} ms,"
         f" busy {summary['busy']:.4f}; "
         + "; ".join(f"{k[:60]} {v['ms']:.3f} ms x{v['count']}" for k, v in top))
    return out


def main(argv=None) -> None:
    print(json.dumps(run(parse_args(argv))), flush=True)


if __name__ == "__main__":
    sys.exit(main())
