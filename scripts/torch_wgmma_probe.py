#!/usr/bin/env python3
"""Kernels G (csrc/ffn_fused.cu), D, E, F and J (the tensor-core route of
csrc/segment_packed.cu), B (csrc/segment_topr.cu, 3xTF32 wgmma), K
(csrc/slab_expand.cu, 2xTF32 wgmma), A (csrc/flat_topk.cu, FFMA) and C
(csrc/sw_grouped.cu) of the PyTorch port
on one NVIDIA GPU: what ptxas reports for them, which tensor-core, FFMA and
DPX instructions their SASS holds (HGMMA: bf16 or, as HGMMA.TF32, tf32
wgmma; IGMMA: int8 wgmma; C's DPX min/max ops, VIMNMX / VIMNMX3 /
VIADDMNMX as cuobjdump prints them), each against its plain version on a
few ragged shapes, and their times at the main paths' shapes beside their
bounds and the PyTorch yardsticks (G: the two bf16 torch.matmul products;
F: torch._int_mm, the product alone; A, B: one fp32 torch.matmul, the
product alone).

    python3 scripts/torch_wgmma_probe.py [--no-ptxas] [--no-times]

Checks: G within chip_smoke.py's BF16_TOL, D, E, F and J buffers equal to
plain on integer data. Times are chip_smoke.py's cuda_ms (median of 5
windows of 10 calls) and the device time per call under torch.profiler,
split by kernel name. Exits non-zero on any mismatch.
"""

import argparse
import json
import re
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))

from chip_smoke import BF16_TOL, PEAK_OPS, cuda_ms  # noqa: E402

UNITS = ("ffn_fused.cu", "segment_packed.cu", "segment_topr.cu",
         "slab_expand.cu", "flat_topk.cu", "sw_grouped.cu")


def ptxas_report():
    """ptxas -v of G's, D-F/J's, B's, K's, A's and C's units, compiled side
    by side."""
    from knn_for_homology_tpu_torch.ops import _build

    nvcc = _build._nvcc()
    procs = [
        subprocess.Popen(
            [nvcc, *_build.NVCC_FLAGS, "-Xptxas", "-v", "-c",
             str(_build.CSRC / name), "-o", "/dev/null"],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        for name in UNITS
    ]
    for name, proc in zip(UNITS, procs):
        out, _ = proc.communicate()
        for line in out.splitlines():
            if any(w in line for w in ("registers", "spill", "error",
                                       "Compiling entry", "warning", "C75")):
                print(f"ptxas {name}: {line.strip()}", flush=True)
        assert proc.returncode == 0, out


# the variant template argument of segment_packed_mma<BN, V, kInd> in a
# mangled name: 1 D bf16, 2 E, 3 F / J sym, 4 F / J sym2
VARIANT_OF = {"ELi1ELb": "D", "ELi2ELb": "E", "ELi3ELb": "F/J sym",
              "ELi4ELb": "F/J sym2"}


def sass_report(lib_path):
    """Per kernel of the built library's SASS: HGMMA / IGMMA counts (tf32
    ones as HGMMA.TF32), FFMA counts of kernel A, and the counts of every
    integer min/max opcode (the DPX ones included)."""
    from knn_for_homology_tpu_torch.ops import _build

    cuobjdump = Path(_build._nvcc()).parent / "cuobjdump"
    out = subprocess.run([str(cuobjdump), "-sass", str(lib_path)],
                         capture_output=True, text=True, check=True).stdout
    counts, fn = {}, None
    for line in out.splitlines():
        m = re.search(r"Function : (\S+)", line)
        if m:
            fn = m.group(1)
            continue
        m = re.search(r"\*/\s+(?:@!?P\w+\s+)?([A-Z][A-Za-z0-9_.]*)", line)
        if not (fn and m):
            continue
        op = m.group(1)
        key = op.split(".")[0] if "GMMA" in op else op
        if key == "HGMMA" and "TF32" in op:
            key = "HGMMA.TF32"
        if key == "FFMA" and "flat_topk" not in fn:
            continue
        if key in ("HGMMA", "HGMMA.TF32", "IGMMA", "FFMA") or "MNMX" in op:
            c = counts.setdefault(fn, {})
            c[key] = c.get(key, 0) + 1
    for fn, c in sorted(counts.items()):
        label = next((v for k, v in VARIANT_OF.items() if k in fn), "")
        print(f"sass {fn} {label}: {c}", flush=True)
    return counts


def device_ms(fn, reps=10):
    """{kernel name: device ms per call} under torch.profiler, after a
    warm-up call."""
    import torch
    from torch.autograd import DeviceType

    fn()
    torch.cuda.synchronize()
    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    return {ev.key[:70]: ev.self_device_time_total / 1e3 / reps
            for ev in prof.key_averages()
            if ev.device_type == DeviceType.CUDA and ev.self_device_time_total}


def ffn_inputs(seed, t, d, f):
    import numpy as np
    import torch

    rng = np.random.RandomState(seed)

    def bf(*shape, scale=1.0):
        return torch.from_numpy((rng.randn(*shape) * scale).astype(
            np.float32)).to("cuda", torch.bfloat16)

    return (bf(t, d, scale=2.0), bf(d) + 1.0, bf(d, f, scale=d**-0.5),
            bf(f, d, scale=f**-0.5))


def check_bf16(name, got, want):
    import torch

    err = float((got.float() - want.float()).abs().max())
    scale = float(want.float().abs().max())
    ok = bool(torch.isfinite(got.float()).all()) and err <= BF16_TOL * scale
    print(f"{name}: max_abs_err {err:.4g} of {scale:.4g}"
          f" {'ok' if ok else 'MISMATCH'}", flush=True)
    return ok


def main():
    p = argparse.ArgumentParser()
    p.add_argument("--no-ptxas", action="store_true")
    p.add_argument("--no-times", action="store_true")
    args = p.parse_args()

    import numpy as np
    import torch

    if not torch.cuda.is_available():
        raise SystemExit("needs a CUDA device")
    from knn_for_homology_tpu_torch.ops import (
        _build,
        ffn_cuda,
        ivf_cuda,
        packed_cuda,
        slab_cuda,
    )
    from knn_for_homology_tpu_torch.ops.ffn import fused_ffn_plain

    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True).stdout.strip()
    print(f"card: {card} | torch {torch.__version__} cuda {torch.version.cuda}",
          flush=True)
    if not args.no_ptxas:
        ptxas_report()
    print(f"build {_build.timed_build():.1f} s", flush=True)
    sass = sass_report(_build.library_path())
    assert any("gemm_kernel" in fn and "HGMMA" in c for fn, c in sass.items())
    for key, op in (("ELi1ELb", "HGMMA"), ("ELi2ELb", "HGMMA"),
                    ("ELi3ELb", "IGMMA"), ("ELi4ELb", "IGMMA")):
        assert any("segment_packed_mma" in fn and key in fn and op in c
                   for fn, c in sass.items()), (key, op)
    assert any("segment_topr" in fn and "HGMMA.TF32" in c
               for fn, c in sass.items()), "no tf32 wgmma in kernel B"
    k_fns = [fn for fn in sass if "slab_expandI" in fn]  # not slab_tiles
    assert len(k_fns) == 4 and all("HGMMA.TF32" in sass[fn] for fn in k_fns), (
        "K's four expansion kernels, each with tf32 wgmma")
    assert any("flat_topk_partial" in fn and c.get("FFMA", 0) > 0
               for fn, c in sass.items()), "no FFMA in kernel A"
    dpx = {op: n for fn, c in sass.items() if "sw_wavefront" in fn
           for op, n in c.items() if op.startswith("VI")}
    print(f"sass sw_wavefront DPX: {dpx}", flush=True)
    assert dpx, "no DPX instruction in kernel C's SASS"

    ok = True
    for t, d, f in ((1, 128, 256), (65, 256, 384), (129, 1024, 512),
                    (300, 512, 640), (7000, 1024, 16384)):
        x, ln, wi, wo = ffn_inputs(0, t, d, f)
        want = fused_ffn_plain(x, ln, wi, wo)
        ok &= check_bf16(f"G T={t} D={d} F={f}", ffn_cuda.fused_ffn_t5(
            x, ln, wi, wo), want)

    rng = np.random.RandomState(1)

    def i8(*shape, lo=-127, hi=128):
        return torch.from_numpy(rng.randint(lo, hi, size=shape).astype(
            np.int8)).to("cuda")

    # at d = 48 plan_for keeps the query rows resident: 32-lane tiles at
    # R <= 9, 16-lane at R = 30 (the slots of 32 lanes crowd out the ring);
    # the card tests reach the streamed 64-lane route (d = 2048, R >= 35)
    for q_n, storage, r in ((1, "sq8-sym", 7), (65, "sq8-sym2", 9),
                            (300, "sq8-sym", 30), (700, "sq8-sym2", 4),
                            (2200, "sq8-sym", 7), (2200, "sq8-sym2", 9),
                            (2200, "sq8-sym2", 30)):
        db = i8(5000, 48)
        sc = torch.from_numpy(rng.uniform(1e-3, 1e-2, 5000).astype(
            np.float32)).to("cuda")
        q = i8(q_n, 48)
        lo = i8(q_n, 48, lo=-64, hi=65) if storage == "sq8-sym2" else None
        a = (q, db, 256, r, "ip", storage, sc, lo)
        same = torch.equal(packed_cuda.segment_packed_kernel(*a),
                           packed_cuda.segment_packed_plain(*a))
        print(f"F {storage} Q={q_n} R={r}: {'equal' if same else 'MISMATCH'}",
              flush=True)
        ok &= same
    # D (bf16) and E on bf16 wgmma: resident rows at d = 48, streamed
    # 64-lane tiles with slots in device memory at d = 1024, R = 30
    for q_n, storage, metric, d, r in ((1, "bf16", "ip", 48, 7),
                                       (65, "sq8", "l2", 48, 7),
                                       (700, "bf16", "l2", 1024, 30),
                                       (2200, "sq8", "ip", 1024, 7),
                                       (300, "sq8", "l2", 1024, 30)):
        db = i8(5000, d, lo=-3, hi=4)
        q = i8(q_n, d, lo=-3, hi=4).to(torch.bfloat16)
        if storage == "bf16":
            a = (q, db.to(torch.bfloat16), 256, r, metric, "native")
        else:
            sc = torch.from_numpy(rng.uniform(1e-3, 1e-2, 5000).astype(
                np.float32)).to("cuda")
            a = (q, i8(5000, d), 256, r, metric, "sq8", sc)
        same = torch.equal(packed_cuda.segment_packed_kernel(*a),
                           packed_cuda.segment_packed_plain(*a))
        print(f"{'D' if storage == 'bf16' else 'E'} {metric} Q={q_n} d={d}"
              f" R={r}: {'equal' if same else 'MISMATCH'}", flush=True)
        ok &= same
    if not ok:
        raise SystemExit("mismatch")
    if args.no_times:
        print("probe ok")
        return

    # A and B at phase 3's shapes: 1024 (A, k = 13) and 512 (B, W = 256,
    # R = 16) queries against 131072 x 1024 normalised rows
    from knn_for_homology_tpu_torch.ops import exact_cuda, flat_cuda

    gen = torch.Generator("cuda").manual_seed(4)
    db = torch.nn.functional.normalize(
        torch.randn(131072, 1024, device="cuda", generator=gen), dim=1)
    qf = torch.nn.functional.normalize(
        torch.randn(1024, 1024, device="cuda", generator=gen), dim=1)
    mm = cuda_ms(lambda: torch.matmul(qf, db.T))
    for name, q_n, fn, peak in (
            ("A", 1024, lambda: flat_cuda.flat_topk_kernel(db, qf, 13),
             "fp32"),
            ("B", 512, lambda: exact_cuda.segment_topr_kernel(
                db, qf[:512].contiguous(), 256, 16, "cosine"), "tf32")):
        ms = cuda_ms(fn)
        flop = 2 * q_n * 131072 * 1024
        ops = flop * (3 if peak == "tf32" else 1)
        print(json.dumps(dict(
            kernel=name, queries=q_n, ms=ms, tflops=flop / ms / 1e9,
            peak_share=ops / (ms * 1e-3) / PEAK_OPS[peak], product=peak,
            matmul_fp32_1024q_ms=mm, device=device_ms(fn))), flush=True)
    del db, qf

    # G at the encoder's batch: T 7000 x 1024 x 16384
    t, d, f = 7000, 1024, 16384
    x, ln, wi, wo = ffn_inputs(2, t, d, f)
    flop = 4 * t * d * f
    g_ms = cuda_ms(lambda: ffn_cuda.fused_ffn_t5(x, ln, wi, wo))

    def two_matmuls():
        return torch.relu(x @ wi) @ wo

    lib_ms = cuda_ms(two_matmuls)
    print(json.dumps(dict(
        kernel="G", shape=[t, d, f], ms=g_ms,
        tflops=flop / g_ms / 1e9,
        peak_share=flop / (g_ms * 1e-3) / PEAK_OPS["bf16"],
        two_matmul_ms=lib_ms,
        device=device_ms(lambda: ffn_cuda.fused_ffn_t5(x, ln, wi, wo)),
        device_two_matmul=device_ms(two_matmuls))), flush=True)
    del x, ln, wi, wo

    # F at phase 3's shape and at 8192 queries: 131072 x 1024 db, W = 256
    n = 131072
    db = i8(n, 1024)
    sc = torch.from_numpy(rng.uniform(1e-3, 1e-2, n).astype(np.float32)).to(
        "cuda")
    # D (bf16) and E at phase 3's shape: 1024 queries, W = 256, R = 7
    qb = torch.randn(1024, 1024, device="cuda").to(torch.bfloat16)
    for name, a in (("D", (qb, db.to(torch.bfloat16), 256, 7, "cosine")),
                    ("E", (qb, db, 256, 7, "cosine", "sq8", sc))):
        ms = cuda_ms(lambda: packed_cuda.segment_packed_kernel(*a))
        flop = 2 * 1024 * n * 1024
        print(json.dumps(dict(
            kernel=name, queries=1024, ms=ms, tflops=flop / ms / 1e9,
            peak_share=flop / (ms * 1e-3) / PEAK_OPS["bf16"],
            device=device_ms(lambda: packed_cuda.segment_packed_kernel(*a)))),
            flush=True)
    del qb
    for q_n in (1024, 8192):
        q = i8(q_n, 1024)
        lo = i8(q_n, 1024, lo=-64, hi=65)
        row = dict(kernel="F", queries=q_n)
        for storage, r in (("sq8-sym", 7), ("sq8-sym2", 9)):
            a = (q, db, 256, r, "ip", storage, sc,
                 lo if storage == "sq8-sym2" else None)
            row[storage] = cuda_ms(
                lambda: packed_cuda.segment_packed_kernel(*a))
        row["int_mm_ms"] = cuda_ms(lambda: torch._int_mm(q, db.t()))
        row["tops_sym"] = 2 * q_n * n * 1024 / row["sq8-sym"] / 1e9
        print(json.dumps(row), flush=True)
    del db

    # J at phase 3's shape (1024 queries, 256 of 2048 cells) and at a
    # phase-9 block (4096 queries, all 2048 cells, sym2)
    gen = torch.Generator("cuda").manual_seed(3)
    vecs = torch.randn(2048 * 64, 1024, device="cuda", generator=gen)
    members = torch.full((2048, 128), -1, dtype=torch.int32, device="cuda")
    members[:, :64] = torch.randperm(2048 * 64, device="cuda", generator=gen
                                     ).view(2048, 64).to(torch.int32)
    pv, pi, psc = slab_cuda.pack_neighbours(vecs, members, 128)
    qf = torch.randn(4096, 1024, device="cuda", generator=gen)
    for q_n, budget, compute in ((1024, 256, "sym"), (1024, 256, "sym2"),
                                 (4096, 2048, "sym2")):
        cells = torch.randperm(2048, device="cuda", generator=gen)[:budget].to(
            torch.int32)
        tile, r, _ = ivf_cuda.union_plan(budget, 1000, 0.995)
        q8, q_lo, _ = packed_cuda.quantize_queries(qf[:q_n], compute == "sym2")
        a = (q8, pv, psc, pi, cells, tile, r, q_lo)
        same = torch.equal(ivf_cuda.segment_packed_indirect_kernel(*a),
                           ivf_cuda.segment_packed_indirect_plain(*a))
        ok &= same
        ms = cuda_ms(lambda: ivf_cuda.segment_packed_indirect_kernel(*a))
        print(json.dumps(dict(kernel="J", queries=q_n, cells=budget,
                              compute=compute, W=tile, R=r, equal=same, ms=ms,
                              tops=2 * q_n * budget * 128 * 1024 / ms / 1e9)),
              flush=True)
    if not ok:
        raise SystemExit("mismatch")
    print("probe ok")


if __name__ == "__main__":
    main()
