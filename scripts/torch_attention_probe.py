#!/usr/bin/env python3
"""Kernels H and I of the PyTorch port (csrc/flash_t5.cu, csrc/short_t5.cu)
on one NVIDIA GPU: what ptxas reports for them, each against its plain
version at the ragged edges of their tiles, and their times beside
scaled_dot_product_attention at the encoder's shapes.

    python3 scripts/torch_attention_probe.py [--no-ptxas] [--no-times]

Checks use chip_smoke.py's BF16_TOL (2^-6 of the plain version's largest
value); times are chip_smoke.py's cuda_ms, the median of 5 windows of 10
calls (CUDA events, one warm-up). Exits non-zero on any mismatch.
"""

import argparse
import json
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))

from chip_smoke import BF16_TOL, cuda_ms  # noqa: E402

H_SHAPES = [(1, 2, 1), (2, 3, 65), (3, 2, 127), (2, 2, 129), (2, 2, 1025),
            (2, 32, 3200)]
I_SHAPES = [(1, 2, 1), (2, 3, 63), (2, 2, 64), (3, 2, 65), (2, 2, 127),
            (2, 2, 128), (2, 2, 129), (3, 2, 512), (13, 32, 512),
            (27, 32, 256), (3, 2, 1000), (2, 2, 1023), (8, 32, 896),
            (6, 32, 1024)]
TIMED = [("H", 2, 3200, [3097, 2601]),
         ("I", 13, 512, [512 - 29 * i for i in range(13)]),
         ("I", 27, 256, [256 - 7 * i for i in range(27)]),
         ("I", 6, 1024, [1024 - 37 * i for i in range(6)])]


KERNELS = {"ILi2ELb0": "H", "ILi1ELb1": "I"}  # mangled template arguments


def ptxas_report():
    """ptxas -v of the two attention units, compiled side by side."""
    from knn_for_homology_tpu_torch.ops import _build

    nvcc = _build._nvcc()
    procs = [
        subprocess.Popen(
            [nvcc, *_build.NVCC_FLAGS, "-Xptxas", "-v", "-c",
             str(_build.CSRC / name), "-o", "/dev/null"],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        for name in ("flash_t5.cu", "short_t5.cu")
    ]
    for proc in procs:
        out, _ = proc.communicate()
        kernel = ""
        for line in out.splitlines():
            if "registers" in line or "spill" in line or "error" in line \
                    or "Compiling entry" in line or "warning" in line \
                    or "C75" in line:
                kernel = next((v for k, v in KERNELS.items() if k in line),
                              kernel)
                print(f"ptxas {kernel}:", line.strip(), flush=True)
        assert proc.returncode == 0, out


def device_ms(fn, reps=10):
    """Device time per call under torch.profiler: the sum of the device
    events of `reps` calls (after one warm-up), over `reps`."""
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
    total = sum(ev.self_device_time_total for ev in prof.key_averages()
                if ev.device_type == DeviceType.CUDA)
    return total / 1e3 / reps


def inputs(seed, b, h, l, lengths=None):
    import numpy as np
    import torch

    rng = np.random.RandomState(seed)
    q, k, v = (torch.from_numpy((rng.randn(b, h, l, 128) * 0.3).astype(
        np.float32)).to("cuda", torch.bfloat16) for _ in range(3))
    if lengths is None:
        lengths = [max(1, l - 7 * r - 3) for r in range(b)]
        if b > 1:
            lengths[-1] = 0  # a row with every key masked
    mask = torch.arange(l)[None, :] < torch.tensor(lengths)[:, None]
    rel = torch.from_numpy(rng.randn(32, h).astype(np.float32)).to(
        "cuda", torch.bfloat16)
    return q, k, v, mask.to("cuda"), rel


def check(name, got, want, b, all_masked):
    import torch

    assert bool(torch.isfinite(got.float()).all()), f"{name}: not finite"
    err = float((got.float() - want.float()).abs().max())
    scale = float(want.float().abs().max())
    ok = err <= BF16_TOL * max(scale, 1e-6)
    extra = ""
    if all_masked is not None and b > 1:
        row = got[-1].float()
        gap = float((row - all_masked).abs().max())
        extra = f", all-masked row off by {gap:.3g}"
        ok = ok and gap <= BF16_TOL * max(float(all_masked.abs().max()), 1e-6)
    print(f"{name}: max_abs_err {err:.4g} of {scale:.4g}{extra}"
          f" {'ok' if ok else 'MISMATCH'}", flush=True)
    return ok


def main():
    p = argparse.ArgumentParser()
    p.add_argument("--no-ptxas", action="store_true")
    p.add_argument("--no-times", action="store_true")
    args = p.parse_args()

    import torch
    import torch.nn.functional as F

    if not torch.cuda.is_available():
        raise SystemExit("needs a CUDA device")
    from knn_for_homology_tpu_torch.models.t5 import offset_bias_table
    from knn_for_homology_tpu_torch.ops import _build, flash_cuda, short_cuda
    from knn_for_homology_tpu_torch.ops.flash_attention import (
        flash_attention_plain,
    )
    from knn_for_homology_tpu_torch.ops.short_attention import (
        short_attention_plain,
    )

    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True).stdout.strip()
    print(f"card: {card} | torch {torch.__version__} cuda {torch.version.cuda}",
          flush=True)
    if not args.no_ptxas:
        ptxas_report()
    print(f"build {_build.timed_build():.1f} s", flush=True)
    print(f"blocks per SM: H {flash_cuda.blocks_per_sm(3200)} (L = 3200),"
          f" I {short_cuda.blocks_per_sm(512)} (L = 512),"
          f" {short_cuda.blocks_per_sm(1024)} (L = 1024)", flush=True)

    ok = True
    for b, h, l in H_SHAPES:
        q, k, v, mask, rel = inputs(1, b, h, l)
        table = offset_bias_table(rel, l, 32, 128)
        got = flash_cuda.flash_attention_t5(q, k, v, mask, table)
        torch.cuda.synchronize()
        want = flash_attention_plain(q, k, v, mask, table, block=512)
        ok &= check(f"H b={b} h={h} l={l}", got, want, b,
                    torch.zeros_like(got[-1].float()))
    for b, h, l in I_SHAPES:
        q, k, v, mask, rel = inputs(2, b, h, l)
        table = offset_bias_table(rel, l, 32, 128)
        got = short_cuda.short_attention_t5(q, k, v, mask, table)
        torch.cuda.synchronize()
        want = short_attention_plain(q, k, v, mask, table)
        mean_v = v[-1].float().mean(dim=1, keepdim=True).expand_as(got[-1])
        ok &= check(f"I b={b} h={h} l={l}", got, want, b, mean_v)

    if not args.no_times:
        for key, b, l, lengths in TIMED:
            q, k, v, mask, rel = inputs(3, b, 32, l, lengths)
            table = offset_bias_table(rel, l, 32, 128)
            fn = (flash_cuda.flash_attention_t5 if key == "H"
                  else short_cuda.short_attention_t5)
            pos = torch.arange(l, device="cuda")
            dense = table[:, pos[None, :] - pos[:, None] + l - 1]
            attn = (dense[None] + torch.where(mask, 0.0, -1e9)[:, None, None, :]
                    ).to(torch.bfloat16)
            ms = cuda_ms(lambda: fn(q, k, v, mask, table))
            sdpa = cuda_ms(lambda: F.scaled_dot_product_attention(
                q, k, v, attn_mask=attn, scale=1.0))
            ms2 = cuda_ms(lambda: fn(q, k, v, mask, table))
            dev = device_ms(lambda: fn(q, k, v, mask, table))
            sdpa_dev = device_ms(lambda: F.scaled_dot_product_attention(
                q, k, v, attn_mask=attn, scale=1.0))
            flop = 4 * b * 32 * l * l * 128
            print(json.dumps(dict(kernel=key, b=b, l=l, ms=[ms, ms2],
                                  device_ms=dev, sdpa_ms=sdpa,
                                  sdpa_device_ms=sdpa_dev,
                                  tflops=flop / min(ms, ms2) / 1e9)),
                  flush=True)
    if not ok:
        raise SystemExit("mismatch")
    print("probe ok")


if __name__ == "__main__":
    main()
