"""Kernel L (csrc/flash_xlnet.cu) on the card: what ptxas says of it, its
answer against the plain version at ProtXLNet's published shape, and its
time beside the plain version's, SDPA's (no position term: a yardstick the
port never calls) and its bound; then one ProtXLNet encode of 2 x 3098
tokens through the fused route (bf16, kernel L) and the fp32 plain route.

    python3 scripts/torch_relattn_probe.py [--out <file.json>]
"""

import argparse
import dataclasses
import json
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

from knn_for_homology_tpu_torch.models import xlnet  # noqa: E402
from knn_for_homology_tpu_torch.ops import _build, relattn_cuda  # noqa: E402
from knn_for_homology_tpu_torch.ops.relative_attention import (  # noqa: E402
    relative_attention_plain,
)


def ptxas() -> str:
    src = ROOT / "knn_for_homology_tpu_torch" / "csrc" / "flash_xlnet.cu"
    out = subprocess.run(
        [_build._nvcc(), *_build.NVCC_FLAGS, "-Xptxas", "-v", "-c", str(src),
         "-o", "/dev/null"], capture_output=True, text=True)
    return (out.stdout + out.stderr).strip()


def cuda_ms(fn, reps=20) -> float:
    fn()
    torch.cuda.synchronize()
    start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def bound_ms(b, h, l, dh=64) -> float:
    ops = 6 * b * h * l * l * dh
    nbytes = 2 * (4 * b * h * l * dh + 2 * l * h * dh) + b * l
    return 1e3 * max(ops / 989e12, nbytes / 3.35e12)


def main():
    p = argparse.ArgumentParser()
    p.add_argument("--out", default=None, help="also write the results here")
    args = p.parse_args()
    dev = torch.device("cuda")
    res = {"card": torch.cuda.get_device_name(0), "torch": torch.__version__}
    print(res, flush=True)
    print(ptxas(), flush=True)
    res["build_s"] = _build.timed_build()
    b, h, l = 2, 16, 3098
    rng = np.random.RandomState(0)

    def bf16(*shape, scale=1.0):
        return torch.from_numpy((rng.randn(*shape) * scale).astype(
            np.float32)).to(device=dev, dtype=torch.bfloat16)

    q, k, v = (bf16(b, h, l, 64) for _ in range(3))
    r = bf16(2 * l, 30 * h * 64)[:, :h * 64].view(2 * l, h, 64)
    r_w, r_r = bf16(h, 64, scale=0.5), bf16(h, 64, scale=0.5)
    mask = torch.ones(b, l, dtype=torch.bool, device=dev)
    mask[1, 2000:] = False
    got = relattn_cuda.relative_attention(q, k, v, r, r_w, r_r, mask)
    torch.cuda.synchronize()
    want = relative_attention_plain(q, k, v, r, r_w, r_r, mask, block=64)
    res["max_err_over_max"] = float((got.float() - want.float()).abs().max()
                                    / want.float().abs().max())
    print("kernel L vs plain:", res["max_err_over_max"], flush=True)
    res["kernel_ms"] = cuda_ms(
        lambda: relattn_cuda.relative_attention(q, k, v, r, r_w, r_r, mask))
    res["plain_ms"] = cuda_ms(
        lambda: relative_attention_plain(q, k, v, r, r_w, r_r, mask), reps=3)
    res["sdpa_ms"] = cuda_ms(
        lambda: torch.nn.functional.scaled_dot_product_attention(q, k, v))
    res["bound_ms"] = bound_ms(b, h, l)
    print({k_: res[k_] for k_ in ("kernel_ms", "plain_ms", "sdpa_ms",
                                  "bound_ms")}, flush=True)

    config = dataclasses.replace(xlnet.PROTXLNET, dtype=torch.bfloat16)
    params = xlnet.init_params(config, seed=1, device=dev)
    enc = xlnet.XLNetEncoder(config, params)
    ids = torch.randint(7, 27, (b, l), device=dev)
    ids[:, -2:] = torch.tensor([xlnet.XLNET_SEP, xlnet.XLNET_CLS])
    full = torch.ones(b, l, dtype=torch.bool, device=dev)
    enc(ids, full)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    launches = relattn_cuda.relative_attention.launches
    t0 = time.perf_counter()
    enc(ids, full)
    torch.cuda.synchronize()
    res["encode_fused_s"] = time.perf_counter() - t0
    res["encode_fused_peak_above_weights_gib"] = (
        torch.cuda.max_memory_allocated() - base) / 2**30
    res["encode_launches"] = relattn_cuda.relative_attention.launches - launches
    res["encode_fused_ms_events"] = cuda_ms(lambda: enc(ids, full), reps=3)
    del enc
    plain_cfg = dataclasses.replace(xlnet.PROTXLNET, use_kernel=False)
    enc32 = xlnet.XLNetEncoder(plain_cfg, {
        "embedding": params["embedding"].float(),
        "layers": [{n: t.float() for n, t in p_.items()}
                   for p_ in params["layers"]]})
    del params
    res["encode_plain_fp32_ms_events"] = cuda_ms(lambda: enc32(ids, full),
                                                 reps=2)
    print({k_: v_ for k_, v_ in res.items() if k_.startswith("encode")},
          flush=True)
    if args.out:
        Path(args.out).parent.mkdir(parents=True, exist_ok=True)
        Path(args.out).write_text(json.dumps(res, indent=1))


if __name__ == "__main__":
    main()
