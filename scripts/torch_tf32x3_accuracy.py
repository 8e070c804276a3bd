#!/usr/bin/env python3
"""How close the port's two fp32 products come to fp64 and to the plain
fp32 route, on one NVIDIA GPU: kernel B's 3xTF32 wgmma product
(csrc/tf32x3.cuh) and kernel A's FFMA product, on the inputs of the card
test test_kernel_a_gaussian[ip] and [l2] (d = 100 Gaussian rows, inner
products up to 57, l2 scores near -200; the test holds A within 1e-5 and
1e-3 of the plain route, and test_kernel_b_gaussian holds B to fp64) and
on normalised Gaussian rows at d = 1024 (the cosine regime of the main
path).

    python3 scripts/torch_tf32x3_accuracy.py

For each case, the top-13 scores of every query: B's (its candidate
buffers through exact_cuda.epilogue, k = 13 <= R, so exact), A's and the
plain route's (flat_topk_plain, the fp32 matmul with TF32 off), each
against the fp64 similarity of its own ids, and B's and A's against the plain
route's scores. Prints the card and one JSON line per case.
"""

import json
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))


def errors(vals, ids, exact):
    """max |score - fp64 similarity of its id| over the [Q, k] result."""
    return float((vals.double() - exact.gather(1, ids.long())).abs().max())


def main():
    import numpy as np
    import torch

    if not torch.cuda.is_available():
        raise SystemExit("needs a CUDA device")
    from chip_smoke import card_line
    from knn_for_homology_tpu_torch.ops import exact_cuda, flat_cuda
    from knn_for_homology_tpu_torch.ops.distance import similarity_block

    print(card_line(), flush=True)
    for name, seed, n, q_n, d, metric in (
            ("test_kernel_a_gaussian[ip]", 2, 20000, 130, 100, "ip"),
            ("test_kernel_a_gaussian[l2]", 2, 20000, 130, 100, "l2"),
            ("cosine d=1024", 6, 20000, 130, 1024, "cosine")):
        rng = np.random.RandomState(seed)
        db = torch.from_numpy(rng.randn(n, d).astype(np.float32)).cuda()
        qs = torch.from_numpy(rng.randn(q_n, d).astype(np.float32)).cuda()
        if metric == "cosine":
            db = torch.nn.functional.normalize(db, dim=1)
            qs = torch.nn.functional.normalize(qs, dim=1)
        exact = similarity_block(qs.double(), db.double(), metric)
        w, r, k = 256, 16, 13
        bv, bi, _ = exact_cuda.epilogue(
            *exact_cuda.segment_topr_kernel(db, qs, w, r, metric), k, w, r)
        av, ai = flat_cuda.flat_topk_kernel(db, qs, k, metric)
        pv, pi = flat_cuda.flat_topk_plain(db, qs, k, metric)
        print(json.dumps(dict(
            case=name, top=float(pv.abs().max()),
            tf32x3_vs_fp64=errors(bv, bi, exact),
            ffma_vs_fp64=errors(av, ai, exact),
            plain_vs_fp64=errors(pv, pi, exact),
            tf32x3_vs_plain=float((bv - pv).abs().max()),
            ffma_vs_plain=float((av - pv).abs().max()),
        )), flush=True)


if __name__ == "__main__":
    main()
