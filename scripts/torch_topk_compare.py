#!/usr/bin/env python3
"""Kernels A and B of one checkout of the PyTorch port, on one NVIDIA GPU,
at the shapes of chip_smoke.py's phases 3, 5, 7 and 9, so that two
checkouts (a parent and its change) can be timed in turns in one call:

    python3 scripts/torch_topk_compare.py --root <checkout> [--label L]

  * phase 3: A at 1024 queries, k = 13, and B at 512 queries of the exact
    k = 1000 plan (W = 256, R = 16), against chip_smoke.py's 131072 x 1024
    clustered train vectors (seed 0, l2-normalised): chip_smoke.cuda_ms;
  * phase 5: FlatIndex.search of the first 1024 test vectors at k = 1000
    (the exact path: B and its epilogue), host wall after a warm call;
  * phase 7: the bench's exact mode alone (bench.run, --modes exact,
    min of 2), queries/s;
  * phase 9: pipelines.pfam_proteins.build_and_search, the flat index,
    all 131072 train vectors against all at k = 1001 (the pipeline's
    k + 1), search seconds after a warm call.

The checkout's package and chip_smoke.py are imported from --root (each
builds its own kernels there), so the parent's code runs as it was. Prints
the card (nvidia-smi name, power limit) and one JSON line.
"""

import argparse
import json
import sys
import time
from pathlib import Path


def train_test(seed=0, n_fam=4096, per_train=32, dim=1024):
    """chip_smoke.py's write_dataset vectors (the same draws in the same
    order): family centroids x10 plus unit Gaussian noise."""
    import numpy as np

    rng = np.random.RandomState(seed)
    centroids = rng.randn(n_fam, dim).astype(np.float32) * 10.0
    fam_of_train = np.repeat(np.arange(n_fam), per_train)
    train = centroids[fam_of_train] + rng.randn(
        n_fam * per_train, dim).astype(np.float32)
    test = centroids + rng.randn(n_fam, dim).astype(np.float32)
    return train, test


def main():
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--root", type=Path,
                   default=Path(__file__).resolve().parent.parent)
    p.add_argument("--label", default="")
    args = p.parse_args()
    sys.path.insert(0, str(args.root.resolve()))

    import torch

    if not torch.cuda.is_available():
        raise SystemExit("needs a CUDA device")
    from chip_smoke import card_line, cuda_ms, warm_card
    from knn_for_homology_tpu_torch import bench
    from knn_for_homology_tpu_torch.ops import _build, exact_cuda, flat_cuda
    from knn_for_homology_tpu_torch.ops.distance import l2_normalize
    from knn_for_homology_tpu_torch.pipelines.pfam_proteins import (
        build_and_search,
    )
    from knn_for_homology_tpu_torch.search.flat import FlatIndex

    _build.library()
    train, test = train_test()
    db = l2_normalize(torch.from_numpy(train).cuda()).contiguous()
    q_all = l2_normalize(torch.from_numpy(test).cuda()).contiguous()
    out = dict(label=args.label, root=str(args.root), card=card_line())
    warm_card()

    # phase 3
    q = q_all[:1024].contiguous()
    out["A_ms"] = cuda_ms(lambda: flat_cuda.flat_topk_kernel(db, q, 13,
                                                              "cosine"))
    q = q_all[:512].contiguous()
    w, r = exact_cuda.plan(131072, 1000, exact_cuda.default_db_tile(1000))
    out["B_ms"] = cuda_ms(lambda: exact_cuda.segment_topr_kernel(
        db, q, w, r, "cosine"))
    del db, q_all, q

    # phase 5
    index = FlatIndex(device="cuda").add(train)
    qk = test[:1024]
    index.search(qk, 1000)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    index.search(qk, 1000)
    torch.cuda.synchronize()
    out["exact_k1000_1024q_s"] = time.perf_counter() - t0
    del index
    torch.cuda.empty_cache()

    # phase 7
    result = bench.run(bench.parse_args(
        ["--modes", "exact", "--reps", "2", "--hi-recall-target", "0"]))
    out["bench_exact_qps"] = result["exact_qps"]
    torch.cuda.empty_cache()

    # phase 9
    build_and_search(train, "flat", k=1001, device="cuda")
    out["flat_search_s"] = build_and_search(
        train, "flat", k=1001, device="cuda")["search_seconds"]
    print(json.dumps(out), flush=True)


if __name__ == "__main__":
    main()
