#!/usr/bin/env python3
"""How far a one-ulp change of the weights moves each encoder family's
pooled vector, by protein length, at the published shapes with the seeded
random weights chip_smoke.py's phase 11 draws (models/*.init_params).

    python3 scripts/torch_recurrence_drift.py [--device cpu|cuda] [KEY ...]

Every weight is multiplied by 1 ± 2^-23 (a random sign each), which is the
size of the difference between two fp32 devices that sum the same products
in other orders. For each registry key and each length, one random protein
is pooled with both weight sets and the relative L2 distance of the two
vectors is printed: a stable encoder keeps it near 1e-6 at every length; a
chaotic recurrence grows it with the length. This is why phase 11 holds
SeqVec and UniRep, card against CPU, on short proteins only.
"""

import argparse
import json
import sys
import time
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))

LENGTHS = (4, 8, 12, 16, 24, 32, 64)


def perturbed(tree, gen, eps=2.0**-23):
    import torch

    if isinstance(tree, dict):
        return {k: perturbed(v, gen, eps) for k, v in tree.items()}
    if isinstance(tree, list):
        return [perturbed(v, gen, eps) for v in tree]
    sign = torch.sign(torch.randn(tree.shape, generator=gen, device="cpu"))
    return tree * (1 + eps * sign.to(tree.device))


def main() -> None:
    import torch

    import chip_smoke
    from knn_for_homology_tpu_torch import models
    from knn_for_homology_tpu_torch.models.registry import get_embedder

    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("keys", nargs="*", default=list(chip_smoke.OTHER_KEYS))
    p.add_argument("--device", default="cpu")
    p.add_argument("--seed", type=int, default=0)
    args = p.parse_args()
    rng = np.random.RandomState(5)
    for key in args.keys:
        mod_name, cfg_name = chip_smoke.OTHER_KEYS[key]
        module = getattr(models, mod_name)
        config = getattr(module, cfg_name)
        t0 = time.perf_counter()
        params = module.init_params(config, seed=args.seed, device=args.device)
        other = perturbed(params, torch.Generator().manual_seed(1))
        a = get_embedder(key, params=params, config=config, device=args.device)
        b = get_embedder(key, params=other, config=config, device=args.device)
        drift = {}
        for n in LENGTHS:
            seq = chip_smoke.AAS[rng.randint(0, 20, n)].tobytes().decode()
            va, vb = a.embed_pooled([seq])[0], b.embed_pooled([seq])[0]
            drift[n] = float(np.linalg.norm(va - vb) / np.linalg.norm(va))
        print(json.dumps({"key": key, "device": args.device,
                          "rel_l2_by_length": drift,
                          "seconds": round(time.perf_counter() - t0, 1)}),
              flush=True)
        del a, b, params, other


if __name__ == "__main__":
    main()
