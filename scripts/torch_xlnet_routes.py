"""ProtXLNet's two routes on the card, on protxlnet.long's calls: the
served route (bf16, kernel L) and the plain route (fp32, `use_kernel=False`:
dense content and position scores, the reshape shift), each over the same
calls of 32 proteins (uniform on 1025-3096 aa), as residues a second of
`XLNetEmbedder.embed_pooled` alone. A yardstick, not a cell.

    python3 scripts/torch_xlnet_routes.py [--seed 1] [--calls 3]
        [--out <file.json>]
"""

import argparse
import dataclasses
import json
import sys
import time
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

from portbench.drivers.embed_xlnet import (  # noqa: E402
    xlnet_config,
    xlnet_weights,
)
from portbench.lib import harness, traffic  # noqa: E402


def main():
    p = argparse.ArgumentParser()
    p.add_argument("--seed", type=int, default=1)
    p.add_argument("--calls", type=int, default=3)
    p.add_argument("--out", default=None, help="also write the results here")
    args = p.parse_args()
    from knn_for_homology_tpu_torch.models.registry import XLNetEmbedder

    dev = torch.device("cuda")
    cfg = harness.load_json(harness.BENCH_DIR / "configs" / "protxlnet.json")
    cell = harness.load_json(harness.BENCH_DIR / "cells" /
                             "protxlnet.long.json")
    lengths = traffic.lengths_of(cell["lengths"])
    gen = traffic.rng(args.seed, 4)
    calls = [traffic.random_sequences(gen, gen.permutation(lengths))
             for _ in range(args.calls)]
    weights = xlnet_weights(cfg, args.seed, dev)
    served = xlnet_config(cfg)
    routes = {
        "bf16_kernel_l": (served, weights),
        "fp32_plain": (dataclasses.replace(served, dtype=torch.float32,
                                           use_kernel=False), None),
    }
    res = {"card": torch.cuda.get_device_name(0), "seed": args.seed,
           "residues_a_call": int(sum(lengths))}
    for name, (config, params) in routes.items():
        if params is None:  # the fp32 route's weights: the bf16 ones widened
            params = {"embedding": weights["embedding"].float(),
                      "layers": [{k: v.float() for k, v in layer.items()}
                                 for layer in weights["layers"]]}
        emb = XLNetEmbedder(config=config, params=params,
                            token_budget=cell["token_budget"],
                            max_len=cell["max_len"], device=dev)
        emb.embed_pooled(calls[0])  # warm
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        for seqs in calls:
            emb.embed_pooled(seqs)
        seconds = time.perf_counter() - t0
        res[name] = {"residues_per_s": args.calls * int(sum(lengths)) / seconds,
                     "peak_gib": torch.cuda.max_memory_allocated() / 2**30}
        print(name, res[name], flush=True)
        del emb, params
        torch.cuda.empty_cache()
    if args.out:
        Path(args.out).parent.mkdir(parents=True, exist_ok=True)
        Path(args.out).write_text(json.dumps(res, indent=1))


if __name__ == "__main__":
    main()
