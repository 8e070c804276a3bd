"""Search batches of new proteins' vectors against a database split
row-wise over a host's cards: each rank holds one shard on its own card,
quantised to int8 once (sq8), and every call runs the program's
db-sharded route to the host, `parallel/sharded.py:shard_topk_to_host`
(kernel F on each shard, one all_gather of the [Q, k] winner sets, one
stable merge, the results copied to rank 0's host by the program).

Rank 0 is the harness's process. Set-up starts the other ranks as
processes of this file (`python3 db_sharded.py --rank r ...`), one card
each; they join one process group (`parallel/mesh.py:process_group`) and
serve every call from a command loop (rank 0 broadcasts the call's
number), so no process starts per call.

Cell keys: "world" (ranks, a card each), "k", "recall_target" (the
plan's), "queries_per_call", "pool_calls" (distinct query batches, drawn
in set-up from every shard's test proteins and cycled), "check_queries"
(the sampled queries the check compares), "units_per_call".
"""

import argparse
import contextlib
import datetime
import json
import os
import signal
import subprocess
import sys
import tempfile
import time
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parents[2]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

from portbench.lib import traffic  # noqa: E402
from portbench.reference import search as ref_search  # noqa: E402

STOP, CALL = 0, 1
# the meeting of the ranks and each collective give up after this long,
# so a rank that died fails the run instead of hanging it
TIMEOUT = datetime.timedelta(seconds=180)


def shard_seed(seed: int, rank: int) -> int:
    """The seed rank `rank`'s shard is drawn from."""
    return int(np.random.SeedSequence([int(seed), 11, rank])
               .generate_state(1)[0])


def shard_rows(cfg: dict) -> int:
    return cfg["families"] * (cfg["train_per_family"]
                              + cfg["test_per_family"])


def shard(cfg: dict, seed: int, rank: int, device) -> dict:
    """Rank `rank`'s shard of the Pfam20 layout: {"all", "test"} vectors
    (traffic.database's, from the shard's own seed)."""
    return traffic.database(cfg, shard_seed(seed, rank), device)


def query_pool(cfg: dict, cell: dict, seed: int, rank: int, world: int,
               test: torch.Tensor) -> torch.Tensor:
    """[pool_calls · queries_per_call, d] fp32 query vectors, the same on
    every rank: each rank draws its share from its shard's test proteins,
    one all_gather joins them, and a seeded permutation orders them."""
    from knn_for_homology_tpu_torch.parallel.mesh import all_gather

    total = cell["pool_calls"] * cell["queries_per_call"]
    share = -(-total // world)
    picks = traffic.rng(seed, 20 + rank).choice(test.shape[0], share,
                                                replace=False)
    mine = test[torch.as_tensor(picks, device=test.device)]
    every = all_gather(mine, None).reshape(world * share, -1)
    order = traffic.rng(seed, 19).permutation(world * share)[:total]
    return every[torch.as_tensor(order, device=test.device)].contiguous()


def make_state(cfg: dict, cell: dict, seed: int, rank: int, world: int,
               device) -> dict:
    """One rank's shard, quantised once, and the query pool, normalised as
    the cosine search normalises them."""
    from knn_for_homology_tpu_torch.ops.distance import l2_normalize
    from knn_for_homology_tpu_torch.ops.packed_cuda import quantize_database

    data = shard(cfg, seed, rank, device)
    pool = query_pool(cfg, cell, seed, rank, world, data["test"])
    db = quantize_database(l2_normalize(data["all"]))
    del data
    q = cell["queries_per_call"]
    return {"db": db, "rank": rank, "world": world, "k": cell["k"],
            "recall_target": cell["recall_target"],
            "rows": shard_rows(cfg),
            "batches": [l2_normalize(pool[i:i + q])
                        for i in range(0, pool.shape[0], q)],
            "pool": pool}


def search(state: dict, i: int):
    """Call i on this rank: the shard's search of batch i (cycled) and the
    merge; rank 0 gets the global (scores, ids) as host arrays, the other
    ranks None."""
    from knn_for_homology_tpu_torch.parallel.sharded import shard_topk_to_host

    q = state["batches"][i % len(state["batches"])]
    n = state["world"] * state["rows"]
    return shard_topk_to_host(state["db"], q, state["k"], state["rank"], n,
                              None, metric="ip", approx=True,
                              storage="sq8-sym",
                              recall_target=state["recall_target"])


def command(state: dict, code: int, i: int) -> None:
    """Rank 0 tells the other ranks what to run next."""
    import torch.distributed as dist

    msg = torch.tensor([code, i], dtype=torch.int64, device=state["msg_dev"])
    dist.broadcast(msg, src=0)


def serve(state: dict) -> None:
    """A rank other than 0: run what rank 0 broadcasts, until it stops."""
    import torch.distributed as dist

    msg = torch.zeros(2, dtype=torch.int64, device=state["msg_dev"])
    while True:
        dist.broadcast(msg, src=0)
        code, i = msg.tolist()
        if code == STOP:
            return
        search(state, i)


def backend_of(device) -> str:
    return "nccl" if torch.device(device).type == "cuda" else "gloo"


def setup(ctx):
    from knn_for_homology_tpu_torch.parallel import sharded
    from knn_for_homology_tpu_torch.parallel.mesh import process_group

    if not hasattr(sharded, "shard_topk_to_host"):
        raise RuntimeError("the program has no db-sharded search to the host")
    cell, cfg, dev = ctx.cell, ctx.config, ctx.device
    world = cell["world"]
    if dev.type == "cuda" and torch.cuda.device_count() < world:
        raise RuntimeError(f"{world} ranks need {world} cards")
    # the store's directory outlives the group: the ranks leave the group
    # after rank 0 has (release), and only then is the directory removed
    stack, group = contextlib.ExitStack(), contextlib.ExitStack()
    tmp = stack.enter_context(tempfile.TemporaryDirectory(prefix="pb_shard_"))
    stack.callback(group.close)
    store = os.path.join(tmp, "store")
    args = {"config": cfg, "cell": cell, "seed": ctx.seed,
            "world": world, "store": store, "device": dev.type}
    ranks = []
    try:
        for rank in range(1, world):
            ranks.append(subprocess.Popen(
                [sys.executable, str(Path(__file__).resolve()),
                 "--rank", str(rank), "--args", json.dumps(args)],
                stdout=sys.stderr.fileno(), stderr=sys.stderr.fileno()))
        group.enter_context(process_group(backend_of(dev), 0, world, store,
                                          timeout=TIMEOUT))
        ctx.mark("ranks")
        state = make_state(cfg, cell, ctx.seed, 0, world, dev)
        state.update(stack=stack, group=group, ranks=ranks, msg_dev=dev,
                     out=[], recorder=ctx.recorder,
                     checked=checked_rows(cell, ctx.seed,
                                          len(state["batches"])))
        ctx.mark("inputs")
        step(state, 0)  # plans and warms the search's shapes on every rank
        state["out"].clear()
    except BaseException:
        for proc in ranks:  # they may wait on this rank: end them
            proc.kill()
        stop_ranks(ranks)
        stack.close()
        raise
    return state


def checked_rows(cell: dict, seed: int, batches: int) -> list:
    """[rows of batch b the check compares] for each query batch: the
    cell's check_queries (batch, row) pairs, drawn from the seed."""
    per = cell["queries_per_call"]
    n = min(cell["check_queries"], batches * per)
    picks = np.sort(traffic.rng(seed, 9).choice(batches * per, n,
                                                replace=False))
    return [picks[(picks >= b * per) & (picks < (b + 1) * per)] - b * per
            for b in range(batches)]


def step(state, i):
    b = i % len(state["batches"])
    with state["recorder"].span("pass"):
        command(state, CALL, i)
        scores, ids = search(state, i)
    rows = state["checked"][b]  # only what the check compares is kept
    state["out"].append((b, scores[rows], ids[rows]))
    return {"units": ids.shape[0], "queries": ids.shape[0]}


def stop_ranks(ranks, timeout=30) -> None:
    """Wait for the ranks' exit, all within one `timeout`; kill the rest
    (their work is done, or rank 0 has failed)."""
    deadline = time.monotonic() + timeout
    for proc in ranks:
        try:
            proc.wait(timeout=max(deadline - time.monotonic(), 0.0))
        except subprocess.TimeoutExpired:
            proc.kill()
            proc.wait()


def release(state):
    """Stop the ranks: rank 0 leaves the group first (an NCCL group's
    teardown may wait for every rank), then waits for their exit."""
    command(state, STOP, 0)
    state["group"].close()
    stop_ranks(state["ranks"])
    out = {"out": state["out"], "pool": state["pool"], "k": state["k"],
           "queries_per_call": len(state["batches"][0]),
           "checked": state["checked"], "world": state["world"]}
    state["stack"].close()
    state.clear()
    return out


@torch.no_grad()
def readings(ctx, out, control=False):
    """miss_share: 1 - recall of the returned ids against the exact top-k
    over every shard's rows under the same int8 quantisation of rows and
    queries (a returned row counts where its quantised score reaches the
    k-th best; ties of any order read as found), over the sampled queries
    of every call that answered them; the recall target bounds it.
    score_abs_err: the widest difference of a returned score from that
    row's quantised score. The control is the exact top-k under int4
    quantisation, judged the same way."""
    dev, k = ctx.device, out["k"]
    if not out["out"]:
        return {"miss_share": float("inf"), "score_abs_err": float("inf")}
    cfg, world = ctx.config, out["world"]
    raw = torch.cat([shard(cfg, ctx.seed, r, dev)["all"]
                     for r in range(world)]).float()
    rows = raw / raw.norm(dim=1, keepdim=True)
    del raw
    per = out["queries_per_call"]
    # the checked queries of the batches the window ran, and every
    # distinct answer the window gave each (judged once)
    ran = sorted({b for b, *_ in out["out"]})
    picks = [(b, int(r)) for b in ran for r in out["checked"][b]]
    index = {pick: j for j, pick in enumerate(picks)}
    q = torch.stack([out["pool"][b * per + r] for b, r in picks]).float()
    q = q / q.norm(dim=1, keepdim=True)
    qc, qs = ref_search.quantize(q, 127)
    dc, ds = ref_search.quantize(rows, 127)
    kth = ref_search.quantized_scores(qc, qs, dc, ds).topk(k, dim=1) \
        .values[:, -1:]
    if control:
        c_vals, c_ids = ref_search.quantized_topk(q, rows, k, 7)
        answers = [(j, c_vals[j].cpu().numpy(), c_ids[j].cpu().numpy())
                   for j in range(len(picks))]
    else:
        answers, seen = [], set()
        for b, scores, ids in out["out"]:
            for n, r in enumerate(out["checked"][b]):
                j = index[(b, int(r))]
                key = (j, ids[n].tobytes(), scores[n].tobytes())
                if key not in seen:
                    seen.add(key)
                    answers.append((j, scores[n], ids[n]))
    miss, err = [], 0.0
    for j, sims, ids in answers:
        ids_t = torch.as_tensor(ids, device=dev).long()[None]
        got = ref_search.quantized_scores(qc[j:j + 1], qs[j:j + 1], dc, ds,
                                          ids_t)
        got = ref_search.unique_or_neginf(ids_t, got)
        miss.append(float(1 - (got >= kth[j:j + 1]).sum().double() / k))
        diff = (torch.as_tensor(sims, device=dev).double()[None] - got).abs()
        err = max(err, float(torch.where(torch.isfinite(got), diff,
                                         torch.inf).max()))
    return {"miss_share": float(np.mean(miss)), "score_abs_err": err}


def rank_main(argv=None) -> int:
    """A rank other than 0 (set-up starts it): join the group, build the
    shard, serve until rank 0 stops."""
    from knn_for_homology_tpu_torch.parallel.mesh import process_group

    p = argparse.ArgumentParser(description="One rank of db_sharded.")
    p.add_argument("--rank", type=int, required=True)
    p.add_argument("--args", required=True)
    opts = p.parse_args(argv)
    args = json.loads(opts.args)
    try:  # die with rank 0 (Linux)
        import ctypes

        ctypes.CDLL("libc.so.6").prctl(1, signal.SIGKILL)
    except OSError:
        pass
    device = torch.device(args["device"])
    if device.type == "cuda":
        torch.cuda.set_device(opts.rank)
        device = torch.device("cuda", opts.rank)
    with process_group(backend_of(device), opts.rank, args["world"],
                       args["store"], timeout=TIMEOUT):
        state = make_state(args["config"], args["cell"], args["seed"],
                           opts.rank, args["world"], device)
        state["msg_dev"] = device
        serve(state)
    return 0


if __name__ == "__main__":
    sys.exit(rank_main())
