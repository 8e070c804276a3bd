#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py [--seed 0]

Drives the port's two paths. The reference's `seqvec_search` benchmark —
flat kNN → AUC1/TP → Smith-Waterman rescoring → AUC1/TP — at ProtT5-XL's
width (d = 1024) on n = 131072 database vectors and 4096 queries, then the
exact k = 1000 search on the same index; and the headline bench
(knn_for_homology_tpu_torch/bench.py): flat all-vs-all at n = 131072,
d = 1024, k = 1000 in every mode. Phases:

  1. environment: a CUDA device is required; prints the card and its limit;
  2. build: compiles the CUDA kernels from knn_for_homology_tpu_torch/
     csrc/ (a fresh checkout has no build) and prints the seconds;
  3. each kernel against its plain PyTorch version on the card, at the
     shapes its path gives it, with times (D, E, F: 1024 queries of the
     bench's plan from plan_fingerprint, which must be the plan the recall
     anchors hold at: W = 256, R = 7, R = 9 for sym2);
  4. the main path end to end (pipelines.benchmark.run on a seeded dataset
     written in the standard layout), launch counts reset just before;
  5. exact k = 1000 through FlatIndex.search on the same index; the
     approx and sq8 backends reach kernels A and F;
  6. the small-input check: the same pipeline on a small fixture on the
     card and on the CPU (plain versions) must give identical results;
  7. the port's bench at the headline shape (default modes, plus sq8 so
     kernel E runs, plus the sq8-sym2 high-recall point), launch counts
     reset just before; its JSON line, recalls against the reference
     algorithm's (0.9767 sq8-sym, 0.9813 approx, hi ≥ 0.985).

Any failure raises, so the script exits non-zero without the result line.
The last three lines are the card (nvidia-smi name, power limit), the
kernels' JSON summary and {"ok": true, "device": {...}}.
"""

import argparse
import json
import math
import subprocess
import sys
import tempfile
import time
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parent
N_TRAIN, N_TEST, DIM = 131072, 4096, 1024
FAMILY_TRAIN = 32  # train members per family; one test member each
HITS = 13
AAS = np.frombuffer(b"ACDEFGHIKLMNPQRSTVWY", dtype=np.uint8)
SCORE_ATOL = 1e-5  # fp32 sums of 1024 products in two different orders
BENCH_K = 1000
# the bench's plan (W, R) at n = 131072, k = 1000 by recall target, at which
# the reference algorithm's recalls below were measured (ROADMAP,
# BENCH_r05.json): 256 lanes, 512 passes (jbits = 9)
ANCHOR_PLANS = {0.98: (256, 7), 0.995: (256, 9)}
RECALL_ANCHORS = {"sq8-pq": 0.9767, "sq8-sym": 0.9767, "approx": 0.9813}
HI_RECALL_MIN = 0.985


def log(msg):
    print(msg, flush=True)


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    )
    return out.stdout.strip().splitlines()[0]


def cuda_ms(fn, reps=3):
    """Mean milliseconds per call on the card (CUDA events, one warm-up)."""
    import torch

    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


# --------------------------------------------------------------- data
def protein_lengths(rng, size, median_len=330):
    """The repo's protein-length mix: lognormal, median 330 aa, sigma 0.55,
    clipped to [50, 2048] (scripts/bench_align_anchor.py)."""
    raw = rng.lognormal(np.log(median_len), 0.55, size)
    return np.clip(raw, 50, 2048).astype(np.int64)


def write_dataset(out: Path, seed: int, n_fam=N_TEST, per_train=FAMILY_TRAIN,
                  dim=DIM, median_len=330):
    """Seeded dataset in the standard layout: family centroids (x10) plus
    unit Gaussian noise, as data/fixtures.py:make_clustered; each family's
    sequences are mutated copies of one ancestor (30% substitutions, ends
    trimmed by up to 5%), so alignment carries signal. Defaults are the
    main path's size: 4096 families x (32 train + 1 test) at d = 1024."""
    rng = np.random.RandomState(seed)
    per = per_train + 1
    centroids = rng.randn(n_fam, dim).astype(np.float32) * 10.0
    fam_of_train = np.repeat(np.arange(n_fam), per_train)
    train = centroids[fam_of_train] + rng.randn(
        n_fam * per_train, dim
    ).astype(np.float32)
    test = centroids + rng.randn(n_fam, dim).astype(np.float32)
    train_ids = [f"fam{f}_train{j}" for f in range(n_fam)
                 for j in range(per_train)]
    test_ids = [f"fam{f}_test0" for f in range(n_fam)]
    fam_map = {name: f"F{i // per_train}" for i, name in enumerate(train_ids)}
    fam_map.update({name: f"F{i}" for i, name in enumerate(test_ids)})

    lengths = protein_lengths(rng, n_fam, median_len)
    train_seqs, test_seqs = [], []
    for f in range(n_fam):
        ancestor = AAS[rng.randint(0, 20, lengths[f])]
        members = np.repeat(ancestor[None], per, axis=0)
        mutate = rng.rand(per, lengths[f]) < 0.3
        members[mutate] = AAS[rng.randint(0, 20, int(mutate.sum()))]
        trim = (rng.rand(per, 2) * 0.05 * lengths[f]).astype(np.int64)
        seqs = [
            members[m, trim[m, 0] : lengths[f] - trim[m, 1]].tobytes().decode()
            for m in range(per)
        ]
        train_seqs.extend(seqs[:per_train])
        test_seqs.append(seqs[per_train])

    out.mkdir(parents=True, exist_ok=True)
    np.save(out / "train.npy", train)
    np.save(out / "test.npy", test)
    (out / "train.json").write_text(json.dumps(train_ids))
    (out / "test.json").write_text(json.dumps(test_ids))
    (out / "ids_to_family.json").write_text(json.dumps(fam_map))
    for split, ids, seqs in [("train", train_ids, train_seqs),
                             ("test", test_ids, test_seqs)]:
        with open(out / f"{split}.fasta", "w") as fp:
            fp.writelines(f">{i}\n{s}\n" for i, s in zip(ids, seqs))
    return train, test, train_seqs, test_seqs


# ------------------------------------------------------------- checks
def check_topk(name, got, want, db, queries, atol=SCORE_ATOL, exact_fn=None):
    """Kernel vs plain top-k: the sorted scores agree within `atol` at
    every rank, ids agree except swaps among such near-equal scores (each
    differing id's reported score is checked against an fp64 similarity,
    `exact_fn(rows, ids)`, by default the dot of queries and db), and no
    row repeats an id. Returns (max abs score error, differing slots)."""
    import torch

    (gv, gi), (wv, wi) = got, want
    assert gv.shape == wv.shape and gi.shape == wi.shape, name
    finite = torch.isfinite(wv)
    assert torch.equal(finite, torch.isfinite(gv)), f"{name}: -inf slots differ"
    err = float((gv[finite] - wv[finite]).abs().max()) if finite.any() else 0.0
    assert err <= atol, f"{name}: scores differ by {err}"
    if exact_fn is None:
        def exact_fn(rows, ids):
            return (queries[rows].double() * db[ids].double()).sum(1)
    rows, cols = torch.nonzero(gi != wi, as_tuple=True)
    if rows.numel():
        for ids, vals in ((gi, gv), (wi, wv)):
            exact = exact_fn(rows, ids[rows, cols].long())
            bad = (vals[rows, cols].double() - exact).abs().max()
            assert bad <= atol, f"{name}: a swapped id's score is off by {bad}"
    srt = torch.sort(gi, dim=1).values
    dup = (srt[:, 1:] == srt[:, :-1]) & (srt[:, 1:] >= 0)
    assert not dup.any(), f"{name}: repeated ids in a row"
    return err, int(rows.numel())


def bench_plan(recall_target):
    """(W, R) the planner gives the bench; fails unless it is the plan the
    recall anchors were measured at."""
    from knn_for_homology_tpu_torch.ops.exact_cuda import plan_fingerprint

    fp = plan_fingerprint(N_TRAIN, DIM, BENCH_K, recall_target=recall_target)
    plan = (fp["db_tile"], fp["r_slots"])
    assert plan == ANCHOR_PLANS[recall_target], (
        f"plan {plan} at target {recall_target}: the recall anchors hold at"
        f" {ANCHOR_PLANS[recall_target]}"
    )
    return plan


def packed_atol(vals, jbits):
    """Packed truncation (2^jbits float32 ulps of the largest value) plus
    SCORE_ATOL: a decoded value is the similarity cut to 32 - jbits bits."""
    import torch

    top = float(vals[torch.isfinite(vals)].abs().max())
    return top * 2.0 ** (jbits - 23) + SCORE_ATOL


def check_packed_kernels(db, q, kernels):
    """Phase 3 for kernels D, E, F at the bench's plan: D (fp32 and bf16
    db) and E (cosine and l2) decoded and held like check_topk at the
    packed tolerance; F's buffers (sym and sym2) bit-equal to plain."""
    import torch

    from knn_for_homology_tpu_torch.ops import packed_cuda as pc

    w, r = bench_plan(0.98)
    _, r_hi = bench_plan(0.995)
    jbits = pc.pass_bits(N_TRAIN, w)
    kern, plain = pc.segment_packed_kernel, pc.segment_packed_plain
    line = f"[{q.shape[0]} x {N_TRAIN} x {DIM}, k={BENCH_K}, W={w}"

    def decoded(buf):
        return pc.decode_packed(buf, BENCH_K, w, jbits)

    # D: native fp32 and bf16 (the bench's approx mode)
    d_err, d_times = 0.0, {}
    for dt in (torch.float32, torch.bfloat16):
        qd, dbd = q.to(dt).contiguous(), db.to(dt).contiguous()
        args = (qd, dbd, w, r, "cosine")
        got, want = decoded(kern(*args)), decoded(plain(*args))
        err, swaps = check_topk(
            f"D {dt}", got, want, dbd, qd, atol=packed_atol(want[0], jbits)
        )
        d_err = max(d_err, err)
        d_times[dt] = (cuda_ms(lambda: kern(*args)), cuda_ms(lambda: plain(*args)))
        log(f"phase 3 kernel D segment_packed {dt} {line}, R={r}]:"
            f" max_abs_err {err:.3g}, {swaps} near-tie swaps, "
            f"{d_times[dt][0]:.3f} ms vs plain {d_times[dt][1]:.3f} ms")
    ms, plain_ms = d_times[torch.bfloat16]
    kernels["D"] = dict(
        name="segment_packed", route="cuda",
        source="knn_for_homology_tpu_torch/csrc/segment_packed.cu",
        replaces="knn_for_homology_tpu/ops/exact_pallas.py:199",
        max_abs_err=d_err, ms=ms, plain_ms=plain_ms,
    )

    # E: int8 db + row scales, bf16 queries, cosine and l2
    pq = pc.quantize_database(db)
    qb = q.to(torch.bfloat16).contiguous()
    e_err, e_times = 0.0, {}
    for metric in ("cosine", "l2"):
        args = (qb, pq.db_i8, w, r, metric, "sq8", pq.scales)

        def exact_e(rows, ids, metric=metric):
            qq = qb[rows].double()
            x = pq.db_i8[ids].double()
            sc = pq.scales[ids].double()
            sims = (qq * x).sum(1) * sc
            if metric == "l2":
                sims = 2 * sims - (qq * qq).sum(1) - (x * x).sum(1) * sc * sc
            return sims

        got, want = decoded(kern(*args)), decoded(plain(*args))
        err, swaps = check_topk(
            f"E {metric}", got, want, None, None,
            atol=packed_atol(want[0], jbits), exact_fn=exact_e,
        )
        e_err = max(e_err, err)
        e_times[metric] = (cuda_ms(lambda: kern(*args)),
                           cuda_ms(lambda: plain(*args)))
        log(f"phase 3 kernel E segment_packed_sq8 {metric} {line},"
            f" R={r}]: max_abs_err {err:.3g}, {swaps} near-tie swaps,"
            f" {e_times[metric][0]:.3f} ms vs plain {e_times[metric][1]:.3f} ms")
    ms, plain_ms = e_times["cosine"]
    kernels["E"] = dict(
        name="segment_packed_sq8", route="cuda",
        source="knn_for_homology_tpu_torch/csrc/segment_packed.cu",
        replaces="knn_for_homology_tpu/ops/exact_pallas.py:219",
        max_abs_err=e_err, ms=ms, plain_ms=plain_ms,
    )

    # F: int8 queries (sym, R = 7; sym2, R = 9), buffers bit-equal
    f_times = {}
    for storage, r_f in (("sq8-sym", r), ("sq8-sym2", r_hi)):
        q8, q_lo, _ = pc.quantize_queries(q, storage == "sq8-sym2")
        args = (q8, pq.db_i8, w, r_f, "cosine", storage, pq.scales, q_lo)
        got, want = kern(*args), plain(*args)
        assert torch.equal(got, want), (
            f"F {storage}: {int((got != want).sum())} slots differ from plain"
        )
        f_times[storage] = (cuda_ms(lambda: kern(*args)),
                            cuda_ms(lambda: plain(*args)))
        log(f"phase 3 kernel F segment_packed_sq8sym {storage} {line},"
            f" R={r_f}]: buffers bit-equal, {f_times[storage][0]:.3f} ms vs"
            f" plain {f_times[storage][1]:.3f} ms")
    ms, plain_ms = f_times["sq8-sym"]
    kernels["F"] = dict(
        name="segment_packed_sq8sym", route="cuda",
        source="knn_for_homology_tpu_torch/csrc/segment_packed.cu",
        replaces="knn_for_homology_tpu/ops/exact_pallas.py:266",
        max_abs_err=0.0, ms=ms, plain_ms=plain_ms,
    )


def run_bench(kernels):
    """Phase 7: the port's bench at the headline shape, counts from zero."""
    import torch

    from knn_for_homology_tpu_torch import bench
    from knn_for_homology_tpu_torch.ops import exact_cuda, packed_cuda

    args = bench.parse_args(["--modes", "sq8-pq,approx,exact,sq8-sym,sq8"])
    launches = packed_cuda.segment_packed_kernel.launches
    for key in launches:
        launches[key] = 0
    exact_cuda.segment_topr_kernel.launches = 0
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    result = bench.run(args)
    wall = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated()
    print(json.dumps(result), flush=True)
    b_launches = exact_cuda.segment_topr_kernel.launches
    assert b_launches > 0, "kernel B was not launched by the bench"
    for key in ("D", "E", "F"):
        assert launches[key] > 0, f"kernel {key} was not launched by the bench"
        kernels[key]["launches"] = launches[key]
    recalls = {"sq8-pq": result["recall_vs_exact"],
               "sq8-sym": result["sq8-sym_recall"],
               "approx": result["approx_recall"]}
    for mode, anchor in RECALL_ANCHORS.items():
        assert abs(recalls[mode] - anchor) <= 0.01, (
            f"{mode} recall {recalls[mode]} is not within 0.01 of {anchor}"
        )
    assert result["hi_recall"] >= HI_RECALL_MIN, result["hi_recall"]
    for key, value in result.items():
        assert key == "config" or isinstance(value, str) or math.isfinite(value)
    log(f"phase 7 bench n={args.n} d={args.d} k={args.k}: "
        + ", ".join(f"{m} {result[m + '_qps']:.0f} q/s" for m in args.mode_list)
        + f", hi {result['hi_recall_qps']:.0f} q/s | recalls {recalls},"
        f" sq8 {result['sq8_recall']}, hi {result['hi_recall']} |"
        f" launches D {launches['D']} E {launches['E']} F {launches['F']}"
        f" B {b_launches} | run {wall:.1f} s | peak {peak / 2**30:.2f} GiB")


def main() -> None:
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--seed", type=int, default=0)
    args = p.parse_args()

    # ---- phase 1: environment
    import torch

    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: torch.cuda.is_available() is False")
    card = card_line()
    device = torch.device("cuda")
    log(f"phase 1 environment: {torch.cuda.get_device_name(0)} | {card} |"
        f" torch {torch.__version__} cuda {torch.version.cuda}")

    sys.path.insert(0, str(ROOT))
    from knn_for_homology_tpu_torch.ops import _build
    from knn_for_homology_tpu_torch.ops import align as align_ops
    from knn_for_homology_tpu_torch.ops import (
        align_cuda,
        exact_cuda,
        flat_cuda,
        packed_cuda,
    )
    from knn_for_homology_tpu_torch.ops.distance import l2_normalize
    from knn_for_homology_tpu_torch.pipelines import benchmark
    from knn_for_homology_tpu_torch.search.flat import FlatIndex

    # ---- phase 2: build
    build_s = _build.timed_build()
    log(f"phase 2 build: {build_s:.1f} s -> {_build.library_path().name}")

    with tempfile.TemporaryDirectory(prefix="knn_smoke_") as tmp:
        t0 = time.perf_counter()
        ds = Path(tmp) / "dataset"
        train, test, train_seqs, test_seqs = write_dataset(ds, args.seed)
        log(f"data: {N_TRAIN} x {DIM} train, {N_TEST} test, written in"
            f" {time.perf_counter() - t0:.1f} s")
        db = l2_normalize(torch.from_numpy(train).to(device)).contiguous()
        q_all = l2_normalize(torch.from_numpy(test).to(device)).contiguous()
        kernels = {}

        # ---- phase 3: kernels against their plain versions
        q = q_all[:1024].contiguous()
        got = flat_cuda.flat_topk_kernel(db, q, HITS, "cosine")
        want = flat_cuda.flat_topk_plain(db, q, HITS, "cosine")
        err, swaps = check_topk("A", got, want, db, q)
        ms = cuda_ms(lambda: flat_cuda.flat_topk_kernel(db, q, HITS, "cosine"))
        plain_ms = cuda_ms(lambda: flat_cuda.flat_topk_plain(db, q, HITS, "cosine"))
        kernels["A"] = dict(
            name="flat_topk", route="cuda",
            source="knn_for_homology_tpu_torch/csrc/flat_topk.cu",
            replaces="knn_for_homology_tpu/ops/flat_pallas.py:51",
            max_abs_err=err, ms=ms, plain_ms=plain_ms,
        )
        log(f"phase 3 kernel A flat_topk [1024 x {N_TRAIN} x {DIM}, k={HITS}]:"
            f" max_abs_err {err:.3g}, {swaps} near-tie swaps, {ms:.3f} ms"
            f" vs plain {plain_ms:.3f} ms")

        q = q_all[:512].contiguous()
        w, r = exact_cuda.plan(N_TRAIN, 1000, exact_cuda.default_db_tile(1000))
        bufs = exact_cuda.segment_topr_kernel(db, q, w, r, "cosine")
        plain_bufs = exact_cuda.segment_topr_plain(db, q, w, r, "cosine")
        got = exact_cuda.epilogue(*bufs, 1000, w, r)
        want = exact_cuda.epilogue(*plain_bufs, 1000, w, r)
        err, swaps = check_topk("B", got[:2], want[:2], db, q)
        suspect = int(got[2].sum())
        ms = cuda_ms(lambda: exact_cuda.segment_topr_kernel(db, q, w, r, "cosine"))
        plain_ms = cuda_ms(
            lambda: exact_cuda.segment_topr_plain(db, q, w, r, "cosine")
        )
        rescued = exact_cuda.exact_topk(db, q, 1000, "cosine", r_slots=2)
        full = exact_cuda.oneshot_topk(db, q, 1000, "cosine")
        err_r, swaps_r = check_topk("B rescue", rescued, full, db, q)
        kernels["B"] = dict(
            name="segment_topr", route="cuda",
            source="knn_for_homology_tpu_torch/csrc/segment_topr.cu",
            replaces="knn_for_homology_tpu/ops/exact_pallas.py:126",
            max_abs_err=max(err, err_r), ms=ms, plain_ms=plain_ms,
        )
        log(f"phase 3 kernel B segment_topr [512 x {N_TRAIN} x {DIM}, k=1000,"
            f" W={w}, R={r}]: max_abs_err {err:.3g}, {swaps} swaps,"
            f" {suspect} suspect rows, {ms:.3f} ms vs plain {plain_ms:.3f} ms;"
            f" forced R=2 with rescue vs full sort: max_abs_err {err_r:.3g},"
            f" {swaps_r} swaps")

        check_packed_kernels(db, q_all[:1024].contiguous(), kernels)

        # planner blocks from the main path's own mix (each test query
        # against its family's first 13 train members), plus one 700-aa
        # query with 300 short hits, which packs ragged lanes
        rng = np.random.RandomState(args.seed + 1)
        queries = list(test_seqs[:256])
        hits = [train_seqs[i * FAMILY_TRAIN : i * FAMILY_TRAIN + HITS]
                for i in range(256)]
        queries.append(max(test_seqs, key=len)[:700])
        hits.append([s[: rng.randint(20, 80)] for s in train_seqs[:300]])
        cells = align_ops.plan_align_cells(queries, hits)
        blocks = list(align_ops.iter_align_blocks(cells))
        ragged = [b for b in blocks if b[2] > 1]
        # the largest classic blocks up to G=128, Lq=Lt=512 (the plain
        # version's row loop is the slow side of the comparison)
        classic = sorted(
            (b for b in blocks
             if b[2] == 1 and b[0] * b[1] * b[4] <= 128 * 512 * 512),
            key=lambda b: -b[0] * b[1] * b[4],
        )
        assert ragged, "the workload must plan a ragged block"
        picked = classic[:3] + ragged[:1]
        c_err, c_ms, c_plain_ms = 0.0, 0.0, 0.0
        for lq_b, lt_b, s_b, sweep, g_pad, block in picked:
            qc = np.full((g_pad, lq_b), -1, np.int32)
            tc = np.full((g_pad, 128, lt_b), -1, np.int32)
            for i, (row_seq, lanes) in enumerate(block):
                qc[i] = align_ops.encode_sequence(row_seq, lq_b)
                for l, lane in enumerate(lanes):
                    pos = 0
                    for seq, _, _ in lane:
                        tc[i, l, pos : pos + len(seq)] = align_ops.encode_sequence(
                            seq, len(seq)
                        )
                        pos += len(seq) + 1
            qd, td = torch.from_numpy(qc).to(device), torch.from_numpy(tc).to(device)
            for conv in ("mmseqs", "blast"):
                kw = dict(convention=conv, segments=s_b,
                          max_seg_len=sweep if s_b > 1 else None)
                k_out = align_cuda.sw_scores_grouped(qd, td, **kw)
                p_out = align_cuda.sw_scores_grouped_plain(qd, td, **kw)
                assert torch.equal(k_out, p_out), (
                    f"C: kernel and plain differ on ({lq_b}, {lt_b}, {s_b})"
                    f" {conv}: max {float((k_out - p_out).abs().max())}"
                )
                assert float(k_out.max()) > 0
                c_err = max(c_err, float((k_out - p_out).abs().max()))
            kw = dict(convention="mmseqs", segments=s_b,
                      max_seg_len=sweep if s_b > 1 else None)
            ms = cuda_ms(lambda: align_cuda.sw_scores_grouped(qd, td, **kw))
            plain_ms = cuda_ms(
                lambda: align_cuda.sw_scores_grouped_plain(qd, td, **kw), reps=1
            )
            c_ms, c_plain_ms = c_ms + ms, c_plain_ms + plain_ms
            log(f"phase 3 kernel C sw_grouped block G={g_pad} Lq={lq_b}"
                f" K=128 Lt={lt_b} S={s_b}: bit-equal (both conventions),"
                f" {ms:.3f} ms vs plain {plain_ms:.3f} ms")
        kernels["C"] = dict(
            name="sw_grouped", route="cuda",
            source="knn_for_homology_tpu_torch/csrc/sw_grouped.cu",
            replaces="knn_for_homology_tpu/ops/align_pallas.py:179",
            max_abs_err=c_err, ms=c_ms, plain_ms=c_plain_ms,
        )

        # ---- phase 4: the main path, counts from zero
        flat_cuda.flat_topk_kernel.launches = 0
        exact_cuda.segment_topr_kernel.launches = 0
        align_cuda.sw_scores_grouped.launches = 0
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        results = benchmark.run(ds, hits=HITS, figures=False, device="cuda")
        wall = time.perf_counter() - t0
        (_, auc_knn, tp_knn, search_s), (_, auc_al, tp_al, total_s) = results[:2]
        align_s = total_s - search_s
        for label, vals in [("kNN AUC1", auc_knn), ("kNN+align AUC1", auc_al)]:
            mean = float(np.mean(vals))
            # random hit lists score AUC1 ~ 1/N; a working path scores ~13/32
            assert math.isfinite(mean) and mean > 0.05, f"{label} {mean}"
        assert len(auc_knn) == len(auc_al) == N_TEST
        peak = torch.cuda.max_memory_allocated()

        # ---- phase 5: exact k = 1000 on an index of the same vectors
        index = FlatIndex(device="cuda").add(train)
        qk = test[:1024]
        t0 = time.perf_counter()
        scores, ids = index.search(qk, 1000)
        k_s = time.perf_counter() - t0
        launches = {
            "A": flat_cuda.flat_topk_kernel.launches,
            "B": exact_cuda.segment_topr_kernel.launches,
            "C": align_cuda.sw_scores_grouped.launches,
        }
        for key, n in launches.items():
            assert n > 0, f"kernel {key} was not launched on the main path"
            kernels[key]["launches"] = n

        # what the main path aligned: every query against its 13 hits
        _, ids13 = index.search(test, HITS)
        lens_test = np.asarray([len(s) for s in test_seqs], np.float64)
        lens_train = np.asarray([len(s) for s in train_seqs], np.float64)
        pairs = int((ids13 >= 0).sum())
        cells_n = float((lens_test[:, None] * lens_train[ids13]).sum())
        log(f"phase 4 main path: kNN AUC1 {np.mean(auc_knn):.4f} TP"
            f" {np.mean(tp_knn):.4f} | kNN+align AUC1 {np.mean(auc_al):.4f}"
            f" TP {np.mean(tp_al):.4f} | search {search_s:.3f} s"
            f" ({N_TEST / search_s:.0f} queries/s) | align {align_s:.3f} s,"
            f" {pairs} pairs, {cells_n:.4g} DP cells, {cells_n / align_s:.4g}"
            f" cells/s | run {wall:.1f} s | peak {peak / 2**30:.2f} GiB")

        plain = FlatIndex(device="cuda", backend="plain").add(train)
        p_scores, p_ids = plain.search(qk, 1000)
        qn = l2_normalize(torch.from_numpy(qk).to(device))
        err, swaps = check_topk(
            "k=1000",
            (torch.from_numpy(scores).to(device), torch.from_numpy(ids).to(device)),
            (torch.from_numpy(p_scores).to(device),
             torch.from_numpy(p_ids).to(device)),
            db, qn,
        )
        log(f"phase 5 exact k=1000: 1024 queries in {k_s:.3f} s, ids equal to"
            f" the plain full sort but {swaps} near-tie swaps, max_abs_err"
            f" {err:.3g} | main-path launches {launches}")

        # the approx and sq8 backends on the same vectors: approx at k = 13
        # is kernel A's exact search, sq8 at k = 1000 runs kernel F
        a_before = flat_cuda.flat_topk_kernel.launches
        f_before = packed_cuda.segment_packed_kernel.launches["F"]
        _, a_ids = FlatIndex(device="cuda", backend="approx").add(
            train).search(test, HITS)
        assert flat_cuda.flat_topk_kernel.launches > a_before
        assert np.array_equal(a_ids, ids13), "approx k=13 differs from exact"
        _, s_ids = FlatIndex(device="cuda", backend="sq8").add(
            train).search(qk, 1000)
        assert packed_cuda.segment_packed_kernel.launches["F"] > f_before
        s_recall = float(np.mean(
            [len(set(a) & set(b)) / 1000 for a, b in zip(s_ids, ids)]
        ))
        assert s_recall >= 0.9, f"sq8 backend recall {s_recall}"
        log(f"phase 5 backends: approx k=13 ids equal to exact (kernel A),"
            f" sq8 k=1000 recall {s_recall:.4f} against exact (kernel F)")

    # ---- phase 6: small input, card vs CPU through the same pipeline
    with tempfile.TemporaryDirectory(prefix="knn_small_") as tmp:
        # short sequences keep the CPU side (plain versions) quick
        write_dataset(Path(tmp), args.seed, n_fam=24, per_train=6, dim=32,
                      median_len=60)
        on_gpu = benchmark.run(Path(tmp), hits=HITS, figures=False,
                               device="cuda")
        on_cpu = benchmark.run(Path(tmp), hits=HITS, figures=False,
                               device="cpu")
        for a, b in zip(on_gpu, on_cpu):
            assert a[0] == b[0] and a[1] == b[1] and a[2] == b[2], a[0]
        log("phase 6 small input: card and CPU agree on every AUC1/TP")

    # ---- phase 7: the headline bench
    run_bench(kernels)

    log(card)
    print(json.dumps({"kernels": [kernels[k] for k in "ABCDEF"]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}), flush=True)


if __name__ == "__main__":
    main()
