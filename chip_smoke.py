#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py [--seed 0]

Drives the port's three paths. The reference's `seqvec_search` benchmark —
flat kNN → AUC1/TP → Smith-Waterman rescoring → AUC1/TP — at ProtT5-XL's
width (d = 1024) on n = 131072 database vectors and 4096 queries, then the
exact k = 1000 search on the same index; and the headline bench
(knn_for_homology_tpu_torch/bench.py): flat all-vs-all at n = 131072,
d = 1024, k = 1000 in every mode; and the ProtT5 encoder path, sequences
→ pooled embeddings → neighbours. Phases:

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
     algorithm's (0.9767 sq8-sym, 0.9813 approx, hi ≥ 0.985);
  8. the encoder path: ProtT5-XL at full width (24 layers, bf16, random
     weights from a seeded torch.Generator on the card) embeds 1028
     proteins (32 families x 32 of the length mix, plus four long ones
     for the flash route) in 7000-token batches, then l2 and a FlatIndex
     k = 13 search, launch counts reset just before (G, H, A); an opt-in
     short-attention run (I); device time by kernel over warm batches;
     the kernels' route against the plain versions' on 32 proteins;
  9. the IVF index path (pipelines.pfam_proteins.run, the full-protein
     all-vs-all k = 1000 search) over phase 4's 131072 x 1024 vectors as
     full-protein embeddings, one domain (the family) per protein: the IVF
     index (kernel J, the union scan with sym2) and the flat index (kernel
     B), launch counts reset just before; an online batch of 256 queries
     at k = 10 through the per-probe path (kernel K) against the flat
     exact top-10; one 4096-query block through the kernels' route and the
     plain versions' route (ids equal); a write_index / read_index round
     trip on the card.

Phase 3 also holds the encoder's kernels at full width: G at 7000 tokens x
1024 x 16384, H at 2 x 32 heads x 3200 x 128, I at 13 x 32 x 512 x 128 and
27 x 32 x 256 x 128 (H and I fed the [H, 2L-1] offset-bias table); and the
IVF path's kernels: J at 1024 queries x 256 cells (32768 rows) x 1024, k =
1000 (sym and sym2, buffers bit-equal), K at 4096 queries x 32 probes x
128 x 1024. Library yardsticks, which the port never calls: for G, its two
products as two bf16 torch.matmul calls (with the relu between them); for
H and I, scaled_dot_product_attention; for F and J, torch._int_mm on the
same int8 operands (the product only: no scales, no top-R slots). Each
kernel's entry names its yardstick under "library" (null where there is
none), since for G, F and J it is not one call computing the same
function. Every kernel's line carries its bound: the least time the card could take, from
its operations and bytes (PEAK_OPS, HBM_BYTES_PER_S).
Times are medians of five timed windows (cuda_ms), after a two-second
warm-up of the card.

Any failure raises, so the script exits non-zero without the result line.
The last three lines are the card (nvidia-smi name, power limit), the
kernels' JSON summary and {"ok": true, "device": {...}}.
"""

import argparse
import contextlib
import dataclasses
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
# published dense peaks of one H100 SXM at 700 W (NVIDIA data sheet), by the
# operands' type, and its memory rate: the bound of a kernel is the larger
# of its operations over the peak and its bytes over the memory rate
PEAK_OPS = {"fp32": 67e12, "bf16": 989e12, "int8": 1979e12}
HBM_BYTES_PER_S = 3.35e12
# Smith-Waterman cell: substitution lookup + add, two gap updates of two
# ops each, a four-way max, the running best: ~10 scalar ops at fp32 rate
SW_OPS_PER_CELL = 10
# kernel vs plain in bf16: both round their result once from fp32 sums taken
# in other orders (H's p also at other running maxima), an ulp or two apart;
# allowed: 2^-6 of the largest |value| (4 bf16 ulps there)
BF16_TOL = 2.0**-6
# phase 8: ProtT5-XL over 32 families x (31 train + 1 test) proteins of the
# length mix, plus four long ones (the last is cut to 3096) for the flash
# route, in batches of at most 7000 tokens
ENC_FAMILIES, ENC_TRAIN = 32, 31
LONG_LENGTHS = (2048, 2600, 3096, 3500)
TOKEN_BUDGET = 7000
# phase 8, pooled vectors of two routes on the card (the kernels' and the
# plain versions'; the short kernel's and dense attention), per protein.
# Random T5 weights leave the unscaled q.k logits with a standard deviation
# near sqrt(128) = 11, so each softmax is nearly an argmax, and a one-ulp
# change of q or k (2^-8) moves a row's weight between two near-equal keys;
# 24 layers of such switches, averaged over the residues, measured a cosine
# of 0.9951 and a relative L2 error of 0.099 (H100, 700 W). Allowed: a
# cosine of 0.98 and a relative L2 error of 0.2 (each kernel alone is held
# to BF16_TOL in phase 3)
ENC_MIN_COSINE = 0.98
ENC_MAX_REL_ERR = 0.2
# phase 3, kernels J and K at the IVF path's shapes: the phase-9 index's
# 2048 cells of 64 members (the auto sizing, half full); J scans 256 of
# them for 1024 queries at k = 1000, K expands 32 probes for 4096 queries
IVF_CELLS, IVF_FILL = 2048, 64
J_QUERIES, J_BUDGET = 1024, 256
K_QUERIES, K_PROBES = 4096, 32
K_RTOL = 1e-5  # K's fp32 sums of 1024 products, in another order than plain
# phase 9: IVFIndex(cosine, nprobe=32) at k = 1000, the pipeline's own;
# AUC1 may fall at most this far below the flat index's; the online batch
# (per-probe path) must recall this share of the flat exact top-10
IVF_AUC1_SLACK = 0.01
ONLINE_QUERIES, ONLINE_K, ONLINE_RECALL = 256, 10, 0.99
ROUNDTRIP_ROWS = 16384
# phase 9 profile groups: kernel J (the union scan), the sorts and top-k
# selections (routing, cell ranking, the packed decode)
IVF_KERNELS = (("J ivf_indirect", ("segment_packed",)),
               ("sort / top-k", ("sort", "topk", "radix", "bitonic",
                                 "gathertopk")))


def log(msg):
    print(msg, flush=True)


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    )
    return out.stdout.strip().splitlines()[0]


def cuda_ms(fn, reps=10, windows=5):
    """Milliseconds per call on the card: the median over `windows` timed
    windows of `reps` calls each (CUDA events, one warm-up call first)."""
    import torch

    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(windows):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(reps):
            fn()
        end.record()
        torch.cuda.synchronize()
        times.append(start.elapsed_time(end) / reps)
    return float(np.median(times))


def warm_card(seconds=2.0):
    """Keep the card busy for `seconds` (bf16 products), so that phase 3's
    first timings do not catch its clocks still rising."""
    import torch

    a = torch.randn(4096, 4096, device="cuda", dtype=torch.bfloat16)
    t0 = time.perf_counter()
    while time.perf_counter() - t0 < seconds:
        for _ in range(20):
            a @ a
        torch.cuda.synchronize()


def tensor_bytes(*tensors) -> int:
    return sum(t.numel() * t.element_size() for t in tensors)


def bound(ops, kind, nbytes):
    """Least time the card could take (ms) and what bounds it: `ops`
    operations at the peak for `kind` operands, or `nbytes` (each input
    read once, each output written once) at the memory rate."""
    ops_ms = ops / PEAK_OPS[kind] * 1e3
    bytes_ms = nbytes / HBM_BYTES_PER_S * 1e3
    return dict(bound_ms=max(ops_ms, bytes_ms),
                bound_by="operations" if ops_ms >= bytes_ms else "bytes")


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
    q_n, flops = q.shape[0], 2 * q.shape[0] * N_TRAIN * DIM
    for dt in (torch.float32, torch.bfloat16):
        qd, dbd = q.to(dt).contiguous(), db.to(dt).contiguous()
        args = (qd, dbd, w, r, "cosine")
        raw = kern(*args)
        d_bound = bound(flops, "bf16" if dt == torch.bfloat16 else "fp32",
                        tensor_bytes(qd, dbd, raw))
        got, want = decoded(raw), decoded(plain(*args))
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
        max_abs_err=d_err, ms=ms, plain_ms=plain_ms, library_ms=None,
        library=None,
        **d_bound,
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

        raw = kern(*args)
        if metric == "cosine":  # int8 db x bf16 queries, upcast: bf16 rate
            e_bound = bound(flops, "bf16", tensor_bytes(qb, pq.db_i8,
                                                        pq.scales, raw))
        got, want = decoded(raw), decoded(plain(*args))
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
        max_abs_err=e_err, ms=ms, plain_ms=plain_ms, library_ms=None,
        library=None,
        **e_bound,
    )

    # F: int8 queries (sym, R = 7; sym2, R = 9), buffers bit-equal
    f_times = {}
    for storage, r_f in (("sq8-sym", r), ("sq8-sym2", r_hi)):
        q8, q_lo, _ = pc.quantize_queries(q, storage == "sq8-sym2")
        args = (q8, pq.db_i8, w, r_f, "cosine", storage, pq.scales, q_lo)
        got, want = kern(*args), plain(*args)
        if storage == "sq8-sym":
            f_bound = bound(flops, "int8", tensor_bytes(q8, pq.db_i8,
                                                        pq.scales, got))
        assert torch.equal(got, want), (
            f"F {storage}: {int((got != want).sum())} slots differ from plain"
        )
        f_times[storage] = (cuda_ms(lambda: kern(*args)),
                            cuda_ms(lambda: plain(*args)))
        log(f"phase 3 kernel F segment_packed_sq8sym {storage} {line},"
            f" R={r_f}]: buffers bit-equal, {f_times[storage][0]:.3f} ms vs"
            f" plain {f_times[storage][1]:.3f} ms")
    ms, plain_ms = f_times["sq8-sym"]
    # the yardstick, product only: the int8 [Q, N] dots as one
    # torch._int_mm call (no scales, no packed slots)
    q8, _, _ = pc.quantize_queries(q, False)
    db_t = pq.db_i8.t()
    lib_ms = cuda_ms(lambda: torch._int_mm(q8, db_t))
    log(f"phase 3 kernel F: torch._int_mm {line}] (product only)"
        f" {lib_ms:.3f} ms")
    kernels["F"] = dict(
        name="segment_packed_sq8sym", route="cuda",
        source="knn_for_homology_tpu_torch/csrc/segment_packed.cu",
        replaces="knn_for_homology_tpu/ops/exact_pallas.py:266",
        max_abs_err=0.0, ms=ms, plain_ms=plain_ms, library_ms=lib_ms,
        library="torch._int_mm of the int8 operands, product only",
        **f_bound,
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


def check_bf16(name, got, want, tol=BF16_TOL):
    """Kernel vs plain in bf16: finite, same shape, max |got - want| ≤ tol
    of the largest |want|. Returns the max abs error."""
    import torch

    assert got.shape == want.shape and got.dtype == want.dtype, name
    assert bool(torch.isfinite(got.float()).all()), f"{name}: not finite"
    err = float((got.float() - want.float()).abs().max())
    scale = float(want.float().abs().max())
    assert err <= tol * scale, f"{name}: max_abs_err {err} > {tol} x {scale}"
    return err


def check_encoder_kernels(kernels, seed):
    """Phase 3 for kernels G, H, I at ProtT5-XL's width, each against its
    plain version on the same inputs (BF16_TOL), timed beside its bound;
    scaled_dot_product_attention with the same float bias and mask and
    scale 1 is H's and I's library yardstick (the port never calls it).
    H and I take the [H, 2L-1] offset table; their bounds count its bytes
    and the mask's, and the function's 4·B·H·L²·d_kv operations (I's
    second sweep recomputes q.k: 1.5x that on the card). I also runs at a
    second shape, a 7000-token batch at the length mix's median (27 x 256),
    printed beside its SDPA time."""
    import torch
    import torch.nn.functional as F

    from knn_for_homology_tpu_torch.models import t5
    from knn_for_homology_tpu_torch.ops import ffn_cuda, flash_cuda, short_cuda
    from knn_for_homology_tpu_torch.ops.ffn import fused_ffn_plain
    from knn_for_homology_tpu_torch.ops.flash_attention import (
        flash_attention_plain,
        offset_bias_table,
    )
    from knn_for_homology_tpu_torch.ops.short_attention import (
        short_attention_plain,
    )

    dev = torch.device("cuda")
    gen = torch.Generator(dev).manual_seed(seed + 7)
    cfg = t5.PROTT5_XL

    def randn(*shape, scale=1.0):
        out = torch.randn(shape, generator=gen, device=dev) * scale
        return out.to(torch.bfloat16)

    # G: one batch of the token budget, d_model 1024, d_ff 16384
    t_n, d, f = TOKEN_BUDGET, cfg.d_model, cfg.d_ff
    g_args = (randn(t_n, d, scale=2.0), randn(d, scale=0.1) + 1.0,
              randn(d, f, scale=d**-0.5), randn(f, d, scale=f**-0.5))
    got = ffn_cuda.fused_ffn_t5(*g_args)
    err = check_bf16("G", got, fused_ffn_plain(*g_args))
    ms = cuda_ms(lambda: ffn_cuda.fused_ffn_t5(*g_args))
    plain_ms = cuda_ms(lambda: fused_ffn_plain(*g_args))
    # the yardstick: G's two products as two bf16 torch.matmul calls (and
    # the relu between them) on the normalised rows, the norm not timed
    x, ln, wi, wo = g_args
    x32 = x.float()
    normed = (x32 * torch.rsqrt(x32.square().mean(-1, keepdim=True) + 1e-6)
              ).to(x.dtype) * ln
    lib_ms = cuda_ms(lambda: torch.matmul(torch.matmul(normed, wi).relu_(), wo))
    del x32, normed
    kernels["G"] = dict(
        name="ffn_fused", route="cuda",
        source="knn_for_homology_tpu_torch/csrc/ffn_fused.cu",
        replaces="knn_for_homology_tpu/ops/ffn_pallas.py:30",
        max_abs_err=err, ms=ms, plain_ms=plain_ms, library_ms=lib_ms,
        library="two bf16 torch.matmul calls (relu between), norm not timed",
        **bound(4 * t_n * d * f, "bf16", tensor_bytes(*g_args, got)),
    )
    log(f"phase 3 kernel G ffn_fused [T={t_n}, D={d}, F={f}]: max_abs_err"
        f" {err:.3g}, {ms:.3f} ms vs plain {plain_ms:.3f} ms, two bf16"
        f" torch.matmul calls {lib_ms:.3f} ms, bound"
        f" {kernels['G']['bound_ms']:.3f} ms ({kernels['G']['bound_by']})")

    rel = randn(cfg.rel_buckets, cfg.num_heads, scale=0.1)

    def attention_case(name, b, l, lengths, fn, plain, bias, dense_bias):
        q, k, v = (randn(b, cfg.num_heads, l, cfg.d_kv) for _ in range(3))
        mask = torch.arange(l, device=dev)[None, :] < torch.tensor(
            lengths, device=dev)[:, None]
        got = fn(q, k, v, mask, bias)
        err = check_bf16(name, got, plain(q, k, v, mask, bias))
        ms = cuda_ms(lambda: fn(q, k, v, mask, bias))
        plain_ms = cuda_ms(lambda: plain(q, k, v, mask, bias))
        attn = (dense_bias[None] + torch.where(mask, 0.0, -1e9)[:, None, None, :]
                ).to(torch.bfloat16)
        lib_ms = cuda_ms(lambda: F.scaled_dot_product_attention(
            q, k, v, attn_mask=attn, scale=1.0))
        del attn
        ops = 4 * b * cfg.num_heads * l * l * cfg.d_kv
        return dict(max_abs_err=err, ms=ms, plain_ms=plain_ms, library_ms=lib_ms,
                    library="scaled_dot_product_attention",
                    **bound(ops, "bf16", tensor_bytes(q, k, v, mask, bias, got)))

    def dense_from_table(table, l):
        pos = torch.arange(l, device=dev)
        return table[:, pos[None, :] - pos[:, None] + l - 1]

    # H: the longest batch, 2 rows padded to 3200 (the 3096 cut + EOS)
    l = 3200
    table = offset_bias_table(rel, l, cfg.rel_buckets, cfg.rel_max_distance)
    kernels["H"] = dict(
        name="flash_t5", route="cuda",
        source="knn_for_homology_tpu_torch/csrc/flash_t5.cu",
        replaces="knn_for_homology_tpu/ops/flash_attention.py:53",
        **attention_case("H", 2, l, [3097, 2601],
                         flash_cuda.flash_attention_t5, flash_attention_plain,
                         table, dense_from_table(table, l)),
    )
    # I: the opt-in short route at its limit, 13 rows of 512, and a
    # 7000-token batch at the length mix's median, 27 rows of 256
    i_cases = {}
    for b, l, lengths in ((13, 512, [512 - 29 * i for i in range(13)]),
                          (27, 256, [256 - 7 * i for i in range(27)])):
        table = offset_bias_table(rel, l, cfg.rel_buckets, cfg.rel_max_distance)
        i_cases[(b, l)] = attention_case(
            "I", b, l, lengths, short_cuda.short_attention_t5,
            short_attention_plain, table, dense_from_table(table, l))
    kernels["I"] = dict(
        name="short_t5", route="cuda",
        source="knn_for_homology_tpu_torch/csrc/short_t5.cu",
        replaces="knn_for_homology_tpu/ops/short_attention.py:37",
        **i_cases[(13, 512)],
    )
    blocks = {"H": flash_cuda.blocks_per_sm(3200),
              "I": short_cuda.blocks_per_sm(512)}
    for key, shape, kv in (
            ("H", "B=2, H=32, L=3200, dk=128", kernels["H"]),
            ("I", "B=13, H=32, L=512, dk=128", kernels["I"]),
            ("I", "B=27, H=32, L=256, dk=128", i_cases[(27, 256)])):
        log(f"phase 3 kernel {key} {kv.get('name', 'short_t5')} [{shape}]:"
            f" max_abs_err {kv['max_abs_err']:.3g}, {kv['ms']:.3f} ms vs plain"
            f" {kv['plain_ms']:.3f} ms, sdpa {kv['library_ms']:.3f} ms, bound"
            f" {kv['bound_ms']:.3f} ms ({kv['bound_by']}), {blocks[key]}"
            " block(s) per SM")


def check_ivf_kernels(db, q_all, kernels, seed):
    """Phase 3 for kernels J and K on a slab table of the phase-9 layout
    (IVF_CELLS cells of IVF_FILL members of db, packed as the index packs
    them): J's buffers bit-equal to plain (sym and sym2), K's ids equal and
    sims within K_RTOL. No one PyTorch call computes either function (J's
    per-lane packed top-R over an indirect row set; K's gather, dot, scale
    and -inf padding), so neither has a library time."""
    import torch

    from knn_for_homology_tpu_torch.ops import ivf_cuda, packed_cuda, slab_cuda

    dev = db.device
    gen = torch.Generator(dev).manual_seed(seed + 11)
    members = torch.full((IVF_CELLS, 128), -1, dtype=torch.int32, device=dev)
    members[:, :IVF_FILL] = torch.randperm(
        IVF_CELLS * IVF_FILL, generator=gen, device=dev
    ).view(IVF_CELLS, IVF_FILL).to(torch.int32)
    pv, pi, sc = slab_cuda.pack_neighbours(db, members, 128)

    # J: 1024 queries against 256 cells' slabs, k = 1000
    cells = torch.randperm(IVF_CELLS, generator=gen, device=dev)[:J_BUDGET]
    cells = cells.to(torch.int32)
    tile, r, _ = ivf_cuda.union_plan(J_BUDGET, BENCH_K, 0.995)
    # queries zero-padded to the slabs' lane-padded width, as the index does
    q = torch.nn.functional.pad(q_all[:J_QUERIES], (0, pv.shape[1] - db.shape[1]))
    kern = ivf_cuda.segment_packed_indirect_kernel
    plain = ivf_cuda.segment_packed_indirect_plain
    times = {}
    for compute in ("sym", "sym2"):
        q8, q_lo, _ = packed_cuda.quantize_queries(q, compute == "sym2")
        args = (q8, pv, sc, pi, cells, tile, r, q_lo)
        got, want = kern(*args), plain(*args)
        assert torch.equal(got, want), (
            f"J {compute}: {int((got != want).sum())} slots differ from plain")
        times[compute] = (cuda_ms(lambda: kern(*args)),
                          cuda_ms(lambda: plain(*args)))
        if compute == "sym":
            rows = J_BUDGET * 128
            j_bound = bound(2 * J_QUERIES * rows * q.shape[1], "int8",
                            tensor_bytes(q8, cells, got)
                            + rows * (q.shape[1] + 8))
        log(f"phase 3 kernel J ivf_indirect {compute} [{J_QUERIES} x"
            f" {J_BUDGET} cells ({J_BUDGET * 128} rows) x {q.shape[1]},"
            f" k={BENCH_K}, W={tile}, R={r}]: buffers bit-equal,"
            f" {times[compute][0]:.3f} ms vs plain {times[compute][1]:.3f} ms")
    ms, plain_ms = times["sym"]
    # the yardstick, product only: the int8 dots against the union's rows,
    # gathered outside the timing, as one torch._int_mm call
    q8, _, _ = packed_cuda.quantize_queries(q, False)
    rows_t = pv.view(IVF_CELLS, 128, -1)[cells.long()].reshape(
        J_BUDGET * 128, -1).t()
    lib_ms = cuda_ms(lambda: torch._int_mm(q8, rows_t))
    del rows_t
    log(f"phase 3 kernel J: torch._int_mm [{J_QUERIES} x {J_BUDGET * 128}"
        f" x {q.shape[1]}] (product only) {lib_ms:.3f} ms")
    kernels["J"] = dict(
        name="ivf_indirect", route="cuda",
        source="knn_for_homology_tpu_torch/csrc/segment_packed.cu",
        replaces="knn_for_homology_tpu/ops/ivf_pallas.py:55",
        max_abs_err=0.0, ms=ms, plain_ms=plain_ms, library_ms=lib_ms,
        library="torch._int_mm of the gathered int8 rows, product only",
        **j_bound,
    )

    # K: 4096 queries x 32 probes of 128 rows
    sel = torch.randint(0, IVF_CELLS, (K_QUERIES, K_PROBES), generator=gen,
                        device=dev, dtype=torch.int32)
    qk = q_all[:K_QUERIES].contiguous()
    args = (sel, qk, pv, pi, sc, 128)
    got_s, got_n = slab_cuda.beam_expand(*args)
    want_s, want_n = slab_cuda.beam_expand_plain(*args)
    assert torch.equal(got_n, want_n), "K: ids differ from plain"
    fin = torch.isfinite(want_s)
    assert torch.equal(fin, torch.isfinite(got_s)), "K: -inf lanes differ"
    err = float((got_s[fin] - want_s[fin]).abs().max())
    scale = float(want_s[fin].abs().max())
    assert err <= K_RTOL * scale, f"K: max_abs_err {err} > {K_RTOL} x {scale}"
    ms = cuda_ms(lambda: slab_cuda.beam_expand(*args))
    plain_ms = cuda_ms(lambda: slab_cuda.beam_expand_plain(*args))
    # bytes: the queries and probe lists, each slab probed (with its ids and
    # scales) once, the outputs once; operations: an fp32 dot per lane
    touched = int(torch.unique(sel).numel())
    d = qk.shape[1]
    kernels["K"] = dict(
        name="slab_expand", route="cuda",
        source="knn_for_homology_tpu_torch/csrc/slab_expand.cu",
        replaces="knn_for_homology_tpu/ops/graph_pallas.py:139",
        max_abs_err=err, ms=ms, plain_ms=plain_ms, library_ms=None,
        library=None,
        **bound(2 * K_QUERIES * K_PROBES * 128 * d, "fp32",
                tensor_bytes(sel, qk, got_s, got_n)
                + touched * 128 * (d + 8)),
    )
    log(f"phase 3 kernel K slab_expand [{K_QUERIES} x {K_PROBES} probes x 128"
        f" x {d}]: ids equal, max_abs_err {err:.3g}, {ms:.3f} ms vs plain"
        f" {plain_ms:.3f} ms, bound {kernels['K']['bound_ms']:.3f} ms"
        f" ({kernels['K']['bound_by']})")


@contextlib.contextmanager
def plain_ivf_kernels():
    """Kernels J and K swapped for their plain versions (search/ivf.py and
    ops/ivf_cuda.py look them up at each call)."""
    from knn_for_homology_tpu_torch.ops import ivf_cuda, slab_cuda

    swaps = [(ivf_cuda, "segment_packed_indirect_kernel",
              ivf_cuda.segment_packed_indirect_plain),
             (slab_cuda, "beam_expand", slab_cuda.beam_expand_plain)]
    saved = [getattr(mod, name) for mod, name, _ in swaps]
    try:
        for mod, name, plain in swaps:
            setattr(mod, name, plain)
        yield
    finally:
        for (mod, name, _), fn in zip(swaps, saved):
            setattr(mod, name, fn)


@contextlib.contextmanager
def ivf_budgets():
    """The IVF index's debug lines (the union scan's cell budget per query
    block), collected while the block runs."""
    import logging

    lines = []

    class Keep(logging.Handler):
        def emit(self, record):
            lines.append(record.getMessage())

    logger = logging.getLogger("knn_for_homology_tpu_torch.search.ivf")
    handler, level = Keep(logging.DEBUG), logger.level
    logger.addHandler(handler)
    logger.setLevel(logging.DEBUG)
    try:
        yield lines
    finally:
        logger.removeHandler(handler)
        logger.setLevel(level)


def recall_of(got, want):
    """Mean share of each row of `want` found in the same row of `got`."""
    return float(np.mean([len(set(a.tolist()) & set(b.tolist())) / len(b)
                          for a, b in zip(got, want)]))


def run_ivf_path(train, test, kernels):
    """Phase 9: the IVF index path at full width, counts from zero. The
    phase-4 vectors are the proteins (one domain each, its family), the
    pipeline searches all of them against all at k = 1000 with the IVF
    index and the flat index; then the online batch (per-probe path). The
    kernel-vs-plain block and the round trip run after the counts are
    read."""
    import torch

    from knn_for_homology_tpu_torch.data.pfam import get_homologous_proteins
    from knn_for_homology_tpu_torch.eval import analysis
    from knn_for_homology_tpu_torch.ops import (
        exact_cuda,
        flat_cuda,
        ivf_cuda,
        packed_cuda,
        slab_cuda,
    )
    from knn_for_homology_tpu_torch.pipelines import pfam_proteins
    from knn_for_homology_tpu_torch.search.flat import FlatIndex
    from knn_for_homology_tpu_torch.search.io import read_index, write_index
    from knn_for_homology_tpu_torch.search.ivf import IVFIndex

    n = train.shape[0]
    ids = [f"fam{i // FAMILY_TRAIN}_train{i % FAMILY_TRAIN}" for i in range(n)]
    p2d = {p: [(f"F{i // FAMILY_TRAIN}", (0, 100))] for i, p in enumerate(ids)}
    counters = {
        "J": (ivf_cuda, "segment_packed_indirect_kernel"),
        "K": (slab_cuda, "beam_expand"),
        "A": (flat_cuda, "flat_topk_kernel"),
        "B": (exact_cuda, "segment_topr_kernel"),
    }
    with tempfile.TemporaryDirectory(prefix="knn_ivf_") as tmp:
        npy = Path(tmp) / "full_sequences.npy"
        np.save(npy, train)
        for mod, name in counters.values():
            getattr(mod, name).launches = 0
        for key in packed_cuda.segment_packed_kernel.launches:
            packed_cuda.segment_packed_kernel.launches[key] = 0
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        metrics, walls = {}, {}
        with ivf_budgets() as budgets:
            for mode in ("ivf", "flat"):
                t0 = time.perf_counter()
                metrics[mode] = pfam_proteins.run(npy, ids, p2d,
                                                  index_mode=mode, k=BENCH_K,
                                                  device="cuda")
                walls[mode] = time.perf_counter() - t0
        peak = torch.cuda.max_memory_allocated()

    # the online batch: below UNION_MIN_Q, the per-probe path
    t0 = time.perf_counter()
    index = IVFIndex(metric="cosine", nprobe=32, device="cuda").add(train)
    torch.cuda.synchronize()
    build_s = time.perf_counter() - t0
    online = test[:ONLINE_QUERIES]
    assert ONLINE_QUERIES < index.UNION_MIN_Q
    t0 = time.perf_counter()
    _, o_ids = index.search(online, ONLINE_K)
    online_s = time.perf_counter() - t0
    _, exact_ids = FlatIndex(device="cuda").add(train).search(online, ONLINE_K)
    online_recall = recall_of(o_ids, exact_ids)
    launches = {key: getattr(mod, name).launches
                for key, (mod, name) in counters.items()}
    launches.update(packed_cuda.segment_packed_kernel.launches)
    for key in ("J", "K", "B"):
        assert launches[key] > 0, f"kernel {key} was not launched by phase 9"
    kernels["J"]["launches"], kernels["K"]["launches"] = (launches["J"],
                                                          launches["K"])

    for mode, m in metrics.items():
        assert math.isfinite(m["auc1"]) and 0 < m["auc1"] <= 1, (mode, m)
        log(f"phase 9 pfam_proteins {mode}: {n} proteins all-vs-all,"
            f" k={BENCH_K} | build {m['build_seconds']:.3f} s, search"
            f" {m['search_seconds']:.3f} s ({n / m['search_seconds']:.0f}"
            f" queries/s), run {walls[mode]:.1f} s | AUC1 {m['auc1']:.4f},"
            f" recall@300 {m['recall@300']:.4f}")
    assert metrics["ivf"]["auc1"] >= metrics["flat"]["auc1"] - IVF_AUC1_SLACK, (
        metrics["ivf"]["auc1"], metrics["flat"]["auc1"])
    assert online_recall >= ONLINE_RECALL, f"online recall {online_recall}"
    log("phase 9 IVF union scan: " + "; ".join(budgets))
    log(f"phase 9 peak {peak / 2**30:.2f} GiB | online batch: build"
        f" {build_s:.3f} s, {ONLINE_QUERIES} queries at k={ONLINE_K} in"
        f" {online_s * 1e3:.1f} ms (per-probe path), recall {online_recall:.4f}"
        f" against the flat exact top-{ONLINE_K} | launches {launches}")

    # where the IVF all-vs-all search's time goes: device time by kernel
    # over the whole search, then the pipeline's host steps on its hits
    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    with torch.profiler.profile(activities=acts) as prof:
        sims_dev, hits_dev = index.search_device(train, BENCH_K + 1)
        torch.cuda.synchronize()
    search_s = time.perf_counter() - t0
    shares, top = device_time_shares(prof, IVF_KERNELS)
    device_ms = sum(ms for ms, _ in shares.values())
    t0 = time.perf_counter()
    sims, hits = sims_dev.cpu().numpy(), hits_dev.cpu().numpy()
    steps = {"D2H": time.perf_counter() - t0}
    t0 = time.perf_counter()
    hits, _, _ = analysis.remove_self_hit_lossy(hits, sims, np.arange(n))
    steps["self-hit repair"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    homologous = get_homologous_proteins(p2d)
    steps["homologs"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    pfam_proteins.evaluate_protein_hits(hits, ids, homologous)
    steps["AUC1 / recall"] = time.perf_counter() - t0
    log(f"phase 9 profile of the IVF all-vs-all search (wall"
        f" {search_s * 1e3:.1f} ms under the profiler, device busy"
        f" {device_ms / (search_s * 1e3):.3f}): "
        + ", ".join(f"{g} {ms:.1f} ms ({share:.3f})"
                    for g, (ms, share) in shares.items())
        + " | largest of the rest: " + ", ".join(f"{nm} {ms:.1f} ms"
                                                 for nm, ms in top)
        + " | host steps: " + ", ".join(f"{k} {v:.3f} s"
                                        for k, v in steps.items()))
    del sims_dev, hits_dev, sims, hits, homologous

    # one full block through the kernels' route and the plain versions'
    block = train[:index.QUERY_BLOCK]
    got = index.search(block, BENCH_K)
    with plain_ivf_kernels():
        want = index.search(block, BENCH_K)
    assert np.array_equal(got[1], want[1]), (
        f"phase 9: {int((got[1] != want[1]).sum())} ids differ between the"
        " kernels' and the plain versions' routes")
    assert np.array_equal(got[0], want[0])
    _, got_k = index.search(online, ONLINE_K)
    with plain_ivf_kernels():
        _, want_k = index.search(online, ONLINE_K)
    assert np.array_equal(got_k, want_k), "phase 9: per-probe routes differ"

    # write_index / read_index on the card, an index of ROUNDTRIP_ROWS rows
    small = IVFIndex(metric="cosine", nprobe=32, device="cuda").add(
        train[:ROUNDTRIP_ROWS])
    before = small.search(online, ONLINE_K)
    with tempfile.TemporaryDirectory(prefix="knn_ivf_io_") as tmp:
        t0 = time.perf_counter()
        write_index(small, Path(tmp) / "ivf.index")
        loaded = read_index(Path(tmp) / "ivf.index", device="cuda")
        io_s = time.perf_counter() - t0
    after = loaded.search(online, ONLINE_K)
    assert isinstance(loaded, IVFIndex)
    assert np.array_equal(before[1], after[1]) and np.array_equal(
        before[0], after[0]), "phase 9: the round trip changed the results"
    log(f"phase 9 kernels vs plain: a {index.QUERY_BLOCK}-query block at"
        f" k={BENCH_K} (union scan) and the online batch (per-probe) give"
        f" equal ids and scores | round trip of a {ROUNDTRIP_ROWS}-row index"
        f" in {io_s:.2f} s: same ids")


@contextlib.contextmanager
def plain_kernels():
    """The encoder's kernel wrappers swapped for their plain versions, so
    that the same path runs on the card through them (models/t5.py looks
    the wrappers up at each call)."""
    from knn_for_homology_tpu_torch.ops import ffn_cuda, flash_cuda, short_cuda
    from knn_for_homology_tpu_torch.ops.ffn import fused_ffn_plain
    from knn_for_homology_tpu_torch.ops.flash_attention import (
        flash_attention_plain,
    )
    from knn_for_homology_tpu_torch.ops.short_attention import (
        short_attention_plain,
    )

    swaps = [(ffn_cuda, "fused_ffn_t5", fused_ffn_plain),
             (flash_cuda, "flash_attention_t5", flash_attention_plain),
             (short_cuda, "short_attention_t5", short_attention_plain)]
    saved = [getattr(mod, name) for mod, name, _ in swaps]
    try:
        for mod, name, plain in swaps:
            setattr(mod, name, plain)
        yield
    finally:
        for (mod, name, _), fn in zip(swaps, saved):
            setattr(mod, name, fn)


# G runs three CUDA kernels of csrc/ffn_fused.cu (the row norm and two
# GEMMs); H and I are two instantiations of csrc/attention_t5.cuh's kernel
ENCODER_KERNELS = (("G ffn_fused", ("::rms_norm_kernel<", "::gemm_kernel<")),
                   ("H flash_t5", ("attention_t5_kernel<2",)),
                   ("I short_t5", ("attention_t5_kernel<1",)))


def device_time_shares(prof, named=ENCODER_KERNELS):
    """One profiled window's device time: {group: (ms, share)} with the
    `named` groups [(label, name substrings)], cuBLAS products and the rest,
    and the three largest kernels of the rest as [(name, ms)]."""
    from torch.autograd import DeviceType

    named = named + (("cuBLAS products",
                      ("gemm", "cutlass", "xmma", "sm90_", "nvjet")),)
    groups, rest = {}, []
    for ev in prof.key_averages():
        # device events only: an operator's row repeats its kernels' time
        if ev.device_type != DeviceType.CUDA:
            continue
        ms = ev.self_device_time_total / 1e3
        if ms <= 0:
            continue
        name = ev.key.lower()
        group = next((label for label, words in named
                      if any(w in name for w in words)), "rest")
        groups[group] = groups.get(group, 0.0) + ms
        if group == "rest":
            rest.append((ev.key[:60], ms))
    total = sum(groups.values())
    assert total > 0, "the profiler saw no device time"
    top = sorted(rest, key=lambda r: -r[1])[:3]
    return {g: (ms, ms / total) for g, ms in sorted(groups.items())}, top


def check_pooled(name, got, want):
    """Per-protein cosine and relative L2 error of two routes' pooled
    vectors, held to ENC_MIN_COSINE and ENC_MAX_REL_ERR."""
    cos = np.sum(got * want, 1) / (np.linalg.norm(got, axis=1)
                                   * np.linalg.norm(want, axis=1))
    rel = np.linalg.norm(got - want, axis=1) / np.linalg.norm(want, axis=1)
    assert cos.min() >= ENC_MIN_COSINE and rel.max() <= ENC_MAX_REL_ERR, (
        name, float(cos.min()), float(rel.max()))
    return float(cos.min()), rel


def run_encoder(kernels, seed):
    """Phase 8: sequences → ProtT5-XL (24 layers, bf16, random weights from
    torch.Generator("cuda")) → mean-pool → l2 → FlatIndex k = 13, counts
    from zero; then the opt-in short route, a profile of one warm batch,
    and kernels against plain versions on 32 of the proteins."""
    import torch

    from knn_for_homology_tpu_torch.models import t5
    from knn_for_homology_tpu_torch.models.batching import make_batches
    from knn_for_homology_tpu_torch.models.registry import ProtT5Embedder
    from knn_for_homology_tpu_torch.ops import (
        ffn_cuda,
        flash_cuda,
        flat_cuda,
        short_cuda,
    )
    from knn_for_homology_tpu_torch.ops.distance import l2_normalize
    from knn_for_homology_tpu_torch.search.flat import FlatIndex

    dev = torch.device("cuda")
    with tempfile.TemporaryDirectory(prefix="knn_enc_") as tmp:
        _, _, train_seqs, test_seqs = write_dataset(
            Path(tmp), seed + 2, n_fam=ENC_FAMILIES, per_train=ENC_TRAIN, dim=8
        )
    rng = np.random.RandomState(seed + 3)
    long_seqs = [AAS[rng.randint(0, 20, n)].tobytes().decode()
                 for n in LONG_LENGTHS]
    seqs = train_seqs + test_seqs + long_seqs
    n_train = len(train_seqs)

    t0 = time.perf_counter()
    config = t5.PROTT5_XL
    params = t5.init_params(config, seed=seed, device=dev)
    embedder = ProtT5Embedder(config=config, params=params,
                              token_budget=TOKEN_BUDGET, device=dev)
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    n_params = sum(p.numel() for p in embedder.encoder.parameters())
    batches = make_batches(seqs, TOKEN_BUDGET, embedder.max_len)
    residues = sum(min(len(s), embedder.max_len) for s in seqs)
    tokens = sum(len(b.sequences) * b.padded_len for b in batches)

    # the path, counts from zero
    wrappers = {"G": ffn_cuda.fused_ffn_t5, "H": flash_cuda.flash_attention_t5,
                "I": short_cuda.short_attention_t5,
                "A": flat_cuda.flat_topk_kernel}
    for fn in wrappers.values():
        fn.launches = 0
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    pooled = embedder.embed_pooled(seqs)
    embed_s = time.perf_counter() - t0
    vecs = l2_normalize(torch.from_numpy(pooled).to(dev)).cpu().numpy()
    index = FlatIndex(metric="ip", device=dev).add(vecs[:n_train])
    sims, ids = index.search(vecs[n_train:n_train + len(test_seqs)], HITS)
    wall = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated()
    launches = {key: fn.launches for key, fn in wrappers.items()}
    for key in ("G", "H", "A"):
        assert launches[key] > 0, f"kernel {key} was not launched by phase 8"
    assert launches["I"] == 0, "the short kernel is opt-in"
    kernels["G"]["launches"], kernels["H"]["launches"] = (
        launches["G"], launches["H"])
    assert pooled.shape == (len(seqs), config.d_model)
    assert np.isfinite(pooled).all() and np.isfinite(sims).all()
    # same-family share of the top-13 (family f holds rows f*31 .. f*31+30)
    family_hits = float(np.mean(ids // ENC_TRAIN == np.arange(len(test_seqs))[:, None]))
    log(f"phase 8 encoder path: ProtT5-XL {config.num_layers} layers,"
        f" {n_params / 1e9:.3f} B parameters (init {init_s:.2f} s) |"
        f" {len(seqs)} proteins, {residues} residues, {len(batches)} batches,"
        f" {tokens} padded tokens | embed {embed_s:.3f} s ({residues / embed_s:.0f}"
        f" residues/s), embed + search {wall:.3f} s | peak {peak / 2**30:.2f} GiB"
        f" (G's h scratch at the token budget:"
        f" {TOKEN_BUDGET * config.d_ff * 2 / 2**30:.2f} GiB)"
        f" | top-{HITS} same-family share {family_hits:.4f} | launches {launches}")

    # the opt-in short route: kernel I
    short_seqs = [s for s in train_seqs if len(s) < 512][:64]
    short_embedder = ProtT5Embedder(
        config=dataclasses.replace(config, use_short_kernel=True),
        params=params, token_budget=TOKEN_BUDGET, device=dev,
    )
    wrappers["I"].launches = 0
    pooled_short = short_embedder.embed_pooled(short_seqs)
    kernels["I"]["launches"] = wrappers["I"].launches
    assert kernels["I"]["launches"] > 0, "kernel I was not launched"
    rows = [seqs.index(s) for s in short_seqs]
    cos, rel = check_pooled("short route", pooled_short, pooled[rows])
    log(f"phase 8 short route: {len(short_seqs)} proteins, kernel I launches"
        f" {kernels['I']['launches']}, pooled vs the dense route: cosine min"
        f" {cos:.6f}, relative L2 error max {rel.max():.4g}")

    # warm batches under the profiler, device time by kernel: the median
    # batch (dense attention) and the longest (flash)
    by_len = sorted(batches, key=lambda b: b.padded_len)
    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    for batch in (by_len[len(by_len) // 2], by_len[-1]):
        embedder.pooled_batch(batch)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        with torch.profiler.profile(activities=acts) as prof:
            embedder.pooled_batch(batch)
            torch.cuda.synchronize()
        batch_s = time.perf_counter() - t0
        shares, top = device_time_shares(prof)
        log(f"phase 8 profile, one warm batch of {len(batch.sequences)} x"
            f" {batch.padded_len} (wall {batch_s * 1e3:.1f} ms under the"
            " profiler): " + ", ".join(f"{g} {ms:.1f} ms ({share:.3f})"
                                       for g, (ms, share) in shares.items())
            + " | largest of the rest: "
            + ", ".join(f"{n} {ms:.1f} ms" for n, ms in top))

    # kernels against plain versions on 32 proteins, one of them long
    subset = test_seqs[:31] + [long_seqs[2]]
    got = embedder.embed_pooled(subset)
    with plain_kernels():
        want = embedder.embed_pooled(subset)
    cos, rel_err = check_pooled("kernels vs plain", got, want)
    qg = l2_normalize(torch.from_numpy(got[:31]).to(dev)).cpu().numpy()
    qw = l2_normalize(torch.from_numpy(want[:31]).to(dev)).cpu().numpy()
    db = vecs[:n_train]
    sims_g, sims_w = qg @ db.T, qw @ db.T
    _, ids_g = index.search(qg, HITS)
    _, ids_w = index.search(qw, HITS)
    tie = 2 * float(np.abs(sims_g - sims_w).max())
    rows_, cols_ = np.nonzero(ids_g != ids_w)
    for r, c in zip(rows_, cols_):
        gap = abs(sims_w[r, ids_g[r, c]] - sims_w[r, ids_w[r, c]])
        assert gap <= tie, f"phase 8: id swap at ({r}, {c}) with gap {gap} > {tie}"
    log(f"phase 8 kernels vs plain on {len(subset)} proteins: pooled cosine"
        f" min {cos:.6f}, relative L2 error max {rel_err.max():.4g}"
        f" (long one {rel_err[-1]:.4g}); top-{HITS} ids differ in"
        f" {rows_.size} of {ids_g.size} slots, all near-ties within {tie:.3g}")


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
        warm_card()
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
            max_abs_err=err, ms=ms, plain_ms=plain_ms, library_ms=None,
            library=None,
            **bound(2 * q.shape[0] * N_TRAIN * DIM, "fp32",
                    tensor_bytes(db, q, *got)),
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
            library_ms=None,
            library=None,
            **bound(2 * q.shape[0] * N_TRAIN * DIM, "fp32",
                    tensor_bytes(db, q, *bufs)),
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
        c_err, c_ms, c_plain_ms, c_ops, c_bytes = 0.0, 0.0, 0.0, 0, 0
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
            plain_ms = cuda_ms(  # ~0.5 s a call: windows of one call
                lambda: align_cuda.sw_scores_grouped_plain(qd, td, **kw), reps=1
            )
            c_ms, c_plain_ms = c_ms + ms, c_plain_ms + plain_ms
            c_ops += SW_OPS_PER_CELL * g_pad * 128 * lq_b * lt_b
            c_bytes += tensor_bytes(qd, td, k_out)
            log(f"phase 3 kernel C sw_grouped block G={g_pad} Lq={lq_b}"
                f" K=128 Lt={lt_b} S={s_b}: bit-equal (both conventions),"
                f" {ms:.3f} ms vs plain {plain_ms:.3f} ms")
        kernels["C"] = dict(
            name="sw_grouped", route="cuda",
            source="knn_for_homology_tpu_torch/csrc/sw_grouped.cu",
            replaces="knn_for_homology_tpu/ops/align_pallas.py:179",
            max_abs_err=c_err, ms=c_ms, plain_ms=c_plain_ms, library_ms=None,
            library=None,
            **bound(c_ops, "fp32", c_bytes),
        )

        check_encoder_kernels(kernels, args.seed)
        check_ivf_kernels(db, q_all, kernels, args.seed)

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

    # ---- phase 8: the encoder path
    run_encoder(kernels, args.seed)

    # ---- phase 9: the IVF index path, on phase 4's vectors
    del db, q_all, index, plain
    torch.cuda.empty_cache()
    run_ivf_path(train, test, kernels)

    log(card)
    print(json.dumps({"kernels": [kernels[k] for k in "ABCDEFGHIJK"]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}), flush=True)


if __name__ == "__main__":
    main()
