#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py [--seed 0]

Drives the port's main path — the reference's `seqvec_search` benchmark:
flat kNN → AUC1/TP → Smith-Waterman rescoring → AUC1/TP — at ProtT5-XL's
width (d = 1024) on n = 131072 database vectors and 4096 queries, then the
exact k = 1000 search on the same index. Phases:

  1. environment: a CUDA device is required; prints the card and its limit;
  2. build: compiles the three CUDA kernels from knn_for_homology_tpu_torch/
     csrc/ (a fresh checkout has no build) and prints the seconds;
  3. each kernel against its plain PyTorch version on the card, at the
     shapes the main path gives it, with times;
  4. the main path end to end (pipelines.benchmark.run on a seeded dataset
     written in the standard layout), launch counts reset just before;
  5. exact k = 1000 through FlatIndex.search on the same index;
  6. the small-input check: the same pipeline on a small fixture on the
     card and on the CPU (plain versions) must give identical results.

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
def check_topk(name, got, want, db, queries):
    """Kernel vs plain top-k: the sorted scores agree within SCORE_ATOL at
    every rank, ids agree except swaps among such near-equal scores (each
    differing id's reported score is checked against an fp64 dot), and no
    row repeats an id. Returns (max abs score error, differing slots)."""
    import torch

    (gv, gi), (wv, wi) = got, want
    assert gv.shape == wv.shape and gi.shape == wi.shape, name
    finite = torch.isfinite(wv)
    assert torch.equal(finite, torch.isfinite(gv)), f"{name}: -inf slots differ"
    err = float((gv[finite] - wv[finite]).abs().max()) if finite.any() else 0.0
    assert err <= SCORE_ATOL, f"{name}: scores differ by {err}"
    rows, cols = torch.nonzero(gi != wi, as_tuple=True)
    if rows.numel():
        q64 = queries[rows].double()
        for ids, vals in ((gi, gv), (wi, wv)):
            exact = (q64 * db[ids[rows, cols].long()].double()).sum(1)
            bad = (vals[rows, cols].double() - exact).abs().max()
            assert bad <= SCORE_ATOL, f"{name}: a swapped id's score is off by {bad}"
    srt = torch.sort(gi, dim=1).values
    dup = (srt[:, 1:] == srt[:, :-1]) & (srt[:, 1:] >= 0)
    assert not dup.any(), f"{name}: repeated ids in a row"
    return err, int(rows.numel())


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
    from knn_for_homology_tpu_torch.ops import align_cuda, exact_cuda, flat_cuda
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

    log(card)
    print(json.dumps({"kernels": [kernels[k] for k in ("A", "B", "C")]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}), flush=True)


if __name__ == "__main__":
    main()
