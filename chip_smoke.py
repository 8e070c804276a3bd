#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py [--seed 0]

Drives the port's paths. The reference's `seqvec_search` benchmark —
flat kNN → AUC1/TP → Smith-Waterman rescoring → AUC1/TP — at ProtT5-XL's
width (d = 1024) on n = 131072 database vectors and 4096 queries, then the
exact k = 1000 search on the same index; and the headline bench
(knn_for_homology_tpu_torch/bench.py): flat all-vs-all at n = 131072,
d = 1024, k = 1000 in every mode; the ProtT5 encoder path, sequences
→ pooled embeddings → neighbours; the full-protein path (the graph index,
its default, and the IVF index); the paper pipelines (the LSH index
CLI, the Pfam20 domain and full-protein workloads, CATH20); the sharded
path; and the MMseqs2 record I/O. Phases:

  1. environment: a CUDA device is required; prints the card and its limit;
  2. build: compiles the CUDA kernels from knn_for_homology_tpu_torch/
     csrc/ (a fresh checkout has no build) and prints the seconds;
  3. each kernel against its plain PyTorch version on the card, at the
     shapes its path gives it, with times (D, E, F: 1024 queries of the
     bench's plan from plan_fingerprint, which must be the plan the recall
     anchors hold at: W = 256, R = 7, R = 9 for sym2; F and J beside the
     passes one product spans in their plan, P);
  4. the main path end to end (pipelines.benchmark.run on a seeded dataset
     written in the standard layout), launch counts reset just before;
     then a second, warm run under torch.profiler: kernel C's device time,
     launches and GCUPS over the real cells, the host-to-device copies and
     the device's busy share;
  5. exact k = 1000 through FlatIndex.search on the same index; the
     approx and sq8 backends reach kernels A and F (every F launch of the
     sq8 search spanning more than one pass a product);
  6. the small-input check: the same pipeline on a small fixture on the
     card and on the CPU (plain versions) must give identical results;
  7. the port's bench at the headline shape (default modes, plus sq8 so
     kernel E runs, plus the sq8-sym2 high-recall point), launch counts
     reset just before; its JSON line, recalls against the reference
     algorithm's (0.9767 sq8-sym, 0.9813 approx, hi ≥ 0.985); then one
     query block of the exact mode, kernel B and its epilogue timed apart;
  8. the encoder path: ProtT5-XL at full width (24 layers, bf16, random
     weights from a seeded torch.Generator on the card) embeds 1028
     proteins (32 families x 32 of the length mix, plus four long ones
     for the flash route) in 7000-token batches, then l2 and a FlatIndex
     k = 13 search, launch counts reset just before (G, H, I, A); the
     dense torch attention route against I; device time by kernel over warm batches;
     the kernels' route against the plain versions' on 32 proteins; then
     ProtXLNet-UniRef100 in bf16 (kernel L) embeds the same proteins, L
     launched once a layer a batch, 8 of them held to its fp32 route;
  9. the full-protein path (pipelines.pfam_proteins.run, the all-vs-all
     k = 1000 search) over phase 4's 131072 x 1024 vectors as full-protein
     embeddings, one domain (the family) per protein, launch counts reset
     just before each mode: the graph index (the pipeline's default: the
     exact kNN graph through kernel B, then 62 beam steps a query block,
     each one call of kernel K, the block one captured CUDA graph: K counts
     the launches of a capture's eager warm-up, GraphIndex.graph_replays
     the replays; its build steps timed apart), the IVF
     index (kernel J, the union scan with sym2) and the flat index (kernel
     B); an online batch of 256 queries at k = 10 through the IVF
     per-probe path (kernel K's tile route) against the flat exact
     top-10, then on an index of 16384 cells (K's pair route), on the
     graph index and on a kNN-descent graph; one 4096-query IVF block, a
     256-query graph block at k = 1000 and the online batches through the
     kernels' route and the plain versions' route; write_index /
     read_index round trips of an IVF and a graph index on the card;
 10. the paper pipelines on phase 4's dataset, launch counts reset just
     before: (a) the index CLI (search/cli.py) builds the reference's
     1024-bit LSH index over train.npy, read back on the card, its signs
     held to an fp64 host sketch of 256 rows; (b) the Pfam20 domain
     workload (pipelines.pfam_domains.run) on that file, 4096 queries at
     k = 1000, then the top 13 rescored by Smith-Waterman (kernel C); (c)
     the LSH card route (torch._int_mm + unique int32 / int64 keys + topk)
     against its plain route on the card (bit-equal), with the product and
     three selections timed apart at (b)'s shape; (d) the full-protein
     pipeline's lsh mode (2048 bits) all-vs-all at k = 1000 over the
     131072 vectors; (e) CATH20's all-vs-all search (cosine and l2,
     k = 10, kernel A; 14433 seeded vectors and C/A/T/H labels) and its
     top-1 evaluation, A held to the plain route;
 11. the other encoder families through the registry (models/{elmo,bert,
     xlnet,unirep,plus_rnn,cpcprot}.py; plain PyTorch, fp32: cuBLAS
     products, cuDNN convolutions, the recurrences as step loops): SeqVec,
     ESM, ESM1b, ProtBert BFD, ProtAlbert BFD, ProtXLNet UniRef100, UniRep,
     PLUS and CPCProt at their published shapes (weights from a seeded
     torch.Generator on the card) embed 64 proteins of the length mix plus
     one of 1100 aa (ESM's 1022-residue cut); residues/s, batches, padded
     tokens and peak memory per key; each key's pooled vectors of two
     short proteins on the card against the same encoder on the CPU; a
     profile of one warm batch of each key (device time by group,
     launches, per recurrent step where there are steps, busy share); then the seeded SeqVec weights saved as
     a converted .npz and run through `embed-domains` (its default
     embedder) and `embed-one --embedder SeqVec` as subprocesses, their
     outputs held to the registry's;
 12. the sharded path (parallel/) on phase 4's vectors, launch counts reset
     after the unsharded counterparts are computed: (a) one NCCL rank in
     this process at full width, 131072 x 1024 and 4096 queries:
     db_sharded_topk at k = 1000 over all rows with n_valid 131071
     (kernel B masks the pad row), ShardedFlatIndex (B) and its sq8-sym
     storage (F), ShardedIVFIndex per-probe (K) and union (J),
     ShardedGraphIndex (B builds, K searches), ShardedLSHIndex and a
     ShardSweep of two spilled graph shards, each held to the port's
     unsharded index of its kind, with recall@10 against the flat exact
     top-10; (b) two gloo ranks sharing the card (collectives staged
     through host memory): the same indexes over 32768 rows and 1024
     queries, held to the dry run's goldens (ids of the exact top-k; IVF
     at a covering nprobe and budget; LSH bit-equal), and encode_sharded
     at ProtT5-XL width (16 + 16 heads, d_ff 8192 + 8192, kernels G
     without the residual, H) on 64 proteins of the length mix and one of
     1500 aa, held to the unsharded T5Encoder within phase 8's bound; (c)
     dryrun_multichip(2) on gloo ranks of the card; (d) align_pairs /
     sw_scores on 4096 pairs of the main path's mix through C (one lane a
     group), bit-equal to the plain version, with GCUPS.
 13. the MMseqs2 record I/O on the host (interop/mmseqs_format.py), native
     counts reset just before: the prefilter writer and the result reader
     on their native route (interop/native/mmseqs_io.cpp, built with g++
     at first use) and on their Python route, at 131072 queries x 13 hits
     and 32768 x 300 (a seeded 1% of the hits missing) and on an
     alignment-format result DB of the same shapes; the native route must
     run, its files must be byte-equal and its arrays equal to the Python
     route's; both routes' seconds, beside the card's name and limit.

Phase 3 holds kernel A (its FFMA product) at 1024 queries, k = 13, and
kernel B (3xTF32 wgmma products) at 512 queries of the exact k = 1000 plan,
each beside two bounds (bound_ms: the 3xTF32 product, three products at
the TF32 rate, the card's least time for an fp32-accurate product;
bound_fp32_ms: the fp32 FFMA product, A's own design) and one fp32
torch.matmul of the product alone as the yardstick; B also runs with one
query repeated on the database as it is and sorted by that query's
similarity, which splits that proxy's time between products and inserts. A's and B's entries count their launches in every
phase that runs them (launches_by_phase). Phase 3 also holds the encoder's
kernels at full width: G at 7000 tokens x
1024 x 16384, H at 2 x 32 heads x 3200 x 128, I at 13 x 32 x 512 x 128,
27 x 32 x 256 x 128 and 6 x 32 x 1024 x 128 (H and I fed the [H, 2L-1]
offset-bias table), L at
2 x 16 x 3098 x 64 (one row 2002 tokens; R one row off must fail); and the
IVF path's kernels: J at 1024 queries x 256 cells (32768 rows) x 1024, k =
1000 (sym and sym2, buffers bit-equal); K at 32 probes x 128 x 1024 and
four sharing levels of the probed nodes: (a) 4096 queries uniform over the
2048 cells (~64 pairs a node), (b) 256 queries uniform (phase 9's online
shape, ~4), (c) 64 queries probing every cell once, (d) 256 queries
uniform over 16384 cells (~0.5, the online batch of an index 8x phase
9's), and (g0-g61) the probe lists of steps 0, 20, 40 and 61 of the
graph index's beam search over one 2048-query block of phase 4's vectors
at k = 1001 (the pipeline's own traffic; that block is then profiled);
each case on the route K chooses, its launches counted, and on both
of K's routes (tiles: 2xTF32 wgmma; pairs: a block a query, fp32 FFMA),
each held to plain; each beside the card's least time (bound_ms: the
bytes, or the fp32-accurate product at the faster of two TF32 or three
bf16 products), the tile route's own two-TF32 bound (bound_2xtf32_ms) and
the fp32 FFMA bound (bound_fp32_ms), K's entry "sharing" holding all four. Library yardsticks, which the port never calls: for G, its two
products as two bf16 torch.matmul calls (with the relu between them); for
H and I, scaled_dot_product_attention; for F and J, torch._int_mm on the
same int8 operands (the product only: no scales, no top-R slots). Each
kernel's entry names its yardstick under "library" (null where there is
none), since for G, F and J it is not one call computing the same
function. Every kernel's line carries its bound: the least time the card could take, from
its operations and bytes (PEAK_OPS, HBM_BYTES_PER_S); C's counts the real
DP cells of its four phase-3 blocks (sum of len(q) * len(t) over their
pairs) at the int32 rate, and its entry adds their GCUPS (giga cell
updates per second). C's phase-3 blocks are the main path's own: the card
plan (iter_card_blocks) of every test query against its family's first 13
train members, so a block holds more lanes than the kernel's persistent
grid holds warps, as on the main path.
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
# int32: 132 SMs x 64 INT32 lanes a clock (the Hopper SM's four partitions
# of 16; NVIDIA's Hopper architecture white paper) x 1980 MHz, the H100
# SXM's maximum SM clock (nvidia-smi clocks.max.sm; phase 1 prints it)
PEAK_OPS = {"fp32": 67e12, "tf32": 495e12, "bf16": 989e12, "int8": 1979e12,
            "int32": 132 * 64 * 1980e6}
HBM_BYTES_PER_S = 3.35e12
# Smith-Waterman cell, in int32: substitution lookup + add, two gap
# updates of two ops each, a four-way max, the running best: ~10 scalar
# ops, counted over real cells (sum of len(q) * len(t) over the pairs), at
# PEAK_OPS["int32"]
SW_OPS_PER_CELL = 10
# kernel vs plain in bf16: both round their result once from fp32 sums taken
# in other orders (H's p also at other running maxima), an ulp or two apart;
# allowed: 2^-6 of the largest |value| (4 bf16 ulps there)
BF16_TOL = 2.0**-6
# the port's hand-written kernels, by letter (PERF.md §6)
KERNEL_LETTERS = "ABCDEFGHIJKLM"
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
# phase 11: the other encoder families at their published shapes (random
# weights from a seeded torch.Generator on the card) through the registry:
# OTHER_PROTEINS proteins of the repo's length mix (phase 8's lognormal,
# median 330 aa) plus one of OTHER_LONG aa, which ESM cuts at 1022 residues
OTHER_PROTEINS, OTHER_LONG = 64, 1100
# key → (model module name, published config name); ESM and ESM1b share one
# config and one set of weights
OTHER_KEYS = {
    "SeqVec": ("elmo", "SEQVEC"),
    "ESM": ("bert", "ESM1B"),
    "ESM1b": ("bert", "ESM1B"),
    "ProtBert BFD": ("bert", "PROTBERT"),
    "ProtAlbert BFD": ("bert", "PROTALBERT"),
    "ProtXLNet UniRef100": ("xlnet", "PROTXLNET"),
    "UniRep": ("unirep", "UNIREP"),
    "PLUS": ("plus_rnn", "PLUS_RNN"),
    "CPCProt": ("cpcprot", "CPCPROT"),
}
# phase 11, card vs CPU at full width: each key's pooled vectors of two
# proteins on the card and through the same encoder on the CPU (the card's
# weights moved across). Every family is fp32 on both devices (TF32 off),
# so the two sum the same products in other orders, an ulp or so apart. The
# transformers, PLUS and CPCProt keep that size at any length
# (scripts/torch_recurrence_drift.py: a one-ulp change of every weight
# moves their pooled vectors by ~1e-6 at 4 to 64 aa); with these random
# weights SeqVec's second LSTM and UniRep's mLSTM are chaotic and grow it
# with the length (SeqVec 1.5e-5 at 8 aa, 4.5e-4 at 16, 3.3e-2 at 64;
# UniRep 8.4e-6 at 16 aa, 4.4e-3 at 64; CPU). So those two are held at
# OTHER_AGREE_LEN, where that drift is at most 1.5e-5, and their drift at
# OTHER_DRIFT_LENGTHS is logged, not held. Measured worst held: a relative
# L2 error of 1.88e-5 (SeqVec at 8 aa; the other keys ≤ 5.5e-6), cosines
# 1 - 1e-9 or closer (H100, 700 W); unheld, SeqVec drifted to 0.036 at
# 64 aa and UniRep to 0.145. Allowed: a relative L2 error of
# OTHER_MAX_REL_ERR (5x the worst measured) and a cosine of
# OTHER_MIN_COSINE.
OTHER_HELD_LEN = 64
OTHER_AGREE_LEN = {"SeqVec": 8, "UniRep": 16}
OTHER_DRIFT_LENGTHS = (8, 16, 32, 64)
OTHER_MIN_COSINE = 1 - 1e-7
OTHER_MAX_REL_ERR = 1e-4
# phase 11 profile groups (device time of one warm batch)
OTHER_GROUPS = (("GEMMs", ("gemm", "cutlass", "xmma", "sm90_", "nvjet",
                           "gemv", "dot_kernel")),
                ("elementwise", ("elementwise", "vectorized", "unrolled")),
                ("reductions", ("reduce", "softmax", "norm", "cat", "gather",
                                "index")))
# phase 3, kernels J and K at the IVF path's shapes: the phase-9 index's
# 2048 cells of 64 members (the auto sizing, half full); J scans 256 of
# them for 1024 queries at k = 1000, K expands 32 probes for 4096 queries
# (and for 256 and 64, and 256 over WIDE_CELLS cells, check_ivf_kernels)
IVF_CELLS, IVF_FILL = 2048, 64
# phase 9's second online index, and phase 3's K case (d): 8 rows a cell
# at 131072 rows, so that 256 queries x 32 probes touch most cells once
# (kernel K's pair route)
WIDE_CELLS = 16384
J_QUERIES, J_BUDGET = 1024, 256
K_QUERIES, K_PROBES = 4096, 32
K_RTOL = 1e-5  # K's fp32 sums of 1024 products, in another order than plain
# phase 9: IVFIndex(cosine, nprobe=32) at k = 1000, the pipeline's own;
# AUC1 may fall at most this far below the flat index's; the online batch
# (per-probe path) must recall this share of the flat exact top-10
IVF_AUC1_SLACK = 0.01
ONLINE_QUERIES, ONLINE_K, ONLINE_RECALL = 256, 10, 0.99
ROUNDTRIP_ROWS = 16384
# phases 3 and 9: the full-protein pipeline's graph index,
# GraphIndex(cosine, degree=42, beam_width=256) (pipelines/pfam_proteins.py);
# at k = 1000 a query block runs iters = 62 beam steps, each one call of
# kernel K (in the capture's warm-up; a replay repeats them). Phase 3 records K's probe lists at GRAPH_STEPS of the first
# block of phase 4's vectors (in family order, as the pipeline searches
# them) and holds K to plain on them, as its other cases
GRAPH_DEGREE, GRAPH_BEAM = 42, 256
GRAPH_STEPS = (0, 20, 40, 61)
# phase 9: a 256-query block at k = 1000 through the kernels' route and
# the plain versions' (K within K_RTOL of plain can turn a beam at a
# near-tie): at least this share of the plain route's ids found, and the
# scores of ids found by both within SCORE_ATOL (both are the fp32
# rescore of the same rows). The online batch (k = 10) on the exact graph:
# at least GRAPH_ONLINE_FAMILY of its hits in the query's own family. Its
# recall of the flat exact top-10 is logged, not bounded: the reference
# rescores only the beam's first k entries, ranked by the int8 traversal
# scores, and a family's 32 members lie closer together than that
# quantisation resolves
GRAPH_BLOCK_IDS = 0.999
GRAPH_ONLINE_FAMILY = 0.99
# phase 3 profile groups of one graph block: kernel K (its two launches
# and its tile plan), the sorts (the expand pick, the beam rebuild, the
# duplicate masks, the entry seeding), the gathers and scatters
GRAPH_KERNELS = (("K slab_expand", ("slab_expand", "slab_tiles")),
                 ("sort / top-k", ("sort", "radix", "bitonic", "topk")),
                 ("gather / scatter", ("index", "gather", "scatter")))
# phase 10: the reference's LSH index (seqvec_search_create_index's default
# 1024 bits), its sketches held to an fp64 host sketch on FLIP_ROWS rows:
# a sign may flip only where |x.p| is within the fp32 rounding bound of a
# DIM-term dot product in any order, DIM * 2^-24 * sum_i |x_i p_i| (phase
# 4's rows have norms near 320, so that bound is ~0.5, not 1e-4); the LSH
# kNN on phase 4's families must find them first
LSH_BITS, FLIP_ROWS, LSH_AUC1_MIN = 1024, 256, 0.99
# phase 10 (e): CATH20's size (14433 domains, PARITY.md), seeded labels:
# CATH_SUPERFAMILIES superfamilies at CATH_SIGNAL x unit-noise centroids
CATH_DOMAINS, CATH_SUPERFAMILIES, CATH_SIGNAL = 14433, 2000, 0.5
CATH_TOP1_MIN = 0.5
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


def real_cells(block) -> int:
    """DP cells an alignment block needs: sum of len(row) * len(lane
    target) over its pairs (no pad rows, columns, lanes or separators)."""
    return sum(len(row_seq) * len(seq) for row_seq, lanes in block
               for lane in lanes for seq, _, _ in lane)


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


def product_bounds(q_n, db, q, outputs):
    """A's and B's bounds (PERF.md §6): the fp32 FFMA product, 2·Q·N·d
    operations at the fp32 rate, and the 3xTF32 one, three such products at
    the TF32 rate; bytes: both operands once, the outputs once."""
    n, d = db.shape
    nbytes = tensor_bytes(db, q, *outputs)
    fp32 = bound(2 * q_n * n * d, "fp32", nbytes)
    tf32 = bound(3 * 2 * q_n * n * d, "tf32", nbytes)
    return fp32, tf32


def matmul_ms(q, db):
    """The yardstick of A and B: one fp32 torch.matmul of the product alone
    (TF32 off, as the package sets it; no selection), which the port never
    calls."""
    import torch

    assert not torch.backends.cuda.matmul.allow_tf32
    return cuda_ms(lambda: torch.matmul(q, db.T))


def check_search_kernels(db, q_all, kernels):
    """Phase 3 for kernels A and B. A (FFMA product, k = 13, 1024 queries)
    and B (3xTF32 wgmma products, 512 queries at the exact k = 1000 plan)
    against their plain versions (ids equal up to near-ties within
    SCORE_ATOL), B's rescue path against the full sort; each beside both
    bounds (product_bounds) and the fp32 torch.matmul yardstick. B's time is
    then split between products and inserts without a knob: the same call
    with one query repeated, on the database as it is and reordered so the
    query's similarity falls with the pass index (then only the first R
    passes insert anything)."""
    import torch

    from knn_for_homology_tpu_torch.ops import exact_cuda, flat_cuda

    q = q_all[:1024].contiguous()
    got = flat_cuda.flat_topk_kernel(db, q, HITS, "cosine")
    want = flat_cuda.flat_topk_plain(db, q, HITS, "cosine")
    err, swaps = check_topk("A", got, want, db, q)
    ms = cuda_ms(lambda: flat_cuda.flat_topk_kernel(db, q, HITS, "cosine"))
    plain_ms = cuda_ms(lambda: flat_cuda.flat_topk_plain(db, q, HITS, "cosine"))
    fp32, tf32 = product_bounds(q.shape[0], db, q, got)
    lib_ms = matmul_ms(q, db)
    kernels["A"] = dict(
        name="flat_topk", route="cuda",
        source="knn_for_homology_tpu_torch/csrc/flat_topk.cu",
        replaces="knn_for_homology_tpu/ops/flat_pallas.py:51",
        max_abs_err=err, ms=ms, plain_ms=plain_ms, library_ms=lib_ms,
        library="fp32 torch.matmul, product only", product="fp32 FFMA",
        bound_fp32_ms=fp32["bound_ms"], bound_tf32x3_ms=tf32["bound_ms"],
        **tf32,
    )
    log(f"phase 3 kernel A flat_topk [1024 x {N_TRAIN} x {DIM}, k={HITS}]:"
        f" max_abs_err {err:.3g}, {swaps} near-tie swaps, {ms:.3f} ms vs plain"
        f" {plain_ms:.3f} ms, fp32 torch.matmul {lib_ms:.3f} ms, bound"
        f" {tf32['bound_ms']:.3f} ms 3xTF32 ({fp32['bound_ms']:.3f} ms fp32"
        " FFMA, A's own product)")

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
    fp32, tf32 = product_bounds(q.shape[0], db, q, bufs)
    lib_ms = matmul_ms(q, db)
    # products vs inserts: one query repeated, the db as it is and sorted
    # by that query's similarity, descending (the same products; the
    # sorted lanes insert only in their first R passes)
    q1 = q[:1].expand(q.shape[0], -1).contiguous()
    order = torch.argsort(db @ q[0], descending=True)
    db_sorted = db[order].contiguous()
    one_ms = cuda_ms(lambda: exact_cuda.segment_topr_kernel(db, q1, w, r,
                                                           "cosine"))
    sorted_ms = cuda_ms(lambda: exact_cuda.segment_topr_kernel(
        db_sorted, q1, w, r, "cosine"))
    del db_sorted, order
    kernels["B"] = dict(
        name="segment_topr", route="cuda",
        source="knn_for_homology_tpu_torch/csrc/segment_topr.cu",
        replaces="knn_for_homology_tpu/ops/exact_pallas.py:126",
        max_abs_err=max(err, err_r), ms=ms, plain_ms=plain_ms,
        library_ms=lib_ms, library="fp32 torch.matmul, product only",
        product="3xTF32 wgmma",
        bound_fp32_ms=fp32["bound_ms"], bound_tf32x3_ms=tf32["bound_ms"],
        one_query_ms=one_ms, one_query_sorted_db_ms=sorted_ms,
        **tf32,
    )
    log(f"phase 3 kernel B segment_topr [512 x {N_TRAIN} x {DIM}, k=1000,"
        f" W={w}, R={r}]: max_abs_err {err:.3g}, {swaps} swaps,"
        f" {suspect} suspect rows, {ms:.3f} ms vs plain {plain_ms:.3f} ms,"
        f" fp32 torch.matmul {lib_ms:.3f} ms, bound {tf32['bound_ms']:.3f} ms"
        f" 3xTF32 ({fp32['bound_ms']:.3f} ms fp32 FFMA); forced R=2 with"
        f" rescue vs full sort: max_abs_err {err_r:.3g}, {swaps_r} swaps;"
        f" one query repeated: {one_ms:.3f} ms, on the db sorted by its"
        f" similarity (inserts in the first R passes only) {sorted_ms:.3f} ms,"
        f" inserts {one_ms - sorted_ms:.3f} ms"
        f" ({(one_ms - sorted_ms) / one_ms:.1%} of the one-query run)")


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

    # F: int8 queries (sym, R = 7; sym2, R = 9), buffers bit-equal; the
    # passes one product spans in each plan
    f_times, f_groups = {}, {}
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
        f_groups[storage] = pc.passes_per_product(storage, N_TRAIN, DIM, w,
                                                  r_f)
        log(f"phase 3 kernel F segment_packed_sq8sym {storage} {line},"
            f" R={r_f}]: buffers bit-equal, {f_times[storage][0]:.3f} ms"
            f" (P = {f_groups[storage]} passes a product) vs"
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
        passes_per_product=f_groups, **f_bound,
    )


def exact_mode_split(args, kernels):
    """Phase 7: one query block of the bench's exact mode, its kernel B call
    and its epilogue (the int64-key torch.topk over [block, R·W], the
    certificate) timed apart with CUDA events on the bench's own database
    (seed 0, bf16 rows widened to fp32), after one warm call of each."""
    import torch

    from knn_for_homology_tpu_torch.ops import exact_cuda
    from knn_for_homology_tpu_torch.ops.distance import l2_normalize

    gen = torch.Generator(device="cuda").manual_seed(0)
    db = l2_normalize(torch.randn(args.n, args.d, generator=gen, device="cuda")
                      ).to(torch.bfloat16).to(torch.float32)
    w, r = exact_cuda.plan(args.n, args.k, exact_cuda.default_db_tile(args.k))
    block = min(args.n, exact_cuda.CANDIDATE_BYTES // (r * w * 8))
    q = db[:block]
    times = {}
    for name, fn in (("kernel", lambda: exact_cuda.segment_topr_kernel(
            db, q, w, r, "ip")), ("epilogue", None)):
        if fn is None:
            bufs = exact_cuda.segment_topr_kernel(db, q, w, r, "ip")
            fn = lambda: exact_cuda.epilogue(*bufs, args.k, w, r)  # noqa: E731
        fn()
        torch.cuda.synchronize()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        torch.cuda.synchronize()
        times[name] = start.elapsed_time(end)
    del bufs
    kernels["B"]["exact_mode_block"] = dict(queries=block, **{
        f"{name}_ms": ms for name, ms in times.items()})
    log(f"phase 7 exact mode, one block of {block} queries (W={w}, R={r}):"
        f" kernel B {times['kernel']:.3f} ms, epilogue (int64 top-k over"
        f" [{block}, {r * w}], certificate) {times['epilogue']:.3f} ms")


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
    kernels["B"]["launches_by_phase"]["7"] = b_launches
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
    exact_mode_split(args, kernels)
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
    second sweep recomputes q.k: 1.5x that on the card). I also runs at two
    more 7000-token batches, at the length mix's median (27 x 256) and at
    the route's limit (6 x 1024), printed beside their SDPA times."""
    import torch
    import torch.nn.functional as F

    from knn_for_homology_tpu_torch.models import t5
    from knn_for_homology_tpu_torch.models.t5 import offset_bias_table
    from knn_for_homology_tpu_torch.ops import ffn_cuda, flash_cuda, short_cuda
    from knn_for_homology_tpu_torch.ops.ffn import fused_ffn_plain
    from knn_for_homology_tpu_torch.ops.flash_attention import (
        flash_attention_plain,
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
    # G's partial-sum epilogue (residual=False), at one rank's shapes in
    # phase 12's tensor-parallel encoder: d_ff split over two ranks, wi's
    # column half and wo's row half
    half = f // 2
    tp_args = (x, ln, wi[:, :half].contiguous(), wo[:half].contiguous())
    got = ffn_cuda.fused_ffn_t5(*tp_args, residual=False)
    tp_err = check_bf16("G residual=False", got,
                        fused_ffn_plain(*tp_args, residual=False))
    tp_ms = cuda_ms(lambda: ffn_cuda.fused_ffn_t5(*tp_args, residual=False))
    tp_plain_ms = cuda_ms(lambda: fused_ffn_plain(*tp_args, residual=False))
    tp_bound = bound(4 * t_n * d * half, "bf16", tensor_bytes(*tp_args, got))
    del tp_args, got
    log(f"phase 3 kernel G ffn_fused residual=False (one of two tensor-"
        f"parallel ranks) [T={t_n}, D={d}, F={half}]: max_abs_err"
        f" {tp_err:.3g}, {tp_ms:.3f} ms vs plain {tp_plain_ms:.3f} ms, bound"
        f" {tp_bound['bound_ms']:.3f} ms ({tp_bound['bound_by']}) | "
        + card_line())

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
    # I: the encoder's short route, 7000-token batches of 13 rows of 512,
    # 27 rows of 256 (the length mix's median) and 6 rows of 1024 (the
    # route's limit, blockwise_above)
    i_cases = {}
    for b, l, lengths in ((13, 512, [512 - 29 * i for i in range(13)]),
                          (27, 256, [256 - 7 * i for i in range(27)]),
                          (6, 1024, [1024 - 37 * i for i in range(6)])):
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
    kernels["I"]["at_1024"] = i_cases[(6, 1024)]
    for key, shape, kv, blocks in (
            ("H", "B=2, H=32, L=3200, dk=128", kernels["H"],
             flash_cuda.blocks_per_sm(3200)),
            ("I", "B=13, H=32, L=512, dk=128", kernels["I"],
             short_cuda.blocks_per_sm(512)),
            ("I", "B=27, H=32, L=256, dk=128", i_cases[(27, 256)],
             short_cuda.blocks_per_sm(256)),
            ("I", "B=6, H=32, L=1024, dk=128", i_cases[(6, 1024)],
             short_cuda.blocks_per_sm(1024))):
        log(f"phase 3 kernel {key} {kv.get('name', 'short_t5')} [{shape}]:"
            f" max_abs_err {kv['max_abs_err']:.3g}, {kv['ms']:.3f} ms vs plain"
            f" {kv['plain_ms']:.3f} ms, sdpa {kv['library_ms']:.3f} ms, bound"
            f" {kv['bound_ms']:.3f} ms ({kv['bound_by']}), {blocks}"
            " block(s) per SM")


def check_xlnet_kernel(kernels, seed):
    """Phase 3 for kernel L at `protxlnet.long`'s longest batch, 2 x 16
    heads x 3098 x 64 with one row 2002 tokens long (padded keys masked,
    padded query rows finite), R the middle of three layers' columns of one
    [2L, layers x H x 64] product (as the encoder passes it): against its
    plain version (BF16_TOL), and R one row off, which must fail that
    tolerance four times over; timed beside its bound (6·B·H·L²·64 bf16
    operations: the content term, the position term, PV) and beside SDPA
    without the position term, the yardstick the port never calls."""
    import torch
    import torch.nn.functional as F

    from knn_for_homology_tpu_torch.ops import relattn_cuda
    from knn_for_homology_tpu_torch.ops.relative_attention import (
        relative_attention_plain,
    )

    dev = torch.device("cuda")
    gen = torch.Generator(dev).manual_seed(seed + 8)
    b, h, l, dh, lengths = 2, 16, 3098, 64, [3098, 2002]

    def randn(*shape, scale=1.0):
        out = torch.randn(shape, generator=gen, device=dev) * scale
        return out.to(torch.bfloat16)

    q, k, v = (randn(b, h, l, dh) for _ in range(3))
    r = randn(2 * l, 3 * h * dh)[:, h * dh:2 * h * dh].view(2 * l, h, dh)
    r_w, r_r = randn(h, dh, scale=0.5), randn(h, dh, scale=0.5)
    mask = torch.arange(l, device=dev)[None] < torch.tensor(
        lengths, device=dev)[:, None]
    args = (q, k, v, r, r_w, r_r, mask)
    before = relattn_cuda.relative_attention.launches
    got = relattn_cuda.relative_attention(*args)
    assert relattn_cuda.relative_attention.launches == before + 1
    want = relative_attention_plain(*args, block=64)
    err = check_bf16("L", got, want)
    shifted = torch.cat([r[1:], torch.zeros_like(r[:1])])
    fault = relattn_cuda.relative_attention(q, k, v, shifted, r_w, r_r, mask)
    fault_err = float((fault.float() - want.float()).abs().max())
    scale = float(want.float().abs().max())
    assert fault_err > 4 * BF16_TOL * scale, (
        f"L: R one row off reads {fault_err}, within the tolerance")
    ms = cuda_ms(lambda: relattn_cuda.relative_attention(*args))
    plain_ms = cuda_ms(lambda: relative_attention_plain(*args, block=64))
    attn = torch.where(mask, 0.0, -1e9)[:, None, None, :].to(torch.bfloat16)
    lib_ms = cuda_ms(lambda: F.scaled_dot_product_attention(
        q, k, v, attn_mask=attn, scale=dh**-0.5))
    ops = 6 * b * h * l * l * dh
    kernels["L"] = dict(
        name="flash_xlnet", route="cuda",
        source="knn_for_homology_tpu_torch/csrc/flash_xlnet.cu",
        replaces=None, max_abs_err=err, shifted_r_err=fault_err, ms=ms,
        plain_ms=plain_ms, library_ms=lib_ms,
        library="scaled_dot_product_attention (no position term)",
        **bound(ops, "bf16", tensor_bytes(q, k, v, r, r_w, r_r, mask, got)),
    )
    kv = kernels["L"]
    log(f"phase 3 kernel L flash_xlnet [B={b}, H={h}, L={l}, dh={dh}, rows"
        f" {lengths}]: max_abs_err {err:.3g} (R one row off: {fault_err:.3g}),"
        f" {ms:.3f} ms vs plain {plain_ms:.3f} ms, sdpa {lib_ms:.3f} ms,"
        f" bound {kv['bound_ms']:.3f} ms ({kv['bound_by']})")


def check_lstm_kernel(kernels, seed):
    """Phase 3 for kernel M at the batch shapes of `seqvec.mix` with the
    most rows (56 proteins of 185-270 residues) and the fewest (10 of
    881-1614), lengths + 2 for <S> and </S>, SeqVec's widths and bilm-tf's
    Glorot-uniform LSTM weights: against its plain version, a step loop
    of torch ops on the card (every position within 2^-6 relative: both
    round h to bf16 each step, in other summation orders), timed beside
    its bound (both directions' recurrent products, 4·(512·16384 +
    4096·512) bf16 operations a position, or the weights, xw and h once).
    The fp32 step loop the fp32 route runs takes ~0.5 ms a step of both
    directions (scripts/torch_lstm_probe.py). The entry names M's
    thread-block cluster size."""
    import torch

    from knn_for_homology_tpu_torch.ops import lstm_cuda
    from knn_for_homology_tpu_torch.ops.lstm import lstmp_bidir_plain

    dev = torch.device("cuda")
    gen = torch.Generator(dev).manual_seed(seed + 9)
    p, cells = 512, 4096

    def glorot(shape, fan):
        return ((torch.rand(shape, generator=gen, device=dev) * 2 - 1)
                * (6.0 / fan) ** 0.5).to(torch.bfloat16)

    w_h = [glorot((p, 4 * cells), 2 * p + 4 * cells) for _ in range(2)]
    w_p = [glorot((cells, p), cells + p) for _ in range(2)]
    w_x = glorot((p, 4 * cells), 2 * p + 4 * cells)
    weights = lstm_cuda.lstmp_weights(w_h, w_p)
    shapes = {}
    for key, rows, lo, hi in (("rows_56", 56, 185, 270),
                              ("rows_10", 10, 881, 1614)):
        lengths = [round(hi - (hi - lo) * i / (rows - 1)) + 2
                   for i in range(rows)]
        steps = max(lengths)
        x = torch.randn((rows * steps, p), generator=gen, device=dev)
        xw = torch.stack([(x.bfloat16() @ w_x).view(rows, steps, 4 * cells)
                          for _ in range(2)])
        args = (xw, weights, lengths, 3.0, 3.0)
        plain_args = (xw, w_h, w_p, lengths, 3.0, 3.0)
        before = lstm_cuda.lstmp_bidir.launches
        got = lstm_cuda.lstmp_bidir(*args)
        assert lstm_cuda.lstmp_bidir.launches == before + 1
        want = lstmp_bidir_plain(*plain_args)
        err = 0.0
        for r, n in enumerate(lengths):
            gap = (got[r, :n].double() - want[r, :n].double()).norm(dim=-1)
            rel = gap / want[r, :n].double().norm(dim=-1).clamp_min(1e-30)
            err = max(err, float(rel.max()))
            assert not got[r, n:].any(), f"M {key}: written past a row"
        assert err < BF16_TOL, f"M {key}: relative error {err}"
        ms = cuda_ms(lambda: lstm_cuda.lstmp_bidir(*args), reps=3)
        plain_ms = cuda_ms(lambda: lstmp_bidir_plain(*plain_args), reps=1,
                           windows=1)
        positions = sum(lengths)
        recurrent = p * 4 * cells + cells * p
        shapes[key] = kv = dict(
            name="lstm_bidir", route="cuda",
            source="knn_for_homology_tpu_torch/csrc/lstm_bidir.cu",
            replaces=None, max_rel_err=err, ms=ms, us_a_step=1e3 * ms / steps,
            cluster=lstm_cuda.CLUSTER,
            plain_ms=plain_ms, library_ms=None, library=None,
            **bound(2 * positions * 2 * recurrent, "bf16",
                    2 * (2 * recurrent + 2 * positions * (4 * cells + p))),
        )
        log(f"phase 3 kernel M lstm_bidir [{rows} rows, {lo + 2}-{hi + 2}"
            f" steps]: max_rel_err {err:.3g}, {ms:.3f} ms"
            f" ({kv['us_a_step']:.2f} us a step, clusters of"
            f" {lstm_cuda.CLUSTER}) vs plain {plain_ms:.3f} ms,"
            f" bound {kv['bound_ms']:.3f} ms ({kv['bound_by']})")
    # the entry is the widest batch's; the longest batch's rides along
    kernels["M"] = dict(shapes["rows_56"], rows_10=shapes["rows_10"])


def check_ivf_kernels(db, q_all, kernels, seed):
    """Phase 3 for kernels J and K on a slab table of the phase-9 layout
    (IVF_CELLS cells of IVF_FILL members of db, packed as the index packs
    them): J's buffers bit-equal to plain (sym and sym2), K's ids and -inf
    lanes equal and sims within K_RTOL at four sharing levels of the
    probed nodes, on the route K chooses and on each of its two routes
    (K's entry takes shape (a) and lists all four under "sharing"). No one PyTorch call computes either function (J's
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
    times, groups = {}, {}
    for compute in ("sym", "sym2"):
        q8, q_lo, _ = packed_cuda.quantize_queries(q, compute == "sym2")
        args = (q8, pv, sc, pi, cells, tile, r, q_lo)
        got, want = kern(*args), plain(*args)
        assert torch.equal(got, want), (
            f"J {compute}: {int((got != want).sum())} slots differ from plain")
        times[compute] = (cuda_ms(lambda: kern(*args)),
                          cuda_ms(lambda: plain(*args)))
        groups[compute] = ivf_cuda.passes_per_product(
            J_BUDGET, q.shape[1], tile, r, compute == "sym2")
        if compute == "sym":
            rows = J_BUDGET * 128
            j_bound = bound(2 * J_QUERIES * rows * q.shape[1], "int8",
                            tensor_bytes(q8, cells, got)
                            + rows * (q.shape[1] + 8))
        log(f"phase 3 kernel J ivf_indirect {compute} [{J_QUERIES} x"
            f" {J_BUDGET} cells ({J_BUDGET * 128} rows) x {q.shape[1]},"
            f" k={BENCH_K}, W={tile}, R={r}]: buffers bit-equal,"
            f" {times[compute][0]:.3f} ms (P = {groups[compute]} passes a"
            f" product) vs plain {times[compute][1]:.3f} ms")
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
        passes_per_product=groups, **j_bound,
    )

    # K at four sharing levels of the pairs' nodes, each on the route K
    # chooses and on both routes
    wide = torch.full((WIDE_CELLS, 128), -1, dtype=torch.int32, device=dev)
    wide[:, :IVF_FILL] = torch.randint(0, db.shape[0], (WIDE_CELLS, IVF_FILL),
                                       generator=gen, device=dev,
                                       dtype=torch.int32)
    tables = {IVF_CELLS: (pv, pi, sc),
              WIDE_CELLS: slab_cuda.pack_neighbours(db, wide, 128)}
    cases = {
        "a": torch.randint(0, IVF_CELLS, (K_QUERIES, K_PROBES), generator=gen,
                           device=dev, dtype=torch.int32),
        "b": torch.randint(0, IVF_CELLS, (ONLINE_QUERIES, K_PROBES),
                           generator=gen, device=dev, dtype=torch.int32),
        "c": torch.randperm(IVF_CELLS, generator=gen, device=dev).view(
            IVF_CELLS // K_PROBES, K_PROBES).to(torch.int32),
        "d": torch.randint(0, WIDE_CELLS, (ONLINE_QUERIES, K_PROBES),
                           generator=gen, device=dev, dtype=torch.int32),
    }
    k_cases = {}
    for key, sel in cases.items():
        cells = IVF_CELLS if key != "d" else WIDE_CELLS
        k_cases[key] = check_k_case(
            key, (sel, q_all[:sel.shape[0]].contiguous(), *tables[cells], 128))
    kernels["K"] = dict(
        name="slab_expand", route="cuda",
        source="knn_for_homology_tpu_torch/csrc/slab_expand.cu",
        replaces="knn_for_homology_tpu/ops/graph_pallas.py:139",
        library_ms=None, library=None,
        product="tiles: 2xTF32 wgmma; pairs: fp32 FFMA",
        **{k: v for k, v in k_cases["a"].items()
           if k in ("max_abs_err", "ms", "plain_ms", "bound_ms", "bound_by",
                    "bound_2xtf32_ms", "bound_fp32_ms")},
        sharing=k_cases,
    )


def check_graph_kernel_k(train, kernels):
    """Phase 3 for kernel K at the graph beam step's own traffic: the
    pipeline's graph index over phase 4's 131072 x 1024 vectors, one
    query block of them (family order) searched at k = 1001 with K's probe
    lists recorded at GRAPH_STEPS; each step held to plain on both routes
    (check_k_case, entries "g<step>" of K's "sharing"). Then the same block
    under torch.profiler: device time by kernel group, K's share."""
    import torch

    from knn_for_homology_tpu_torch.search.graph import GraphIndex

    t0 = time.perf_counter()
    index = GraphIndex(metric="cosine", degree=GRAPH_DEGREE,
                       beam_width=GRAPH_BEAM, device="cuda").add(train)
    index._packed_state()
    torch.cuda.synchronize()
    build_s = time.perf_counter() - t0
    qb = index.query_block(BENCH_K + 1)
    block = train[:qb]
    with recorded_k_calls(GRAPH_STEPS) as kept:
        t0 = time.perf_counter()
        index.search(block, BENCH_K + 1)
        block_s = time.perf_counter() - t0
    card = torch.cuda.get_device_properties(0).total_memory
    log(f"phase 3 graph index: {train.shape[0]} x {train.shape[1]} built and"
        f" packed in {build_s:.2f} s; one block of {len(block)} queries at"
        f" k={BENCH_K + 1} in {block_s:.3f} s ({kept.calls} K calls) | the"
        f" card's {card} bytes: packed while the slab table is within"
        f" {index.PACKED_SHARE * card / 1e9:.2f} GB (this one"
        f" {index._packed[0].numel() / 1e9:.2f} GB), query blocks of {qb}"
        f" (rescore gather within {index.RESCORE_SHARE * card / 1e9:.2f} GB)")
    for step in GRAPH_STEPS:
        kernels["K"]["sharing"][f"g{step}"] = dict(
            check_k_case(f"g{step}", kept[step]), step=step)
    del kept

    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    with torch.profiler.profile(activities=acts) as prof:
        index.search(block, BENCH_K + 1)
        torch.cuda.synchronize()
    prof_s = time.perf_counter() - t0
    shares, top = device_time_shares(prof, GRAPH_KERNELS)
    device_ms = sum(ms for ms, _ in shares.values())
    kernels["K"]["graph_block"] = dict(
        queries=len(block), wall_ms=prof_s * 1e3, device_ms=device_ms,
        k_share=shares.get("K slab_expand", (0.0, 0.0))[1])
    log(f"phase 3 profile of one graph block ({len(block)} queries,"
        f" k={BENCH_K + 1},"
        f" wall {prof_s * 1e3:.1f} ms under the profiler, device busy"
        f" {device_ms / (prof_s * 1e3):.3f}): "
        + ", ".join(f"{g} {ms:.1f} ms ({share:.3f})"
                    for g, (ms, share) in shares.items())
        + " | largest of the rest: " + ", ".join(f"{nm} {ms:.1f} ms"
                                                 for nm, ms in top))
    del index
    torch.cuda.empty_cache()


@contextlib.contextmanager
def recorded_k_calls(steps):
    """The arguments of kernel K's calls numbered `steps` (from 0), as the
    graph beam search passes them, kept for the length of the block. The
    search's view of ops/slab_cuda.py becomes a copy whose beam_expand
    records, then calls the real one (which counts its launches on
    itself); a call inside a capture is neither kept nor counted."""
    import types

    import torch

    from knn_for_homology_tpu_torch.ops import slab_cuda
    from knn_for_homology_tpu_torch.search import graph as graph_mod

    class Kept(dict):
        calls = 0

    kept = Kept()

    def recorder(*args):
        if torch.cuda.is_current_stream_capturing():
            return slab_cuda.beam_expand(*args)
        if kept.calls in steps:
            kept[kept.calls] = (args[0].clone(),) + args[1:]
        kept.calls += 1
        return slab_cuda.beam_expand(*args)

    view = types.ModuleType(slab_cuda.__name__)
    view.__dict__.update(vars(slab_cuda), beam_expand=recorder)
    graph_mod.slab_cuda = view
    try:
        yield kept
    finally:
        graph_mod.slab_cuda = slab_cuda

def check_k_case(key, args):
    """Kernel K on one probe list (`args` as beam_expand takes them): on the
    route K chooses, its launches counted, and on each of its two routes,
    held to plain (ids and -inf lanes equal, sims within K_RTOL of the
    largest |sim|), timed beside plain and its bounds. Bytes: the queries
    and probe lists, each probed slab (with its ids and scales) once, the
    outputs once; operations: an fp32 dot per real slab row at the card's
    fastest fp32-accurate product (two TF32 or three bf16 products: int8
    values are exact in both), beside the tile route's own two TF32
    products and one fp32 FFMA."""
    import torch

    from knn_for_homology_tpu_torch.ops import slab_cuda

    sel, qk, pv, pi = args[:4]
    deg_p, n_nodes, d = args[5], pi.shape[0], qk.shape[1]
    want_s, want_n = slab_cuda.beam_expand_plain(*args)
    fin = torch.isfinite(want_s)
    scale = float(want_s[fin].abs().max())

    def held(route):
        """K's max abs error against plain; ids, -inf lanes equal."""
        got_s, got_n = slab_cuda.beam_expand(*args)
        assert torch.equal(got_n, want_n), (
            f"K {key} {route}: ids differ from plain")
        assert torch.equal(fin, torch.isfinite(got_s)), (
            f"K {key} {route}: -inf lanes differ")
        err = float((got_s[fin] - want_s[fin]).abs().max())
        assert err <= K_RTOL * scale, (
            f"K {key} {route}: max_abs_err {err} > {K_RTOL} x {scale}")
        return err

    slab_cuda.beam_expand.launches = 0
    slab_cuda.beam_expand.routes = dict.fromkeys(slab_cuda.ROUTES, 0)
    err = held("auto")
    launches = slab_cuda.beam_expand.launches
    route = next(r for r, n in slab_cuda.beam_expand.routes.items() if n)
    per_route = {}
    for r in slab_cuda.ROUTES:
        with k_route(r):
            per_route[r] = dict(max_abs_err=held(r), ms=cuda_ms(
                lambda: slab_cuda.beam_expand(*args)))
    plain_ms = cuda_ms(lambda: slab_cuda.beam_expand_plain(*args))
    touched = int(torch.unique(sel.clamp(0, n_nodes - 1)).numel())
    flops = 2 * sel.numel() * deg_p * d
    nbytes = (tensor_bytes(sel, qk, want_s, want_n)
              + touched * (deg_p * d + slab_cuda.LANE * 8))
    card = min((bound(2 * flops, "tf32", nbytes),
                bound(3 * flops, "bf16", nbytes)),
               key=lambda b: b["bound_ms"])
    case = dict(
        queries=sel.shape[0], probes=sel.shape[1], cells=n_nodes, deg_p=deg_p,
        nodes=touched, pairs_per_node=sel.numel() / touched, route=route,
        launches=launches, max_abs_err=err,
        ms=per_route[route]["ms"], plain_ms=plain_ms, routes=per_route,
        bound_2xtf32_ms=bound(2 * flops, "tf32", nbytes)["bound_ms"],
        bound_fp32_ms=bound(flops, "fp32", nbytes)["bound_ms"], **card)
    log(f"phase 3 kernel K slab_expand ({key}) [{sel.shape[0]} x"
        f" {sel.shape[1]} probes x {deg_p} x {d}, {touched} of {n_nodes}"
        f" nodes, {sel.numel() / touched:.2f} pairs a node]: route {route}"
        f" ({launches} launch), ids equal, max_abs_err {err:.3g},"
        f" {case['ms']:.3f} ms (tiles {per_route['tiles']['ms']:.3f}, pairs"
        f" {per_route['pairs']['ms']:.3f}) vs plain {plain_ms:.3f} ms,"
        f" bound {card['bound_ms']:.3f} ms ({card['bound_by']}; two TF32"
        f" products {case['bound_2xtf32_ms']:.3f}, fp32 FFMA"
        f" {case['bound_fp32_ms']:.3f} ms)")
    return case


@contextlib.contextmanager
def k_route(route):
    """Kernel K held to one of its routes (ops/slab_cuda.py looks its
    route up at each call)."""
    from knn_for_homology_tpu_torch.ops import slab_cuda

    saved = slab_cuda.slab_route
    slab_cuda.slab_route = lambda *shape: route
    try:
        yield
    finally:
        slab_cuda.slab_route = saved


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
    """Phase 9: the full-protein path at full width, counts from zero
    before each run. The phase-4 vectors are the proteins (one domain
    each, its family), the pipeline searches all of them against all at
    k = 1000 with the graph index (its default: kernels B and K), the IVF
    index and the flat index; then the online batch on that IVF index (the
    per-probe path), on one of WIDE_CELLS cells, on the graph index and on
    a kNN-descent graph. The kernel-vs-plain checks and the round trips run
    after the counts are read."""
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
    from knn_for_homology_tpu_torch.search import graph as graph_mod
    from knn_for_homology_tpu_torch.search.flat import FlatIndex
    from knn_for_homology_tpu_torch.search.graph import GraphIndex
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
    # the graph build's three steps: the exact kNN (kernel B), the
    # assembly (self column, long-range edges), the int8 slab pack (done
    # at the first search, so inside the pipeline's search seconds)
    graph_steps = {"kNN (B)": (graph_mod, "flat_topk"),
                   "assembly": (graph_mod, "_assemble_graph"),
                   "pack": (slab_cuda, "pack_neighbours")}

    def reset_counts():
        for mod, name in counters.values():
            getattr(mod, name).launches = 0
        slab_cuda.beam_expand.routes = dict.fromkeys(slab_cuda.ROUTES, 0)
        GraphIndex.graph_replays = 0
        for key in packed_cuda.segment_packed_kernel.launches:
            packed_cuda.segment_packed_kernel.launches[key] = 0
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()

    def read_counts():
        out = {key: getattr(mod, name).launches
               for key, (mod, name) in counters.items()}
        out.update(packed_cuda.segment_packed_kernel.launches)
        out["K by route"] = dict(slab_cuda.beam_expand.routes)
        out["graph replays"] = GraphIndex.graph_replays
        return out

    metrics, walls, peaks, by_mode, step_s = {}, {}, {}, {}, {}
    with tempfile.TemporaryDirectory(prefix="knn_ivf_") as tmp:
        npy = Path(tmp) / "full_sequences.npy"
        np.save(npy, train)
        with ivf_budgets() as budgets:
            for mode in ("graph", "ivf", "flat"):
                reset_counts()
                with contextlib.ExitStack() as stack:
                    if mode == "graph":
                        step_s = {step: stack.enter_context(
                            timed_calls(owner, name, []))
                            for step, (owner, name) in graph_steps.items()}
                    t0 = time.perf_counter()
                    metrics[mode] = pfam_proteins.run(
                        npy, ids, p2d, index_mode=mode, k=BENCH_K,
                        device="cuda")
                    walls[mode] = time.perf_counter() - t0
                peaks[mode] = torch.cuda.max_memory_allocated()
                by_mode[mode] = read_counts()

    # the online batch: below UNION_MIN_Q, the per-probe path
    reset_counts()
    t0 = time.perf_counter()
    index = IVFIndex(metric="cosine", nprobe=32, device="cuda").add(train)
    torch.cuda.synchronize()
    build_s = time.perf_counter() - t0
    online = test[:ONLINE_QUERIES]
    assert ONLINE_QUERIES < index.UNION_MIN_Q
    t0 = time.perf_counter()
    _, o_ids = index.search(online, ONLINE_K)
    online_s = time.perf_counter() - t0
    # the same batch on an index of WIDE_CELLS cells: most probed cells
    # are probed once (kernel K's pair route)
    wide = IVFIndex(metric="cosine", nprobe=32, n_clusters=WIDE_CELLS,
                    device="cuda").add(train)
    t0 = time.perf_counter()
    _, w_ids = wide.search(online, ONLINE_K)
    wide_s = time.perf_counter() - t0
    # the same batch on the pipeline's graph index, and on a kNN-descent
    # graph of the same vectors (its build for indexes above
    # EXACT_BUILD_MAX rows)
    graphs = {}
    for build in ("exact", "nn-descent"):
        t0 = time.perf_counter()
        g = GraphIndex(metric="cosine", degree=GRAPH_DEGREE,
                       beam_width=GRAPH_BEAM, build=build,
                       device="cuda").add(train)
        g._packed_state()
        torch.cuda.synchronize()
        g_build = time.perf_counter() - t0
        g.search(online, ONLINE_K)  # the first block's sizes, warm
        t0 = time.perf_counter()
        _, g_ids = g.search(online, ONLINE_K)
        graphs[build] = (g, g_build, time.perf_counter() - t0, g_ids)
    _, exact_ids = FlatIndex(device="cuda").add(train).search(online, ONLINE_K)
    by_mode["online"] = read_counts()
    online_recall = recall_of(o_ids, exact_ids)
    launches = {key: sum(c[key] for c in by_mode.values())
                for key in counters}
    k_routes = {r: sum(c["K by route"][r] for c in by_mode.values())
                for r in slab_cuda.ROUTES}
    for key in ("J", "K", "B", "A"):
        assert launches[key] > 0, f"kernel {key} was not launched by phase 9"
    for key in ("K", "B"):
        assert by_mode["graph"][key] > 0, (
            f"kernel {key} was not launched by the graph mode")
    for route, n_route in k_routes.items():
        assert n_route > 0, f"kernel K's {route} route was not launched"
    for key in ("A", "B"):
        kernels[key]["launches_by_phase"]["9"] = launches[key]
    kernels["J"]["launches"], kernels["K"]["launches"] = (launches["J"],
                                                          launches["K"])
    kernels["K"]["launches_by_route"] = k_routes
    for key in ("K", "B"):
        kernels[key]["launches_by_mode"] = {
            m: c[key] for m, c in by_mode.items()}
    kernels["K"]["routes_by_mode"] = {m: c["K by route"]
                                      for m, c in by_mode.items()}
    # K's counters count its eager launches (a captured block's warm-up);
    # the graph index's replays of captured blocks are counted apart
    kernels["K"]["graph_replays_by_mode"] = {m: c["graph replays"]
                                             for m, c in by_mode.items()}
    assert by_mode["graph"]["graph replays"] > 0, (
        "the graph mode replayed no captured block")

    for mode, m in metrics.items():
        assert math.isfinite(m["auc1"]) and 0 < m["auc1"] <= 1, (mode, m)
        log(f"phase 9 pfam_proteins {mode}: {n} proteins all-vs-all,"
            f" k={BENCH_K} | build {m['build_seconds']:.3f} s, search"
            f" {m['search_seconds']:.3f} s ({n / m['search_seconds']:.0f}"
            f" queries/s), run {walls[mode]:.1f} s | AUC1 {m['auc1']:.4f},"
            f" recall@300 {m['recall@300']:.4f} | peak"
            f" {peaks[mode] / 2**30:.2f} GiB | launches {by_mode[mode]}")
    log("phase 9 graph build steps (s, the card synchronised after each): "
        + ", ".join(f"{step} {sum(w):.3f}" for step, w in step_s.items())
        + " (the pack runs at the first search)")
    for mode in ("graph", "ivf"):
        assert metrics[mode]["auc1"] >= (
            metrics["flat"]["auc1"] - IVF_AUC1_SLACK), (
            mode, metrics[mode]["auc1"], metrics["flat"]["auc1"])
    g_recall = {b: recall_of(v[3], exact_ids) for b, v in graphs.items()}
    own = np.arange(ONLINE_QUERIES)[:, None]  # test query i is family i
    g_family = {b: float(np.mean(v[3] // FAMILY_TRAIN == own))
                for b, v in graphs.items()}
    log("phase 9 IVF union scan: " + "; ".join(budgets))
    log(f"phase 9 online batch: IVF build {build_s:.3f} s, {ONLINE_QUERIES}"
        f" queries at k={ONLINE_K} in {online_s * 1e3:.1f} ms (per-probe"
        f" path), recall {online_recall:.4f} against the flat exact"
        f" top-{ONLINE_K}; on {WIDE_CELLS} cells in {wide_s * 1e3:.1f} ms,"
        f" recall {recall_of(w_ids, exact_ids):.4f}; "
        + "; ".join(f"graph ({b}) build + pack {v[1]:.3f} s, the batch in"
                    f" {v[2] * 1e3:.1f} ms, recall {g_recall[b]:.4f}, own"
                    f" family {g_family[b]:.4f}"
                    for b, v in graphs.items())
        + f" | launches {by_mode['online']}")
    assert online_recall >= ONLINE_RECALL, f"online recall {online_recall}"
    assert g_family["exact"] >= GRAPH_ONLINE_FAMILY, g_family
    gindex = graphs.pop("exact")[0]
    del graphs

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
    with plain_ivf_kernels():
        _, want_w = wide.search(online, ONLINE_K)
    assert np.array_equal(w_ids, want_w), (
        f"phase 9: per-probe routes differ on {WIDE_CELLS} cells")
    del wide

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

    # the graph index: a block of ONLINE_QUERIES at k = 1000 through kernel
    # K and through its plain version (GRAPH_BLOCK_IDS, SCORE_ATOL)
    block = train[:ONLINE_QUERIES]
    got = gindex.search(block, BENCH_K)
    with plain_ivf_kernels():
        want = gindex.search(block, BENCH_K)
    found, worst = [], 0.0
    for gs, gi, ws, wi in zip(*got, *want):
        common, at_g, at_w = np.intersect1d(gi, wi, return_indices=True)
        found.append(common.size / wi.size)
        worst = max(worst, float(np.abs(gs[at_g] - ws[at_w]).max()))
    same_place = float(np.mean(got[1] == want[1]))
    assert np.mean(found) >= GRAPH_BLOCK_IDS, (
        f"phase 9: the graph's kernel route finds {np.mean(found):.5f} of the"
        " plain route's ids")
    assert worst <= SCORE_ATOL, f"phase 9: graph scores differ by {worst}"
    kernels["K"]["graph_vs_plain"] = dict(
        queries=ONLINE_QUERIES, k=BENCH_K, ids_found=float(np.mean(found)),
        same_place=same_place, max_score_diff=worst)
    small = GraphIndex(metric="cosine", degree=GRAPH_DEGREE,
                       beam_width=GRAPH_BEAM, device="cuda").add(
        train[:ROUNDTRIP_ROWS])
    before = small.search(online, ONLINE_K)
    with tempfile.TemporaryDirectory(prefix="knn_graph_io_") as tmp:
        t0 = time.perf_counter()
        write_index(small, Path(tmp) / "graph.index")
        loaded = read_index(Path(tmp) / "graph.index", device="cuda")
        io_s = time.perf_counter() - t0
    after = loaded.search(online, ONLINE_K)
    assert isinstance(loaded, GraphIndex)
    assert np.array_equal(before[1], after[1]) and np.array_equal(
        before[0], after[0]), "phase 9: the graph round trip changed results"
    log(f"phase 9 graph kernels vs plain: a {ONLINE_QUERIES}-query block at"
        f" k={BENCH_K}: the kernel route finds {np.mean(found):.5f} of the"
        f" plain route's ids ({same_place:.5f} at the same place), scores"
        f" of common ids within {worst:.3g} | round trip of a"
        f" {ROUNDTRIP_ROWS}-row graph index in {io_s:.2f} s: same ids")


@contextlib.contextmanager
def timed_calls(owner, name, walls):
    """Append the wall seconds of every call of owner.name (the card
    synchronised at its end) to `walls`, for the length of the block."""
    import torch

    fn = getattr(owner, name)

    def wrapper(*args, **kwargs):
        t0 = time.perf_counter()
        out = fn(*args, **kwargs)
        torch.cuda.synchronize()
        walls.append(time.perf_counter() - t0)
        return out

    setattr(owner, name, wrapper)
    try:
        yield walls
    finally:
        setattr(owner, name, fn)


def cath_like(seed):
    """Phase 10 (e): CATH20's size, seeded. CATH_DOMAINS vectors of d = DIM
    round CATH_SUPERFAMILIES superfamily centroids (scale CATH_SIGNAL, unit
    noise), and their C / A / T / H labels: H the superfamily, T, A and C
    coarser groups of it. Returns (embeddings, ids, levels, level array)."""
    rng = np.random.RandomState(seed)
    fams = rng.randint(0, CATH_SUPERFAMILIES, CATH_DOMAINS)
    centroids = rng.randn(CATH_SUPERFAMILIES, DIM).astype(np.float32)
    emb = (centroids[fams] * CATH_SIGNAL
           + rng.randn(CATH_DOMAINS, DIM).astype(np.float32))
    ids = np.asarray([f"d{i:05d}" for i in range(CATH_DOMAINS)])
    codes = [f"{1 + h % 4}.{h % 40}.{h % 400}.{h}" for h in fams]
    levels = {i: tuple(c.rsplit(".", k)[0] for k in range(4))
              for i, c in zip(ids, codes)}
    return emb, ids, levels, np.asarray([levels[i] for i in ids])


def run_paper_pipelines(ds, train, test, kernels, seed):
    """Phase 10: the paper pipelines on the card, counts from zero. (a) the
    index CLI builds the reference's 1024-bit LSH index over phase 4's
    train.npy, read back on the card, its sketches held to an fp64 host
    sketch; (b) the Pfam20 domain workload on that index file (k = 1000,
    then kernel C rescores the top 13); (c) the LSH card route against its
    plain route on the card, and its pieces timed; (d) the full-protein
    pipeline's lsh mode (2048 bits) all-vs-all; (e) CATH20's search
    (kernel A) and top-1 evaluation on a seeded set of its size."""
    import torch

    from knn_for_homology_tpu_torch.ops import align_cuda, flat_cuda, lsh
    from knn_for_homology_tpu_torch.ops.distance import l2_normalize
    from knn_for_homology_tpu_torch.ops.topk import stable_topk
    from knn_for_homology_tpu_torch.pipelines import (
        cath,
        pfam_domains,
        pfam_proteins,
    )
    from knn_for_homology_tpu_torch.search import cli
    from knn_for_homology_tpu_torch.search.flat import FlatIndex
    from knn_for_homology_tpu_torch.search.io import read_index
    from knn_for_homology_tpu_torch.search.lsh import LSHIndex

    counters = {"A": flat_cuda.flat_topk_kernel,
                "C": align_cuda.sw_scores_grouped}
    for fn in counters.values():
        fn.launches = 0
    torch.cuda.synchronize()

    # (a) the index CLI, then the file read back on the card
    index_file = ds.parent / "pfam20_lsh.index"
    t0 = time.perf_counter()
    cli.create_index_main(["--dir", str(ds), "--index", str(index_file),
                           "--kind", "lsh", "--param", str(LSH_BITS)])
    build_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    index = read_index(index_file, device="cuda")
    torch.cuda.synchronize()
    read_s = time.perf_counter() - t0
    assert isinstance(index, LSHIndex) and index.ntotal == N_TRAIN
    assert index.nbits == LSH_BITS and index._signs.is_cuda
    rows = train[:FLIP_ROWS].astype(np.float64)
    proj = index.projection.astype(np.float64)
    exact = rows @ proj
    slack = DIM * 2.0**-24 * (np.abs(rows) @ np.abs(proj))
    flips = index._signs[:FLIP_ROWS].cpu().numpy() != np.where(exact >= 0,
                                                                1, -1)
    flip_max = float(np.abs(exact[flips]).max()) if flips.any() else 0.0
    assert (np.abs(exact[flips]) <= slack[flips]).all(), (
        "phase 10: a sign flipped beyond the fp32 rounding bound")
    log(f"phase 10 (a) create-index --kind lsh --param {LSH_BITS}:"
        f" {N_TRAIN} x {DIM} in {build_s:.3f} s (load, sketch, pack,"
        f" write), {index_file.stat().st_size} bytes, read back on the card"
        f" in {read_s:.3f} s | sketch vs fp64 host sketch of {FLIP_ROWS}"
        f" rows: {int(flips.sum())} of {flips.size} signs flip, largest"
        f" |x.p| among them {flip_max:.3g} (fp32 bound: median"
        f" {float(np.median(slack)):.3g}); signs within 1e-4 of 0:"
        f" {int((np.abs(exact) <= 1e-4).sum())}")

    # (b) the Pfam20 domain workload on (a)'s file
    search_walls, align_walls = [], []
    t0 = time.perf_counter()
    with timed_calls(LSHIndex, "search", search_walls), timed_calls(
        pfam_domains, "align_rescore", align_walls
    ):
        summary = pfam_domains.run(ds, hits=BENCH_K, index_path=index_file,
                                   lsh_bits=LSH_BITS, rescore_hits=HITS,
                                   figures_dir=None, device="cuda")
    run_s = time.perf_counter() - t0
    c_after_b = counters["C"].launches
    assert len(search_walls) == len(align_walls) == 1
    assert c_after_b > 0, "phase 10: kernel C was not launched"
    # a family's 32 members sit ~46 bits from its query, the rest ~512
    assert summary["knn_auc1"] >= LSH_AUC1_MIN, summary
    assert math.isfinite(summary["knn_align_auc1"]) and (
        summary["knn_align_auc1"] > 0.05), summary
    lsh_s = search_walls[0]
    log(f"phase 10 (b) pfam_domains.run: {N_TEST} queries at k={BENCH_K} on"
        f" the {LSH_BITS}-bit index, top {HITS} rescored | knn_auc1"
        f" {summary['knn_auc1']:.4f}, knn_tp300 {summary['knn_tp300']:.4f},"
        f" knn_align_auc1 {summary['knn_align_auc1']:.4f} | LSH search"
        f" {lsh_s:.3f} s ({N_TEST / lsh_s:.0f} queries/s), align"
        f" {align_walls[0]:.3f} s, run {run_s:.1f} s | C launches"
        f" {c_after_b} (no mmseqs binary: the MMseqs2 baselines are"
        f" skipped, {len(summary)} summary keys)")

    # (c) the card route against the plain route on the card, then its
    # pieces at (b)'s shape: the int8 product alone, and three selections
    # of the same order over its [Q, N] block (int32 or int64 keys + topk;
    # a stable sort)
    db_s = index._signs
    q_s = index.signs_of(test)
    key_dtype = lsh.key_dtype(N_TRAIN, LSH_BITS)
    want = lsh.hamming_topk_plain(db_s, q_s[:FLIP_ROWS], BENCH_K)
    for dtype in (key_dtype, torch.int64):
        got = lsh.hamming_topk_int(db_s, q_s[:FLIP_ROWS], BENCH_K, dtype)
        assert torch.equal(got[1], want[1]) and torch.equal(
            got[0], want[0]), (f"phase 10: the LSH card route ({dtype} keys)"
                               " and its plain route differ")
    route_ms = cuda_ms(lambda: lsh.hamming_topk(db_s, q_s, BENCH_K),
                       reps=2, windows=3)
    mm_ms = cuda_ms(lambda: torch._int_mm(q_s, db_s.t()), reps=5, windows=3)
    ip = torch._int_mm(q_s, db_s.t())
    id_bits = (N_TRAIN - 1).bit_length()

    def key_select(dtype):
        key = ip.to(dtype, copy=True)  # ip is reused: int32 keys add a copy
        key += LSH_BITS
        key <<= id_bits
        key |= (1 << id_bits) - 1 - torch.arange(N_TRAIN, device=ip.device,
                                                 dtype=dtype)
        return torch.topk(key, BENCH_K, dim=1)

    key_ms = {dt: cuda_ms(lambda: key_select(dt), reps=2, windows=3)
              for dt in (torch.int32, torch.int64)}
    sort_ms = cuda_ms(lambda: stable_topk(ip.to(torch.float32), BENCH_K),
                      reps=1, windows=3)
    del ip
    plain_ms = cuda_ms(lambda: lsh.hamming_topk_plain(db_s, q_s, BENCH_K),
                       reps=1, windows=3)
    lsh_bound = bound(2 * N_TEST * N_TRAIN * LSH_BITS, "int8",
                      tensor_bytes(db_s, q_s) + N_TEST * BENCH_K * 8)
    log(f"phase 10 (c) LSH card route vs plain route on the card,"
        f" {FLIP_ROWS} queries at k={BENCH_K}: ids and distances bit-equal"
        f" ({str(key_dtype)[6:]} and int64 keys) | [{N_TEST} x {N_TRAIN} x"
        f" {LSH_BITS} bits]: route ({str(key_dtype)[6:]} keys)"
        f" {route_ms:.3f} ms, bound {lsh_bound['bound_ms']:.3f} ms"
        f" ({lsh_bound['bound_by']}), torch._int_mm alone {mm_ms:.3f} ms;"
        f" selections of its block: int32 keys (from a copy) + topk"
        f" {key_ms[torch.int32]:.3f} ms, int64 keys + topk"
        f" {key_ms[torch.int64]:.3f} ms, stable sort {sort_ms:.3f} ms; plain"
        f" route {plain_ms:.3f} ms")
    del index, db_s, q_s, got, want
    torch.cuda.empty_cache()

    # (d) the full-protein pipeline's lsh mode over the same vectors
    n = train.shape[0]
    ids = [f"fam{i // FAMILY_TRAIN}_train{i % FAMILY_TRAIN}" for i in range(n)]
    p2d = {p: [(f"F{i // FAMILY_TRAIN}", (0, 100))] for i, p in enumerate(ids)}
    npy = ds.parent / "full_sequences.npy"
    np.save(npy, train)
    t0 = time.perf_counter()
    m = pfam_proteins.run(npy, ids, p2d, index_mode="lsh", k=BENCH_K,
                          device="cuda")
    wall = time.perf_counter() - t0
    assert m["auc1"] >= LSH_AUC1_MIN, m
    log(f"phase 10 (d) pfam_proteins lsh (2048 bits): {n} proteins"
        f" all-vs-all, k={BENCH_K} | build {m['build_seconds']:.3f} s,"
        f" search {m['search_seconds']:.3f} s"
        f" ({n / m['search_seconds']:.0f} queries/s), run {wall:.1f} s |"
        f" AUC1 {m['auc1']:.4f}, recall@300 {m['recall@300']:.4f}")
    npy.unlink()

    # (e) CATH20: cosine and l2 all-vs-all at k = 10 (kernel A), then top-1
    emb, cath_ids, levels, array = cath_like(seed + 4)
    cath_dir = ds.parent / "cath"
    cath_dir.mkdir()
    np.save(cath_dir / "ProtT5.npy", emb)
    a_before = counters["A"].launches
    cath.search_and_save(cath_dir, device="cuda")
    a_cath = counters["A"].launches - a_before
    assert a_cath == 2, f"phase 10: kernel A ran {a_cath} times, not 2"
    evaluation = cath.CathEvaluation(cath_ids, levels, array)
    out = []
    for name, metric in (("cosine", "cosine"), ("euclidean", "l2")):
        hits = np.load(cath_dir / f"hits_{name}.npz")["ProtT5"]
        scores = np.load(cath_dir / f"scores_{name}.npz")["ProtT5"]
        assert hits.shape == (CATH_DOMAINS, cath.CATH_HITS)
        assert not (hits == np.arange(CATH_DOMAINS)[:, None]).any()
        secs = float((cath_dir / f"ProtT5.{name}-search-time.txt").read_text())
        raw, norm = evaluation.top1(evaluation.compute_is_correct(hits))
        assert raw >= CATH_TOP1_MIN, (name, raw)
        out.append(f"{name} {secs:.3f} s, QrawTop1 {raw:.4f}, QnormTop1"
                   f" {norm:.4f}")
        if metric == "cosine":  # kernel A against the plain route
            p_ids, p_scores = FlatIndex(metric="cosine", backend="plain",
                                        device="cuda").add(emb).search_self(
                                            cath.CATH_HITS)
            dbn = l2_normalize(torch.from_numpy(emb).cuda())
            as_t = lambda a: torch.from_numpy(np.ascontiguousarray(a)).cuda()  # noqa: E731
            cath_err, cath_swaps = check_topk(
                "phase 10 CATH cosine", (as_t(scores), as_t(hits)),
                (as_t(p_scores), as_t(p_ids)), dbn, dbn)
    launches = {key: fn.launches for key, fn in counters.items()}
    assert launches["A"] > 0 and launches["C"] > 0
    kernels["A"]["launches_by_phase"]["10"] = launches["A"]
    kernels["C"].setdefault("launches_by_phase", {"4": kernels["C"]["launches"]})
    kernels["C"]["launches_by_phase"]["10"] = launches["C"]
    log(f"phase 10 (e) CATH20 search_and_save ({CATH_DOMAINS} x {DIM},"
        f" {CATH_SUPERFAMILIES} seeded superfamilies, k={cath.CATH_HITS}):"
        f" " + "; ".join(out) + f" | cosine ids vs the plain route:"
        f" {cath_swaps} near-tie swaps, max_abs_err {cath_err:.3g} |"
        f" phase 10 launches {launches}")


@contextlib.contextmanager
def plain_kernels(keys="GHI"):
    """The wrappers of the encoder's kernels named in `keys` swapped for
    their plain versions, so that the same path runs on the card through
    them (models/t5.py looks the wrappers up at each call)."""
    from knn_for_homology_tpu_torch.ops import ffn_cuda, flash_cuda, short_cuda
    from knn_for_homology_tpu_torch.ops.ffn import fused_ffn_plain
    from knn_for_homology_tpu_torch.ops.flash_attention import (
        flash_attention_plain,
    )
    from knn_for_homology_tpu_torch.ops.short_attention import (
        short_attention_plain,
    )

    swaps = [(mod, name, plain) for key, mod, name, plain in (
        ("G", ffn_cuda, "fused_ffn_t5", fused_ffn_plain),
        ("H", flash_cuda, "flash_attention_t5", flash_attention_plain),
        ("I", short_cuda, "short_attention_t5", short_attention_plain))
        if key in keys]
    saved = [getattr(mod, name) for mod, name, _ in swaps]
    try:
        for mod, name, plain in swaps:
            setattr(mod, name, plain)
        yield
    finally:
        for (mod, name, _), fn in zip(swaps, saved):
            setattr(mod, name, fn)


# phase 4 profile groups: kernel C (its lane scan and DP kernels), the
# host-to-device copies (mostly C's lane codes), kernel A
MAIN_KERNELS = (("C sw_grouped", ("sw_wavefront", "sw_lanes")),
                ("H2D copies", ("memcpy htod",)),
                ("A flat_topk", ("flat_topk",)))
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
    from zero; then kernel I's plain version on the card against the path's
    kernel I, a profile of one warm batch, and kernels against plain
    versions on 32 of the proteins."""
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
    # every FFN on G; attention on I for batches padded to ≤ blockwise_above,
    # on H above
    dense = sum(b.padded_len <= config.blockwise_above for b in batches)
    want = {"G": len(batches), "H": len(batches) - dense, "I": dense}
    for key, n in want.items():
        assert launches[key] == config.num_layers * n, (
            f"kernel {key}: {launches[key]} launches, want"
            f" {config.num_layers} x {n} of {len(batches)} batches")
    assert launches["A"] > 0, "kernel A was not launched by phase 8"
    kernels["G"]["launches"], kernels["H"]["launches"] = (
        launches["G"], launches["H"])
    kernels["I"]["launches"] = launches["I"]
    kernels["A"]["launches_by_phase"]["8"] = launches["A"]
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

    # kernel I's plain version on the card (swapped in for I's wrapper)
    # against the path's kernel I on 64 proteins shorter than 1024
    short_seqs = [s for s in train_seqs if len(s) < 1024][:64]
    wrappers["I"].launches = 0
    with plain_kernels("I"):
        pooled_plain = embedder.embed_pooled(short_seqs)
    assert wrappers["I"].launches == 0, "I's plain version launched kernel I"
    rows = [seqs.index(s) for s in short_seqs]
    cos, rel = check_pooled("I's plain version", pooled[rows], pooled_plain)
    log(f"phase 8 I's plain version: {len(short_seqs)} proteins, pooled"
        f" vectors of the path (kernel I, {kernels['I']['launches']}"
        f" launches) vs I's plain version on the card: cosine min {cos:.6f},"
        f" relative L2 error max {rel.max():.4g}")

    # warm batches under the profiler, device time by kernel: the median
    # batch (kernel I) and the longest (flash)
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


def run_xlnet(kernels, seed):
    """Phase 8 for ProtXLNet-UniRef100 at its published widths in bf16
    (the `protxlnet.long` cell's route; weights from models/xlnet.py's
    init_params): `embed_pooled` of phase 8's proteins (the length mix and
    the four long ones, 7000-token batches) through the registry, kernel L
    launched once a layer a batch; then 8 of them, the longest among them,
    against the fp32 route (use_kernel=False) on the card."""
    import torch

    from knn_for_homology_tpu_torch.models import xlnet
    from knn_for_homology_tpu_torch.models.registry import get_embedder
    from knn_for_homology_tpu_torch.ops import relattn_cuda

    dev = torch.device("cuda")
    with tempfile.TemporaryDirectory(prefix="knn_xlnet_") as tmp:
        _, _, train_seqs, test_seqs = write_dataset(
            Path(tmp), seed + 2, n_fam=ENC_FAMILIES, per_train=ENC_TRAIN, dim=8
        )
    rng = np.random.RandomState(seed + 3)
    seqs = train_seqs + test_seqs + [AAS[rng.randint(0, 20, n)].tobytes()
                                     .decode() for n in LONG_LENGTHS]
    config = dataclasses.replace(xlnet.PROTXLNET, dtype=torch.bfloat16)
    params = xlnet.init_params(config, seed=seed, device=dev)
    embedder = get_embedder("ProtXLNet UniRef100", config=config,
                            params=params, token_budget=TOKEN_BUDGET,
                            device=dev)
    batches = embedder.batches(seqs)
    residues = sum(min(len(s), embedder.max_len) for s in seqs)
    embedder.embed_pooled(seqs[:1])  # cuBLAS warm
    relattn_cuda.relative_attention.launches = 0
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    pooled = embedder.embed_pooled(seqs)
    embed_s = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated()
    launches = relattn_cuda.relative_attention.launches
    assert launches == config.num_layers * len(batches), (
        f"kernel L: {launches} launches for {len(batches)} batches")
    assert pooled.shape == (len(seqs), config.d_model)
    assert np.isfinite(pooled).all()
    kernels["L"]["launches"] = launches
    kernels["L"]["launches_by_phase"] = {"8": launches}
    subset = test_seqs[:7] + [max(seqs, key=len)]
    plain = get_embedder(
        "ProtXLNet UniRef100", params=params, token_budget=TOKEN_BUDGET,
        config=dataclasses.replace(xlnet.PROTXLNET, use_kernel=False),
        device=dev)
    cos, rel = check_pooled("ProtXLNet bf16 vs fp32",
                            embedder.embed_pooled(subset),
                            plain.embed_pooled(subset))
    log(f"phase 8 ProtXLNet bf16: {len(seqs)} proteins, {residues} residues,"
        f" {len(batches)} batches | embed {embed_s:.3f} s"
        f" ({residues / embed_s:.0f} residues/s) | peak {peak / 2**30:.2f} GiB"
        f" | kernel L launches {launches} = {config.num_layers} x"
        f" {len(batches)} | pooled vs the fp32 route on {len(subset)}"
        f" proteins: cosine min {cos:.6f}, relative L2 error max"
        f" {rel.max():.4g} (longest, {len(subset[-1])} aa: {rel[-1]:.4g})")


def other_padded_tokens(key, embedder, seqs):
    """(batches, padded tokens) the encoder of `key` takes for `seqs`: its
    own batching and each family's input width."""
    if key == "CPCProt":
        chunks = embedder.chunks(seqs)
        return len(chunks), sum(ids.size for _, ids, _ in chunks)
    batches = embedder.batches(seqs)
    width = {
        "SeqVec": lambda b: b.padded_len,
        "UniRep": lambda b: b.padded_len + 1,
        "ProtXLNet UniRef100": lambda b: b.padded_len + 2,
        "PLUS": lambda b: b.padded_len,
    }.get(key, lambda b: min(b.padded_len + 2, embedder.usable))
    return len(batches), sum(len(b.sequences) * width(b) for b in batches)


def profile_groups(prof):
    """{group: (ms, launches)} of one profiled window's device kernels, by
    OTHER_GROUPS (first match), the rest under "other"."""
    from torch.autograd import DeviceType

    out = {}
    for ev in prof.key_averages():
        if ev.device_type != DeviceType.CUDA or ev.self_device_time_total <= 0:
            continue
        name = ev.key.lower()
        if "memcpy" in name or "memset" in name:
            group = "copies"
        else:
            group = next((label for label, words in OTHER_GROUPS
                          if any(w in name for w in words)), "other")
        ms, n = out.get(group, (0.0, 0))
        out[group] = (ms + ev.self_device_time_total / 1e3, n + ev.count)
    assert out, "the profiler saw no device time"
    return out


def profile_other_batch(key, embedder, seqs):
    """One warm batch of `key` (its middle batch) under torch.profiler:
    device time by group, kernel launches (and per recurrent step: the
    time loops' steps, summed over layers and directions) and the busy
    share."""
    import torch

    if key == "CPCProt":
        chunks = embedder.chunks(seqs)
        _, ids, _ = chunks[len(chunks) // 2]
        ids = torch.from_numpy(ids).cuda()
        rows, width = ids.shape[0], ids.shape[1]

        def run():
            return embedder.encoder(ids)

        steps = width  # the GRU over patches
    else:
        batches = embedder.batches(seqs)
        batch = batches[len(batches) // 2]
        rows, width = len(batch.sequences), batch.padded_len

        def run():
            return embedder.run_batch(batch)

        # the published configs' time loops: SeqVec 2 layers x 2
        # directions over <S> … </S>; UniRep one mLSTM over <start> +
        # residues; PLUS 3 layers x 2 directions
        steps = {"SeqVec": 4 * (width + 2), "UniRep": width + 1,
                 "PLUS": 6 * width}.get(key)
    run()
    torch.cuda.synchronize()
    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        t0 = time.perf_counter()
        run()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    groups = profile_groups(prof)
    device_ms = sum(ms for ms, _ in groups.values())
    launches = sum(n for _, n in groups.values())
    per_step = f", {launches / steps:.1f} a recurrent step" if steps else ""
    log(f"phase 11 profile {key}, one warm batch of {rows} x {width}"
        f"{' patches' if key == 'CPCProt' else ''} (wall {wall_ms:.1f} ms"
        f" under the profiler, device {device_ms:.1f} ms, busy"
        f" {device_ms / wall_ms:.3f}, {launches} kernel launches{per_step}): "
        + ", ".join(f"{g} {ms:.1f} ms ({ms / device_ms:.3f}, {n} launches)"
                    for g, (ms, n) in sorted(groups.items())))


def check_card_vs_cpu(key, embedder, config, rng):
    """Pooled vectors on the card and through the same encoder on the CPU
    (the card's weights moved across), held on two proteins of
    OTHER_AGREE_LEN / OTHER_HELD_LEN aa (the second carries X and U), plus
    one protein a length of OTHER_DRIFT_LENGTHS for the keys of
    OTHER_AGREE_LEN → (held min cosine, held max rel. L2, {length: rel})."""
    from knn_for_homology_tpu_torch.models.convert import params_to_torch
    from knn_for_homology_tpu_torch.models.registry import get_embedder

    def protein(n):
        return AAS[rng.randint(0, 20, n)].tobytes().decode()

    n = OTHER_AGREE_LEN.get(key, OTHER_HELD_LEN)
    drift_lengths = OTHER_DRIFT_LENGTHS if key in OTHER_AGREE_LEN else ()
    seqs = [protein(n), "XU" + protein(n * 5 // 8 - 2)]
    seqs += [protein(m) for m in drift_lengths]
    got = embedder.embed_pooled(seqs)
    cpu = get_embedder(key, config=config, device="cpu",
                       params=params_to_torch(embedder.encoder.params(), "cpu"))
    want = cpu.embed_pooled(seqs).astype(np.float64)
    got = got.astype(np.float64)
    del cpu
    cos = np.sum(got * want, 1) / (np.linalg.norm(got, axis=1)
                                   * np.linalg.norm(want, axis=1))
    rel = np.linalg.norm(got - want, axis=1) / np.linalg.norm(want, axis=1)
    held_cos, held_rel = float(cos[:2].min()), float(rel[:2].max())
    assert held_cos >= OTHER_MIN_COSINE and held_rel <= OTHER_MAX_REL_ERR, (
        key, held_cos, held_rel, n)
    return held_cos, held_rel, dict(zip(drift_lengths, rel[2:].tolist()))


def run_embed_cli(seqvec, tmp, seqs):
    """The normal entry points: the seeded SeqVec tree saved as a converted
    .npz (config in its meta), then `embed-domains` with its default
    embedder and `embed-one --embedder SeqVec`, each a `python -m`
    subprocess on the card; their outputs held to the registry's."""
    from knn_for_homology_tpu_torch.models.convert import save_params
    from knn_for_homology_tpu_torch.models.pooling import pool_domain_range

    tmp = Path(tmp)
    meta = {"config": {k: v for k, v in dataclasses.asdict(
        seqvec.config).items() if k != "dtype"}}
    ckpt = tmp / "SeqVec.npz"
    save_params(seqvec.encoder.params(), ckpt, meta=meta)
    full = seqs[:6]
    names = [f"P{i}" for i in range(len(full))]
    (tmp / "full.fasta").write_text(
        "".join(f">{n}\n{s}\n" for n, s in zip(names, full)))
    # in the CLI's output order: by protein, then by range
    train = [(0, 1, 40), (0, 41, len(full[0]))]
    train += [(i, 1, 40) for i in range(1, 4)]
    test = [(i, 5, len(s) - 3) for i, s in enumerate(full[4:], start=4)]
    for split, ranges in (("train", train), ("test", test)):
        (tmp / f"{split}.fasta").write_text("".join(
            f">P{i}/{a}-{b}\nX\n" for i, a, b in ranges))
    embed = [sys.executable, "-m", "knn_for_homology_tpu_torch.pipelines.embed"]
    t0 = time.perf_counter()
    subprocess.run(embed + ["embed-domains", str(tmp / "full.fasta"),
                            str(tmp / "train.fasta"), str(tmp / "test.fasta"),
                            str(tmp / "domains"), "--checkpoint", str(ckpt)],
                   check=True, cwd=ROOT, timeout=600)
    domains_s = time.perf_counter() - t0
    per_residue = [np.concatenate(list(e), axis=-1)
                   for e in seqvec.embed_per_residue(full)]
    worst = 0.0
    for split, ranges in (("train", train), ("test", test)):
        got = np.load(tmp / "domains" / f"{split}.npy")
        want = np.stack([pool_domain_range(per_residue[i], a, b)
                         for i, a, b in ranges])[:, 1024:2048]
        assert got.shape == (len(ranges), 1024), got.shape
        err = float(np.abs(got - want).max() / np.abs(want).max())
        assert err <= 1e-5, f"phase 11: embed-domains {split} differs: {err}"
        worst = max(worst, err)
    t0 = time.perf_counter()
    subprocess.run(embed + ["embed-one", str(tmp / "full.fasta"),
                            str(tmp / "one"), "--embedder", "SeqVec",
                            "--checkpoint", str(ckpt)],
                   check=True, cwd=ROOT, timeout=600)
    one_s = time.perf_counter() - t0
    variants = seqvec.embed_layer_variants(full)
    for name, want in variants.items():
        got = np.load(tmp / "one" / f"{name}.npy")
        assert got.shape == (len(full), 1024) and np.isfinite(got).all()
        err = float(np.abs(got - want).max() / np.abs(want).max())
        assert err <= 1e-5, f"phase 11: embed-one {name} differs: {err}"
    log(f"phase 11 embed CLI (SeqVec .npz of {ckpt.stat().st_size / 2**20:.0f}"
        f" MiB): embed-domains (default embedder) {domains_s:.1f} s, LSTM1"
        f" slices [{len(train)} + {len(test)}, 1024] equal to the registry's"
        f" (max relative error {worst:.3g}); embed-one --embedder SeqVec"
        f" {one_s:.1f} s, its 4 layer files equal to the registry's")


def run_other_encoders(seed):
    """Phase 11: every other registry key at its published shape on the
    card (seeded weights), embedding OTHER_PROTEINS + 1 proteins; card vs
    CPU (check_card_vs_cpu); a profile of one warm batch of each key; then
    the embed CLI's SeqVec entry points."""
    import torch

    from knn_for_homology_tpu_torch import models
    from knn_for_homology_tpu_torch.models.registry import get_embedder

    rng = np.random.RandomState(seed + 11)
    lengths = list(protein_lengths(rng, OTHER_PROTEINS)) + [OTHER_LONG]
    seqs = [AAS[rng.randint(0, 20, n)].tobytes().decode() for n in lengths]
    t_phase = time.perf_counter()
    shared = {}  # config name → card weights (ESM and ESM1b share them)
    seqvec = None
    for key, (mod_name, cfg_name) in OTHER_KEYS.items():
        module = getattr(models, mod_name)
        config = getattr(module, cfg_name)
        t0 = time.perf_counter()
        if cfg_name not in shared:
            shared.clear()
            torch.cuda.empty_cache()
            shared[cfg_name] = module.init_params(config, seed=seed,
                                                  device="cuda")
        embedder = get_embedder(key, params=shared[cfg_name], config=config,
                                device="cuda")
        torch.cuda.synchronize()
        init_s = time.perf_counter() - t0
        n_params = sum(p.numel() for p in embedder.encoder.parameters())
        n_batches, padded = other_padded_tokens(key, embedder, seqs)
        max_len = getattr(embedder, "max_len", None) or 10**9
        residues = sum(min(len(s), max_len) for s in seqs)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        pooled = embedder.embed_pooled(seqs)
        wall = time.perf_counter() - t0
        peak = torch.cuda.max_memory_allocated()
        assert pooled.shape == (len(seqs), embedder.dim), (key, pooled.shape)
        assert np.isfinite(pooled).all(), key
        extra = ""
        if mod_name == "bert" and cfg_name == "ESM1B":
            long_out = next(iter(embedder.embed_per_residue(seqs[-1:])))
            assert long_out.shape == (1022, embedder.dim), long_out.shape
            extra = f" | the {OTHER_LONG}-aa protein cut to 1022 residues"
        cos, rel, drift = check_card_vs_cpu(key, embedder, config, rng)
        if drift:
            extra += " | drift, card vs CPU, by length (not held): " + ", ".join(
                f"{n} aa {d:.3g}" for n, d in drift.items())
        held = OTHER_AGREE_LEN.get(key, OTHER_HELD_LEN)
        log(f"phase 11 {key}: {n_params / 1e6:.1f} M parameters (init"
            f" {init_s:.2f} s) | {len(seqs)} proteins, {residues} residues,"
            f" {n_batches} batches, {padded} padded tokens | embed"
            f" {wall:.3f} s ({residues / wall:.0f} residues/s) | peak"
            f" {peak / 2**30:.2f} GiB | card vs CPU on 2 proteins of"
            f" {held}/{held * 5 // 8} aa: cosine min {cos:.9f}, relative L2"
            f" error max {rel:.3g}{extra}")
        profile_other_batch(key, embedder, seqs)
        if key == "SeqVec":
            seqvec = embedder
        else:
            del embedder
    shared.clear()
    with tempfile.TemporaryDirectory(prefix="knn_seqvec_") as tmp:
        run_embed_cli(seqvec, tmp, seqs)
    del seqvec
    torch.cuda.empty_cache()
    log(f"phase 11 done in {time.perf_counter() - t_phase:.1f} s")


def run_seqvec_serving(kernels, seed):
    """Phase 11 for SeqVec at its published widths in bf16 (the
    `seqvec.mix` cell's route; the benchmark's weights, bilm-tf's
    Glorot-uniform LSTMs): `embed_pooled` of phase 11's proteins through
    the registry in 16384-token batches, kernel M launched once a layer a
    batch and the step loop never; then 4 of them, the longest among
    them, against the fp32 route (the step loop) on the card."""
    import torch

    from knn_for_homology_tpu_torch.models import elmo
    from knn_for_homology_tpu_torch.models.registry import get_embedder
    from knn_for_homology_tpu_torch.ops import lstm, lstm_cuda
    from portbench.drivers.embed_seqvec import seqvec_weights
    from portbench.lib import harness

    dev = torch.device("cuda")
    cfg = harness.load_json(harness.BENCH_DIR / "configs" / "seqvec.json")
    rng = np.random.RandomState(seed + 11)
    lengths = list(protein_lengths(rng, OTHER_PROTEINS)) + [OTHER_LONG]
    seqs = [AAS[rng.randint(0, 20, n)].tobytes().decode() for n in lengths]
    config = dataclasses.replace(elmo.SEQVEC, dtype=torch.bfloat16)
    params = seqvec_weights(cfg, seed, dev, torch.bfloat16)
    embedder = get_embedder("SeqVec", config=config, params=params,
                            max_batch_tokens=16384, device=dev)
    batches = embedder.batches(seqs)
    embedder.embed_pooled(seqs[:1])  # cuBLAS warm
    plain = lstm.lstmp_bidir_plain
    loop_calls = []

    def counted_plain(*args):
        loop_calls.append(1)
        return plain(*args)

    lstm_cuda.lstmp_bidir.launches = lstm_cuda.lstmp_bidir.steps = 0
    # the step loop, where the fp32 route and the wrapper's CPU route call it
    elmo.lstmp_bidir_plain = lstm_cuda.lstmp_bidir_plain = counted_plain
    try:
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        pooled = embedder.embed_pooled(seqs)
        embed_s = time.perf_counter() - t0
    finally:
        elmo.lstmp_bidir_plain = lstm_cuda.lstmp_bidir_plain = plain
    peak = torch.cuda.max_memory_allocated()
    launches, steps = lstm_cuda.lstmp_bidir.launches, lstm_cuda.lstmp_bidir.steps
    assert launches == 2 * len(batches), (
        f"kernel M: {launches} launches for {len(batches)} batches")
    assert steps == sum(2 * (max(len(s) for s in b.sequences) + 2)
                        for b in batches), steps
    assert not loop_calls, "the bf16 route ran the step loop"
    assert pooled.shape == (len(seqs), 1024) and np.isfinite(pooled).all()
    kernels["M"]["launches"] = launches
    kernels["M"]["launches_by_phase"] = {"11": launches}
    subset = seqs[:3] + [max(seqs, key=len)]
    fp32 = get_embedder("SeqVec", params=params, max_batch_tokens=16384,
                        config=elmo.SEQVEC, device=dev)
    want = fp32.embed_pooled(subset)
    got = embedder.embed_pooled(subset)
    rel = np.linalg.norm(got - want, axis=1) / np.linalg.norm(want, axis=1)
    assert rel.max() < BF16_TOL, rel
    residues = sum(lengths)
    log(f"phase 11 SeqVec bf16 on M: {len(seqs)} proteins, {residues}"
        f" residues, {len(batches)} batches | embed {embed_s:.3f} s"
        f" ({residues / embed_s:.0f} residues/s) | peak {peak / 2**30:.2f}"
        f" GiB | kernel M launches {launches} = 2 x {len(batches)}, {steps}"
        f" serial steps, the step loop none | pooled vs the fp32 route on"
        f" {len(subset)} proteins: relative L2 error max {rel.max():.4g}"
        f" (longest, {len(subset[-1])} aa: {rel[-1]:.4g})")
    del embedder, fp32
    torch.cuda.empty_cache()


# ----------------------------------------------------------- phase 12
# phase 12 (b): two gloo ranks sharing the card, the same indexes at a
# smaller depth; the encoder at ProtT5-XL width on SHARD_PROTEINS proteins of
# the length mix plus one above blockwise_above (kernel H's route)
SHARD_ROWS, SHARD_QUERIES, SHARD_PROTEINS, SHARD_LONG = 32768, 1024, 64, 1500
# (a)'s IVF: the pipeline's nprobe; (b)'s IVF covers every cell of its
# shard, so its top-10 is the exact one (the dry run's golden)
SHARD_NPROBE = 32
# (d): pairs of the main path's mix, each test protein against its family's
# first train member
PAIRS = N_TEST


def kernel_counters():
    """Every kernel's launch count, by letter."""
    from knn_for_homology_tpu_torch.ops import (
        align_cuda,
        exact_cuda,
        ffn_cuda,
        flash_cuda,
        flat_cuda,
        ivf_cuda,
        lstm_cuda,
        packed_cuda,
        relattn_cuda,
        short_cuda,
        slab_cuda,
    )

    plain = {"A": flat_cuda.flat_topk_kernel,
             "B": exact_cuda.segment_topr_kernel,
             "C": align_cuda.sw_scores_grouped, "G": ffn_cuda.fused_ffn_t5,
             "H": flash_cuda.flash_attention_t5,
             "I": short_cuda.short_attention_t5,
             "J": ivf_cuda.segment_packed_indirect_kernel,
             "K": slab_cuda.beam_expand,
             "L": relattn_cuda.relative_attention,
             "M": lstm_cuda.lstmp_bidir}
    return plain, packed_cuda.segment_packed_kernel.launches


def reset_kernel_counts():
    plain, packed = kernel_counters()
    for fn in plain.values():
        fn.launches = 0
    for key in packed:
        packed[key] = 0


def read_kernel_counts() -> dict:
    plain, packed = kernel_counters()
    out = {key: fn.launches for key, fn in plain.items()}
    out.update(packed)
    return {key: out[key] for key in KERNEL_LETTERS}


def recall_at(ids, exact_ids, k=10):
    return float(np.mean([len(set(a[:k]) & set(b[:k])) / k
                          for a, b in zip(ids, exact_ids)]))


def tokens_of(batch, dev):
    """(ids, mask, residue mask) of one batch, as ProtT5Embedder builds
    them: EOS kept in the mask, dropped from the pooling."""
    import torch

    from knn_for_homology_tpu_torch.models import t5
    from knn_for_homology_tpu_torch.models.batching import pad_tokens

    ids, mask = pad_tokens([t5.tokenize(s) for s in batch.sequences],
                           batch.padded_len, t5.PAD_ID)
    res = mask.copy()
    for row, seq in enumerate(batch.sequences):
        res[row, len(seq):] = False
    return [torch.from_numpy(a).to(dev) for a in (ids, mask, res)]


def sharded_rank(data_dir, seqs, seed):
    """Phase 12 (b) (and scripts/torch_multichip.py), one rank of the
    group: the sharded indexes over the rows in `data_dir` (a shard a
    rank; the IVF probes every cell of its shard), then encode_sharded at
    ProtT5-XL width, the heads and d_ff split over every rank. Returns its
    results, seconds and kernel launches (counted from zero here)."""
    import torch
    import torch.distributed as dist

    from knn_for_homology_tpu_torch.models import t5
    from knn_for_homology_tpu_torch.models.batching import make_batches
    from knn_for_homology_tpu_torch.models.pooling import mean_pool
    from knn_for_homology_tpu_torch.ops.distance import l2_normalize
    from knn_for_homology_tpu_torch.parallel import (
        DATA_AXIS,
        MODEL_AXIS,
        ShardedFlatIndex,
        ShardedGraphIndex,
        ShardedIVFIndex,
        ShardedLSHIndex,
        db_sharded_topk,
        make_mesh,
        make_pod_mesh,
    )
    from knn_for_homology_tpu_torch.parallel.encoder_sharding import (
        encode_sharded,
        shard_t5_params,
    )

    dev = torch.device("cuda")
    db = np.load(Path(data_dir) / "db.npy")
    q = np.load(Path(data_dir) / "q.npy")
    world = dist.get_world_size()
    mesh, pod = make_mesh(world), make_pod_mesh(n_ici=world, n_dcn=1)
    cover = -(-2 * -(-db.shape[0] // world) // 128)  # the cells of a shard
    reset_kernel_counts()
    out, secs = {}, {}

    def timed(name, fn):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        res = fn()
        torch.cuda.synchronize()
        secs[name] = time.perf_counter() - t0
        out[name] = res

    dbn = l2_normalize(torch.from_numpy(db).to(dev))
    qn = l2_normalize(torch.from_numpy(q).to(dev))
    timed("db_sharded", lambda: tuple(a.cpu().numpy() for a in db_sharded_topk(
        dbn, qn, BENCH_K, mesh, metric="ip")))
    timed("flat", lambda: ShardedFlatIndex(pod, device=dev).add(db).search(
        q, BENCH_K)[1])
    timed("ivf_probe", lambda: ShardedIVFIndex(
        mesh, nprobe=cover, device=dev).build(db).search(q, 10))
    timed("ivf_union", lambda: ShardedIVFIndex(
        mesh, nprobe=cover, union_budget=cover,
        device=dev).build(db).search(q, 10))
    timed("graph", lambda: ShardedGraphIndex(mesh, device=dev).build(
        db).search(q, 10)[1])
    timed("lsh", lambda: ShardedLSHIndex(mesh, DIM, LSH_BITS, device=dev).add(
        db).finalize().search(q, BENCH_K))

    tp = make_mesh(world, axis_names=(DATA_AXIS, MODEL_AXIS),
                   shape=(1, world))
    config = t5.PROTT5_XL
    full = t5.init_params(config, seed=seed, device=dev)
    local = shard_t5_params(full, tp)
    del full
    torch.cuda.empty_cache()
    pooled = np.zeros((len(seqs), config.d_model), np.float32)

    def encode():
        for batch in make_batches(seqs, TOKEN_BUDGET):
            ids, mask, res = tokens_of(batch, dev)
            hidden = encode_sharded(local, ids, mask, config, tp)
            pooled[batch.indices] = mean_pool(hidden, res).float().cpu().numpy()
        return pooled

    timed("encode", encode)
    return {"out": out, "secs": secs, "launches": read_kernel_counts(),
            "peak": torch.cuda.max_memory_allocated()}


def encoder_proteins(test_seqs, seed):
    """SHARD_PROTEINS - 1 proteins of the length mix and one of SHARD_LONG
    aa, above blockwise_above (kernel H's route)."""
    from knn_for_homology_tpu_torch.models import t5

    rng = np.random.RandomState(seed + 12)
    seqs = list(rng.choice(np.asarray(test_seqs, dtype=object),
                           SHARD_PROTEINS - 1, replace=False))
    seqs.append(AAS[rng.randint(0, 20, SHARD_LONG)].tobytes().decode())
    assert max(map(len, seqs)) > t5.PROTT5_XL.blockwise_above
    return seqs


def shard_graph_ref(dbn, qn, world, k=10):
    """ShardedGraphIndex's golden over `world` shards without pad rows:
    each shard's own GraphIndex search, merged by (score descending, lower
    global id), the sharded merge's order."""
    from knn_for_homology_tpu_torch.search.graph import GraphIndex

    n = dbn.shape[0]
    assert n % world == 0, f"{n} rows do not split into {world} even shards"
    rows = n // world
    q = qn.cpu().numpy()
    sims, ids = [], []
    for s in range(world):
        sv, iv = GraphIndex(metric="ip", device=dbn.device).add(
            dbn[s * rows : (s + 1) * rows].cpu().numpy()).search(q, k)
        sims.append(sv)
        ids.append(np.where(iv >= 0, iv + s * rows, -1))
    sims, ids = np.concatenate(sims, 1), np.concatenate(ids, 1)
    order = np.lexsort((ids, -sims), axis=1)[:, :k]
    return np.take_along_axis(ids, order, 1)


def rank_refs(db, q, enc_seqs, seed, world):
    """The unsharded counterparts of sharded_rank's results on `world`
    ranks, on the card: the exact top-k (kernel B), the LSH index, the
    per-shard graph searches' merge and the T5Encoder's pooled vectors
    (the same seeded weights)."""
    import torch

    from knn_for_homology_tpu_torch.models import t5
    from knn_for_homology_tpu_torch.models.registry import ProtT5Embedder
    from knn_for_homology_tpu_torch.ops import exact_cuda
    from knn_for_homology_tpu_torch.ops.distance import l2_normalize
    from knn_for_homology_tpu_torch.search.lsh import LSHIndex

    dev = torch.device("cuda")
    dbn = l2_normalize(torch.from_numpy(db).to(dev))
    qn = l2_normalize(torch.from_numpy(q).to(dev))
    embedder = ProtT5Embedder(config=t5.PROTT5_XL, params=t5.init_params(
        t5.PROTT5_XL, seed=seed, device=dev), token_budget=TOKEN_BUDGET,
        device=dev)
    refs = dict(
        db=db, q=q, dbn=dbn, qn=qn, proteins=enc_seqs,
        exact=exact_cuda.exact_topk(dbn, qn, BENCH_K, metric="ip"),
        lsh=LSHIndex(DIM, LSH_BITS, device=dev).add(db).search(q, BENCH_K),
        graph=shard_graph_ref(dbn, qn, world),
        pooled=embedder.embed_pooled(enc_seqs),
    )
    del embedder
    torch.cuda.empty_cache()
    return refs


def rank_data(tmp: Path, refs) -> str:
    """The rows and queries of sharded_rank, saved for its processes."""
    data_dir = tmp / "shard_data"
    data_dir.mkdir()
    np.save(data_dir / "db.npy", refs["db"])
    np.save(data_dir / "q.npy", refs["q"])
    return str(data_dir)


def check_ranks(tag, ranks, refs, wall, card) -> dict:
    """sharded_rank's results held to the unsharded counterparts (the dry
    run's goldens): db-sharded and flat ids of the exact top-k, the IVF at
    a covering nprobe and budget the exact top-10, the graph's ids those of
    the per-shard GraphIndex searches' merge, LSH bit-equal, the
    tensor-parallel encoder within phase 8's bound; near-tie swaps (within
    SCORE_ATOL, fp64-checked) counted. Returns the launches of all ranks."""
    import torch

    dbn, qn, exact = refs["dbn"], refs["qn"], refs["exact"]
    r0 = ranks[0]
    for other in ranks[1:]:
        for key in ("flat", "graph"):
            assert np.array_equal(other["out"][key], r0["out"][key]), key
    swaps = {}
    got = tuple(torch.from_numpy(a).to(dbn.device)
                for a in r0["out"]["db_sharded"])
    _, swaps["db_sharded"] = check_topk(f"{tag} db_sharded", got, exact,
                                        dbn, qn)
    assert np.array_equal(r0["out"]["flat"], r0["out"]["db_sharded"][1])
    # the covering IVF's fp32 rescore (bmm) and B's 3xTF32 products may
    # order near-ties apart
    top10 = (exact[0][:, :10].contiguous(), exact[1][:, :10].contiguous())
    for key in ("ivf_probe", "ivf_union"):
        got = tuple(torch.from_numpy(a).to(dbn.device) for a in r0["out"][key])
        _, swaps[key] = check_topk(f"{tag} {key}", got, top10, dbn, qn)
    assert np.array_equal(r0["out"]["graph"], refs["graph"]), (
        f"{tag}: ShardedGraphIndex ids differ from the per-shard merge")
    assert np.array_equal(r0["out"]["lsh"][1], refs["lsh"][1])
    assert np.array_equal(r0["out"]["lsh"][0], refs["lsh"][0])
    pooled = r0["out"]["encode"]
    assert pooled.shape == refs["pooled"].shape and np.isfinite(pooled).all()
    cos, rel = check_pooled(f"{tag} encode_sharded", pooled, refs["pooled"])
    launches = {key: sum(r["launches"][key] for r in ranks)
                for key in KERNEL_LETTERS}
    for key in "BJKGH":
        assert launches[key] > 0, f"{tag}: kernel {key} not launched"
    n, world = len(refs["db"]), len(ranks)
    residues = sum(len(s) for s in refs["proteins"])
    heads, d_ff = 32 // world, 16384 // world
    log(f"{tag}, {world} ranks, {n} x {DIM}, {len(refs['q'])} queries |"
        f" {card} | wall {wall:.1f} s (spawn and CUDA start included) |"
        " rank 0 seconds: "
        + ", ".join(f"{k} {v:.3f}" for k, v in r0["secs"].items())
        + f" | db_sharded / ShardedFlatIndex ids equal to exact_topk but"
        f" {swaps['db_sharded']} near-tie swaps; IVF per-probe and union"
        f" (nprobe = budget = every cell of a shard) top-10 equal to the"
        f" exact top-10 but {swaps['ivf_probe']} and {swaps['ivf_union']}"
        f" near-tie swaps; LSH bit-equal to LSHIndex; graph ids equal to"
        f" the merge of {world} per-shard GraphIndex searches, recall@10"
        f" {recall_at(r0['out']['graph'], exact[1][:, :10].cpu().numpy()):.4f}"
        f" | encode_sharded ProtT5-XL, {heads} heads and d_ff {d_ff} a rank,"
        f" {len(pooled)} proteins ({residues} residues, longest"
        f" {max(map(len, refs['proteins']))}):"
        f" {residues / r0['secs']['encode']:.0f} residues/s; pooled vs the"
        f" unsharded T5Encoder: cosine min {cos:.6f}, relative L2 max"
        f" {rel.max():.4g} (bound: cosine >= {ENC_MIN_COSINE}, relative L2"
        f" <= {ENC_MAX_REL_ERR}) | peak {r0['peak'] / 2**30:.2f} GiB a rank"
        f" | launches (all ranks) {launches}")
    return launches


def run_sharded(train, test, train_seqs, test_seqs, kernels, seed, tmp):
    """Phase 12: the sharded path (parallel/). (a) one NCCL rank in this
    process at full width over phase 4's vectors; (b) two gloo ranks
    sharing the card (sharded_rank); (c) dryrun_multichip(2) on gloo; (d)
    sw_scores / align_pairs through kernel C. Unsharded counterparts are
    computed before the counts are reset."""
    import torch

    from knn_for_homology_tpu_torch.entry import dryrun_multichip
    from knn_for_homology_tpu_torch.ops import align as align_ops
    from knn_for_homology_tpu_torch.ops import align_cuda, exact_cuda
    from knn_for_homology_tpu_torch.ops.distance import l2_normalize
    from knn_for_homology_tpu_torch.ops.packed_cuda import packed_topk
    from knn_for_homology_tpu_torch.parallel import (
        ShardedFlatIndex,
        ShardedGraphIndex,
        ShardedIVFIndex,
        ShardedLSHIndex,
        db_sharded_topk,
        make_mesh,
        make_pod_mesh,
    )
    from knn_for_homology_tpu_torch.parallel.mesh import process_group, spawn
    from knn_for_homology_tpu_torch.parallel.scale import ShardSweep
    from knn_for_homology_tpu_torch.search.graph import GraphIndex
    from knn_for_homology_tpu_torch.search.ivf import IVFIndex
    from knn_for_homology_tpu_torch.search.lsh import LSHIndex

    t_phase = time.perf_counter()
    dev = torch.device("cuda")
    card = card_line()
    db = l2_normalize(torch.from_numpy(train).to(dev)).contiguous()
    qn = l2_normalize(torch.from_numpy(test).to(dev)).contiguous()
    n_a = N_TRAIN - 1  # (a)'s flat search leaves one pad row in its shard
    sweep_half = SHARD_ROWS // 2

    # ---- the unsharded counterparts (their launches are not phase 12's)
    ref_exact = exact_cuda.exact_topk(db[:n_a], qn, BENCH_K, metric="ip")
    top10 = ref_exact[1][:, :10].cpu().numpy()
    ref_sq8 = packed_topk(db, qn, BENCH_K, metric="ip", storage="sq8-sym")
    ivf = IVFIndex(metric="ip", nprobe=SHARD_NPROBE, kmeans_iters=16,
                   device=dev).add(db.cpu().numpy())
    ref_probe = ivf.search(qn[:256].cpu().numpy(), 10)
    ref_union = ivf.search(qn[:1024].cpu().numpy(), 10,
                           union_budget=ivf._centroids.shape[0])
    del ivf
    graph = GraphIndex(metric="ip", device=dev).add(db.cpu().numpy())
    ref_graph = graph.search(qn.cpu().numpy(), BENCH_K)
    del graph
    ref_lsh = LSHIndex(DIM, LSH_BITS, device=dev).add(train).search(
        test, BENCH_K)
    halves = [train[:sweep_half], train[sweep_half:SHARD_ROWS]]
    parts = [GraphIndex(device=dev, iters=8).add(h).search(test, 10)
             for h in halves]
    cand_s = np.concatenate([parts[0][0], parts[1][0]], 1)
    cand_i = np.concatenate([parts[0][1], parts[1][1] + sweep_half], 1)
    ref_sweep = np.take_along_axis(
        cand_i, np.argsort(-cand_s, axis=1, kind="stable")[:, :10], 1)
    enc_seqs = encoder_proteins(test_seqs, seed)
    refs = rank_refs(train[:SHARD_ROWS], test[:SHARD_QUERIES], enc_seqs,
                     seed, world=2)
    log(f"phase 12 unsharded counterparts in {time.perf_counter() - t_phase:.1f}"
        " s")

    # ---- (a) one NCCL rank, full width, counts from zero
    reset_kernel_counts()
    torch.cuda.synchronize()
    secs, res = {}, {}

    def timed(name, fn):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        res[name] = fn()
        torch.cuda.synchronize()
        secs[name] = time.perf_counter() - t0

    with process_group("nccl"):
        mesh, pod = make_mesh(1), make_pod_mesh(n_ici=1, n_dcn=1)
        # all 131072 rows, n_valid 131071: kernel B masks the pad row
        timed("db_sharded", lambda: db_sharded_topk(
            db, qn, BENCH_K, mesh, metric="ip", n_valid=n_a))
        b_live = exact_cuda.segment_topr_kernel.launches
        # again, the group's communicator set up by the first call
        timed("db_sharded_warm", lambda: db_sharded_topk(
            db, qn, BENCH_K, mesh, metric="ip", n_valid=n_a))
        timed("flat", lambda: ShardedFlatIndex(mesh, device=dev).add(
            train[:n_a]).search(test, BENCH_K))
        timed("flat_sq8", lambda: ShardedFlatIndex(
            mesh, storage="sq8-sym", device=dev).add(train).search(
                test, BENCH_K))
        timed("ivf_probe", lambda: ShardedIVFIndex(
            mesh, nprobe=SHARD_NPROBE, device=dev).build(train).search(
                test[:256], 10))
        timed("ivf_union", lambda: ShardedIVFIndex(
            mesh, nprobe=SHARD_NPROBE, union_budget=N_TRAIN, device=dev
        ).build(train).search(test[:1024], 10))
        timed("graph", lambda: ShardedGraphIndex(pod, device=dev).build(
            train).search(test, BENCH_K))
        timed("lsh", lambda: ShardedLSHIndex(
            mesh, DIM, LSH_BITS, device=dev).add(train).finalize().search(
                test, BENCH_K))

        def sweep():
            sw = ShardSweep(Path(tmp) / "sweep", iters=8, device=dev)
            build = [sw.build_shard(h) for h in halves]
            return build, sw.search(test, 10)

        timed("sweep", sweep)
    launches_a = read_kernel_counts()
    assert b_live > 0, "(a): kernel B did not run with a live n_valid mask"
    # db_sharded's split (not launches of the path): its shard-local call
    # alone at the traced plan, and exact_topk at the default plan
    timed("local_traced", lambda: exact_cuda.exact_topk_traced(
        db, qn, BENCH_K, metric="ip", n_valid=n_a))
    timed("local_default", lambda: exact_cuda.exact_topk(
        db, qn, BENCH_K, metric="ip", n_valid=n_a))
    tile = exact_cuda.default_db_tile(BENCH_K)
    plans = {t: exact_cuda.plan(N_TRAIN, BENCH_K, tile, exact_row_target=t)
             for t in (1e-6, 3e-3)}
    for key in "BFJK":
        assert launches_a[key] > 0, f"phase 12 (a): kernel {key} not launched"

    swaps = {}
    got = res["db_sharded"]
    _, swaps["db_sharded"] = check_topk("12a db_sharded", got, ref_exact,
                                        db, qn)
    assert int(got[1].max()) < n_a
    flat = tuple(torch.from_numpy(a).to(dev) for a in res["flat"])
    _, swaps["flat"] = check_topk("12a ShardedFlatIndex", flat, ref_exact,
                                  db, qn)
    assert np.array_equal(res["flat_sq8"][1], ref_sq8[1].cpu().numpy())
    assert np.array_equal(res["ivf_probe"][1], ref_probe[1])
    assert np.array_equal(res["ivf_union"][1], ref_union[1])
    assert np.array_equal(res["graph"][1], ref_graph[1])
    assert np.array_equal(res["lsh"][1], ref_lsh[1])
    assert np.array_equal(res["lsh"][0], ref_lsh[0])
    build_s, (sweep_s, sweep_i, shard_s) = res["sweep"]
    assert np.array_equal(sweep_i, ref_sweep)
    recalls = {
        "flat": recall_at(res["flat"][1], top10),
        "flat sq8-sym": recall_at(res["flat_sq8"][1], top10),
        "ivf per-probe": recall_at(res["ivf_probe"][1], top10[:256]),
        "ivf union": recall_at(res["ivf_union"][1], top10[:1024]),
        "graph": recall_at(res["graph"][1], top10),
        "lsh": recall_at(res["lsh"][1], top10),
    }
    log(f"phase 12 (a) one NCCL rank, {N_TRAIN} x {DIM}, {N_TEST} queries |"
        f" {card} | db_sharded k={BENCH_K} (n_valid {n_a}: kernel B's live"
        f" mask) {secs['db_sharded']:.3f} s, again"
        f" {secs['db_sharded_warm']:.3f} s; its shard-local"
        f" exact_topk_traced alone (W, R {plans[1e-6]})"
        f" {secs['local_traced']:.3f} s, exact_topk at the default plan"
        f" (W, R {plans[3e-3]}) {secs['local_default']:.3f} s; ids equal"
        f" to the unsharded exact_topk but {swaps['db_sharded']} near-tie"
        " swaps;"
        f" ShardedFlatIndex ({n_a} rows) {secs['flat']:.3f} s, but"
        f" {swaps['flat']} near-tie swaps; sq8-sym (F)"
        f" {secs['flat_sq8']:.3f} s, ids equal to packed_topk; IVF per-probe"
        f" (K, 256 q, k=10) {secs['ivf_probe']:.3f} s and union (J, 1024 q,"
        f" every cell) {secs['ivf_union']:.3f} s incl. builds, ids equal to"
        f" IVFIndex; graph (B build, K) {secs['graph']:.3f} s incl. build,"
        f" ids equal to GraphIndex; LSH {secs['lsh']:.3f} s, bit-equal to"
        f" LSHIndex; ShardSweep 2 x {sweep_half} graph shards: builds"
        f" {', '.join(f'{b:.3f}' for b in build_s)} s, shard searches"
        f" {', '.join(f'{s:.3f}' for s in shard_s)} s, ids equal to the"
        f" in-memory shards' merge | recall@10 vs flat exact: "
        + ", ".join(f"{k} {v:.4f}" for k, v in recalls.items())
        + f" | launches {launches_a}")

    # ---- (b) two gloo ranks sharing the card
    t0 = time.perf_counter()
    ranks = spawn(sharded_rank, 2, device="cuda", backend="gloo",
                  args=(rank_data(Path(tmp), refs), enc_seqs, seed))
    launches_b = check_ranks("phase 12 (b) two gloo ranks on one card",
                             ranks, refs, time.perf_counter() - t0, card)

    # ---- (c) the dry run, two gloo ranks on the card
    t0 = time.perf_counter()
    dry = dryrun_multichip(2, device="cuda", backend="gloo")
    log(f"phase 12 (c) dryrun_multichip(2, cuda, gloo): {dry['steps']} steps"
        f" held to their goldens in {time.perf_counter() - t0:.1f} s"
        f" (encoder vs unsharded max |diff| {dry['encoder_max_abs']:.3g},"
        " bf16) | " + card)

    # ---- (d) pair alignment through kernel C
    queries = list(test_seqs[:PAIRS])
    targets = [train_seqs[i * FAMILY_TRAIN] for i in range(PAIRS)]
    cells = float(sum(len(a) * len(b) for a, b in zip(queries, targets)))
    align_cuda.sw_scores_grouped.launches = 0
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    scores, evs = align_ops.align_pairs(queries, targets, device="cuda")
    pairs_s = time.perf_counter() - t0
    c_launches = align_cuda.sw_scores_grouped.launches
    assert c_launches > 0 and np.isfinite(evs).all() and scores.max() > 0
    lq = max(256, -(-max(map(len, queries)) // 256) * 256)
    lt = max(256, -(-max(map(len, targets)) // 256) * 256)
    qd = torch.from_numpy(np.stack([align_ops.encode_sequence(s, lq)
                                    for s in queries])).to(dev)
    td = torch.from_numpy(np.stack([align_ops.encode_sequence(s, lt)
                                    for s in targets])).to(dev)
    half = PAIRS // 2  # align_pairs' batches of 2048 pairs
    k_out = torch.cat([align_ops.sw_scores(qd[s:s + half], td[s:s + half],
                                           convention="mmseqs")
                       for s in (0, half)])
    p_out = torch.cat([align_cuda.sw_scores_grouped_plain(
        qd[s:s + half], td[s:s + half, None, :], convention="mmseqs")[:, 0]
        for s in (0, half)])
    assert torch.equal(k_out, p_out), "C: sw_scores differs from plain"
    assert np.array_equal(scores, k_out.cpu().numpy())
    ms = cuda_ms(lambda: [align_ops.sw_scores(qd[s:s + half], td[s:s + half])
                          for s in (0, half)], reps=3)
    log(f"phase 12 (d) align_pairs: {PAIRS} pairs of the main path's mix"
        f" ({cells:.4g} real cells) in {pairs_s:.3f} s, {c_launches} C"
        f" launches; sw_scores (K = 1) bit-equal to plain; kernel C"
        f" {ms:.3f} ms for both batches ({cells / ms / 1e6:.1f} GCUPS) | "
        + card)

    launches = {key: launches_a[key] + launches_b[key] for key in launches_a}
    launches["C"] += c_launches
    for key, entry in kernels.items():
        entry.setdefault("launches_by_phase", {})["12"] = launches[key]
    log(f"phase 12 done in {time.perf_counter() - t_phase:.1f} s | launches"
        f" {launches}")


# phase 13: the MMseqs2 record I/O (interop/), the prefilter DB of each
# shape (queries x hits: the main path's 13, the reference's prefilter
# size 300) and an alignment-format result DB of the same shape; a share
# of the hits missing (-1, skipped by the writers)
MMSEQS_IO_SHAPES = ((131072, 13), (32768, 300))
MMSEQS_IO_MISSING = 0.01
MMSEQS_IO_POOL = 65536  # distinct alignment lines the result DB draws from


@contextlib.contextmanager
def python_io_route(native):
    """The MMseqs2 format functions on their Python route, as where the
    native library cannot be built."""
    load = native.load
    native.load = lambda: None
    try:
        yield
    finally:
        native.load = load


def write_alignment_db(db: Path, kept, rng):
    """An alignment-format result DB (`mmseqs align`'s ten columns, the
    E-value in column 3): record q holds kept[q] lines drawn from a pool of
    MMSEQS_IO_POOL seeded lines; returns its bytes."""
    n = MMSEQS_IO_POOL
    cols = zip(rng.integers(0, N_TRAIN, n).tolist(),
               rng.integers(20, 900, n).tolist(), rng.random(n).tolist(),
               (10.0 ** rng.uniform(-250, 1, n)).tolist(),
               rng.integers(50, 2000, (n, 4)).tolist())
    pool = [f"{t}\t{s}\t{i:.3f}\t{e:.3E}\t0\t{a}\t{b}\t0\t{c}\t{d}\n".encode()
            for t, s, i, e, (a, b, c, d) in cols]
    picks = rng.integers(0, n, int(kept.sum())).tolist()
    bounds = np.concatenate([[0], np.cumsum(kept)]).tolist()
    records = [b"".join([pool[i] for i in picks[a:b]]) + b"\0"
               for a, b in zip(bounds, bounds[1:])]
    offsets = np.concatenate([[0], np.cumsum([len(r) for r in records])])
    Path(f"{db}.0").write_bytes(b"".join(records))
    Path(f"{db}.index").write_text("".join(
        f"{q}\t{offsets[q]}\t{len(r)}\n" for q, r in enumerate(records)))
    return int(offsets[-1])


def run_mmseqs_io(seed, tmp, card):
    """Phase 13: the MMseqs2 prefilter writer and result reader
    (interop/mmseqs_format.py) on their native route (interop/native, C++
    built with g++ at first use) and their Python route, at each of
    MMSEQS_IO_SHAPES, counts from zero. The native route must run, and its
    files and arrays must equal the Python route's."""
    from knn_for_homology_tpu_torch.interop import mmseqs_format, native

    t_phase = t0 = time.perf_counter()
    assert native.load() is not None, "phase 13: the native I/O did not build"
    log(f"phase 13 build: {time.perf_counter() - t0:.3f} s ->"
        f" {native.library_path().name}")
    rng = np.random.default_rng(seed)
    out = Path(tmp)
    for nq, k in MMSEQS_IO_SHAPES:
        hits = rng.integers(0, N_TRAIN, (nq, k))
        hits[rng.random((nq, k)) < MMSEQS_IO_MISSING] = -1
        scores = rng.uniform(-1, 1, (nq, k)).astype(np.float32)  # cosines
        args = (np.arange(nq), scores, rng.permutation(nq),
                rng.permutation(N_TRAIN))
        native.write_prefilter_native.calls = 0
        native.read_result_records_native.calls = 0
        secs = {}
        t0 = time.perf_counter()
        mmseqs_format.write_prefilter_db(hits, out / "pf_native", *args)
        secs["write native"] = time.perf_counter() - t0
        with python_io_route(native):
            t0 = time.perf_counter()
            mmseqs_format.write_prefilter_db(hits, out / "pf_python", *args)
            secs["write python"] = time.perf_counter() - t0
        pf_bytes = 0
        for suffix in (".0", ".index", ".dbtype"):
            got = Path(f"{out / 'pf_native'}{suffix}").read_bytes()
            want = Path(f"{out / 'pf_python'}{suffix}").read_bytes()
            assert got == want, f"phase 13: {nq} x {k} {suffix} differs"
            pf_bytes += len(got)

        aln = out / "aln"
        aln_bytes = write_alignment_db(aln, (hits != -1).sum(1), rng)
        t0 = time.perf_counter()
        got = mmseqs_format.read_result_records(aln)
        secs["read native"] = time.perf_counter() - t0
        with python_io_route(native):
            t0 = time.perf_counter()
            want = mmseqs_format.read_result_records(aln)
            secs["read python"] = time.perf_counter() - t0
        calls = (native.write_prefilter_native.calls,
                 native.read_result_records_native.calls)
        assert calls == (1, 1), f"phase 13: native route calls {calls}"
        assert np.array_equal(got[0], want[0]), "phase 13: query ids differ"
        for name, a, b in (("targets", got[1], want[1]),
                           ("E-values", got[2], want[2])):
            assert [len(x) for x in a] == [len(x) for x in b], name
            assert np.array_equal(np.concatenate(a), np.concatenate(b)), (
                f"phase 13: {nq} x {k} {name} differ")
        entries = int((hits != -1).sum())
        assert sum(len(a) for a in got[1]) == entries
        log(f"phase 13 MMseqs2 I/O {nq} x {k} ({entries} hits): prefilter"
            f" DB {pf_bytes} bytes, write native"
            f" {secs['write native']:.3f} s / python"
            f" {secs['write python']:.3f} s, bytes equal; alignment DB"
            f" {aln_bytes} bytes, read native {secs['read native']:.3f} s /"
            f" python {secs['read python']:.3f} s, arrays equal; native"
            f" calls (write, read) {calls} | {card}")
        for path in out.iterdir():
            path.unlink()
    log(f"phase 13: {time.perf_counter() - t_phase:.1f} s (data and"
        " comparisons included)")


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
    max_sm = subprocess.run(
        ["nvidia-smi", "--query-gpu=clocks.max.sm", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip().splitlines()[0]
    log(f"phase 1 environment: {torch.cuda.get_device_name(0)} | {card} |"
        f" max SM clock {max_sm} | torch {torch.__version__} cuda"
        f" {torch.version.cuda}")

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

    # phase 4's dataset stays for phase 10 (the paper pipelines)
    smoke_dir = tempfile.TemporaryDirectory(prefix="knn_smoke_")
    tmp = smoke_dir.name
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
    check_search_kernels(db, q_all, kernels)

    check_packed_kernels(db, q_all[:1024].contiguous(), kernels)

    # the card's blocks (iter_card_blocks, as align_hits on the card)
    # of the main path's own mix: every test query against its family's
    # first 13 train members, plus one 700-aa query with 300 short hits,
    # which packs ragged lanes. Picked: the block with the most lanes,
    # the two with the most real cells (three 256-row strips and more),
    # and the ragged block; each of the first three holds more lanes
    # than the persistent grid has warps, so warps take lane after lane
    rng = np.random.RandomState(args.seed + 1)
    queries = list(test_seqs)
    hits = [train_seqs[i * FAMILY_TRAIN : i * FAMILY_TRAIN + HITS]
            for i in range(N_TEST)]
    queries.append(max(test_seqs, key=len)[:700])
    hits.append([s[: rng.randint(20, 80)] for s in train_seqs[:300]])
    cells = align_ops.plan_align_cells(queries, hits)
    blocks = list(align_ops.iter_card_blocks(cells))
    lanes_of = lambda b: b[4] * max(len(ln) for _, ln in b[5])  # noqa: E731
    classic = [b for b in blocks if b[2] == 1]
    ragged = [b for b in blocks if b[2] > 1]
    assert ragged, "the workload must plan a ragged block"
    widest = max(classic, key=lanes_of)
    picked = [widest] + sorted(
        (b for b in classic if b is not widest),
        key=lambda b: -real_cells(b[5]),
    )[:2] + [max(ragged, key=lanes_of)]
    warps = _build.library().knn_sw_grouped_warps
    c_err, c_ms, c_plain_ms, c_cells, c_bytes = 0.0, 0.0, 0.0, 0, 0
    outnumbered = 0  # blocks of more lanes than the grid's warps
    for lq_b, lt_b, s_b, _, g_pad, block in picked:
        qc, tc = align_ops.lane_codes(block, lq_b, lt_b, g_pad)
        qd, td = torch.from_numpy(qc).to(device), torch.from_numpy(tc).to(device)
        lanes, grid = g_pad * tc.shape[1], warps(g_pad, tc.shape[1])
        outnumbered += lanes > grid
        for conv in ("mmseqs", "blast"):
            kw = dict(convention=conv, segments=s_b)
            k_out = align_cuda.sw_scores_grouped(qd, td, **kw)
            p_out = align_cuda.sw_scores_grouped_plain(qd, td, **kw)
            assert torch.equal(k_out, p_out), (
                f"C: kernel and plain differ on ({lq_b}, {lt_b}, {s_b})"
                f" {conv}: max {float((k_out - p_out).abs().max())}"
            )
            assert float(k_out.max()) > 0
            c_err = max(c_err, float((k_out - p_out).abs().max()))
        kw = dict(convention="mmseqs", segments=s_b)
        ms = cuda_ms(lambda: align_cuda.sw_scores_grouped(qd, td, **kw))
        plain_ms = cuda_ms(  # up to seconds a call: windows of one call
            lambda: align_cuda.sw_scores_grouped_plain(qd, td, **kw), reps=1
        )
        cells = real_cells(block)
        c_ms, c_plain_ms = c_ms + ms, c_plain_ms + plain_ms
        c_cells += cells
        c_bytes += tensor_bytes(qd, td, k_out)
        log(f"phase 3 kernel C sw_grouped block G={g_pad} Lq={lq_b}"
            f" K={tc.shape[1]} Lt={lt_b} S={s_b} ({lanes} lanes, grid of"
            f" {grid} warps): bit-equal (both conventions),"
            f" {ms:.3f} ms vs plain {plain_ms:.3f} ms, {cells} real"
            f" cells, {cells / ms / 1e6:.1f} GCUPS")
    c_bound = bound(SW_OPS_PER_CELL * c_cells, "int32", c_bytes)
    kernels["C"] = dict(
        name="sw_grouped", route="cuda",
        source="knn_for_homology_tpu_torch/csrc/sw_grouped.cu",
        replaces="knn_for_homology_tpu/ops/align_pallas.py:179",
        max_abs_err=c_err, ms=c_ms, plain_ms=c_plain_ms, library_ms=None,
        library=None, gcups=c_cells / c_ms / 1e6, **c_bound,
    )
    assert outnumbered >= 3, "C: the blocks must outnumber the grid's warps"
    log(f"phase 3 kernel C: four card blocks {c_ms:.3f} ms, {c_cells} real"
        f" cells, {c_cells / c_ms / 1e6:.1f} GCUPS, bound"
        f" {c_bound['bound_ms']:.3f} ms ({c_bound['bound_by']}), plain"
        f" {c_plain_ms:.3f} ms")

    check_encoder_kernels(kernels, args.seed)
    check_xlnet_kernel(kernels, args.seed)
    check_lstm_kernel(kernels, args.seed)
    check_ivf_kernels(db, q_all, kernels, args.seed)
    check_graph_kernel_k(train, kernels)

    # ---- phase 4: the main path, counts from zero
    flat_cuda.flat_topk_kernel.launches = 0
    exact_cuda.segment_topr_kernel.launches = 0
    align_cuda.sw_scores_grouped.launches = 0
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    results = benchmark.run(ds, hits=HITS, figures=False, device="cuda")
    wall = time.perf_counter() - t0
    phase4 = {"A": flat_cuda.flat_topk_kernel.launches,
              "B": exact_cuda.segment_topr_kernel.launches}
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
    for key in ("A", "B"):
        kernels[key]["launches_by_phase"] = {
            "4": phase4[key], "5": launches[key] - phase4[key]}
    assert phase4["A"] > 0 and launches["B"] > phase4["B"], (
        "A must run in phase 4, B in phase 5")

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

    # phase 4 profile: a second, warm run of the main path under
    # torch.profiler: C's device time and launches, the H2D copies and
    # the device's busy share
    c_before = align_cuda.sw_scores_grouped.launches
    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    torch.cuda.synchronize()
    with torch.profiler.profile(activities=acts) as prof:
        t0 = time.perf_counter()  # the run, not the trace's processing
        benchmark.run(ds, hits=HITS, figures=False, device="cuda")
        torch.cuda.synchronize()
        prof_s = time.perf_counter() - t0
    c_launches = align_cuda.sw_scores_grouped.launches - c_before
    shares, top = device_time_shares(prof, MAIN_KERNELS)
    device_ms = sum(ms for ms, _ in shares.values())
    c_dev = shares.get("C sw_grouped", (0.0, 0.0))[0]
    assert c_dev > 0 and c_launches > 0, "phase 4: C did not run"
    log(f"phase 4 profile of the main path (wall {prof_s * 1e3:.1f} ms"
        f" under the profiler, device busy {device_ms / (prof_s * 1e3):.3f}):"
        + ", ".join(f" {g} {ms:.1f} ms ({share:.3f})"
                    for g, (ms, share) in shares.items())
        + f" | C: {c_launches} launches, {cells_n / c_dev / 1e6:.1f} GCUPS"
        f" over {cells_n:.4g} real cells | largest of the rest: "
        + ", ".join(f"{nm} {ms:.1f} ms" for nm, ms in top))

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
    f_groups = dict(packed_cuda.segment_packed_kernel.launches_by_group["F"])
    _, a_ids = FlatIndex(device="cuda", backend="approx").add(
        train).search(test, HITS)
    assert flat_cuda.flat_topk_kernel.launches > a_before
    kernels["A"]["launches_by_phase"]["5"] += (
        flat_cuda.flat_topk_kernel.launches - a_before)
    assert np.array_equal(a_ids, ids13), "approx k=13 differs from exact"
    _, s_ids = FlatIndex(device="cuda", backend="sq8").add(
        train).search(qk, 1000)
    assert packed_cuda.segment_packed_kernel.launches["F"] > f_before
    f_groups = {
        g: n - f_groups.get(g, 0)
        for g, n in packed_cuda.segment_packed_kernel.launches_by_group[
            "F"].items() if n > f_groups.get(g, 0)}
    assert min(f_groups) > 1, f"sq8 F launches by passes a product {f_groups}"
    s_recall = float(np.mean(
        [len(set(a) & set(b)) / 1000 for a, b in zip(s_ids, ids)]
    ))
    assert s_recall >= 0.9, f"sq8 backend recall {s_recall}"
    log(f"phase 5 backends: approx k=13 ids equal to exact (kernel A),"
        f" sq8 k=1000 recall {s_recall:.4f} against exact (kernel F;"
        f" launches by passes a product {f_groups})")

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
    run_xlnet(kernels, args.seed)

    # ---- phase 9: the IVF index path, on phase 4's vectors
    del db, q_all, index, plain
    torch.cuda.empty_cache()
    run_ivf_path(train, test, kernels)

    # ---- phase 10: the paper pipelines, on phase 4's dataset
    torch.cuda.empty_cache()
    run_paper_pipelines(ds, train, test, kernels, args.seed)
    smoke_dir.cleanup()

    # ---- phase 11: the other encoder families
    torch.cuda.empty_cache()
    run_other_encoders(args.seed)
    run_seqvec_serving(kernels, args.seed)

    # ---- phase 12: the sharded path, on phase 4's vectors
    torch.cuda.empty_cache()
    with tempfile.TemporaryDirectory(prefix="knn_shard_") as tmp:
        run_sharded(train, test, train_seqs, test_seqs, kernels, args.seed,
                    tmp)
    del train, test

    # ---- phase 13: the MMseqs2 record I/O on the host
    with tempfile.TemporaryDirectory(prefix="knn_mmseqs_") as tmp:
        run_mmseqs_io(args.seed, tmp, card)

    log(card)
    print(json.dumps({"kernels": [kernels[k] for k in KERNEL_LETTERS]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}), flush=True)


if __name__ == "__main__":
    main()
