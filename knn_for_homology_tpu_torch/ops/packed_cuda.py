"""Kernels D, E, F: approx top-k via packed segment-top-R candidates
(csrc/segment_packed.cu). Port of the packed half of
knn_for_homology_tpu/ops/exact_pallas.py (`packed_pallas_topk`).

Column c of the database belongs to segment (lane) c mod W and pass c // W.
Each candidate is one int32, (ordered_int(sim) & ~jmax) | (jmax - pass),
and each lane keeps its R largest: one compare orders by the similarity
truncated to 32 - jbits bits, then by the earlier pass. R comes from the
recall target's Poisson loss bound (exact_cuda.r_for_recall); there is no
certificate. Decoded values carry the truncation (< 2^jbits float32 ulps);
ids are exact for the candidates kept.

Storages:
  * "native"   — D: fp32 or bf16 db and queries, fp32 sums (fp32 on FFMA,
                 bf16 on bf16 `wgmma`);
  * "sq8"      — E: int8 db rows + per-row f32 scales (FAISS SQ8 storage),
                 queries cast to bf16 (the rows widen to bf16 exactly for
                 bf16 `wgmma`);
  * "sq8-sym"  — F: queries quantised to int8 too, int8 x int8 -> int32
                 (ip / cosine only; l2 falls back to "sq8");
  * "sq8-sym2" — F: plus the residual query q_lo = round((q/qsc - q8)·128)
                 as a second int8 pass, combined as hi + lo/128.
The per-query scale of the sym storages is rank-neutral and multiplies the
decoded values. An `SQ8Database` (quantize_database) skips the per-call
quantisation.

A CUDA tensor goes to the kernel; a CPU tensor to `segment_packed_plain`,
which builds the same buffer in plain PyTorch. The decode is PyTorch on
either device, as it was XLA outside the Pallas kernels. Kernel F's plan
lets one int8 product span several passes where it can
(`passes_per_product`); the wrapper counts its launches by that number.
"""

import functools
from typing import Optional, Tuple

import torch

from . import _build
from .distance import METRICS, similarity_block
from .exact_cuda import (
    CANDIDATE_BYTES,
    INT32_MIN,
    _ordered_int,
    default_db_tile,
    plan,
    row_bound,
)
from .topk import NEG_INF, pad_k

STORAGES = ("native", "sq8", "sq8-sym", "sq8-sym2")
SYM_STORAGES = ("sq8-sym", "sq8-sym2")
KERNEL_OF = {"native": "D", "sq8": "E", "sq8-sym": "F", "sq8-sym2": "F"}
# variant codes of knn_segment_packed
_VARIANT = {"sq8": 2, "sq8-sym": 3, "sq8-sym2": 4}


class SQ8Database:
    """Pre-quantised database for the sq8 storages: int8 rows [N, d] and
    per-row f32 dequant scales [N] (quantize_database). Passing one as `db`
    lets repeated searches skip the per-call quantisation."""

    def __init__(self, db_i8: torch.Tensor, scales: torch.Tensor, n: int):
        self.db_i8 = db_i8
        self.scales = scales
        self.n = n


def quantize_int8(
    x: torch.Tensor, reciprocal: bool = False
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Symmetric per-row int8 quantisation (port of
    ops/graph_pallas.py:quantize_int8): row n ≈ q[n] * scale[n], scale =
    max|row| / 127, codes rounded half to even and clipped to ±127.

    The reference's scale depends on where it runs: called eagerly
    (quantize_database) it divides by 127; traced inside a jitted function
    (packed_pallas_topk quantising its queries, or a float database) XLA
    folds the division by the constant into a multiply by f32(1/127), which
    differs in the last bit for ~5% of rows. `reciprocal=True` is that
    second form. Codes are equal either way. Both forms use tensor
    operands, so the CPU and CUDA kernels compute them alike."""
    max_abs = torch.clamp(x.abs().amax(dim=1, keepdim=True), min=1e-30)
    if reciprocal:
        scale = max_abs * torch.full_like(max_abs, 1.0 / 127.0)
    else:
        scale = max_abs / torch.full_like(max_abs, 127.0)
    q = torch.clamp(torch.round(x / scale), -127, 127).to(torch.int8)
    return q, scale[:, 0].to(torch.float32)


def quantize_database(db: torch.Tensor) -> SQ8Database:
    """Quantise a float database once for repeated sq8 searches."""
    q8, scales = quantize_int8(db.to(torch.float32))
    return SQ8Database(q8.contiguous(), scales, db.shape[0])


def quantize_queries(
    queries: torch.Tensor, two_level: bool, reciprocal: bool = True
) -> Tuple[torch.Tensor, Optional[torch.Tensor], torch.Tensor]:
    """(q8, q_lo, qsc) of the sym storages, as packed_pallas_topk computes
    them: int8 codes and per-query scales; sym2 adds the residual at
    exactly qsc/128 (codes ≤ 64). `reciprocal` as in quantize_int8 (the
    reference traces this inside its jitted searches)."""
    q32 = queries.to(torch.float32)
    q8, qsc = quantize_int8(q32, reciprocal=reciprocal)
    q_lo = None
    if two_level:
        resid = q32 / qsc[:, None] - q8.to(torch.float32)
        q_lo = torch.round(resid * 128.0).to(torch.int8)
    return q8, q_lo, qsc


def pass_bits(n: int, db_tile: int) -> int:
    """jbits: the low bits of a packed slot that hold the reversed pass."""
    return max(1, (-(-n // db_tile) - 1).bit_length())


@functools.lru_cache(maxsize=None)
def _group(variant: int, n: int, d: int, w: int, r: int) -> int:
    return _build.library().knn_segment_packed_group(variant, n, d, w, r)


def passes_per_product(
    storage: str, n: int, d: int, db_tile: int, r_slots: int,
    dtype: torch.dtype = torch.bfloat16,
) -> int:
    """Passes of the W lanes that one tensor-core product of the kernel
    spans in its launch plan at these shapes (csrc/segment_packed.cu
    `knn_segment_packed_group`; d padded as the wrapper pads it): more than
    one for kernel F where its plan groups passes, 1 for D (of `dtype`) and
    E. Needs the built library."""
    if storage == "native":
        variant = 0 if dtype == torch.float32 else 1
    else:
        variant = _VARIANT[storage]
    if variant:
        d += -d % 16
    group = _group(variant, n, d, db_tile, r_slots)
    if group < 1:
        raise ValueError(f"no plan for {storage} at n={n}, d={d},"
                         f" W={db_tile}, R={r_slots}")
    return group


def _check(queries, db, db_tile, r_slots, metric, storage, scales, q_lo):
    if metric not in METRICS:
        raise ValueError(f"unknown metric {metric!r}")
    if storage not in STORAGES:
        raise ValueError(f"unknown storage {storage!r}")
    if storage in SYM_STORAGES and metric == "l2":
        raise ValueError("the sym storages score ip / cosine only")
    if db_tile % 64 or r_slots < 1:
        raise ValueError(f"need W % 64 == 0 and R ≥ 1, got {db_tile}, {r_slots}")
    if db.dim() != 2 or queries.dim() != 2 or db.shape[1] != queries.shape[1]:
        raise ValueError(
            f"need db [N, d] and queries [Q, d], got {tuple(db.shape)}"
            f" and {tuple(queries.shape)}"
        )
    tensors = [queries, db] + [t for t in (scales, q_lo) if t is not None]
    if any(t.device != db.device for t in tensors):
        raise ValueError("all operands must be on one device")
    if db.device.type not in ("cpu", "cuda"):
        raise ValueError(f"unsupported device {db.device}")
    if storage == "native":
        if db.dtype not in (torch.float32, torch.bfloat16) or (
            queries.dtype != db.dtype
        ):
            raise TypeError("native storage takes fp32 or bf16 db and queries"
                            " of one dtype")
        return
    want_q = torch.bfloat16 if storage == "sq8" else torch.int8
    if db.dtype != torch.int8 or queries.dtype != want_q:
        raise TypeError(f"{storage} takes an int8 db and {want_q} queries")
    if scales is None or scales.dtype != torch.float32 or (
        scales.shape != (db.shape[0],)
    ):
        raise TypeError(f"{storage} takes float32 scales [N]")
    if storage == "sq8-sym2" and (
        q_lo is None or q_lo.dtype != torch.int8 or q_lo.shape != queries.shape
    ):
        raise TypeError("sq8-sym2 takes int8 q_lo shaped like the queries")


def _packed_sims(queries, db, metric, storage, scales, q_lo):
    """[Q, N] fp32 similarities in the reference kernels' arithmetic."""
    x = db.to(torch.float32)
    q = queries.to(torch.float32)
    if storage == "native":
        return similarity_block(q, x, metric)
    if storage == "sq8":
        sims = (q @ x.T) * scales[None, :]
        if metric == "l2":
            q_sq = torch.sum(q * q, dim=1)
            d_sq = torch.sum(x * x, dim=1) * scales * scales
            sims = 2.0 * sims - q_sq[:, None] - d_sq[None, :]
        return sims
    # int8-valued fp32 products: every partial sum is an integer < 2^24
    # (d ≤ 1024), so these equal the int32 dots exactly
    sims = q @ x.T
    if storage == "sq8-sym2":
        sims = sims + (q_lo.to(torch.float32) @ x.T) * (1.0 / 128.0)
    return sims * scales[None, :]


def segment_packed_plain(
    queries: torch.Tensor, db: torch.Tensor, db_tile: int, r_slots: int,
    metric: str = "ip", storage: str = "native",
    scales: torch.Tensor = None, q_lo: torch.Tensor = None,
    n_valid: int = None,
) -> torch.Tensor:
    """Plain PyTorch version of the kernels: the same [Q, R·W] int32
    packed buffer (fp32 matmul, TF32 off)."""
    n = db.shape[0]
    sims = _packed_sims(queries, db, metric, storage, scales, q_lo)
    valid = None
    if row_bound(n, n_valid) < n:
        valid = torch.arange(n, device=db.device) < row_bound(n, n_valid)
    return pack_lanes(sims, db_tile, r_slots, pass_bits(n, db_tile), valid)


def pack_lanes(
    sims: torch.Tensor, db_tile: int, r_slots: int, jbits: int,
    valid: torch.Tensor = None,
) -> torch.Tensor:
    """[Q, N] similarities -> the [Q, R·W] packed buffer: column c packed
    with its pass c // W into lane c % W, each lane's R largest kept in
    descending order. Columns where `valid` [N] is False never enter."""
    q_n, n = sims.shape
    w, r = db_tile, r_slots
    passes = -(-n // w)
    jmax = (1 << jbits) - 1
    oi = _ordered_int(sims.contiguous().view(torch.int32))
    rev_pass = jmax - torch.arange(n, device=sims.device, dtype=torch.int32) // w
    cand = (oi & ~jmax) | rev_pass[None, :]
    if valid is not None:
        cand = torch.where(valid[None, :], cand, INT32_MIN)
    full = oi.new_full((q_n, passes * w), INT32_MIN)
    full[:, :n] = cand
    # [Q, W, P]: packed values are unique within a lane (distinct pass
    # bits), so topk needs no tie rule
    per_lane = full.view(q_n, passes, w).transpose(1, 2)
    top = torch.topk(per_lane, min(r, passes), dim=2).values
    if passes < r:
        top = torch.cat([top, top.new_full((q_n, w, r - passes), INT32_MIN)], 2)
    return top.transpose(1, 2).reshape(q_n, r * w).contiguous()


def segment_packed_kernel(
    queries: torch.Tensor, db: torch.Tensor, db_tile: int, r_slots: int,
    metric: str = "ip", storage: str = "native",
    scales: torch.Tensor = None, q_lo: torch.Tensor = None,
    n_valid: int = None,
) -> torch.Tensor:
    """Per-segment top-R packed buffer [Q, R·W] int32 (slot r of lane w at
    column r·W + w, empty slots INT32_MIN). Operands as the storage takes
    them: native fp32/bf16 queries and db of one dtype; sq8 bf16 queries,
    int8 db, scales; sym int8 queries (+ q_lo for sym2), int8 db, scales.
    Rows ≥ min(N, n_valid) never enter a slot, while the passes and jbits
    stay those of all N rows, as the reference plans them."""
    _check(queries, db, db_tile, r_slots, metric, storage, scales, q_lo)
    if db.device.type == "cpu":
        return segment_packed_plain(
            queries, db, db_tile, r_slots, metric, storage, scales, q_lo,
            n_valid,
        )
    n, d = db.shape
    q_n = queries.shape[0]
    f32 = storage == "native" and db.dtype == torch.float32
    if not f32 and d % 16:
        # the tensor-core kernels' TMA reads rows of whole 16 bytes; zero
        # columns add 0 to every dot and norm. This copies both operands,
        # the whole db included, on every call (no configuration of the
        # repo has such a d: all are 1024)
        pad = (0, -d % 16)
        queries, db = (torch.nn.functional.pad(t, pad) for t in (queries, db))
        q_lo = None if q_lo is None else torch.nn.functional.pad(q_lo, pad)
        d = db.shape[1]
    queries, db = queries.contiguous(), db.contiguous()
    if storage == "native":
        variant = 0 if f32 else 1
    else:
        variant = _VARIANT[storage]
        scales = scales.contiguous()
        q_lo = None if q_lo is None else q_lo.contiguous()
    buf = torch.empty((q_n, r_slots * db_tile), dtype=torch.int32,
                      device=db.device)
    if q_n == 0:
        return buf
    # l2 on the bf16 tensor-core route: the kernel's squared row norms of
    # the queries, then of the db rows
    norms = (torch.empty(q_n + n, dtype=torch.float32, device=db.device)
             if metric == "l2" and variant in (1, 2) else None)
    code = _build.library().knn_segment_packed(
        queries.data_ptr(), None if q_lo is None else q_lo.data_ptr(),
        db.data_ptr(), None if scales is None else scales.data_ptr(),
        None if norms is None else norms.data_ptr(),
        buf.data_ptr(), q_n, n,
        row_bound(n, n_valid), d, db_tile, r_slots, pass_bits(n, db_tile),
        variant, int(metric == "l2"), _build.stream_ptr(db.device),
    )
    _build.check(code, "knn_segment_packed")
    name = KERNEL_OF[storage]
    segment_packed_kernel.launches[name] += 1
    by_group = segment_packed_kernel.launches_by_group[name]
    group = _group(variant, n, d, db_tile, r_slots)
    by_group[group] = by_group.get(group, 0) + 1
    return buf


segment_packed_kernel.launches = {"D": 0, "E": 0, "F": 0}
# launches by the passes one product spans (passes_per_product)
segment_packed_kernel.launches_by_group = {"D": {}, "E": {}, "F": {}}


def decode_packed(
    buf: torch.Tensor, k: int, db_tile: int, jbits: int
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Packed buffer -> (vals [Q, k] f32, ids [Q, k] int32), value
    descending. Equal packed values (same truncated value and pass, other
    lanes) go lower buffer position first, as lax.top_k orders them: one
    int64 key per slot, high word the packed value, low word the reversed
    position."""
    width = buf.shape[1]
    pos = torch.arange(width, device=buf.device, dtype=torch.int64)
    key = buf.to(torch.int64) * (1 << 32) + ((1 << 32) - 1 - pos)
    sel, _ = torch.topk(key, k, dim=1, largest=True, sorted=True)
    packed = (sel >> 32).to(torch.int32)
    lane = (((1 << 32) - 1 - (sel & 0xFFFFFFFF)) % db_tile).to(torch.int32)
    jmax = (1 << jbits) - 1
    ids = (jmax - (packed & jmax)) * db_tile + lane
    vals = _ordered_int(packed & ~jmax).view(torch.float32)
    empty = packed == INT32_MIN
    return torch.where(empty, NEG_INF, vals), torch.where(empty, -1, ids)


def packed_plan(
    n: int, k_eff: int, db_tile: int = None, recall_target: float = 0.95
) -> Tuple[int, int, int]:
    """(W, R, query block) of `packed_topk` over n rows at k_eff: the
    reference planner's W and R, and the most queries a launch takes, which
    the [QB, R·W] buffer and its int64 decode keys bound."""
    if db_tile is None:
        db_tile = default_db_tile(k_eff, n, exact=False)
    db_tile, r_slots = plan(
        n, k_eff, db_tile, exact=False, recall_target=recall_target
    )
    max_block = max(32, CANDIDATE_BYTES // (r_slots * db_tile * 12))
    return db_tile, r_slots, max_block


def packed_topk(
    db,
    queries: torch.Tensor,
    k: int,
    metric: str = "cosine",
    db_tile: int = None,
    recall_target: float = 0.95,
    storage: str = "native",
    n_valid: int = None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Approx top-k via the packed segment-top-R kernels (port of
    packed_pallas_topk). Returns (sims [Q, k] descending, ids [Q, k]
    int32) in the internal convention; k > N pads with (-inf, -1). Rows ≥
    n_valid (a shard's pad rows) never enter; W, R and jbits stay those of
    all N rows.

    `db` is a float tensor or an `SQ8Database` (then storage "native"
    means "sq8-sym", or "sq8" for l2). The sym storages score ip / cosine
    only; l2 falls back to the asymmetric "sq8". Native queries and db of
    different dtypes are both promoted (bf16 with fp32 -> fp32)."""
    prequant = isinstance(db, SQ8Database)
    if prequant:
        if storage == "native":
            storage = "sq8-sym" if metric != "l2" else "sq8"
        n = db.n
    else:
        n = db.shape[0]
    q_n = queries.shape[0]
    if q_n == 0:
        return (
            torch.zeros((0, k), dtype=torch.float32, device=queries.device),
            torch.zeros((0, k), dtype=torch.int32, device=queries.device),
        )
    k_eff = min(k, n)
    if storage not in STORAGES:
        raise ValueError(f"unknown storage {storage!r}")
    if storage in SYM_STORAGES and metric == "l2":
        # the query scale enters l2's 2qd − |q|² − |d|² per row, so it is
        # not a rank-neutral factor: l2 keeps the asymmetric kernel
        storage = "sq8"
    db_tile, r_slots, max_block = packed_plan(n, k_eff, db_tile,
                                              recall_target)
    jbits = pass_bits(n, db_tile)
    scales = None
    if storage == "native":
        dtype = torch.promote_types(db.dtype, queries.dtype)
        db = db.to(dtype)
    elif prequant:
        db, scales = db.db_i8, db.scales
    else:
        if db.dtype == torch.int8:
            raise ValueError(
                "storage='sq8' quantises internally; pass the float database"
                " (or an SQ8Database from quantize_database)"
            )
        db, scales = quantize_int8(db.to(torch.float32), reciprocal=True)
    vals_out, ids_out = [], []
    for s in range(0, q_n, max_block):
        block = queries[s : s + max_block]
        qsc = q_lo = None
        if storage == "native":
            block = block.to(dtype)
        elif storage == "sq8":
            block = block.to(torch.bfloat16)
        else:
            block, q_lo, qsc = quantize_queries(block, storage == "sq8-sym2")
        buf = segment_packed_kernel(
            block, db, db_tile, r_slots, metric, storage, scales, q_lo,
            n_valid,
        )
        vals, ids = decode_packed(buf, k_eff, db_tile, jbits)
        if qsc is not None:
            # per-query dequant scale: rank-neutral, folded in after the
            # decode (-inf empty slots stay -inf under a positive scale)
            vals = vals * qsc[:, None]
        vals_out.append(vals)
        ids_out.append(ids)
    return pad_k(torch.cat(vals_out, 0), torch.cat(ids_out, 0), k)
