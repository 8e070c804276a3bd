"""Kernel J: the indirect sq8-sym union scan of the IVF index (the `kInd`
variant of csrc/segment_packed.cu). Port of
knn_for_homology_tpu/ops/ivf_pallas.py.

The index scans the union of the cells a query block probes without
gathering it: `cells` [budget] lists the cells, and column c of the virtual
database is row c % 128 of cell cells[c // 128] of the packed slab table
(ops/slab_cuda.py layout). Scoring and selection are kernel F's sq8-sym /
sym2 path with that row indirection and capacity padding (packed id -1)
masked: the queries are quantised to int8 (sym2 adds the residual pass),
each of the W = e·128 lanes keeps its R best packed candidates, and the
decode picks the top k. A CUDA tensor goes to the kernel, a CPU tensor to
`segment_packed_indirect_plain`.
"""

from typing import Tuple

import torch

from . import _build
from .exact_cuda import CANDIDATE_BYTES, plan
from .packed_cuda import (
    _packed_sims,
    decode_packed,
    pack_lanes,
    pass_bits,
    quantize_queries,
)
from .slab_cuda import LANE
from .topk import NEG_INF

# slabs per insert pass: the lane width W = e·128 and the pass index, and
# so which truncated-value ties break which way, follow from it
SLABS_PER_STEP = 8

# bound on the plain version's [chunk, budget·128] fp32 similarity block
_PLAIN_BYTES = 1 << 30


def _check(q8, q_lo, pv, sc, pi, cells, tile, r_slots):
    tensors = [q8, pv, sc, pi, cells] + ([q_lo] if q_lo is not None else [])
    if any(t.device != pv.device for t in tensors):
        raise ValueError("all operands must be on one device")
    if pv.dtype != torch.int8 or q8.dtype != torch.int8 or (
        q_lo is not None and (q_lo.dtype != torch.int8 or q_lo.shape != q8.shape)
    ):
        raise TypeError("need int8 slabs, queries and residuals")
    if sc.dtype != torch.float32 or pi.dtype != torch.int32 or (
        cells.dtype != torch.int32
    ):
        raise TypeError("need f32 scales, int32 ids and int32 cells")
    c = pi.shape[0]
    if pv.shape[0] != c * LANE or sc.shape != (c, LANE) or pi.shape != (
        c, LANE
    ) or q8.dim() != 2 or q8.shape[1] != pv.shape[1] or cells.dim() != 1:
        raise ValueError("operands do not match one slab table")
    if tile % LANE or (cells.shape[0] * LANE) % tile or r_slots < 1:
        raise ValueError(f"need W % 128 == 0 dividing budget·128, R ≥ 1;"
                         f" got W={tile}, budget={cells.shape[0]}, R={r_slots}")


def segment_packed_indirect_plain(
    q8: torch.Tensor, pv: torch.Tensor, sc: torch.Tensor, pi: torch.Tensor,
    cells: torch.Tensor, tile: int, r_slots: int, q_lo: torch.Tensor = None,
) -> torch.Tensor:
    """Plain PyTorch version of kernel J: the same [Q, R·W] packed buffer,
    from the selected cells' rows gathered and scored as kernel F's plain
    version scores them."""
    c, d = pi.shape[0], pv.shape[1]
    idx = cells.long()
    rows = pv.view(c, LANE, d)[idx].reshape(-1, d)
    scales = sc[idx].reshape(-1)
    valid = pi[idx].reshape(-1) >= 0
    n = rows.shape[0]
    jbits = pass_bits(n, tile)
    storage = "sq8-sym" if q_lo is None else "sq8-sym2"
    chunk = max(1, _PLAIN_BYTES // (4 * n))
    parts = []
    for s in range(0, q8.shape[0], chunk):
        lo = None if q_lo is None else q_lo[s : s + chunk]
        sims = _packed_sims(q8[s : s + chunk], rows, "ip", storage, scales, lo)
        parts.append(pack_lanes(sims, tile, r_slots, jbits, valid))
    if not parts:
        return torch.empty((0, r_slots * tile), dtype=torch.int32,
                           device=pv.device)
    return torch.cat(parts, 0)


def segment_packed_indirect_kernel(
    q8: torch.Tensor,  # [Q, d] int8 queries
    pv: torch.Tensor,  # [C*128, d] int8 slabs
    sc: torch.Tensor,  # [C, 128] f32 scales
    pi: torch.Tensor,  # [C, 128] int32 ids, -1 padding
    cells: torch.Tensor,  # [budget] int32 cell ids in [0, C)
    tile: int,
    r_slots: int,
    q_lo: torch.Tensor = None,  # [Q, d] int8 residuals: sym2
) -> torch.Tensor:
    """Per-lane top-R packed buffer [Q, R·W] int32 of the virtual union
    (slot r of lane w at column r·W + w, empty slots INT32_MIN)."""
    _check(q8, q_lo, pv, sc, pi, cells, tile, r_slots)
    if pv.device.type == "cpu":
        return segment_packed_indirect_plain(q8, pv, sc, pi, cells, tile,
                                             r_slots, q_lo)
    q_n, d = q8.shape
    if d % 16:
        raise ValueError(f"kernel J reads rows of whole 16 bytes; d = {d}"
                         " (the slab table pads rows to 128)")
    budget = cells.shape[0]
    q8 = q8.contiguous()
    q_lo = None if q_lo is None else q_lo.contiguous()
    buf = torch.empty((q_n, r_slots * tile), dtype=torch.int32,
                      device=pv.device)
    if q_n == 0:
        return buf
    code = _build.library().knn_ivf_indirect(
        q8.data_ptr(), None if q_lo is None else q_lo.data_ptr(),
        pv.data_ptr(), sc.data_ptr(), pi.data_ptr(), cells.data_ptr(),
        buf.data_ptr(), q_n, budget, pv.shape[0], d, tile, r_slots,
        pass_bits(budget * LANE, tile), int(q_lo is not None),
        _build.stream_ptr(pv.device),
    )
    _build.check(code, "knn_ivf_indirect")
    segment_packed_indirect_kernel.launches += 1
    return buf


segment_packed_indirect_kernel.launches = 0


def union_plan(budget: int, k: int, recall_target: float):
    """(W, R, k_eff) of a union scan over `budget` cells: e = min(8,
    budget) slabs per pass, W = e·128 lanes, R from the recall target grown
    until R·W ≥ k (the reference's approx `_plan`)."""
    e = min(SLABS_PER_STEP, budget)
    # budgets are powers of two (search/ivf.py rounds them), so e divides
    if budget % e:
        raise ValueError(f"budget {budget} is not a multiple of {e}")
    n_rows = budget * LANE
    k_eff = min(k, n_rows)
    tile, r_slots = plan(n_rows, k_eff, e * LANE, exact=False,
                         recall_target=recall_target)
    return tile, r_slots, k_eff


def ivf_union_topk(
    pv: torch.Tensor,  # [C*128, d] int8 packed slabs (lane-padded d)
    sc: torch.Tensor,  # [C, 128] f32 per-row dequant scales
    pi: torch.Tensor,  # [C, 128] int32 global ids (-1 padding)
    cells: torch.Tensor,  # [budget] int32 DISTINCT cell ids to scan
    queries: torch.Tensor,  # [Q, d_orig] f32
    k: int,
    recall_target: float = 0.995,
    compute: str = "sym",
    reciprocal: bool = False,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """→ (vals [Q, k] f32 desc, pos [Q, k] int32, ids [Q, k] int32).

    `pos` indexes the virtual slab-ordered buffer (cell slot pos // 128 of
    `cells`, lane pos % 128); empty slots carry (-inf, -1, -1). `compute`
    "sym" is one int8 pass, "sym2" adds the residual query pass.
    `reciprocal` is the query quantisation's form: the reference's index
    calls this inside its jitted scan (True); a direct call is eager
    (False)."""
    if compute not in ("sym", "sym2"):
        raise ValueError(f"unknown compute {compute!r}")
    d = pv.shape[1]
    budget = cells.shape[0]
    tile, r_slots, k_eff = union_plan(budget, k, recall_target)
    n_rows = budget * LANE
    jbits = pass_bits(n_rows, tile)
    q32 = queries.to(torch.float32)
    if q32.shape[1] != d:  # slabs are lane-padded at pack time
        q32 = torch.nn.functional.pad(q32, (0, d - q32.shape[1]))
    q8, q_lo, qsc = quantize_queries(q32, compute == "sym2", reciprocal)
    cells = cells.to(torch.int32).contiguous()
    # the [QB, R·W] buffer and its int64 decode keys bound the query block
    max_block = max(32, CANDIDATE_BYTES // (r_slots * tile * 12))
    vals_out, pos_out = [], []
    for s in range(0, q8.shape[0], max_block):
        lo = None if q_lo is None else q_lo[s : s + max_block]
        buf = segment_packed_indirect_kernel(
            q8[s : s + max_block], pv, sc, pi, cells, tile, r_slots, lo
        )
        vals, pos = decode_packed(buf, k_eff, tile, jbits)
        vals_out.append(vals)
        pos_out.append(pos)
    vals = torch.cat(vals_out, 0) * qsc[:, None]
    pos = torch.cat(pos_out, 0)
    safe = pos.clamp(0, n_rows - 1).long()
    ids = pi[cells.long()[safe // LANE], safe % LANE]
    ids = torch.where(pos >= 0, ids, -1)
    if k_eff < k:
        pad = k - k_eff
        vals = torch.nn.functional.pad(vals, (0, pad), value=NEG_INF)
        pos = torch.nn.functional.pad(pos, (0, pad), value=-1)
        ids = torch.nn.functional.pad(ids, (0, pad), value=-1)
    return vals, pos, ids
