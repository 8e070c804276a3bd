"""Plain nearest-neighbour search: exact cosine top-k in float64, symmetric
per-row integer quantisation, and the exact top-k under quantised scores.
Imports nothing of the program.
"""

import torch


def normalized64(x: torch.Tensor) -> torch.Tensor:
    x = x.to(torch.float64)
    norm = x.norm(dim=1, keepdim=True)
    return x / torch.where(norm > 0, norm, torch.ones_like(norm))


def tf32_round(x: torch.Tensor) -> torch.Tensor:
    """float32 values rounded to TF32's 10-bit mantissa (nearest, ties
    away), as the tensor cores round a TF32 product's operands."""
    bits = x.to(torch.float32).contiguous().view(torch.int32)
    bits = (bits + (1 << 12)) & ~((1 << 13) - 1)
    return bits.view(torch.float32)


def cosine_scores(queries, rows, ids=None, block=512) -> torch.Tensor:
    """[Q, N] float64 cosines of each query with every row, or [Q, k] with
    the rows `ids` [Q, k] names (ids < 0 or out of range give -inf)."""
    q = normalized64(queries)
    db = normalized64(rows)
    if ids is None:
        return torch.cat([q[i:i + block] @ db.T
                          for i in range(0, q.shape[0], block)])
    ids = torch.as_tensor(ids, device=q.device).long()
    ok = (ids >= 0) & (ids < db.shape[0])
    picked = db[ids.clamp(0, db.shape[0] - 1)]  # [Q, k, d]
    out = torch.einsum("qkd,qd->qk", picked, q)
    return torch.where(ok, out, torch.full_like(out, float("-inf")))


def unique_or_neginf(ids, scores: torch.Tensor) -> torch.Tensor:
    """scores with every repeat of an id in its row after the first set to
    -inf: a list of hits that names a row twice has one hit fewer."""
    ids = torch.as_tensor(ids, device=scores.device).long()
    order = torch.sort(ids, dim=1, stable=True)
    dup = torch.zeros_like(ids, dtype=torch.bool)
    dup_sorted = torch.zeros_like(ids, dtype=torch.bool)
    dup_sorted[:, 1:] = order.values[:, 1:] == order.values[:, :-1]
    dup.scatter_(1, order.indices, dup_sorted)
    return torch.where(dup, torch.full_like(scores, float("-inf")), scores)


def hit_gap(queries, rows, ids, k: int) -> float:
    """Widest gap by which a returned hit's cosine lies below the exact
    top-k's at its rank: rank r of the returned ids, sorted by their exact
    cosine, against the exact r-th best (float64). Ties of any order read
    0; a missing, repeated or out-of-range id reads as -inf."""
    exact = cosine_scores(queries, rows).topk(k, dim=1).values
    got = unique_or_neginf(ids, cosine_scores(queries, rows, ids))
    got = got.sort(dim=1, descending=True).values
    return float((exact - got).max())


def hit_err(queries, rows, ids, scores, k: int) -> float:
    """The wider of hit_gap and the widest distance of a returned score
    from its hit's exact float64 cosine: the ids and their scores, both as
    returned (a missing or out-of-range id reads as inf)."""
    exact = cosine_scores(queries, rows, ids)
    scores = torch.as_tensor(scores, dtype=torch.float64, device=exact.device)
    off = float((scores - exact).abs().max())
    return max(hit_gap(queries, rows, ids, k), off)


def quantize(x: torch.Tensor, levels: int):
    """Symmetric per-row quantisation to integers in [-levels, levels]:
    scale = max|row| / levels, codes rounded half to even. Returns (codes
    as float64, scales float64)."""
    x = x.to(torch.float64)
    scale = (x.abs().amax(dim=1, keepdim=True).clamp(min=1e-30)
             .to(torch.float32).to(torch.float64) / levels)
    codes = torch.clamp(torch.round(x / scale), -levels, levels)
    return codes, scale[:, 0]


def quantized_scores(q_codes, q_scale, db_codes, db_scale, ids=None,
                     block=256) -> torch.Tensor:
    """Dequantised products (integer dot x both scales, float64) of each
    query with every row, or with the rows `ids` names (-inf where none)."""
    if ids is None:
        out = torch.cat([q_codes[i:i + block] @ db_codes.T
                         for i in range(0, q_codes.shape[0], block)])
        return out * q_scale[:, None] * db_scale[None, :]
    ids = torch.as_tensor(ids, device=q_codes.device).long()
    ok = (ids >= 0) & (ids < db_codes.shape[0])
    safe = ids.clamp(0, db_codes.shape[0] - 1)
    step = max(1, block // 2)
    out = torch.cat([
        torch.einsum("qkd,qd->qk", db_codes[safe[i:i + step]],
                     q_codes[i:i + step])
        for i in range(0, ids.shape[0], step)])
    out = out * q_scale[:, None] * db_scale[safe]
    return torch.where(ok, out, torch.full_like(out, float("-inf")))


def quantized_topk(queries, rows, k: int, levels: int):
    """The exact top-k under `levels` quantisation of rows and queries:
    (scores [Q, k] float64 descending, ids [Q, k])."""
    qc, qs = quantize(queries, levels)
    dc, ds = quantize(rows, levels)
    return quantized_scores(qc, qs, dc, ds).topk(k, dim=1)
