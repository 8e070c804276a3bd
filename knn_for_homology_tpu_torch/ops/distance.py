"""Distance primitives (port of knn_for_homology_tpu/ops/distance.py).

Conventions (FAISS-compatible, as in the reference):
  * "cosine" — inner products of L2-normalised rows, descending;
  * "ip"     — raw inner product, descending;
  * "l2"     — squared L2 distance, ascending.
Internally everything is "bigger is better": l2 similarities are negated
squared distances, 2·q·d − |q|² − |d|².

fp32 products stay fp32: the package turns TF32 off at import.
"""

import torch

METRICS = ("cosine", "ip", "l2")


def pad_rows(x: torch.Tensor, multiple: int) -> torch.Tensor:
    """Zero-pad dim 0 up to a multiple."""
    rem = (-x.shape[0]) % multiple
    if rem == 0:
        return x
    return torch.cat([x, x.new_zeros((rem,) + tuple(x.shape[1:]))], dim=0)


def l2_normalize(x: torch.Tensor, eps: float = 0.0) -> torch.Tensor:
    """Row-wise L2 normalisation; zero rows are left untouched (no NaNs),
    like faiss.normalize_L2."""
    norm = torch.sqrt(torch.sum(x * x, dim=-1, keepdim=True))
    safe = torch.where(norm > eps, norm, torch.ones_like(norm))
    return x / safe


def similarity_block(
    queries: torch.Tensor,
    db_block: torch.Tensor,
    metric: str,
    q_sq: torch.Tensor = None,
) -> torch.Tensor:
    """[Q, B] similarity of queries against one database block (cosine
    inputs must already be normalised)."""
    if metric not in METRICS:
        raise ValueError(f"unknown metric {metric!r}")
    dots = queries @ db_block.T
    if metric == "l2":
        if q_sq is None:
            q_sq = torch.sum(queries * queries, dim=-1)
        d_sq = torch.sum(db_block * db_block, dim=-1)
        return 2.0 * dots - q_sq[:, None] - d_sq[None, :]
    return dots


def check_search_inputs(db: torch.Tensor, queries: torch.Tensor, metric: str):
    """What the search kernels take: float32 db [N, d] and queries [Q, d]
    on one device, a known metric. Raises otherwise."""
    if metric not in METRICS:
        raise ValueError(f"unknown metric {metric!r}")
    if db.dim() != 2 or queries.dim() != 2 or db.shape[1] != queries.shape[1]:
        raise ValueError(
            f"need db [N, d] and queries [Q, d], got {tuple(db.shape)}"
            f" and {tuple(queries.shape)}"
        )
    if db.device != queries.device:
        raise ValueError("db and queries must be on one device")
    if db.dtype != torch.float32 or queries.dtype != torch.float32:
        raise TypeError("the kernels take float32 db and queries")
    if db.device.type not in ("cpu", "cuda"):
        raise ValueError(f"unsupported device {db.device}")
    if db.device.type == "cuda" and not (
        db.is_contiguous() and queries.is_contiguous()
    ):
        raise ValueError("the kernels take contiguous db and queries")


def finalize_scores(sims: torch.Tensor, metric: str) -> torch.Tensor:
    """Internal similarities back to FAISS-convention scores."""
    return -sims if metric == "l2" else sims
