"""Kernel C: grouped Smith-Waterman scores (csrc/sw_grouped.cu).

Port of knn_for_homology_tpu/ops/align_pallas.py:sw_scores_grouped_pallas.
A CUDA tensor goes to the kernel; a CPU tensor to `sw_scores_grouped_plain`,
a row scan in plain PyTorch with the reference's math: `torch.cummax` for
the horizontal-gap prefix max, float32 state holding exact integers, and
ragged lanes segmented by baked seg·2^17 offsets. Both are bit-identical to
the reference.
"""

import torch

from . import _build
from .align import BLOSUM62, GAP_EXT, GAP_FIRST, MAX_SEGMENTS, NEG

# ragged-lane segment offset of the reference (align_pallas.SEG_BIG): larger
# than any score, and MAX_SEGMENTS·SEG_BIG + score stays below 2^24
SEG_BIG = float(1 << 17)
N_AA = BLOSUM62.shape[0]


def _check(q_codes, t_codes, convention, segments, max_seg_len):
    if convention not in GAP_FIRST:
        raise ValueError(f"unknown convention {convention!r}")
    if q_codes.dim() != 2 or t_codes.dim() != 3:
        raise ValueError("need q_codes [G, Lq] and t_codes [G, K, Lt]")
    if q_codes.shape[0] != t_codes.shape[0]:
        raise ValueError("q_codes and t_codes disagree on G")
    if q_codes.device != t_codes.device:
        raise ValueError("q_codes and t_codes must be on one device")
    if q_codes.dtype.is_floating_point or t_codes.dtype.is_floating_point:
        raise TypeError("residue codes must be integers")
    if not 1 <= segments <= MAX_SEGMENTS:
        raise ValueError(f"segments must be in [1, {MAX_SEGMENTS}]")
    if max_seg_len is not None and max_seg_len < 1:
        raise ValueError("max_seg_len must be ≥ 1")


def sw_scores_grouped_plain(
    q_codes: torch.Tensor,
    t_codes: torch.Tensor,
    convention: str = "blast",
    segments: int = 1,
    max_seg_len: int = None,
) -> torch.Tensor:
    """Plain PyTorch version of the kernel: local-alignment scores [G, K]
    ([G, S, K] for segments > 1). `max_seg_len` only bounded the
    reference's prefix-max sweeps, which is exact whenever it covers the
    longest segment (the planner's contract); this scan is always full."""
    _check(q_codes, t_codes, convention, segments, max_seg_len)
    dev = q_codes.device
    gap_first = GAP_FIRST[convention]
    g_n, lq = q_codes.shape
    _, k_n, lt = t_codes.shape
    blosum = torch.as_tensor(BLOSUM62, device=dev)
    neg = float(NEG)

    t_t = t_codes.transpose(1, 2).to(torch.int64)  # [G, Lt, K]
    t_pad = t_t < 0
    t_safe = t_t.clamp(0, N_AA - 1).reshape(g_n, lt * k_n)
    j_idx = torch.arange(lt, dtype=torch.float32, device=dev)[None, :, None]

    segoff = None
    if segments > 1:
        # inclusive prefix count of knockout columns numbers the segments
        count = torch.cumsum(t_pad.to(torch.float32), dim=1)
        segoff = torch.clamp(count, max=float(MAX_SEGMENTS)) * SEG_BIG
    h = torch.zeros((g_n, lt, k_n), device=dev) if segoff is None else segoff
    f = torch.full((g_n, lt, k_n), neg, device=dev)
    floor = 0.0 if segoff is None else segoff
    best = torch.zeros(
        (g_n, 1, k_n) if segments == 1 else (g_n, lt, k_n), device=dev
    )
    zero_col = torch.zeros((g_n, 1, k_n), device=dev)
    neg_col = torch.full((g_n, 1, k_n), neg, device=dev)

    for row in range(lq):
        qi = q_codes[:, row].to(torch.int64)
        rows = blosum[qi.clamp(0, N_AA - 1)]  # [G, A]
        sub = torch.gather(rows, 1, t_safe).view(g_n, lt, k_n)
        sub = torch.where(t_pad | (qi < 0)[:, None, None], neg, sub)
        diag = torch.cat([zero_col, h[:, :-1]], dim=1)
        f = torch.maximum(h - gap_first, f - GAP_EXT)
        h0 = torch.maximum(torch.maximum(diag + sub, f),
                           torch.as_tensor(floor, device=dev))
        # E[j] = max_{i<j} H0[i] + i·ext − (gap_first − ext) − j·ext
        prefix = torch.cummax(h0 + j_idx * GAP_EXT, dim=1).values
        pshift = torch.cat([neg_col, prefix[:, :-1]], dim=1)
        e = pshift - (gap_first - GAP_EXT) - j_idx * GAP_EXT
        h = torch.maximum(h0, e)
        if segments == 1:
            best = torch.maximum(best, h.amax(dim=1, keepdim=True))
        else:
            best = torch.maximum(best, h)
    if segments == 1:
        return best[:, 0]
    outs = []
    for s_i in range(segments):
        m = segoff == s_i * SEG_BIG
        outs.append(torch.clamp(
            torch.where(m, best, 0.0).amax(dim=1) - s_i * SEG_BIG, min=0.0
        ))
    return torch.stack(outs, dim=1)  # [G, S, K]


def sw_scores_grouped(
    q_codes: torch.Tensor,  # [G, Lq] integer, -1 padding
    t_codes: torch.Tensor,  # [G, K, Lt] integer, -1 padding / separators
    convention: str = "blast",
    segments: int = 1,
    max_seg_len: int = None,
) -> torch.Tensor:
    """Local-alignment scores [G, K] float32 of each group's query against
    its K target lanes; with segments > 1 each lane holds up to `segments`
    targets separated by -1 and the result is [G, S, K] (0 for absent
    segments). Kernel on a CUDA device, plain version on the CPU."""
    _check(q_codes, t_codes, convention, segments, max_seg_len)
    if q_codes.device.type == "cpu":
        return sw_scores_grouped_plain(
            q_codes, t_codes, convention, segments, max_seg_len
        )
    if q_codes.device.type != "cuda":
        raise ValueError(f"unsupported device {q_codes.device}")
    dev = q_codes.device
    g_n, lq = q_codes.shape
    _, k_n, lt = t_codes.shape
    out = torch.empty((g_n, segments, k_n), dtype=torch.float32, device=dev)
    if g_n == 0 or k_n == 0:
        return out[:, 0] if segments == 1 else out
    if lq == 0 or lt == 0:
        out.zero_()
        return out[:, 0] if segments == 1 else out
    # codes outside the alphabet clip to its last letter and negatives are
    # pads (as in the reference); the kernel does both itself, so int8
    # target codes in [G, K, Lt] (align_hits builds them so) go as they are
    q = q_codes.clamp(-1, N_AA - 1).to(torch.int32).contiguous()
    t = (t_codes if t_codes.dtype == torch.int8
         else t_codes.clamp(-1, N_AA - 1).to(torch.int8)).contiguous()
    blosum = torch.as_tensor(BLOSUM62, device=dev).to(torch.int32).contiguous()
    lib = _build.library()
    warps = lib.knn_sw_grouped_warps(g_n, k_n)
    if warps < 1:
        raise RuntimeError("knn_sw_grouped_warps: the card cannot be queried")
    bound = torch.empty((warps, lt, 2), dtype=torch.int32, device=dev)
    live = torch.empty((g_n * k_n, 2), dtype=torch.int32, device=dev)
    counters = torch.zeros(2, dtype=torch.int32, device=dev)
    code = lib.knn_sw_grouped(
        q.data_ptr(), t.data_ptr(), blosum.data_ptr(), bound.data_ptr(),
        live.data_ptr(), counters.data_ptr(), out.data_ptr(), g_n, lq, lt,
        k_n, segments, int(GAP_FIRST[convention]), int(GAP_EXT),
        _build.stream_ptr(dev),
    )
    _build.check(code, "knn_sw_grouped")
    sw_scores_grouped.launches += 1
    return out[:, 0] if segments == 1 else out


sw_scores_grouped.launches = 0
