"""Plain Smith-Waterman local alignment scores and Karlin-Altschul
E-values, for pairs of protein strings. Imports nothing of the program.

Scoring: BLOSUM62 (NCBI), affine gaps as MMseqs2's alignment charges them:
a gap of length n costs 11 + (n - 1). Gotoh's recurrences, one query row
at a time over all pairs at once, vectorised over the target columns; the
horizontal gap of a row is a running maximum (an opening cost of at least
one extension makes H before it the same as H after it there).

`cap` saturates every DP value at that score, as 8-bit SIMD aligners do
before they recompute: the control runs with cap 127.
"""

import numpy as np
import torch

ALPHABET = "ARNDCQEGHILKMFPSTWYVBZX*"
_BLOSUM62 = """
 4 -1 -2 -2  0 -1 -1  0 -2 -1 -1 -1 -1 -2 -1  1  0 -3 -2  0 -2 -1  0 -4
-1  5  0 -2 -3  1  0 -2  0 -3 -2  2 -1 -3 -2 -1 -1 -3 -2 -3 -1  0 -1 -4
-2  0  6  1 -3  0  0  0  1 -3 -3  0 -2 -3 -2  1  0 -4 -2 -3  3  0 -1 -4
-2 -2  1  6 -3  0  2 -1 -1 -3 -4 -1 -3 -3 -1  0 -1 -4 -3 -3  4  1 -1 -4
 0 -3 -3 -3  9 -3 -4 -3 -3 -1 -1 -3 -1 -2 -3 -1 -1 -2 -2 -1 -3 -3 -2 -4
-1  1  0  0 -3  5  2 -2  0 -3 -2  1  0 -3 -1  0 -1 -2 -1 -2  0  3 -1 -4
-1  0  0  2 -4  2  5 -2  0 -3 -3  1 -2 -3 -1  0 -1 -3 -2 -2  1  4 -1 -4
 0 -2  0 -1 -3 -2 -2  6 -2 -4 -4 -2 -3 -3 -2  0 -2 -2 -3 -3 -1 -2 -1 -4
-2  0  1 -1 -3  0  0 -2  8 -3 -3 -1 -2 -1 -2 -1 -2 -2  2 -3  0  0 -1 -4
-1 -3 -3 -3 -1 -3 -3 -4 -3  4  2 -3  1  0 -3 -2 -1 -3 -1  3 -3 -3 -1 -4
-1 -2 -3 -4 -1 -2 -3 -4 -3  2  4 -2  2  0 -3 -2 -1 -2 -1  1 -4 -3 -1 -4
-1  2  0 -1 -3  1  1 -2 -1 -3 -2  5 -1 -3 -1  0 -1 -3 -2 -2  0  1 -1 -4
-1 -1 -2 -3 -1  0 -2 -3 -2  1  2 -1  5  0 -2 -1 -1 -1 -1  1 -3 -1 -1 -4
-2 -3 -3 -3 -2 -3 -3 -3 -1  0  0 -3  0  6 -4 -2 -2  1  3 -1 -3 -3 -1 -4
-1 -2 -2 -1 -3 -1 -1 -2 -2 -3 -3 -1 -2 -4  7 -1 -1 -4 -3 -2 -2 -1 -2 -4
 1 -1  1  0 -1  0  0  0 -1 -2 -2  0 -1 -2 -1  4  1 -3 -2 -2  0  0  0 -4
 0 -1  0 -1 -1 -1 -1 -2 -2 -1 -1 -1 -1 -2 -1  1  5 -2 -2  0 -1 -1  0 -4
-3 -3 -4 -4 -2 -2 -3 -2 -2 -3 -2 -3 -1  1 -4 -3 -2 11  2 -3 -4 -3 -2 -4
-2 -2 -2 -3 -2 -1 -2 -3  2 -1 -1 -2 -1  3 -3 -2 -2  2  7 -1 -3 -2 -1 -4
 0 -3 -3 -3 -1 -2 -2 -3 -3  3  1 -2  1 -1 -2 -2  0 -3 -1  4 -3 -2 -1 -4
-2 -1  3  4 -3  0  1 -1  0 -3 -4  0 -3 -3 -2  0 -1 -4 -3 -3  4  1 -1 -4
-1  0  0  1 -3  3  4 -2  0 -3 -3  1 -1 -3 -1  0 -1 -3 -2 -2  1  4 -1 -4
 0 -1 -1 -1 -2 -1 -1 -1 -1 -1 -1 -1 -1 -1 -2  0  0 -2 -1 -1 -1 -1 -1 -4
-4 -4 -4 -4 -4 -4 -4 -4 -4 -4 -4 -4 -4 -4 -4 -4 -4 -4 -4 -4 -4 -4 -4  1
"""
BLOSUM62 = np.asarray([[int(v) for v in row.split()]
                       for row in _BLOSUM62.strip().split("\n")], np.int32)
GAP_OPEN = 11  # the first column of a gap
GAP_EXTEND = 1  # each further column
# Karlin-Altschul gapped parameters of BLOSUM62 with gaps 11/1 (NCBI BLAST)
KA_LAMBDA = 0.267
KA_K = 0.041
NEG = -(1 << 28)

_LUT = np.full(256, ALPHABET.index("X"), np.int64)
for _i, _aa in enumerate(ALPHABET):
    _LUT[ord(_aa)] = _i


def codes(seqs, device) -> torch.Tensor:
    """[P, max len] alphabet indices, -1 past each sequence's end."""
    width = max(1, max(len(s) for s in seqs))
    out = np.full((len(seqs), width), -1, np.int64)
    for i, s in enumerate(seqs):
        out[i, :len(s)] = _LUT[np.frombuffer(s.encode(), np.uint8)]
    return torch.from_numpy(out).to(device)


@torch.no_grad()
def scores(queries, targets, device, cap=None) -> np.ndarray:
    """[P] int64 local alignment score of each (query, target) pair."""
    if not queries:
        return np.zeros(0, np.int64)
    q, t = codes(queries, device), codes(targets, device)
    blosum = torch.as_tensor(BLOSUM62, device=device, dtype=torch.int32)
    pairs, width = t.shape
    t_pad = t < 0
    t_safe = t.clamp(min=0)
    cols = torch.arange(width + 1, device=device, dtype=torch.int32)
    h = torch.zeros((pairs, width + 1), dtype=torch.int32, device=device)
    e = torch.full((pairs, width), NEG, dtype=torch.int32, device=device)
    best = torch.zeros(pairs, dtype=torch.int32, device=device)
    zero = torch.zeros((pairs, 1), dtype=torch.int32, device=device)
    for i in range(q.shape[1]):
        qi = q[:, i]
        sub = torch.gather(blosum[qi.clamp(min=0)], 1, t_safe)
        sub = torch.where(t_pad | (qi < 0)[:, None], NEG, sub)
        # vertical gap: from the row above, same column
        e = torch.maximum(h[:, 1:] - GAP_OPEN, e - GAP_EXTEND)
        h0 = torch.clamp(torch.maximum(h[:, :-1] + sub, e), min=0)
        # horizontal gap into column j from any j' < j of this row
        run = torch.cummax(torch.cat([zero, h0], 1) + cols * GAP_EXTEND,
                           dim=1).values
        f = run[:, :-1] - GAP_OPEN - (cols[1:] - 1) * GAP_EXTEND
        row = torch.maximum(h0, f)
        if cap is not None:
            row = row.clamp(max=cap)
            e = e.clamp(max=cap)
        h = torch.cat([zero, row], 1)
        best = torch.maximum(best, row.amax(dim=1))
    return best.long().cpu().numpy()


def e_values(scores_, query_lengths, db_residues: float) -> np.ndarray:
    """Karlin-Altschul E = K·m·n·exp(-λS) for true query length m and the
    database's residues n, in float32 arithmetic as the search reports it."""
    s = np.asarray(scores_, np.float32)
    m = np.maximum(np.asarray(query_lengths, np.float32), np.float32(1))
    return (np.float32(KA_K) * m * np.float32(db_residues)
            * np.exp(np.float32(-KA_LAMBDA) * s)).astype(np.float32)
