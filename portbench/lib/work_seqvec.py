"""Operations and bytes of SeqVec's work, from shapes and the program's
counts alone (lib/work.py's frozen formulas, for the bi-LSTM encoder).
Frozen: encoder_mfu.seqvec and lstm_roofline.seqvec divide these by
measured device time.
"""

from .peaks import bound_s
from .work import BF16


def lstm_scan_params(cfg: dict) -> int:
    """Weights one LSTMP step multiplies a position by: the input and the
    recurrent kernels (proj x 4·cells each) and the projection (cells x
    proj). The character CNN is a table evaluated once an encode, not
    counted."""
    proj, cells = cfg["proj_dim"], cfg["lstm_dim"]
    return 2 * proj * 4 * cells + cells * proj


def seqvec_model_flops(residues: int, cfg: dict) -> float:
    """Model FLOPs of encoding this many real residues: two FLOPs a weight
    of every LSTMP scan, 2 directions x n_lstm_layers scans a residue
    (37.7 M a scan at SeqVec's widths)."""
    scans = 2 * cfg["n_lstm_layers"]
    return float(residues * scans * 2 * lstm_scan_params(cfg))


def lstm_launch_bound_s(rows: int, residues: int, cfg: dict) -> float:
    """One launch of kernel M (one layer, both directions) over a batch of
    `rows` proteins holding `residues` real residues, each wrapped in <S>
    and </S>: the recurrent products, 2 directions x (residues + 2·rows)
    positions x 2·(proj·4·cells + cells·proj) operations, at the bf16
    peak; the bytes, both directions' recurrent weights once, the
    positions' bf16 x·W_x in and h out once, at the memory rate."""
    proj, cells = cfg["proj_dim"], cfg["lstm_dim"]
    positions = residues + 2 * rows
    recurrent = proj * 4 * cells + cells * proj
    ops = 2 * positions * 2 * recurrent
    nbytes = BF16 * (2 * recurrent + 2 * positions * (4 * cells + proj))
    return bound_s(ops, "bf16", nbytes)
