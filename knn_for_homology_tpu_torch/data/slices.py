"""Long-protein slicing — overlapping windows searched independently.

Parity with the reference's slices subsystem (reference:
pfam/slices/slices_shared.py:8-9, make_slices.py:17-29): 600-residue
windows with 200 overlap (stride 400); proteins shorter than 200 still get
one slice; slice ids are `<protein>-<start>`.
"""

from pathlib import Path
from typing import Dict, Iterator, List, Tuple

from ..config import SLICE_OVERLAP, SLICE_SIZE
from .fasta import iter_fasta


def slice_sequence(
    sequence: str,
    slice_len: int = SLICE_SIZE,
    overlap: int = SLICE_OVERLAP,
) -> Iterator[Tuple[int, str]]:
    """(start, window) pairs; max(200, len-overlap) keeps short proteins
    (reference: make_slices.py:22-28)."""
    for start in range(0, max(200, len(sequence) - overlap), slice_len - overlap):
        yield start, sequence[start : start + slice_len]


def make_slices(
    full_sequences_fasta: Path,
    slices_fasta: Path,
    slice_len: int = SLICE_SIZE,
    overlap: int = SLICE_OVERLAP,
) -> int:
    """Write the slices fasta; returns the slice count."""
    counter = 0
    with open(slices_fasta, "w") as fp:
        for header, sequence in iter_fasta(full_sequences_fasta):
            parts = header.split(" ")
            sequence_id = parts[1] if len(parts) > 1 else parts[0]
            for start, window in slice_sequence(sequence, slice_len, overlap):
                fp.write(f">{sequence_id}-{start}\n{window}\n")
                counter += 1
    return counter


def slice_id_to_protein(slice_id: str) -> Tuple[str, int]:
    """'<protein>-<start>' → (protein, start)."""
    protein, start = slice_id.rsplit("-", 1)
    return protein, int(start)


def slices_per_protein(slice_ids: List[str]) -> Dict[str, List[int]]:
    """protein → row indices of its slices (for assembly)."""
    out: Dict[str, List[int]] = {}
    for row, sid in enumerate(slice_ids):
        protein, _ = slice_id_to_protein(sid)
        out.setdefault(protein, []).append(row)
    return out


def main(argv=None):
    """CLI parity with `python -m pfam.slices.make_slices`
    (reference: pfam/slices/make_slices.py:17-29)."""
    import argparse

    parser = argparse.ArgumentParser()
    parser.add_argument("full_sequences_fasta", type=Path)
    parser.add_argument("slices_fasta", type=Path)
    parser.add_argument("--slice-len", type=int, default=SLICE_SIZE)
    parser.add_argument("--overlap", type=int, default=SLICE_OVERLAP)
    args = parser.parse_args(argv)
    count = make_slices(
        args.full_sequences_fasta, args.slices_fasta, args.slice_len, args.overlap
    )
    print(f"Made {count} slices")


if __name__ == "__main__":
    main()
