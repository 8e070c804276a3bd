"""FASTA reading/writing.

Behavioural contract matches the reference's parser
(reference: seqvec_search/utils.py:65-86): ordered dict of id→sequence,
optional header-rename callable, multi-line sequence bodies concatenated.
"""

from pathlib import Path
from typing import Callable, Dict, Iterator, Tuple, TypeVar

T = TypeVar("T")


def iter_fasta(source: Path) -> Iterator[Tuple[str, str]]:
    """Stream (header, sequence) pairs without holding the file in memory."""
    header = None
    chunks = []
    with open(source) as fp:
        for line in fp:
            if line.startswith(">"):
                if header is not None:
                    yield header, "".join(chunks)
                header = line[1:].strip()
                chunks = []
            else:
                chunks.append(line.strip())
    if header is not None:
        yield header, "".join(chunks)


def read_fasta(
    source: Path, rename: Callable[[str], T] = lambda x: x
) -> Dict[T, str]:
    return {rename(h): s for h, s in iter_fasta(source)}


def write_fasta(target: Path, data: Dict[str, str]) -> None:
    with open(target, "w") as fp:
        for name, sequence in data.items():
            fp.write(f">{name}\n{sequence}\n")
