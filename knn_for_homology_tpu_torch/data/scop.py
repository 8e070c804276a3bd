"""SCOP2 preprocessing — classification parsing + per-domain embedding cuts.

Parity with the reference (reference: seqvec_search/scop_preprocessing.py):
SCOPCLA parsing into TP/CL/CF/SF/FA levels, UniProt bulk sequence fetches,
and cutting per-domain embeddings (including non-contiguous domains) from
per-residue arrays with mean-pooling of the LSTM1 slice [:, 1024:2048].
"""

from pathlib import Path
from typing import Dict, List, Sequence, Tuple
from urllib.request import urlopen, urlretrieve

import numpy as np

SCOP_CLA_URL = "https://scop.mrc-lmb.cam.ac.uk/files/scop-cla-latest.txt"


def download_scop_classification(target: Path) -> Path:
    target.parent.mkdir(parents=True, exist_ok=True)
    if not target.is_file():
        urlretrieve(SCOP_CLA_URL, target)
    return target


def parse_scop_cla(cla_file: Path) -> List[Dict[str, str]]:
    """SCOPCLA rows → dicts with uniprot id, residue ranges, and the
    TP/CL/CF/SF/FA classification levels
    (reference: scop_preprocessing.py:26-49)."""
    entries = []
    with open(cla_file) as fp:
        for line in fp:
            if line.startswith("#") or not line.strip():
                continue
            cols = line.split()
            # FA-DOMID FA-PDBID FA-PDBREG FA-UNIID FA-UNIREG SF-DOMID
            # SF-PDBID SF-PDBREG SF-UNIID SF-UNIREG SCOPCLA
            scopcla = dict(
                part.split("=") for part in cols[10].split(",")
            )
            entries.append(
                {
                    "uniprot": cols[3],
                    "ranges": cols[4],
                    **scopcla,  # TP, CL, CF, SF, FA
                }
            )
    return entries


def parse_ranges(ranges: str) -> List[Tuple[int, int]]:
    """'12-100' or '12-100,150-200' (non-contiguous domains) → 1-based
    inclusive pairs (reference: scop_preprocessing.py:86-106)."""
    out = []
    for part in ranges.split(","):
        start, stop = part.split("-")
        out.append((int(start), int(stop)))
    return out


def cut_domain_embedding(
    per_residue: np.ndarray,
    ranges: Sequence[Tuple[int, int]],
    lstm1_slice: Tuple[int, int] = (1024, 2048),
) -> np.ndarray:
    """Mean-pool the (possibly non-contiguous) domain residues of the LSTM1
    feature slice (reference: scop_preprocessing.py:86-106)."""
    pieces = [per_residue[start - 1 : stop] for start, stop in ranges]
    stacked = np.concatenate(pieces, axis=0)
    return stacked[:, lstm1_slice[0] : lstm1_slice[1]].mean(axis=0)


def fetch_uniprot_sequences(
    accessions: Sequence[str], batch: int = 200
) -> Dict[str, str]:
    """Bulk-fetch sequences from UniProt (reference:
    scop_preprocessing.py:72-82). Network-gated; callers cache the result."""
    from ..data.fasta import iter_fasta
    import io
    import tempfile

    sequences: Dict[str, str] = {}
    for start in range(0, len(accessions), batch):
        chunk = accessions[start : start + batch]
        url = (
            "https://rest.uniprot.org/uniprotkb/stream?format=fasta&query="
            + "+OR+".join(f"accession:{a}" for a in chunk)
        )
        with urlopen(url) as fp:
            text = fp.read().decode()
        with tempfile.NamedTemporaryFile("w", suffix=".fasta", delete=False) as tmp:
            tmp.write(text)
            path = tmp.name
        for header, seq in iter_fasta(Path(path)):
            accession = header.split("|")[1] if "|" in header else header
            sequences[accession] = seq
    return sequences
