"""Pfam metadata: domain ranges, protein→domain maps, homology ground truth.

Parity with the reference (reference: pfam/pfam_shared.py:25-53,
pfam/proteins_shared.py:76-136): Pfam-A / pfamseq downloads, `>ID/start-stop`
header parsing, Pfam-A header regex parsing with caching, and the
shared-domain-family closure defining which proteins count as homologs.
"""

import json
import re
from collections import defaultdict
from itertools import chain
from pathlib import Path
from typing import Dict, List, Set, Tuple

from .fasta import iter_fasta

PFAM_RELEASE = "Pfam33.1"
PFAM_A_URL = (
    f"ftp://ftp.ebi.ac.uk/pub/databases/Pfam/releases/{PFAM_RELEASE}/Pfam-A.fasta.gz"
)
PFAMSEQ_URL = (
    f"ftp://ftp.ebi.ac.uk/pub/databases/Pfam/releases/{PFAM_RELEASE}/pfamseq.gz"
)

# >A0A1I4YJU4_9ENTR/160-195 A0A1I4YJU4.1 PF10417.10;1-cysPrx_C;
HEADER_RE = re.compile(r">(.+)/(\d+)-(\d+) .* (.*)\.\d+;.*;")


def download_pfam_files(pfam_dir: Path) -> Tuple[Path, Path]:
    """(reference: pfam/pfam_shared.py:25-38)"""
    from ..utils.io import download_and_extract

    pfam_dir.mkdir(parents=True, exist_ok=True)
    pfam_a = pfam_dir / "Pfam-A.fasta"
    pfamseq = pfam_dir / "pfamseq"
    if not pfam_a.is_file():
        download_and_extract(PFAM_A_URL, pfam_a)
    if not pfamseq.is_file():
        download_and_extract(PFAMSEQ_URL, pfamseq)
    return pfam_a, pfamseq


def build_domain_ranges(filename: Path) -> Dict[str, List[Tuple[int, int, str]]]:
    """`>ID/start-stop` headers → id → [(start, stop, full header)]
    (reference: pfam/pfam_shared.py:41-53; 1-based inclusive ranges)."""
    substr_dict: Dict[str, List[Tuple[int, int, str]]] = defaultdict(list)
    with open(filename) as fp:
        for line in fp:
            if line[0] == ">":
                header = line.strip()[1:]
                sequence_id, substr = header.split("/")
                start, stop = substr.split("-")
                substr_dict[sequence_id].append((int(start), int(stop), header))
    return dict(substr_dict)


def get_protein_to_domain(
    proteins: Set[str], pfam_a: Path, cache: Path = None
) -> Dict[str, List[Tuple[str, Tuple[int, int]]]]:
    """protein → [(family, (start0, stop))] from Pfam-A headers, cached
    (reference: pfam/proteins_shared.py:100-136; the reference converts the
    1-based inclusive range to a python slice (start-1, stop))."""
    if cache is not None and Path(cache).is_file():
        raw = json.loads(Path(cache).read_text())
        return {
            p: [(fam, (s, e)) for fam, s, e in rows] for p, rows in raw.items()
        }
    protein_to_domain: Dict[str, List] = defaultdict(list)
    with open(pfam_a) as fp:
        for line in fp:
            if line[0] != ">":
                continue
            match = HEADER_RE.match(line)
            if match is None:
                continue
            protein, start, stop, family = match.groups()
            if protein not in proteins:
                continue
            protein_to_domain[protein].append(
                (family, (int(start) - 1, int(stop)))
            )
    protein_to_domain = dict(protein_to_domain)
    if cache is not None:
        Path(cache).write_text(
            json.dumps(
                {
                    p: [[fam, s, e] for fam, (s, e) in rows]
                    for p, rows in protein_to_domain.items()
                }
            )
        )
    return protein_to_domain


def get_homologous_proteins(
    protein_to_domain: Dict[str, List[Tuple[str, Tuple[int, int]]]]
) -> Dict[str, Set[str]]:
    """protein → set of homologs via the shared-domain-family closure
    (reference: pfam/proteins_shared.py:76-97); self excluded."""
    protein_domains = {
        protein: set(fam for fam, _ in domains)
        for protein, domains in protein_to_domain.items()
    }
    domain_proteins: Dict[str, Set[str]] = defaultdict(set)
    for protein, families in protein_domains.items():
        for family in families:
            domain_proteins[family].add(protein)
    homologous: Dict[str, Set[str]] = {}
    for protein, families in protein_domains.items():
        homologs = set(chain(*(domain_proteins[f] for f in families)))
        homologs.discard(protein)
        homologous[protein] = homologs
    return homologous


def extract_full_sequences(
    domain_ids: Set[str], pfamseq: Path, out_fasta: Path
) -> int:
    """Stream pfamseq, write the full sequences of the named proteins
    (reference: pfam/prepare_subset10_full_sequences.py:18-26; pfamseq
    headers carry the accession as the second whitespace token)."""
    remaining = set(domain_ids)
    written = 0
    with open(out_fasta, "w") as out:
        for header, sequence in iter_fasta(pfamseq):
            parts = header.split(" ")
            sequence_id = parts[1] if len(parts) > 1 else parts[0]
            if sequence_id in remaining:
                remaining.remove(sequence_id)
                out.write(f">{sequence_id}\n{sequence}\n")
                written += 1
    return written


def main(argv=None):
    """CLI parity with `python -m pfam.prepare_subset10_full_sequences`
    (reference: pfam/prepare_subset10_full_sequences.py:8-26): collect the
    proteins behind the train/test domain fastas and extract their full
    sequences from pfamseq."""
    import argparse

    parser = argparse.ArgumentParser()
    parser.add_argument("data_dir", type=Path)
    parser.add_argument("pfamseq", type=Path)
    parser.add_argument("--out", default="full_sequences.fasta")
    args = parser.parse_args(argv)
    proteins = set()
    for split in ("train", "test"):
        proteins.update(build_domain_ranges(args.data_dir / f"{split}.fasta"))
    written = extract_full_sequences(
        proteins, args.pfamseq, args.data_dir / args.out
    )
    print(f"Extracted {written} of {len(proteins)} full sequences")


if __name__ == "__main__":
    main()
