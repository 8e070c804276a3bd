"""CATH metadata: downloads, CLF parsing, id canonicalisation.

Parity with the reference's cath_shared (reference: cath/cath_shared.py:28-125):
CATH v4.2.0 S20 fasta + domain list downloads, fixed-width CLF parsing into
per-id (H, T, A, C) level tuples (index 0 = full H code, index 3 = class —
the ordering the CATH pipeline's level metrics rely on,
reference: cath/cath.py:56-58), cached; bio_embeddings-style h5 extraction.
"""

import json
from pathlib import Path
from typing import Dict, Iterable, Sequence, Tuple
from urllib.request import urlretrieve

import numpy as np

CATH_PREFIX = (
    "ftp://orengoftp.biochem.ucl.ac.uk/cath/releases/all-releases/v4_2_0/"
)
CATH_FASTA_URL = (
    CATH_PREFIX
    + "non-redundant-data-sets/cath-dataset-nonredundant-S20-v4_2_0.fa"
)
CATH_DOMAIN_LIST_URL = (
    CATH_PREFIX + "cath-classification-data/cath-domain-list-v4_2_0.txt"
)


def download_cath_files(cath_data: Path) -> Tuple[Path, Path]:
    """Fetch the S20 fasta + domain list once
    (reference: cath/cath_shared.py:28-39)."""
    cath_data.mkdir(parents=True, exist_ok=True)
    fasta_file = cath_data / "cath-20.fasta"
    domain_list = cath_data / "cath-domain-list.txt"
    if not fasta_file.is_file():
        urlretrieve(CATH_FASTA_URL, fasta_file)
    if not domain_list.is_file():
        urlretrieve(CATH_DOMAIN_LIST_URL, domain_list)
    return fasta_file, domain_list


def parse_clf(domain_list: Path) -> Dict[str, str]:
    """CLF 2.0 fixed-width parse → domain → 'C.A.T.H' code
    (reference: cath/cath_shared.py:42-100; columns 0-7 domain,
    7-13/13-19/19-25/25-31 C/A/T/H numbers)."""
    mapping: Dict[str, str] = {}
    with open(domain_list) as fp:
        for line in fp:
            if line.startswith("#") or not line.strip():
                continue
            domain = line[0:7].strip()
            c = line[7:13].split()[0]
            a = line[13:19].split()[0]
            t = line[19:25].split()[0]
            h = line[25:31].split()[0]
            mapping[domain] = f"{c}.{a}.{t}.{h}"
    return mapping


def load_mapping(
    ids: Sequence[str], domain_list: Path, cache: Path = None
) -> Tuple[Dict[str, Tuple[str, ...]], np.ndarray]:
    """→ (id → 4-tuple of level codes, [N, 4] array).

    Tuple index 0 = full H code 'C.A.T.H', 1 = 'C.A.T', 2 = 'C.A', 3 = 'C' —
    same ordering as the reference (levels reversed relative to "CATH"):
    mapping_levels[id] = tuple(cathcode.rsplit('.', i)[0] for i in range(4))
    (reference: cath/cath_shared.py:96-100)."""
    if cache is not None and Path(cache).is_file():
        codes = json.loads(Path(cache).read_text())
    else:
        codes = parse_clf(domain_list)
        if cache is not None:
            Path(cache).write_text(json.dumps(codes))
    levels: Dict[str, Tuple[str, ...]] = {}
    for seq_id in ids:
        code = codes[seq_id]
        levels[seq_id] = tuple(code.rsplit(".", i)[0] for i in range(4))
    array = np.asarray([levels[i] for i in ids])
    return levels, array


def canonical_cath_id(header: str) -> str:
    """'cath|4_2_0|16vpA00/1-100' → '16vpA00'
    (reference: cath/cath_shared.py:103-110)."""
    return header.split("|")[2].split("/")[0]


def read_ids(cath_data: Path) -> np.ndarray:
    """The canonical id order from ids.json (written by the embed driver,
    reference: cath/embed.py:76)."""
    return np.asarray(
        [
            canonical_cath_id(i)
            for i in json.loads((cath_data / "ids.json").read_text())
        ]
    )


def load_h5(filepath: Path, ids: Iterable[str]) -> np.ndarray:
    """bio_embeddings h5 → array ordered like ids
    (reference: cath/cath_shared.py:113-125)."""
    import h5py

    embedding_dict: Dict[str, np.ndarray] = {}
    with h5py.File(filepath) as h5:
        for _, value in h5.items():
            cath_id = canonical_cath_id(value.attrs["original_id"])
            embedding_dict[cath_id] = value[:]
    return np.asarray([embedding_dict[i] for i in ids])


def h5_to_npy(h5_path: Path, ids: Iterable[str]) -> None:
    np.save(Path(h5_path).with_suffix(".npy"), load_h5(h5_path, ids))
