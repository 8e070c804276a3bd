"""Dataset builders: seeded Pfam subsets + family-count subsetting.

Parity with the reference (reference: seqvec_search/make_pfam_subset.py:35-98,
seqvec_search/make_subset.py:12-74). Seeds are part of the semantic
contract: `random.Random(seed)` with the same sample()/randint() call order
reproduces the published subsets (subset10 = seed 2020, 10+10,
reference: pfam/pfam_shared.py:38; the dist fixture = seed 42, 7..13,
reference: test-data/pfam-20-dist/make_pfam_subset.py).
"""

import json
import random
from collections import defaultdict
from pathlib import Path
from typing import Dict, List, Set

from .dataset import Dataset
from .fasta import iter_fasta

import numpy as np


def make_pfam_subset(
    data: Path,
    seed: int,
    pfam_a: Path,
    pfamseq: Path,
    min_count: int,
    max_count: int,
) -> int:
    """Sample min+max domains per family with ≥ min+max members; split into
    train/test fastas with ground truth; extract full sequences from pfamseq.
    Returns the number of picked families."""
    data = Path(data)
    data.mkdir(parents=True, exist_ok=True)
    picked_sequence: Set[str] = set()
    domain_extract_test: Dict[str, Dict[str, List[str]]] = defaultdict(dict)
    domain_extract_train: Dict[str, Dict[str, List[str]]] = defaultdict(dict)
    picked_families = 0
    id_to_family: Dict[str, str] = {}
    rng = random.Random(seed)

    def flush(entries, family, out_train, out_test):
        nonlocal picked_families
        if len(entries) <= min_count + max_count:
            return
        picked_families += 1
        selected = rng.sample(entries, min_count + max_count)
        split_size = rng.randint(min_count, max_count)
        for protein_id, domain_range, sequence in selected[:split_size]:
            out_train.write(f">{protein_id}/{domain_range}\n{sequence}\n")
            domain_extract_train[protein_id][f"{protein_id}/{domain_range}"] = [
                domain_range
            ]
        for protein_id, domain_range, sequence in selected[split_size:]:
            out_test.write(f">{protein_id}/{domain_range}\n{sequence}\n")
            domain_extract_test[protein_id][f"{protein_id}/{domain_range}"] = [
                domain_range
            ]
        for protein_id, domain_range, _ in selected:
            picked_sequence.add(protein_id)
            id_to_family[f"{protein_id}/{domain_range}"] = family

    with open(data / "train.fasta", "w") as out_train, open(
        data / "test.fasta", "w"
    ) as out_test:
        last_family = None
        entries: List = []
        for header, sequence in iter_fasta(Path(pfam_a)):
            last_space = header.rfind(" ")
            family = header[last_space + 1 : header.find(".", last_space)]
            if family != last_family:
                if last_family is not None:
                    flush(entries, last_family, out_train, out_test)
                entries = []
                last_family = family
            protein_id, domain_range = header[: header.find(" ")].split("/")
            entries.append((protein_id, domain_range, sequence))
        # NOTE: the final family is deliberately NOT flushed — the reference
        # generator only samples a family when the next family's header
        # appears, so the last family of Pfam-A is always dropped
        # (reference: seqvec_search/make_pfam_subset.py:50-77). Mirroring
        # that quirk keeps the seeded RNG call sequence, and therefore the
        # published subsets, reproducible byte-for-byte.

    (data / "extract_test.json").write_text(json.dumps(domain_extract_test))
    (data / "extract_train.json").write_text(json.dumps(domain_extract_train))
    (data / "ids_to_family.json").write_text(json.dumps(id_to_family))

    # train/test id order = fasta order (the Dataset contract)
    for split in ("train", "test"):
        ids = [h for h, _ in iter_fasta(data / f"{split}.fasta")]
        (data / f"{split}.json").write_text(json.dumps(ids))

    if pfamseq is not None and Path(pfamseq).is_file():
        with open(data / "full-sequences.fasta", "w") as out:
            for header, sequence in iter_fasta(Path(pfamseq)):
                parts = header.split(" ")
                sequence_id = parts[1] if len(parts) > 1 else parts[0]
                if sequence_id in picked_sequence:
                    picked_sequence.remove(sequence_id)
                    out.write(f">{sequence_id}\n{sequence}\n")
    return picked_families


def make_subset_by_families(
    input_dir: Path, output_dir: Path, n_families: int
) -> None:
    """Filter a dataset to its first N families, slicing npy/json/fasta
    consistently (reference: seqvec_search/make_subset.py:24-74)."""
    output_dir = Path(output_dir)
    output_dir.mkdir(parents=True)
    data = Dataset.from_dir(Path(input_dir))
    # insertion-ordered first-N families (the reference's set() ordering is
    # arbitrary; first-appearance order is deterministic)
    families: List[str] = []
    for i in data.train_ids + data.test_ids:
        fam = data.ids_to_family[i]
        if fam not in families:
            families.append(fam)
        if len(families) >= n_families:
            break
    keep = set(families[:n_families])

    test_ids = [i for i in data.test_ids if data.ids_to_family[i] in keep]
    train_ids = [i for i in data.train_ids if data.ids_to_family[i] in keep]
    (output_dir / "test.json").write_text(json.dumps(test_ids))
    (output_dir / "train.json").write_text(json.dumps(train_ids))

    test_filter = [data.ids_to_family[i] in keep for i in data.test_ids]
    train_filter = [data.ids_to_family[i] in keep for i in data.train_ids]
    np.save(output_dir / "test.npy", data.load_test()[test_filter])
    np.save(output_dir / "train.npy", data.load_train()[train_filter])
    (output_dir / "ids_to_family.json").write_text(
        json.dumps(data.ids_to_family)
    )
    for split in ("train", "test"):
        src = input_dir / f"{split}.fasta"
        if not src.is_file():
            continue
        with open(output_dir / f"{split}.fasta", "w") as out:
            for header, sequence in iter_fasta(src):
                if data.ids_to_family[header] in keep:
                    out.write(f">{header}\n{sequence}\n")


def main(argv=None):
    """CLI parity with the reference's builder entry points
    (reference: seqvec_search/make_pfam_subset.py:103-124 and
    seqvec_search/make_subset.py:25-78)."""
    import argparse

    from ..utils.logging import configure_logging

    configure_logging()
    parser = argparse.ArgumentParser()
    sub = parser.add_subparsers(dest="command", required=True)

    p = sub.add_parser("pfam-subset")
    p.add_argument("--pfam", type=Path, default=Path("data"))
    p.add_argument("--data", type=Path, default=Path("data/pfam-dist"))
    p.add_argument("--min", type=int, default=7)
    p.add_argument("--max", type=int, default=13)
    p.add_argument("--seed", type=int, default=532741831)

    p = sub.add_parser("family-subset")
    p.add_argument("input", type=Path)
    p.add_argument("output", type=Path)
    p.add_argument("families", type=int)

    args = parser.parse_args(argv)
    if args.command == "pfam-subset":
        make_pfam_subset(
            args.data,
            args.seed,
            args.pfam / "Pfam-A.fasta",
            args.pfam / "pfamseq",
            args.min,
            args.max,
        )
    else:
        make_subset_by_families(args.input, args.output, args.families)


if __name__ == "__main__":
    main()
