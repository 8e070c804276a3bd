"""Dataset contract — the directory layout every pipeline consumes.

Identical on-disk layout to the reference's ``LoadedData``
(reference: seqvec_search/data.py:9-50): a directory with

  train.npy / test.npy        float vectors [N, d]
  train.json / test.json      ordered string ids (row i of npy ↔ ids[i])
  ids_to_family.json          id → family label
  train.fasta / test.fasta    sequences (only needed for alignment paths)

so the reference's datasets load unchanged. On top of the string-land
contract we precompute integer *family codes* so metrics and search run as
vectorised array programs instead of per-query Python loops.
"""

import json
from dataclasses import dataclass, field
from functools import cached_property
from pathlib import Path
from typing import Dict, List, Optional

import numpy as np

from ..config import DEFAULT_HITS


@dataclass
class Dataset:
    path: Path
    train: Path
    train_ids: List[str]
    test: Path
    test_ids: List[str]
    ids_to_family: Dict[str, str]
    train_sequences: Path
    test_sequences: Path
    hits: int = DEFAULT_HITS
    knn_index: Optional[Path] = None
    _family_index: Dict[str, int] = field(default_factory=dict, repr=False)

    @classmethod
    def from_dir(
        cls,
        path: Path,
        hits: int = DEFAULT_HITS,
        knn_index: Optional[Path] = None,
    ) -> "Dataset":
        path = Path(path)
        return cls(
            path=path,
            train=path / "train.npy",
            train_ids=json.loads((path / "train.json").read_text()),
            test=path / "test.npy",
            test_ids=json.loads((path / "test.json").read_text()),
            ids_to_family=json.loads((path / "ids_to_family.json").read_text()),
            train_sequences=path / "train.fasta",
            test_sequences=path / "test.fasta",
            hits=hits,
            knn_index=knn_index,
        )

    # --- mmseqs bridge directories (reference: seqvec_search/data.py:22-32) ---
    @property
    def mmseqs_dir(self) -> Path:
        return self.path / "mmseqs_dbs"

    @property
    def mmseqs_test(self) -> Path:
        return self.mmseqs_dir / "test"

    @property
    def mmseqs_train(self) -> Path:
        return self.mmseqs_dir / "train"

    # --- array accessors ---
    def load_train(self) -> np.ndarray:
        return np.load(self.train)

    def load_test(self) -> np.ndarray:
        return np.load(self.test)

    # --- vectorised family codes ---
    @cached_property
    def family_names(self) -> List[str]:
        """Stable family vocabulary: order of first appearance over train then
        test ids; families are strings in the reference, ints here."""
        index: Dict[str, int] = {}
        for seq_id in list(self.train_ids) + list(self.test_ids):
            fam = self.ids_to_family[seq_id]
            if fam not in index:
                index[fam] = len(index)
        self._family_index = index
        return list(index.keys())

    @cached_property
    def train_family_codes(self) -> np.ndarray:
        self.family_names  # ensure the index exists
        return np.asarray(
            [self._family_index[self.ids_to_family[i]] for i in self.train_ids],
            dtype=np.int32,
        )

    @cached_property
    def test_family_codes(self) -> np.ndarray:
        self.family_names
        return np.asarray(
            [self._family_index[self.ids_to_family[i]] for i in self.test_ids],
            dtype=np.int32,
        )

    @cached_property
    def train_family_sizes(self) -> np.ndarray:
        """family code → number of *train* members.

        The reference normalises AUC1/TP by the family's train count
        (reference: seqvec_search/main.py:68: Counter over train_ids).
        """
        sizes = np.zeros(len(self.family_names), dtype=np.int32)
        np.add.at(sizes, self.train_family_codes, 1)
        return sizes
