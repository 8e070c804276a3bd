"""MMseqs2 interop — formats + subprocess drivers (the host edge).

Public surface mirrors the reference's `seqvec_search.mmseqs` package
(reference: seqvec_search/mmseqs/__init__.py:1-15).
"""

from pathlib import Path

import numpy as np

from ..data.dataset import Dataset
from .mmseqs_cli import (
    MMseqsNotFound,
    align,
    create_db,
    create_sequence_dbs,
    find_mmseqs,
    search,
)
from .mmseqs_format import (
    ConcatBuffer,
    make_id_map,
    read_result_db as _read_result_db_impl,
    read_result_db_with_e_value,
    read_result_records,
    results_to_array,
    write_prefilter_db,
    write_sequence_db,
)


def write_prefilter_db_data(
    data: Dataset, queries: np.ndarray, hits: np.ndarray, scores: np.ndarray
) -> None:
    """kNN hits → prefilter DB next to the dataset's MMseqs DBs
    (reference: mmseqs/_write_prefilter_db.py:33-49)."""
    create_sequence_dbs(data)
    test_map = make_id_map(data.test_ids, data.mmseqs_test)
    train_map = make_id_map(data.train_ids, data.mmseqs_train)
    write_prefilter_db(
        hits, data.mmseqs_dir / "prefilter", queries, scores, test_map, train_map
    )


def read_result_db(data: Dataset, result_db: Path):
    return _read_result_db_impl(
        data.train_ids, data.mmseqs_train, data.test_ids, data.mmseqs_test,
        result_db,
    )


__all__ = [
    "MMseqsNotFound",
    "align",
    "create_db",
    "create_sequence_dbs",
    "find_mmseqs",
    "search",
    "ConcatBuffer",
    "make_id_map",
    "read_result_db",
    "read_result_db_with_e_value",
    "read_result_records",
    "results_to_array",
    "write_prefilter_db",
    "write_prefilter_db_data",
    "write_sequence_db",
]
