"""MMseqs2 subprocess drivers — the host edge of the hybrid pipeline.

Parity with the reference's wrappers (reference: seqvec_search/mmseqs/
_create_sequence_dbs.py, _search.py, _align.py): createdb with mtime-based
up-to-date checks, `search -e -s [--max-seqs] [--num-iterations]` with temp
dir + stale-result cleanup, `align -e`, wall-time returns. The binary is
located via $MMSEQS_PATH, $PATH, or the reference's ./mmseqs/bin/mmseqs
layout; when absent, sequence DBs are written natively
(interop/mmseqs_format.write_sequence_db) and search/align raise
MMseqsNotFound — the native TPU aligner (search/rescore.py) covers the
alignment capability without the binary.
"""

import logging
import os
import shutil
import time
from pathlib import Path
from subprocess import check_call
from tempfile import TemporaryDirectory
from typing import Optional

from ..config import E_VALUE_CUTOFF
from ..data.dataset import Dataset
from ..data.fasta import iter_fasta
from .mmseqs_format import write_sequence_db

logger = logging.getLogger(__name__)


class MMseqsNotFound(RuntimeError):
    pass


def find_mmseqs() -> Optional[str]:
    env = os.environ.get("MMSEQS_PATH")
    if env and Path(env).exists():
        return env
    on_path = shutil.which("mmseqs")
    if on_path:
        return on_path
    local = Path("mmseqs/bin/mmseqs")  # the reference's layout
    if local.exists():
        return str(local)
    return None


def _require_mmseqs() -> str:
    binary = find_mmseqs()
    if binary is None:
        raise MMseqsNotFound(
            "mmseqs binary not found (set $MMSEQS_PATH); the native TPU "
            "aligner (search.rescore.align_rescore) provides the alignment "
            "capability without it"
        )
    return binary


def create_db(fasta_file: Path, db_name: Path) -> None:
    """`mmseqs createdb`, or the byte-compatible native writer without the
    binary (reference: mmseqs/_create_sequence_dbs.py:11-12)."""
    Path(db_name).parent.mkdir(parents=True, exist_ok=True)
    binary = find_mmseqs()
    if binary:
        check_call([binary, "createdb", str(fasta_file), str(db_name)])
    else:
        write_sequence_db(iter_fasta(Path(fasta_file)), Path(db_name))


def create_sequence_dbs(data: Dataset) -> None:
    """Convert train/test fastas to MMseqs DBs unless already up to date
    (mtime check — reference: mmseqs/_create_sequence_dbs.py:24-29)."""
    data.mmseqs_dir.mkdir(exist_ok=True)
    for db_name, sequences in [
        ("test", data.test_sequences),
        ("train", data.train_sequences),
    ]:
        dbtype = data.mmseqs_dir / f"{db_name}.dbtype"
        if (
            not dbtype.is_file()
            or dbtype.stat().st_mtime
            < (data.path / f"{db_name}.fasta").stat().st_mtime
        ):
            logger.info("Creating mmseqs database for %s", db_name)
            create_db(sequences, data.mmseqs_dir / db_name)


def search(
    data: Dataset,
    sensitivity: float = 7.5,
    e_value_cutoff: float = E_VALUE_CUTOFF,
    max_seqs: Optional[int] = None,
    num_iterations: Optional[int] = None,
) -> float:
    """`mmseqs search` (reference: mmseqs/_search.py:14-41 and the iterated
    variant of pfam/pfam.py:56-122). Returns wall seconds."""
    binary = _require_mmseqs()
    create_sequence_dbs(data)
    logger.info("Searching with MMseqs2")
    start = time.time()
    for stale in data.mmseqs_dir.glob("result_mmseqs2*"):
        stale.unlink()
    cmd = [
        binary,
        "search",
        "-e",
        str(e_value_cutoff),
        "-s",
        str(sensitivity),
    ]
    if max_seqs is not None:
        cmd += ["--max-seqs", str(max_seqs)]
    if num_iterations is not None:
        cmd += ["--num-iterations", str(num_iterations)]
    with TemporaryDirectory() as temp_dir:
        check_call(
            cmd
            + [
                str(data.mmseqs_test),
                str(data.mmseqs_train),
                str(data.mmseqs_dir / "result_mmseqs2"),
                temp_dir,
            ]
        )
    total = time.time() - start
    logger.info("`mmseqs search` took %fs", total)
    return total


def align(data: Dataset, e_value_cutoff: float = E_VALUE_CUTOFF) -> float:
    """`mmseqs align` over the written prefilter DB
    (reference: mmseqs/_align.py:12-30). Returns wall seconds."""
    binary = _require_mmseqs()
    logger.info("Aligning with MMseqs2")
    start = time.time()
    check_call(
        [
            binary,
            "align",
            "-e",
            str(e_value_cutoff),
            str(data.mmseqs_test),
            str(data.mmseqs_train),
            str(data.mmseqs_dir / "prefilter"),
            str(data.mmseqs_dir / "result_combined"),
        ]
    )
    total = time.time() - start
    logger.info("`mmseqs align` took %fs", total)
    return total
