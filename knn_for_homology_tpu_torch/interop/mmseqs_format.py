"""MMseqs2 database formats — byte-compatible writers/readers.

The bridge into the classical aligner: kNN hit lists become an MMseqs2
*prefilter database* that `mmseqs align` re-scores
(reference: seqvec_search/mmseqs/_write_prefilter_db.py:33-97), and MMseqs2
result databases are parsed back into hit/E-value arrays
(reference: seqvec_search/mmseqs/_read_results_db.py). We additionally write
MMseqs2 *sequence databases* directly (the reference shells out to
`mmseqs createdb` for those, reference: mmseqs/_create_sequence_dbs.py:12),
so the bridge works end-to-end without the binary until alignment time.
"""

from pathlib import Path
from typing import Dict, Iterable, List, Sequence, Tuple

import numpy as np

from ..config import SENTINEL_E_VALUE

# .dbtype payloads (first byte = type id)
DBTYPE_AA = b"\x00\x00\x00\x00"
DBTYPE_PREFILTER = b"\x07\x00\x00\x00"
DBTYPE_GENERIC = b"\x0c\x00\x00\x00"


# --- id maps -------------------------------------------------------------------


def make_id_map(ids: Sequence[str], mmseqs_db: Path) -> np.ndarray:
    """Row position in `ids` → MMseqs2 internal id, via the .lookup file
    (reference: mmseqs/_write_prefilter_db.py:20-30)."""
    lookup: Dict[str, int] = {}
    with open(str(mmseqs_db) + ".lookup") as fp:
        for line in fp:
            seq_mmseqs_id, seq_name, _ = line.split("\t")
            lookup[seq_name] = int(seq_mmseqs_id)
    return np.asarray([lookup[name] for name in ids], dtype=np.int64)


# --- sequence DB writer (mmseqs createdb equivalent) -----------------------------


def write_sequence_db(fasta_entries: Iterable[Tuple[str, str]], db: Path) -> None:
    """Write an MMseqs2 sequence DB (data/.index/.dbtype/.lookup/_h…) from
    (header, sequence) pairs. First whitespace-token of the header is the
    accession (createdb's convention)."""
    db = Path(db)
    db.parent.mkdir(parents=True, exist_ok=True)
    data = open(db, "wb")
    index = open(str(db) + ".index", "w")
    lookup = open(str(db) + ".lookup", "w")
    hdr = open(str(db) + "_h", "wb")
    hdr_index = open(str(db) + "_h.index", "w")
    offset = hdr_offset = 0
    for i, (header, sequence) in enumerate(fasta_entries):
        name = header.split()[0] if header.split() else str(i)
        record = (sequence + "\n").encode() + b"\0"
        data.write(record)
        index.write(f"{i}\t{offset}\t{len(record)}\n")
        offset += len(record)
        hrec = (header + "\n").encode() + b"\0"
        hdr.write(hrec)
        hdr_index.write(f"{i}\t{hdr_offset}\t{len(hrec)}\n")
        hdr_offset += len(hrec)
        lookup.write(f"{i}\t{name}\t0\n")
    for fp in (data, index, lookup, hdr, hdr_index):
        fp.close()
    Path(str(db) + ".dbtype").write_bytes(DBTYPE_AA)
    Path(str(db) + "_h.dbtype").write_bytes(DBTYPE_GENERIC)
    Path(str(db) + ".source").write_text(f"0\t{db.name}.fasta\n")


# --- prefilter DB writer ----------------------------------------------------------


def write_prefilter_db(
    hits: np.ndarray,  # [Q, k] search-engine row ids, -1 = missing
    prefilter_db: Path,
    queries: np.ndarray,  # [Q] query row ids
    scores: np.ndarray,  # [Q, k]
    test_to_mmseqs: np.ndarray,
    train_to_mmseqs: np.ndarray,
    clip: bool = True,
) -> None:
    """Byte-compatible with the reference's hand-written prefilter DB
    (reference: mmseqs/_write_prefilter_db.py:52-97): one data file
    `<db>.0` of `target\\tscore\\t0\\n` lines per query, NUL-terminated
    records, scores ×100 as int (clipped ±1e30), `.index` of
    (mmseqs query id, offset, record length)."""
    prefilter_db = Path(prefilter_db)
    prefilter_db.parent.mkdir(parents=True, exist_ok=True)
    Path(str(prefilter_db) + ".dbtype").write_bytes(DBTYPE_PREFILTER)
    scores_int = np.asarray(scores, dtype=np.float64)
    if clip:
        scores_int = np.clip(scores_int, -1e30, 1e30)
    scores_int = scores_int * 100

    with open(str(prefilter_db) + ".0", "wb") as data, open(
        str(prefilter_db) + ".index", "w"
    ) as index:
        offset = 0
        for query, hit_row, score_row in zip(
            np.asarray(queries), np.asarray(hits), scores_int
        ):
            length = 0
            for hit, score in zip(hit_row, score_row):
                if hit == -1:
                    continue
                line = f"{train_to_mmseqs[hit]}\t{int(score)}\t0\n".encode()
                data.write(line)
                length += len(line)
            data.write(b"\0")
            length += 1
            index.write(f"{test_to_mmseqs[query]}\t{offset}\t{length}\n")
            offset += length


# --- result DB reader --------------------------------------------------------------


def _result_data_files(result_db: Path) -> List[Path]:
    """Numbered data files of a result DB, or the single merged file
    (iterated search) — reference: mmseqs/_read_results_db.py:151-160."""
    result_db = Path(result_db)
    if result_db.is_file():
        return [result_db]
    files = [
        f
        for f in result_db.parent.glob(f"{result_db.name}.*")
        if f.suffix[1:].isdigit()
    ]
    if not files:
        raise FileNotFoundError(f"no data files for result DB {result_db}")
    return sorted(files, key=lambda f: int(f.suffix[1:]))


class ConcatBuffer:
    """Multiple data files addressed as one contiguous byte range — the
    reading side of MMseqs2's split data files
    (reference: mmseqs/_read_results_db.py MultiMMap).

    mmap-backed, like the reference's MultiMMap: UniRef90-scale result DBs
    are tens of GB and must never be materialised in RAM — the kernel pages
    in only the slices actually read."""

    def __init__(self, files: Sequence[Path]):
        import mmap

        self.blobs = []
        self.sizes = []
        self._files = []
        for f in files:
            size = Path(f).stat().st_size
            if size == 0:  # mmap refuses empty files
                self.blobs.append(b"")
            else:
                fp = open(f, "rb")
                self._files.append(fp)
                self.blobs.append(
                    mmap.mmap(fp.fileno(), 0, access=mmap.ACCESS_READ)
                )
            self.sizes.append(size)

    def __getitem__(self, item: slice) -> bytes:
        start, stop = item.start, item.stop
        for blob, size in zip(self.blobs, self.sizes):
            if start < size:
                assert stop <= size, (start, stop, size)
                return blob[start:stop]
            start -= size
            stop -= size
        raise IndexError(item)

    def close(self) -> None:
        for blob in self.blobs:
            if blob:
                blob.close()
        for fp in self._files:
            fp.close()
        self.blobs, self._files = [], []

    def __enter__(self) -> "ConcatBuffer":
        return self

    def __exit__(self, *exc) -> None:
        self.close()


def _read_index(result_db: Path) -> np.ndarray:
    """[N, 3] int64 (query_id, offset, record_size)."""
    rows = []
    with open(str(result_db) + ".index") as fp:
        for line in fp:
            qid, offset, size = line.split("\t")
            rows.append((int(qid), int(offset), int(size)))
    return np.asarray(rows, dtype=np.int64)


def read_result_records(
    result_db: Path, e_value_column: int = 3
) -> Tuple[np.ndarray, List[np.ndarray], List[np.ndarray]]:
    """Raw parse: (mmseqs query ids [N], per-query target-id arrays,
    per-query E-value arrays). E-values come from `e_value_column` when a
    record line has that many columns (alignment format), else 0."""
    index = _read_index(result_db)
    targets: List[np.ndarray] = []
    evalues: List[np.ndarray] = []
    with ConcatBuffer(_result_data_files(result_db)) as buffer:
        return _parse_records(index, buffer, e_value_column, targets, evalues)


def _parse_records(index, buffer, e_value_column, targets, evalues):
    for qid, offset, size in index:
        record = buffer[offset : offset + size - 1]  # -1 drops the NUL
        t_list, e_list = [], []
        for line in record.split(b"\n")[:-1]:
            cols = line.split(b"\t")
            t_list.append(int(cols[0]))
            e_list.append(
                float(cols[e_value_column])
                if len(cols) > e_value_column
                else 0.0
            )
        targets.append(np.asarray(t_list, dtype=np.int64))
        evalues.append(np.asarray(e_list, dtype=np.float64))
    return index[:, 0], targets, evalues


def read_result_db(
    train_ids: Sequence[str],
    mmseqs_train: Path,
    test_ids: Sequence[str],
    mmseqs_test: Path,
    result_db: Path,
) -> Dict[str, List[str]]:
    """Hits as string ids (reference: mmseqs/_read_results_db.py:65-129)."""
    test_back = np.argsort(make_id_map(test_ids, mmseqs_test))
    train_back = np.argsort(make_id_map(train_ids, mmseqs_train))
    qids, targets, _ = read_result_records(result_db)
    hits: Dict[str, List[str]] = {}
    for qid, t_arr in zip(qids, targets):
        query = test_ids[test_back[qid]]
        hits[query] = [train_ids[i] for i in train_back[t_arr]]
    return hits


def read_result_db_with_e_value(
    train_ids: Sequence[str],
    mmseqs_train: Path,
    test_ids: Sequence[str],
    mmseqs_test: Path,
    result_db: Path,
) -> Tuple[Dict[int, np.ndarray], Dict[int, np.ndarray]]:
    """Int-id variant (reference: mmseqs/_read_results_db.py:132-175)."""
    test_back = np.argsort(make_id_map(test_ids, mmseqs_test))
    train_back = np.argsort(make_id_map(train_ids, mmseqs_train))
    qids, targets, evalues = read_result_records(result_db)
    hits: Dict[int, np.ndarray] = {}
    evs: Dict[int, np.ndarray] = {}
    for qid, t_arr, e_arr in zip(qids, targets, evalues):
        query = int(test_back[qid])
        hits[query] = train_back[t_arr]
        evs[query] = e_arr
    return hits, evs


def results_to_array(
    hits: Dict[int, np.ndarray],
    e_values: Dict[int, np.ndarray],
    sentinel_e_value: float = SENTINEL_E_VALUE,
) -> Tuple[np.ndarray, np.ndarray]:
    """Pad ragged per-query hits to rectangles; padding gets E = sentinel
    (reference: mmseqs/_read_results_db.py:178-196).

    Deviation from the reference: hit-id padding is -1 (the engine-wide
    missing-hit sentinel) instead of numpy's default 0 — 0 is a real train
    row, and our evaluators consume hit ids directly (the reference only
    ever evaluated separately padded correctness arrays)."""
    max_hits = max(len(h) for h in hits.values())
    hit_rows, ev_rows = [], []
    for i in range(len(hits)):
        pad = max_hits - len(hits[i])
        hit_rows.append(np.pad(hits[i], (0, pad), constant_values=-1))
        ev_rows.append(
            np.pad(e_values[i], (0, pad), constant_values=sentinel_e_value)
        )
    return np.asarray(hit_rows), np.asarray(ev_rows)
