"""ctypes bindings of mmseqs_io.cpp, the native MMseqs2 record I/O.

`load()` builds the library at first use with the flags of the JAX
package's Makefile (`$CXX`, g++ by default, `-O3 -fPIC -shared
-std=c++17`) into `build/torch_native/` at the repository root
(git-ignored), named by a hash of the source, the compiler and the flags,
and caches the handle. Nothing is written into the package directory.
Where the library cannot be built, `load()` logs one warning with the
compiler's output and returns None, and interop/mmseqs_format.py runs its
Python code, the reference. Where it loads, the native route runs, and
its errors raise as the Python code's would: ValueError on a NaN score,
OverflowError on an infinite one, OSError when a file cannot be opened.

`write_prefilter_native.calls` and `read_result_records_native.calls`
count the native route's calls, as the kernels count their launches.

Nothing here runs at import: the CPU tests import every module.
"""

import ctypes
import hashlib
import logging
import os
import shlex
import subprocess
import threading
from pathlib import Path
from typing import Optional

import numpy as np

logger = logging.getLogger(__name__)

SOURCE = Path(__file__).resolve().parent / "mmseqs_io.cpp"
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "torch_native"
CXXFLAGS = ("-O3", "-fPIC", "-shared", "-std=c++17")

# the C entry points' status codes (mmseqs_io.cpp, enum Status) and the
# exceptions the Python code raises in their place
OS_ERROR = 1
_READ_ERRORS = {
    2: (ValueError, "a malformed record line or index line"),
    3: (OverflowError, "an id beyond int64"),
    4: (IndexError, "a record outside the data files, or a missing column"),
}
_WRITE_ERRORS = {
    2: (ValueError, "cannot convert float NaN to integer"),
    3: (OverflowError, "cannot convert float infinity to integer"),
}

_LIB: Optional[ctypes.CDLL] = None
_TRIED = False
_LOCK = threading.Lock()


def compiler():
    """The C++ compiler command, `$CXX` as in the JAX package's Makefile."""
    return shlex.split(os.environ.get("CXX") or "g++")


def library_path() -> Path:
    h = hashlib.sha256(" ".join([*compiler(), *CXXFLAGS]).encode())
    h.update(SOURCE.read_bytes())
    return BUILD_DIR / f"libmmseqs_io_{h.hexdigest()[:16]}.so"


def build() -> Path:
    """Compile mmseqs_io.cpp unless this source is already built. Raises
    OSError when there is no compiler, CalledProcessError when it fails."""
    out = library_path()
    if out.exists():
        return out
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_suffix(f".{os.getpid()}.tmp")
    try:
        subprocess.run([*compiler(), *CXXFLAGS, "-o", str(tmp), str(SOURCE)],
                       check=True, capture_output=True, text=True)
        tmp.replace(out)  # atomic: a concurrent loader never sees half a file
    finally:
        tmp.unlink(missing_ok=True)
    return out


def load() -> Optional[ctypes.CDLL]:
    """The loaded library, built first if needed; None if it cannot be
    built (one warning, with the compiler's output, says why)."""
    global _LIB, _TRIED
    with _LOCK:
        if _TRIED:
            return _LIB
        _TRIED = True
        try:
            path = build()
        except subprocess.CalledProcessError as err:
            logger.warning(
                "native MMseqs2 I/O: %s failed (%d), the Python route runs:"
                "\n%s", " ".join(err.cmd), err.returncode, err.stderr)
            return None
        except OSError as err:  # no compiler
            logger.warning("native MMseqs2 I/O: no C++ compiler (%s), the"
                           " Python route runs", err)
            return None
        lib = ctypes.CDLL(str(path), use_errno=True)
        p, i64 = ctypes.c_void_p, ctypes.c_int64
        lib.rr_open.restype = p
        lib.rr_open.argtypes = [ctypes.c_char_p, ctypes.c_char_p, ctypes.c_int,
                                p, p, p]
        lib.rr_fill.restype = None
        lib.rr_fill.argtypes = [p] * 5
        lib.rr_close.restype = None
        lib.rr_close.argtypes = [p]
        lib.pf_write.restype = ctypes.c_int
        lib.pf_write.argtypes = [ctypes.c_char_p, ctypes.c_char_p, p, i64, p,
                                 p, p, i64]
        _LIB = lib
        return _LIB


def _raise(status: int, path, errors) -> None:
    if status == OS_ERROR:
        err = ctypes.get_errno()
        raise OSError(err, os.strerror(err), str(path))
    exc, what = errors[status]
    raise exc(f"{what} ({path})")


def _ptr(a: np.ndarray) -> int:
    return a.ctypes.data


def read_result_records_native(result_db: Path, e_value_column: int):
    """→ (qids [N], [target arrays], [E-value arrays]), as
    mmseqs_format.read_result_records returns them; None without the
    library."""
    lib = load()
    if lib is None:
        return None
    from ..mmseqs_format import _result_data_files

    data_files = "\n".join(str(f) for f in _result_data_files(result_db))
    nq, ne, status = np.zeros(1, np.int64), np.zeros(1, np.int64), np.zeros(
        1, np.int32)
    read_result_records_native.calls += 1
    handle = lib.rr_open((str(result_db) + ".index").encode(),
                         data_files.encode(), e_value_column, _ptr(nq),
                         _ptr(ne), _ptr(status))
    if not handle:
        _raise(int(status[0]), result_db, _READ_ERRORS)
    qids = np.empty(int(nq[0]), dtype=np.int64)
    counts = np.empty(int(nq[0]), dtype=np.int64)
    targets = np.empty(int(ne[0]), dtype=np.int64)
    evalues = np.empty(int(ne[0]), dtype=np.float64)
    lib.rr_fill(handle, _ptr(qids), _ptr(counts), _ptr(targets), _ptr(evalues))
    lib.rr_close(handle)
    bounds = np.concatenate([[0], np.cumsum(counts)]).tolist()
    t_list = [targets[a:b] for a, b in zip(bounds, bounds[1:])]
    e_list = [evalues[a:b] for a, b in zip(bounds, bounds[1:])]
    return qids, t_list, e_list


read_result_records_native.calls = 0


def write_prefilter_native(
    prefilter_db: Path,
    hits: np.ndarray,
    queries: np.ndarray,
    scores_x100: np.ndarray,
    test_to_mmseqs: np.ndarray,
    train_to_mmseqs: np.ndarray,
) -> bool:
    """Write `<db>.0` and `<db>.index` as mmseqs_format.write_prefilter_db's
    Python loop does; False without the library."""
    lib = load()
    if lib is None:
        return False
    hits, scores = np.asarray(hits), np.asarray(scores_x100, np.float64)
    if hits.ndim != 2 or scores.ndim != 2:
        raise ValueError(f"hits {hits.shape} and scores {scores.shape} must"
                         " be [queries, k]")
    # the Python loop zips queries, hit rows and score rows, and each hit
    # row with its score row: the shortest of each sets the count
    nq = min(len(queries), len(hits), len(scores))
    k = min(hits.shape[1], scores.shape[1])
    hits, scores = hits[:nq, :k], np.ascontiguousarray(scores[:nq, :k])
    # ids as the loop looks them up (numpy indexing: negative ids count
    # from the end; out-of-range or non-integer ids raise IndexError)
    kept = hits != -1
    targets = np.full(hits.shape, -1, dtype=np.int64)
    targets[kept] = np.asarray(train_to_mmseqs)[hits[kept]]
    hits = np.ascontiguousarray(hits, dtype=np.int64)
    qids = np.ascontiguousarray(
        np.asarray(test_to_mmseqs)[np.asarray(queries)[:nq]], dtype=np.int64)
    write_prefilter_native.calls += 1
    status = lib.pf_write((str(prefilter_db) + ".0").encode(),
                          (str(prefilter_db) + ".index").encode(), _ptr(qids),
                          nq, _ptr(hits), _ptr(targets), _ptr(scores), k)
    if status:
        _raise(status, prefilter_db, _WRITE_ERRORS)
    return True


write_prefilter_native.calls = 0
