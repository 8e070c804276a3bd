"""Build the CUDA kernels in csrc/ at first use and bind them with ctypes.

Every `csrc/*.cu` compiles in its own nvcc process, all started together,
and one more nvcc call links the objects into a shared library with a plain
C interface (no PyTorch headers: seconds instead of minutes). The library
lands in `build/torch_kernels/` at the repository root (git-ignored),
named by a hash of the sources and flags, so an edited kernel rebuilds and
an unchanged one loads from disk. Pointers and the stream travel as
`ctypes.c_void_p`; every entry point returns `cudaGetLastError()` after its
launch, which `check` turns into an exception.

Nothing here runs at import: the CPU tests import every module of the port.
"""

import ctypes
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path

CSRC = Path(__file__).resolve().parent.parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "torch_kernels"
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-Xcompiler", "-fPIC", "-lineinfo",
)

_P = ctypes.c_void_p
_I = ctypes.c_int
# C entry points: name -> argument types (every one returns cudaError_t)
SIGNATURES = {
    # q, db, vals, ids, part_vals, part_ids, q_n, n, d, k, splits, l2, stream
    "knn_flat_topk": [_P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _P],
    # q, db, buf_v, buf_i, q_n, n, d, w, r, l2, stream
    "knn_segment_topr": [_P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _P],
    # q, q_lo, db, scales, buf, q_n, n, d, w, r, jbits, variant, l2, stream
    "knn_segment_packed": [
        _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I, _I, _P,
    ],
    # q, t_jk, blosum, state, out, g, lq, lt, k, segments, gap_first,
    # gap_ext, stream
    "knn_sw_grouped": [_P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I, _P],
}

_LIB = {}  # digest -> loaded CDLL (one per process)


def sources():
    return sorted(CSRC.glob("*.cu")) + sorted(CSRC.glob("*.cuh"))


def _digest() -> str:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for path in sources():
        h.update(path.name.encode())
        h.update(path.read_bytes())
    return h.hexdigest()[:16]


def _nvcc() -> str:
    from torch.utils.cpp_extension import CUDA_HOME

    if CUDA_HOME and (Path(CUDA_HOME) / "bin" / "nvcc").exists():
        return str(Path(CUDA_HOME) / "bin" / "nvcc")
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError("nvcc not found: the CUDA kernels cannot be built")
    return found


def library_path() -> Path:
    return BUILD_DIR / f"libknn_kernels_{_digest()}.so"


def _run_all(cmds) -> None:
    """Run the commands concurrently; raise with the output of any failure."""
    procs = [
        subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                         text=True)
        for cmd in cmds
    ]
    failed = []
    for cmd, proc in zip(cmds, procs):
        out, err = proc.communicate()
        if proc.returncode != 0:
            failed.append(f"{' '.join(cmd)} ({proc.returncode}):\n{out}\n{err}")
    if failed:
        raise RuntimeError("nvcc failed:\n" + "\n".join(failed))


def build() -> Path:
    """Compile csrc/*.cu unless this exact source set is already built."""
    out = library_path()
    if out.exists():
        return out
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    stem = out.with_suffix(f".{os.getpid()}")
    nvcc = _nvcc()
    units = [p for p in sources() if p.suffix == ".cu"]
    objs = [Path(f"{stem}.{p.stem}.o") for p in units]
    tmp = Path(f"{stem}.tmp")
    try:
        _run_all([
            [nvcc, *NVCC_FLAGS, "-c", str(src), "-o", str(obj)]
            for src, obj in zip(units, objs)
        ])
        _run_all([[nvcc, *NVCC_FLAGS, "-shared", "-o", str(tmp),
                   *map(str, objs)]])
        tmp.replace(out)  # atomic: a concurrent loader never sees half a file
    finally:
        for path in (*objs, tmp):
            path.unlink(missing_ok=True)
    return out


def library() -> ctypes.CDLL:
    """The loaded kernel library, built first if needed."""
    key = _digest()
    if key not in _LIB:
        lib = ctypes.CDLL(str(build()))
        for name, argtypes in SIGNATURES.items():
            fn = getattr(lib, name)
            fn.argtypes = argtypes
            fn.restype = ctypes.c_int
        lib.knn_error_string.argtypes = [ctypes.c_int]
        lib.knn_error_string.restype = ctypes.c_char_p
        _LIB[key] = lib
    return _LIB[key]


def timed_build() -> float:
    """Build (if needed) and load the library; returns wall seconds."""
    start = time.perf_counter()
    library()
    return time.perf_counter() - start


def check(code: int, name: str) -> None:
    if code != 0:
        msg = library().knn_error_string(code).decode()
        raise RuntimeError(f"{name}: CUDA launch failed: {msg} ({code})")


def stream_ptr(device) -> int:
    import torch

    return torch.cuda.current_stream(device).cuda_stream
