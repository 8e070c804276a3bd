"""Build the CUDA kernels in csrc/ at first use and bind them with ctypes.

Every `csrc/*.cu` compiles in its own nvcc process, all started together,
and one more nvcc call links the objects into a shared library with a plain
C interface (no PyTorch headers: seconds instead of minutes), against
libcuda (`-lcuda`, for the TMA maps of kernels B, D-K and L; the
toolkit's stub at link time, the installed libcuda.so.1 at load time). The library
lands in `build/torch_kernels/` at the repository root (git-ignored),
named by a hash of the sources and flags (taken once per process), so an
edited kernel rebuilds in the next process and an unchanged one loads from
disk. Pointers and the stream travel as
`ctypes.c_void_p`; every entry point returns `cudaGetLastError()` after its
launch, which `check` turns into an exception.

Nothing here runs at import: the CPU tests import every module of the port.
"""

import ctypes
import functools
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
_F = ctypes.c_float
# C entry points: name -> argument types (each returns cudaError_t, but
# the *_blocks_per_sm, *_warps and *_group queries, which return a count
# or -1)
SIGNATURES = {
    # q, db, norms, vals, ids, part_vals, part_ids, q_n, n, d, k, splits,
    # l2, stream
    "knn_flat_topk": [
        _P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _P,
    ],
    # q, db, norms, buf_v, buf_i, q_n, n, n_valid, d, w, r, l2, stages,
    # global_slots, stream
    "knn_segment_topr": [
        _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I, _I, _I, _P,
    ],
    # q, q_lo, db, scales, norms, buf, q_n, n, n_valid, d, w, r, jbits,
    # variant, l2, stream
    "knn_segment_packed": [
        _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I, _I, _I, _P,
    ],
    # variant, n, d, w, r -> passes one product of kernel F / J spans
    "knn_segment_packed_group": [_I, _I, _I, _I, _I],
    # q, q_lo, pv, scales, ids, cells, buf, q_n, budget, table_rows, d, w,
    # r, jbits, two_level, stream
    "knn_ivf_indirect": [
        _P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I, _I, _P,
    ],
    # nodes, pairs, t_max, narrow, tiles, stream
    "knn_slab_tiles": [_P, _I, _I, _I, _P, _P],
    # q, pv, pi, sc, order, nodes, tiles, sims, nbrs, q_n, e, d, deg_p,
    # n_nodes, t_max, stream
    "knn_slab_expand": [
        _P, _P, _P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _P,
    ],
    # sel, q, pv, pi, sc, sims, nbrs, q_n, e, d, deg_p, n_nodes, stream
    "knn_slab_expand_pairs": [
        _P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _P,
    ],
    # q, t, blosum, bound, live, counters, out, g, lq, lt, k, segments,
    # gap_first, gap_ext, stream
    "knn_sw_grouped": [
        _P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I, _P,
    ],
    # g, k -> warps of kernel C's DP grid (rows of its boundary scratch)
    "knn_sw_grouped_warps": [_I, _I],
    # x, ln, wi, wo, normed, h, out, t, d, f, eps, residual, stream
    "knn_ffn_fused": [_P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _F, _I, _P],
    # q, k, v, mask, table, out, b, h, l, stream
    "knn_flash_t5": [_P, _P, _P, _P, _P, _P, _I, _I, _I, _P],
    # q, k, v, mask, table, out, b, h, l, stream
    "knn_short_t5": [_P, _P, _P, _P, _P, _P, _I, _I, _I, _P],
    # q, k, v, r, r row stride, mask, r_w, r_r, out, b, h, l, stream
    "knn_flash_xlnet": [
        _P, _P, _P, _P, ctypes.c_longlong, _P, _P, _P, _P, _I, _I, _I, _P,
    ],
    # xw, w_h, w_proj, order, lens, y, sums, cells, counters, rows, steps,
    # cell_clip, proj_clip, stream
    "knn_lstmp_bidir": [_P, _P, _P, _P, _P, _P, _P, _P, _P, _I, _I, _F, _F,
                        _P],
    # l -> blocks of kernel H / I that fit on one SM (the occupancy query)
    "knn_flash_t5_blocks_per_sm": [_I],
    "knn_short_t5_blocks_per_sm": [_I],
}

_LIB = {}  # digest -> loaded CDLL (one per process)


def sources():
    return sorted(CSRC.glob("*.cu")) + sorted(CSRC.glob("*.cuh"))


@functools.lru_cache(maxsize=None)
def _digest() -> str:
    """Hash of the sources and flags, taken once per process: every kernel
    call asks for the library, and re-reading the sources each time cost
    milliseconds of host time per launch."""
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


def _link_flags(nvcc: str):
    """-lcuda, with the toolkit's stub directory (libcuda.so is the
    driver's and need not be on the linker's path)."""
    root = Path(nvcc).resolve().parent.parent
    stubs = [root / "lib64" / "stubs",
             root / "targets" / "x86_64-linux" / "lib" / "stubs"]
    return [f"-L{d}" for d in stubs if d.is_dir()] + ["-lcuda"]


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
                   *map(str, objs), *_link_flags(nvcc)]])
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
