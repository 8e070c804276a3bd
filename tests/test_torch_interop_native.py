"""The port's native MMseqs2 I/O (interop/native: mmseqs_io.cpp through
ctypes) against the JAX package's Python writer and parser, the
reference: the same bytes, the same arrays (E-values exact: both parse
with correctly rounded decimal conversion) and the same exception types.
The JAX side runs with its own native route patched off, as
tests/test_interop.py does. The library is built at first use; a test
skips only where no C++ compiler is found."""

import logging
import shutil
from pathlib import Path

import numpy as np
import pytest

import knn_for_homology_tpu.interop.native as jnative
from knn_for_homology_tpu.interop import mmseqs_format as jformat
from knn_for_homology_tpu_torch.interop import mmseqs_format as tformat
from knn_for_homology_tpu_torch.interop import native

ROOT = Path(__file__).resolve().parent.parent
N_TRAIN, N_TEST, K = 60, 24, 9


@pytest.fixture()
def lib(monkeypatch):
    """The port's library, counters at 0; the JAX side on its Python
    route."""
    if shutil.which(native.compiler()[0]) is None:
        pytest.skip(f"no C++ compiler ({native.compiler()[0]})")
    assert native.load() is not None, "the native library did not build"
    monkeypatch.setattr(native.write_prefilter_native, "calls", 0)
    monkeypatch.setattr(native.read_result_records_native, "calls", 0)
    monkeypatch.setattr(jnative, "write_prefilter_native",
                        lambda *a, **k: False)
    monkeypatch.setattr(jnative, "read_result_records_native",
                        lambda *a, **k: None)
    return native.load()


def _maps():
    rng = np.random.RandomState(11)
    return rng.permutation(N_TEST) + 1000, rng.permutation(N_TRAIN) * 7


def _hits_scores(case):
    rng = np.random.RandomState(3)
    hits = rng.randint(-1, N_TRAIN, size=(N_TEST, K))
    scores = rng.uniform(-3, 4, size=(N_TEST, K))
    special = {
        "random": [],
        "negative_fractional": [-0.004, -0.5, -0.999, -2.567, -250.9, -1e-9],
        "inf_clipped": [np.inf, -np.inf, np.inf],
        "huge": [1e20, -1e18, 1e28, -1e30, 1e30, 3.3e29],
        "int64_edge": [9.2e16, -9.2e16, 9.3e16, -9.3e16, 92233720368547758.07,
                       -92233720368547758.08],
        "unclipped": [1.7e306, -1.7e306, 1e300, 5e-320],
    }[case]
    hits[1, :] = -1  # an empty record
    hits[2, :3] = -1
    if special:
        hits[0, : len(special)] = np.arange(len(special))  # kept
        scores[0, : len(special)] = special
    return hits, scores.astype(np.float32 if case == "random" else np.float64)


def _db_bytes(db: Path):
    return [Path(str(db) + s).read_bytes() for s in (".0", ".index", ".dbtype")]


@pytest.mark.parametrize("case", ["random", "negative_fractional",
                                  "inf_clipped", "huge", "int64_edge",
                                  "unclipped"])
def test_native_writer_equals_jax_python_writer(lib, tmp_path, case):
    hits, scores = _hits_scores(case)
    test_map, train_map = _maps()
    clip = case != "unclipped"
    queries = np.arange(N_TEST)
    tformat.write_prefilter_db(hits, tmp_path / "port", queries, scores,
                               test_map, train_map, clip=clip)
    jformat.write_prefilter_db(hits, tmp_path / "jax", queries, scores,
                               test_map, train_map, clip=clip)
    assert native.write_prefilter_native.calls == 1
    got, want = _db_bytes(tmp_path / "port"), _db_bytes(tmp_path / "jax")
    assert got == want
    assert want[0].count(b"\0") == N_TEST


def _python_route(monkeypatch):
    monkeypatch.setattr(native, "load", lambda: None)


@pytest.mark.parametrize("route", ["native", "python"])
@pytest.mark.parametrize("bad,clip,exc", [(np.nan, True, ValueError),
                                          (np.inf, False, OverflowError)])
def test_non_finite_scores_raise_on_both_routes(lib, tmp_path, monkeypatch,
                                                route, bad, clip, exc):
    hits, scores = _hits_scores("random")
    scores = scores.astype(np.float64)
    scores[5, 4], hits[5, 4] = bad, 3
    if route == "python":
        _python_route(monkeypatch)
    args = (np.arange(N_TEST), scores, *_maps())
    with pytest.raises(exc):
        tformat.write_prefilter_db(hits, tmp_path / "port", *args, clip=clip)
    with pytest.raises(exc):
        jformat.write_prefilter_db(hits, tmp_path / "jax", *args, clip=clip)
    assert native.write_prefilter_native.calls == (route == "native")


def _alignment_line(rng, n_cols=10):
    cols = [str(rng.randint(0, 10**6)), str(rng.randint(-50, 900)),
            f"{rng.rand():.3f}", f"{10.0 ** rng.uniform(-250, 2):.3E}",
            *(str(rng.randint(0, 3000)) for _ in range(6))]
    return "\t".join(cols[:n_cols]) + "\n"


EXTREME_E_VALUES = ["1e-400", "1E400", "5e-320", "2.2250738585072011e-308",
                    "+1.5", "-0", "inf", "-Infinity", "nan", " 3.0 ",
                    "1.7976931348623159e308"]


def _write_result_db(db: Path, layout: str):
    """A result DB of `layout`, the records written in index order: `split`
    spreads them over numbered data files (a sparse gap before the last
    record, as tests/test_interop.py's streaming test lays them out);
    `empty_records` mixes records with no line; `short_lines` mixes lines
    of 1-3 columns (prefilter format), trailing whitespace, \\r\\n and a
    last line without its newline (Python's parser drops it); `extremes`
    gives every line an E-value beyond the double range, subnormal,
    signed, infinite or NaN."""
    rng = np.random.RandomState({"split": 1, "empty_records": 2,
                                 "short_lines": 3, "extremes": 4}[layout])
    records = []
    for _ in range(40):
        n = rng.randint(0, 6)
        if layout == "extremes":
            lines = [_alignment_line(rng).split("\t") for _ in range(n + 1)]
            for line in lines:
                line[3] = EXTREME_E_VALUES[rng.randint(len(EXTREME_E_VALUES))]
            records.append("".join("\t".join(x) for x in lines).encode()
                           + b"\0")
            continue
        if layout == "empty_records" and rng.rand() < 0.5:
            n = 0
        lines = [_alignment_line(rng) for _ in range(n)]
        if layout == "short_lines":
            lines = [
                line if rng.rand() < 0.4
                else "\t".join(line.split("\t")[: rng.randint(1, 4)]) + "\n"
                for line in lines
            ]
            if lines:
                lines[0] = lines[0].replace("\n", " \r\n")
            if rng.rand() < 0.3:
                lines.append(_alignment_line(rng)[:-1])  # no newline
        records.append("".join(lines).encode() + b"\0")
    qids = iter(rng.permutation(len(records)) + 5)
    splits = [records]
    if layout == "split":  # .1 is empty, .3 starts with a sparse gap
        splits = [records[:15], [], records[15:39], records[39:]]
    index, offset = [], 0
    for i, part in enumerate(splits):
        with open(f"{db}.{i}", "wb") as fp:
            if i == 3:
                gap = 2**27  # no block of it is written
                fp.truncate(gap)
                fp.seek(gap)
                offset += gap
            for rec in part:
                fp.write(rec)
                index.append(f"{next(qids)}\t{offset}\t{len(rec)}\n")
                offset += len(rec)
    Path(f"{db}.index").write_text("".join(index))


def _assert_records_equal(got, want):
    np.testing.assert_array_equal(got[0], want[0])
    assert len(got[1]) == len(want[1]) == len(got[2]) == len(want[2])
    for a, b in zip(got[1], want[1]):
        assert a.dtype == b.dtype == np.int64
        np.testing.assert_array_equal(a, b)
    for a, b in zip(got[2], want[2]):
        assert a.dtype == b.dtype == np.float64
        np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("e_value_column", [3, 1])
@pytest.mark.parametrize("layout", ["split", "empty_records", "short_lines",
                                    "extremes"])
def test_native_reader_equals_jax_python_parser(lib, tmp_path, layout,
                                                e_value_column):
    db = tmp_path / "res"
    _write_result_db(db, layout)
    got = tformat.read_result_records(db, e_value_column)
    want = jformat.read_result_records(db, e_value_column)
    assert native.read_result_records_native.calls == 1
    _assert_records_equal(got, want)
    assert sum(len(t) for t in want[1]) > 40
    if layout == "empty_records":
        assert sum(len(t) == 0 for t in want[1]) >= 10


@pytest.mark.parametrize("line", [b"\n", b"x7\t1\t0\n", b"7\t1\t0x1p3\t0\n",
                                  b"7\t1\t\t0\n", b"+-7\t1\t0\n",
                                  b"7\t1\t1.5.2\t0\n"])
def test_native_reader_raises_where_python_does(lib, tmp_path, line):
    db = tmp_path / "bad"
    rec = b"3\t5\t1e-3\t9\n" + line + b"\0"
    Path(f"{db}.0").write_bytes(rec)
    Path(f"{db}.index").write_text(f"0\t0\t{len(rec)}\n")
    with pytest.raises(ValueError):
        jformat.read_result_records(db, 2)
    with pytest.raises(ValueError):
        tformat.read_result_records(db, 2)


def test_counters_show_the_native_route(lib, tmp_path):
    hits, scores = _hits_scores("random")
    tformat.write_prefilter_db(hits, tmp_path / "pf", np.arange(N_TEST),
                               scores, *_maps())
    tformat.read_result_records(tmp_path / "pf")
    tformat.read_result_records(tmp_path / "pf")
    assert native.write_prefilter_native.calls == 1
    assert native.read_result_records_native.calls == 2


def test_python_route_when_load_returns_none(lib, tmp_path, monkeypatch):
    hits, scores = _hits_scores("huge")
    args = (np.arange(N_TEST), scores, *_maps())
    tformat.write_prefilter_db(hits, tmp_path / "native", *args)
    native_records = tformat.read_result_records(tmp_path / "native")
    _python_route(monkeypatch)
    tformat.write_prefilter_db(hits, tmp_path / "python", *args)
    assert _db_bytes(tmp_path / "python") == _db_bytes(tmp_path / "native")
    _assert_records_equal(tformat.read_result_records(tmp_path / "python"),
                          native_records)
    assert native.write_prefilter_native.calls == 1
    assert native.read_result_records_native.calls == 1


def test_failed_build_warns_with_the_compiler_output(lib, tmp_path,
                                                     monkeypatch, caplog):
    monkeypatch.setattr(native, "_LIB", None)
    monkeypatch.setattr(native, "_TRIED", False)
    monkeypatch.setattr(native, "BUILD_DIR", tmp_path / "build")
    monkeypatch.setenv("CXX", "sh -c 'echo no-such-header >&2; exit 1' --")
    with caplog.at_level(logging.WARNING):
        assert native.load() is None
        assert native.load() is None
    warnings = [r for r in caplog.records if r.levelno == logging.WARNING]
    assert len(warnings) == 1 and "no-such-header" in warnings[0].getMessage()
    hits, scores = _hits_scores("random")
    tformat.write_prefilter_db(hits, tmp_path / "pf", np.arange(N_TEST),
                               scores, *_maps())
    assert native.write_prefilter_native.calls == 0
    assert not list((tmp_path / "build").glob("*"))


def test_library_lands_in_the_build_directory(lib):
    path = native.library_path()
    assert path.parent == ROOT / "build" / "torch_native"
    assert path.is_file() and path.name.startswith("libmmseqs_io_")
    package = Path(native.__file__).parent
    files = {p.name for p in package.iterdir() if p.name != "__pycache__"}
    assert files == {"__init__.py", "mmseqs_io.cpp"}
