"""The port's native host runtime (caps_tpu_torch/native/,
native/csrc/host_runtime.cpp) against its pure-Python and numpy twins
and against the JAX package's native library.

One counterpart for each test of ``tests/test_native.py``: the C++ pool,
typed ingest and CSR build must give what the port's ``StringPool``,
Python ingest loop and numpy CSR give, bit for bit, and what the JAX
package's native library gives.  A failed build raises and does not
fall back to Python quietly.
"""
from __future__ import annotations

import os
import shutil

import numpy as np
import pytest
import torch

import caps_tpu_torch
from caps_tpu import native as jax_native
from caps_tpu_torch import native
from caps_tpu_torch.backends.cuda.pool import (
    NativeStringPool, StringPool, make_pool,
)
from caps_tpu_torch.okapi.types import (
    CTBoolean, CTFloat, CTInteger, CTNode, CTString,
)
from caps_tpu_torch.ops import expand as X

VALUES = ["b", "a", None, "b", "", "ü", "a" * 100, None, "z"]


@pytest.fixture(scope="module")
def lib():
    return native.runtime()


def pools(lib):
    return StringPool(), NativeStringPool(lib)


def test_pool_differential(lib):
    py, nat = pools(lib)
    pc = py.encode_many(VALUES)
    nc = nat.encode_many(VALUES)
    np.testing.assert_array_equal(pc, nc)
    assert len(py) == len(nat) and py.version == nat.version
    assert py.decode_many(pc) == nat.decode_many(nc) == VALUES
    np.testing.assert_array_equal(py.rank_array(), nat.rank_array())
    # a numpy string array: codes in order of first appearance, trailing
    # NULs stripped as numpy does, multi-byte code points
    arr = np.array(["b", "ab", "ü€𝄞", "", "b", "ab", "zz"])
    np.testing.assert_array_equal(py.encode_many(arr), nat.encode_many(arr))
    assert py._strings == nat._strings
    np.testing.assert_array_equal(py.rank_array(), nat.rank_array())
    if jax_native.available():
        from caps_tpu.backends.tpu.pool import NativeStringPool as JaxPool
        jp = JaxPool()
        np.testing.assert_array_equal(jp.encode_many(VALUES), nc[:9])
        np.testing.assert_array_equal(
            jp.rank_array(), _fresh_rank(lib, VALUES))


def _fresh_rank(lib, values):
    p = NativeStringPool(lib)
    p.encode_many(values)
    return p.rank_array()


def test_pool_single_encode_roundtrip(lib):
    nat = NativeStringPool(lib)
    a = nat.encode("x")
    assert nat.encode("x") == a
    assert nat.encode(None) == -1
    assert nat.decode(a) == "x"
    assert nat.decode(-1) is None
    py = StringPool()
    py.encode("x")
    assert nat.nbytes == py.nbytes and len(nat) == 1


def test_pool_luts_match(lib):
    py, nat = pools(lib)
    words = ["Apple", "apricot", "Banana", "avocado", "12", "x y"]
    py.encode_many(words)
    nat.encode_many(words)
    np.testing.assert_array_equal(py.starts_with_lut("a"),
                                  nat.starts_with_lut("a"))
    np.testing.assert_array_equal(py.contains_lut("an"),
                                  nat.contains_lut("an"))
    np.testing.assert_array_equal(py.regex_lut("a.*o"), nat.regex_lut("a.*o"))
    np.testing.assert_array_equal(
        py.map_lut("upper", str.upper), nat.map_lut("upper", str.upper))
    assert py.decode_many(py.map_lut("upper", str.upper)) == \
        nat.decode_many(nat.map_lut("upper", str.upper))
    for got, want in zip(nat.value_lut("len", len, np.int64),
                         py.value_lut("len", len, np.int64)):
        np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(py.lengths_array(), nat.lengths_array())
    codes = np.array([0, 2, 4], np.int32)
    np.testing.assert_array_equal(py.map_codes(codes, str.lower),
                                  nat.map_codes(codes, str.lower))
    for got, want in zip(nat.list_codes(codes, str.split),
                         py.list_codes(codes, str.split)):
        np.testing.assert_array_equal(got, want)
    assert py._strings == nat._strings and py.nbytes == nat.nbytes


def test_pool_mark_and_rollback(lib):
    """A failed ingest's strings go away in both pools alike: sizes,
    codes of later strings and ranks agree after the rollback."""
    py, nat = pools(lib)
    for p in (py, nat):
        p.encode_many(["a", "b"])
        p.rank_array()
        mark = p.mark()
        p.encode_many(["c", "d", "a"])
        assert p.rollback(mark) is True
        assert len(p) == 2 and p.version == mark
        assert p.encode("d") == 2
    assert py._strings == nat._strings
    np.testing.assert_array_equal(py.rank_array(), nat.rank_array())


def test_ingest_i64(lib):
    vals = [1, None, -5, 2**40, True]
    d, v = lib.ingest_i64(vals)
    np.testing.assert_array_equal(np.frombuffer(d, np.int64),
                                  [1, 0, -5, 2**40, 1])
    np.testing.assert_array_equal(np.frombuffer(v, np.uint8),
                                  [1, 0, 1, 1, 1])
    if jax_native.available():
        assert (d, v) == jax_native.lib.ingest_i64(vals)


def test_ingest_f64_and_bool(lib):
    d, v = lib.ingest_f64([1.5, None, 2])
    np.testing.assert_array_equal(np.frombuffer(d, np.float64),
                                  [1.5, 0.0, 2.0])
    d2, v2 = lib.ingest_bool([True, False, None, 1])
    np.testing.assert_array_equal(np.frombuffer(d2, np.uint8), [1, 0, 0, 1])
    np.testing.assert_array_equal(np.frombuffer(v2, np.uint8), [1, 1, 0, 1])
    if jax_native.available():
        assert (d, v) == jax_native.lib.ingest_f64([1.5, None, 2])
        assert (d2, v2) == jax_native.lib.ingest_bool([True, False, None, 1])


def test_ingest_rejects_bad_values(lib):
    with pytest.raises(TypeError):
        lib.ingest_i64([1, "nope"])


def test_csr_build_matches_numpy(lib, monkeypatch):
    rng = np.random.RandomState(0)
    n_nodes, n_edges = 50, 400
    src = rng.randint(0, n_nodes, n_edges).astype(np.int64)
    off_b, perm_b = lib.csr_build(src.tobytes(), n_edges, n_nodes)
    off = np.frombuffer(off_b, np.int64)
    perm = np.frombuffer(perm_b, np.int64)
    np.testing.assert_array_equal(off, np.concatenate(
        [[0], np.cumsum(np.bincount(src, minlength=n_nodes))]))
    np.testing.assert_array_equal(perm, np.argsort(src, kind="stable"))
    if jax_native.available():
        assert (off_b, perm_b) == jax_native.lib.csr_build(
            src.tobytes(), n_edges, n_nodes)
    # build_csr: the native counting sort and the numpy path agree bit
    # for bit, masked rows and a padded capacity included
    ok = rng.rand(n_edges) > 0.1
    nat = X.build_csr(src, ok, 512, "cpu")
    monkeypatch.setenv(native.OPT_OUT_ENV, "1")
    ref = X.build_csr(src, ok, 512, "cpu")
    assert nat.n_keys == ref.n_keys
    assert torch.equal(nat.indptr, ref.indptr)
    assert torch.equal(nat.perm, ref.perm)


def test_csr_build_rejects_out_of_range(lib):
    src = np.array([0, 9], np.int64)
    with pytest.raises(ValueError):
        lib.csr_build(src.tobytes(), 2, 5)


def test_ingest_i64_rejects_nonfinite_floats(lib):
    for bad in (float("nan"), float("inf"), float("-inf")):
        with pytest.raises((TypeError, ValueError, OverflowError)):
            lib.ingest_i64([1, bad])
    d, v = lib.ingest_i64([1, 2.0])  # finite floats still tolerated
    np.testing.assert_array_equal(np.frombuffer(d, np.int64), [1, 2])


def test_make_column_native_matches_python(monkeypatch):
    """Whole-table ingest parity: native on vs off, Python lists (the
    native converters, a numeric string they reject) and numpy string
    arrays, and the error an out-of-range id raises."""
    data = {"i": [1, None, 3], "f": [1.5, None, -2.0],
            "b": [True, None, False], "s": ["x", None, "y"],
            "u": np.array(["p", "q", "p"]), "n": ["4", 5, None],
            "d": [7, 8, None]}
    types = {"i": CTInteger, "f": CTFloat, "b": CTBoolean, "s": CTString,
             "u": CTString, "n": CTInteger, "d": CTInteger}

    def ingest():
        s = caps_tpu_torch.local_session(device="cpu")
        t = s.table_factory.from_columns(data, types)
        return (t.rows(), type(s.backend.pool).__name__,
                {c: t._cols[c].host[0].tolist() for c in data})

    rows1, kind1, host1 = ingest()
    monkeypatch.setenv(native.OPT_OUT_ENV, "1")
    rows2, kind2, host2 = ingest()
    assert (kind1, kind2) == ("NativeStringPool", "StringPool")
    assert rows1 == rows2 and host1 == host2
    from caps_tpu_torch.backends.cuda.column import make_column
    errors = []
    for opt_out in ("", "1"):
        monkeypatch.setenv(native.OPT_OUT_ENV, opt_out)
        with pytest.raises(ValueError) as ei:
            make_column([1, 2**33, None, -2**34], CTNode(), 4, make_pool(),
                        "cpu")
        errors.append(str(ei.value))
    assert errors[0] == errors[1] and str(2**33) in errors[0]


def test_failed_build_raises_and_does_not_fall_back(tmp_path, monkeypatch):
    """A source that does not compile raises NativeBuildError naming the
    compiler's error, from the loader and from every caller — the
    pool, ingest and CSR build do not quietly take Python."""
    broken = tmp_path / "host_runtime.cpp"
    shutil.copy(native._SRC, broken)
    with open(broken, "a") as f:
        f.write("\nthis is not C++;\n")
    with pytest.raises(native.NativeBuildError, match="error"):
        native.build(str(broken), so=str(tmp_path / "x.so"))
    assert not os.path.exists(tmp_path / "x.so")
    monkeypatch.setattr(native, "_SRC", str(broken))
    monkeypatch.setattr(native, "_BUILD_DIR", str(tmp_path / "_build"))
    monkeypatch.setattr(native, "_lib", None)
    with pytest.raises(native.NativeBuildError):
        native.runtime()
    with pytest.raises(native.NativeBuildError):
        make_pool()
    with pytest.raises(native.NativeBuildError):
        caps_tpu_torch.local_session(device="cpu")
    with pytest.raises(native.NativeBuildError):
        X.build_csr(np.array([0, 1]), np.array([True, True]), 4, "cpu")
    # opting out is the one way to the twins
    monkeypatch.setenv(native.OPT_OUT_ENV, "1")
    assert native.runtime() is None
    assert type(make_pool()) is StringPool
