"""Session-global string dictionary.

The device never sees a string (SURVEY.md §7 architecture stance): every
string value is encoded host-side to an int32 code.  Equality and hashing
work directly on codes.  Ordering uses a lazily-built *rank* array
(code -> rank of the string in sorted pool order) shipped to the device, so
ORDER BY / < / > on strings stay on-device.  String predicates with literal
arguments (STARTS WITH 'A', CONTAINS 'x', =~ regex) compile to boolean
lookup tables over the pool, applied as a gather.

Two implementations behave alike, code for code: :class:`StringPool`
in pure Python, and :class:`NativeStringPool` over the C++ host runtime
(``native/csrc/host_runtime.cpp``), which :func:`make_pool` gives unless
the caller opted out (``CAPS_TPU_NO_NATIVE=1``).  A failed native build
raises; it does not fall back to Python.
"""
from __future__ import annotations

import re
from typing import Any, Callable, Dict, List, Optional, Tuple

import numpy as np

NULL_CODE = -1


def make_pool() -> "StringPool":
    """The native pool (native/csrc/host_runtime.cpp), or the pure-Python
    one when the caller opted out of the native runtime."""
    from caps_tpu_torch import native
    lib = native.runtime()
    return StringPool() if lib is None else NativeStringPool(lib)


class StringPool:
    def __init__(self):
        self._strings: List[str] = []
        self._codes: Dict[str, int] = {}
        self._rank_version = -1
        self._rank: Optional[np.ndarray] = None
        # cache of the function lookup tables over the pool, keyed by
        # (fn_name, version)
        self._fn_luts: Dict[tuple, Any] = {}

    def __len__(self) -> int:
        return len(self._strings)

    @property
    def version(self) -> int:
        return len(self._strings)

    def encode(self, s: Optional[str]) -> int:
        if s is None:
            return NULL_CODE
        code = self._codes.get(s)
        if code is None:
            code = len(self._strings)
            self._codes[s] = code
            self._strings.append(s)
        return code

    def encode_many(self, values) -> np.ndarray:
        """Codes for a sequence of strings (None -> NULL_CODE).  A numpy
        string array is encoded once per distinct value, in order of
        first appearance — the codes a row-by-row encode would give."""
        if isinstance(values, np.ndarray) and values.dtype.kind in "US":
            uniq, first, inverse = np.unique(
                values, return_index=True, return_inverse=True)
            codes = np.empty(len(uniq), dtype=np.int32)
            for j in np.argsort(first, kind="stable"):
                codes[j] = self.encode(str(uniq[j]))
            return codes[inverse.reshape(-1)]
        return np.array([self.encode(v) for v in values], dtype=np.int32)

    def decode(self, code: int) -> Optional[str]:
        if code < 0:
            return None
        return self._strings[code]

    def decode_many(self, codes) -> List[Optional[str]]:
        strings = self._strings  # one read of the native pool's mirror
        return [None if c < 0 else strings[c] for c in
                (codes.tolist() if hasattr(codes, "tolist") else codes)]

    # -- memory accounting ---------------------------------------------------

    @property
    def nbytes(self) -> int:
        """Approximate host bytes of the interned strings plus index
        overhead — the memory ledger's ``mem.string_pool_bytes`` input
        (obs/ledger.py).  Rides the per-version ``lengths_array`` cache,
        so repeated gauge reads between interns are O(1)."""
        n = len(self)
        if not n:
            return 0
        try:
            return int(self.lengths_array().sum()) + 64 * n
        except Exception:  # pragma: no cover — accounting must not fail
            return 64 * n

    # -- failure containment -------------------------------------------------

    def mark(self) -> int:
        """Checkpoint for :meth:`rollback` — take one before an ingest
        that may fail (backends/cuda/table.py ``from_columns``)."""
        return self.version

    def rollback(self, mark: int) -> bool:
        """Discard every string interned after ``mark``: a failed ingest
        (device OOM mid-placement) must not leave its strings behind —
        the pool's size decides whether a group-by takes the dense
        kernel.  Returns True."""
        if mark >= len(self._strings):
            return True
        for s in self._strings[mark:]:
            self._codes.pop(s, None)
        del self._strings[mark:]
        self._rank_version = -1
        self._rank = None
        self._fn_luts.clear()
        return True

    # -- ordering -----------------------------------------------------------

    def rank_array(self) -> np.ndarray:
        """rank[code] orders codes like their strings; rebuilt when the pool
        has grown since the last build."""
        if self._rank_version != self.version:
            order = np.argsort(np.array(self._strings, dtype=object), kind="stable") \
                if self._strings else np.zeros(0, dtype=np.int64)
            rank = np.empty(len(self._strings), dtype=np.int32)
            rank[order] = np.arange(len(self._strings), dtype=np.int32)
            self._rank = rank
            self._rank_version = self.version
            self._fn_luts.clear()
        return self._rank

    # -- predicate / function lookup tables ---------------------------------

    def predicate_lut(self, fn: Callable[[str], bool]) -> np.ndarray:
        """Boolean table over all pool strings: lut[code] = fn(string)."""
        return np.array([bool(fn(s)) for s in self._strings], dtype=bool) \
            if self._strings else np.zeros(0, dtype=bool)

    def starts_with_lut(self, prefix: str) -> np.ndarray:
        return self.predicate_lut(lambda s: s.startswith(prefix))

    def ends_with_lut(self, suffix: str) -> np.ndarray:
        return self.predicate_lut(lambda s: s.endswith(suffix))

    def contains_lut(self, sub: str) -> np.ndarray:
        return self.predicate_lut(lambda s: sub in s)

    def regex_lut(self, pattern: str) -> np.ndarray:
        rx = re.compile(pattern)
        return self.predicate_lut(lambda s: rx.fullmatch(s) is not None)

    def map_lut(self, name: str, fn: Callable[[str], str]) -> np.ndarray:
        """int32 table mapping each code to the code of fn(string); new
        strings are added to the pool.  Cached per (name, pool version)."""
        key = (name, self.version)
        if key not in self._fn_luts:
            size = len(self._strings)
            out = np.empty(size, dtype=np.int32)
            for code in range(size):
                out[code] = self.encode(fn(self._strings[code]))
            self._fn_luts[key] = out
        return self._fn_luts[key]

    def value_lut(self, name: str, fn: Callable[[str], Any], dtype
                  ) -> Tuple[np.ndarray, np.ndarray]:
        """(values, ok) over all pool strings: values[code] = fn(string)
        of ``dtype``, ok False where fn gives None (a null).  Cached per
        (name, pool version)."""
        key = (name, self.version)
        if key not in self._fn_luts:
            vals = [fn(s) for s in self._strings]
            self._fn_luts[key] = (
                np.array([0 if v is None else v for v in vals], dtype=dtype),
                np.array([v is not None for v in vals], dtype=bool))
        return self._fn_luts[key]

    def map_codes(self, codes: np.ndarray, fn: Callable[[str], str]
                  ) -> np.ndarray:
        """int32 codes of fn(string) for each of ``codes``; new strings
        are added to the pool."""
        return np.array([self.encode(fn(self._strings[c]))
                         for c in codes.tolist()], dtype=np.int32)

    def list_codes(self, codes: np.ndarray,
                   fn: Callable[[str], List[str]]
                   ) -> Tuple[np.ndarray, np.ndarray]:
        """(codes, lens) of fn(string) for each of ``codes``
        (:meth:`string_lists`)."""
        return self.string_lists([fn(self._strings[c])
                                  for c in codes.tolist()])

    def string_lists(self, lists: List[List[str]]
                     ) -> Tuple[np.ndarray, np.ndarray]:
        """(codes, lens) of lists of strings: row i of the int32 matrix
        holds the codes of ``lists[i]``, left-aligned; new strings are
        added to the pool."""
        width = max([1] + [len(x) for x in lists])
        out = np.zeros((len(lists), width), dtype=np.int32)
        for i, x in enumerate(lists):
            out[i, :len(x)] = [self.encode(v) for v in x]
        return out, np.array([len(x) for x in lists], dtype=np.int32)

    def lengths_array(self) -> np.ndarray:
        """int64 table mapping each code to len(string); cached per pool
        version (rebuilding per query would stall on large pools)."""
        key = ("__lengths__", self.version)
        if key not in self._fn_luts:
            self._fn_luts[key] = np.array(
                [len(s) for s in self._strings], dtype=np.int64)
        return self._fn_luts[key]


class NativeStringPool(StringPool):
    """StringPool over the C++ host runtime: encoding (one string, a
    sequence, or a numpy ``<U`` array's raw buffer), the rank array and
    rollback run natively.  The LUT builders and decoding reuse the
    base class against ``_strings``, a list mirror of the native pool
    that catches up on the codes added since it was last read (one
    native call for all of them)."""

    def __init__(self, lib):
        self._lib = lib
        self._h = lib.pool_new()
        self._mirror: List[str] = []
        self._rank_version = -1
        self._rank: Optional[np.ndarray] = None
        self._fn_luts: Dict[tuple, Any] = {}

    def __del__(self):  # pragma: no cover - interpreter teardown timing
        try:
            self._lib.pool_free(self._h)
        except Exception:
            pass

    @property
    def _strings(self) -> List[str]:
        size = self._lib.pool_size(self._h)
        if len(self._mirror) < size:
            self._mirror.extend(self._lib.pool_get_range(
                self._h, len(self._mirror), size))
        return self._mirror

    def __len__(self) -> int:
        return self._lib.pool_size(self._h)

    @property
    def version(self) -> int:
        return self._lib.pool_size(self._h)

    def encode(self, s: Optional[str]) -> int:
        return self._lib.pool_encode1(self._h, s)

    def encode_many(self, values) -> np.ndarray:
        """Codes for a sequence of strings (None -> NULL_CODE), in one
        native call; a numpy ``<U`` array is encoded from its buffer."""
        if isinstance(values, np.ndarray) and values.dtype.kind == "U":
            arr = np.ascontiguousarray(values.reshape(-1))
            width = arr.dtype.itemsize // 4
            raw = self._lib.pool_encode_ucs4(
                self._h, arr.view(np.uint8) if arr.size else b"",
                arr.shape[0], width)
            return np.frombuffer(raw, dtype=np.int32)
        if isinstance(values, np.ndarray) and values.dtype.kind == "S":
            # str() of each bytes value, as the Python pool's np.unique
            # path encodes them
            values = [str(v) for v in values.reshape(-1).tolist()]
        elif not isinstance(values, (list, tuple)):
            values = list(values)
        raw = self._lib.pool_encode_many(self._h, values)
        return np.frombuffer(raw, dtype=np.int32)

    def rollback(self, mark: int) -> bool:
        if mark >= self.version:
            return True
        self._lib.pool_truncate(self._h, mark)
        del self._mirror[mark:]
        self._rank_version = -1
        self._rank = None
        self._fn_luts.clear()
        return True

    def rank_array(self) -> np.ndarray:
        if self._rank_version != self.version:
            self._rank = np.frombuffer(self._lib.pool_rank(self._h),
                                       dtype=np.int32).copy()
            self._rank_version = self.version
            self._fn_luts.clear()
        return self._rank
