"""Session-global string dictionary.

The device never sees a string (SURVEY.md §7 architecture stance): every
string value is encoded host-side to an int32 code.  Equality and hashing
work directly on codes.  Ordering uses a lazily-built *rank* array
(code -> rank of the string in sorted pool order) shipped to the device, so
ORDER BY / < / > on strings stay on-device.  String predicates with literal
arguments (STARTS WITH 'A', CONTAINS 'x', =~ regex) compile to boolean
lookup tables over the pool, applied as a gather.

The pure-Python pool of the JAX package; its native C++ pool is not
ported yet (ROADMAP).
"""
from __future__ import annotations

import re
from typing import Any, Callable, Dict, List, Optional, Tuple

import numpy as np

NULL_CODE = -1


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
        return [self.decode(int(c)) for c in codes]

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
        """(codes, lens) of fn(string) for each of ``codes``: row i of
        the int32 matrix holds the codes of the strings fn gives for
        ``codes[i]``, left-aligned; new strings are added to the pool."""
        lists = [fn(self._strings[c]) for c in codes.tolist()]
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
