"""TCK scenario loader + runner.

Parses the Gherkin subset the openCypher TCK actually uses — Feature /
Scenario, ``Given an empty graph``, ``And having executed`` docstrings,
``And parameters are`` tables, ``When executing query`` docstrings,
``Then the result should be (, in any order / in order / empty)`` tables,
``Then a <Error> should be raised`` — and runs each scenario through the
full engine stack, comparing result tables with TCK value semantics
(ref: okapi-tck ScenariosFor + opencypher/tck-api; SURVEY.md §4.3).

The port's runner differs from the JAX package's in one rule: an error
that says the port has not reached a feature yet (:func:`is_not_ported`)
never satisfies a scenario's error expectation; it raises
:class:`NotPorted`, and the scenario belongs on the port's list of
known gaps (``blacklists/cuda.txt``).
"""
from __future__ import annotations

import dataclasses
import os
from typing import Any, Dict, List, Optional, Tuple

from caps_tpu_torch.tck.values import parse_value, values_equal


@dataclasses.dataclass
class Expectation:
    kind: str                      # "rows" | "empty" | "error"
    ordered: bool = False
    columns: Tuple[str, ...] = ()
    rows: Tuple[Tuple[Any, ...], ...] = ()
    error: str = ""                # expected error class, e.g. SyntaxError


@dataclasses.dataclass
class Scenario:
    feature: str
    name: str
    create: Optional[str]          # "having executed" setup query (or None)
    params: Dict[str, Any]
    query: str
    expectation: Expectation

    @property
    def key(self) -> str:
        return f"{self.feature}::{self.name}"


class FeatureParseError(Exception):
    pass


def _parse_docstring(lines: List[str], i: int) -> Tuple[str, int]:
    if i >= len(lines) or lines[i].strip() != '"""':
        raise FeatureParseError(f'expected """ at line {i + 1}')
    i += 1
    body = []
    while True:
        if i >= len(lines):
            raise FeatureParseError("unterminated docstring")
        if lines[i].strip() == '"""':
            return " ".join(body).strip(), i + 1
        body.append(lines[i].strip())
        i += 1


def _parse_table(lines: List[str], i: int) -> Tuple[List[List[str]], int]:
    rows = []
    while i < len(lines) and lines[i].strip().startswith("|"):
        cells = [c.strip() for c in lines[i].strip().strip("|").split("|")]
        rows.append(cells)
        i += 1
    if not rows:
        raise FeatureParseError(f"expected a table at line {i + 1}")
    return rows, i


def parse_feature(text: str, feature_name: str = "") -> List[Scenario]:
    lines = text.splitlines()
    scenarios: List[Scenario] = []
    feature = feature_name
    i = 0
    cur: Optional[Dict[str, Any]] = None

    def finish():
        nonlocal cur
        if cur is None:
            return
        if "query" not in cur or "expect" not in cur:
            raise FeatureParseError(
                f"scenario {cur['name']!r} missing query or expectation")
        scenarios.append(Scenario(feature, cur["name"], cur.get("create"),
                                  cur.get("params", {}), cur["query"],
                                  cur["expect"]))
        cur = None

    while i < len(lines):
        line = lines[i].strip()
        if not line or line.startswith("#"):
            i += 1
        elif line.startswith("Feature:"):
            feature = line[len("Feature:"):].strip()
            i += 1
        elif line.startswith("Scenario:"):
            finish()
            cur = {"name": line[len("Scenario:"):].strip()}
            i += 1
        elif cur is None:
            raise FeatureParseError(f"unexpected line outside scenario: {line}")
        elif line in ("Given an empty graph", "Given any graph"):
            i += 1
        elif line in ("And having executed:", "Given having executed:"):
            doc, i = _parse_docstring(lines, i + 1)
            cur["create"] = (cur.get("create", "") + " " + doc).strip() \
                if cur.get("create") else doc
        elif line == "And parameters are:":
            table, i = _parse_table(lines, i + 1)
            cur["params"] = {r[0]: parse_value(r[1]) for r in table}
        elif line == "When executing query:":
            doc, i = _parse_docstring(lines, i + 1)
            cur["query"] = doc
        elif line.startswith("Then the result should be"):
            tail = line[len("Then the result should be"):].strip(" ,:")
            if tail == "empty":
                cur["expect"] = Expectation("empty")
                i += 1
            else:
                ordered = tail == "in order"
                if tail not in ("in any order", "in order", ""):
                    raise FeatureParseError(f"bad expectation: {line}")
                table, i = _parse_table(lines, i + 1)
                cols = tuple(table[0])
                rows = tuple(tuple(parse_value(c) for c in r)
                             for r in table[1:])
                cur["expect"] = Expectation("rows", ordered, cols, rows)
        elif line.startswith("Then a ") and "should be raised" in line:
            err = line[len("Then a "):].split()[0]
            cur["expect"] = Expectation("error", error=err)
            i += 1
        elif line == "And no side effects":
            i += 1  # accepted for upstream-corpus compatibility; a no-op
        else:
            raise FeatureParseError(f"unsupported step at line {i + 1}: {line}")
    finish()
    return scenarios


FEATURES_DIR = os.path.join(os.path.dirname(__file__), "features")


def load_features(directory: str = FEATURES_DIR) -> List[Scenario]:
    out: List[Scenario] = []
    for fname in sorted(os.listdir(directory)):
        if fname.endswith(".feature"):
            with open(os.path.join(directory, fname)) as f:
                out.extend(parse_feature(f.read(), fname))
    return out


def load_gaps(path: str) -> Dict[str, str]:
    """Scenario key -> the error it is listed for: one key per line, then
    `` # `` and the error's message; lines that start with '#' are
    comments (the reference's failing_blacklist resource format, with
    the cause inline)."""
    if not os.path.exists(path):
        return {}
    out: Dict[str, str] = {}
    with open(path) as f:
        for line in f:
            line = line.strip()
            if line and not line.startswith("#"):
                key, _, cause = line.partition(" # ")
                out[key.strip()] = cause.strip()
    return out


BLACKLIST = os.path.join(os.path.dirname(__file__), "blacklists", "cuda.txt")
SHARDED_BLACKLIST = os.path.join(os.path.dirname(__file__), "blacklists",
                                 "sharded.txt")


class TckFailure(AssertionError):
    pass


class NotPorted(Exception):
    """The scenario reached an operator or expression the port has no
    device path for yet (``UnsupportedOnDevice``) or a feature outside
    the ported slices (``NotImplementedError`` naming ROADMAP)."""


def is_not_ported(exc: BaseException) -> bool:
    """True for the port's two "not ported yet" errors.  Neither is the
    engine rejecting a query, so neither satisfies an error
    expectation."""
    from caps_tpu_torch.backends.cuda.expr import UnsupportedOnDevice
    return isinstance(exc, UnsupportedOnDevice) or (
        isinstance(exc, NotImplementedError) and "see ROADMAP" in str(exc))


def _rows_match(expect: Expectation, got: List[Dict[str, Any]]) -> bool:
    want = [dict(zip(expect.columns, r)) for r in expect.rows]
    if len(got) != len(want):
        return False
    if any(tuple(r.keys()) != expect.columns for r in got):
        return False
    if expect.ordered:
        return all(
            all(values_equal(w[c], g[c]) for c in expect.columns)
            for w, g in zip(want, got))
    remaining = list(got)
    for w in want:
        for k, g in enumerate(remaining):
            if all(values_equal(w[c], g[c]) for c in expect.columns):
                del remaining[k]
                break
        else:
            return False
    return True


def run_scenario(session, scenario: Scenario) -> None:
    """Execute one scenario; raises TckFailure on mismatch and NotPorted
    where the port has no path for it yet."""
    from caps_tpu_torch.testing.factory import create_graph
    expect = scenario.expectation
    try:
        graph = create_graph(session, scenario.create or "", {})
        result = graph.cypher(scenario.query, scenario.params)
        got = result.records.to_maps()
    except Exception as e:
        if is_not_ported(e):
            raise NotPorted(
                f"{scenario.key}: {type(e).__name__}: {e}") from e
        if expect.kind == "error":
            return  # any engine error satisfies a TCK error expectation class
        raise TckFailure(
            f"{scenario.key}: unexpected {type(e).__name__}: {e}") from e
    if expect.kind == "error":
        raise TckFailure(f"{scenario.key}: expected {expect.error}, "
                         f"got rows {got}")
    if expect.kind == "empty":
        if got:
            raise TckFailure(f"{scenario.key}: expected empty, got {got}")
        return
    if not _rows_match(expect, got):
        want = [dict(zip(expect.columns, r)) for r in expect.rows]
        raise TckFailure(f"{scenario.key}:\n  want {want}\n  got  {got}")
