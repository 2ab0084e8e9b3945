"""Multiset comparison of query results.

Mirrors the reference's ``Bag`` (ref: okapi-testing/.../Bag.scala;
SURVEY.md §4): result rows compare
order-insensitively with duplicates significant, which is exactly Cypher's
result semantics absent ORDER BY.
"""
from __future__ import annotations

from collections import Counter
from typing import Any, Iterable, Mapping


def _canon(v: Any) -> Any:
    from caps_tpu_torch.okapi.values import CypherNode, CypherRelationship
    if isinstance(v, CypherNode):
        return ("node", v.id, v.labels,
                tuple(sorted((k, _canon(x)) for k, x in v.properties.items())))
    if isinstance(v, CypherRelationship):
        return ("rel", v.id, v.start, v.end, v.rel_type,
                tuple(sorted((k, _canon(x)) for k, x in v.properties.items())))
    if isinstance(v, bool):
        return ("bool", v)
    if isinstance(v, float) and v == int(v):
        return ("num", int(v))  # 2.0 == 2 in Cypher comparisons
    if isinstance(v, int):
        return ("num", v)
    if isinstance(v, list):
        return ("list",) + tuple(_canon(x) for x in v)
    if isinstance(v, dict):
        return ("map",) + tuple(sorted((k, _canon(x)) for k, x in v.items()))
    return v


class Bag:
    def __init__(self, rows: Iterable[Mapping[str, Any]]):
        self.rows = list(rows)
        self._counter = Counter(
            tuple(sorted((k, _canon(v)) for k, v in r.items()))
            for r in self.rows)

    def __eq__(self, other) -> bool:
        if isinstance(other, Bag):
            return self._counter == other._counter
        if isinstance(other, (list, tuple)):
            return self == Bag(other)
        return NotImplemented

    def __len__(self) -> int:
        return len(self.rows)

    def __repr__(self) -> str:
        return f"Bag({self.rows!r})"

    def diff(self, other: "Bag") -> str:
        missing = self._counter - other._counter
        extra = other._counter - self._counter
        return f"missing={dict(missing)}\nextra={dict(extra)}"
