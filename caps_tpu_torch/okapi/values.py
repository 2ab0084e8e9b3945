"""Runtime Cypher values, including null semantics.

Mirrors the reference's value model: CypherValue, CypherMap, CypherList,
CypherNode, CypherRelationship and the primitives (ref:
okapi-api/.../api/value/CypherValue.scala — reconstructed, mount empty;
SURVEY.md §2 "Value model").

Python adaptation: primitives stay plain Python values (``None``, ``bool``,
``int``, ``float``, ``str``, ``list``, ``dict``) — wrapping every scalar
would fight the columnar backends.  The classes here cover the structured
values that appear in materialized results, plus the Cypher comparison /
equality / ordering helpers whose semantics differ from Python's
(3-valued logic, cross-type global sort order, null handling).
"""
from __future__ import annotations

import dataclasses
from typing import Any, Dict, Iterator, Mapping, Optional, Sequence, Tuple

# `CypherValue` as a concept = None | bool | int | float | str | list | dict
# | CypherNode | CypherRelationship.  Alias kept for API parity.
CypherValue = Any


class CypherList(list):
    """Marker subclass for lists produced by the engine (e.g. collect())."""


class CypherMap(dict):
    """Marker subclass for maps produced by the engine."""


@dataclasses.dataclass(frozen=True)
class CypherNode:
    """A materialized node: identity, labels, properties."""
    id: int
    labels: FrozenLabels = ()
    properties: Mapping[str, CypherValue] = dataclasses.field(default_factory=dict)

    def __post_init__(self):
        object.__setattr__(self, "labels", tuple(sorted(self.labels)))
        object.__setattr__(self, "properties", dict(self.properties))

    def __eq__(self, other):  # identity semantics, like the reference
        return isinstance(other, CypherNode) and other.id == self.id

    def __hash__(self):
        return hash(("node", self.id))

    def __repr__(self):
        lbl = "".join(f":{l}" for l in self.labels)
        props = ", ".join(f"{k}: {_repr_value(v)}" for k, v in sorted(self.properties.items()))
        return f"({lbl} {{{props}}})" if props else f"({lbl})"


@dataclasses.dataclass(frozen=True)
class CypherRelationship:
    """A materialized relationship: identity, endpoints, type, properties."""
    id: int
    start: int
    end: int
    rel_type: str = ""
    properties: Mapping[str, CypherValue] = dataclasses.field(default_factory=dict)

    def __post_init__(self):
        object.__setattr__(self, "properties", dict(self.properties))

    def __eq__(self, other):
        return isinstance(other, CypherRelationship) and other.id == self.id

    def __hash__(self):
        return hash(("rel", self.id))

    def __repr__(self):
        props = ", ".join(f"{k}: {_repr_value(v)}" for k, v in sorted(self.properties.items()))
        body = f":{self.rel_type}" + (f" {{{props}}}" if props else "")
        return f"[{body}]"


FrozenLabels = Tuple[str, ...]


@dataclasses.dataclass(frozen=True)
class CypherPath:
    """A materialized path: alternating nodes and relationships,
    ``len(nodes) == len(rels) + 1``.  Equality is by the node/rel id
    sequence (path identity), mirroring the reference's path value
    (ref: okapi-api value model — reconstructed, mount empty;
    SURVEY.md §2 "Value model")."""
    nodes: Tuple[CypherNode, ...]
    rels: Tuple["CypherRelationship", ...] = ()

    def __post_init__(self):
        object.__setattr__(self, "nodes", tuple(self.nodes))
        object.__setattr__(self, "rels", tuple(self.rels))
        if len(self.nodes) != len(self.rels) + 1:
            raise ValueError(
                f"path needs {len(self.rels) + 1} nodes, got {len(self.nodes)}")

    @property
    def length(self) -> int:
        return len(self.rels)

    def __eq__(self, other):
        return (isinstance(other, CypherPath)
                and tuple(n.id for n in other.nodes) == tuple(n.id for n in self.nodes)
                and tuple(r.id for r in other.rels) == tuple(r.id for r in self.rels))

    def __hash__(self):
        return hash(("path", tuple(n.id for n in self.nodes),
                     tuple(r.id for r in self.rels)))

    def __repr__(self):
        parts = [repr(self.nodes[0])]
        for i, rel in enumerate(self.rels):
            prev, nxt = self.nodes[i], self.nodes[i + 1]
            if rel.start == prev.id and rel.end == nxt.id:
                parts.append(f"-{rel!r}->")
            else:  # traversed against the stored orientation
                parts.append(f"<-{rel!r}-")
            parts.append(repr(nxt))
        return "<" + "".join(parts) + ">"


def _repr_value(v: CypherValue) -> str:
    if isinstance(v, str):
        return f"'{v}'"
    if v is None:
        return "null"
    if isinstance(v, bool):
        return "true" if v else "false"
    return repr(v)


# ---------------------------------------------------------------------------
# Temporal values (ref: okapi-api value model's
# temporal family — reconstructed, mount empty).  Minimal but real slice:
# calendar dates as epoch days, wall-clock datetimes (UTC, no zone) as
# epoch microseconds, durations as (months, days, seconds) components.
# Integer encodings make the device representation one int64 column.
# ---------------------------------------------------------------------------

_EPOCH_ORDINAL = 719_163  # datetime.date(1970, 1, 1).toordinal()


@dataclasses.dataclass(frozen=True)
class CypherDate:
    """Calendar date, stored as days since 1970-01-01 (int, may be
    negative)."""
    days: int

    @staticmethod
    def from_components(year: int, month: int = 1, day: int = 1) -> "CypherDate":
        import datetime as _dt
        return CypherDate(_dt.date(year, month, day).toordinal()
                          - _EPOCH_ORDINAL)

    @staticmethod
    def parse(s: str) -> "CypherDate":
        import datetime as _dt
        d = _dt.date.fromisoformat(s)
        return CypherDate(d.toordinal() - _EPOCH_ORDINAL)

    def _date(self):
        import datetime as _dt
        return _dt.date.fromordinal(self.days + _EPOCH_ORDINAL)

    @property
    def year(self) -> int:
        return self._date().year

    @property
    def month(self) -> int:
        return self._date().month

    @property
    def day(self) -> int:
        return self._date().day

    def iso(self) -> str:
        return self._date().isoformat()

    def plus(self, dur: "CypherDuration") -> "CypherDate":
        d = self._date()
        y, m = divmod(d.month - 1 + dur.months, 12)
        import calendar
        import datetime as _dt
        nd = min(d.day, calendar.monthrange(d.year + y, m + 1)[1])
        moved = _dt.date(d.year + y, m + 1, nd)
        # sub-day components truncate toward zero so +PT1S / -PT1S stay
        # symmetric on a date (floor would pull negatives back a full day)
        moved += _dt.timedelta(days=dur.days + int(dur.seconds / 86_400))
        return CypherDate(moved.toordinal() - _EPOCH_ORDINAL)

    def __repr__(self) -> str:
        return self.iso()


@dataclasses.dataclass(frozen=True)
class CypherDateTime:
    """Wall-clock datetime (UTC, zoneless), stored as microseconds since
    the 1970-01-01T00:00:00 epoch."""
    micros: int

    @staticmethod
    def from_components(year: int, month: int = 1, day: int = 1,
                        hour: int = 0, minute: int = 0, second: int = 0,
                        microsecond: int = 0) -> "CypherDateTime":
        import datetime as _dt
        dt = _dt.datetime(year, month, day, hour, minute, second,
                          microsecond)
        days = dt.date().toordinal() - _EPOCH_ORDINAL
        return CypherDateTime(
            days * 86_400_000_000
            + (dt.hour * 3600 + dt.minute * 60 + dt.second) * 1_000_000
            + dt.microsecond)

    @staticmethod
    def parse(s: str) -> "CypherDateTime":
        import datetime as _dt
        if s.endswith("Z") or s.endswith("z"):
            s = s[:-1] + "+00:00"
        dt = _dt.datetime.fromisoformat(s)
        if dt.tzinfo is not None:
            # normalize offset datetimes to the UTC instant (the engine's
            # datetimes are zoneless UTC wall clocks)
            dt = dt.astimezone(_dt.timezone.utc).replace(tzinfo=None)
        return CypherDateTime.from_components(
            dt.year, dt.month, dt.day, dt.hour, dt.minute, dt.second,
            dt.microsecond)

    def _datetime(self):
        import datetime as _dt
        days, rem = divmod(self.micros, 86_400_000_000)
        base = _dt.date.fromordinal(days + _EPOCH_ORDINAL)
        sec, us = divmod(rem, 1_000_000)
        h, rest = divmod(sec, 3600)
        m, s = divmod(rest, 60)
        return _dt.datetime(base.year, base.month, base.day, h, m, s, us)

    @property
    def year(self) -> int:
        return self._datetime().year

    @property
    def month(self) -> int:
        return self._datetime().month

    @property
    def day(self) -> int:
        return self._datetime().day

    @property
    def hour(self) -> int:
        return self._datetime().hour

    @property
    def minute(self) -> int:
        return self._datetime().minute

    @property
    def second(self) -> int:
        return self._datetime().second

    def date(self) -> CypherDate:
        return CypherDate(self.micros // 86_400_000_000)

    def plus(self, dur: "CypherDuration") -> "CypherDateTime":
        dt = self._datetime()
        y, m = divmod(dt.month - 1 + dur.months, 12)
        import calendar
        import datetime as _dt
        nd = min(dt.day, calendar.monthrange(dt.year + y, m + 1)[1])
        moved = dt.replace(year=dt.year + y, month=m + 1, day=nd)
        moved += _dt.timedelta(days=dur.days, seconds=dur.seconds)
        return CypherDateTime.from_components(
            moved.year, moved.month, moved.day, moved.hour, moved.minute,
            moved.second, moved.microsecond)

    def iso(self) -> str:
        return self._datetime().isoformat()

    def __repr__(self) -> str:
        return self.iso()


@dataclasses.dataclass(frozen=True)
class CypherDuration:
    """Duration as the Cypher component triple (months, days, seconds) —
    kept separate because months have no fixed length.  Not orderable
    (per openCypher); equality is componentwise."""
    months: int = 0
    days: int = 0
    seconds: int = 0

    @property
    def years_part(self) -> int:
        return self.months // 12

    def plus(self, other: "CypherDuration") -> "CypherDuration":
        return CypherDuration(self.months + other.months,
                              self.days + other.days,
                              self.seconds + other.seconds)

    def negate(self) -> "CypherDuration":
        return CypherDuration(-self.months, -self.days, -self.seconds)

    def iso(self) -> str:
        # components render with their own signs (Neo4j style, e.g.
        # 'PT-30S'); truncate toward zero so negatives don't borrow
        def tdiv(a: int, b: int):
            q = int(a / b)
            return q, a - q * b

        out = "P"
        if self.months:
            y, m = tdiv(self.months, 12)
            if y:
                out += f"{y}Y"
            if m:
                out += f"{m}M"
        if self.days:
            out += f"{self.days}D"
        if self.seconds:
            h, rest = tdiv(self.seconds, 3600)
            m, s = tdiv(rest, 60)
            out += "T"
            if h:
                out += f"{h}H"
            if m:
                out += f"{m}M"
            if s:
                out += f"{s}S"
        return out if out != "P" else "PT0S"

    def __repr__(self) -> str:
        return self.iso()


def temporal_construct(name: str, value=None):
    """Shared ``date()``/``datetime()``/``localdatetime()``/``duration()``
    constructor used by both expression evaluators and the graph factory.
    Accepts ISO strings, component maps, or an already-typed value; null
    propagates.  Raises ValueError on malformed input."""
    if value is None:
        raise ValueError(
            f"{name}() without an argument (current time) is "
            "non-deterministic and not supported; pass a string or map")
    name = name.lower()
    if name == "date":
        if isinstance(value, CypherDate):
            return value
        if isinstance(value, CypherDateTime):
            return value.date()
        if isinstance(value, str):
            return CypherDate.parse(value)
        if isinstance(value, Mapping):
            return CypherDate.from_components(
                int(value["year"]), int(value.get("month", 1)),
                int(value.get("day", 1)))
    elif name in ("datetime", "localdatetime"):
        if isinstance(value, CypherDateTime):
            return value
        if isinstance(value, CypherDate):
            return CypherDateTime(value.days * 86_400_000_000)
        if isinstance(value, str):
            return CypherDateTime.parse(value)
        if isinstance(value, Mapping):
            return CypherDateTime.from_components(
                int(value["year"]), int(value.get("month", 1)),
                int(value.get("day", 1)), int(value.get("hour", 0)),
                int(value.get("minute", 0)), int(value.get("second", 0)))
    elif name == "duration":
        if isinstance(value, CypherDuration):
            return value
        if isinstance(value, str):
            return _parse_iso_duration(value)
        if isinstance(value, Mapping):
            months = int(value.get("years", 0)) * 12 \
                + int(value.get("months", 0))
            days = int(value.get("weeks", 0)) * 7 + int(value.get("days", 0))
            seconds = (int(value.get("hours", 0)) * 3600
                       + int(value.get("minutes", 0)) * 60
                       + int(value.get("seconds", 0)))
            return CypherDuration(months, days, seconds)
    raise ValueError(f"cannot construct {name}() from {value!r}")


def _parse_iso_duration(s: str) -> CypherDuration:
    import re as _re
    m = _re.fullmatch(
        r"P(?:(\d+)Y)?(?:(\d+)M)?(?:(\d+)W)?(?:(\d+)D)?"
        r"(?:T(?:(\d+)H)?(?:(\d+)M)?(?:(\d+)S)?)?", s)
    if m is None or s in ("P", "PT"):
        raise ValueError(f"malformed ISO-8601 duration {s!r}")
    y, mo, w, d, h, mi, sec = (int(g) if g else 0 for g in m.groups())
    return CypherDuration(y * 12 + mo, w * 7 + d,
                          h * 3600 + mi * 60 + sec)


_TEMPORAL_FIELDS = {
    CypherDate: {"year": "year", "month": "month", "day": "day"},
    CypherDateTime: {"year": "year", "month": "month", "day": "day",
                     "hour": "hour", "minute": "minute", "second": "second"},
}


def temporal_component(v, key: str):
    """``.year``/``.month``/... accessor on a temporal value (None when
    the component doesn't exist on that type)."""
    if isinstance(v, CypherDuration):
        k = key.lower()
        if k == "months":
            return v.months
        if k == "years":
            return v.months // 12
        if k == "days":
            return v.days
        if k == "seconds":
            return v.seconds
        if k == "hours":
            return v.seconds // 3600
        if k == "minutes":
            return v.seconds // 60
        return None
    fields = _TEMPORAL_FIELDS.get(type(v))
    if fields is None or key.lower() not in fields:
        return None
    return getattr(v, fields[key.lower()])


def is_temporal(v) -> bool:
    return isinstance(v, (CypherDate, CypherDateTime, CypherDuration))


# ---------------------------------------------------------------------------
# Cypher semantics helpers (3-valued logic, equality, global ordering)
# ---------------------------------------------------------------------------

def cypher_equals(a: CypherValue, b: CypherValue) -> Optional[bool]:
    """Cypher `=`: returns True/False/None (null) with 3-valued semantics."""
    if a is None or b is None:
        return None
    if isinstance(a, CypherNode) or isinstance(b, CypherNode):
        return isinstance(a, CypherNode) and isinstance(b, CypherNode) and a.id == b.id
    if isinstance(a, CypherRelationship) or isinstance(b, CypherRelationship):
        return (isinstance(a, CypherRelationship)
                and isinstance(b, CypherRelationship) and a.id == b.id)
    if isinstance(a, CypherPath) or isinstance(b, CypherPath):
        return isinstance(a, CypherPath) and isinstance(b, CypherPath) and a == b
    if isinstance(a, bool) or isinstance(b, bool):
        return isinstance(a, bool) and isinstance(b, bool) and a == b
    if isinstance(a, (CypherDate, CypherDateTime, CypherDuration)) \
            or isinstance(b, (CypherDate, CypherDateTime, CypherDuration)):
        return type(a) is type(b) and a == b
    if isinstance(a, (int, float)) and isinstance(b, (int, float)):
        return a == b  # Python int/float comparison is exact, no precision loss
    if isinstance(a, str) and isinstance(b, str):
        return a == b
    if isinstance(a, (list, tuple)) and isinstance(b, (list, tuple)):
        if len(a) != len(b):
            return False
        out: Optional[bool] = True
        for x, y in zip(a, b):
            e = cypher_equals(x, y)
            if e is False:
                return False
            if e is None:
                out = None
        return out
    if isinstance(a, dict) and isinstance(b, dict):
        if set(a) != set(b):
            return False
        out = True
        for k in a:
            e = cypher_equals(a[k], b[k])
            if e is False:
                return False
            if e is None:
                out = None
        return out
    return False


_ORDER_RANK = {
    "map": 0, "node": 1, "rel": 2, "list": 3, "path": 3.5, "str": 4,
    "bool": 5, "num": 6, "datetime": 6.2, "date": 6.4, "duration": 6.6,
    "null": 7,
}


def _order_key(v: CypherValue) -> Tuple:
    """Total order over all Cypher values (for ORDER BY): per openCypher,
    within-type natural order; nulls sort last in ascending order."""
    if v is None:
        return (_ORDER_RANK["null"],)
    if isinstance(v, bool):
        return (_ORDER_RANK["bool"], v)
    if isinstance(v, (int, float)):
        return (_ORDER_RANK["num"], v)  # int/float cross-compare exactly
    if isinstance(v, str):
        return (_ORDER_RANK["str"], v)
    if isinstance(v, CypherNode):
        return (_ORDER_RANK["node"], v.id)
    if isinstance(v, CypherRelationship):
        return (_ORDER_RANK["rel"], v.id)
    if isinstance(v, CypherPath):
        return (_ORDER_RANK["path"], tuple(n.id for n in v.nodes),
                tuple(r.id for r in v.rels))
    if isinstance(v, CypherDate):
        return (_ORDER_RANK["date"], v.days)
    if isinstance(v, CypherDateTime):
        return (_ORDER_RANK["datetime"], v.micros)
    if isinstance(v, CypherDuration):
        # durations are not comparable in Cypher; a deterministic ORDER BY
        # key is still required — component tuple
        return (_ORDER_RANK["duration"], v.months, v.days, v.seconds)
    if isinstance(v, (list, tuple)):
        return (_ORDER_RANK["list"], tuple(_order_key(x) for x in v))
    if isinstance(v, dict):
        return (_ORDER_RANK["map"], tuple(sorted((k, _order_key(x)) for k, x in v.items())))
    raise TypeError(f"unorderable value {v!r}")


def order_key(v: CypherValue) -> Tuple:
    """Sort key for one ORDER BY item; descending order is realized by the
    caller via per-item ``reverse=True`` in a multi-pass stable sort."""
    return _order_key(v)


def cypher_lt(a: CypherValue, b: CypherValue) -> Optional[bool]:
    """Cypher `<`: null if either operand is null or the types are not
    comparable (number vs string etc.)."""
    if a is None or b is None:
        return None
    a_num = isinstance(a, (int, float)) and not isinstance(a, bool)
    b_num = isinstance(b, (int, float)) and not isinstance(b, bool)
    if a_num and b_num:
        return a < b
    if isinstance(a, str) and isinstance(b, str):
        return a < b
    if isinstance(a, bool) and isinstance(b, bool):
        return a < b
    if isinstance(a, CypherDate) and isinstance(b, CypherDate):
        return a.days < b.days
    if isinstance(a, CypherDateTime) and isinstance(b, CypherDateTime):
        return a.micros < b.micros
    if isinstance(a, (list, tuple)) and isinstance(b, (list, tuple)):
        for x, y in zip(a, b):
            lt = cypher_lt(x, y)
            if lt is None:
                return None
            if lt:
                return True
            gt = cypher_lt(y, x)
            if gt is None:
                return None
            if gt:
                return False
        return len(a) < len(b)
    return None


def is_truthy(v: Optional[bool]) -> bool:
    """WHERE keeps a row iff the predicate is exactly true (null drops)."""
    return v is True
