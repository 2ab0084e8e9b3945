"""The Cypher type lattice with nullability.

Mirrors the reference's ``CypherType`` family — CTNode(labels),
CTRelationship(types), scalar types, CTList(inner), CTMap, CTAny, CTNull,
CTVoid, with ``.nullable``/``.material`` and ``join``/``meet`` used for
schema inference (ref: okapi-api/.../api/types/CypherType.scala —
reconstructed, mount empty; SURVEY.md §2 "Type system").

Semantics carried over:
  * node label sets are conjunctive ("has all these labels"); join
    intersects them, meet unions them; the empty set means "any node".
  * relationship type sets are disjunctive ("one of these types"); join
    unions them, meet intersects; the empty set means "any relationship".
  * ``CTNull`` is the type of the literal null; joining it into a material
    type yields that type's nullable variant.
  * ``CTVoid`` is the bottom element (the type of an empty union).
  * ``CTInteger join CTFloat = CTNumber``.
"""
from __future__ import annotations

import dataclasses
from typing import FrozenSet, Iterable, Tuple


@dataclasses.dataclass(frozen=True)
class CypherType:
    is_nullable: bool = False

    # -- nullability --------------------------------------------------------

    @property
    def nullable(self) -> "CypherType":
        if self.is_nullable or isinstance(self, (_CTNull, _CTAny, _CTVoid)):
            return self
        return dataclasses.replace(self, is_nullable=True)

    @property
    def material(self) -> "CypherType":
        if isinstance(self, _CTAny):
            return self
        if isinstance(self, _CTNull):
            return CTVoid
        if not self.is_nullable:
            return self
        return dataclasses.replace(self, is_nullable=False)

    # -- lattice ------------------------------------------------------------

    def join(self, other: "CypherType") -> "CypherType":
        """Least upper bound of two types."""
        if self == other:
            return self
        if isinstance(self, _CTVoid):
            return other
        if isinstance(other, _CTVoid):
            return self
        if isinstance(self, _CTNull):
            return other.nullable
        if isinstance(other, _CTNull):
            return self.nullable
        if isinstance(self, _CTAny) or isinstance(other, _CTAny):
            return CTAny
        nullable = self.is_nullable or other.is_nullable
        joined = self.material._join_material(other.material)
        return joined.nullable if nullable else joined

    def _join_material(self, other: "CypherType") -> "CypherType":
        if self == other:
            return self
        if isinstance(self, _CTNode) and isinstance(other, _CTNode):
            return _CTNode(labels=self.labels & other.labels)
        if isinstance(self, _CTRelationship) and isinstance(other, _CTRelationship):
            if not self.rel_types or not other.rel_types:
                return _CTRelationship(rel_types=frozenset())
            return _CTRelationship(rel_types=self.rel_types | other.rel_types)
        if isinstance(self, _CTList) and isinstance(other, _CTList):
            return _CTList(inner=self.inner.join(other.inner))
        number = (_CTInteger, _CTFloat, _CTNumber)
        if isinstance(self, number) and isinstance(other, number):
            return CTNumber
        if isinstance(self, _CTMap) and isinstance(other, _CTMap):
            return CTMap
        return CTAny

    def meet(self, other: "CypherType") -> "CypherType":
        """Greatest lower bound of two types."""
        if self == other:
            return self
        if isinstance(self, _CTAny):
            return other
        if isinstance(other, _CTAny):
            return self
        if isinstance(self, _CTVoid) or isinstance(other, _CTVoid):
            return CTVoid
        if isinstance(self, _CTNull):
            return CTNull if other.is_nullable else CTVoid
        if isinstance(other, _CTNull):
            return CTNull if self.is_nullable else CTVoid
        nullable = self.is_nullable and other.is_nullable
        met = self.material._meet_material(other.material)
        return met.nullable if nullable else met

    def _meet_material(self, other: "CypherType") -> "CypherType":
        if self == other:
            return self
        if isinstance(self, _CTNode) and isinstance(other, _CTNode):
            return _CTNode(labels=self.labels | other.labels)
        if isinstance(self, _CTRelationship) and isinstance(other, _CTRelationship):
            if not self.rel_types:
                return other
            if not other.rel_types:
                return self
            common = self.rel_types & other.rel_types
            return _CTRelationship(rel_types=common) if common else CTVoid
        if isinstance(self, _CTNumber):
            if isinstance(other, (_CTInteger, _CTFloat)):
                return other
        if isinstance(other, _CTNumber):
            if isinstance(self, (_CTInteger, _CTFloat)):
                return self
        if isinstance(self, _CTList) and isinstance(other, _CTList):
            inner = self.inner.meet(other.inner)
            return _CTList(inner=inner)
        return CTVoid

    def subtype_of(self, other: "CypherType") -> bool:
        return self.join(other) == other

    def could_be(self, other: "CypherType") -> bool:
        return self.meet(other) != CTVoid

    # -- convenience --------------------------------------------------------

    @property
    def name(self) -> str:
        return type(self).__name__.lstrip("_")

    def __repr__(self) -> str:
        base = self._repr_material()
        return f"{base}?" if self.is_nullable else base

    def _repr_material(self) -> str:
        return self.name


@dataclasses.dataclass(frozen=True, repr=False)
class _CTVoid(CypherType):
    pass


@dataclasses.dataclass(frozen=True, repr=False)
class _CTNull(CypherType):
    is_nullable: bool = True


@dataclasses.dataclass(frozen=True, repr=False)
class _CTAny(CypherType):
    is_nullable: bool = True


@dataclasses.dataclass(frozen=True, repr=False)
class _CTBoolean(CypherType):
    pass


@dataclasses.dataclass(frozen=True, repr=False)
class _CTInteger(CypherType):
    pass


@dataclasses.dataclass(frozen=True, repr=False)
class _CTFloat(CypherType):
    pass


@dataclasses.dataclass(frozen=True, repr=False)
class _CTNumber(CypherType):
    pass


@dataclasses.dataclass(frozen=True, repr=False)
class _CTString(CypherType):
    pass


@dataclasses.dataclass(frozen=True, repr=False)
class _CTMap(CypherType):
    pass


@dataclasses.dataclass(frozen=True, repr=False)
class _CTPath(CypherType):
    pass


@dataclasses.dataclass(frozen=True, repr=False)
class _CTDate(CypherType):
    pass


@dataclasses.dataclass(frozen=True, repr=False)
class _CTDateTime(CypherType):
    pass


@dataclasses.dataclass(frozen=True, repr=False)
class _CTDuration(CypherType):
    pass


@dataclasses.dataclass(frozen=True, repr=False)
class _CTNode(CypherType):
    labels: FrozenSet[str] = frozenset()

    def _repr_material(self) -> str:
        if not self.labels:
            return "CTNode"
        return "CTNode(" + ":".join(sorted(self.labels)) + ")"


@dataclasses.dataclass(frozen=True, repr=False)
class _CTRelationship(CypherType):
    rel_types: FrozenSet[str] = frozenset()

    def _repr_material(self) -> str:
        if not self.rel_types:
            return "CTRelationship"
        return "CTRelationship(" + "|".join(sorted(self.rel_types)) + ")"


@dataclasses.dataclass(frozen=True, repr=False)
class _CTList(CypherType):
    inner: CypherType = None  # type: ignore[assignment]

    def _repr_material(self) -> str:
        return f"CTList({self.inner!r})"


# Singletons / constructors matching the reference's naming.
CTVoid = _CTVoid()
CTNull = _CTNull()
CTAny = _CTAny()
CTBoolean = _CTBoolean()
CTInteger = _CTInteger()
CTFloat = _CTFloat()
CTNumber = _CTNumber()
CTString = _CTString()
CTMap = _CTMap()
CTPath = _CTPath()
CTDate = _CTDate()
CTDateTime = _CTDateTime()
CTDuration = _CTDuration()


def CTNode(labels: Iterable[str] = ()) -> _CTNode:
    if isinstance(labels, str):
        labels = (labels,)
    return _CTNode(labels=frozenset(labels))


def CTRelationship(rel_types: Iterable[str] = ()) -> _CTRelationship:
    if isinstance(rel_types, str):
        rel_types = (rel_types,)
    return _CTRelationship(rel_types=frozenset(rel_types))


def CTList(inner: CypherType) -> _CTList:
    return _CTList(inner=inner)


def join_all(types: Iterable[CypherType]) -> CypherType:
    out: CypherType = CTVoid
    for t in types:
        out = out.join(t)
    return out


def parse_type(s: str) -> CypherType:
    """Inverse of ``repr``: parse "CTInteger?", "CTNode(A:B)",
    "CTList(CTString)" etc. (used by the fs data source's schema.json)."""
    s = s.strip()
    nullable = s.endswith("?")
    if nullable:
        s = s[:-1]
    simple = {
        "CTVoid": CTVoid, "CTNull": CTNull, "CTAny": CTAny,
        "CTBoolean": CTBoolean, "CTInteger": CTInteger, "CTFloat": CTFloat,
        "CTNumber": CTNumber, "CTString": CTString, "CTMap": CTMap,
        "CTPath": CTPath, "CTNode": _CTNode(), "CTRelationship": _CTRelationship(),
        "CTDate": CTDate, "CTDateTime": CTDateTime, "CTDuration": CTDuration,
    }
    if s in simple:
        t = simple[s]
    elif s.startswith("CTNode(") and s.endswith(")"):
        t = CTNode(s[len("CTNode("):-1].split(":"))
    elif s.startswith("CTRelationship(") and s.endswith(")"):
        t = CTRelationship(s[len("CTRelationship("):-1].split("|"))
    elif s.startswith("CTList(") and s.endswith(")"):
        t = CTList(parse_type(s[len("CTList("):-1]))
    else:
        raise ValueError(f"cannot parse CypherType {s!r}")
    return t.nullable if nullable else t


def from_python(value) -> CypherType:
    """Infer the CypherType of a plain Python value (literals, parameters)."""
    from caps_tpu_torch.okapi import values as v
    if value is None:
        return CTNull
    if isinstance(value, bool):
        return CTBoolean
    if isinstance(value, int):
        return CTInteger
    if isinstance(value, float):
        return CTFloat
    if isinstance(value, str):
        return CTString
    if isinstance(value, v.CypherDate):
        return CTDate
    if isinstance(value, v.CypherDateTime):
        return CTDateTime
    if isinstance(value, v.CypherDuration):
        return CTDuration
    if isinstance(value, v.CypherNode):
        return CTNode(value.labels)
    if isinstance(value, v.CypherRelationship):
        return CTRelationship((value.rel_type,))
    if isinstance(value, (list, tuple, v.CypherList)):
        return CTList(join_all(from_python(x) for x in value))
    if isinstance(value, (dict, v.CypherMap)):
        return CTMap
    raise TypeError(f"no CypherType for Python value of type {type(value)!r}")
