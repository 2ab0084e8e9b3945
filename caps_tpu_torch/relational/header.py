"""RecordHeader: the bidirectional map between expressions and physical
columns.

Mirrors the reference's central data structure (ref:
okapi-relational/.../impl/table/RecordHeader.scala — reconstructed, mount
empty; SURVEY.md §2 "RecordHeader"): a node var owns an id column, one
boolean column per possible label, and one column per property; a rel var
owns id, source, target, type and property columns; value vars own a single
column.

Column naming is deterministic:

    Var(n)/Id(Var(n))        -> "n__id"        (entities)
    Var(x)                   -> "x"            (values)
    HasLabel(Var(n), "L")    -> "n__label_L"
    StartNode(Var(r))        -> "r__src"
    EndNode(Var(r))          -> "r__tgt"
    Type(Var(r))             -> "r__type"
    Property(Var(n), "k")    -> "n__prop_k"
    var-length rel hop i     -> "r__hop{i}"
"""
from __future__ import annotations

from typing import Dict, Iterable, List, Optional, Tuple

from caps_tpu_torch.ir import exprs as E
from caps_tpu_torch.okapi.schema import Schema
from caps_tpu_torch.okapi.types import (
    CTBoolean, CTInteger, CTList, CTNode, CTRelationship, CTString,
    CypherType, _CTNode, _CTRelationship,
)


class HeaderError(Exception):
    pass


def column_name_for(expr: E.Expr, entity_vars: Iterable[str]) -> str:
    """Deterministic column name for a mappable expression."""
    entity_vars = set(entity_vars)
    if isinstance(expr, E.Var):
        return f"{expr.name}__id" if expr.name in entity_vars else expr.name
    if isinstance(expr, E.Id) and isinstance(expr.entity, E.Var):
        return f"{expr.entity.name}__id"
    if isinstance(expr, E.HasLabel) and isinstance(expr.node, E.Var):
        return f"{expr.node.name}__label_{expr.label}"
    if isinstance(expr, E.StartNode) and isinstance(expr.rel, E.Var):
        return f"{expr.rel.name}__src"
    if isinstance(expr, E.EndNode) and isinstance(expr.rel, E.Var):
        return f"{expr.rel.name}__tgt"
    if isinstance(expr, E.Type) and isinstance(expr.rel, E.Var):
        return f"{expr.rel.name}__type"
    if isinstance(expr, E.Property) and isinstance(expr.entity, E.Var):
        return f"{expr.entity.name}__prop_{expr.key}"
    if isinstance(expr, E.PathSeg) and isinstance(expr.path, E.Var):
        return f"{expr.path.name}__seg{expr.index}"
    if isinstance(expr, E.PathNode) and isinstance(expr.path, E.Var):
        return f"{expr.path.name}__node{expr.index}"
    raise HeaderError(f"no canonical column name for {expr!r}")


class RecordHeader:
    """Immutable ordered mapping Expr -> (column, CypherType)."""

    def __init__(self, entries: Iterable[Tuple[E.Expr, str, CypherType]] = ()):
        self._entries: Tuple[Tuple[E.Expr, str, CypherType], ...] = tuple(entries)
        self._by_expr: Dict[E.Expr, Tuple[str, CypherType]] = {
            e: (c, t) for e, c, t in self._entries}
        cols: Dict[str, CypherType] = {}
        for _, c, t in self._entries:
            if c in cols:
                continue
            cols[c] = t
        self._col_types = cols
        if len(self._by_expr) != len(self._entries):
            raise HeaderError("duplicate expression in header")

    # -- queries ------------------------------------------------------------

    @property
    def exprs(self) -> Tuple[E.Expr, ...]:
        return tuple(e for e, _, _ in self._entries)

    @property
    def columns(self) -> Tuple[str, ...]:
        # unique, insertion order
        return tuple(self._col_types.keys())

    def has(self, expr: E.Expr) -> bool:
        return expr in self._by_expr

    def column(self, expr: E.Expr) -> str:
        if expr not in self._by_expr:
            raise HeaderError(f"expression {expr!r} not in header "
                              f"(has: {[str(e) for e in self.exprs]})")
        return self._by_expr[expr][0]

    def type_of(self, expr: E.Expr) -> CypherType:
        if expr not in self._by_expr:
            raise HeaderError(f"expression {expr!r} not in header")
        return self._by_expr[expr][1]

    def column_type(self, col: str) -> CypherType:
        return self._col_types[col]

    @property
    def entity_vars(self) -> Tuple[str, ...]:
        out = []
        for e, _, t in self._entries:
            if isinstance(e, E.Var) and isinstance(
                    t.material, (_CTNode, _CTRelationship)):
                out.append(e.name)
        return tuple(out)

    @property
    def composite_vars(self) -> Tuple[str, ...]:
        """Vars owning multiple columns: entity vars plus path vars."""
        from caps_tpu_torch.okapi.types import _CTPath
        out = list(self.entity_vars)
        for e, _, t in self._entries:
            if isinstance(e, E.Var) and isinstance(t.material, _CTPath):
                out.append(e.name)
        return tuple(out)

    @property
    def vars(self) -> Tuple[str, ...]:
        return tuple(e.name for e, _, _ in self._entries if isinstance(e, E.Var))

    def var_type(self, name: str) -> CypherType:
        return self.type_of(E.Var(name))

    def exprs_for(self, var: str) -> Tuple[E.Expr, ...]:
        """All expressions owned by ``var`` (the reference's
        ``expressionsFor``/``ownedBy``)."""
        out = []
        v = E.Var(var)
        for e, _, _ in self._entries:
            if e == v or any(c == v for c in e.walk()):
                out.append(e)
        return out and tuple(out) or ()

    # -- construction -------------------------------------------------------

    @staticmethod
    def empty() -> "RecordHeader":
        return RecordHeader()

    def with_expr(self, expr: E.Expr, cypher_type: CypherType,
                  column: Optional[str] = None) -> "RecordHeader":
        if expr in self._by_expr:
            return self
        if column is None:
            column = column_name_for(expr, self.entity_vars_guess(expr))
        return RecordHeader(self._entries + ((expr, column, cypher_type),))

    def entity_vars_guess(self, expr: E.Expr) -> Tuple[str, ...]:
        """Entity vars for naming purposes: current entities plus the var in
        ``expr`` if the expression itself declares entity structure."""
        names = set(self.entity_vars)
        if isinstance(expr, (E.Id, E.HasLabel, E.StartNode, E.EndNode, E.Type,
                             E.Property)):
            child = expr.children[0]
            if isinstance(child, E.Var):
                names.add(child.name)
        return tuple(names)

    def concat(self, other: "RecordHeader") -> "RecordHeader":
        """Disjoint union of two headers (the reference's ``++``)."""
        overlap = set(self._by_expr) & set(other._by_expr)
        if overlap:
            raise HeaderError(f"headers overlap on {overlap}")
        col_overlap = set(self.columns) & set(other.columns)
        if col_overlap:
            raise HeaderError(f"headers share columns {col_overlap}")
        return RecordHeader(self._entries + other._entries)

    def select(self, exprs: Iterable[E.Expr]) -> "RecordHeader":
        keep = []
        for e in exprs:
            if e not in self._by_expr:
                raise HeaderError(f"cannot select {e!r}: not in header")
            c, t = self._by_expr[e]
            keep.append((e, c, t))
        return RecordHeader(keep)

    def select_vars(self, names: Iterable[str]) -> "RecordHeader":
        """Keep every expression owned by the given vars, in header order."""
        names = set(names)
        keep = []
        for e, c, t in self._entries:
            evs = {v.name for v in E.vars_in(e)}
            if evs and evs <= names:
                keep.append((e, c, t))
        return RecordHeader(keep)

    def rename_var(self, old: str, new: str,
                   new_type: Optional[CypherType] = None) -> "RecordHeader":
        """Alias an entity/value var: rewrite owned expressions and rename
        their columns with the new prefix."""
        entries = []
        ov = E.Var(old)
        for e, c, t in self._entries:
            if ov in e.walk() or e == ov:
                ne = e.transform_down(lambda n: E.Var(new) if n == ov else n)
                if c == old:
                    nc = new
                elif c.startswith(f"{old}__"):
                    nc = f"{new}__" + c[len(old) + 2:]
                else:
                    nc = c
                nt = new_type if new_type is not None and e == ov else t
                entries.append((ne, nc, nt))
            else:
                entries.append((e, c, t))
        return RecordHeader(entries)

    # -- entity header builders --------------------------------------------

    @staticmethod
    def for_node(var: str, schema: Schema, labels: Iterable[str] = (),
                 nullable: bool = False) -> "RecordHeader":
        labels = frozenset(labels)
        combos = schema.combinations_for(labels)
        all_labels = sorted(set().union(*combos) if combos else labels)
        props = schema.node_property_keys(labels)
        v = E.Var(var)
        node_t: CypherType = CTNode(labels)
        if nullable:
            node_t = node_t.nullable
        entries: List[Tuple[E.Expr, str, CypherType]] = [
            (v, f"{var}__id", node_t)]
        for lbl in all_labels:
            entries.append((E.HasLabel(v, lbl), f"{var}__label_{lbl}",
                            CTBoolean.nullable if nullable else CTBoolean))
        for key in sorted(props):
            t = props[key].nullable if nullable else props[key]
            entries.append((E.Property(v, key), f"{var}__prop_{key}", t))
        return RecordHeader(entries)

    @staticmethod
    def for_relationship(var: str, schema: Schema,
                         rel_types: Iterable[str] = (),
                         nullable: bool = False) -> "RecordHeader":
        rel_types = frozenset(rel_types)
        effective = rel_types or schema.relationship_types
        props = schema.relationship_property_keys(rel_types)
        v = E.Var(var)
        rel_t: CypherType = CTRelationship(effective)
        int_t: CypherType = CTInteger
        str_t: CypherType = CTString
        if nullable:
            rel_t, int_t, str_t = rel_t.nullable, CTInteger.nullable, CTString.nullable
        entries: List[Tuple[E.Expr, str, CypherType]] = [
            (v, f"{var}__id", rel_t),
            (E.StartNode(v), f"{var}__src", int_t),
            (E.EndNode(v), f"{var}__tgt", int_t),
            (E.Type(v), f"{var}__type", str_t),
        ]
        for key in sorted(props):
            t = props[key].nullable if nullable else props[key]
            entries.append((E.Property(v, key), f"{var}__prop_{key}", t))
        return RecordHeader(entries)

    @staticmethod
    def for_value(var: str, cypher_type: CypherType) -> "RecordHeader":
        return RecordHeader([(E.Var(var), var, cypher_type)])

    # -- alignment (for unions) --------------------------------------------

    def union_target(self, other: "RecordHeader") -> "RecordHeader":
        """Header covering both inputs: union of expressions; types join;
        expressions present on one side only become nullable."""
        entries: List[Tuple[E.Expr, str, CypherType]] = []
        seen = set()
        for e, c, t in self._entries:
            if e in other._by_expr:
                _, t2 = other._by_expr[e]
                entries.append((e, c, t.join(t2)))
            else:
                entries.append((e, c, t.nullable))
            seen.add(e)
        for e, c, t in other._entries:
            if e in seen:
                continue
            entries.append((e, c, t.nullable))
        return RecordHeader(entries)

    # -- dunder -------------------------------------------------------------

    def __eq__(self, other):
        return isinstance(other, RecordHeader) and self._entries == other._entries

    def __hash__(self):
        return hash(self._entries)

    def __repr__(self):
        inner = ", ".join(f"{e.cypher_repr()}->{c}" for e, c, _ in self._entries)
        return f"RecordHeader({inner})"
