"""The expression tree.

Mirrors the reference's okapi ``Expr`` family — Var, Param, Property,
HasLabel, HasType, Id, StartNode, EndNode, Equals, Ands/Ors/Not, arithmetic,
FunctionExpr, Aggregators (ref: okapi-ir/.../ir/api/expr/Expr.scala —
reconstructed, mount empty; SURVEY.md §2 "IR").

One expression tree is used from the parser all the way into
``RecordHeader`` column keys (the reference does the same from IR down;
its separate front-end AST exprs existed only because the parser was an
external dependency).  Variables are name-based; types are computed on
demand by :mod:`caps_tpu.ir.typer` against a type environment.

Every expression is a frozen dataclass on :class:`TreeNode`, so structural
equality/hashing works and headers can key on expressions.
"""
from __future__ import annotations

import dataclasses
from typing import Any, ClassVar, Optional, Tuple

from caps_tpu_torch.okapi.trees import TreeNode


@dataclasses.dataclass(frozen=True)
class Expr(TreeNode):
    """Base expression node."""

    def cypher_repr(self) -> str:
        return str(self)


# -- leaves -----------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class Var(Expr):
    name: str

    def cypher_repr(self) -> str:
        return self.name


@dataclasses.dataclass(frozen=True)
class Param(Expr):
    name: str

    def cypher_repr(self) -> str:
        return f"${self.name}"


@dataclasses.dataclass(frozen=True)
class Lit(Expr):
    """Literal: None | bool | int | float | str (lists via ListLit)."""
    value: Any

    def cypher_repr(self) -> str:
        if self.value is None:
            return "null"
        if isinstance(self.value, bool):
            return "true" if self.value else "false"
        if isinstance(self.value, str):
            return f"'{self.value}'"
        return repr(self.value)


NULL = Lit(None)
TRUE = Lit(True)
FALSE = Lit(False)


@dataclasses.dataclass(frozen=True)
class ListLit(Expr):
    items: Tuple[Expr, ...]


@dataclasses.dataclass(frozen=True)
class MapLit(Expr):
    keys: Tuple[str, ...]
    values: Tuple[Expr, ...]


# -- entity accessors -------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class Property(Expr):
    entity: Expr
    key: str

    def cypher_repr(self) -> str:
        return f"{self.entity.cypher_repr()}.{self.key}"


@dataclasses.dataclass(frozen=True)
class HasLabel(Expr):
    node: Expr
    label: str

    def cypher_repr(self) -> str:
        return f"{self.node.cypher_repr()}:{self.label}"


@dataclasses.dataclass(frozen=True)
class HasType(Expr):
    rel: Expr
    rel_type: str

    def cypher_repr(self) -> str:
        return f"type({self.rel.cypher_repr()}) = '{self.rel_type}'"


@dataclasses.dataclass(frozen=True)
class Id(Expr):
    entity: Expr


@dataclasses.dataclass(frozen=True)
class StartNode(Expr):
    rel: Expr


@dataclasses.dataclass(frozen=True)
class EndNode(Expr):
    rel: Expr


@dataclasses.dataclass(frozen=True)
class Labels(Expr):
    node: Expr


@dataclasses.dataclass(frozen=True)
class Type(Expr):
    rel: Expr


@dataclasses.dataclass(frozen=True)
class Keys(Expr):
    entity: Expr


@dataclasses.dataclass(frozen=True)
class Properties(Expr):
    entity: Expr


# -- paths ------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class PathExpr(Expr):
    """Defining expression of a named path ``p = (a)-[r]->(b)...``: the
    constituent entity vars in pattern order.  ``nodes[i]`` / ``rels[i]``
    are the bound node / rel vars; ``varlen[i]`` marks rel positions bound
    to relationship LISTS (var-length segments).  Never reaches a backend:
    the relational ProjectOp lowers it to path-owned id columns (ref:
    front-end ``PathExpression``† — reconstructed, mount empty;
    SURVEY.md §2 "IR")."""
    nodes: Tuple[Expr, ...]
    rels: Tuple[Expr, ...] = ()
    varlen: Tuple[bool, ...] = ()

    def cypher_repr(self) -> str:
        return "path(...)"


@dataclasses.dataclass(frozen=True)
class PathSeg(Expr):
    """Relationship (or rel-list) at hop ``index`` of a projected path
    var — header-resident column, like StartNode/EndNode for rels."""
    path: Expr
    index: int
    is_varlen: bool = False


@dataclasses.dataclass(frozen=True)
class PathNode(Expr):
    """Node id at position ``index`` of a projected fixed-length path."""
    path: Expr
    index: int


@dataclasses.dataclass(frozen=True)
class PathNodes(Expr):
    """Node-id sequence of a (possibly var-length) named path,
    reconstructed at evaluation time by walking each hop's relationship
    endpoints — the expression form of the var-length path
    materialization in ``relational/session.py``.  ``pieces[i]`` yields
    hop ``i``'s relationship id (or rel-id list when ``is_list[i]``)."""
    start: Expr
    pieces: Tuple[Expr, ...]
    is_list: Tuple[bool, ...]

    def cypher_repr(self) -> str:
        return "nodes(<path>)"


# -- boolean (3-valued) -----------------------------------------------------

@dataclasses.dataclass(frozen=True)
class Ands(Expr):
    exprs: Tuple[Expr, ...]

    def cypher_repr(self) -> str:
        return " AND ".join(e.cypher_repr() for e in self.exprs)


@dataclasses.dataclass(frozen=True)
class Ors(Expr):
    exprs: Tuple[Expr, ...]

    def cypher_repr(self) -> str:
        return " OR ".join(e.cypher_repr() for e in self.exprs)


@dataclasses.dataclass(frozen=True)
class Xor(Expr):
    lhs: Expr
    rhs: Expr


@dataclasses.dataclass(frozen=True)
class Not(Expr):
    expr: Expr

    def cypher_repr(self) -> str:
        return f"NOT {self.expr.cypher_repr()}"


@dataclasses.dataclass(frozen=True)
class IsNull(Expr):
    expr: Expr


@dataclasses.dataclass(frozen=True)
class IsNotNull(Expr):
    expr: Expr


# -- comparison -------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class BinaryExpr(Expr):
    lhs: Expr
    rhs: Expr

    op: ClassVar[str] = "?"

    def cypher_repr(self) -> str:
        return f"{self.lhs.cypher_repr()} {self.op} {self.rhs.cypher_repr()}"


@dataclasses.dataclass(frozen=True)
class Equals(BinaryExpr):
    op = "="


@dataclasses.dataclass(frozen=True)
class NotEquals(BinaryExpr):
    op = "<>"


@dataclasses.dataclass(frozen=True)
class LessThan(BinaryExpr):
    op = "<"


@dataclasses.dataclass(frozen=True)
class LessThanOrEqual(BinaryExpr):
    op = "<="


@dataclasses.dataclass(frozen=True)
class GreaterThan(BinaryExpr):
    op = ">"


@dataclasses.dataclass(frozen=True)
class GreaterThanOrEqual(BinaryExpr):
    op = ">="


@dataclasses.dataclass(frozen=True)
class In(BinaryExpr):
    op = "IN"


@dataclasses.dataclass(frozen=True)
class Disjoint(BinaryExpr):
    """True iff the two list operands share no element — planner-internal,
    emitted for relationship-uniqueness between two var-length rel lists
    in one MATCH pattern (Cypher edge isomorphism; no surface syntax)."""
    op = "DISJOINT"


@dataclasses.dataclass(frozen=True)
class ExistsSubQuery(Expr):
    """``EXISTS { [MATCH] <pattern> [WHERE expr] }`` — true iff the pattern
    has at least one match extending the current row (ref: okapi-logical
    ExistsSubQuery — reconstructed, mount empty; SURVEY.md §2).

    Two-stage payload: the parser stores the clause-AST pattern in
    ``pattern`` with the raw WHERE in ``where``; IRBuilder replaces it
    with a node holding the IR ``Pattern`` and the full typed predicate
    tuple (inline property maps + WHERE) in ``predicates``.  The logical
    planner lowers it to a row-id semi-join and never lets it reach a
    backend."""
    pattern: object
    where: Optional["Expr"] = None
    predicates: Tuple["Expr", ...] = ()

    def outer_free_vars(self) -> Tuple[str, ...]:
        """Outer-scope variable names this subquery depends on (IR-stage
        only; parser-stage nodes are resolved before anyone needs this)."""
        bound = getattr(self.pattern, "bound", ())
        entities = getattr(self.pattern, "entities", ())
        local = {f.name for f in entities}
        names = list(bound)
        for p in self.predicates:
            for v in vars_in(p):
                if v.name not in local and v.name not in names:
                    names.append(v.name)
        return tuple(names)

    def cypher_repr(self) -> str:
        return "EXISTS { ... }"


@dataclasses.dataclass(frozen=True)
class StartsWith(BinaryExpr):
    op = "STARTS WITH"


@dataclasses.dataclass(frozen=True)
class EndsWith(BinaryExpr):
    op = "ENDS WITH"


@dataclasses.dataclass(frozen=True)
class Contains(BinaryExpr):
    op = "CONTAINS"


@dataclasses.dataclass(frozen=True)
class RegexMatch(BinaryExpr):
    op = "=~"


# -- arithmetic -------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class Add(BinaryExpr):
    op = "+"


@dataclasses.dataclass(frozen=True)
class Subtract(BinaryExpr):
    op = "-"


@dataclasses.dataclass(frozen=True)
class Multiply(BinaryExpr):
    op = "*"


@dataclasses.dataclass(frozen=True)
class Divide(BinaryExpr):
    op = "/"


@dataclasses.dataclass(frozen=True)
class Modulo(BinaryExpr):
    op = "%"


@dataclasses.dataclass(frozen=True)
class Power(BinaryExpr):
    op = "^"


@dataclasses.dataclass(frozen=True)
class Negate(Expr):
    expr: Expr


# -- containers / access ----------------------------------------------------

@dataclasses.dataclass(frozen=True)
class Index(Expr):
    """``expr[idx]`` — list index or map key access."""
    expr: Expr
    idx: Expr


@dataclasses.dataclass(frozen=True)
class Slice(Expr):
    expr: Expr
    lower: Optional[Expr]
    upper: Optional[Expr]


@dataclasses.dataclass(frozen=True)
class ListComprehension(Expr):
    """``[var IN list WHERE pred | proj]``."""
    var: str
    list_expr: Expr
    predicate: Optional[Expr]
    projection: Optional[Expr]

    def cypher_repr(self) -> str:
        out = f"[{self.var} IN {self.list_expr.cypher_repr()}"
        if self.predicate is not None:
            out += f" WHERE {self.predicate.cypher_repr()}"
        if self.projection is not None:
            out += f" | {self.projection.cypher_repr()}"
        return out + "]"


@dataclasses.dataclass(frozen=True)
class QuantifiedPredicate(Expr):
    """``all/any/none/single(var IN list WHERE pred)`` with openCypher
    3-valued semantics (ref: front-end ``IterablePredicateExpression``
    family — reconstructed, mount empty; SURVEY.md §2 "Cypher front-end")."""
    kind: str  # 'all' | 'any' | 'none' | 'single'
    var: str
    list_expr: Expr
    predicate: Expr

    def cypher_repr(self) -> str:
        return (f"{self.kind}({self.var} IN {self.list_expr.cypher_repr()} "
                f"WHERE {self.predicate.cypher_repr()})")


@dataclasses.dataclass(frozen=True)
class Reduce(Expr):
    """``reduce(acc = init, var IN list | expr)``."""
    acc: str
    init: Expr
    var: str
    list_expr: Expr
    expr: Expr

    def cypher_repr(self) -> str:
        return (f"reduce({self.acc} = {self.init.cypher_repr()}, {self.var} "
                f"IN {self.list_expr.cypher_repr()} | "
                f"{self.expr.cypher_repr()})")


# -- case -------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class CaseExpr(Expr):
    """Generic CASE WHEN p THEN v ... ELSE d END.  Simple form
    ``CASE e WHEN v THEN r`` is normalized to ``WHEN e = v THEN r`` by the
    parser."""
    conditions: Tuple[Expr, ...]
    values: Tuple[Expr, ...]
    default: Optional[Expr]


# -- functions --------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class FunctionExpr(Expr):
    """A non-aggregating function invocation, name-resolved at plan time."""
    name: str
    args: Tuple[Expr, ...]

    def cypher_repr(self) -> str:
        return f"{self.name}({', '.join(a.cypher_repr() for a in self.args)})"


@dataclasses.dataclass(frozen=True)
class Exists(Expr):
    """``exists(n.prop)``."""
    expr: Expr


@dataclasses.dataclass(frozen=True)
class Coalesce(Expr):
    exprs: Tuple[Expr, ...]


# -- aggregators ------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class Aggregator(Expr):
    pass


@dataclasses.dataclass(frozen=True)
class CountStar(Aggregator):
    def cypher_repr(self) -> str:
        return "count(*)"


@dataclasses.dataclass(frozen=True)
class Count(Aggregator):
    expr: Expr
    distinct: bool = False


@dataclasses.dataclass(frozen=True)
class Sum(Aggregator):
    expr: Expr
    distinct: bool = False


@dataclasses.dataclass(frozen=True)
class Avg(Aggregator):
    expr: Expr
    distinct: bool = False


@dataclasses.dataclass(frozen=True)
class Min(Aggregator):
    expr: Expr


@dataclasses.dataclass(frozen=True)
class Max(Aggregator):
    expr: Expr


@dataclasses.dataclass(frozen=True)
class Collect(Aggregator):
    expr: Expr
    distinct: bool = False


@dataclasses.dataclass(frozen=True)
class StDev(Aggregator):
    expr: Expr


@dataclasses.dataclass(frozen=True)
class PercentileCont(Aggregator):
    expr: Expr
    percentile: Expr
    distinct: bool = False


@dataclasses.dataclass(frozen=True)
class PercentileDisc(Aggregator):
    expr: Expr
    percentile: Expr
    distinct: bool = False


AGGREGATOR_NAMES = {
    "count", "sum", "avg", "min", "max", "collect", "stdev",
    "percentilecont", "percentiledisc",
}


def is_aggregating(e: Expr) -> bool:
    """True if the expression contains an aggregator anywhere."""
    return e.exists(lambda n: isinstance(n, Aggregator))


def vars_in(e: Expr) -> Tuple[Var, ...]:
    """Free variables of ``e`` at its own scope level.  An EXISTS subquery
    contributes the outer vars its pattern binds against plus any outer
    vars in its predicates — but not its pattern-local variables.
    Variables bound by list comprehensions, quantified predicates, and
    ``reduce`` are likewise excluded inside their own scopes."""
    seen: list = []

    def add(v: Var) -> None:
        if v not in seen:
            seen.append(v)

    def go(n, bound: frozenset) -> None:
        if isinstance(n, ExistsSubQuery):
            for name in n.outer_free_vars():
                if name not in bound:
                    add(Var(name))
            return
        if isinstance(n, Var):
            if n.name not in bound:
                add(n)
            return
        if isinstance(n, ListComprehension):
            go(n.list_expr, bound)
            inner = bound | {n.var}
            if n.predicate is not None:
                go(n.predicate, inner)
            if n.projection is not None:
                go(n.projection, inner)
            return
        if isinstance(n, QuantifiedPredicate):
            go(n.list_expr, bound)
            go(n.predicate, bound | {n.var})
            return
        if isinstance(n, Reduce):
            go(n.init, bound)
            go(n.list_expr, bound)
            go(n.expr, bound | {n.acc, n.var})
            return
        for c in n.children:
            go(c, bound)

    go(e, frozenset())
    return tuple(seen)
