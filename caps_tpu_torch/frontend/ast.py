"""Clause- and pattern-level AST.

The parser produces this tree; expression positions hold
:mod:`caps_tpu.ir.exprs` nodes directly (see that module's docstring for
why the expression tree is shared).  Mirrors the role of the reference's
front-end ``Statement``/clause AST (external ``org.opencypher:front-end``
dep — SURVEY.md §2 "Cypher front-end").
"""
from __future__ import annotations

import dataclasses
import enum
from typing import Optional, Tuple

from caps_tpu_torch.ir.exprs import Expr
from caps_tpu_torch.okapi.trees import TreeNode


class Direction(enum.Enum):
    OUTGOING = ">"
    INCOMING = "<"
    BOTH = "-"


# -- patterns ---------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class NodePattern(TreeNode):
    var: Optional[str]
    labels: Tuple[str, ...] = ()
    properties: Optional[Expr] = None  # MapLit or Param


@dataclasses.dataclass(frozen=True)
class RelPattern(TreeNode):
    var: Optional[str]
    rel_types: Tuple[str, ...] = ()
    properties: Optional[Expr] = None
    direction: Direction = Direction.OUTGOING
    var_length: Optional[Tuple[int, Optional[int]]] = None  # (lower, upper|None)


@dataclasses.dataclass(frozen=True)
class PatternPart(TreeNode):
    """One comma-separated pattern: alternating nodes and relationships,
    ``elements = (NodePattern, RelPattern, NodePattern, ...)``."""
    elements: Tuple[TreeNode, ...]
    path_var: Optional[str] = None

    @property
    def nodes(self) -> Tuple[NodePattern, ...]:
        return tuple(e for e in self.elements if isinstance(e, NodePattern))

    @property
    def rels(self) -> Tuple[RelPattern, ...]:
        return tuple(e for e in self.elements if isinstance(e, RelPattern))


@dataclasses.dataclass(frozen=True)
class Pattern(TreeNode):
    parts: Tuple[PatternPart, ...]


# -- clause items -----------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class ReturnItem(TreeNode):
    expr: Expr
    alias: Optional[str] = None


@dataclasses.dataclass(frozen=True)
class OrderItem(TreeNode):
    expr: Expr
    ascending: bool = True


# -- clauses ----------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class Clause(TreeNode):
    pass


@dataclasses.dataclass(frozen=True)
class MatchClause(Clause):
    pattern: Pattern
    where: Optional[Expr] = None
    optional: bool = False


@dataclasses.dataclass(frozen=True)
class UnwindClause(Clause):
    expr: Expr
    var: str


@dataclasses.dataclass(frozen=True)
class ProjectionBody(TreeNode):
    items: Tuple[ReturnItem, ...]
    star: bool = False
    distinct: bool = False
    order_by: Tuple[OrderItem, ...] = ()
    skip: Optional[Expr] = None
    limit: Optional[Expr] = None


@dataclasses.dataclass(frozen=True)
class WithClause(Clause):
    body: ProjectionBody
    where: Optional[Expr] = None


@dataclasses.dataclass(frozen=True)
class ReturnClause(Clause):
    body: ProjectionBody


@dataclasses.dataclass(frozen=True)
class CreateClause(Clause):
    pattern: Pattern


@dataclasses.dataclass(frozen=True)
class SetItem(TreeNode):
    """``SET a.key = expr`` | ``SET a :Label`` | ``SET a += map``."""
    var: str
    key: Optional[str] = None
    labels: Tuple[str, ...] = ()
    value: Optional[Expr] = None
    merge: bool = False  # += form


@dataclasses.dataclass(frozen=True)
class SetClause(Clause):
    items: Tuple[SetItem, ...]


@dataclasses.dataclass(frozen=True)
class DeleteClause(Clause):
    exprs: Tuple[Expr, ...]
    detach: bool = False


@dataclasses.dataclass(frozen=True)
class CallClause(Clause):
    """``CALL proc.name(args) [YIELD col [AS alias], ...]``.

    ``yields`` holds ``(column, alias-or-None)`` pairs as written; an
    empty tuple means no YIELD was given and the semantic pass expands
    it to every registered output column under its default name.
    ``where`` is the optional predicate right after the YIELD items."""
    procedure: str
    args: Tuple[Expr, ...] = ()
    yields: Tuple[Tuple[str, Optional[str]], ...] = ()
    where: Optional[Expr] = None


# -- multiple-graph clauses (Cypher 10 extensions) --------------------------

@dataclasses.dataclass(frozen=True)
class FromGraphClause(Clause):
    """``FROM GRAPH ns.name`` / ``USE ns.name`` — switches the working graph."""
    qualified_name: str


@dataclasses.dataclass(frozen=True)
class CloneItem(TreeNode):
    var: str                    # new binding (may shadow source var)
    source: Expr                # entity being cloned


@dataclasses.dataclass(frozen=True)
class ConstructClause(Clause):
    """``CONSTRUCT [ON g1, g2] [CLONE ...] [NEW pattern] [SET ...]``."""
    on_graphs: Tuple[str, ...] = ()
    clones: Tuple[CloneItem, ...] = ()
    news: Tuple[Pattern, ...] = ()
    sets: Tuple[SetItem, ...] = ()


@dataclasses.dataclass(frozen=True)
class ReturnGraphClause(Clause):
    pass


# -- queries ----------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class SingleQuery(TreeNode):
    clauses: Tuple[Clause, ...]


@dataclasses.dataclass(frozen=True)
class UnionQuery(TreeNode):
    queries: Tuple[SingleQuery, ...]
    union_all: bool = False


@dataclasses.dataclass(frozen=True)
class CatalogCreateGraph(TreeNode):
    """``CATALOG CREATE GRAPH ns.name { <query> }``."""
    qualified_name: str
    inner: TreeNode  # SingleQuery | UnionQuery


@dataclasses.dataclass(frozen=True)
class CatalogDropGraph(TreeNode):
    qualified_name: str


Statement = TreeNode  # SingleQuery | UnionQuery | CatalogCreateGraph | CatalogDropGraph
