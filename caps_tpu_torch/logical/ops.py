"""Logical operator algebra.

Mirrors the reference's ``LogicalOperator`` family — NodeScan, Expand,
ExpandInto (here: ``Expand(into=True)``), BoundedVarLengthExpand, Filter,
Project, Select, Aggregate, Distinct, OrderBy, Skip, Limit, Optional,
CartesianProduct, ValueJoin, TabularUnionAll, FromGraph, ReturnGraph
(ref: okapi-logical/.../logical/impl/LogicalOperator.scala — reconstructed,
mount empty; SURVEY.md §2).

Every operator carries its output ``fields`` — a tuple of
``(name, CypherType)`` pairs — so downstream planning never re-derives
scope.  Fields are plain tuples (not TreeNodes) to keep tree traversal
restricted to operators.
"""
from __future__ import annotations

import dataclasses
from typing import FrozenSet, Optional as Opt, Tuple

from caps_tpu_torch.frontend.ast import CloneItem, SetItem
from caps_tpu_torch.ir.exprs import Aggregator, Expr
from caps_tpu_torch.ir.pattern import Direction
from caps_tpu_torch.okapi.graph import QualifiedGraphName
from caps_tpu_torch.okapi.trees import TreeNode
from caps_tpu_torch.okapi.types import CypherType

Fields = Tuple[Tuple[str, CypherType], ...]


@dataclasses.dataclass(frozen=True)
class LogicalOperator(TreeNode):
    # Every concrete operator declares a trailing `fields: Fields` dataclass
    # field holding its output columns.

    @property
    def field_names(self) -> Tuple[str, ...]:
        return tuple(n for n, _ in self.fields)

    @property
    def env(self):
        return dict(self.fields)

    def args_string(self) -> str:  # keep pretty-printed plans readable
        parts = []
        for f in dataclasses.fields(self):
            if f.name == "fields":
                continue
            v = getattr(self, f.name)
            if isinstance(v, TreeNode) or (
                    isinstance(v, tuple) and any(isinstance(c, TreeNode) for c in v)):
                continue
            parts.append(f"{f.name}={v!r}")
        return ", ".join(parts)


@dataclasses.dataclass(frozen=True)
class Start(LogicalOperator):
    """Source of a single empty row, bound to a graph context."""
    qgn: Opt[QualifiedGraphName] = None
    fields: Fields = ()


@dataclasses.dataclass(frozen=True)
class NodeScan(LogicalOperator):
    parent: LogicalOperator
    var: str
    labels: FrozenSet[str]
    fields: Fields = ()


@dataclasses.dataclass(frozen=True)
class RelScan(LogicalOperator):
    """Scan of all relationships of the given types (used to rehydrate
    unwound relationship ids; pattern rel scans are planned inside
    Expand)."""
    parent: LogicalOperator
    var: str
    rel_types: FrozenSet[str]
    fields: Fields = ()


@dataclasses.dataclass(frozen=True)
class Expand(LogicalOperator):
    """One hop from ``source``: join relationships (and the target node scan
    unless ``into``) onto the incoming rows.  ``direction`` is relative to
    ``source``: OUTGOING follows edges source→target, INCOMING target→source,
    BOTH follows either (union)."""
    parent: LogicalOperator
    source: str
    rel: str
    rel_types: Tuple[str, ...]
    target: str
    target_labels: FrozenSet[str]
    direction: Direction
    into: bool = False
    fields: Fields = ()


@dataclasses.dataclass(frozen=True)
class BoundedVarLengthExpand(LogicalOperator):
    """Variable-length hop ``(source)-[rel:types*lower..upper]->(target)``;
    ``rel`` binds to the list of traversed relationships."""
    parent: LogicalOperator
    source: str
    rel: str
    rel_types: Tuple[str, ...]
    target: str
    target_labels: FrozenSet[str]
    direction: Direction
    lower: int
    upper: Opt[int]
    into: bool = False
    fields: Fields = ()


@dataclasses.dataclass(frozen=True)
class Filter(LogicalOperator):
    parent: LogicalOperator
    predicate: Expr
    fields: Fields = ()


@dataclasses.dataclass(frozen=True)
class Project(LogicalOperator):
    """Add computed columns (existing columns are kept)."""
    parent: LogicalOperator
    items: Tuple[Tuple[str, Expr], ...]
    fields: Fields = ()


@dataclasses.dataclass(frozen=True)
class Select(LogicalOperator):
    """Narrow to exactly these fields, in order."""
    parent: LogicalOperator
    names: Tuple[str, ...]
    fields: Fields = ()


@dataclasses.dataclass(frozen=True)
class Distinct(LogicalOperator):
    parent: LogicalOperator
    fields: Fields = ()


@dataclasses.dataclass(frozen=True)
class Aggregate(LogicalOperator):
    parent: LogicalOperator
    group: Tuple[Tuple[str, Expr], ...]
    aggregations: Tuple[Tuple[str, Aggregator], ...]
    fields: Fields = ()


@dataclasses.dataclass(frozen=True)
class OrderBy(LogicalOperator):
    parent: LogicalOperator
    items: Tuple[Tuple[Expr, bool], ...]  # (expr, ascending)
    fields: Fields = ()


@dataclasses.dataclass(frozen=True)
class Skip(LogicalOperator):
    parent: LogicalOperator
    expr: Expr
    fields: Fields = ()


@dataclasses.dataclass(frozen=True)
class Limit(LogicalOperator):
    parent: LogicalOperator
    expr: Expr
    fields: Fields = ()


@dataclasses.dataclass(frozen=True)
class Unwind(LogicalOperator):
    parent: LogicalOperator
    list_expr: Expr
    var: str
    fields: Fields = ()


@dataclasses.dataclass(frozen=True)
class Optional(LogicalOperator):
    """OPTIONAL MATCH: keep every ``lhs`` row; where ``rhs`` (which extends
    lhs) found no rows, emit nulls for the new fields."""
    lhs: LogicalOperator
    rhs: LogicalOperator
    fields: Fields = ()


@dataclasses.dataclass(frozen=True)
class ExistsSemiJoin(LogicalOperator):
    """EXISTS-subquery support (ref: okapi-logical ExistsSubQuery —
    reconstructed; SURVEY.md §2): ``rhs`` extends ``lhs`` with the
    subquery pattern and projects a constant ``marker``; the output keeps
    every lhs row once, with ``marker`` non-null iff rhs matched it."""
    lhs: LogicalOperator
    rhs: LogicalOperator
    marker: str
    fields: Fields = ()


@dataclasses.dataclass(frozen=True)
class CartesianProduct(LogicalOperator):
    lhs: LogicalOperator
    rhs: LogicalOperator
    fields: Fields = ()


@dataclasses.dataclass(frozen=True)
class ValueJoin(LogicalOperator):
    """Join on equality predicates ``lhs_expr = rhs_expr`` (inner unless
    ``join_type`` says otherwise)."""
    lhs: LogicalOperator
    rhs: LogicalOperator
    predicates: Tuple[Expr, ...]
    join_type: str = "inner"
    fields: Fields = ()


@dataclasses.dataclass(frozen=True)
class TabularUnionAll(LogicalOperator):
    lhs: LogicalOperator
    rhs: LogicalOperator
    fields: Fields = ()


@dataclasses.dataclass(frozen=True)
class ProcedureCall(LogicalOperator):
    """``CALL algo.*`` — run one registered graph-algorithm procedure
    over the working graph's snapshot; ``yields`` holds ``(procedure
    column, output name)`` pairs and ``fields`` the resulting columns."""
    parent: LogicalOperator
    procedure: str
    args: Tuple[Expr, ...]
    yields: Tuple[Tuple[str, str], ...]
    fields: Fields = ()


@dataclasses.dataclass(frozen=True)
class FromGraph(LogicalOperator):
    """Switch the working graph for operators above this one."""
    parent: LogicalOperator
    qgn: QualifiedGraphName
    fields: Fields = ()


@dataclasses.dataclass(frozen=True)
class ConstructGraph(LogicalOperator):
    parent: LogicalOperator
    on_graphs: Tuple[QualifiedGraphName, ...]
    clones: Tuple[CloneItem, ...]
    news: Tuple[TreeNode, ...]
    sets: Tuple[SetItem, ...]
    fields: Fields = ()


@dataclasses.dataclass(frozen=True)
class ReturnGraph(LogicalOperator):
    parent: LogicalOperator
    fields: Fields = ()


@dataclasses.dataclass(frozen=True)
class EmptyRecords(LogicalOperator):
    fields: Fields = ()


@dataclasses.dataclass(frozen=True)
class LogicalPlan(TreeNode):
    """Root wrapper: the operator tree plus the user-visible output columns."""
    root: LogicalOperator
    result_fields: Tuple[str, ...]
    returns_graph: bool = False

    def pretty(self, _depth: int = 0) -> str:
        return self.root.pretty(_depth)
