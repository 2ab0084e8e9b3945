"""Query blocks: the IR of a query as a linear chain of blocks.

Mirrors the reference's ``QueryModel``/``Block`` family — MatchBlock,
ProjectBlock, AggregationBlock, OrderAndSliceBlock, UnwindBlock,
ResultBlock (ref: okapi-ir/.../ir/api/block/ — reconstructed, mount empty;
SURVEY.md §2 "IR").  The reference models a DAG; for the supported clause
subset a linear chain suffices (each block consumes the previous block's
rows), with UNION handled one level up in :class:`CypherStatement`.
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

from caps_tpu_torch.frontend.ast import CloneItem, SetItem
from caps_tpu_torch.ir.exprs import Aggregator, Expr
from caps_tpu_torch.ir.pattern import Pattern
from caps_tpu_torch.okapi.graph import QualifiedGraphName
from caps_tpu_torch.okapi.trees import TreeNode


@dataclasses.dataclass(frozen=True)
class Block(TreeNode):
    pass


@dataclasses.dataclass(frozen=True)
class MatchBlock(Block):
    pattern: Pattern
    predicates: Tuple[Expr, ...] = ()
    optional: bool = False


@dataclasses.dataclass(frozen=True)
class ProjectBlock(Block):
    """Project to exactly these named expressions (scope reset)."""
    items: Tuple[Tuple[str, Expr], ...]
    distinct: bool = False


@dataclasses.dataclass(frozen=True)
class AggregationBlock(Block):
    """Group by ``group`` items, compute ``aggregations``; output columns are
    group names + aggregation names."""
    group: Tuple[Tuple[str, Expr], ...]
    aggregations: Tuple[Tuple[str, Aggregator], ...]


@dataclasses.dataclass(frozen=True)
class FilterBlock(Block):
    predicate: Expr


@dataclasses.dataclass(frozen=True)
class OrderAndSliceBlock(Block):
    order: Tuple[Tuple[Expr, bool], ...] = ()  # (expr, ascending)
    skip: Optional[Expr] = None
    limit: Optional[Expr] = None


@dataclasses.dataclass(frozen=True)
class SelectBlock(Block):
    """Narrow the visible fields (drops hidden ORDER BY helper fields)."""
    fields: Tuple[str, ...]


@dataclasses.dataclass(frozen=True)
class UnwindBlock(Block):
    list_expr: Expr
    var: str


@dataclasses.dataclass(frozen=True)
class CallBlock(Block):
    """``CALL proc(...) YIELD ...`` — a registered graph-algorithm
    procedure; ``yields`` holds ``(procedure column, output name)``
    pairs with aliases already resolved by the builder."""
    procedure: str
    args: Tuple[Expr, ...] = ()
    yields: Tuple[Tuple[str, str], ...] = ()


@dataclasses.dataclass(frozen=True)
class FromGraphBlock(Block):
    qgn: QualifiedGraphName


@dataclasses.dataclass(frozen=True)
class ConstructBlock(Block):
    on_graphs: Tuple[QualifiedGraphName, ...] = ()
    clones: Tuple[CloneItem, ...] = ()
    news: Tuple[TreeNode, ...] = ()   # frontend.ast.Pattern, kept structural
    sets: Tuple[SetItem, ...] = ()


@dataclasses.dataclass(frozen=True)
class ReturnGraphBlock(Block):
    pass


@dataclasses.dataclass(frozen=True)
class ResultBlock(Block):
    """Terminal block: the query's output columns, in order."""
    fields: Tuple[str, ...]


@dataclasses.dataclass(frozen=True)
class CypherQuery(TreeNode):
    """IR of one single query: a linear chain of blocks."""
    blocks: Tuple[Block, ...]

    @property
    def result_fields(self) -> Tuple[str, ...]:
        for b in reversed(self.blocks):
            if isinstance(b, ResultBlock):
                return b.fields
        return ()


@dataclasses.dataclass(frozen=True)
class UnionOfQueries(TreeNode):
    queries: Tuple[CypherQuery, ...]
    union_all: bool = False


@dataclasses.dataclass(frozen=True)
class CreateGraphStatement(TreeNode):
    """``CATALOG CREATE GRAPH qgn { inner }``."""
    qgn: QualifiedGraphName
    inner: TreeNode  # CypherQuery | UnionOfQueries


@dataclasses.dataclass(frozen=True)
class DropGraphStatement(TreeNode):
    qgn: QualifiedGraphName


CypherStatement = TreeNode  # CypherQuery | UnionOfQueries | Create/DropGraphStatement
