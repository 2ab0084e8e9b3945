"""Entity tables: declarations of how raw tables encode nodes/relationships.

Mirrors the reference's ``ElementTable``/``NodeTable``/``RelationshipTable``
with ``NodeMapping``/``RelationshipMapping`` (ref:
okapi-relational/.../api/io/ — reconstructed, mount empty; SURVEY.md §2
"Entity tables & mappings").
"""
from __future__ import annotations

import dataclasses
from typing import Dict, FrozenSet, Mapping, Optional, Tuple

from caps_tpu_torch.okapi.schema import Schema
from caps_tpu_torch.okapi.types import CypherType
from caps_tpu_torch.relational.table import Table


@dataclasses.dataclass(frozen=True)
class NodeMapping:
    id_col: str = "_id"
    labels: FrozenSet[str] = frozenset()          # implied labels (constant)
    property_cols: Mapping[str, str] = dataclasses.field(default_factory=dict)

    @staticmethod
    def on(id_col: str = "_id") -> "NodeMapping":
        return NodeMapping(id_col=id_col)

    def with_implied_labels(self, *labels: str) -> "NodeMapping":
        return dataclasses.replace(self, labels=frozenset(self.labels | set(labels)))

    def with_property(self, key: str, col: Optional[str] = None) -> "NodeMapping":
        props = dict(self.property_cols)
        props[key] = col or key
        return dataclasses.replace(self, property_cols=props)


@dataclasses.dataclass(frozen=True)
class RelationshipMapping:
    rel_type: str = ""
    id_col: str = "_id"
    source_col: str = "_src"
    target_col: str = "_tgt"
    property_cols: Mapping[str, str] = dataclasses.field(default_factory=dict)

    @staticmethod
    def on(rel_type: str, id_col: str = "_id", source_col: str = "_src",
           target_col: str = "_tgt") -> "RelationshipMapping":
        return RelationshipMapping(rel_type, id_col, source_col, target_col)

    def with_property(self, key: str, col: Optional[str] = None) -> "RelationshipMapping":
        props = dict(self.property_cols)
        props[key] = col or key
        return dataclasses.replace(self, property_cols=props)


class NodeTable:
    """A table of nodes sharing one exact label combination."""

    def __init__(self, mapping: NodeMapping, table: Table):
        missing = [c for c in [mapping.id_col, *mapping.property_cols.values()]
                   if c not in table.columns]
        if missing:
            raise ValueError(f"node table missing columns {missing}")
        self.mapping = mapping
        self.table = table

    @property
    def labels(self) -> FrozenSet[str]:
        return self.mapping.labels

    def property_types(self) -> Dict[str, CypherType]:
        return {key: self.table.column_type(col)  # type: ignore[attr-defined]
                for key, col in self.mapping.property_cols.items()}

    def schema(self) -> Schema:
        return Schema.empty().with_node_property_keys(
            self.labels, self.property_types())


class RelationshipTable:
    """A table of relationships sharing one type."""

    def __init__(self, mapping: RelationshipMapping, table: Table):
        needed = [mapping.id_col, mapping.source_col, mapping.target_col,
                  *mapping.property_cols.values()]
        missing = [c for c in needed if c not in table.columns]
        if missing:
            raise ValueError(f"relationship table missing columns {missing}")
        self.mapping = mapping
        self.table = table

    @property
    def rel_type(self) -> str:
        return self.mapping.rel_type

    def property_types(self) -> Dict[str, CypherType]:
        return {key: self.table.column_type(col)  # type: ignore[attr-defined]
                for key, col in self.mapping.property_cols.items()}

    def schema(self) -> Schema:
        return Schema.empty().with_relationship_property_keys(
            self.rel_type, self.property_types())
