"""IR pattern: entities and connections extracted from MATCH patterns.

Mirrors the reference's ``Pattern`` + ``Connection`` (directed / undirected,
var-length bounds) and ``IRField`` (ref: okapi-ir/.../ir/api/pattern/ —
reconstructed, mount empty; SURVEY.md §2 "IR").
"""
from __future__ import annotations

import dataclasses
import enum
from typing import Optional, Tuple

from caps_tpu_torch.okapi.trees import TreeNode
from caps_tpu_torch.okapi.types import CypherType


class Direction(enum.Enum):
    OUTGOING = ">"
    INCOMING = "<"
    BOTH = "-"


@dataclasses.dataclass(frozen=True)
class IRField(TreeNode):
    name: str
    cypher_type: CypherType

    def __repr__(self):
        return f"{self.name}: {self.cypher_type!r}"


@dataclasses.dataclass(frozen=True)
class Connection(TreeNode):
    """One relationship hop ``(source)-[rel:types]->(target)``."""
    source: str
    rel: str
    target: str
    direction: Direction = Direction.OUTGOING
    rel_types: Tuple[str, ...] = ()
    var_length: Optional[Tuple[int, Optional[int]]] = None  # (lower, upper|None)

    @property
    def is_var_length(self) -> bool:
        return self.var_length is not None


@dataclasses.dataclass(frozen=True)
class Pattern(TreeNode):
    """Entities declared by one MATCH: node/rel vars with their declared
    types, plus the connection topology."""
    entities: Tuple[IRField, ...] = ()
    connections: Tuple[Connection, ...] = ()
    # Vars that were already bound before this MATCH (not re-declared here;
    # the planner joins on them instead of scanning).
    bound: Tuple[str, ...] = ()

    def entity_type(self, name: str) -> CypherType:
        for f in self.entities:
            if f.name == name:
                return f.cypher_type
        raise KeyError(name)

    @property
    def entity_names(self) -> Tuple[str, ...]:
        return tuple(f.name for f in self.entities)
