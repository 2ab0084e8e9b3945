"""Property Graph Data Source SPI.

Mirrors the reference's ``PropertyGraphDataSource`` (``hasGraph``, ``graph``,
``schema``, ``store``, ``delete``, ``graphNames``) (ref:
okapi-api/.../api/io/PropertyGraphDataSource.scala — reconstructed, mount
empty; SURVEY.md §2 "PGDS SPI").
"""
from __future__ import annotations

import abc
from typing import Optional, Tuple

from caps_tpu_torch.okapi.graph import GraphName, PropertyGraph
from caps_tpu_torch.okapi.schema import Schema


class PropertyGraphDataSource(abc.ABC):
    """Pluggable graph storage; a catalog namespace resolves to one of these."""

    @abc.abstractmethod
    def has_graph(self, name: GraphName) -> bool:
        ...

    @abc.abstractmethod
    def graph(self, name: GraphName) -> PropertyGraph:
        ...

    def schema(self, name: GraphName) -> Optional[Schema]:
        """Schema without loading the graph, when cheaply available."""
        return self.graph(name).schema if self.has_graph(name) else None

    @abc.abstractmethod
    def store(self, name: GraphName, graph: PropertyGraph) -> None:
        ...

    @abc.abstractmethod
    def delete(self, name: GraphName) -> None:
        ...

    @abc.abstractmethod
    def graph_names(self) -> Tuple[GraphName, ...]:
        ...
