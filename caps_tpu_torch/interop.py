"""Build a graph from numpy arrays.

The port's counterpart of carrying weights across: the same arrays a
test hands ``caps_tpu``'s ``TableFactory.from_columns`` build the port's
``NodeTable`` / ``RelationshipTable`` here, so both engines hold the same
graph.  Numeric arrays are copied to the device in bulk, and so are
``datetime64`` arrays: days (``datetime64[D]``) as dates, any finer unit
as datetimes in microseconds, ``NaT`` a null.
"""
from __future__ import annotations

from typing import Any, Dict, Mapping

import numpy as np

from caps_tpu_torch.okapi.types import (
    CTBoolean, CTDate, CTDateTime, CTFloat, CTInteger, CTString, CypherType,
)
from caps_tpu_torch.relational.entity_tables import (
    NodeMapping, NodeTable, RelationshipMapping, RelationshipTable,
)

_ENTITY_COLS = ("_id", "_src", "_tgt")


def ctype_of(values: Any) -> CypherType:
    """The Cypher type of a property column given as a numpy array or a
    list of str."""
    arr = values if isinstance(values, np.ndarray) else None
    if arr is None:
        if all(v is None or isinstance(v, str) for v in values):
            return CTString
        arr = np.asarray(values)
    kind = arr.dtype.kind
    if kind == "b":
        return CTBoolean
    if kind in "iu":
        return CTInteger
    if kind == "f":
        return CTFloat
    if kind in "USO":
        return CTString
    if kind == "M":
        return CTDate if np.datetime_data(arr.dtype)[0] == "D" \
            else CTDateTime
    raise TypeError(f"no Cypher type for numpy dtype {arr.dtype}")


def graph_from_numpy(session, nodes: Mapping[str, Mapping[str, Any]],
                     rels: Mapping[str, Mapping[str, Any]]):
    """``nodes``: {label: {"_id": int64[], prop: array or list[str]}};
    ``rels``: {type: {"_id": int64[], "_src": int64[], "_tgt": int64[],
    prop: ...}}.  Returns ``session.create_graph(...)``."""
    f = session.table_factory
    node_tables = []
    for label, cols in nodes.items():
        mapping = NodeMapping.on("_id").with_implied_labels(label)
        types: Dict[str, CypherType] = {"_id": CTInteger}
        for key, values in cols.items():
            if key != "_id":
                mapping = mapping.with_property(key)
                types[key] = ctype_of(values)
        node_tables.append(NodeTable(mapping, f.from_columns(cols, types)))
    rel_tables = []
    for rel_type, cols in rels.items():
        mapping = RelationshipMapping.on(rel_type)
        types = {c: CTInteger for c in _ENTITY_COLS}
        for key, values in cols.items():
            if key not in _ENTITY_COLS:
                mapping = mapping.with_property(key)
                types[key] = ctype_of(values)
        rel_tables.append(RelationshipTable(mapping,
                                            f.from_columns(cols, types)))
    return session.create_graph(node_tables, rel_tables)
