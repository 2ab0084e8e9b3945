"""Filesystem property-graph data source (Parquet / CSV / ORC).

The counterpart of ``caps_tpu/io/fs.py``, with its on-disk format kept
byte for byte: a graph is a directory

    <root>/<graph-name>/
        schema.json
        nodes/<Label1_Label2>/part.parquet     (_id + property columns)
        relationships/<TYPE>/part.parquet      (_id, _src, _tgt + properties)

(``part.csv`` / ``part.orc`` in the other formats; label and type names
percent-encoded, ``_`` too, and ``__no_label__`` for unlabelled nodes),
so a directory written by either package reads into the other to the
same rows.

Arrow is the host-side format.  ``pyarrow`` is imported here only, and
only inside the functions that read or write (the one exception to the
package's torch / numpy / standard-library rule, ROADMAP).  Where the
reference goes through a Python value per row, this module moves whole
columns: a store reads each numeric or boolean column of a device table
as one numpy array (``DeviceTable.host_values``), and a load hands
``from_columns`` a numpy array for each numeric or boolean Arrow column
without nulls (the bulk path ``interop.py`` uses).  The values, types and
files are the reference's.  ``last_store_s`` and ``last_load_s`` hold the
seconds of the last store and load, by part.
"""
from __future__ import annotations

import json
import os
import shutil
import urllib.parse
from typing import Any, Dict, Optional, Tuple

import numpy as np

from caps_tpu_torch.obs import clock
from caps_tpu_torch.okapi.graph import GraphName, PropertyGraph
from caps_tpu_torch.okapi.io import PropertyGraphDataSource
from caps_tpu_torch.okapi.schema import Schema
from caps_tpu_torch.okapi.types import (
    CTBoolean, CTFloat, CTInteger, CTString, CypherType, parse_type,
)
from caps_tpu_torch.relational.entity_tables import (
    NodeMapping, NodeTable, RelationshipMapping, RelationshipTable,
)
from caps_tpu_torch.relational.graphs import RelationalCypherGraph, ScanGraph

# Arrow columns that load as one numpy array: the Cypher type a column
# must have (nullable or not) for each Arrow type test
_BULK_TYPES = (("is_int64", CTInteger), ("is_float64", CTFloat),
               ("is_boolean", CTBoolean))


def _encode_name(name: str) -> str:
    # Percent-encode path-unsafe characters AND '_' (the combo separator),
    # so labels containing '_' or '/' round-trip and distinct combos never
    # collide on the joined dirname.  Decoding is a plain unquote.
    return urllib.parse.quote(name, safe="").replace("_", "%5F")


def _decode_name(name: str) -> str:
    return urllib.parse.unquote(name)


def _combo_dirname(labels) -> str:
    return "_".join(_encode_name(l) for l in sorted(labels)) \
        if labels else "__no_label__"


def _dirname_combo(name: str) -> Tuple[str, ...]:
    if name == "__no_label__":
        return ()
    return tuple(_decode_name(part) for part in name.split("_"))


def _column(table, col: str):
    """One column of a table for the store: ``(values, ok)`` numpy
    arrays when the table gives them in bulk (a device table's numeric
    or boolean column), else its list of Python values."""
    bulk = getattr(table, "host_values", None)
    got = bulk(col) if bulk is not None else None
    return got if got is not None else table.column_values(col)


def _take(col, rows: Optional[np.ndarray]):
    if rows is None:
        return col
    if isinstance(col, tuple):
        return col[0][rows], col[1][rows]
    return [col[i] for i in rows.tolist()]


def _arrow_array(col):
    """The Arrow array the reference's ``pa.array(values)`` gives: a
    numpy pair builds the same array (int64, double or bool, nulls
    where ``ok`` is False) unless it has no valid value, where the
    reference's list of Nones (or an empty list) gives Arrow's null
    type."""
    import pyarrow as pa
    if isinstance(col, tuple):
        values, ok = col
        if ok.any():
            return pa.array(values, mask=None if ok.all() else ~ok)
        col = [None] * int(values.shape[0])
    return pa.array(col)


class FSGraphSource(PropertyGraphDataSource):
    def __init__(self, session, path: str, fmt: str = "parquet"):
        if fmt not in ("parquet", "csv", "orc"):
            raise ValueError(f"unsupported format {fmt!r}")
        if fmt == "orc":
            # Some pyarrow builds ship without ORC; only ORC users should
            # pay (or see) that, so the import is confined here.
            import pyarrow.orc  # noqa: F401
        self.session = session
        self.path = path
        self.fmt = fmt
        #: seconds of the last store: ``scan`` (reading the graph's
        #: columns), ``write`` (building and writing the Arrow tables)
        self.last_store_s: Dict[str, float] = {}
        #: seconds of the last load: ``read`` (the Arrow files),
        #: ``columns`` (Arrow to numpy arrays and lists), ``upload``
        #: (``from_columns``: string encoding and the copy to the device)
        self.last_load_s: Dict[str, float] = {}
        os.makedirs(path, exist_ok=True)

    # -- paths ----------------------------------------------------------

    def _graph_dir(self, name: GraphName) -> str:
        return os.path.join(self.path, name.value)

    def graph_names(self) -> Tuple[GraphName, ...]:
        out = []
        for entry in sorted(os.listdir(self.path)):
            if os.path.isfile(os.path.join(self.path, entry, "schema.json")):
                out.append(GraphName(entry))
        return tuple(out)

    def has_graph(self, name: GraphName) -> bool:
        return os.path.isfile(os.path.join(self._graph_dir(name), "schema.json"))

    def delete(self, name: GraphName) -> None:
        shutil.rmtree(self._graph_dir(name), ignore_errors=True)

    # -- io helpers ------------------------------------------------------

    def _write_table(self, directory: str, data: Dict[str, Any]) -> None:
        import pyarrow as pa
        os.makedirs(directory, exist_ok=True)
        table = pa.table({k: _arrow_array(v) for k, v in data.items()})
        if self.fmt == "parquet":
            import pyarrow.parquet as pq
            pq.write_table(table, os.path.join(directory, "part.parquet"))
        elif self.fmt == "orc":
            import pyarrow.orc as paorc
            # ORC cannot encode null-typed columns (an all-null property
            # with no observed type); store them as null strings.
            fields = [pa.field(f.name, pa.string()) if pa.types.is_null(f.type)
                      else f for f in table.schema]
            paorc.write_table(table.cast(pa.schema(fields)),
                              os.path.join(directory, "part.orc"))
        else:
            import pyarrow.csv as pacsv
            pacsv.write_csv(table, os.path.join(directory, "part.csv"))

    def _read_arrow(self, directory: str):
        if self.fmt == "parquet":
            import pyarrow.parquet as pq
            return pq.read_table(os.path.join(directory, "part.parquet"))
        if self.fmt == "orc":
            import pyarrow.orc as paorc
            return paorc.read_table(os.path.join(directory, "part.orc"))
        import pyarrow.csv as pacsv
        return pacsv.read_csv(os.path.join(directory, "part.csv"))

    @staticmethod
    def _columns(table, types: Dict[str, CypherType]) -> Dict[str, Any]:
        """Each Arrow column as the reference's ``to_pylist()`` values:
        a numpy array for a numeric or boolean column without nulls whose
        Cypher type is the matching one, a list otherwise."""
        import pyarrow as pa
        out: Dict[str, Any] = {}
        for name in table.column_names:
            col = table.column(name)
            ctype = types[name].material
            bulk = len(col) > 0 and col.null_count == 0 and any(
                getattr(pa.types, test)(col.type) and ctype == want
                for test, want in _BULK_TYPES)
            out[name] = col.to_numpy() if bulk else col.to_pylist()
        return out

    # -- store -----------------------------------------------------------

    def store(self, name: GraphName, graph: PropertyGraph) -> None:
        if not isinstance(graph, RelationalCypherGraph):
            raise TypeError("fs source can only store relational graphs")
        gdir = self._graph_dir(name)
        shutil.rmtree(gdir, ignore_errors=True)
        os.makedirs(gdir, exist_ok=True)
        schema = graph.schema
        with open(os.path.join(gdir, "schema.json"), "w") as f:
            json.dump(schema.to_json_dict(), f, indent=2)

        spent = {"scan": 0.0, "write": 0.0}
        for combo in schema.label_combinations:
            t0 = clock.now()
            data = self._node_scan_data(graph, combo)
            t1 = clock.now()
            self._write_table(
                os.path.join(gdir, "nodes", _combo_dirname(combo)), data)
            spent["scan"] += t1 - t0
            spent["write"] += clock.now() - t1
        for rel_type in sorted(schema.relationship_types):
            t0 = clock.now()
            data = self._rel_scan_data(graph, rel_type)
            t1 = clock.now()
            self._write_table(
                os.path.join(gdir, "relationships", _encode_name(rel_type)),
                data)
            spent["scan"] += t1 - t0
            spent["write"] += clock.now() - t1
        self.last_store_s = spent

    def _node_scan_data(self, graph, combo) -> Dict[str, Any]:
        """Materialize one label combination's nodes via the scan path,
        keeping only rows whose labels are exactly the combo."""
        from caps_tpu_torch.ir import exprs as E
        header, table = graph.scan_node("n", combo)
        ids = _column(table, header.column(E.Var("n")))
        n = len(ids[0]) if isinstance(ids, tuple) else len(ids)
        exact = np.ones(n, dtype=bool)
        seen = set()
        for e in header.exprs:
            if isinstance(e, E.HasLabel):
                col = _column(table, header.column(e))
                has = col[0] & col[1] if isinstance(col, tuple) \
                    else np.array([v is True for v in col], dtype=bool)
                exact &= has == (e.label in set(combo))
                seen.add(e.label)
        if not set(combo) <= seen:
            exact[:] = False
        rows = None if exact.all() else np.flatnonzero(exact)
        keys = sorted(graph.schema.property_keys_for_combo(combo))
        prop_cols = {}
        for e in header.exprs:
            if isinstance(e, E.Property) and e.key in keys:
                prop_cols[e.key] = _column(table, header.column(e))
        data: Dict[str, Any] = {"_id": _take(ids, rows)}
        for k in keys:
            col = prop_cols.get(k, [None] * n)
            data[k] = _take(col, rows)
        return data

    def _rel_scan_data(self, graph, rel_type: str) -> Dict[str, Any]:
        from caps_tpu_torch.ir import exprs as E
        header, table = graph.scan_rel("r", (rel_type,))
        v = E.Var("r")
        data: Dict[str, Any] = {
            "_id": _column(table, header.column(v)),
            "_src": _column(table, header.column(E.StartNode(v))),
            "_tgt": _column(table, header.column(E.EndNode(v))),
        }
        keys = sorted(graph.schema.relationship_property_keys((rel_type,)))
        for e in header.exprs:
            if isinstance(e, E.Property) and e.key in keys:
                data[e.key] = _column(table, header.column(e))
        return data

    # -- schema / load ---------------------------------------------------

    def schema(self, name: GraphName) -> Optional[Schema]:
        path = os.path.join(self._graph_dir(name), "schema.json")
        if not os.path.isfile(path):
            return None
        with open(path) as f:
            doc = json.load(f)
        schema = Schema.empty()
        for node in doc.get("nodes", []):
            keys = {k: parse_type(t) for k, t in node["properties"].items()}
            schema = schema.with_node_property_keys(node["labels"], keys)
        for rel in doc.get("relationships", []):
            keys = {k: parse_type(t) for k, t in rel["properties"].items()}
            schema = schema.with_relationship_property_keys(rel["type"], keys)
        return schema

    def graph(self, name: GraphName) -> ScanGraph:
        if not self.has_graph(name):
            raise KeyError(f"graph {name!r} not found under {self.path}")
        schema = self.schema(name)
        gdir = self._graph_dir(name)
        factory = self.session.table_factory
        spent = {"read": 0.0, "columns": 0.0, "upload": 0.0}

        def load(directory: str, types: Dict[str, CypherType], keys):
            t0 = clock.now()
            table = self._read_arrow(directory)
            t1 = clock.now()
            for k in table.column_names:
                if k not in types:
                    types[k] = keys.get(k, CTString.nullable)
            data = self._columns(table, types)
            t2 = clock.now()
            out = factory.from_columns(data, types)
            spent["read"] += t1 - t0
            spent["columns"] += t2 - t1
            spent["upload"] += clock.now() - t2
            return data, out

        node_tables = []
        nodes_dir = os.path.join(gdir, "nodes")
        if os.path.isdir(nodes_dir):
            for entry in sorted(os.listdir(nodes_dir)):
                combo = _dirname_combo(entry)
                keys = schema.property_keys_for_combo(combo)
                data, table = load(os.path.join(nodes_dir, entry),
                                   {"_id": CTInteger}, keys)
                mapping = NodeMapping.on("_id").with_implied_labels(*combo)
                for k in data:
                    if k != "_id":
                        mapping = mapping.with_property(k)
                node_tables.append(NodeTable(mapping, table))

        rel_tables = []
        rels_dir = os.path.join(gdir, "relationships")
        if os.path.isdir(rels_dir):
            for entry in sorted(os.listdir(rels_dir)):
                rel_type = _decode_name(entry)
                keys = schema.relationship_property_keys((rel_type,))
                data, table = load(
                    os.path.join(rels_dir, entry),
                    {"_id": CTInteger, "_src": CTInteger, "_tgt": CTInteger},
                    keys)
                mapping = RelationshipMapping.on(rel_type)
                for k in data:
                    if k not in ("_id", "_src", "_tgt"):
                        mapping = mapping.with_property(k)
                rel_tables.append(RelationshipTable(mapping, table))
        t0 = clock.now()
        graph = ScanGraph(self.session, node_tables, rel_tables)
        spent["upload"] += clock.now() - t0
        self.last_load_s = spent
        return graph
