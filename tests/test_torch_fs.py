"""The port's filesystem source (``caps_tpu_torch/io/fs.py``) against the
JAX package's (``caps_tpu/io/fs.py``).

* The 9 ``fs`` cases of ``tests/test_multiple_graph.py`` (round trips in
  parquet, csv and orc, the federated MATCH of BASELINE config 5, labels
  with ``_``, an all-null orc property, the combo collision) run on the
  port's two backends: the pure-Python oracle and the CUDA backend on
  the CPU.
* A directory written by either package reads into the other to the same
  rows, in every format, and the two packages write the same files byte
  for byte: ``schema.json`` and every ``part.*``.
* A graph built from numpy columns (the bulk store and load paths) gives
  the rows the JAX package reads from the same directory.
"""
from __future__ import annotations

import os

import numpy as np
import pytest

import caps_tpu
import caps_tpu_torch
from caps_tpu.io.fs import FSGraphSource as JaxFS
from caps_tpu.okapi.graph import Namespace as JaxNamespace
from caps_tpu.testing.factory import create_graph as jax_create_graph
from caps_tpu_torch.interop import graph_from_numpy
from caps_tpu_torch.io.fs import FSGraphSource
from caps_tpu_torch.okapi.graph import Namespace
from caps_tpu_torch.testing.bag import Bag
from caps_tpu_torch.testing.factory import create_graph
from caps_tpu_torch.testing.sessions import BACKENDS, make_backend_session

FORMATS = ["parquet", "csv", "orc"]


@pytest.fixture(params=BACKENDS)
def session(request):
    return make_backend_session(request.param, device="cpu")


def _rows(graph, q):
    return graph.cypher(q).records.to_maps()


# -- tests/test_multiple_graph.py's fs cases on the port ---------------------

@pytest.mark.parametrize("fmt", FORMATS)
def test_fs_roundtrip(session, tmp_path, fmt):
    src = FSGraphSource(session, str(tmp_path), fmt=fmt)
    session.catalog.register_source(Namespace("fs"), src)
    g = create_graph(session,
                     "CREATE (a:Person {name: 'Alice', age: 23})"
                     "-[:KNOWS {since: 2020}]->(b:Person:Admin {name: 'Bob'})")
    session.catalog.store("fs.people", g)
    g2 = session.catalog.graph("fs.people")
    assert g2.schema == g.schema
    rows = _rows(g2, "MATCH (a:Person)-[k:KNOWS]->(b:Admin) "
                     "RETURN a.name AS a, k.since AS s, b.name AS b")
    assert rows == [{"a": "Alice", "s": 2020, "b": "Bob"}]


def test_federated_match_across_sources(session, tmp_path):
    """Config 5: a query touching graphs from two data sources."""
    src = FSGraphSource(session, str(tmp_path))
    session.catalog.register_source(Namespace("fs"), src)
    products = create_graph(session, "CREATE (:Product {sku: 1, name: 'x'})")
    session.catalog.store("fs.products", products)
    customers = create_graph(session,
                             "CREATE (:Customer {name: 'c', wants: 1})")
    session.catalog.store("customers", customers)
    rows = session.cypher(
        "FROM GRAPH session.customers MATCH (c:Customer) "
        "WITH c.name AS cname, c.wants AS sku "
        "FROM GRAPH fs.products MATCH (p:Product) WHERE p.sku = sku "
        "RETURN cname, p.name AS product").records.to_maps()
    assert rows == [{"cname": "c", "product": "x"}]


@pytest.mark.parametrize("fmt", FORMATS)
def test_fs_roundtrip_label_with_underscore(session, tmp_path, fmt):
    src = FSGraphSource(session, str(tmp_path), fmt=fmt)
    session.catalog.register_source(Namespace("fsu"), src)
    g = create_graph(session,
                     "CREATE (:My_Label {v: 1})-[:HAS_PART]->(:Other {v: 2})")
    session.catalog.store("fsu.g", g)
    loaded = session.catalog.graph("fsu.g")
    assert _rows(loaded, "MATCH (n:My_Label) RETURN n.v AS v") == [{"v": 1}]
    assert _rows(loaded, "MATCH (:My_Label)-[r:HAS_PART]->(m) "
                         "RETURN m.v AS v") == [{"v": 2}]


def test_fs_orc_all_null_property(session, tmp_path):
    src = FSGraphSource(session, str(tmp_path), fmt="orc")
    session.catalog.register_source(Namespace("fso"), src)
    g = create_graph(session, "CREATE (:P {x: 1}), (:P)")
    session.catalog.store("fso.g", g)
    loaded = session.catalog.graph("fso.g")
    assert Bag(_rows(loaded, "MATCH (n:P) RETURN n.x AS x")) == \
        [{"x": 1}, {"x": None}]


def test_fs_no_combo_collision(session, tmp_path):
    src = FSGraphSource(session, str(tmp_path), fmt="parquet")
    session.catalog.register_source(Namespace("fsc"), src)
    g = create_graph(session, "CREATE (:A_B {v: 1}), (n:A:B {v: 2})")
    session.catalog.store("fsc.g", g)
    loaded = session.catalog.graph("fsc.g")
    assert _rows(loaded, "MATCH (n:A_B) RETURN n.v AS v") == [{"v": 1}]
    assert _rows(loaded, "MATCH (n:A:B) RETURN n.v AS v") == [{"v": 2}]


# -- across the packages -----------------------------------------------------

GRAPHS = {
    "people": "CREATE (a:Person {name: 'Alice', age: 23, score: 1.5, "
              "ok: true})-[:KNOWS {since: 2020}]->(b:Person:Admin "
              "{name: 'Bob', ok: false}), (:Person {age: 7})",
    "names": "CREATE (:My_Label {v: 1})-[:HAS_PART]->(:`a/b` {v: 2}), "
             "(:A_B {v: 3}), (:A:B {v: 4}), ({v: 5})-[:`x/y_z` {w: 0.5}]"
             "->(:A_B)",
    "nulls": "CREATE (:P {x: 1}), (:P), (:Q)-[:R]->(:Q {y: 'q'})",
}
def _dump(graph):
    """Every node (labels, properties) and relationship (endpoints,
    type, properties) by id."""
    nodes = {int(k): (tuple(sorted(v[0])), dict(v[1]))
             for k, v in graph.node_lookup().items()}
    rels = {int(k): (v[0], v[1], v[2], dict(v[3]))
            for k, v in graph.rel_lookup().items()}
    return nodes, rels


def _files(root):
    out = {}
    for d, _dirs, files in os.walk(root):
        for f in files:
            path = os.path.join(d, f)
            with open(path, "rb") as fh:
                out[os.path.relpath(path, root)] = fh.read()
    return out


@pytest.mark.parametrize("fmt", FORMATS)
@pytest.mark.parametrize("name", sorted(GRAPHS))
def test_a_directory_crosses_between_the_packages(tmp_path, fmt, name):
    create = GRAPHS[name]
    js = caps_tpu.local_session(backend="local")
    ps = caps_tpu_torch.local_session(backend="local")
    ref_dir, port_dir = str(tmp_path / "jax"), str(tmp_path / "port")
    JaxFS(js, ref_dir, fmt=fmt).store(
        caps_tpu.GraphName(name), jax_create_graph(js, create))
    FSGraphSource(ps, port_dir, fmt=fmt).store(
        caps_tpu_torch.GraphName(name), create_graph(ps, create))
    assert _files(port_dir) == _files(ref_dir)
    cs = caps_tpu_torch.local_session(device="cpu")
    cuda_dir = str(tmp_path / "cuda")
    FSGraphSource(cs, cuda_dir, fmt=fmt).store(
        caps_tpu_torch.GraphName(name), create_graph(cs, create))
    assert _files(cuda_dir) == _files(ref_dir)
    want = _dump(JaxFS(js, ref_dir, fmt=fmt).graph(caps_tpu.GraphName(name)))
    for backend in BACKENDS:
        s = make_backend_session(backend, device="cpu")
        got = FSGraphSource(s, ref_dir, fmt=fmt).graph(
            caps_tpu_torch.GraphName(name))
        assert _dump(got) == want, backend
    back = JaxFS(js, port_dir, fmt=fmt).graph(caps_tpu.GraphName(name))
    assert _dump(back) == want


def test_a_cuda_store_writes_the_reference_files(tmp_path):
    """The CUDA backend's store reads numeric and boolean columns in bulk
    (``DeviceTable.host_values``) and writes what the reference writes."""
    create = GRAPHS["people"]
    js = caps_tpu.local_session(backend="local")
    cs = caps_tpu_torch.local_session(device="cpu")
    ref_dir, port_dir = str(tmp_path / "jax"), str(tmp_path / "port")
    JaxFS(js, ref_dir).store(caps_tpu.GraphName("g"),
                             jax_create_graph(js, create))
    src = FSGraphSource(cs, port_dir)
    src.store(caps_tpu_torch.GraphName("g"), create_graph(cs, create))
    assert _files(port_dir) == _files(ref_dir)
    assert set(src.last_store_s) == {"scan", "write"}


def _arrays(n_people, n_edges, seed):
    rng = np.random.RandomState(seed)
    ids = np.arange(n_people, dtype=np.int64) * 3 + 5
    nodes = {"Person": {"_id": ids,
                        "age": rng.randint(18, 90, n_people).astype(np.int64),
                        "city": [f"c{i % 17}" for i in range(n_people)]}}
    rels = {"KNOWS": {"_id": np.arange(n_edges, dtype=np.int64) + 10 ** 6,
                      "_src": ids[rng.randint(0, n_people, n_edges)],
                      "_tgt": ids[rng.randint(0, n_people, n_edges)],
                      "w": rng.rand(n_edges)}}
    return nodes, rels


GROUPED = ("MATCH (a:Person)-[:KNOWS]->(b)-[:KNOWS]->(c) WHERE a.age = 30 "
           "RETURN c.city AS city, count(*) AS n ORDER BY n DESC, city")


@pytest.mark.parametrize("fmt", FORMATS)
def test_bulk_columns_round_trip(tmp_path, fmt):
    nodes, rels = _arrays(400, 3000, 1)
    cs = caps_tpu_torch.local_session(device="cpu")
    src = FSGraphSource(cs, str(tmp_path), fmt=fmt)
    cs.catalog.register_source(Namespace("fs"), src)
    g = graph_from_numpy(cs, nodes, rels)
    cs.catalog.store("fs.social", g)
    loaded = cs.catalog.graph("fs.social")
    assert set(src.last_load_s) == {"read", "columns", "upload"}
    js = caps_tpu.local_session(backend="local")
    ref = JaxFS(js, str(tmp_path), fmt=fmt).graph(
        caps_tpu.GraphName("social"))
    assert _dump(loaded) == _dump(ref)
    assert _rows(loaded, GROUPED) == _rows(ref, GROUPED) == _rows(g, GROUPED)
    # the federated query: session.base against fs.social
    cs.catalog.store("base", g)
    fed = ("FROM GRAPH session.base MATCH (a:Person) WHERE a.age = 30 "
           "WITH a.city AS city, count(*) AS k "
           "FROM GRAPH fs.social MATCH (p:Person) WHERE p.city = city "
           "RETURN city, k, count(p) AS n ORDER BY city")
    js.catalog.register_source(JaxNamespace("fs"), JaxFS(js, str(tmp_path),
                                                         fmt=fmt))
    js.catalog.store("base", ref)
    assert cs.cypher(fed).records.to_maps() == \
        js.cypher(fed).records.to_maps()


def test_bulk_load_hands_numpy_to_from_columns(tmp_path):
    nodes, rels = _arrays(50, 200, 2)
    cs = caps_tpu_torch.local_session(device="cpu")
    src = FSGraphSource(cs, str(tmp_path))
    src.store(caps_tpu_torch.GraphName("g"), graph_from_numpy(cs, nodes, rels))
    seen = {}
    real = cs.table_factory.from_columns

    def spy(data, types):
        seen.update({k: type(v).__name__ for k, v in data.items()})
        return real(data, types)
    cs.table_factory.from_columns = spy
    src.graph(caps_tpu_torch.GraphName("g"))
    assert seen == {"_id": "ndarray", "age": "ndarray", "city": "list",
                    "_src": "ndarray", "_tgt": "ndarray", "w": "ndarray"}
