"""Filesystem data-source example — store a graph to Parquet, register the
directory as a catalog namespace, query it back with FROM GRAPH (ref:
spark-cypher FSGraphSource / Neo4jWorkflowExample workflow shape;
SURVEY.md §2, §3.3).

The port's counterpart of ``examples/fs_datasource.py``, on
``caps_tpu_torch`` (the card by default; ``main(device="cpu")`` runs it
on the CPU).

Run:  python examples/torch_fs_datasource.py
"""
import tempfile

import caps_tpu_torch
from caps_tpu_torch.io.fs import FSGraphSource
from caps_tpu_torch.okapi.graph import GraphName
from caps_tpu_torch.testing.factory import create_graph


def main(backend: str = "cuda", device=None):
    session = caps_tpu_torch.local_session(
        backend=backend, **({} if device is None else {"device": device}))
    graph = create_graph(session, """
        CREATE (:City {name: 'Kyoto', pop: 1463723}),
               (:City {name: 'Oslo', pop: 709037})
    """)

    with tempfile.TemporaryDirectory() as root:
        fs = FSGraphSource(session, root, fmt="parquet")
        session.catalog.register_source("fs", fs)
        fs.store(GraphName("cities"), graph)

        rows = session.cypher("""
            FROM GRAPH fs.cities
            MATCH (c:City) WHERE c.pop > 1000000
            RETURN c.name AS n
        """).records.to_maps()
        print("big cities from the fs source:", [r["n"] for r in rows])
        return rows


if __name__ == "__main__":
    main()
