"""Columnar-input example — building a graph from raw columns + entity
mappings, the analog of the reference's DataFrameInputExample
(DataFrames → CAPSNodeTable/CAPSRelationshipTable; ref:
spark-cypher-examples; SURVEY.md §2).

The port's counterpart of ``examples/columnar_input.py``, on
``caps_tpu_torch`` (the card by default; ``main(device="cpu")`` runs it
on the CPU).

Run:  python examples/torch_columnar_input.py
"""
import caps_tpu_torch
from caps_tpu_torch.okapi.types import CTFloat, CTInteger, CTString
from caps_tpu_torch.relational.entity_tables import (
    NodeMapping, NodeTable, RelationshipMapping, RelationshipTable,
)


def main(backend: str = "cuda", device=None):
    session = caps_tpu_torch.local_session(
        backend=backend, **({} if device is None else {"device": device}))
    f = session.table_factory

    products = NodeTable(
        NodeMapping.on("id").with_implied_labels("Product")
        .with_property("title").with_property("price"),
        f.from_columns(
            {"id": [0, 1, 2],
             "title": ["keyboard", "mouse", "monitor"],
             "price": [49.0, 19.0, 249.0]},
            {"id": CTInteger, "title": CTString, "price": CTFloat}))

    customers = NodeTable(
        NodeMapping.on("id").with_implied_labels("Customer")
        .with_property("name"),
        f.from_columns(
            {"id": [10, 11], "name": ["Nia", "Omar"]},
            {"id": CTInteger, "name": CTString}))

    bought = RelationshipTable(
        RelationshipMapping.on("BOUGHT"),
        f.from_columns(
            {"_id": [100, 101, 102], "_src": [10, 10, 11],
             "_tgt": [0, 2, 1]},
            {"_id": CTInteger, "_src": CTInteger, "_tgt": CTInteger}))

    graph = session.create_graph([products, customers], [bought])
    rows = graph.cypher("""
        MATCH (c:Customer)-[:BOUGHT]->(p:Product)
        RETURN c.name AS customer, sum(p.price) AS total
        ORDER BY customer
    """).records.to_maps()
    for r in rows:
        print(f"{r['customer']} spent {r['total']}")
    return rows


if __name__ == "__main__":
    main()
