"""Multiple-graph example — catalog, CONSTRUCT, RETURN GRAPH, FROM GRAPH
(benchmark config 5; ref: spark-cypher-examples MultipleGraphExample;
SURVEY.md §2, §3.4).

The port's counterpart of ``examples/multiple_graph.py``, on
``caps_tpu_torch`` (the card by default; ``main(device="cpu")`` runs it
on the CPU).

Run:  python examples/torch_multiple_graph.py
"""
import caps_tpu_torch
from caps_tpu_torch.testing.factory import create_graph


def main(backend: str = "cuda", device=None):
    session = caps_tpu_torch.local_session(
        backend=backend, **({} if device is None else {"device": device}))

    social = create_graph(session, """
        CREATE (a:Person {name: 'Alice'}), (b:Person {name: 'Bob'}),
               (a)-[:KNOWS]->(b)
    """)
    purchases = create_graph(session, """
        CREATE (a:Person {name: 'Alice'}), (p:Product {title: 'book'}),
               (a)-[:BOUGHT]->(p)
    """)
    session.catalog.store("social", social)
    session.catalog.store("purchases", purchases)

    # Query a catalog graph by name
    rows = session.cypher("""
        FROM GRAPH session.social
        MATCH (p:Person) RETURN p.name AS n ORDER BY n
    """).records.to_maps()
    print("people in session.social:", [r["n"] for r in rows])

    # CONSTRUCT a recommendation graph linking friends to what they bought
    result = session.cypher("""
        FROM GRAPH session.social
        MATCH (a:Person)-[:KNOWS]->(b:Person)
        CONSTRUCT
          NEW (a)-[:SHOULD_ASK]->(b)
        RETURN GRAPH
    """)
    rec = result.graph
    edges = rec.cypher("""
        MATCH (x)-[:SHOULD_ASK]->(y) RETURN x.name AS x, y.name AS y
    """).records.to_maps()
    print("constructed SHOULD_ASK edges:", edges)
    return rows, edges


if __name__ == "__main__":
    main()
