"""SocialNetworkExample — the bundled Alice/Bob/Carol KNOWS graph
(benchmark config 1; ref: spark-cypher-examples SocialNetworkExample;
SURVEY.md §2).

The port's counterpart of ``examples/social_network.py``, on
``caps_tpu_torch`` (the card by default; ``main(device="cpu")`` runs it
on the CPU).

Run:  python examples/torch_social_network.py [--backend local|cuda]
      [--device cpu]
"""
import argparse

import caps_tpu_torch
from caps_tpu_torch.testing.factory import create_graph


def main(backend: str = "cuda", device=None):
    session = caps_tpu_torch.local_session(
        backend=backend, **({} if device is None else {"device": device}))

    graph = create_graph(session, """
        CREATE (alice:Person {name: 'Alice', age: 23}),
               (bob:Person {name: 'Bob', age: 42}),
               (carol:Person {name: 'Carol', age: 31}),
               (alice)-[:KNOWS {since: 2010}]->(bob),
               (bob)-[:KNOWS {since: 2015}]->(carol),
               (alice)-[:KNOWS {since: 2018}]->(carol)
    """)

    result = graph.cypher("""
        MATCH (a:Person)-[:KNOWS]->(b:Person)
        WHERE a.age < 40
        RETURN a.name AS a, b.name AS b
        ORDER BY a, b
    """)
    rows = result.records.to_maps()
    print("who knows whom (a.age < 40):")
    for r in rows:
        print(f"  {r['a']} -> {r['b']}")

    foaf = graph.cypher("""
        MATCH (a:Person {name: 'Alice'})-[:KNOWS]->()-[:KNOWS]->(c)
        RETURN c.name AS foaf
    """).records.to_maps()
    print("Alice's friends-of-friends:", [r["foaf"] for r in foaf])
    return rows, foaf


if __name__ == "__main__":
    ap = argparse.ArgumentParser()
    ap.add_argument("--backend", default="cuda", choices=["local", "cuda"])
    ap.add_argument("--device", default=None,
                    help='"cpu" runs the cuda backend on the CPU')
    main(**vars(ap.parse_args()))
