"""Recommendation example — multi-hop collaborative filtering in one Cypher
query (ref: spark-cypher-examples RecommendationExample; SURVEY.md §2).

Customers who bought the same product as you are taste-neighbours; rank
what they bought that you haven't.

The port's counterpart of ``examples/recommendation.py``, on
``caps_tpu_torch`` (the card by default; ``main(device="cpu")`` runs it
on the CPU).

Run:  python examples/torch_recommendation.py
"""
import caps_tpu_torch
from caps_tpu_torch.testing.factory import create_graph


def main(backend: str = "cuda", device=None):
    session = caps_tpu_torch.local_session(
        backend=backend, **({} if device is None else {"device": device}))
    graph = create_graph(session, """
        CREATE (nia:Customer {name: 'Nia'}),
               (omar:Customer {name: 'Omar'}),
               (vera:Customer {name: 'Vera'}),
               (kb:Product {title: 'keyboard'}),
               (ms:Product {title: 'mouse'}),
               (mn:Product {title: 'monitor'}),
               (hd:Product {title: 'headset'}),
               (nia)-[:BOUGHT]->(kb), (nia)-[:BOUGHT]->(ms),
               (omar)-[:BOUGHT]->(kb), (omar)-[:BOUGHT]->(mn),
               (vera)-[:BOUGHT]->(ms), (vera)-[:BOUGHT]->(mn),
               (vera)-[:BOUGHT]->(hd)
    """)
    rows = graph.cypher("""
        MATCH (me:Customer {name: 'Nia'})-[:BOUGHT]->(:Product)
              <-[:BOUGHT]-(peer:Customer)-[:BOUGHT]->(rec:Product)
        WHERE peer.name <> 'Nia'
        OPTIONAL MATCH (me)-[own:BOUGHT]->(rec)
        WITH rec, count(*) AS score, count(own) AS owned
        WHERE owned = 0
        RETURN rec.title AS recommend, score
        ORDER BY score DESC, recommend
    """).records.to_maps()
    print("recommendations for Nia:")
    for r in rows:
        print(f"  {r['recommend']} (score {r['score']})")
    return rows


if __name__ == "__main__":
    main()
