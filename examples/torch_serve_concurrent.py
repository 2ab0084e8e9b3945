"""Concurrent serving example — many client threads, one prepared plan.

``caps_tpu_torch/serve/`` turns a session into a multi-client service:
clients ``submit()`` from any thread and block on Future-style handles while a
worker pool executes through the session's prepared-plan path.  The
micro-batcher coalesces compatible in-flight requests (same normalized
query + parameter signature = same plan-cache key family) into ONE pass
over the cached operator tree — the serving analogue of continuous
batching in LLM inference, with the cached plan playing the compiled
program's role.

The demo submits a burst from 4 client threads, then compares against
the same workload as sequential ``PreparedQuery.run()`` calls, and
prints the batch-size histogram the server actually achieved: a max
batch size > 1 is the amortization made visible — those requests shared
one plan-cache lookup, one execution lock acquisition, and (on the CUDA
backend) one uninterrupted fused dispatch stream.

The port's counterpart of ``examples/serve_concurrent.py``, on
``caps_tpu_torch`` (the card by default; ``main(device="cpu")`` runs it
on the CPU).

Run:  python examples/torch_serve_concurrent.py
"""
import threading

import caps_tpu_torch
from caps_tpu_torch.serve import QueryServer, ServerConfig
from caps_tpu_torch.testing.factory import create_graph

QUERY = ("MATCH (a:Person)-[:KNOWS]->(b:Person) WHERE a.age > $min_age "
         "RETURN b.name AS knows ORDER BY knows")
BINDINGS = [{"min_age": a} for a in (20, 30, 40, 50)]
N_CLIENTS, PER_CLIENT = 4, 6


def main(backend: str = "cuda", device=None):
    session = caps_tpu_torch.local_session(
        backend=backend, **({} if device is None else {"device": device}))
    graph = create_graph(session, """
        CREATE (ana:Person {name: 'Ana', age: 34}),
               (bo:Person {name: 'Bo', age: 51}),
               (cleo:Person {name: 'Cleo', age: 27}),
               (dev:Person {name: 'Dev', age: 45}),
               (ana)-[:KNOWS]->(bo), (bo)-[:KNOWS]->(cleo),
               (cleo)-[:KNOWS]->(dev), (dev)-[:KNOWS]->(ana),
               (ana)-[:KNOWS]->(cleo)
    """)

    # Sequential reference: one prepared statement, one caller.
    prep = graph.prepare(QUERY)
    expected = {b["min_age"]: [r["knows"] for r in
                               prep.run(b).records.to_maps()]
                for b in BINDINGS}

    # Serving tier: the burst is queued before the workers start, so
    # the very first batch demonstrably coalesces.
    server = QueryServer(session, graph=graph, start=False,
                         config=ServerConfig(workers=2, max_batch=8))
    handles = []

    def client(i):
        for j in range(PER_CLIENT):
            binding = BINDINGS[(i + j) % len(BINDINGS)]
            handles.append((binding, server.submit(QUERY, binding)))

    threads = [threading.Thread(target=client, args=(i,))
               for i in range(N_CLIENTS)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    server.start()

    ok = 0
    for binding, handle in handles:
        rows = [r["knows"] for r in handle.rows(timeout=30)]
        assert rows == expected[binding["min_age"]], (binding, rows)
        ok += 1
    server.shutdown()

    stats = server.stats()
    n = N_CLIENTS * PER_CLIENT
    print(f"{ok}/{n} served correctly across {N_CLIENTS} client threads")
    print(f"batches: {stats['batches']} for {stats['completed']} requests "
          f"(mean size {stats['batch_size.mean']:.2f}, "
          f"max {stats['batch_size.max']})")
    print(f"vs sequential run(): every request in a size-"
          f"{stats['batch_size.max']} batch shared one plan-cache lookup "
          f"and one execution-lock acquisition instead of paying its own")
    return ok, int(stats["batch_size.max"])


if __name__ == "__main__":
    main()
