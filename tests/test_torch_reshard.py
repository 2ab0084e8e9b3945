"""Device health and re-sharding of the port's sessions
(``CUDACypherSession.health_check`` / ``shrink_and_reshard``) against
the JAX package's.

Counterparts of ``tests/test_aux.py``'s health-check and
shrink-and-reshard tests, on 8-shard meshes on the CPU (mesh slots stand
for devices), each query equal to the JAX package's session; plus the
port's own check that a replay after a re-shard never serves the sizes
recorded for the old shard count."""
import caps_tpu_torch
from caps_tpu.backends.local.session import LocalCypherSession
from caps_tpu.testing.factory import create_graph as jax_create_graph
from caps_tpu_torch.okapi.config import EngineConfig
from caps_tpu_torch.testing.bag import Bag
from caps_tpu_torch.testing.factory import create_graph


def _session(**cfg):
    return caps_tpu_torch.local_session(device="cpu",
                                        config=EngineConfig(**cfg))


def _oracle(create, q):
    return jax_create_graph(LocalCypherSession(), create, {}
                            ).cypher(q).records.to_maps()


def test_health_check_all_devices_ok():
    s = _session(mesh_shape=(8,))
    status = s.health_check()
    assert len(status) == 8 and all(status.values())
    assert list(status) == [f"cpu#{i}" for i in range(8)]
    s1 = caps_tpu_torch.local_session(device="cpu")
    assert s1.health_check() == {"cpu": True}


def test_shrink_and_reshard_after_device_loss():
    """After losing shards the session rebuilds its mesh over the
    survivors (power-of-two prefix), re-places catalog graphs, rebuilds
    the CSR, and answers as before."""
    create = ("CREATE (a:Person {name:'Ada'}), (b:Person {name:'Bo'}), "
              "(c:Person {name:'Cy'}), (a)-[:KNOWS]->(b), "
              "(b)-[:KNOWS]->(c), (a)-[:KNOWS]->(c)")
    q = "MATCH (a)-[:KNOWS*1..2]->(b) RETURN a.name AS a, b.name AS b"
    q2 = ("MATCH (a:Person)-[:KNOWS]->(b)-[:KNOWS]->(c) "
          "WHERE a.name='Ada' RETURN count(*) AS c")
    sess = _session(mesh_shape=(8,))
    g = create_graph(sess, create, {})
    sess.catalog.store("g", g)
    want, want2 = _oracle(create, q), _oracle(create, q2)
    assert Bag(g.cypher(q).records.to_maps()) == want

    survivors = list(sess.backend.mesh.devices.flat)[:5]
    n = sess.shrink_and_reshard(healthy=survivors)
    assert n == 4 and sess.backend.mesh.devices.size == 4
    assert Bag(g.cypher(q).records.to_maps()) == want
    assert g.cypher(q2).records.to_maps() == want2

    n = sess.shrink_and_reshard(healthy=survivors[:1])
    assert n == 1 and sess.backend.mesh is None
    assert Bag(g.cypher(q).records.to_maps()) == want


def test_shrink_and_reshard_two_level_mesh():
    """A 2-D mesh regroups survivors by slice: rows shrink to the
    smallest surviving power-of-two width and the mesh stays two-level."""
    create = ("CREATE (a:P {v: 1}), (b:P {v: 2}), (c:P {v: 3}), "
              "(a)-[:R]->(b), (b)-[:R]->(c)")
    q = "MATCH (x:P)-[:R]->(y) RETURN x.v AS x, y.v AS y"
    sess = _session(mesh_shape=(2, 4))
    g = create_graph(sess, create, {})
    sess.catalog.store("g", g)
    want = _oracle(create, q)
    assert Bag(g.cypher(q).records.to_maps()) == want
    old = sess.backend.mesh.devices
    n = sess.shrink_and_reshard(healthy=list(old[0]) + list(old[1][:3]))
    assert n == 4
    assert sess.backend.mesh.devices.shape == (2, 2)
    assert sess.backend.mesh.axis_names == ("dcn", "shard")
    assert all(d in list(old[0]) for d in sess.backend.mesh.devices[0])
    assert all(d in list(old[1]) for d in sess.backend.mesh.devices[1])
    assert Bag(g.cypher(q).records.to_maps()) == want


def test_health_check_drives_the_reshard(monkeypatch):
    """With no survivors named, the shards whose health check fails are
    dropped."""
    sess = _session(mesh_shape=(8,))
    g = create_graph(sess, "CREATE (:P {v: 1})-[:R]->(:P {v: 2})", {})
    sess.catalog.store("g", g)
    real = sess.health_check
    monkeypatch.setattr(sess, "health_check", lambda: {
        k: not k.endswith(("#6", "#7")) for k in real()})
    assert sess.shrink_and_reshard() == 4
    assert [s.index for s in sess.backend.mesh.slots] == [0, 1, 2, 3]


def test_replay_after_a_reshard_never_serves_the_old_sizes():
    """A re-shard changes every recorded size (bin capacities, per-shard
    output sizes): the next run of a replayed query records anew, answers
    right, and its later exact replays read no size again."""
    create = ("CREATE " + ", ".join(f"(n{i}:P {{v: {i % 5}}})"
                                    for i in range(40)) + ", "
              + ", ".join(f"(n{i})-[:R]->(n{(i * 7 + 3) % 40})"
                          for i in range(40)))
    q = ("MATCH (a:P)-[:R]->(b:P) WHERE a.v = $v "
         "RETURN b.v AS v, count(*) AS c ORDER BY v")
    sess = _session(mesh_shape=(8,), use_csr=False,
                    broadcast_join_threshold=0)
    g = create_graph(sess, create, {})
    sess.catalog.store("g", g)
    plain = create_graph(caps_tpu_torch.local_session(device="cpu"),
                         create, {})
    want = plain.cypher(q, {"v": 2}).records.to_maps()
    for _ in range(2):
        r = g.cypher(q, {"v": 2})
        assert r.records.to_maps() == want
    assert sess.fused.last_mode == "replay"
    assert r.metrics["size_syncs"] == 0 and r.metrics["dist_joins"] > 0
    bytes8 = r.metrics["ici_bytes"]

    sess.shrink_and_reshard(healthy=list(sess.backend.mesh.slots)[:4])
    r = g.cypher(q, {"v": 2})
    assert sess.fused.last_mode == "record"
    assert r.records.to_maps() == want
    assert r.metrics["size_syncs"] > 0
    assert r.metrics["ici_bytes"] != bytes8
    r = g.cypher(q, {"v": 2})
    assert sess.fused.last_mode == "replay"
    assert r.metrics["size_syncs"] == 0
    assert r.records.to_maps() == want


# -- shard damage (counterparts of tests/test_aux.py's corrupt_shard tests) --

CREATE = ("CREATE (a:P {name:'a', x: 1}), (b:P {name:'b', x: 2}), "
          "(c:P {name:'c', x: 3}), (a)-[:T]->(b), (b)-[:T]->(c)")


def test_fault_injection_is_detected_by_parity():
    """A silently corrupted shard changes the results: the digest
    machinery can see shard damage (SURVEY.md §5.3)."""
    from caps_tpu_torch.relational.session import result_digest
    from caps_tpu_torch.testing.faults import corrupt_shard
    clean = _session(mesh_shape=(8,))
    want = result_digest(create_graph(clean, CREATE, {})
                         .cypher("MATCH (p:P) RETURN p.x AS x"))
    hurt = _session(mesh_shape=(8,))
    with corrupt_shard(hurt, shard=0, flip_bits=100) as counts:
        g_hurt = create_graph(hurt, CREATE, {})
    assert counts["corrupted"] > 0
    got = result_digest(g_hurt.cypher("MATCH (p:P) RETURN p.x AS x"))
    assert got != want


def test_corrupt_shard_requires_mesh():
    import pytest
    from caps_tpu_torch.testing.faults import corrupt_shard
    with pytest.raises(ValueError):
        with corrupt_shard(caps_tpu_torch.local_session(device="cpu")):
            pass


# -- the size stream's host objects (consume_obj) ------------------------------

def test_consume_obj_records_and_replays_with_no_read():
    """A host object rides the size stream: eager and record runs call
    ``make`` (one counted read), replays serve the recorded object with
    no call; under generic replay with ``debug_obj_guard`` an object
    counts as unguarded until a relation-checked consume follows it."""
    import torch
    s = _session(mesh_shape=(8,), debug_obj_guard=True)
    be = s.backend
    calls = []

    def make():
        calls.append(1)
        return ("sample", len(calls))

    assert be.consume_obj(make) == ("sample", 1) and be.syncs == 1
    rec = []
    be.count_mode = ("record", rec)
    assert be.consume_obj(make) == ("sample", 2)
    be.count_mode = ("replay", rec, [0])
    assert be.consume_obj(make) == ("sample", 2) and len(calls) == 2
    rec.append(("size", 0, "exact"))
    be.count_mode = ("replay_gen", rec, [0])
    be._obj_unguarded = 0
    assert be.consume_obj(make) == ("sample", 2)
    assert be._obj_unguarded == 1
    be.consume_count(torch.tensor(0), relation="exact")
    assert be._obj_unguarded == 0 and len(calls) == 2
    be.count_mode = None


def test_merged_streams_take_the_latest_object():
    from caps_tpu_torch.backends.cuda.fused import _merge_streams
    a = [("__obj__", "old"), ("size", 3, "exact")]
    b = [("__obj__", "new"), ("size", 3, "exact")]
    assert _merge_streams(a, b) == b
    assert _merge_streams(a, [("size", 3, "exact")] * 2) is None
