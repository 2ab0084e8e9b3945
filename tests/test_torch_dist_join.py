"""Hand-scheduled distributed joins of the port (parallel/dist_join.py)
against the JAX package's, on 8-shard meshes.

The port runs an 8-shard mesh on the CPU; the JAX package runs its
8 virtual XLA devices (``tests/conftest.py``).  Each case is a
counterpart of ``tests/test_dist_join.py``: the same seeded graph goes
into both sessions with the same configuration, and every query must
give the same rows as the JAX package's sharded session and as the
port's unsharded session (as bags: a radix join's rows come out grouped
by hash partition), with the same ``dist_joins``, ``broadcast_joins``
and ``ici_bytes`` — the padded exchange buffers, equal byte for byte
only when the binning and the bin-widening retries are the same."""
import numpy as np
import pytest

import caps_tpu_torch
from caps_tpu.backends.tpu.session import TPUCypherSession
from caps_tpu.okapi.config import EngineConfig as JaxConfig
from caps_tpu_torch.okapi.config import EngineConfig
from caps_tpu_torch.parallel import collectives as C
from caps_tpu_torch.parallel import dist_join as DJ
from caps_tpu_torch.testing.bag import Bag
from tests.test_torch_algo import port_make_graph
from tests.util import make_graph as jax_make_graph

import torch


def _spec(n=400, m=1500, seed=5, hot_frac=0.0):
    rng = np.random.RandomState(seed)
    src = rng.randint(0, n, m)
    dst = rng.randint(0, n, m)
    if hot_frac:
        hot = rng.rand(m) < hot_frac
        dst = np.where(hot, 0, dst)
    nodes = {("P",): [{"_id": i, "v": int(rng.randint(0, 40))}
                      for i in range(n)]}
    rels = {"T": [(int(s), int(d), {"w": int(rng.randint(0, 3))})
                  for s, d in zip(src, dst)]}
    return nodes, rels


QUERIES = [
    "MATCH (a:P)-[r:T]->(b:P) WHERE a.v = 7 "
    "RETURN b.v AS v, count(*) AS c ORDER BY v",
    "MATCH (a:P {v: 3})-[r:T]->(b:P) RETURN r.w AS w, b.v AS v",
    "MATCH (a:P) OPTIONAL MATCH (a)-[r:T]->(b:P {v: 9}) "
    "RETURN a.v AS av, count(r) AS c ORDER BY av",
]
SKEW_Q = ("MATCH (a:P)-[r:T]->(b:P) WHERE b.v < 5 "
          "RETURN a.v AS av, b.v AS bv, r.w AS w")
LIST_Q = ("MATCH (a:P {v: 3})-[rs:T*1..2]->(b:P) "
          "RETURN b.v AS v, size(rs) AS n")
COUNTERS = ("dist_joins", "broadcast_joins", "salted_joins", "ici_bytes")


_GRAPHS: dict = {}
_RESULTS: dict = {}


def _graphs(cfg: dict, spec_args: tuple):
    """(port graph, JAX graph, unsharded port graph) for a config and a
    ``_spec`` argument tuple, built once per module."""
    key = (tuple(sorted(cfg.items())), spec_args)
    if key not in _GRAPHS:
        nodes, rels = _spec(*spec_args)
        port = caps_tpu_torch.local_session(device="cpu",
                                            config=EngineConfig(**cfg))
        jax_s = TPUCypherSession(config=JaxConfig(**cfg))
        plain = caps_tpu_torch.local_session(device="cpu")
        _GRAPHS[key] = (port_make_graph(port, nodes, rels),
                        jax_make_graph(jax_s, nodes, rels),
                        port_make_graph(plain, nodes, rels))
    return _GRAPHS[key]


def _run_both(cfg: dict, queries, spec_args=()):
    """Per query: (port rows, port metrics, JAX rows, JAX metrics,
    unsharded port rows) — each query's first run on fresh sessions
    (memoized: tests of one config share the runs)."""
    gp, gj, gu = _graphs(cfg, spec_args)
    out = []
    for q in queries:
        key = (tuple(sorted(cfg.items())), spec_args, q)
        if key not in _RESULTS:
            rp, rj = gp.cypher(q), gj.cypher(q)
            _RESULTS[key] = (rp.records.to_maps(), rp.metrics,
                             rj.records.to_maps(), rj.metrics,
                             gu.cypher(q).records.to_maps())
        out.append(_RESULTS[key])
    return out


def _check(cfg, queries, strategy, spec_args=()):
    fired = 0
    for got, pm, want, jm, plain in _run_both(cfg, queries, spec_args):
        assert Bag(got) == want
        assert Bag(got) == plain
        for k in COUNTERS:
            assert pm[k] == jm[k], (k, pm[k], jm[k])
        fired += pm[strategy]
        if pm[strategy]:
            assert pm["ici_bytes"] > 0
            assert 0 < pm["ici_payload_bytes"] <= pm["ici_bytes"]
    assert fired > 0, f"{strategy} never ran"


def test_radix_exchange_join_parity():
    _check(dict(mesh_shape=(8,), use_csr=False, broadcast_join_threshold=0),
           QUERIES, "dist_joins")


def test_radix_salted_join_parity():
    _check(dict(mesh_shape=(8,), use_csr=False, broadcast_join_threshold=0,
                join_salt=4), QUERIES, "dist_joins")


def test_broadcast_join_parity():
    _check(dict(mesh_shape=(8,), use_csr=False,
                broadcast_join_threshold=1 << 20),
           QUERIES, "broadcast_joins")


def test_skewed_key_parity_with_salt():
    """A hot destination key: the salted radix join equals the JAX
    package's — build rows replicate into every sub-bucket, probe rows
    round-robin across them."""
    _check(dict(mesh_shape=(8,), use_csr=False, broadcast_join_threshold=0,
                join_salt=4), [SKEW_Q], "dist_joins",
           spec_args=(400, 1500, 11, 0.4))


def test_radix_beats_broadcast_on_ici_bytes():
    """Each row crosses between shards once in the exchange, once per
    shard in the broadcast: the accounting shows it, as the JAX
    package's does."""
    bytes_by = {}
    for name, thresh in (("radix", 0), ("broadcast", 1 << 20)):
        (_, pm, _, jm, _), = _run_both(
            dict(mesh_shape=(8,), use_csr=False,
                 broadcast_join_threshold=thresh), [QUERIES[1]])
        assert pm["ici_bytes"] == jm["ici_bytes"]
        bytes_by[name] = pm["ici_bytes"]
    assert 0 < bytes_by["radix"] < bytes_by["broadcast"], bytes_by


def test_single_card_unaffected():
    """No mesh: the dist-join path stands down."""
    s = caps_tpu_torch.local_session(device="cpu")
    nodes, rels = _spec(n=100, m=300)
    g = port_make_graph(s, nodes, rels)
    res = g.cypher(QUERIES[0])
    assert res.metrics["dist_joins"] == 0
    assert res.metrics["broadcast_joins"] == 0
    assert "mesh" not in res.metrics


def test_auto_salt_on_skewed_keys():
    """Hot keys are DETECTED (no manual salt) and salted surgically, as
    in the JAX package."""
    cfg = dict(mesh_shape=(8,), use_csr=False, broadcast_join_threshold=0)
    (got, pm, want, jm, plain), = _run_both(
        cfg, [SKEW_Q], (400, 1500, 13, 0.5))
    assert Bag(got) == want == Bag(plain)
    assert pm["salted_joins"] > 0 and pm["salted_joins"] == jm["salted_joins"]
    assert pm["ici_bytes"] == jm["ici_bytes"]


def test_uniform_keys_do_not_salt():
    cfg = dict(mesh_shape=(8,), use_csr=False, broadcast_join_threshold=0)
    (got, pm, want, jm, _), = _run_both(cfg, [QUERIES[1]])
    assert pm["dist_joins"] > 0
    assert pm["salted_joins"] == 0 == jm["salted_joins"]


def test_payload_bytes_bracketed_by_wire_estimate():
    cfg = dict(mesh_shape=(8,), use_csr=False, broadcast_join_threshold=0)
    (_, pm, _, jm, _), = _run_both(cfg, [QUERIES[1]])
    assert 0 < pm["ici_payload_bytes"] <= pm["ici_bytes"]
    assert pm["ici_payload_bytes"] == jm["ici_payload_bytes"]


def test_dist_join_on_2d_mesh():
    """The radix exchange runs on a 2-D (DCN x shard) mesh, flattened
    DCN-major, with parity."""
    _check(dict(mesh_shape=(2, 4), use_csr=False,
                broadcast_join_threshold=0), [QUERIES[1]], "dist_joins")


def test_dist_join_carries_list_columns():
    """List columns (var-length relationship lists) ride the exchange
    as matrix payloads."""
    _check(dict(mesh_shape=(8,), use_csr=False, broadcast_join_threshold=0,
                use_ring=False), [LIST_Q], "dist_joins")


MAP_Q = ("MATCH (a:P) WHERE a.v < 12 WITH a, CASE WHEN a.v > 5 "
         "THEN {z: a.v, a: a.v % 3} ELSE {a: 'x', y: a.v, z: 0} END AS m "
         "MATCH (a)-[r:T]->(b:P) "
         "RETURN m, toString(m) AS t, m.z AS z, m.a AS ma, m.y AS y, "
         "keys(m) AS k, b.v AS v")


def test_dist_join_carries_maps_in_their_key_order():
    """A map column whose rows print their keys in orders of their own
    (``{z: …, a: …}`` beside ``{a: …, y: …, z: …}``) rides the exchange
    with its presence and its order in line with its keys: entries,
    keys and the text of each row are the JAX package's (which answers
    maps through its host fallback, so joins them unsharded)."""
    (got, pm, want, _jm, plain), = _run_both(
        dict(mesh_shape=(4,), use_csr=False, broadcast_join_threshold=0),
        [MAP_Q])
    assert pm["dist_joins"] > 0
    assert len(want) > 0 and {r["t"] for r in want} >= {
        "{'z': 6, 'a': 0}", "{'a': 'x', 'y': 0, 'z': 0}"}
    assert Bag(got) == want
    assert Bag(got) == plain


# -- the pieces, against the JAX functions ------------------------------------

def test_salted_dest_equals_the_jax_function():
    """Per-row destinations of seeded keys, negative keys, the join
    sentinels and keys near 2**62, with and without a salt."""
    import jax.numpy as jnp
    from caps_tpu.parallel.collectives import salted_dest as jax_dest
    rng = np.random.default_rng(0)
    keys = np.concatenate([
        rng.integers(-10**6, 10**6, 500),
        (1 << 62) + rng.integers(-1000, 1000, 50),
        -(1 << 62) + rng.integers(-1000, 1000, 50),
        np.array([DJ._L_NULL, DJ._R_NULL, -1, 0, 1, 2**63 - 1]),
    ]).astype(np.int64)
    sid = rng.integers(0, 4, keys.shape[0]).astype(np.int32)
    for n, salt in ((8, 1), (8, 4), (4, 2), (3, 1)):
        got = C.salted_dest(torch.from_numpy(keys), n, salt,
                            torch.from_numpy(sid)).numpy()
        want = np.asarray(jax_dest(jnp.asarray(keys), n, salt,
                                   jnp.asarray(sid)))
        assert np.array_equal(got, want), (n, salt)


def test_sentinels_never_match():
    """The null sentinels match no key and not each other."""
    rk = torch.tensor([DJ._R_NULL, 5, 7], dtype=torch.int64)
    rok = torch.tensor([True, True, True])
    lk = torch.tensor([DJ._L_NULL, DJ._R_NULL, 5], dtype=torch.int64)
    lok = torch.tensor([False, True, True])
    counts, _lo, _perm = DJ._probe_partition(rk, rok, lk, lok)
    # a dead probe row counts nothing; a live sentinel key matches the
    # build side's sentinel only where the build row is live (never
    # produced for a null: _where_key folds nulls per side)
    assert counts.tolist()[0] == 0 and counts.tolist()[2] == 1


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_bin_positions_equal_the_jax_function(seed):
    import jax.numpy as jnp
    from caps_tpu.parallel.collectives import bin_positions as jax_bins
    rng = np.random.default_rng(seed)
    dest = rng.integers(0, 8, 300).astype(np.int32)
    ok = rng.random(300) < 0.8
    for cap in (8, 40, 300):
        got = C.bin_positions(torch.from_numpy(dest), torch.from_numpy(ok),
                              8, cap)
        want = jax_bins(jnp.asarray(dest), jnp.asarray(ok), 8, cap)
        for g, w in zip(got, want):
            assert np.array_equal(np.asarray(g), np.asarray(w)), cap


@pytest.mark.parametrize("left_join", [False, True])
def test_shard_expansion_equals_expand_matches(left_join):
    """Phase 2's expansion through the expand-positions kernel's entry
    point equals the plain ``expand_matches`` (the JAX package's
    ``_expand_matches``) on every valid row."""
    rng = np.random.default_rng(7)
    counts = torch.from_numpy(rng.integers(0, 4, 64)).to(torch.int64)
    lok = torch.from_numpy(rng.random(64) < 0.8)
    counts = torch.where(lok, counts, torch.zeros_like(counts))
    lo = torch.from_numpy(rng.integers(0, 20, 64)).to(torch.int64)
    perm = torch.from_numpy(rng.permutation(100)).to(torch.int64)
    rok = torch.from_numpy(rng.random(100) < 0.9)
    got = DJ._expand_shard(counts, lo, perm, lok, rok, 256, left_join)
    want = DJ.expand_matches(counts, lo, perm, lok, rok, 256, left_join)
    assert torch.equal(got[2], want[2])
    valid = want[2]
    for g, w in zip(got[:2], want[:2]):
        assert torch.equal(g[valid], w[valid])
    assert torch.equal(got[3], want[3])


def test_generic_replay_of_a_salted_join():
    """The salt choice and the bin-widening retries record and replay:
    an exact replay reads no size, a generic replay across parameters
    stays exact, with the obj guard on."""
    nodes, rels = _spec(hot_frac=0.5, seed=13)
    cfg = EngineConfig(mesh_shape=(8,), use_csr=False,
                       broadcast_join_threshold=0, debug_obj_guard=True)
    s = caps_tpu_torch.local_session(device="cpu", config=cfg)
    plain = caps_tpu_torch.local_session(device="cpu")
    g = port_make_graph(s, nodes, rels)
    gu = port_make_graph(plain, nodes, rels)
    q = ("MATCH (a:P)-[r:T]->(b:P) WHERE b.v < $x "
         "RETURN a.v AS av, b.v AS bv, r.w AS w")
    for x in (5, 5, 9, 20, 2, 5):
        r = g.cypher(q, {"x": x})
        assert Bag(r.records.to_maps()) == \
            gu.cypher(q, {"x": x}).records.to_maps()
        assert r.metrics["dist_joins"] > 0
    r = g.cypher(q, {"x": 5})
    assert s.fused.last_mode == "replay"
    assert r.metrics["size_syncs"] == 0
    assert s.fused.generic_replays > 0


def test_generic_replay_with_a_changed_hot_key_rerecords():
    """The hot-key sample is a served host object under generic replay;
    when the parameters move the hot key, the recorded sample leaves the
    new hub unsalted, its rows overflow their bin, the ``dropped == 0``
    guard trips the end-of-query violation, and the query re-records on
    a fresh sample — the rows are never the stale sample's."""
    n_hub_rows = 600
    nodes = {("P",): [{"_id": i, "v": 1 if i < 300 else 2 if i < 600 else 0}
                      for i in range(640)]}
    # nodes with v = 1 point at hub 0, nodes with v = 2 at hub 1
    rels = {"T": [(i, 0 if i < 300 else 1, {"w": i % 3})
                  for i in range(n_hub_rows)]}
    cfg = EngineConfig(mesh_shape=(8,), use_csr=False,
                       broadcast_join_threshold=0, join_hot_factor=1.0,
                       debug_obj_guard=True)
    s = caps_tpu_torch.local_session(device="cpu", config=cfg)
    g = port_make_graph(s, nodes, rels)
    gu = port_make_graph(caps_tpu_torch.local_session(device="cpu"),
                         nodes, rels)
    q = ("MATCH (a:P)-[r:T]->(b:P) WHERE a.v = $v "
         "RETURN b.v AS bv, count(*) AS c")
    r1 = g.cypher(q, {"v": 1})
    assert r1.metrics["salted_joins"] > 0
    mismatches = s.fused.mismatches
    r2 = g.cypher(q, {"v": 2})
    assert Bag(r2.records.to_maps()) == gu.cypher(q, {"v": 2}) \
        .records.to_maps()
    assert s.fused.mismatches == mismatches + 1
    assert s.fused.last_mode == "record"
