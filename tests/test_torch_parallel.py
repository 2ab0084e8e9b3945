"""The port's mesh, collectives, sharded query steps and ring schedules
(``caps_tpu_torch/parallel``) against the JAX package's on 8-shard
meshes.

Each test is a counterpart of one of ``tests/test_parallel.py``'s: the
port runs an 8-shard mesh on the CPU, the JAX package its 8 virtual XLA
devices (``tests/conftest.py``), on the same seeded numpy inputs, and
every count must be equal exactly.  ``test_graft_entry_points`` has no
counterpart (``__graft_entry__.py`` is the JAX package's); in its place
the sharded two-hop step runs at the graft's shapes."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import caps_tpu_torch
from caps_tpu.backends.tpu.session import TPUCypherSession
from caps_tpu.okapi.config import EngineConfig as JaxConfig
from caps_tpu.parallel import mesh as jax_mesh
from caps_tpu.parallel import query_step as jax_qs
from caps_tpu.parallel import ring as jax_ring
from caps_tpu.testing.factory import create_graph as jax_create_graph
from caps_tpu_torch.okapi.config import EngineConfig
from caps_tpu_torch.parallel import query_step as QS
from caps_tpu_torch.parallel import ring as R
from caps_tpu_torch.parallel.mesh import make_mesh, make_mesh_2d
from caps_tpu_torch.relational.var_expand import VarExpandOp
from caps_tpu_torch.testing.bag import Bag
from caps_tpu_torch.testing.factory import create_graph


@pytest.fixture(scope="module")
def mesh():
    return make_mesh(8, device="cpu")


@pytest.fixture(scope="module")
def jmesh():
    return jax_mesh.make_mesh(8)


def _t(x):
    return torch.from_numpy(np.ascontiguousarray(x))


def _edges(mesh, args, at):
    """``args`` as tensors, the edge arrays at positions ``at`` cut into
    the shards' resident blocks (the port's stages take blocks)."""
    from caps_tpu_torch.parallel.collectives import shard_blocks
    return [shard_blocks(_t(a), mesh) if i in at else _t(a)
            for i, a in enumerate(args)]


def _same(port_rows, jax_rows) -> bool:
    """Rows equal as bags; entity values of the two packages are
    different classes, so rows compare by their text."""
    return sorted(map(repr, port_rows)) == sorted(map(repr, jax_rows))


def _graph(n_nodes, n_edges, seed=7):
    rng = np.random.RandomState(seed)
    names = rng.randint(0, 5, n_nodes, dtype=np.int32)
    src = rng.randint(0, n_nodes, n_edges, dtype=np.int32)
    dst = rng.randint(0, n_nodes, n_edges, dtype=np.int32)
    ok = np.ones(n_edges, bool)
    return names, src, dst, ok


def _two_hop_both(mesh_n, names, src, dst, ok, seed_code, n_nodes):
    pmesh = make_mesh(mesh_n, device="cpu")
    step = QS.make_sharded_two_hop(pmesh, n_nodes)
    total, cnt2 = step(*_edges(pmesh, (names, src, dst, ok), (1, 2, 3)),
                       seed_code)
    jstep = jax_qs.make_sharded_two_hop(jax_mesh.make_mesh(mesh_n), n_nodes)
    jt, jc = jstep(*map(jnp.asarray, (names, src, dst, ok)),
                   jnp.int32(seed_code))
    return int(total), cnt2.numpy(), int(jt), np.asarray(jc)


def test_sharded_two_hop_matches_reference():
    names, src, dst, ok = _graph(64, 8 * 32)
    total, cnt2, jt, jc = _two_hop_both(8, names, src, dst, ok, 3, 64)
    assert total == jt and np.array_equal(cnt2, jc)
    assert int(cnt2.sum()) == total


def test_mesh_size_is_config():
    """The same step on 1-, 2- and 8-shard meshes, each equal to the JAX
    package's mesh of that size."""
    names, src, dst, ok = _graph(32, 8 * 8, seed=9)
    totals = set()
    for n in (1, 2, 8):
        total, _c, jt, _jc = _two_hop_both(n, names, src, dst, ok, 2, 32)
        assert total == jt
        totals.add(total)
    assert len(totals) == 1


def test_mesh_defaults_to_the_card():
    """A mesh built without a device is on the card, and raises where
    none is visible: it never falls back to the CPU."""
    if torch.cuda.is_available():
        m = make_mesh(2)
        assert all(d.type == "cuda" for d in m.shard_devices)
    else:
        for build in (lambda: make_mesh(4), lambda: make_mesh_2d((2, 2))):
            with pytest.raises(RuntimeError, match="device='cpu'"):
                build()
    assert make_mesh(4, device="cpu").distinct_devices == \
        (torch.device("cpu"),)


@pytest.mark.parametrize("op", ["pmin", "pmax", "psum"])
@pytest.mark.parametrize("dtype", [np.float32, np.int32])
def test_all_reduces_match_lax(mesh, jmesh, op, dtype):
    """The mesh's all-reduces equal ``lax.pmin`` / ``pmax`` / ``psum``
    over the JAX package's 8 devices bit for bit: NaN of both signs,
    ±0 and the extremes spread over the shards."""
    import jax
    from jax.sharding import PartitionSpec as P
    from caps_tpu.parallel.compat import shard_map
    from caps_tpu_torch.parallel import collectives as C
    rng = np.random.default_rng(3)
    x = rng.integers(-50, 50, (8, 16)).astype(dtype)
    if dtype == np.float32:
        x[:, 0] = np.where(np.arange(8) % 2, 0.0, -0.0)
        x[3, 1] = np.float32("nan")
        x[0, 2] = -np.float32("nan")
        x[:, 3] = np.float32("nan")
        x[5, 4] = np.float32("inf")
        x[6, 5] = np.float32("-inf")
    else:
        x[2, 1] = np.iinfo(np.int32).max
        x[4, 2] = np.iinfo(np.int32).min
    lax_op = {"pmin": jax.lax.pmin, "pmax": jax.lax.pmax,
              "psum": jax.lax.psum}[op]
    want = np.asarray(jax.jit(shard_map(
        lambda b: lax_op(b[0], "shard"), mesh=jmesh, in_specs=(P("shard"),),
        out_specs=P(), check_vma=False))(jnp.asarray(x)))
    port_op = {"pmin": C.pmin, "pmax": C.pmax, "psum": C.global_sum}[op]
    got = port_op([_t(r) for r in x], [mesh.lead])[0].numpy()
    assert got.dtype == want.dtype
    np.testing.assert_array_equal(np.isnan(got), np.isnan(want))
    keep = ~np.isnan(want)
    np.testing.assert_array_equal(got[keep].view(np.int32),
                                  want[keep].view(np.int32))


def test_collectives_smoke(mesh, jmesh):
    x = np.arange(8 * 8, dtype=np.int32)
    got = QS.make_collectives_smoke(mesh)(_t(x))
    want = jax_qs.make_collectives_smoke(jmesh)(jnp.asarray(x))
    assert int(got) == int(want)


def test_sharded_two_hop_at_the_graft_shapes():
    """In place of ``test_graft_entry_points``: the two-hop step at the
    graft entry's shapes (64 nodes, 256 edges, seed 0) on an 8-shard
    mesh equals the JAX package's mesh."""
    rng = np.random.RandomState(0)
    names = rng.randint(0, 8, 64, dtype=np.int32)
    src = rng.randint(0, 64, 256, dtype=np.int32)
    dst = rng.randint(0, 64, 256, dtype=np.int32)
    ok = np.ones(256, bool)
    total, cnt2, jt, jc = _two_hop_both(8, names, src, dst, ok, 3, 64)
    assert total == jt >= 0 and np.array_equal(cnt2, jc)


@pytest.mark.parametrize("masked", [False, True])
def test_ring_khop_matches_reference(mesh, jmesh, masked):
    n_nodes, n_edges, hops = 64, 256, 3
    rng = np.random.RandomState(7)
    src = rng.randint(0, n_nodes, n_edges, dtype=np.int32)
    dst = rng.randint(0, n_nodes, n_edges, dtype=np.int32)
    ok = rng.rand(n_edges) < 0.9
    seed = (rng.rand(n_nodes) < 0.2).astype(np.int32)
    mask = (rng.rand(n_nodes) < 0.7).astype(np.int32)
    extra = (mask,) if masked else ()
    total, blocks = R.make_ring_khop(mesh, n_nodes, hops, masked=masked)(
        *_edges(mesh, (seed, src, dst, ok) + extra, (1, 2, 3)))
    jt, jb = jax_ring.make_ring_khop(jmesh, n_nodes, hops, masked=masked)(
        *map(jnp.asarray, (seed, src, dst, ok) + extra))
    assert int(total) == int(jt)
    assert np.array_equal(blocks.numpy(), np.asarray(jb))
    if not masked:
        wt, wc = R.ring_khop_reference(*map(_t, (seed, src, dst, ok)), hops,
                                       n_nodes)
        jwt, jwc = jax_ring.ring_khop_reference(
            *map(jnp.asarray, (seed, src, dst, ok)), hops, n_nodes)
        assert int(wt) == int(jwt) == int(total)
        assert np.array_equal(wc.numpy(), np.asarray(jwc))


def test_ring_varexpand_matrix_matches_reference(mesh, jmesh):
    n_nodes, n_edges, n_seeds = 64, 256, 9
    rng = np.random.RandomState(11)
    src = rng.randint(0, n_nodes, n_edges).astype(np.int32)
    dst = rng.randint(0, n_nodes, n_edges).astype(np.int32)
    src[:20] = dst[:20]
    ok = rng.rand(n_edges) < 0.9
    seeds = rng.choice(n_nodes, size=n_seeds, replace=False)
    f0 = np.zeros((n_seeds, n_nodes), dtype=np.int64)
    f0[np.arange(n_seeds), seeds] = 1
    tmask = (rng.rand(n_nodes) < 0.7).astype(np.int64)
    args = (f0, src, dst, ok, tmask)
    for lengths in [(1,), (2,), (1, 2), (0, 1, 2), (0,)]:
        got = R.make_ring_varexpand(mesh, n_nodes, lengths)(
            *_edges(mesh, args, (1, 2, 3)))
        want = jax_ring.make_ring_varexpand(jmesh, n_nodes, lengths)(
            *map(jnp.asarray, args))
        twin = R.ring_varexpand_reference(*map(_t, args), lengths)
        assert np.array_equal(got.numpy(), np.asarray(want)), lengths
        assert torch.equal(got, twin), lengths


def test_ring_varexpand_pathcount_oracle(mesh, jmesh):
    n_nodes, n_edges = 16, 48
    rng = np.random.RandomState(3)
    src = rng.randint(0, n_nodes, n_edges).astype(np.int32)
    dst = rng.randint(0, n_nodes, n_edges).astype(np.int32)
    src[:6] = dst[:6]
    ok = np.ones(n_edges, bool)
    f0 = np.eye(n_nodes, dtype=np.int64)
    tmask = np.ones(n_nodes, dtype=np.int64)
    args = (f0, src, dst, ok, tmask)
    got = R.make_ring_varexpand(mesh, n_nodes, (1, 2))(
        *_edges(mesh, args, (1, 2, 3)))
    want = jax_ring.make_ring_varexpand(jmesh, n_nodes, (1, 2))(
        *map(jnp.asarray, args))
    assert np.array_equal(got.numpy(), np.asarray(want))
    brute = np.zeros((n_nodes, n_nodes), dtype=np.int64)
    for e1 in range(n_edges):
        brute[src[e1], dst[e1]] += 1
        for e2 in range(n_edges):
            if e1 != e2 and dst[e1] == src[e2]:
                brute[src[e1], dst[e2]] += 1
    assert np.array_equal(got.numpy(), brute)


VAR_CREATE = ("CREATE (a:Person {name:'Alice'}), (b:Person {name:'Bob'}), "
              "(c:Person {name:'Carol'}), (d {name:'Dave'}), "
              "(a)-[:KNOWS]->(b), (b)-[:KNOWS]->(c), (a)-[:KNOWS]->(c), "
              "(c)-[:KNOWS]->(d), (d)-[:KNOWS]->(d), (c)-[:LIKES]->(a)")
VAR_CASES = [
    ("MATCH (a)-[:KNOWS*1..2]->(b) RETURN a.name AS a, b.name AS b",
     "ring-matrix"),
    ("MATCH (a)<-[:KNOWS*1..2]-(b) RETURN a.name AS a, b.name AS b",
     "ring-matrix"),
    ("MATCH (a)-[:KNOWS*0..2]->(b:Person) RETURN b.name AS b",
     "ring-matrix"),
    ("MATCH (a:Person)-[*1..2]->(b) RETURN a.name AS a, b.name AS b",
     "ring-matrix"),
    ("MATCH (a)-[r:KNOWS*1..2]->(b) RETURN a.name AS a, size(r) AS n",
     "ring-matrix"),
    ("MATCH (a)-[r:KNOWS*1..2]->(b) RETURN a.name AS a, r AS r", "join"),
    ("MATCH (a)-[:KNOWS*1..2]-(b) RETURN a.name AS a, b.name AS b",
     "ring-matrix"),
    ("MATCH (a)-[*0..2]-(b:Person) RETURN b.name AS b", "ring-matrix"),
    ("MATCH (a)-[:KNOWS*1..3]->(b) RETURN a.name AS a, b.name AS b",
     "ring-matrix"),
    ("MATCH (a)-[:KNOWS*1..4]->(b) RETURN a.name AS a, b.name AS b",
     "join"),
]


def _strategy(res):
    ve = [m for m in res.metrics["operators"] if m["op"] == "VarExpand"]
    return ve[0]["strategy"] if ve else None


def _jax_oracle(create):
    """The JAX package's local oracle graph (its reference's engine
    tests compare their sharded sessions with it)."""
    from caps_tpu.backends.local.session import LocalCypherSession
    return jax_create_graph(LocalCypherSession(), create, {})


@pytest.fixture(scope="module")
def var_graphs():
    port = caps_tpu_torch.local_session(
        device="cpu", config=EngineConfig(mesh_shape=(8,)))
    return create_graph(port, VAR_CREATE, {}), _jax_oracle(VAR_CREATE)


@pytest.mark.parametrize("case", range(len(VAR_CASES)))
def test_varexpand_rides_ring_on_mesh(var_graphs, case):
    """On a mesh a var-length query whose relationship variable is dead
    downstream runs as ``ring-matrix`` and answers as the JAX package's
    oracle, on the strategy the JAX package's sharded session takes
    (``tests/test_parallel.py``); per-path data stays on joins."""
    q, strategy = VAR_CASES[case]
    gp, gj = var_graphs
    rp = gp.cypher(q)
    assert _same(rp.records.to_maps(), gj.cypher(q).records.to_maps()), q
    assert _strategy(rp) == strategy


def test_ring_varexpand_undirected_oracle(mesh, jmesh):
    n_nodes, n_edges = 16, 40
    rng = np.random.RandomState(9)
    src = rng.randint(0, n_nodes, n_edges).astype(np.int32)
    dst = rng.randint(0, n_nodes, n_edges).astype(np.int32)
    src[:5] = dst[:5]
    src[5:8], dst[5:8] = src[8:11], dst[8:11]
    nonloop = src != dst
    a = np.concatenate([src, dst[nonloop]])
    b = np.concatenate([dst, src[nonloop]])
    pad = (-len(a)) % 8
    a = np.concatenate([a, np.zeros(pad, np.int32)])
    b = np.concatenate([b, np.zeros(pad, np.int32)])
    okp = np.concatenate([np.ones(len(a) - pad, bool), np.zeros(pad, bool)])
    f0 = np.eye(n_nodes, dtype=np.int64)
    tmask = np.ones(n_nodes, dtype=np.int64)
    args = (f0, a, b, okp, tmask)
    got = R.make_ring_varexpand(mesh, n_nodes, (1, 2),
                                correction="degree")(
        *_edges(mesh, args, (1, 2, 3)))
    want = jax_ring.make_ring_varexpand(jmesh, n_nodes, (1, 2),
                                        correction="degree")(
        *map(jnp.asarray, args))
    assert np.array_equal(got.numpy(), np.asarray(want))
    assert got.sum() > 0


def test_varexpand_matrix_single_card():
    """Off-mesh an eligible var-expand takes the single-device
    ``matrix`` strategy, as in the JAX package."""
    create = ("CREATE (a:Person {name:'Alice'}), (b:Person {name:'Bob'}), "
              "(c:Person {name:'Carol'}), (a)-[:KNOWS]->(b), "
              "(b)-[:KNOWS]->(c), (c)-[:KNOWS]->(c)")
    gp = create_graph(caps_tpu_torch.local_session(device="cpu"), create, {})
    gj = jax_create_graph(TPUCypherSession(), create, {})
    for q, strat in [
        ("MATCH (a)-[:KNOWS*1..2]->(b) RETURN a.name AS a, b.name AS b",
         "matrix"),
        ("MATCH (a)-[:KNOWS*1..2]-(b) RETURN a.name AS a, b.name AS b",
         "matrix"),
        ("MATCH (a)-[r:KNOWS*1..2]->(b) RETURN size(r) AS n", "matrix"),
        ("MATCH (a)-[r:KNOWS*1..2]->(b) RETURN r AS r", "join"),
    ]:
        rp = gp.cypher(q)
        assert _same(rp.records.to_maps(), gj.cypher(q).records.to_maps())
        assert _strategy(rp) == strat, q


def test_two_level_mesh_parity():
    """A 2-D (DCN x shard) mesh runs the engine with the JAX package's
    oracle's rows; the var-expand takes the single-device ``matrix``
    form on it, as the JAX package's 2-D sessions do, and the count
    pushdown segment-sums each shard's resident edge block and reports
    ``spmv-sharded``, as the JAX package does."""
    create = ("CREATE (a:Person {name:'Ada', age:30}), "
              "(b:Person {name:'Bo', age:40}), (c:Person {name:'Cy'}), "
              "(a)-[:KNOWS]->(b), (b)-[:KNOWS]->(c), (a)-[:KNOWS]->(c)")
    port = caps_tpu_torch.local_session(
        device="cpu", config=EngineConfig(mesh_shape=(2, 4)))
    assert port.backend.mesh.axis_names == ("dcn", "shard")
    assert port.backend.mesh.devices.shape == (2, 4)
    mesh2 = make_mesh_2d((2, 4), device="cpu")
    assert mesh2.size == 8 and [s.index for s in mesh2.devices[1]] == \
        [4, 5, 6, 7]
    gp = create_graph(port, create, {})
    gj = _jax_oracle(create)
    for q in [
        "MATCH (a:Person)-[:KNOWS]->(b) RETURN a.name AS a, b.name AS b",
        "MATCH (a)-[:KNOWS*1..2]->(b) RETURN a.name AS a, b.name AS b",
        "MATCH (a:Person)-[:KNOWS]->(b)-[:KNOWS]->(c) "
        "WHERE a.name='Ada' RETURN count(*) AS c",
        "MATCH (p:Person) RETURN p.name AS n, min(p.age) AS a ORDER BY n",
    ]:
        assert Bag(gp.cypher(q).records.to_maps()) == \
            gj.cypher(q).records.to_maps(), q
    res = gp.cypher("MATCH (a)-[:KNOWS*1..2]->(b) RETURN b.name AS b")
    assert _strategy(res) == "matrix"
    res = gp.cypher("MATCH (a:Person)-[:KNOWS]->(b)-[:KNOWS]->(c) "
                    "WHERE a.name='Ada' RETURN count(*) AS c")
    cp = [m for m in res.metrics["operators"] if m["op"] == "CountPattern"]
    assert cp and cp[0]["strategy"] == "spmv-sharded"


def test_count_chain_rides_ring_on_mesh():
    """A uniform count chain on a 1-D mesh takes the ring and equals the
    JAX package's sharded session (with its strategy)."""
    create = ("CREATE (a:Person {name:'Ada'}), (b:Person {name:'Bo'}), "
              "(c:Person {name:'Cy'}), (d:Person {name:'Di'}), "
              "(a)-[:KNOWS]->(b), (b)-[:KNOWS]->(c), (a)-[:KNOWS]->(c), "
              "(c)-[:KNOWS]->(d), (d)-[:KNOWS]->(a), (b)-[:KNOWS]->(b)")
    gp = create_graph(caps_tpu_torch.local_session(
        device="cpu", config=EngineConfig(mesh_shape=(8,))), create, {})
    gj = jax_create_graph(TPUCypherSession(
        config=JaxConfig(mesh_shape=(8,))), create, {})
    for q in ["MATCH (a:Person)-[:KNOWS]->(b:Person)-[:KNOWS]->(c:Person) "
              "RETURN count(*) AS c",
              "MATCH (a:Person)-[:KNOWS*1..1]->(b) RETURN count(*) AS c",
              "MATCH (a:Person {name:'Ada'})-[:KNOWS]->(b)-[:KNOWS]->(c) "
              "RETURN count(*) AS c"]:
        rp, rj = gp.cypher(q), gj.cypher(q)
        assert rp.records.to_maps() == rj.records.to_maps(), q
        sp = [m["strategy"] for m in rp.metrics["operators"]
              if m["op"] == "CountPattern"]
        sj = [m["strategy"] for m in rj.metrics["operators"]
              if m["op"] == "CountPattern"]
        assert sp == sj, (q, sp, sj)


def test_varexpand_matrix_three_hops_oracle():
    rng = np.random.RandomState(5)
    n = 7
    parts = [f"(n{i}:P {{v: {i}}})" for i in range(n)]
    edges = [f"(n{rng.randint(0, n)})-[:K]->(n{rng.randint(0, n)})"
             for _ in range(14)]
    edges += ["(n0)-[:K]->(n0)", "(n1)-[:K]->(n2)", "(n1)-[:K]->(n2)"]
    create = "CREATE " + ", ".join(parts + edges)
    gj = _jax_oracle(create)
    gs = create_graph(caps_tpu_torch.local_session(
        device="cpu", config=EngineConfig(mesh_shape=(8,))), create, {})
    gt = create_graph(caps_tpu_torch.local_session(device="cpu"), create, {})
    for pat in ["-[:K*1..3]->", "<-[:K*1..3]-", "-[:K*1..3]-",
                "-[:K*3..3]->", "-[:K*0..3]-", "-[:K*2..3]-"]:
        q = f"MATCH (a){pat}(b) RETURN a.v AS a, b.v AS b"
        want = gj.cypher(q).records.to_maps()
        for g, strat in ((gt, "matrix"), (gs, "ring-matrix")):
            res = g.cypher(q)
            assert Bag(res.records.to_maps()) == want, pat
            assert _strategy(res) == strat, pat


def test_ring_varexpand3_kernel_vs_twin(mesh, jmesh):
    n_nodes, n_rels = 16, 30
    rng = np.random.RandomState(2)
    src = rng.randint(0, n_nodes, n_rels).astype(np.int32)
    dst = rng.randint(0, n_nodes, n_rels).astype(np.int32)
    src[:4] = dst[:4]
    rid = np.arange(n_rels)
    nonloop = src != dst
    frm = np.concatenate([src, dst[nonloop]]).astype(np.int32)
    to = np.concatenate([dst, src[nonloop]]).astype(np.int32)
    rids = np.concatenate([rid, rid[nonloop]])
    sp13, spt = R.build_iso3_sparse(frm, to, rids, n_nodes)

    def pad(xs):
        p = (-len(xs[0])) % 8
        return tuple(np.concatenate([x, np.zeros(p, x.dtype)]) for x in xs)

    frm_p, to_p = pad((frm, to))
    ok_p = np.arange(len(frm_p)) < len(frm)
    args = (np.eye(n_nodes, dtype=np.int64), frm_p, to_p, ok_p,
            np.ones(n_nodes, dtype=np.int64)) + pad(sp13) + pad(spt)
    for lengths in [(1, 2, 3), (0, 1, 2, 3), (3,)]:
        got = R.make_ring_varexpand3(mesh, n_nodes, lengths,
                                     correction="degree")(
            *_edges(mesh, args, (1, 2, 3, 5, 6, 7, 8, 9, 10)))
        want = jax_ring.make_ring_varexpand3(jmesh, n_nodes, lengths,
                                             correction="degree")(
            *map(jnp.asarray, args))
        twin = R.ring_varexpand3_reference(
            *map(_t, args[:5]), lengths, tuple(map(_t, args[5:8])),
            tuple(map(_t, args[8:])), correction="degree")
        assert np.array_equal(got.numpy(), np.asarray(want)), lengths
        assert torch.equal(got, twin)
        assert got.sum() > 0


@pytest.mark.parametrize("sharded", [False, True])
def test_varexpand_matrix_seed_blocking(monkeypatch, sharded):
    """Large seed sets run the matrix in fixed-size chunks whose pair
    tables union (forced by shrinking the working-set cap), on one
    device and on the ring, with the JAX package's rows."""
    rng = np.random.RandomState(3)
    n = 9
    parts = [f"(n{i}:P {{v: {i}}})" for i in range(n)]
    edges = [f"(n{rng.randint(0, n)})-[:K]->(n{rng.randint(0, n)})"
             for _ in range(18)]
    create = "CREATE " + ", ".join(parts + edges)
    q = "MATCH (a)-[:K*1..2]-(b) RETURN a.v AS a, b.v AS b"
    want = jax_create_graph(TPUCypherSession(), create, {}
                            ).cypher(q).records.to_maps()
    monkeypatch.setattr(VarExpandOp, "_RING_MAX_MATRIX", 100)
    cfg = EngineConfig(mesh_shape=(8,)) if sharded else None
    res = create_graph(caps_tpu_torch.local_session(device="cpu",
                                                    config=cfg),
                       create, {}).cypher(q)
    assert Bag(res.records.to_maps()) == want
    assert _strategy(res) == ("ring-matrix" if sharded else "matrix")
