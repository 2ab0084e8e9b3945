"""Row-resident shards (``caps_tpu_torch/backends/cuda/sharded.py``)
against the JAX package's ``NamedSharding`` row placement.

On a mesh, ``DeviceBackend.place_column`` splits every per-row tensor of
a column whose rows divide over the shards into per-slot blocks,
DCN-major, and leaves the rest whole; side columns (inner lists, the
lists and maps "any" values hold) stay whole.  The same seeded graph
goes through the port's row-resident sessions and the JAX package's
8-device sessions (``tests/conftest.py`` gives XLA 8 virtual CPU
devices) on ``(8,)`` and ``(2, 4)`` meshes: every query equal, every
``CountPattern`` strategy equal, exact replays reading no size, and a
write then a compaction then a read on a mesh."""
import numpy as np
import pytest
import torch

import caps_tpu_torch
from caps_tpu.backends.tpu.session import TPUCypherSession
from caps_tpu.okapi.config import EngineConfig as JaxConfig
from caps_tpu_torch.backends.cuda.sharded import ShardedTable, resident_bytes
from caps_tpu_torch.okapi.config import EngineConfig
from caps_tpu_torch.okapi.types import (
    CTAny, CTInteger, CTList, CTMap, CTString,
)
from caps_tpu_torch.testing.bag import Bag
from tests.test_torch_algo import port_make_graph
from tests.util import make_graph as jax_make_graph

MESHES = [(8,), (2, 4)]

COLUMNS = {
    "i": ([3, None, 7, 1, 9, 2, 5], CTInteger),
    "s": (["a", "b", None, "d", "e", "f", "g"], CTString),
    "l": ([[1, 2], None, [], [3], [4, 5, 6], [7], [8]], CTList(CTInteger)),
    "n": ([[[1], [2, 3]], None, [[4]], [], [[5, 6]], [[7]], [[8, 9]]],
          CTList(CTList(CTInteger))),
    "m": ([{"k": 1}, None, {"k": 2, "j": "x"}, {"k": 3}, {"j": "y"},
           {"k": 4}, {"k": 5}], CTMap),
    "x": ([[1, 2], "a", None, {"k": [3]}, [[4]], 5.5, {"k": None}], CTAny),
}


def _session(mesh_shape=(), **cfg):
    return caps_tpu_torch.local_session(device="cpu", config=EngineConfig(
        mesh_shape=tuple(mesh_shape), **cfg))


def _tensors(col):
    """Every per-row tensor of a column (a map's key columns too)."""
    out = [getattr(col, f) for f in ("data", "valid", "lens", "elem_valid",
                                     "tags", "order")
           if getattr(col, f) is not None]
    for c in (col.fields or {}).values():
        out += _tensors(c)
    return out


@pytest.mark.parametrize("shape", MESHES, ids=str)
def test_place_column_splits_every_per_row_tensor(shape):
    """Each per-row tensor's blocks sit on their slots (DCN-major on the
    2-D mesh: block i is ``mesh.devices.flat[i]``'s), each block holds
    its slot's rows of the whole column and owns its storage; the side
    columns stay whole, one object every block shares."""
    data = {c: v for c, (v, _t) in COLUMNS.items()}
    types = {c: t for c, (_v, t) in COLUMNS.items()}
    s = _session(shape)
    t = s.table_factory.from_columns(data, types)
    plain = _session().table_factory.from_columns(data, types)
    mesh = s.backend.mesh
    assert isinstance(t, ShardedTable) and len(t.parts) == 8
    assert [p.backend.slot for p in t.parts] == list(mesh.devices.flat)
    assert [p.backend.slot.index for p in t.parts] == list(range(8))
    cap = plain.capacity
    b = cap // 8
    for c in COLUMNS:
        whole = plain._cols[c]
        for i, p in enumerate(t.parts):
            blk = p._cols[c]
            assert blk.capacity == b
            for got, want in zip(_tensors(blk), _tensors(whole)):
                assert got.device == mesh.devices.flat[i].device
                assert torch.equal(got, want[i * b:(i + 1) * b])
                assert got.untyped_storage().nbytes() == got.nbytes
            for side in ("child", "maps"):
                w = getattr(whole, side)
                got = getattr(blk, side)
                assert (got is None) == (w is None)
                if w is not None:
                    assert got is getattr(t.parts[0]._cols[c], side)
                    assert got.capacity == w.capacity
        assert t.column_values(c) == plain.column_values(c) == data[c]
    assert [p.size for p in t.parts] == [min(max(7 - i * b, 0), b)
                                         for i in range(8)]


def test_rows_that_do_not_divide_stay_whole():
    """A 3-shard mesh does not divide a 256-row capacity: the column
    stays whole on the lead, as the JAX package leaves it."""
    s = _session((3,))
    col = s.table_factory.from_columns({"i": [1, 2]}, {"i": CTInteger})
    assert not isinstance(col, ShardedTable)
    assert col._cols["i"].capacity == 256
    placed = s.backend.place_column(col._cols["i"])
    assert placed is col._cols["i"]


def test_place_column_follows_the_jax_rule():
    """The seam returns per-slot blocks where the rows divide and the
    column itself otherwise, as ``place_rows`` does."""
    from caps_tpu_torch.backends.cuda.column import make_column
    s = _session((8,))
    be = s.backend
    col = make_column([1, 2, 3], CTInteger, 256, be.pool, be.device)
    blocks = be.place_column(col)
    assert isinstance(blocks, list) and len(blocks) == 8
    assert torch.equal(torch.cat([b.data for b in blocks]), col.data)
    small = make_column([1, 2, 3], CTInteger, 16, be.pool, be.device)
    assert [b.capacity for b in be.place_column(small)] == [2] * 8
    for cap in (12, 13):
        odd = make_column([1, 2, 3], CTInteger, cap, be.pool, be.device)
        assert be.place_column(odd) is odd


# -- the query set against the JAX package's sharded sessions ---------------

def _spec(n=240, m=900, seed=11):
    rng = np.random.RandomState(seed)
    cities = [f"c{i}" for i in range(6)]
    nodes = {("P",): [{"_id": i, "v": int(rng.randint(0, 30)),
                       "c": cities[rng.randint(0, 6)],
                       "l": [int(x) for x in rng.randint(0, 9,
                                                         rng.randint(0, 4))]}
                      for i in range(n)]}
    rels = {"T": [(int(a), int(b), {"w": int(rng.randint(0, 4))})
                  for a, b in zip(rng.randint(0, n, m),
                                  rng.randint(0, n, m))]}
    return nodes, rels


QUERIES = {
    "join": "MATCH (a:P)-[r:T]->(b:P) WHERE a.v < 6 "
            "RETURN a.v AS av, b.v AS bv, r.w AS w",
    "optional": "MATCH (a:P) WHERE a.v < 4 OPTIONAL MATCH "
                "(a)-[r:T]->(b:P {v: 9}) RETURN a.v AS av, b.v AS bv",
    "varlen": "MATCH (a:P {v: 3})-[:T*1..2]->(b:P) RETURN b.v AS v",
    "varlen_rels": "MATCH (a:P {v: 3})-[rs:T*1..2]->(b:P) "
                   "RETURN b.v AS v, size(rs) AS n",
    "dense_group": "MATCH (a:P) RETURN a.c AS c, count(*) AS n, "
                   "min(a.v) AS lo, max(a.v) AS hi",
    "sorted_group": "MATCH (a:P)-[:T]->(b:P) RETURN a.v % 5 AS k, "
                    "count(*) AS n, sum(b.v) AS s",
    "distinct": "MATCH (a:P)-[:T]->(b:P) WHERE a.v < 10 "
                "RETURN DISTINCT b.c AS c",
    "order_limit": "MATCH (a:P) RETURN a.v AS v, a._id AS id "
                   "ORDER BY v DESC, id LIMIT 7",
    "unwind": "MATCH (a:P) WHERE a.v < 6 UNWIND a.l AS x "
              "RETURN a.v AS v, x",
    "collect": "MATCH (a:P)-[:T]->(b:P) WHERE a.v < 4 "
               "RETURN a.v AS v, collect(b.v) AS bs",
    "count_ring": "MATCH (a:P)-[:T]->(b:P)-[:T]->(c:P) RETURN count(*) AS c",
    "count_sharded": "MATCH (a:P)-[:T]->(b:P)-[:T]->(c:P) "
                     "WHERE a.v = 3 AND c.v < 20 RETURN count(*) AS c",
    "count_varlen": "MATCH (a:P {v: 5})-[:T*1..2]->(c) RETURN count(*) AS c",
}

_GRAPHS: dict = {}


def _graphs(shape, **cfg):
    key = (shape, tuple(sorted(cfg.items())))
    if key not in _GRAPHS:
        nodes, rels = _spec()
        port = _session(shape, **cfg)
        jax_s = TPUCypherSession(config=JaxConfig(mesh_shape=shape, **cfg))
        _GRAPHS[key] = (port_make_graph(port, nodes, rels),
                        jax_make_graph(jax_s, nodes, rels), port)
    return _GRAPHS[key]


def _norm(rows):
    """Rows as a bag, collected lists as bags (a collect's element order
    follows the rows' order, which the layouts need not share)."""
    return Bag([{k: (sorted(v) if isinstance(v, list) else v)
                 for k, v in r.items()} for r in rows])


def _strategies(result):
    return [m["strategy"] for m in result.metrics["operators"]
            if m["op"] == "CountPattern"]


@pytest.mark.parametrize("csr", [True, False], ids=["csr", "exchange"])
@pytest.mark.parametrize("shape", MESHES, ids=str)
@pytest.mark.parametrize("name", sorted(QUERIES))
def test_query_equals_the_jax_sharded_session(name, shape, csr):
    gp, gj, port = _graphs(shape, use_csr=csr)
    assert isinstance(gp.node_tables[0].table, ShardedTable)
    q = QUERIES[name]
    rp, rj = gp.cypher(q), gj.cypher(q)
    got, want = rp.records.to_maps(), rj.records.to_maps()
    if name == "order_limit":
        assert got == want
    else:
        assert _norm(got) == _norm(want)
    assert _strategies(rp) == _strategies(rj), (_strategies(rp),
                                                _strategies(rj))


def test_count_chain_strategies_match_the_jax_package():
    """A chain whose hops' targets differ runs ``spmv-sharded`` on both
    meshes, a uniform one the ring on the 1-D mesh, as the JAX package
    reports them."""
    for shape, uniform in (((8,), "ring"), ((2, 4), "spmv-sharded")):
        gp, _gj, _port = _graphs(shape, use_csr=True)
        assert _strategies(gp.cypher(QUERIES["count_sharded"])) == \
            ["spmv-sharded"]
        assert _strategies(gp.cypher(QUERIES["count_ring"])) == [uniform]


def test_spmv_sharded_hops_combine_with_global_sum():
    """Each hop of a sharded count chain all-reduces the shards'
    frontiers once (``collectives.psum``), and reads every edge block
    where it resides."""
    from caps_tpu_torch.obs import global_registry
    gp, _gj, _port = _graphs((8,), use_csr=True)
    reg = global_registry()
    before = reg.snapshot().get("collectives.psum.calls", 0)
    gp.cypher(QUERIES["count_sharded"])
    # two hops, plus the seed's and the two masks' indicators
    assert reg.snapshot()["collectives.psum.calls"] - before >= 5


def test_row_local_operators_stay_resident_and_gathers_are_counted():
    """Filters, projections and joins keep their rows on their shards
    (no gather in the query); an ORDER BY gathers to the lead, counted
    in the gathers and in ``ici_bytes``."""
    gp, _gj, _port = _graphs((8,), use_csr=False)
    gp.cypher(QUERIES["join"])      # the graph's statistics gather once
    r = gp.cypher(QUERIES["join"])
    assert isinstance(r.records.table, ShardedTable)
    assert r.metrics["dist_joins"] + r.metrics["broadcast_joins"] > 0
    assert r.metrics["gathers"] == 0
    r2 = gp.cypher(QUERIES["order_limit"])
    assert not isinstance(r2.records.table, ShardedTable)
    assert r2.metrics["gathers"] >= 1
    assert r2.metrics["ici_bytes"] >= r2.metrics["gather_bytes"] > 0


def test_take_rows_moves_only_the_rows_each_block_holds():
    """A probe of a row-resident build side: each block takes only the
    indices it owns, at the largest group's bucket, and only the rows
    taken off slots other than the prober's count as moved."""
    s = _session((8,))
    rows = {"k": np.arange(4096), "w": np.arange(4096) * 3}
    t = s.table_factory.from_columns(rows, {"k": CTInteger, "w": CTInteger})
    assert isinstance(t, ShardedTable) and t.capacity == 4096
    b = t.parts[0].capacity
    idx = torch.from_numpy(np.random.RandomState(7).randint(0, 4096, 3000))
    be = s.backend
    before = be.gather_bytes
    got = t.take_rows(idx, home=t.parts[0].backend.slot)
    assert got["k"].data.tolist() == idx.tolist()
    assert got["w"].data.tolist() == (idx * 3).tolist()
    assert bool(got["k"].valid.all())
    owners = np.bincount(idx.numpy() // b, minlength=8)
    cap = min(len(idx), be.bucket(int(owners.max())))
    row = 8 + 1 + 8 + 1          # two int64 columns and their validity
    assert be.gather_bytes - before == 7 * cap * row
    assert 7 * cap < 7 * len(idx)


@pytest.mark.parametrize("name", ["join", "dense_group", "count_sharded",
                                  "varlen"])
def test_exact_replay_reads_no_size(name):
    gp, _gj, port = _graphs((8,), use_csr=False)
    q = QUERIES[name] + " "     # a query text of its own: a fresh record
    first = gp.cypher(q)
    again = gp.cypher(q)
    assert port.fused.last_mode == "replay"
    assert again.metrics["size_syncs"] == 0
    assert _norm(again.records.to_maps()) == _norm(first.records.to_maps())


def test_generic_replay_reads_the_flag_with_the_row_counts():
    """A param-generic replay of a row-resident result reads its
    violation flag and every shard's row count in one transfer, and
    answers as an unsharded session does."""
    gp, _gj, port = _graphs((8,), use_csr=False)
    q = "MATCH (a:P)-[r:T]->(b:P) WHERE a.v < $v RETURN b.v AS bv"
    plain = caps_tpu_torch.local_session(device="cpu")
    gplain = port_make_graph(plain, *_spec())
    generic = 0
    for v in (5, 5, 9, 20, 2, 5, 7, 11):
        r = gp.cypher(q, {"v": v})
        assert Bag(r.records.to_maps()) == \
            gplain.cypher(q, {"v": v}).records.to_maps()
        if port.fused.last_mode == "replay_gen":
            generic += 1
            assert r.metrics["size_syncs"] == 1
    assert generic > 0


def test_resident_bytes_per_slot_hold_no_whole_copy():
    """Each slot holds its blocks' bytes, an eighth of the graph's, and
    no table stays whole on the lead."""
    gp, _gj, _port = _graphs((8,), use_csr=False)
    got = resident_bytes(gp)
    assert got["whole"] == 0 and len(got["per_slot"]) == 8
    assert len(set(got["per_slot"])) == 1
    total = sum(et.table.gathered().nbytes for et in
                tuple(gp.node_tables) + tuple(gp.rel_tables))
    assert sum(got["per_slot"]) == total


def test_write_compaction_and_read_on_a_mesh():
    """A write through a versioned graph, a compaction that folds it
    into a new placement and a read: equal to the JAX package's answers,
    the folded base row-resident again."""
    from caps_tpu.backends.local.session import LocalCypherSession
    from caps_tpu.relational.updates import versioned as jax_versioned
    from caps_tpu.testing.factory import create_graph as jax_create_graph
    from caps_tpu_torch.relational.updates import versioned
    from caps_tpu_torch.testing.factory import create_graph
    create = ("CREATE (a:P {v: 1}), (b:P {v: 2}), (c:P {v: 3}), "
              "(a)-[:T]->(b), (b)-[:T]->(c)")
    writes = ["MATCH (x:P {v: 3}) CREATE (x)-[:T]->(:P {v: 4})",
              "MATCH (x:P {v: 1}) DETACH DELETE x"]
    q = "MATCH (x:P)-[:T]->(y:P) RETURN x.v AS x, y.v AS y"
    s = _session((8,))
    vg = versioned(s, create_graph(s, create, {}))
    js = LocalCypherSession()
    jv = jax_versioned(js, jax_create_graph(js, create, {}))
    for w in writes:
        vg.cypher(w)
        jv.cypher(w)
    want = jv.cypher(q).records.to_maps()
    assert Bag(vg.cypher(q).records.to_maps()) == want
    assert vg.compact() is True and vg.delta_rows() == 0
    base = vg.current().base
    tables = [et.table for et in tuple(base.node_tables)
              + tuple(base.rel_tables)]
    assert tables and all(isinstance(t, ShardedTable) for t in tables)
    assert Bag(vg.cypher(q).records.to_maps()) == want
