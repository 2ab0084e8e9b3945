"""Fleet backends: one ``QueryServer`` per process behind a socket.

A :class:`FleetBackend` wraps one server (its own session, graph, plan
cache, warm-path store) in a TCP listener speaking the frame protocol
of ``serve/wire.py``.  The router (serve/router.py) holds a
:class:`~caps_tpu_torch.serve.wire.WireClient` per backend and routes by
consistent hash — compiled state never migrates between processes
(each holds its own CUDA context), so scale-out ships *queries to the
process whose caches are hot* and *snapshots to the processes whose
graphs are stale*, never compiled artifacts.

Two deployment shapes share this class:

* **in-process** (tests, docs): ``FleetBackend(spec)`` starts the
  server and listener on threads in the caller's process — real
  sockets, real wire frames, deterministic and fast;
* **multi-process** (production shape): ``spawn_backend(spec)``
  launches ``python -m caps_tpu_torch.serve.fleet '<spec json>'`` — each
  child is a new interpreter (its own GIL and its own CUDA context on
  the card; never a ``fork`` of a process that holds one), prints
  ``CAPS_FLEET_PORT <port>`` on stdout, and serves until killed.  Its
  stderr goes to a file, and a child that dies before it reports its
  port raises with that file's tail.

Both build their graph from :class:`BackendSpec.graph` — a declarative
spec (not a pickled object), so every process reconstructs an
IDENTICAL base graph from the same JSON and snapshot shipping only has
to move deltas (``relational/updates.py delta_state_to_payload``).  The
``foaf`` kind is built straight into columns (:func:`foaf_arrays`): the
same graph the reference's CREATE text gives, at sizes a CREATE string
cannot be parsed at.
"""
from __future__ import annotations

import array
import dataclasses
import json
import hashlib
import os
import random
import socket
import sys
import threading
from typing import Any, Dict, Optional, Tuple

import numpy as np

from caps_tpu_torch.durability.lease import ROUTER_LEASE_NAME, LeaseStore
from caps_tpu_torch.durability.wal import (CommitLog, compose_delta_payloads,
                                           empty_payload, scan_durable_dir)
from caps_tpu_torch.obs import clock
from caps_tpu_torch.obs.lockgraph import make_lock
from caps_tpu_torch.serve import wire
from caps_tpu_torch.serve.errors import (QueryFailed,
                                         ReplicationUnsupported, StaleEpoch,
                                         WalWriteError)
from caps_tpu_torch.serve.server import QueryServer, ServerConfig
from caps_tpu_torch.serve.warmup import WarmupConfig

_UNSET = object()


@dataclasses.dataclass(frozen=True)
class BackendSpec:
    """Declarative description of one fleet backend — everything a
    fresh process needs to reconstruct the same serving state."""

    #: ring identity (stable across restarts — a rejoining process with
    #: the same name reclaims the same ring segment)
    name: str
    #: session backend: "cuda" (a session on the card; a process with
    #: no card raises at start) or "cpu" (the plain versions, for
    #: tests).  "local" (the reference's oracle) raises until that
    #: backend is ported.
    backend: str = "cuda"
    #: graph spec: ``{"kind": "script", "create": "..."}`` (a CREATE
    #: statement through testing/factory), ``{"kind": "foaf",
    #: "n_people": N, "n_edges": M, "seed": S}`` (deterministic social
    #: graph — same seed → byte-identical base in every process), or
    #: None for the empty ambient graph
    graph: Optional[Dict[str, Any]] = None
    #: wrap the graph in a VersionedGraph — required for the write
    #: owner and every peer that pulls snapshots
    versioned: bool = False
    #: shared on-disk PlanStore path: a rejoining process warms from it
    #: BEFORE taking traffic, and persists back on shutdown
    plan_store_path: Optional[str] = None
    #: background (True) vs inline (False) warmup; rejoin uses inline
    #: so the port only opens once the hot set is compiled
    warm_background: bool = False
    workers: int = 2
    max_queue: int = 256
    default_deadline_s: Optional[float] = None
    #: simulated per-query device dwell (seconds, via ``obs.clock``):
    #: a stand-in for a backend that WAITS on its device for most of a
    #: query's life, so QPS scaling across processes measures the
    #: serving path's parallelism deterministically on a CPU host.
    #: 0.0 (default) = serve at real speed.
    service_dwell_s: float = 0.0
    #: snapshot-keyed result-cache byte budget (relational/
    #: result_cache.py); None = serve every read through the device.
    #: The hash-ring's (graph, plan-family) affinity already routes a
    #: hot family to one process, so its entries stay process-resident.
    result_cache_budget: Optional[int] = None
    #: shared durable directory (the store the PlanStore already lives
    #: in): this backend's WAL goes to ``<durable_dir>/wal-<name>/`` and
    #: the fleet's write lease to ``<durable_dir>/lease.json``.  None =
    #: memory-only serving (the pre-durability behavior).
    durable_dir: Optional[str] = None
    #: WAL fsync policy: "always" | "rotate" | "never"
    #: (caps_tpu_torch/durability/wal.py)
    wal_fsync: str = "always"
    #: write-lease TTL: how long after the owner's last renewal a peer
    #: may steal the lease (failover detection horizon)
    lease_ttl_s: float = 5.0
    host: str = "127.0.0.1"
    #: 0 = ephemeral (the listener reports the bound port)
    port: int = 0

    def to_json(self) -> str:
        return json.dumps(dataclasses.asdict(self), sort_keys=True)

    @classmethod
    def from_json(cls, text: str) -> "BackendSpec":
        fields = {f.name for f in dataclasses.fields(cls)}
        raw = json.loads(text)
        return cls(**{k: v for k, v in raw.items() if k in fields})


def foaf_create_script(n_people: int, n_edges: int, seed: int) -> str:
    """Deterministic friend-of-a-friend CREATE statement.  Pure
    function of its arguments (seeded Mersenne Twister — stable across
    processes and Python builds), so every backend that parses it gets
    an identical base graph."""
    rng = random.Random(seed)
    parts = [f"(p{i}:Person {{name: 'p{i}', age: {20 + (i * 7) % 50}}})"
             for i in range(n_people)]
    seen = set()
    for _ in range(n_edges):
        a = rng.randrange(n_people)
        b = rng.randrange(n_people)
        if a == b or (a, b) in seen:
            continue
        seen.add((a, b))
        parts.append(f"(p{a})-[:KNOWS {{w: {rng.randrange(100)}}}]->(p{b})")
    return "CREATE " + ",\n  ".join(parts)


def foaf_arrays(n_people: int, n_edges: int, seed: int
                ) -> Dict[str, np.ndarray]:
    """The graph :func:`foaf_create_script` describes, as columns: the
    same ``random.Random(seed)`` draws in the same order, the same
    self-loop and duplicate skipping, and the ids the CREATE factory
    (testing/factory.py) gives — people ``0 .. n_people - 1`` in order,
    then one relationship id per kept edge.  ``name`` is left to the
    caller (``p<i>`` for person ``i``).

    ``randrange(n)`` is inlined as its rejection loop over
    ``getrandbits(n.bit_length())`` (the same draws), and the duplicate
    set holds ``a * n + b`` ints: about 30M draws at 1M people and 10M
    edges."""
    n = int(n_people)
    if n <= 0 and int(n_edges) > 0:
        raise QueryFailed("graph spec kind 'foaf' needs a person for its "
                          "edges (randrange of an empty range)")
    rng = random.Random(seed)
    bits = rng.getrandbits
    kn, kw = n.bit_length(), (100).bit_length()
    src, tgt, w = array.array("q"), array.array("q"), array.array("q")
    seen = set()
    for _ in range(int(n_edges)):
        a = bits(kn)
        while a >= n:
            a = bits(kn)
        b = bits(kn)
        while b >= n:
            b = bits(kn)
        key = a * n + b
        if a == b or key in seen:
            continue
        seen.add(key)
        r = bits(kw)
        while r >= 100:
            r = bits(kw)
        src.append(a)
        tgt.append(b)
        w.append(r)
    people = np.arange(n, dtype=np.int64)
    m = len(src)
    return {"person_id": people, "age": 20 + (people * 7) % 50,
            "rel_id": np.arange(n, n + m, dtype=np.int64),
            "src": np.frombuffer(src, dtype=np.int64),
            "tgt": np.frombuffer(tgt, dtype=np.int64),
            "w": np.frombuffer(w, dtype=np.int64)}


def foaf_graph(session, n_people: int, n_edges: int, seed: int):
    """:func:`foaf_arrays` as the graph the CREATE factory would build
    from :func:`foaf_create_script`: one ``Person {age, name}`` table
    and one ``KNOWS {w}`` table, property columns in sorted order."""
    from caps_tpu_torch.interop import graph_from_numpy
    a = foaf_arrays(n_people, n_edges, seed)
    nodes = {"Person": {"_id": a["person_id"], "age": a["age"],
                        "name": [f"p{i}" for i in range(int(n_people))]}}
    rels = {"KNOWS": {"_id": a["rel_id"], "_src": a["src"],
                      "_tgt": a["tgt"], "w": a["w"]}}
    return graph_from_numpy(session, nodes, rels)


def build_graph_from_spec(session, gspec: Optional[Dict[str, Any]],
                          versioned: bool):
    """Construct the spec'd graph on ``session``.  Returns None for an
    absent spec (the server then serves the ambient empty graph)."""
    from caps_tpu_torch.testing.factory import create_graph
    if gspec is None:
        base = None
    else:
        kind = gspec.get("kind", "script")
        if kind == "script":
            create = gspec.get("create")
            if not create:
                raise QueryFailed(
                    "graph spec kind 'script' requires a non-empty "
                    "'create' statement")
            base = create_graph(session, create, gspec.get("parameters"))
        elif kind == "foaf":
            base = foaf_graph(session, int(gspec.get("n_people", 64)),
                              int(gspec.get("n_edges", 256)),
                              int(gspec.get("seed", 0)))
        else:
            raise QueryFailed(f"unknown graph spec kind {kind!r}")
    if versioned:
        from caps_tpu_torch.relational.updates import versioned as make_versioned
        return make_versioned(session, base)
    return base


def make_backend_session(backend: str):
    """The session a spec's ``backend`` names: on the card for
    ``"cuda"`` (raises where there is none — a backend never serves
    from the CPU unasked), the plain versions for ``"cpu"``, the
    pure-Python oracle (``backends/local``) for ``"local"``."""
    import caps_tpu_torch
    if backend == "local":
        return caps_tpu_torch.local_session(backend="local")
    if backend not in ("cuda", "cpu"):
        raise QueryFailed(f"unknown fleet backend {backend!r} "
                          f"(one of 'cuda', 'cpu', 'local')")
    return caps_tpu_torch.local_session(device=backend)


def rows_digest(rows) -> str:
    """Order-insensitive content digest of materialized rows — the
    cross-process read-your-writes check compares THIS, so two
    backends agree exactly when their visible graph state agrees."""
    canon = sorted(json.dumps(r, sort_keys=True, default=str)
                   for r in rows)
    return hashlib.sha256("\n".join(canon).encode("utf-8")).hexdigest()


class FleetBackend:
    """One serving process: a QueryServer behind a wire listener."""

    def __init__(self, spec: BackendSpec, session=None, start: bool = True):
        self.spec = spec
        t0 = clock.now()
        if session is None:
            session = make_backend_session(spec.backend)
        self.session = session
        t1 = clock.now()
        self.graph = build_graph_from_spec(session, spec.graph,
                                           spec.versioned)
        #: where this backend's start went (seconds): the session (CUDA
        #: context), the spec'd graph, the WAL replay (``ping`` reports
        #: it)
        self.startup = {"session_s": t1 - t0,
                        "graph_s": clock.now() - t1,
                        "recover_s": 0.0}
        warmup = None
        if spec.plan_store_path is not None:
            warmup = WarmupConfig(store_path=spec.plan_store_path,
                                  background=spec.warm_background,
                                  save_on_shutdown=True)
        rescache = None
        if spec.result_cache_budget is not None:
            from caps_tpu_torch.relational.result_cache import ResultCacheConfig
            rescache = ResultCacheConfig(
                budget_bytes=int(spec.result_cache_budget))
        self.server = QueryServer(
            session, graph=self.graph,
            config=ServerConfig(workers=spec.workers,
                                max_queue=spec.max_queue,
                                default_deadline_s=spec.default_deadline_s,
                                warmup=warmup,
                                result_cache=rescache))
        self._registry = session.metrics_registry
        #: durability (caps_tpu_torch/durability): WAL + lease, or None when
        #: the spec has no durable_dir / the graph is not versioned
        self.wal: Optional[CommitLog] = None
        self.lease: Optional[LeaseStore] = None
        self.router_lease: Optional[LeaseStore] = None
        #: the lease epoch this backend last wrote under (stamped on
        #: write acks so routers can fence their own staleness)
        self.write_epoch: Optional[int] = None
        self._base_overlay: Optional[Dict[str, Any]] = None
        if (spec.durable_dir is not None
                and getattr(self.graph, "graph_is_versioned", False)):
            self._init_durability()
        self._shutting_down = threading.Event()
        self._conn_threads = []
        self._conns = []
        self._lock = make_lock("fleet.FleetBackend._lock")
        self._listener: Optional[socket.socket] = None
        self._accept_thread: Optional[threading.Thread] = None
        self.port: Optional[int] = None
        if start:
            self.start()

    # -- durability ----------------------------------------------------

    def _init_durability(self) -> None:
        """Open the WAL and lease on the shared durable store, then
        CRASH-RECOVER before serving: replay this backend's own log
        over the spec'd base (entries are cumulative, so the single
        highest intact entry IS the recovered state) and hook the
        commit path for append-before-acknowledge."""
        from caps_tpu_torch.relational.updates import delta_state_from_payload
        spec = self.spec
        self.wal = CommitLog(
            os.path.join(spec.durable_dir, f"wal-{spec.name}"),
            fsync=spec.wal_fsync, registry=self._registry,
            event_log=getattr(self.session, "event_log", None))
        self.lease = LeaseStore(spec.durable_dir, ttl_s=spec.lease_ttl_s,
                                registry=self._registry)
        #: the ROUTER tier's lease (serve/ha.py) — read-only here: the
        #: backend fences write-coordination frames from deposed zombie
        #: routers against it, exactly like zombie owners
        self.router_lease = LeaseStore(
            spec.durable_dir, ttl_s=spec.lease_ttl_s,
            lease_name=ROUTER_LEASE_NAME, registry=self._registry)
        self._base_overlay = empty_payload()
        t0 = clock.now()
        rec = self.wal.recover()
        if rec.version > 0:
            self.graph.install_state(
                delta_state_from_payload(rec.state), rec.version)
        self.startup["recover_s"] = clock.now() - t0
        self.graph.pre_publish = self._wal_append
        self.graph.on_compacted = self._wal_checkpoint

    def _cumulative_payload(self, snap) -> Dict[str, Any]:
        """``snap``'s state as a payload cumulative over the SPEC'D
        base: compaction folds the overlay into a new base, so states
        after a fold are composed back over what was folded away —
        recovery always replays onto a freshly spec-built graph."""
        from caps_tpu_torch.relational.updates import delta_state_to_payload
        return compose_delta_payloads(self._base_overlay,
                                      delta_state_to_payload(snap.state))

    def _wal_append(self, new_snap) -> None:
        """``pre_publish`` hook: the append-before-acknowledge point.
        Runs under the commit lock before the snapshot swap; a failed
        append raises WalWriteError and the commit rolls back — the
        writer never sees an ack for a frame that did not land."""
        self.wal.append(new_snap.snapshot_version,
                        self._cumulative_payload(new_snap),
                        epoch=self.write_epoch)

    def _wal_checkpoint(self, folded_snap, new_snap) -> None:
        """``on_compacted`` hook: fold the compacted-away overlay into
        the base composition, persist it as the checkpoint, truncate
        covered segments.  A checkpoint write failure is deferred, not
        fatal: entries stay cumulative over the spec'd base, so recovery
        is exact from the un-truncated log alone."""
        from caps_tpu_torch.relational.updates import delta_state_to_payload
        self._base_overlay = compose_delta_payloads(
            self._base_overlay, delta_state_to_payload(folded_snap.state))
        try:
            self.wal.checkpoint(new_snap.snapshot_version,
                                self._base_overlay, epoch=self.write_epoch)
        except WalWriteError:
            self._registry.counter("wal.checkpoint_failures").inc()

    def _fence_router(self, frame_router_epoch: Optional[int]) -> None:
        """The router-tier fence (serve/ha.py): a write-coordination
        frame stamped with a ROUTER epoch older than the published
        router lease's comes from a deposed zombie active router —
        refuse it exactly like a zombie owner's.  Frames without a
        router epoch pass (single-router deployments carry none), and
        TTL expiry is irrelevant here: only a SUCCESSOR bumping the
        epoch deposes the stamp's holder."""
        if frame_router_epoch is None or self.router_lease is None:
            return
        lease = self.router_lease.read()
        if lease is not None and int(frame_router_epoch) != lease["epoch"]:
            self._registry.counter("wal.fenced_writes").inc()
            raise StaleEpoch(
                f"stale ROUTER epoch fenced at backend "
                f"{self.spec.name!r} — a newer active router holds the "
                f"router lease", epoch=int(frame_router_epoch),
                lease_epoch=lease["epoch"], owner=lease["owner"])

    def _fence_write(self, frame_epoch: Optional[int]) -> None:
        """The split-brain fence, checked before EVERY durable write:
        (a) this backend must hold the live lease (a deposed zombie
        owner reads the shared lease file and learns it does not), and
        (b) the frame's epoch, when carried, must match the lease's (a
        router with a stale ownership view is told who owns writes
        now).  An unheld lease is claimed on first write — initial
        ownership needs no ceremony."""
        lease = self.lease.read()
        if lease is None or self.lease.expired(lease):
            epoch = self.lease.acquire(self.spec.name)
            if epoch is not None:
                self.write_epoch = epoch
                lease = self.lease.read()
            else:
                lease = self.lease.read()
        if lease is None or lease["owner"] != self.spec.name:
            self._registry.counter("wal.fenced_writes").inc()
            raise StaleEpoch(
                f"backend {self.spec.name!r} does not hold the write "
                f"lease", epoch=frame_epoch,
                lease_epoch=None if lease is None else lease["epoch"],
                owner=None if lease is None else lease["owner"])
        self.write_epoch = lease["epoch"]
        if frame_epoch is not None and int(frame_epoch) != lease["epoch"]:
            self._registry.counter("wal.fenced_writes").inc()
            raise StaleEpoch(
                f"stale-epoch write frame fenced at backend "
                f"{self.spec.name!r}", epoch=int(frame_epoch),
                lease_epoch=lease["epoch"], owner=lease["owner"])

    # -- listener ------------------------------------------------------

    def start(self) -> int:
        """Bind + start accepting (idempotent).  Returns the bound
        port.  When the spec asks for inline warmup the server
        constructor already blocked on it — the port only opens warm."""
        with self._lock:
            if self._listener is not None:
                return self.port
            listener = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
            listener.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
            listener.bind((self.spec.host, self.spec.port))
            listener.listen(64)
            self._listener = listener
            self.port = listener.getsockname()[1]
            self._registry.gauge("fleet.backend_up").set(1.0)
            t = threading.Thread(target=self._accept_loop,
                                 name=f"caps-fleet-{self.spec.name}",
                                 daemon=True)
            self._accept_thread = t
            t.start()
            return self.port

    def _accept_loop(self) -> None:
        while not self._shutting_down.is_set():
            try:
                conn, _addr = self._listener.accept()
            except OSError:
                return  # listener closed — shutdown
            conn.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)
            self._conns.append(conn)
            self._registry.counter("fleet.connections").inc()
            t = threading.Thread(
                target=wire.serve_connection,
                args=(conn, self.handle, self._shutting_down),
                name=f"caps-fleet-conn-{self.spec.name}", daemon=True)
            t.start()
            self._conn_threads.append(t)

    def shutdown(self, drain: bool = True) -> None:
        """Stop the listener, then the server (persisting warm state
        when a store is configured).  Safe to call twice."""
        self._shutting_down.set()
        with self._lock:
            listener, self._listener = self._listener, None
        if listener is not None:
            # shutdown() before close(): close() alone does NOT wake a
            # thread blocked in accept() on the same socket
            for fn in (lambda: listener.shutdown(socket.SHUT_RDWR),
                       listener.close):
                try:
                    fn()
                except OSError:  # pragma: no cover — teardown must not raise
                    pass
        # sever open connections like a dying process would: blocked
        # peers observe EOF/reset (a WireError), not a hung socket
        for conn in self._conns:
            for fn in (lambda c=conn: c.shutdown(socket.SHUT_RDWR),
                       conn.close):
                try:
                    fn()
                except OSError:  # pragma: no cover — teardown must not raise
                    pass
        accept_thread = self._accept_thread
        if accept_thread is not None and \
                accept_thread is not threading.current_thread():
            accept_thread.join(timeout=5.0)
        for t in self._conn_threads:
            if t is not threading.current_thread():
                t.join(timeout=5.0)
        self._registry.gauge("fleet.backend_up").set(0.0)
        self.server.shutdown(drain=drain)

    # -- op dispatch ---------------------------------------------------

    def handle(self, msg: Dict[str, Any]) -> Any:
        """One request → one reply payload.  ServeErrors propagate (the
        wire layer serializes them typed); anything else becomes a
        QueryFailed on the wire."""
        op = msg.get("op")
        fn = getattr(self, f"_op_{op}", None)
        if fn is None:
            raise QueryFailed(f"unknown fleet op {op!r}")
        self._registry.counter(f"fleet.ops.{op}").inc()
        return fn(msg)

    def _op_ping(self, msg) -> Dict[str, Any]:
        return {"name": self.spec.name, "pid": os.getpid(),
                "health": self.server.health(),
                "snapshot_version": self._snapshot_version(),
                "startup": dict(self.startup)}

    def _snapshot_version(self) -> Optional[int]:
        if getattr(self.graph, "graph_is_versioned", False):
            return self.graph.current().snapshot_version
        return None

    def _submit(self, msg) -> Tuple[list, Dict[str, Any]]:
        deadline = msg.get("deadline_s", _UNSET)
        kwargs: Dict[str, Any] = {}
        if deadline is not _UNSET:
            kwargs["deadline_s"] = deadline
        if msg.get("priority") is not None:
            kwargs["priority"] = int(msg["priority"])
        handle = self.server.submit(msg.get("query", ""),
                                    msg.get("params") or {}, **kwargs)
        rows = handle.rows()
        return rows, handle.info

    def _op_query(self, msg) -> Dict[str, Any]:
        if self.spec.service_dwell_s > 0.0:
            clock.sleep(self.spec.service_dwell_s)
        rows, info = self._submit(msg)
        out = {"rows": rows,
               "ledger": info.get("ledger"),
               "snapshot_version": info.get("snapshot_version"),
               "queue_depth": self.server.admission.depth()}
        if msg.get("digest"):
            out["digest"] = rows_digest(rows)
        return out

    def _op_write(self, msg) -> Dict[str, Any]:
        """An update query against the owned versioned graph; the reply
        carries the post-commit version so the router can measure
        snapshot lag per peer.  Durable backends fence the frame's
        epoch first (StaleEpoch — never execute a zombie's write) and
        acknowledge only after the WAL append landed (the pre_publish
        hook runs inside the commit)."""
        if not getattr(self.graph, "graph_is_versioned", False):
            raise ReplicationUnsupported(
                f"backend {self.spec.name!r} serves a non-versioned "
                f"graph; writes need a versioned owner")
        if self.lease is not None:
            self._fence_router(msg.get("router_epoch"))
            self._fence_write(msg.get("epoch"))
        rows, info = self._submit(msg)
        out = {"rows": rows,
               "version": self.graph.current().snapshot_version,
               "queue_depth": self.server.admission.depth()}
        if self.lease is not None:
            out["epoch"] = self.write_epoch
            self.lease.renew(self.spec.name)
        return out

    def _op_acquire_lease(self, msg) -> Dict[str, Any]:
        """Failover: make THIS backend the write owner.  First replay
        every backend's WAL under the shared store (the dead owner's
        acked-but-unshipped writes live only in ITS log — zero
        acknowledged-write loss), then claim the epoch-fenced lease,
        polling up to ``wait_s`` for the dead owner's TTL to lapse.
        Non-durable backends answer ``durable: False`` so the router
        can keep the legacy read-only-until-rejoin behavior."""
        if self.lease is None:
            return {"durable": False, "epoch": None,
                    "version": self._snapshot_version()}
        from caps_tpu_torch.relational.updates import delta_state_from_payload
        best = scan_durable_dir(self.spec.durable_dir,
                                registry=self._registry)
        if (best is not None
                and best.version > (self._snapshot_version() or 0)):
            self.graph.install_state(
                delta_state_from_payload(best.state), best.version)
            self._registry.counter("wal.failover_replays").inc()
        deadline = clock.now() + float(msg.get("wait_s") or 0.0)
        epoch = self.lease.acquire(self.spec.name)
        while epoch is None and clock.now() < deadline:
            clock.sleep(min(0.05, max(self.spec.lease_ttl_s / 4.0, 0.005)))
            epoch = self.lease.acquire(self.spec.name)
        if epoch is not None:
            self.write_epoch = epoch
        return {"durable": True, "epoch": epoch,
                "version": self._snapshot_version()}

    def _op_export_delta(self, msg) -> Dict[str, Any]:
        """Replication source: the current snapshot's full delta state.
        Deltas are cumulative over the shared base (the spec'd graph),
        so one pull brings ANY stale peer exactly current — no
        per-version chain to replay."""
        from caps_tpu_torch.relational.updates import delta_state_to_payload
        if not getattr(self.graph, "graph_is_versioned", False):
            raise ReplicationUnsupported(
                f"backend {self.spec.name!r} serves a non-versioned "
                f"graph; nothing to export")
        snap = self.graph.current()
        return {"version": snap.snapshot_version,
                "state": delta_state_to_payload(snap.state)}

    def _op_sync_from(self, msg) -> Dict[str, Any]:
        """Replication sink: pull the owner's delta and flip the local
        version atomically.  Monotonic — a concurrent newer local
        version wins (install_state refuses to go backwards)."""
        from caps_tpu_torch.relational.updates import delta_state_from_payload
        if not getattr(self.graph, "graph_is_versioned", False):
            raise ReplicationUnsupported(
                f"backend {self.spec.name!r} serves a non-versioned "
                f"graph; cannot install snapshots")
        with wire.WireClient(str(msg["host"]), int(msg["port"]),
                             timeout_s=30.0) as owner:
            if self.wal is not None:
                # WAL-tail rejoin: this backend's own recovered log may
                # already be current (it held every acked write when it
                # died) — compare versions before paying for a full
                # cumulative-delta pull
                owner_version = owner.call("ping").get("snapshot_version")
                local_version = self.graph.current().snapshot_version
                if (owner_version is not None
                        and local_version >= int(owner_version)):
                    self._registry.counter("wal.catchups").inc()
                    return {"version": local_version, "wal_catchup": True}
            delta = owner.call("export_delta")
        state = delta_state_from_payload(delta["state"])

        def _publish(new_snap) -> None:
            # runs under the commit lock BEFORE the reference swap
            # (relational/updates.py install_state): superseded result-
            # cache entries retire and the version gauge updates
            # happens-before any reader can be admitted at the new
            # version — the rejoin fencing fix (no read is ever served
            # a version the gauges don't yet report)
            self._registry.counter("fleet.snapshots_installed").inc()
            self._registry.gauge("fleet.snapshot_version").set(
                float(new_snap.snapshot_version))
            if self.wal is not None:
                # best-effort peer durability: shipped snapshots land in
                # THIS backend's log too, so "longest replayed log" at
                # election time favors the most caught-up peer.  A peer
                # disk hiccup must never fail replication — the owner's
                # log still holds the entry.
                try:
                    self.wal.append(new_snap.snapshot_version,
                                    self._cumulative_payload(new_snap))
                except WalWriteError:
                    self._registry.counter(
                        "wal.peer_append_failures").inc()

        snap = self.graph.install_state(state, int(delta["version"]),
                                        on_install=_publish)
        return {"version": snap.snapshot_version}

    def _op_stats(self, msg) -> Dict[str, Any]:
        return self.server.stats()

    def _op_health(self, msg) -> Dict[str, Any]:
        return {"health": self.server.health()}

    def _op_health_report(self, msg) -> Dict[str, Any]:
        return self.server.health_report()

    def _op_metrics_snapshot(self, msg) -> Dict[str, Any]:
        return self._registry.snapshot()

    def _op_metrics_text(self, msg) -> str:
        return self.server.metrics_text()

    def _op_telemetry(self, msg) -> Dict[str, Any]:
        return self.server.telemetry.summary()

    def _op_warmup_report(self, msg) -> Dict[str, Any]:
        return self.server.warmup_report(msg.get("families"))

    def _op_warmup_wait(self, msg) -> Dict[str, Any]:
        warmer = self.server.warmer
        if warmer is None:
            return {"state": "none", "done": True}
        done = warmer.wait(msg.get("timeout"))
        return {"state": warmer.report().get("state", "?"), "done": done}

    def _op_device(self, msg) -> Dict[str, Any]:
        """Where this backend runs: its session's device and, on a card,
        the card's name and the memory this process's allocator holds
        there.  A local (pure-Python) backend runs on the host."""
        import torch
        dev = getattr(self.session, "device", None)
        out: Dict[str, Any] = {"device": str(dev or "host"),
                               "pid": os.getpid()}
        if dev is not None and dev.type == "cuda":
            out.update(name=torch.cuda.get_device_name(dev),
                       memory_reserved=int(torch.cuda.memory_reserved(dev)),
                       memory_allocated=int(
                           torch.cuda.memory_allocated(dev)))
        return out

    def _op_launches(self, msg) -> Dict[str, int]:
        """This process's kernel launch counts (``ops.launches``) since
        the last reset; ``reset`` zeroes them after the read."""
        from caps_tpu_torch import ops
        out = ops.launches()
        if msg.get("reset"):
            ops.reset_launches()
        return out

    def _op_shutdown(self, msg) -> Dict[str, Any]:
        # reply first, then tear down from another thread — the client
        # gets its ack before the socket dies
        threading.Thread(target=self.shutdown,
                         kwargs={"drain": bool(msg.get("drain", True))},
                         name=f"caps-fleet-shutdown-{self.spec.name}",
                         daemon=True).start()
        return {"closing": True}


# -- process entry point ----------------------------------------------


def backend_main(spec_json: str) -> None:  # pragma: no cover — child
    """Entry point of a spawned backend process: build the backend,
    report the bound port on stdout, serve until killed."""
    backend = FleetBackend(BackendSpec.from_json(spec_json))
    print(f"CAPS_FLEET_PORT {backend.port}", flush=True)
    try:
        backend._shutting_down.wait()
    except KeyboardInterrupt:
        pass
    backend.shutdown(drain=False)


def spawn_backend(spec: BackendSpec, env: Optional[Dict[str, str]] = None,
                  timeout_s: float = 600.0):
    """Launch ``python -m caps_tpu_torch.serve.fleet`` with ``spec`` in a
    new interpreter and wait for its port line.  Returns
    ``(process, port)``; the caller owns the process
    (terminate/kill/wait).  See :func:`spawn_child`."""
    return spawn_child("caps_tpu_torch.serve.fleet", spec.to_json(),
                       "CAPS_FLEET_PORT", f"fleet backend {spec.name!r}",
                       env=env, timeout_s=timeout_s)


def spawn_child(module: str, spec_json: str, tag: str, what: str,
                env: Optional[Dict[str, str]] = None,
                timeout_s: float = 600.0):
    """Run ``python -m <module> '<spec_json>'`` and wait for the
    ``<tag> <port>`` line it prints on stdout.  Returns
    ``(process, port)``.

    The child is a new interpreter (never a ``fork`` of a process that
    may hold a CUDA context).  It inherits the caller's environment —
    nothing that hides the card is set — with the package's parent
    directory on its PYTHONPATH.  Its stderr goes to a temporary file
    (``process.caps_stderr_path``): a child that exits, or does not
    report a port within ``timeout_s``, raises :class:`QueryFailed`
    carrying that file's tail, so a failed kernel build, native build or
    CUDA start shows why."""
    import subprocess
    import tempfile
    child_env = dict(os.environ)
    # the child must import caps_tpu_torch regardless of the caller's
    # cwd: put the package's parent dir on its PYTHONPATH explicitly
    pkg_root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    parent = os.path.dirname(pkg_root)
    existing = child_env.get("PYTHONPATH")
    child_env["PYTHONPATH"] = (
        parent if not existing else parent + os.pathsep + existing)
    if env:
        child_env.update(env)
    err = tempfile.NamedTemporaryFile(prefix="caps-child-",
                                      suffix=".stderr", delete=False)
    proc = subprocess.Popen([sys.executable, "-m", module, spec_json],
                            stdout=subprocess.PIPE, stderr=err,
                            env=child_env, text=True)
    err.close()
    proc.caps_stderr_path = err.name
    port = _read_port_line(proc, tag, timeout_s)
    if port is None:
        proc.kill()
        proc.wait()
        tail = stderr_tail(proc)
        os.unlink(err.name)
        raise QueryFailed(
            f"{what} exited before reporting a port (exit code "
            f"{proc.returncode}); its stderr ends:\n{tail}")
    return proc, port


def _read_port_line(proc, tag: str, timeout_s: float) -> Optional[int]:
    """The port a child prints as ``<tag> <port>``; None when it exits
    (or does not report within ``timeout_s``) first.  The reader thread
    keeps draining the child's stdout afterwards, so a chatty child
    never blocks on a full pipe."""
    found: Dict[str, int] = {}
    done = threading.Event()

    def read() -> None:
        for line in proc.stdout:
            if "port" not in found and line.startswith(tag):
                found["port"] = int(line.split()[1])
                done.set()
        done.set()

    threading.Thread(target=read, daemon=True,
                     name=f"caps-spawn-{tag}").start()
    clock.wait(done, timeout_s)
    return found.get("port")


def stderr_tail(proc, n_bytes: int = 4000) -> str:
    """The last ``n_bytes`` a spawned child wrote to its stderr file."""
    path = getattr(proc, "caps_stderr_path", None)
    if path is None:
        return ""
    try:
        with open(path, "rb") as f:
            f.seek(0, os.SEEK_END)
            f.seek(max(0, f.tell() - n_bytes))
            return f.read().decode("utf-8", "replace")
    except OSError as ex:
        return f"<stderr unreadable: {ex}>"


if __name__ == "__main__":  # pragma: no cover — child process
    backend_main(sys.argv[1])
