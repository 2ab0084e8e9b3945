"""Server warmup: run the hot path before traffic arrives (the
counterpart of ``caps_tpu/serve/warmup.py``).

``server.warmup_report()`` says which hot plan families never compiled
on this process (eager PyTorch compiles nothing: the compile ledger
charges the host seconds of a shape's first run — the cold plan, the
fused record run — obs/compile.py); this module spends it.  At
server start a :class:`ServerWarmup` drives each target family through
the NORMAL compile boundaries — ``session.cypher_on_graph`` on every
live device replica, under the replica's execution lock — so the
compile ledger itself proves coverage: after a successful warmup,
``warmup_report()["cold_families"]`` is empty and the first client
query of a warmed family is a plan-cache hit (compile charge 0.0).

Targets come from, in priority order:

* ``WarmupConfig.families`` — an explicit ``(query, params)`` list (a
  deploy pipeline's curated hot set);
* a persistent plan store (``WarmupConfig.store_path`` →
  ``relational/plan_store.py``): per family the original query text and
  a shape-faithful recorded binding, plus the fused executor's
  param-generic size streams (seeded BEFORE execution, so the warmup
  run itself replays sync-free where the store matches) and the
  shape-bucket lattice boundaries.

Progress and outcome surface in ``server.stats()["warmup"]`` and
``health_report()["warmup"]`` (state machine ``idle → running →
done | failed``), in ``warmup.*`` counters, and as structured
``warmup.start`` / ``warmup.family_failed`` / ``warmup.done`` events.
A family that fails to warm is recorded and SKIPPED — warmup is an
optimization pass; it must never keep a server from serving.
"""
from __future__ import annotations

import dataclasses
import threading
from typing import Any, Dict, List, Optional, Tuple

from caps_tpu_torch.obs import clock
from caps_tpu_torch.obs.lockgraph import make_lock


@dataclasses.dataclass(frozen=True)
class WarmupConfig:
    #: persistent plan store path (relational/plan_store.py); None = no
    #: store — warmup then only covers ``families``
    store_path: Optional[str] = None
    #: explicit hot set: items are ``(query, params)`` pairs or bare
    #: query strings (params {})
    families: Optional[Tuple] = None
    #: run warmup on a background thread (server start returns
    #: immediately; progress is visible in ``stats()["warmup"]``) or
    #: inline (start blocks until the hot set is compiled)
    background: bool = True
    #: persist the session's warm state back to ``store_path`` when the
    #: server fully shuts down — the cross-process round trip
    save_on_shutdown: bool = True
    #: wall-clock budget; families left over when it expires are
    #: reported as skipped (the report's ``truncated`` flag)
    max_seconds: Optional[float] = None
    #: fold observed op_stats sizes (and the store's recorded lattice)
    #: into the session's shape-bucket lattice before executing
    seed_shape_buckets: bool = True


class ServerWarmup:
    """One server's warmup driver + progress report."""

    def __init__(self, server, config: WarmupConfig):
        self.server = server
        self.config = config
        registry = server.session.metrics_registry
        self._completed_c = registry.counter("warmup.completed")
        self._failed_c = registry.counter("warmup.failed")
        self._seconds_c = registry.counter("warmup.seconds")
        self._streams_c = registry.counter("warmup.streams_seeded")
        self._lock = make_lock("warmup.ServerWarmup._lock")
        self._state = "idle"
        self._report: Dict[str, Any] = {}
        self._done = threading.Event()
        #: cooperative cancel: checked between family executions, set by
        #: :meth:`finalize` so an early shutdown bounds the run
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None
        self._finalized = False
        self.store = None
        if config.store_path is not None:
            from caps_tpu_torch.relational.plan_store import PlanStore
            self.store = PlanStore(config.store_path, registry=registry,
                                   event_log=server.event_log)

    # -- lifecycle -----------------------------------------------------

    def start(self) -> None:
        """Kick off warmup (idempotent): inline when
        ``config.background`` is False, else on a daemon thread."""
        with self._lock:
            if self._state != "idle":
                return
            self._state = "running"
        if self.config.background:
            t = threading.Thread(target=self._run_guarded,
                                 name="caps-warmup", daemon=True)
            self._thread = t
            t.start()
        else:
            self._run_guarded()

    def wait(self, timeout: Optional[float] = None) -> bool:
        """Block until warmup finished (True) or ``timeout`` elapsed."""
        return self._done.wait(timeout)

    def finalize(self) -> None:
        """Shutdown hook: cancel + join a background run and persist
        the warm state when configured.  A run that outlives the join
        timeout is NOT saved over — a mid-run snapshot would persist
        half-warm state.  Idempotent; never raises."""
        with self._lock:
            if self._finalized:
                return
            self._finalized = True
        self._stop.set()  # the run breaks at the next family boundary
        t = self._thread
        if t is not None and t.is_alive():
            t.join(timeout=5.0)
        if t is not None and t.is_alive():  # pragma: no cover — wedged
            return                          # device call: don't race it
        if self.store is not None and self.config.save_on_shutdown:
            self.save()

    def save(self) -> bool:
        """Persist the session's CURRENT warm state to the store
        (bindings, fused streams, lattice).  Failure degrades with a
        ``planstore.rejected`` event — never raises."""
        if self.store is None:
            return False
        from caps_tpu_torch.relational.plan_store import collect_warm_state
        try:
            payload = collect_warm_state(
                self.server.session, graph=self.server._default_graph)
        except Exception as ex:  # collection must not break shutdown
            self.store._reject(
                f"collect failed: {type(ex).__name__}: {ex}")
            return False
        return self.store.save(payload)

    # -- the run -------------------------------------------------------

    def _run_guarded(self) -> None:
        try:
            self._run()
        except Exception as ex:  # warmup must never take the server down
            with self._lock:
                self._state = "failed"
                self._report["error"] = f"{type(ex).__name__}: {ex}"
            if not self._stop.is_set():
                self.server.event_log.emit(
                    "warmup.done", request_id=None, family=None,
                    outcome="failed",
                    error=f"{type(ex).__name__}: {ex}"[:200])
        finally:
            self._done.set()

    def _targets(self, payload) -> List[Tuple[str, Dict[str, Any]]]:
        if self.config.families is not None:
            out = []
            for item in self.config.families:
                if isinstance(item, str):
                    out.append((item, {}))
                else:
                    query, params = item
                    out.append((query, dict(params or {})))
            return out
        if payload is not None:
            out = []
            for f in payload["families"]:
                bindings = f.get("bindings") or [f["params"]]
                for b in bindings:
                    out.append((f["query"], dict(b)))
            return out
        return []

    def _seed(self, payload) -> int:
        """Pre-execution seeding: statistics prior + lattice boundaries
        + fused streams."""
        session = self.server.session
        if payload is not None and payload.get("stats"):
            # the load half of collect_warm_state's ``stats`` field:
            # price this process's first plans (the warmup runs
            # themselves) from the previous process's observed sketch
            # instead of paying the host recompute on the serving path
            graph = self.server._default_graph
            if getattr(graph, "graph_is_versioned", False):
                graph = graph.current()
            if hasattr(graph, "seed_statistics"):
                graph.seed_statistics(payload["stats"])
        if self.config.seed_shape_buckets:
            if payload is not None:
                session.shape_lattice.seed(
                    [b for b in payload.get("lattice", [])
                     if isinstance(b, int)])
                session.shape_lattice.seed(
                    [f.get("rows_max", 0) for f in payload["families"]
                     if isinstance(f.get("rows_max"), int)])
            session.seed_shape_buckets()
        streams = 0
        fused = getattr(session, "fused", None)
        if payload is not None and fused is not None:
            from caps_tpu_torch.relational.plan_store import deserialize_stream
            graph = self.server._default_graph
            if getattr(graph, "graph_is_versioned", False):
                graph = graph.current()
            lat = session.shape_lattice
            for fam in payload["families"]:
                raw = fam.get("stream")
                if not isinstance(raw, dict):
                    continue
                entries = deserialize_stream(raw.get("entries"))
                pool_len = raw.get("pool_len")
                if entries is None or not isinstance(pool_len, int):
                    continue
                # Pad-and-pack headroom: widen recorded row counts and
                # capacity-relation sizes to their bucket boundary, so
                # any binding whose sizes land in the SAME buckets
                # replays without a violation re-record.  Sound by the
                # relation contract (backends/cuda/table.py): "rows" and
                # "cap" values serve correctly at any value >= actual,
                # and consumers re-bucket capacities — the compiled
                # shape is identical, the exactness comes from the
                # per-table live-row masks generic replay already
                # carries.
                entries = [
                    ("rows", lat.bucket(e[1])) if e[0] == "rows"
                    else (("size", lat.bucket(e[1]), "cap")
                          if e[0] == "size" and e[2] == "cap" else e)
                    for e in entries]
                if fused.seed_generic(graph, fam["query"], pool_len,
                                      entries):
                    streams += 1
        if streams:
            self._streams_c.inc(streams)
        return streams

    def _run(self) -> None:
        server = self.server
        t0 = clock.now()
        payload = self.store.load() if self.store is not None else None
        streams = self._seed(payload)
        targets = self._targets(payload)
        server.event_log.emit(
            "warmup.start", request_id=None, family=None,
            families=len(targets), streams_seeded=streams,
            store_loaded=payload is not None)
        completed_q, failures, truncated = set(), [], False
        failed_queries = set()
        graph = server._default_graph
        if getattr(graph, "graph_is_versioned", False):
            # warmup is read-only: resolve the mutable handle to the
            # latest committed snapshot once, exactly like the serving
            # read path — replicas cannot (and must not) replicate the
            # writable handle itself
            graph = graph.current()
        if server.config.devices is not None:
            replicas = list(server.devices.replicas)
        else:
            replicas = [server.devices.replicas[0]]

        def pool_sizes():
            out = {}
            for r in replicas:
                backend = getattr(r.session, "backend", None)
                if backend is not None:
                    out[id(r)] = len(backend.pool)
            return out

        def streams_stale() -> bool:
            # Only a STALE stream (exists, but the pool moved) warrants
            # another pass: re-executing pre-pays its record run.  An
            # absent stream (use_fused off, unfuseable params, never
            # recorded) would stay absent however many passes ran —
            # treating it as stale would burn every pass and report a
            # false non-convergence.
            for r in replicas:
                fused = getattr(r.session, "fused", None)
                if fused is None:
                    continue
                try:
                    rg = r.graph_for(graph)
                except Exception:  # pragma: no cover — replica without
                    continue       # this graph yet: nothing to converge
                for query, _params in targets:
                    if query not in failed_queries and \
                            fused.generic_state(rg, query) == "stale":
                        return True
            return False

        # Bounded convergence loop.  One pass executes every target
        # family on every replica through the normal compile path.  A
        # family's execution can GROW the string pool, which silently
        # invalidates pool-keyed warm state built earlier in the same
        # pass — other families' param-generic fused streams AND the
        # count-pushdown closures keyed (graph, params, pool, plan).
        # Whenever a pass grew any pool, or left a target's generic
        # stream pool-stale, run one more pass (the re-compiles land
        # HERE, inside warmup, instead of on first traffic).  Three
        # passes bound the worst case; an unconverged exit is reported,
        # never silent.
        converged, passes = False, 0
        for _pass in range(3):
            if truncated or not targets:
                converged = not targets
                break
            passes += 1
            before = pool_sizes()
            for query, params in targets:
                if query in failed_queries:
                    continue
                if self._stop.is_set() or (
                        self.config.max_seconds is not None
                        and clock.now() - t0 > self.config.max_seconds):
                    truncated = True
                    break
                ok = True
                for replica in replicas:
                    try:
                        with replica.lock, replica.activate():
                            replica.session.cypher_on_graph(
                                replica.graph_for(graph), query, params)
                    except Exception as ex:
                        ok = False
                        failed_queries.add(query)
                        failures.append({"query": query[:120],
                                         "device": replica.index,
                                         "pass": passes,
                                         "error": f"{type(ex).__name__}: "
                                                  f"{str(ex)[:160]}"})
                        server.event_log.emit(
                            "warmup.family_failed", request_id=None,
                            family=query[:120], device=replica.index,
                            error=f"{type(ex).__name__}: "
                                  f"{str(ex)[:160]}")
                        break
                if ok:
                    completed_q.add(query)
            if truncated:
                break
            if pool_sizes() == before and not streams_stale():
                converged = True
                break
        # a family is completed only when EVERY one of its bindings
        # warmed — a half-warmed rotation must not read as coverage
        completed = len(completed_q - failed_queries)
        seconds = clock.now() - t0
        self._completed_c.inc(completed)
        self._failed_c.inc(len(failures))
        self._seconds_c.inc(seconds)
        report = {
            "families_total": len({q for q, _p in targets}),
            "bindings_total": len(targets),
            "completed": completed,
            "failures": failures,
            "seconds": round(seconds, 6),
            "truncated": truncated,
            "streams_seeded": streams,
            "converged": converged,
            "passes": passes,
            "store": None if self.store is None else {
                "path": self.store.path,
                "loaded": payload is not None,
                "rejected": self.store.last_rejection,
            },
        }
        with self._lock:
            self._state = "done"
            self._report = report
        if not self._stop.is_set():
            # a cancelled run skips the emit: the server may already
            # have closed the event-log file sink, and a late write
            # would lazily reopen it
            server.event_log.emit(
                "warmup.done", request_id=None, family=None,
                outcome="done", families=len(targets),
                completed=completed, failures=len(failures),
                seconds=round(seconds, 6), truncated=truncated)

    # -- reads ---------------------------------------------------------

    def report(self) -> Dict[str, Any]:
        """The ``stats()["warmup"]`` / ``health_report()["warmup"]``
        section: state machine position plus the finished run's
        outcome."""
        with self._lock:
            out = {"state": self._state}
            out.update(self._report)
            return out
