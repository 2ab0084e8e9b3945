"""CUDACypherSession — the user-facing session for the CUDA backend.

The counterpart of ``caps_tpu/backends/tpu/session.py``: the planning
stack is the backend-generic one; only the Table factory is
device-backed, and every read query runs through the fused
record/replay executor (``fused.py``).  The session runs on the card
unless the caller asks for ``device="cpu"`` (the tests do), where every
kernel wrapper takes its plain PyTorch version.  A record run is a
compile boundary (``obs/compile.py``), and PROFILE's epilogue says
which timings are device times and which are host dispatch
(``_annotate_profile``).
"""
from __future__ import annotations

from typing import Optional

import torch

from caps_tpu_torch import obs
from caps_tpu_torch.backends.cuda.fused import FusedExecutor
from caps_tpu_torch.backends.cuda.table import DeviceBackend, DeviceTableFactory
from caps_tpu_torch.obs import clock
from caps_tpu_torch.obs.compile import current_charges
from caps_tpu_torch.okapi.config import EngineConfig
from caps_tpu_torch.relational.result_cache import seeded_prefix_ids
from caps_tpu_torch.relational.session import (
    RelationalCypherSession, degraded_state,
)
from caps_tpu_torch.relational.shapes import (
    param_shape_signature, signature_text,
)
from caps_tpu_torch.relational.updates import is_update_query


class CUDACypherSession(RelationalCypherSession):

    # count-only pattern chains lower to SpMV (relational/count_pattern.py)
    supports_count_pushdown = True
    # cyclic MATCH segments may run as one worst-case-optimal multiway
    # join (relational/wcoj.py)
    supports_wcoj = True

    def __init__(self, config: Optional[EngineConfig] = None,
                 device="cuda"):
        super().__init__(config)
        device = torch.device(device)
        if device.type == "cuda" and not torch.cuda.is_available():
            raise RuntimeError(
                "CUDACypherSession: device 'cuda' requested but CUDA is not "
                "available (pass device='cpu' to run the plain versions)")
        if device.type not in ("cuda", "cpu"):
            raise ValueError(f"unsupported device {device}")
        self.device = device
        self.backend = DeviceBackend(self.config, device)
        # one lattice: the session-level shape buckets
        # (relational/shapes.py) ARE the device padding ladder, so a seed
        # from op_stats or the plan store adapts padding, compile-shape
        # labels and the batch keys together
        self.backend.shapes = self.shape_lattice
        self._factory = DeviceTableFactory(self.backend)
        self.fused = FusedExecutor(self.backend,
                                   max_entries=self.config.compile_cache_size)

    @property
    def table_factory(self) -> DeviceTableFactory:
        return self._factory

    def clone(self, device=None) -> "CUDACypherSession":
        """A fresh session of the same config on this session's device,
        or on ``device`` (a replica on another card — serve/devices.py).
        A clone of a card session is never placed on the CPU."""
        device = self.device if device is None else torch.device(device)
        if self.device.type == "cuda" and device.type != "cuda":
            raise ValueError(
                f"a clone of a session on {self.device} must stay on a "
                f"card, not {device}")
        return type(self)(config=self.config, device=device)

    def cypher_batch(self, graph, items, scopes=None):
        """Serving micro-batch (relational/session.py): the members'
        fused replays dispatch back to back under one ``fused.batch``
        bracket — no size read per exact-replay member, and the server
        reads the rows only after the last member, so the card's stream
        stays busy across the whole batch."""
        if self.config.use_fused and len(items) > 1:
            with self.fused.batch(len(items)):
                return super().cypher_batch(graph, items, scopes)
        return super().cypher_batch(graph, items, scopes)

    def _cypher_on_graph(self, graph, query, parameters=None):
        """Route every read query through the fused executor: the first
        run records the data-dependent sizes, repeats replay them with no
        device→host reads.  Attaches the per-query count of size reads
        (``size_syncs``), of reads of the values a string-making
        function formats (``held_reads``) and of generic replays to the
        result's metrics."""
        be = self.backend
        # degraded unfused mode (relational/session.py): per-operator
        # eager execution, no memo touched.  Update statements never
        # fuse: their effect is a commit, not a replayable size stream.
        use_fused = (self.config.use_fused and not degraded_state()[1]
                     and not is_update_query(query))
        syncs0, held0 = be.syncs, be.held_reads
        generic0 = self.fused.generic_replays
        # the mesh's communication accounting, as per-query deltas
        dist0 = (be.ici_bytes, be.dist_joins, be.broadcast_joins,
                 be.ici_payload_bytes, be.salted_joins, be.gathers,
                 be.gather_bytes)
        if not use_fused:
            result = super()._cypher_on_graph(graph, query, parameters)
        else:
            params = dict(parameters or {})
            key = self.fused.key(graph, query, params)
            charges = current_charges()
            n0 = len(charges) if charges is not None else 0
            result = self.fused.run(
                key, lambda: super(CUDACypherSession, self)._cypher_on_graph(
                    graph, query, parameters))
            if (key is not None and self.fused.last_mode == "record"
                    and result.metrics is not None):
                # Compile ledger: a record run is the fused compile
                # boundary (its host seconds are the first run of this
                # shape).  Replays charge nothing.  Boundaries inside the
                # execute phase (count-closure builds, multiway-join
                # step shapes) charged themselves: subtract them so a
                # query's compile seconds sum the wall clock once.
                exec_s = float(result.metrics.get("execute_s") or 0.0)
                if charges is not None:
                    exec_s -= sum(c["seconds"] for c in charges[n0:]
                                  if c["kind"] != "plan")
                # the shape label is the BUCKETED parameter signature: two
                # record runs whose bindings differ only within a bucket
                # are the same shape, so the second is a re-compile
                sig = signature_text(param_shape_signature(
                    params, lattice=self.shape_lattice))
                obs.compile_charge("fused_record", max(0.0, exec_s),
                                   shape=f"g{key[0]}:{sig}")
        if result.metrics is not None:
            result.metrics["size_syncs"] = be.syncs - syncs0
            result.metrics["held_reads"] = be.held_reads - held0
            for name, v0 in zip(("ici_bytes", "dist_joins",
                                 "broadcast_joins", "ici_payload_bytes",
                                 "salted_joins", "gathers",
                                 "gather_bytes"), dist0):
                result.metrics[name] = getattr(be, name) - v0
            if be.mesh is not None:
                result.metrics["mesh"] = be.mesh.describe()
            if use_fused:
                result.metrics["fused_generic_replays"] = \
                    self.fused.generic_replays - generic0
        if self._profiling:
            self._annotate_profile(result, use_fused)
        return result

    def _seed_subplans(self, rcache, root) -> int:
        """Seed the memoized prefixes, then put the set seeded into the
        size stream (``DeviceBackend.consume_seeds``): a replay recorded
        with another set diverges there, before an operator reads a size
        meant for another — the fused executor's audit then re-records,
        as the JAX package's does at its end-of-run count."""
        seeded = super()._seed_subplans(rcache, root)
        if seeded:
            self.backend.consume_seeds(",".join(
                str(i) for i in seeded_prefix_ids(root)))
        return seeded

    def _annotate_profile(self, result, use_fused: bool) -> None:
        """Fused-replay-aware PROFILE epilogue (never silently wrong
        numbers): when the query REPLAYED and per-op sync was off, the
        per-operator spans measured only host dispatch of an async
        stream — tag them so, and report device time as ONE per-replay
        aggregate span (the time to a ``torch.cuda.synchronize`` after
        the result).  Eager and record runs, and per-op-sync profiles,
        carry per-op times of their own.  A run that did not go through
        the fused executor (fusing off, a degraded eager run, an update)
        is ``eager``, whatever mode the executor's last run had."""
        mode = self.fused.last_mode if use_fused else None
        if result.metrics is not None:
            result.metrics["fused_mode"] = mode or "eager"
        replayed = mode in ("replay", "replay_gen")
        per_op_device = self.tracer.sync_device
        if result.profile is not None:
            obs.tag_timing(result.profile,
                           "device" if per_op_device else
                           ("dispatch" if replayed else "host"))
        if replayed and not per_op_device and result.records is not None:
            t0 = clock.now()
            result.records.table.device_sync()
            device_s = clock.now() - t0
            self.tracer.event("fused_replay.aggregate", kind="phase",
                              device_s=device_s, fused_mode=mode)
            if result.metrics is not None:
                result.metrics["replay_device_s"] = device_s
            if result.profile is not None:
                result.profile["replay_device_s"] = device_s
                # per-op rows under generic replay are served UPPER
                # bounds; fix the root to the exact result cardinality
                # (one read) and say what the inner numbers are
                if mode == "replay_gen":
                    result.profile["rows"] = \
                        result.records.table.exact_size()
                    result.profile["rows_inner"] = "upper-bound"

    def _evict_catalog_dependents(self, qgn) -> None:
        """A query that reads a catalog graph (FROM GRAPH) sees other
        sizes once the name is stored anew: its recorded size streams go
        with its cached plan."""
        super()._evict_catalog_dependents(qgn)
        self.fused.evict_dependents(qgn)

    def metrics_snapshot(self) -> dict:
        """The session snapshot (registry, plan cache, tracer) extended
        with the backend's size-read count, the fused executor's
        record/replay counters and the count closures built."""
        snap = super().metrics_snapshot()
        fused = self.fused
        snap.update({
            "backend.syncs": self.backend.syncs,
            "backend.held_reads": self.backend.held_reads,
            "fused.recordings": fused.recordings,
            "fused.replays": fused.replays,
            "fused.generic_replays": fused.generic_replays,
            "fused.mismatches": fused.mismatches,
            "fused.batches": fused.batches,
            "fused.batch_members": fused.batch_members,
            "fused.count_builds": self.backend.count_builds,
            "backend.ici_bytes": self.backend.ici_bytes,
            "backend.ici_payload_bytes": self.backend.ici_payload_bytes,
            "backend.dist_joins": self.backend.dist_joins,
            "backend.broadcast_joins": self.backend.broadcast_joins,
            "backend.salted_joins": self.backend.salted_joins,
            "backend.gathers": self.backend.gathers,
            "backend.gather_bytes": self.backend.gather_bytes,
        })
        return snap

    def health_check(self) -> dict:
        """Device health probe (SURVEY.md §5.3): a tiny canary
        computation on every shard's device (the session's device
        without a mesh), checked on the host.  Returns {shard: bool},
        keyed by ``str`` of the mesh slot (``"cuda:0#3"``) or of the
        device.  A failing device reports False instead of raising, so
        callers can shrink the mesh and re-shard."""
        be = self.backend
        targets = (list(be.mesh.slots) if be.mesh is not None
                   else [self.device])
        status = {}
        for t in targets:
            dev = getattr(t, "device", t)
            try:
                x = torch.arange(8, dtype=torch.int32, device=dev)
                ok = int((x * 2 + 1).sum()) == 64
            except Exception:
                ok = False
            status[str(t)] = ok
        return status

    def shrink_and_reshard(self, healthy=None, graphs=None) -> int:
        """Failure recovery (SURVEY.md §5.3): rebuild the mesh over the
        surviving shard slots (the largest power-of-two prefix, so
        bucketed capacities stay divisible; a 2-D mesh regroups the
        survivors by their DCN row and keeps rows slice-contiguous),
        re-place every table of every catalog graph (and of ``graphs``)
        over the survivors, and rebuild each relationship table's CSR.
        Returns the new shard count.

        A table is rebuilt on the new lead first (``sharded.recover``):
        from its columns' ingest mirrors where each has one (a lost
        card's buffers are unreadable; the mirror is the replica, as in
        the JAX package), else from its blocks, read only from
        ``healthy`` slots — a table that needs a lost slot's block and
        has a column without a mirror raises, before the session
        changes.  It is then placed anew: row-resident where its rows
        divide over the new mesh, whole on the new lead otherwise.

        A re-shard changes the shard count and with it every recorded
        size stream (bin capacities, per-shard output sizes): the fused
        executor's memo, the plan cache's entries, the count closures of
        the re-placed graphs and the result cache's memoized prefixes
        are dropped, so the next run of any query re-records.

        ``healthy``: the surviving mesh slots (default: those whose
        ``health_check`` passes)."""
        from caps_tpu_torch.backends.cuda.sharded import (
            ShardedTable, place_table, recover,
        )
        from caps_tpu_torch.backends.cuda.table import DeviceTable
        from caps_tpu_torch.okapi.catalog import SessionGraphDataSource
        from caps_tpu_torch.parallel.mesh import mesh_from_slots
        be = self.backend
        old = be.mesh
        if healthy is None:
            status = self.health_check()
            pool = list(old.slots) if old is not None else []
            healthy = [d for d in pool if status.get(str(d), False)]
        if not healthy:
            raise RuntimeError("no healthy devices to reshard onto")
        if old is not None and old.devices.ndim == 2:
            by_row = []
            for row in old.devices:
                keep = [d for d in row if d in healthy]
                if keep:
                    by_row.append(keep)
            width = 1 << (min(len(v) for v in by_row).bit_length() - 1)
            rows = [v[:width] for v in by_row]
            survivors = [d for r in rows for d in r]
        else:
            k = 1 << (len(healthy).bit_length() - 1)
            rows = survivors = list(healthy[:k])
        lead = torch.device(getattr(survivors[0], "device", self.device))
        home = old.slots[0] if old is not None else None

        targets = list(graphs or [])
        for ns in self.catalog.namespaces:
            src = self.catalog.source(ns)
            if isinstance(src, SessionGraphDataSource):
                targets.extend(src.graph(g) for g in src.graph_names())
        # every table whole on the new lead, before the session changes
        wholes = {}
        for g in targets:
            for et in (tuple(getattr(g, "node_tables", ()))
                       + tuple(getattr(g, "rel_tables", ()))):
                t = et.table
                if id(t) in wholes:
                    continue
                name = getattr(et.mapping, "rel_type", None) or ":".join(
                    sorted(getattr(et.mapping, "labels", ())))
                if isinstance(t, ShardedTable):
                    wholes[id(t)] = (t, recover(
                        be, t.parts, [p.backend.slot for p in t.parts],
                        healthy, lead, name))
                elif isinstance(t, DeviceTable):
                    wholes[id(t)] = (t, recover(
                        be, [t], [home], healthy if home is not None
                        else [None], lead, name))

        be.mesh = mesh_from_slots(rows)
        be.device = self.device = lead
        be.fused_count_static.clear()
        be.fused_count_fns.clear()
        be.algo_fns.clear()
        placed = {k: (t, place_table(w)) for k, (t, w) in wholes.items()}
        for g in targets:
            for et in (tuple(getattr(g, "node_tables", ()))
                       + tuple(getattr(g, "rel_tables", ()))):
                if id(et.table) in placed:
                    et.table = placed[id(et.table)][1]
            for rt in getattr(g, "rel_tables", ()):
                # rebuild the CSR physical layout on the new placement
                self._factory.prepare_rel_table(rt)
        # every recorded size stream and cached plan was made for the
        # old shard count; a memoized prefix may hold a block on a lost
        # slot's card, which is never read again
        self.fused.clear()
        self.plan_cache.clear()
        if self.result_cache is not None:
            self.result_cache.clear_subplans()
        return be.n_shards
