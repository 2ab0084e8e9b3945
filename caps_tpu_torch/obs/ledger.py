"""Memory ledger: byte accounting for the engine's resident state.

The counterpart of ``caps_tpu/obs/ledger.py``.  Per-operator
``bytes_in`` (relational/ops.py) measures bytes *moved* per execution;
this module measures bytes *held* — the plan cache, the string pool,
base and delta tables per snapshot version, and the card's allocator:

* :class:`MemoryLedger` — one per session: live ``mem.*`` gauges
  (plan-cache bytes, string-pool bytes, tracked-graph bytes, device
  bytes in use) registered in the session registry so they ride
  ``metrics_snapshot()``;
* :func:`snapshot_footprint` — duck-typed byte breakdown of any graph:
  plain scan graphs report one total, versioned graphs / snapshots
  split base vs delta bytes per snapshot version
  (``GraphSnapshot.delta_nbytes``);
* :func:`device_memory` — per-device live bytes from
  ``torch.cuda.memory_stats`` (``allocated_bytes.all.current`` and
  ``.peak``) beside the card's total memory; a CPU device reports
  ``{"available": False}`` instead of a zero.

Table ``nbytes`` walks column buffers without reading the device, and
a probe that cannot measure says so rather than reporting 0.
"""
from __future__ import annotations

import weakref
from typing import Any, Dict

import torch

from caps_tpu_torch.obs.lockgraph import make_lock


def tables_nbytes(entity_tables) -> int:
    """Summed ``table.nbytes`` over a graph's entity-table sequence
    (never raises: a table that cannot report counts 0)."""
    n = 0
    for et in entity_tables or ():
        t = getattr(et, "table", et)
        try:
            n += int(t.nbytes)
        except Exception:
            pass
    return n


def _scan_bytes(graph) -> int:
    return (tables_nbytes(getattr(graph, "node_tables", ()))
            + tables_nbytes(getattr(graph, "rel_tables", ())))


def snapshot_footprint(graph) -> Dict[str, Any]:
    """Byte breakdown of one graph.  Versioned handles resolve to their
    current snapshot; snapshots split base vs delta (delta tables +
    tombstone id sets) and carry their version; plain graphs report one
    total under ``bytes``."""
    if getattr(graph, "graph_is_versioned", False):
        current = getattr(graph, "current", None)
        if current is not None:
            return snapshot_footprint(current())
    state = getattr(graph, "state", None)
    base = getattr(graph, "base", None)
    if state is not None and base is not None:
        base_b = _scan_bytes(base)
        delta_nbytes = getattr(graph, "delta_nbytes", None)
        delta_b = delta_nbytes() if delta_nbytes is not None else 0
        return {"snapshot_version": getattr(graph, "snapshot_version", 0),
                "base_bytes": base_b, "delta_bytes": delta_b,
                "delta_rows": state.delta_rows,
                "bytes": base_b + delta_b}
    return {"bytes": _scan_bytes(graph)}


def device_memory(device=None) -> Dict[str, Dict[str, Any]]:
    """Per-device allocator stats.  ``device`` None means every card of
    the process (or the CPU when there is none).  A card reports its
    allocated bytes now and at peak (``torch.cuda.memory_stats``) and
    its total memory; the CPU reports ``{"available": False}`` — an
    honest "cannot measure", never a fake zero."""
    if device is not None:
        device = torch.device(device)
        if device.type != "cuda":
            return {str(device): {"available": False}}
        indices = [device.index if device.index is not None
                   else torch.cuda.current_device()]
    elif torch.cuda.is_available():
        indices = list(range(torch.cuda.device_count()))
    else:
        return {"cpu": {"available": False}}
    out: Dict[str, Dict[str, Any]] = {}
    for i in indices:
        stats = torch.cuda.memory_stats(i)
        out[f"cuda:{i}"] = {
            "available": True,
            "bytes_in_use": int(stats.get("allocated_bytes.all.current", 0)),
            "peak_bytes_in_use": int(stats.get("allocated_bytes.all.peak",
                                               0)),
            "bytes_limit": int(torch.cuda.get_device_properties(i)
                               .total_memory)}
    return out


def device_bytes_in_use(device=None) -> int:
    """Summed live bytes across devices that can report (0 when none
    can — pair with :func:`device_memory` to tell "idle" from "blind")."""
    return sum(e.get("bytes_in_use", 0)
               for e in device_memory(device).values())


class MemoryLedger:
    """Byte accounting for one session's resident state.

    Registers live ``mem.*`` gauges in ``registry`` (callbacks read the
    session's plan cache / string pool / tracked graphs / device at
    snapshot time) and serves the structured :meth:`report`.  Graphs
    are tracked by weakref — a dropped graph falls out of the ledger
    instead of being pinned by it."""

    def __init__(self, registry=None, session=None):
        self._session = (weakref.ref(session) if session is not None
                         else lambda: None)
        # name -> {owner key -> graph weakref} (insertion-ordered:
        # newest owner last)
        self._graphs: Dict[str, Dict[Any, Any]] = {}
        self._lock = make_lock("ledger.MemoryLedger._lock")
        if registry is not None:
            registry.gauge("mem.plan_cache_bytes", fn=self.plan_cache_bytes)
            registry.gauge("mem.result_cache_bytes",
                           fn=self.result_cache_bytes)
            registry.gauge("mem.string_pool_bytes",
                           fn=self.string_pool_bytes)
            registry.gauge("mem.tracked_graph_bytes",
                           fn=self.tracked_graph_bytes)
            registry.gauge("mem.device_bytes_in_use",
                           fn=self.device_bytes_in_use)

    def _device(self):
        return getattr(self._session(), "device", None)

    # -- tracked graphs -------------------------------------------------

    def track(self, name: str, graph, owner=None) -> None:
        """Account ``graph`` under ``name`` (weakly); each ``owner``
        holds its own slot under the name."""
        try:
            ref = weakref.ref(graph)
        except TypeError:  # pragma: no cover — non-weakrefable graph
            ref = (lambda g=graph: g)
        key = id(owner) if owner is not None else None
        with self._lock:
            slot = self._graphs.setdefault(name, {})
            slot.pop(key, None)
            slot[key] = ref  # newest last (dict preserves insertion)

    def untrack(self, name: str) -> None:
        """Drop EVERY owner's entry under ``name``."""
        with self._lock:
            self._graphs.pop(name, None)

    def untrack_if(self, name: str, graph, owner=None) -> bool:
        """Untrack ``owner``'s slot under ``name`` only while it still
        refers to ``graph`` — other owners' slots (and a re-track that
        replaced this one) are untouched."""
        key = id(owner) if owner is not None else None
        with self._lock:
            slot = self._graphs.get(name)
            if slot is not None:
                ref = slot.get(key)
                if ref is not None and ref() is graph:
                    del slot[key]
                    if not slot:
                        del self._graphs[name]
                    return True
        return False

    def _live_graphs(self) -> Dict[str, Any]:
        with self._lock:
            slots = {name: list(slot.values())
                     for name, slot in self._graphs.items()}
        out = {}
        for name, refs in slots.items():
            for ref in reversed(refs):  # newest live owner wins
                g = ref()
                if g is not None:
                    out[name] = g
                    break
        return out

    # -- gauge callbacks ------------------------------------------------

    def plan_cache_bytes(self) -> int:
        cache = getattr(self._session(), "plan_cache", None)
        if cache is None:
            return 0
        try:
            return int(cache.stats()["bytes"])
        except Exception:  # pragma: no cover — accounting must not fail
            return 0

    def result_cache_bytes(self) -> int:
        cache = getattr(self._session(), "result_cache", None)
        if cache is None:
            return 0
        try:
            return int(cache.bytes)
        except Exception:  # pragma: no cover — accounting must not fail
            return 0

    def string_pool_bytes(self) -> int:
        pool = getattr(getattr(self._session(), "backend", None), "pool",
                       None)
        if pool is None:
            return 0
        try:
            return int(pool.nbytes)
        except Exception:  # pragma: no cover
            return 0

    def tracked_graph_bytes(self) -> int:
        return sum(snapshot_footprint(g)["bytes"]
                   for g in self._live_graphs().values())

    def device_bytes_in_use(self) -> int:
        return device_bytes_in_use(self._device())

    # -- the structured view --------------------------------------------

    def report(self) -> Dict[str, Any]:
        """The full byte picture: plan cache, string pool, per-tracked-
        graph footprints (base/delta split per snapshot version), and
        the session's device."""
        graphs = {name: snapshot_footprint(g)
                  for name, g in self._live_graphs().items()}
        devices = device_memory(self._device())
        return {
            "plan_cache_bytes": self.plan_cache_bytes(),
            "result_cache_bytes": self.result_cache_bytes(),
            "string_pool_bytes": self.string_pool_bytes(),
            "graphs": graphs,
            "tracked_graph_bytes": sum(f["bytes"]
                                       for f in graphs.values()),
            "devices": devices,
            "device_bytes_in_use": sum(e.get("bytes_in_use", 0)
                                       for e in devices.values()),
        }
