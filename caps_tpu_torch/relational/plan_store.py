"""Persistent on-disk plan store: the cross-process warm path (the
counterpart of ``caps_tpu/relational/plan_store.py``).

A cold process pays for the engine-level warm state a process
accumulates — which plan families are hot, a shape-faithful parameter
binding per family, the fused executor's recorded size streams, and the
observed shape-bucket boundaries.  This module persists THAT state as a
versioned JSON index so a fresh process can warm itself through
``serve/warmup.py`` instead of re-learning it from live traffic.

Honesty contract (the store is a hint, never an authority):

* the payload is fingerprinted by store format, package version,
  backend (``cuda`` or ``cpu``) and device kind — a mismatch is **rejected** (counter
  ``planstore.rejected`` + a structured ``planstore.rejected`` event)
  and the process degrades to cold compile, exactly like a corrupt,
  truncated, or unwritable file;
* nothing executable is stored (plain JSON, no pickle): seeded fused
  size streams are re-verified at execution time by the generic-replay
  relation checks (``backends/cuda/table.py``) — a wrong stream
  re-records, it can never shape results;
* a missing store is a normal first boot, not an error.
"""
from __future__ import annotations

import json
import os
from typing import Any, Dict, List, Optional

import torch

STORE_FORMAT = 1

#: per-family cap on persisted size-stream entries — a runaway stream
#: must not balloon the index file
_MAX_STREAM_ENTRIES = 4096


def store_fingerprint() -> Dict[str, Any]:
    """What a payload must match to be trusted by THIS process: the
    store format, the package version, and the card this process sees
    (``cpu`` without one)."""
    import caps_tpu_torch
    if torch.cuda.is_available():
        backend, device_kind = "cuda", torch.cuda.get_device_name(0)
    else:
        backend = device_kind = "cpu"
    return {"format": STORE_FORMAT,
            "package": getattr(caps_tpu_torch, "__version__", "0"),
            "backend": backend, "device_kind": str(device_kind)}


def _serialize_stream(entries) -> Optional[List[List[Any]]]:
    """JSON form of a fused size stream, or None when it cannot
    round-trip faithfully (``__obj__`` entries hold live host objects)."""
    out: List[List[Any]] = []
    if len(entries) > _MAX_STREAM_ENTRIES:
        return None
    for e in entries:
        if not isinstance(e, tuple) or not e:
            return None
        if e[0] == "rows" and len(e) == 2 and isinstance(e[1], int):
            out.append(["rows", e[1]])
        elif e[0] == "size" and len(e) == 3 and isinstance(e[1], int) \
                and isinstance(e[2], str):
            out.append(["size", e[1], e[2]])
        else:  # __obj__ or an unknown tag: not persistable
            return None
    return out


def deserialize_stream(raw) -> Optional[List[tuple]]:
    """The inverse of :func:`_serialize_stream`, validating every entry
    — a damaged stream is dropped (None), never partially trusted."""
    if not isinstance(raw, list) or len(raw) > _MAX_STREAM_ENTRIES:
        return None
    out: List[tuple] = []
    for e in raw:
        if not isinstance(e, list) or not e:
            return None
        if e[0] == "rows" and len(e) == 2 and isinstance(e[1], int):
            out.append(("rows", e[1]))
        elif e[0] == "size" and len(e) == 3 and isinstance(e[1], int) \
                and isinstance(e[2], str):
            out.append(("size", e[1], e[2]))
        else:
            return None
    return out


def collect_warm_state(session, graph=None,
                       families: Optional[List[str]] = None
                       ) -> Dict[str, Any]:
    """Snapshot a session's warm state into a store payload: per hot
    family the original query text, the last JSON-able parameter
    binding (``session.warmup_bindings()``), the fused executor's
    param-generic size stream for ``graph`` (when the backend has one),
    and the observed max row count (the lattice seed)."""
    bindings = session.warmup_bindings()
    if families is not None:
        keep = set(families)
        bindings = [b for b in bindings if b["family"] in keep]
    streams: Dict[str, Dict[str, Any]] = {}
    fused = getattr(session, "fused", None)
    g = graph
    if g is not None and getattr(g, "graph_is_versioned", False):
        g = g.current()
    if fused is not None and g is not None:
        for query, rec in fused.export_streams(g).items():
            ser = _serialize_stream(rec["entries"])
            if ser is not None:
                streams[query] = {"pool_len": rec["pool_len"],
                                  "entries": ser}
    rows_max: Dict[str, int] = {}
    try:
        for fam, ops in session.op_stats.stats().items():
            rows_max[fam] = max((int(st.get("rows_max") or 0)
                                 for st in ops.values()), default=0)
    except Exception:  # pragma: no cover — stats shape drift
        rows_max = {}
    out_families = []
    for b in bindings:
        out_families.append({
            "family": b["family"],
            "query": b["query"],
            "params": b["params"],
            # every retained binding crossed a compile boundary (a
            # per-value compile cache's rotation) — warmup replays all
            "bindings": b.get("bindings") or [b["params"]],
            "stream": streams.get(b["query"]),
            "rows_max": rows_max.get(b["family"], 0),
        })
    stats_payload = None
    if graph is not None:
        # persist the ingest-time statistics sketch alongside the warm
        # state (relational/stats.py): a fresh process's cost model can
        # price its first plans from the PREVIOUS process's observed
        # graph shape instead of an empty prior
        try:
            stats = g.statistics() if g is not None else None
            if stats is not None and stats.total_nodes:
                stats_payload = stats.to_payload()
        except Exception:  # pragma: no cover — the store is a hint
            stats_payload = None
    return {
        "fingerprint": store_fingerprint(),
        "lattice": list(session.shape_lattice.boundaries()),
        "families": out_families,
        "stats": stats_payload,
    }


class PlanStore:
    """One JSON index file of warm-path state, loaded with suspicion.

    ``load()`` returns the validated payload or None; ``save(payload)``
    writes atomically (tmp + rename) and returns success.  EVERY way a
    store can be bad — unreadable, corrupt JSON, truncated, wrong
    fingerprint, malformed families, unwritable directory — lands in
    ``planstore.rejected`` (counter + structured event via
    ``event_log``) and degrades to a cold start; serving never sees an
    exception from here."""

    def __init__(self, path: str, registry=None, event_log=None):
        self.path = str(path)
        self._event_log = event_log
        self._rejected_c = (registry.counter("planstore.rejected")
                           if registry is not None else None)
        self._loaded_c = (registry.counter("planstore.loaded")
                         if registry is not None else None)
        self._saved_c = (registry.counter("planstore.saved")
                        if registry is not None else None)
        #: last rejection reason (None = never rejected) — the stats /
        #: warmup report surface
        self.last_rejection: Optional[str] = None

    def _reject(self, reason: str) -> None:
        self.last_rejection = reason
        if self._rejected_c is not None:
            self._rejected_c.inc()
        if self._event_log is not None:
            self._event_log.emit("planstore.rejected", request_id=None,
                                 family=None, path=self.path,
                                 reason=reason[:200])

    def load(self) -> Optional[Dict[str, Any]]:
        if not os.path.exists(self.path):
            return None  # first boot: nothing persisted yet, not an error
        try:
            with open(self.path, "r", encoding="utf-8") as f:
                raw = f.read()
        except OSError as ex:
            self._reject(f"unreadable: {type(ex).__name__}: {ex}")
            return None
        try:
            payload = json.loads(raw)
        except ValueError as ex:
            self._reject(f"corrupt: {ex}")
            return None
        if not isinstance(payload, dict):
            self._reject("corrupt: top-level value is not an object")
            return None
        want = store_fingerprint()
        have = payload.get("fingerprint")
        if have != want:
            self._reject(f"fingerprint mismatch: stored {have!r}, "
                         f"this process {want!r}")
            return None
        fams = payload.get("families")
        if not isinstance(fams, list) or not all(
                isinstance(f, dict) and isinstance(f.get("query"), str)
                and isinstance(f.get("params"), dict)
                and (f.get("bindings") is None
                     or (isinstance(f["bindings"], list)
                         and all(isinstance(b, dict)
                                 for b in f["bindings"])))
                for f in fams):
            self._reject("malformed families section")
            return None
        if self._loaded_c is not None:
            self._loaded_c.inc()
        return payload

    def save(self, payload: Dict[str, Any]) -> bool:
        tmp = f"{self.path}.tmp.{os.getpid()}"
        try:
            d = os.path.dirname(self.path)
            if d:
                os.makedirs(d, exist_ok=True)
            with open(tmp, "w", encoding="utf-8") as f:
                json.dump(payload, f, sort_keys=True)
            os.replace(tmp, self.path)
        except (OSError, TypeError, ValueError) as ex:
            self._reject(f"unwritable: {type(ex).__name__}: {ex}")
            try:
                os.remove(tmp)
            except OSError:
                pass
            return False
        if self._saved_c is not None:
            self._saved_c.inc()
        return True
