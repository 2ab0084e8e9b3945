"""The epoch-fenced write lease: who may accept writes for a fleet.

Lease state lives as one JSON file in the shared durable directory the
backends' WALs (and the PlanStore) already live in — no coordinator
process, just the shared filesystem:

    lease.json = {"owner": <backend name>, "epoch": int, "renewed_t": s}

The **epoch** is the fence.  It increments on every ownership change and
never reuses a value: claiming epoch ``e`` is a compare-and-swap through
an ``O_CREAT | O_EXCL`` claim file keyed by ``e`` (exactly one process
can create it), so two peers racing for a dead owner's lease cannot both
win.  Backends stamp their epoch on every write acknowledgement and
fence any write frame carrying a stale epoch with the typed
:class:`~caps_tpu_torch.serve.errors.StaleEpoch` — a zombie owner that missed
its own deposition can never split-brain the log.

Liveness is a TTL on ``renewed_t``: the owner renews on every write, and
a peer may steal only after the TTL has lapsed (``clock.now`` is the
sanctioned monotonic source — CLOCK_MONOTONIC is machine-wide, so
cross-process comparisons on the one shared host hold).

The store is **namespaced** by ``lease_name``: the default namespace
(``lease``) arbitrates the fleet's single write owner, and the router
tier (serve/ha.py) arbitrates its active/standby election through a
second namespace (``lease-router``) in the SAME directory with the SAME
CAS machinery — one fence implementation, two independently-epoched
leases that can never collide on a claim file.
"""
from __future__ import annotations

import json
import os
from typing import Any, Dict, Optional

from caps_tpu_torch.obs import clock
from caps_tpu_torch.obs.lockgraph import make_lock
from caps_tpu_torch.obs.metrics import MetricsRegistry, global_registry

#: the default namespace — the fleet's write-owner lease
DEFAULT_LEASE_NAME = "lease"
#: the router tier's active/standby lease namespace (serve/ha.py):
#: same directory, same CAS machinery, independent epochs
ROUTER_LEASE_NAME = "lease-router"
_CLAIM_SUFFIX = ".claim"


class LeaseStore:
    """One epoch-fenced lease, arbitrated through the shared store."""

    def __init__(self, dir_path: str, *, ttl_s: float = 5.0,
                 lease_name: str = DEFAULT_LEASE_NAME,
                 registry: Optional[MetricsRegistry] = None,
                 event_log=None):
        self.dir_path = os.path.abspath(dir_path)
        self.ttl_s = float(ttl_s)
        self.lease_name = str(lease_name)
        self._registry = registry if registry is not None else global_registry()
        self._event_log = event_log
        self._lock = make_lock("lease.LeaseStore._lock")
        os.makedirs(self.dir_path, exist_ok=True)

    @property
    def lease_path(self) -> str:
        return os.path.join(self.dir_path, f"{self.lease_name}.json")

    @property
    def _claim_prefix(self) -> str:
        return f"{self.lease_name}.epoch-"

    def _claim_path(self, epoch: int) -> str:
        return os.path.join(self.dir_path,
                            f"{self._claim_prefix}{epoch:08d}{_CLAIM_SUFFIX}")

    # -- reads ---------------------------------------------------------------

    def read(self) -> Optional[Dict[str, Any]]:
        """The current lease record, or None when nobody ever held it.
        A malformed file reads as absent — unlike a WAL checkpoint the
        lease carries no graph state, so the safe degradation is a fresh
        election, not a refusal."""
        try:
            with open(self.lease_path, encoding="utf-8") as f:
                record = json.load(f)
        except (OSError, ValueError):
            return None
        if (not isinstance(record, dict)
                or not isinstance(record.get("owner"), str)
                or not isinstance(record.get("epoch"), int)
                or not isinstance(record.get("renewed_t"), (int, float))):
            return None
        return record

    def expired(self, lease: Dict[str, Any]) -> bool:
        return clock.now() - float(lease["renewed_t"]) > self.ttl_s

    def holder(self, name: str) -> Optional[int]:
        """The live epoch ``name`` holds, else None."""
        lease = self.read()
        if lease is None or lease["owner"] != name or self.expired(lease):
            return None
        return lease["epoch"]

    # -- writes --------------------------------------------------------------

    def _write(self, record: Dict[str, Any]) -> None:
        tmp = f"{self.lease_path}.tmp.{os.getpid()}"
        with open(tmp, "w", encoding="utf-8") as f:
            f.write(json.dumps(record, sort_keys=True))
            f.flush()
            os.fsync(f.fileno())
        os.replace(tmp, self.lease_path)

    def acquire(self, name: str) -> Optional[int]:
        """Claim the lease for ``name``; the new (or renewed) epoch on
        success, None while another owner's lease is still live or a
        rival won the epoch CAS.  Never blocks — failover loops call
        this until the dead owner's TTL lapses."""
        with self._lock:
            current = self.read()
            if current is not None and not self.expired(current):
                if current["owner"] == name:
                    self._renew_locked(current)
                    return current["epoch"]
                self._registry.counter("wal.lease_conflicts").inc()
                return None
            next_epoch = (current["epoch"] if current is not None else 0) + 1
            claim = self._claim_path(next_epoch)
            try:
                fd = os.open(claim, os.O_CREAT | os.O_EXCL | os.O_WRONLY)
            except FileExistsError:
                # a rival claimed this epoch first.  If it then died
                # before publishing lease.json the epoch would wedge
                # forever, so a claim older than the TTL with no
                # matching lease is broken — the next acquire retries.
                try:
                    if (clock.wall() - os.path.getmtime(claim)) > self.ttl_s:
                        os.unlink(claim)
                except OSError:
                    pass
                self._registry.counter("wal.lease_conflicts").inc()
                return None
            os.close(fd)
            self._write({"owner": name, "epoch": next_epoch,
                         "renewed_t": clock.now()})
            self._sweep_claims(next_epoch)
            self._registry.counter("wal.lease_acquired").inc()
            self._registry.gauge("wal.lease_epoch").set(float(next_epoch))
            if self._event_log is not None:
                self._event_log.emit(
                    "wal.lease_acquired", request_id=None, family=None,
                    owner=name, epoch=next_epoch)
            return next_epoch

    def renew(self, name: str) -> bool:
        """Refresh the TTL at the SAME epoch; False when ``name`` no
        longer holds the lease (it must stop acknowledging writes)."""
        with self._lock:
            current = self.read()
            if current is None or current["owner"] != name:
                return False
            self._renew_locked(current)
            return True

    def _renew_locked(self, current: Dict[str, Any]) -> None:
        self._write({"owner": current["owner"], "epoch": current["epoch"],
                     "renewed_t": clock.now()})
        self._registry.counter("wal.lease_renewals").inc()

    def _sweep_claims(self, upto_epoch: int) -> None:
        """Drop claim files at or below the published epoch — they can
        never be contended again (epochs are monotone)."""
        try:
            names = os.listdir(self.dir_path)
        except OSError:
            return
        prefix = self._claim_prefix
        for fname in names:
            if not (fname.startswith(prefix)
                    and fname.endswith(_CLAIM_SUFFIX)):
                continue
            stem = fname[len(prefix):-len(_CLAIM_SUFFIX)]
            try:
                if int(stem) <= upto_epoch:
                    os.unlink(os.path.join(self.dir_path, fname))
            except (ValueError, OSError):
                continue
