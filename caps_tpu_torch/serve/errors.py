"""Typed errors of the serving tier.

Every failure mode a client of :class:`caps_tpu_torch.serve.QueryServer` can
see is a distinct exception type carrying machine-usable fields — a
load-shedding client retries after ``Overloaded.retry_after_s``, a
deadline miss reports *which pipeline phase* consumed the budget
(``DeadlineExceeded.phase``) so capacity planning can tell a planning
stall from a device stall from queue pressure.

**Wire fidelity.**  The fleet tier (serve/wire.py, serve/router.py)
carries these errors between processes.  Every class serializes with
:meth:`ServeError.to_payload` and reconstructs with
:func:`error_from_payload` — EXACTLY: message, ``retry_after_s``,
``attempts`` histories, phases, and budget fields all survive the JSON
round trip, so a remote client's backoff and retry decisions are made
from the same machine-usable fields a local caller would see
(tests/test_fleet.py runs the parity matrix over every class here)."""
from __future__ import annotations

from typing import Any, Dict, Optional, Tuple


class ServeError(RuntimeError):
    """Base class for all serving-tier errors.

    Invariant (enforced by the capslint error-taxonomy pass): every
    exception *constructed and raised* inside ``serve/``
    inherits from this class, so a client needs exactly one except
    clause to catch everything the serving tier itself can signal."""

    def to_payload(self) -> Dict[str, Any]:
        """JSON-able wire form: class name, message, and every
        machine-usable field (:meth:`_payload_fields`).  The inverse is
        :func:`error_from_payload`."""
        out: Dict[str, Any] = {"error": type(self).__name__,
                               "message": str(self)}
        out.update(self._payload_fields())
        return out

    def _payload_fields(self) -> Dict[str, Any]:
        """Subclass hook: the constructor-relevant fields beyond the
        message (must round-trip through JSON exactly)."""
        return {}

    @classmethod
    def _rebuild(cls, payload: Dict[str, Any]) -> "ServeError":
        """Reconstruct from :meth:`to_payload` output.  The default
        covers message-only constructors; field-carrying subclasses
        override it to restore their exact machine-usable state."""
        return cls(str(payload.get("message", "")))


class NotPorted(ServeError, NotImplementedError):
    """A serving feature of the JAX package the port has not reached
    (none is left since shard groups were ported; the type stays in the
    wire protocol's error set): a ServeError, and the NotImplementedError
    naming ROADMAP that an unported feature of the port raises."""


class ServerClosed(ServeError):
    """submit() after shutdown() began: the server accepts no new work."""


class Overloaded(ServeError):
    """Admission control shed this request instead of queuing unboundedly.

    ``retry_after_s`` is the server's estimate of when capacity frees up
    (queue depth x recent per-request service time / workers) — the
    back-off hint a well-behaved client honors."""

    def __init__(self, message: str, retry_after_s: float = 0.0,
                 queue_depth: int = 0, priority: int = 0):
        super().__init__(message)
        self.retry_after_s = retry_after_s
        self.queue_depth = queue_depth
        self.priority = priority

    def _payload_fields(self) -> Dict[str, Any]:
        return {"retry_after_s": self.retry_after_s,
                "queue_depth": self.queue_depth,
                "priority": self.priority}

    @classmethod
    def _rebuild(cls, payload: Dict[str, Any]) -> "Overloaded":
        return cls(str(payload.get("message", "")),
                   retry_after_s=float(payload.get("retry_after_s", 0.0)),
                   queue_depth=int(payload.get("queue_depth", 0)),
                   priority=int(payload.get("priority", 0)))


class WaitTimeout(ServeError, TimeoutError):
    """A *client wait* on a handle ran out (``QueryHandle.result(timeout)``)
    — says nothing about the request itself, which is still in flight.
    Subclasses :class:`TimeoutError` so pre-existing ``except
    TimeoutError`` call sites keep working."""


class QueryFailed(ServeError):
    """Terminal failure after the server exhausted its containment
    ladder (transient retries, plan quarantine, degraded re-execution).

    ``attempts`` is the machine-readable attempt history — one dict per
    execution with the mode it ran in (``fused`` / ``replan`` /
    ``unfused``), the error type/classification observed, and any backoff
    charged — so a client (or the soak test) can reconstruct exactly
    what the server tried.  ``retry_after_s`` reuses the
    :class:`Overloaded` hint semantics: when the give-up was budget- or
    breaker-driven, it is the earliest time a retry could behave
    differently (0.0 = retrying will not help)."""

    def __init__(self, message: str, attempts: Tuple[dict, ...] = (),
                 retry_after_s: float = 0.0):
        super().__init__(message)
        self.attempts = tuple(attempts)
        self.retry_after_s = retry_after_s

    def _payload_fields(self) -> Dict[str, Any]:
        return {"attempts": [dict(a) for a in self.attempts],
                "retry_after_s": self.retry_after_s}

    @classmethod
    def _rebuild(cls, payload: Dict[str, Any]) -> "QueryFailed":
        return cls(str(payload.get("message", "")),
                   attempts=tuple(dict(a) for a in
                                  payload.get("attempts", ())),
                   retry_after_s=float(payload.get("retry_after_s", 0.0)))


class CircuitOpen(QueryFailed):
    """Fast-fail: this request's plan family tripped its circuit breaker
    and the cooldown has not elapsed — the server refuses to burn device
    time on a family that is failing deterministically.  ``retry_after_s``
    is the remaining cooldown (after it, one half-open trial runs)."""

    def __init__(self, message: str, retry_after_s: float = 0.0):
        super().__init__(message, attempts=(), retry_after_s=retry_after_s)

    def _payload_fields(self) -> Dict[str, Any]:
        return {"retry_after_s": self.retry_after_s}

    @classmethod
    def _rebuild(cls, payload: Dict[str, Any]) -> "CircuitOpen":
        return cls(str(payload.get("message", "")),
                   retry_after_s=float(payload.get("retry_after_s", 0.0)))


class CompactionFailed(ServeError):
    """The background compactor (serve/compaction.py) could not run —
    misconfiguration (a non-versioned graph) or a fold failure surfaced
    to a caller.  Routine fold failures are NOT raised: they roll back,
    count ``compaction.failures``, and retry on the next tick."""


class ReplicationUnsupported(ServeError):
    """A graph that cannot be re-ingested onto another device replica
    (only scan graphs and the empty ambient graph replicate — see
    ``serve/devices.py``).  The server never surfaces this to clients:
    requests against such graphs are pinned to device 0."""


class ShardingUnsupported(ServeError):
    """A graph that cannot be served by a shard group (serve/shards.py):
    only scan-backed graphs partition, and a group manages its OWN
    versioned write lineage — handing it an externally versioned graph
    would split the commit history two ways.  Writes themselves are
    served: the sharded commit protocol splits staged ops per shard and
    commits them atomically at the group's WAL append.  Classified
    FATAL: retrying cannot change it."""


class ShardMemberDown(ServeError):
    """A single-shard-routed query's owning member is quarantined and
    its background rebuild has not finished.  Marked ``caps_transient``
    at construction: the serving tier's retry ladder backs off and
    re-executes — by then the rebuild may have reinstated the member —
    instead of walking the poisoned-plan ladder."""

    def __init__(self, message: str, member: Optional[int] = None):
        super().__init__(message)
        self.caps_transient = True
        if member is not None:
            #: member attribution for the group ladder (serve/shards.py)
            self.caps_shard_member = member

    def _payload_fields(self) -> Dict[str, Any]:
        return {"member": getattr(self, "caps_shard_member", None)}

    @classmethod
    def _rebuild(cls, payload: Dict[str, Any]) -> "ShardMemberDown":
        member = payload.get("member")
        return cls(str(payload.get("message", "")),
                   member=None if member is None else int(member))


class CancellationError(ServeError):
    """Base of the two cooperative-cancel outcomes (deadline, explicit).

    The fused executor re-raises these immediately instead of treating
    them as replay divergence: a query killed by its budget must not be
    transparently re-executed."""

    def __init__(self, message: str, phase: str = "?"):
        super().__init__(message)
        #: pipeline phase at which the cancellation was observed
        #: (queued | parse | plan | execute | materialize)
        self.phase = phase

    def _payload_fields(self) -> Dict[str, Any]:
        return {"phase": self.phase}

    @classmethod
    def _rebuild(cls, payload: Dict[str, Any]) -> "CancellationError":
        return cls(str(payload.get("message", "")),
                   phase=str(payload.get("phase", "?")))


class DeadlineExceeded(CancellationError):
    """The request's deadline expired; ``phase`` attributes the budget."""

    def __init__(self, phase: str, budget_s: Optional[float],
                 elapsed_s: float):
        super().__init__(
            f"deadline exceeded in phase {phase!r} "
            f"(budget {budget_s if budget_s is not None else '?'} s, "
            f"elapsed {elapsed_s:.4f} s)", phase=phase)
        self.budget_s = budget_s
        self.elapsed_s = elapsed_s

    def _payload_fields(self) -> Dict[str, Any]:
        return {"phase": self.phase, "budget_s": self.budget_s,
                "elapsed_s": self.elapsed_s}

    @classmethod
    def _rebuild(cls, payload: Dict[str, Any]) -> "DeadlineExceeded":
        # the message is deterministic from the fields, so rebuilding
        # through the constructor reproduces it byte-for-byte
        budget = payload.get("budget_s")
        return cls(str(payload.get("phase", "?")),
                   None if budget is None else float(budget),
                   float(payload.get("elapsed_s", 0.0)))


class Cancelled(CancellationError):
    """The client cancelled the request (``QueryHandle.cancel()``)."""

    def __init__(self, phase: str = "queued"):
        super().__init__(f"request cancelled in phase {phase!r}",
                         phase=phase)

    @classmethod
    def _rebuild(cls, payload: Dict[str, Any]) -> "Cancelled":
        # message is derived from the phase — reconstruct, don't pass
        return cls(phase=str(payload.get("phase", "queued")))


class WireError(ServeError):
    """A fleet wire-protocol transport failure (serve/wire.py): the
    connection dropped mid-call, a frame was malformed or oversized, or
    the peer closed before replying.  Marked ``caps_transient`` at
    construction — the router's obligation under this error is to
    degrade the backend's ring segment and retry the request on the
    next ring node, exactly like the device ladder retries on a
    different replica."""

    def __init__(self, message: str):
        super().__init__(message)
        self.caps_transient = True


class FleetUnavailable(ServeError):
    """The router exhausted every live ring node for a request (all
    backends dead or overloaded).  ``retry_after_s`` carries the best
    backoff hint observed along the way (the largest ``Overloaded``
    hint, or 0.0 when the failures were connection-level)."""

    def __init__(self, message: str, retry_after_s: float = 0.0):
        super().__init__(message)
        self.retry_after_s = retry_after_s

    def _payload_fields(self) -> Dict[str, Any]:
        return {"retry_after_s": self.retry_after_s}

    @classmethod
    def _rebuild(cls, payload: Dict[str, Any]) -> "FleetUnavailable":
        return cls(str(payload.get("message", "")),
                   retry_after_s=float(payload.get("retry_after_s", 0.0)))


class WalWriteError(ServeError):
    """A write-ahead-log append (or its fsync) failed BEFORE the commit
    acknowledged (caps_tpu_torch/durability/wal.py).  The commit rolls back
    through the string-pool mark and this error surfaces to the writer —
    a durability failure is NEVER a silent ack.  Marked
    ``caps_transient``: disk pressure and injected fsync faults are
    retryable; the graph itself is untouched."""

    def __init__(self, message: str):
        super().__init__(message)
        self.caps_transient = True


class StaleEpoch(ServeError):
    """An epoch-fenced write frame was refused (caps_tpu_torch/durability):
    the backend no longer holds the write lease, or the frame carries an
    epoch older than the lease's.  This is the split-brain fence — a
    zombie owner (or a router with a stale ownership view) learns who
    actually owns writes from the carried fields and re-routes.
    Classified FATAL on purpose: blind retry against the same backend
    cannot succeed; the caller must re-elect."""

    def __init__(self, message: str, epoch: Optional[int] = None,
                 lease_epoch: Optional[int] = None,
                 owner: Optional[str] = None):
        super().__init__(message)
        #: the epoch the refused frame carried (None = frame had none)
        self.epoch = epoch
        #: the live lease's epoch at refusal time
        self.lease_epoch = lease_epoch
        #: the live lease's owner — where writes actually go now
        self.owner = owner

    def _payload_fields(self) -> Dict[str, Any]:
        return {"epoch": self.epoch, "lease_epoch": self.lease_epoch,
                "owner": self.owner}

    @classmethod
    def _rebuild(cls, payload: Dict[str, Any]) -> "StaleEpoch":
        epoch = payload.get("epoch")
        lease_epoch = payload.get("lease_epoch")
        owner = payload.get("owner")
        return cls(str(payload.get("message", "")),
                   epoch=None if epoch is None else int(epoch),
                   lease_epoch=(None if lease_epoch is None
                                else int(lease_epoch)),
                   owner=None if owner is None else str(owner))


def _error_classes() -> Dict[str, type]:
    """Every ServeError subclass reachable from the base (this module
    defines them all; subclasses registered elsewhere resolve too)."""
    out: Dict[str, type] = {"ServeError": ServeError}
    stack = [ServeError]
    while stack:
        cls = stack.pop()
        for sub in cls.__subclasses__():
            if sub.__name__ not in out:
                out[sub.__name__] = sub
                stack.append(sub)
    return out


def error_from_payload(payload: Dict[str, Any]) -> ServeError:
    """The inverse of :meth:`ServeError.to_payload`: reconstruct the
    exact typed error a remote process raised.  An unknown class name
    (version skew across the fleet) degrades to a :class:`QueryFailed`
    carrying the original class name in its message — never an
    exception from here."""
    if not isinstance(payload, dict):
        return QueryFailed(f"malformed wire error payload: {payload!r}")
    name = payload.get("error")
    cls = _error_classes().get(name) if isinstance(name, str) else None
    if cls is None:
        return QueryFailed(f"unrecognized wire error {name!r}: "
                           f"{payload.get('message', '')}")
    return cls._rebuild(payload)
