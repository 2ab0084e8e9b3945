"""Failure taxonomy for the serving tier: the counterpart of
``caps_tpu/serve/failure.py``.

A single-controller PyTorch process has no executor blacklisting or
lineage re-execution, so the serving tier decides on its own what a
raised exception means for the request and for the shared engine state.
One function owns that decision:

    classify(exc) -> TRANSIENT | POISONED_PLAN | FATAL

* ``TRANSIENT`` — the execution environment hiccuped; the SAME
  execution path is expected to succeed on a retry.  A card that ran
  out of memory (``torch.cuda.OutOfMemoryError``), a CUDA runtime error
  raised by a launch or a copy (``torch.AcceleratorError``, or a
  ``RuntimeError`` whose message starts ``CUDA error`` — the retry lands
  on another replica, and :func:`device_fault` charges the card),
  connection and timeout errors, and anything explicitly marked
  ``caps_transient = True`` (the fault-injection harness and backend
  code use the marker).  The worker retries these with exponential
  backoff (:mod:`caps_tpu_torch.serve.retry`), charging the request's
  deadline.

* ``FATAL`` — the *request* is wrong or already resolved: syntax /
  semantic errors, missing parameters, cooperative cancellation and
  deadline expiry, and every :class:`~caps_tpu_torch.serve.errors.ServeError`.
  Retrying cannot change the outcome; the error completes the handle
  as-is.

* ``POISONED_PLAN`` — everything else.  The deliberate default: an
  unexplained execution error while serving from shared cached state
  (a cached operator tree, a fused size memo) must be treated as
  possible corruption of that state, because a poisoned entry fails
  every future hit on its key.  The worker quarantines the plan-cache
  entry, drops the fused memos, and walks the degraded ladder (fresh
  fused re-record → per-operator unfused execution); a query that is
  simply broken deterministically costs two extra executions once and
  then trips its family's circuit breaker.
"""
from __future__ import annotations

import torch

from caps_tpu_torch.serve.errors import CancellationError, ServeError

#: Classification outcomes (strings, not an Enum: they flow straight
#: into attempt-history dicts, metrics labels, and trace events).
TRANSIENT = "transient"
POISONED_PLAN = "poisoned_plan"
FATAL = "fatal"

#: the exception class PyTorch raises for a CUDA runtime error (a
#: failed launch, an illegal address, a lost card); older releases
#: raise a plain RuntimeError whose message starts "CUDA error"
_ACCELERATOR_ERROR = getattr(torch, "AcceleratorError", None)

#: Frontend / user-error exception class names (by name: the frontend
#: must stay importable without pulling the serving tier and vice
#: versa).
_FATAL_NAMES = frozenset({"CypherSyntaxError", "SemanticError",
                          "HeaderError", "NondeterministicResultError",
                          "UnsupportedOnDevice"})


def is_device_error(exc: BaseException) -> bool:
    """True when ``exc`` is a CUDA runtime error raised by a launch or
    a copy (not an out-of-memory error, which says nothing against the
    card)."""
    if isinstance(exc, torch.cuda.OutOfMemoryError):
        return False
    if _ACCELERATOR_ERROR is not None and isinstance(exc,
                                                     _ACCELERATOR_ERROR):
        return True
    return isinstance(exc, RuntimeError) \
        and str(exc).startswith("CUDA error")


def device_fault(exc: BaseException) -> bool:
    """True when the error indicts the DEVICE rather than the query or
    the cached plan — the only failures the per-device health ladder
    (serve/devices.py) counts.  An explicit ``caps_device_fault`` marker
    wins (the device-scoped fault injectors stamp it); otherwise CUDA
    runtime errors and connection failures qualify.  A user's bad query
    must never take a device down."""
    marker = getattr(exc, "caps_device_fault", None)
    if marker is not None:
        return bool(marker)
    return is_device_error(exc) or isinstance(exc, ConnectionError)


def attribute_device(exc: BaseException, device_index: int) -> None:
    """Stamp the replica index an execution error was observed on —
    first-writer-wins, like ``caps_failed_op`` (relational/ops.py): the
    device CLOSEST to the failure keeps the attribution through retries
    on other devices."""
    try:
        if getattr(exc, "caps_device_index", None) is None:
            exc.caps_device_index = device_index
    except Exception:  # pragma: no cover — immutable exception types
        pass


def device_of(exc: BaseException):
    """The replica index stamped by :func:`attribute_device` (None when
    the error never crossed a device execution bracket)."""
    return getattr(exc, "caps_device_index", None)


def quarantine_plan_state(session, graph, query, params,
                          exec_lock=None) -> None:
    """Evict one family's shared cached state on ``session``: the
    plan-cache entry anchored by (graph, query, params) and, on
    backends with a fused executor, its size memos.  The ONE
    poisoned-plan eviction sequence of the server's device path.
    ``exec_lock`` (the owning execution stream's lock) is held around
    the fused eviction: memo maps must not shrink under an in-flight
    fused run.  Never raises — containment must not fail."""
    import contextlib
    try:
        key_fn = getattr(session, "_plan_cache_key", None)
        if key_fn is not None:
            key = key_fn(graph, query, params)
            if key is not None:
                session.plan_cache.quarantine(key)
    except Exception:  # pragma: no cover — containment must not fail
        pass
    fused = getattr(session, "fused", None)
    if fused is not None:
        try:
            with (exec_lock if exec_lock is not None
                  else contextlib.nullcontext()):
                fused.forget(graph, query)
        except Exception:  # pragma: no cover — containment must not fail
            pass


def classify(exc: BaseException) -> str:
    """Map one raised exception to its containment treatment."""
    # explicit marker wins: the fault harness and backend code stamp
    # exceptions they KNOW are retryable / know are not
    marker = getattr(exc, "caps_transient", None)
    if marker is True:
        return TRANSIENT
    if marker is False:
        return FATAL
    # the serving tier's own errors are never retried by the serving
    # tier (cancellation, shedding, give-ups — all terminal here)
    if isinstance(exc, (CancellationError, ServeError)):
        return FATAL
    if isinstance(exc, torch.cuda.OutOfMemoryError):
        return TRANSIENT
    if is_device_error(exc):
        # the card failed the launch or the copy: retry (on another
        # replica when there is one); the device ladder counts it
        return TRANSIENT
    if isinstance(exc, (ConnectionError, TimeoutError)):
        return TRANSIENT
    if isinstance(exc, (SyntaxError, KeyError, NotImplementedError)) \
            or type(exc).__name__ in _FATAL_NAMES:
        # user error (bad query text / missing $param / unsupported
        # feature): deterministic, never the cache's fault
        return FATAL
    return POISONED_PLAN
