"""Write-path fault injection (the counterpart of two injectors of
``caps_tpu/testing/faults.py``).

* :func:`abort_write` — abort a versioned-graph commit mid-apply, after
  some of its delta columns were placed on the card;
* :func:`flaky_compaction` — fail compaction's column placements.

Both wrap the backend's one placement seam
(``backends/cuda/table.py DeviceBackend.place_column``) and raise a
transient error (``caps_transient = True``).  The failure-atomic commit
(relational/updates.py) must roll back completely under either: the
delta tables dropped, the string pool back at its pre-commit mark, the
snapshot unchanged.  The other injectors of the reference come with the
serving tier (ROADMAP Queue 1 item 8).
"""
from __future__ import annotations

import contextlib
from typing import Callable, Optional

from caps_tpu_torch.obs.lockgraph import make_lock
from caps_tpu_torch.obs.metrics import global_registry

#: one lock for installing and restoring the placement seam, so nested
#: and concurrent injectors compose (LIFO)
_patch_lock = make_lock("faults._patch_lock")


class _Budget:
    """Locked injection schedule shared across threads: fire on every
    ``every_n``-th eligible invocation (1 = every one), at most
    ``n_times`` total (None = unlimited — a permanent fault)."""

    def __init__(self, n_times: Optional[int], every_n: int = 1):
        self._n = n_times
        self._every = max(1, int(every_n))
        self._lock = make_lock("faults._Budget._lock")
        self._calls = 0
        self.injected = 0

    def take(self) -> bool:
        with self._lock:
            if self._n is not None and self._n <= 0:
                return False
            self._calls += 1
            if (self._calls - 1) % self._every:
                return False
            if self._n is not None:
                self._n -= 1
            self.injected += 1
            return True


def _count_injection(name: str) -> None:
    global_registry().counter(f"faults.injected.{name}").inc()


def _make_write_abort() -> BaseException:
    """A fresh transient ``ABORTED`` error: retrying the write is safe
    precisely because the commit it interrupted rolled back."""
    exc = RuntimeError("ABORTED: transfer interrupted mid-commit "
                       "[injected write abort]")
    exc.caps_transient = True
    return exc


@contextlib.contextmanager
def _patched_place_column(backend, wrap: Callable[[Callable], Callable]):
    """Replace ``backend.place_column`` with ``wrap(original)`` and
    restore the captured original on exit."""
    with _patch_lock:
        orig = backend.place_column
        backend.place_column = wrap(orig)
    try:
        yield
    finally:
        with _patch_lock:
            backend.place_column = orig


def _placement_backend(session, who: str):
    backend = getattr(session, "backend", None)
    if backend is None or not hasattr(backend, "place_column"):
        raise ValueError(f"{who} needs a device-backed session")
    return backend


@contextlib.contextmanager
def abort_write(session, after_n_columns: int = 1,
                n_times: Optional[int] = 1, every_n: int = 1):
    """Abort a versioned-graph commit MID-APPLY: the first
    ``after_n_columns`` column placements of each injection window
    succeed, then the next placement raises a fresh transient
    ``ABORTED`` error.  ``n_times`` bounds total injections (None =
    permanent), ``every_n`` spaces them out.  Compaction folds are NOT
    targeted (use :func:`flaky_compaction`).  Yields the injection
    budget (``.injected``)."""
    from caps_tpu_torch.relational.updates import in_compaction
    backend = _placement_backend(session, "abort_write")
    budget = _Budget(n_times, every_n)
    survived = {"n": 0}
    state_lock = make_lock("faults.abort_write.state_lock")

    def wrap(orig):
        def poisoned(col):
            if in_compaction():
                return orig(col)
            with state_lock:
                survived["n"] += 1
                fire = survived["n"] > after_n_columns
                if fire:
                    survived["n"] = 0  # next window builds afresh
            if fire and budget.take():
                _count_injection("abort_write")
                raise _make_write_abort()
            return orig(col)
        return poisoned

    with _patched_place_column(backend, wrap):
        yield budget


@contextlib.contextmanager
def flaky_compaction(session, error_rate: float = 0.5,
                     n_times: Optional[int] = None):
    """Fail a deterministic ~``error_rate`` fraction of COMPACTION
    column placements with a transient error — scoped by the
    compaction thread-local (relational/updates.py ``in_compaction``),
    so writes and reads never see it.  The fold must roll back (pool
    restored, snapshot unchanged) and the next attempt succeed once the
    budget is spent.  Yields the injection budget."""
    from caps_tpu_torch.relational.updates import in_compaction
    if not 0.0 < error_rate <= 1.0:
        raise ValueError(f"error_rate must be in (0, 1], got {error_rate}")
    backend = _placement_backend(session, "flaky_compaction")
    budget = _Budget(n_times, every_n=max(1, int(round(1.0 / error_rate))))

    def wrap(orig):
        def poisoned(col):
            if in_compaction() and budget.take():
                _count_injection("flaky_compaction")
                raise _make_write_abort()
            return orig(col)
        return poisoned

    with _patched_place_column(backend, wrap):
        yield budget
