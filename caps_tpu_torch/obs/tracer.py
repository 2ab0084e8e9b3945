"""Structured tracing: spans at query → phase → operator granularity.

The counterpart of ``caps_tpu/obs/tracer.py``.  A :class:`Span` records
wall time, optional device time (the delta up to a
``torch.cuda.synchronize`` of the card), output cardinality, and bytes
moved.
Spans nest: the :class:`Tracer` keeps a stack, and a span closed while a
parent is open attaches to that parent; root spans accumulate in
``tracer.spans`` until cleared or exported (``caps_tpu/obs/export.py``).

Overhead contract: with ``tracer.enabled`` False, ``span()``/``event()``
return/record nothing beyond one attribute check — the disabled path is
a shared :class:`NullSpan` singleton, so ambient instrumentation (every
relational operator, every session phase) costs one check and no
synchronizing call.

Module-level activation (``activate`` / ``active_tracer``) lets code
with no session handle (the compile ledger's charges) emit events into
whichever session's tracer is currently executing a query.
"""
from __future__ import annotations

import contextlib
import dataclasses
import threading
from typing import Any, Dict, Iterator, List, Optional

from caps_tpu_torch.obs import clock
from caps_tpu_torch.obs.lockgraph import make_lock

#: Optional provider of the executing device/replica index.  The serving
#: tier installs ``serve.devices.executing_device_index`` here (obs/ must
#: never import serve/, so the dependency is inverted): spans and events
#: opened inside a replica's execution bracket then carry a ``device``
#: attr, and the chrome exporter lays multi-replica traces on parallel
#: ``pid`` lanes (obs/export.py).  None (the default) costs nothing.
_device_index_provider = None


def set_device_index_provider(fn) -> None:
    """Install (or clear, with None) the thread-scoped device-index
    provider consulted when spans open."""
    global _device_index_provider
    _device_index_provider = fn


def _stamp_device(attrs: Dict[str, Any]) -> None:
    provider = _device_index_provider
    if provider is not None and "device" not in attrs:
        idx = provider()
        if idx is not None:
            attrs["device"] = idx


@dataclasses.dataclass
class Span:
    """One timed region.  ``t0`` is on the :mod:`caps_tpu_torch.obs.clock`
    monotonic base (shared with every other span, so exports can lay
    spans on one timeline)."""
    name: str
    kind: str = "phase"            # query | phase | operator | collective | event
    t0: float = 0.0
    wall_s: float = 0.0
    device_s: Optional[float] = None
    rows: Optional[int] = None
    bytes: Optional[int] = None
    attrs: Dict[str, Any] = dataclasses.field(default_factory=dict)
    children: List["Span"] = dataclasses.field(default_factory=list)

    def annotate(self, rows: Optional[int] = None,
                 bytes: Optional[int] = None,
                 device_s: Optional[float] = None, **attrs) -> "Span":
        if rows is not None:
            self.rows = rows
        if bytes is not None:
            self.bytes = bytes
        if device_s is not None:
            self.device_s = device_s
        if attrs:
            self.attrs.update(attrs)
        return self

    def to_dict(self) -> Dict[str, Any]:
        d: Dict[str, Any] = {"name": self.name, "kind": self.kind,
                             "t0": self.t0, "wall_s": self.wall_s}
        if self.device_s is not None:
            d["device_s"] = self.device_s
        if self.rows is not None:
            d["rows"] = self.rows
        if self.bytes is not None:
            d["bytes"] = self.bytes
        if self.attrs:
            d["attrs"] = dict(self.attrs)
        if self.children:
            d["children"] = [c.to_dict() for c in self.children]
        return d


class NullSpan:
    """Shared no-op span returned by a disabled tracer.  Every method is
    a no-op so instrumented code needs no enabled-checks of its own."""

    __slots__ = ()

    def __enter__(self) -> "NullSpan":
        return self

    def __exit__(self, *exc) -> bool:
        return False

    def annotate(self, *a, **kw) -> "NullSpan":
        return self


NULL_SPAN = NullSpan()


class _SpanCtx:
    """Context manager that opens ``span`` on enter and closes it on
    exit (timestamps + stack maintenance).  Exceptions mark the span and
    propagate."""

    __slots__ = ("_tracer", "span")

    def __init__(self, tracer: "Tracer", span: Span):
        self._tracer = tracer
        self.span = span

    def __enter__(self) -> Span:
        self.span.t0 = clock.now()
        self._tracer._stack.append(self.span)
        return self.span

    def __exit__(self, exc_type, exc, tb) -> bool:
        sp = self.span
        sp.wall_s = clock.now() - sp.t0
        if exc_type is not None:
            sp.attrs["error"] = exc_type.__name__
        tracer = self._tracer
        stack = tracer._stack
        # tolerate a torn stack (an unexited child after an exception):
        # pop down to and including this span
        while stack:
            top = stack.pop()
            if top is sp:
                break
        tracer._attach(sp)
        return False


class Tracer:
    """Span collector for one session (or the process-global default).

    ``enabled`` gates everything; ``sync_device`` asks instrumented
    operators to wait for the card (``torch.cuda.synchronize`` through
    ``Table.device_sync``; nothing to wait for on the CPU) before
    closing their span — PROFILE's per-operator device-time mode, see
    ``relational/ops.py``."""

    def __init__(self, enabled: bool = False, max_spans: int = 100_000):
        self.enabled = enabled
        self.sync_device = False
        self.max_spans = max_spans
        self.spans: List[Span] = []     # finished root spans
        # The open-span stack is PER THREAD (a cross-thread event must
        # not attach as a child of whatever span happens to be open over
        # there), while finished roots funnel into the shared ``spans``
        # list under a lock.
        self._tls = threading.local()
        self._spans_lock = make_lock("tracer.Tracer._spans_lock")
        self.dropped = 0                # spans beyond max_spans

    @property
    def _stack(self) -> List[Span]:
        stack = getattr(self._tls, "stack", None)
        if stack is None:
            stack = self._tls.stack = []
        return stack

    # -- recording -----------------------------------------------------

    def span(self, name: str, kind: str = "phase", **attrs):
        """Open a span; use as a context manager.  Disabled → NULL_SPAN."""
        if not self.enabled:
            return NULL_SPAN
        _stamp_device(attrs)
        return _SpanCtx(self, Span(name=name, kind=kind, attrs=attrs))

    def event(self, name: str, kind: str = "event", **attrs) -> None:
        """A zero-duration span (counter-style occurrence: a collective
        fired, a cache evicted)."""
        if not self.enabled:
            return
        _stamp_device(attrs)
        sp = Span(name=name, kind=kind, t0=clock.now(), attrs=attrs)
        rows = attrs.pop("rows", None)
        nbytes = attrs.pop("bytes", None)
        device_s = attrs.pop("device_s", None)
        sp.attrs = attrs
        if rows is not None:
            sp.rows = rows
        if nbytes is not None:
            sp.bytes = nbytes
        if device_s is not None:
            sp.device_s = device_s
        self._attach(sp)

    def _attach(self, span: Span) -> None:
        stack = self._stack
        if stack:
            stack[-1].children.append(span)
            return
        with self._spans_lock:
            if len(self.spans) < self.max_spans:
                self.spans.append(span)
            else:
                self.dropped += 1

    # -- inspection / lifecycle ----------------------------------------

    @property
    def current(self) -> Optional[Span]:
        return self._stack[-1] if self._stack else None

    def clear(self) -> None:
        with self._spans_lock:
            self.spans = []
            self.dropped = 0
        self._tls.stack = []  # only the calling thread's open stack

    @contextlib.contextmanager
    def forced(self, sync_device: bool = False) -> Iterator["Tracer"]:
        """Temporarily enable the tracer (PROFILE does this around one
        query even when ambient tracing is off)."""
        prev, prev_sync = self.enabled, self.sync_device
        self.enabled, self.sync_device = True, sync_device
        try:
            yield self
        finally:
            self.enabled, self.sync_device = prev, prev_sync


#: Disabled fallback returned when no tracer is active.
_NULL_TRACER = Tracer(enabled=False)

# Activation is PER THREAD: two sessions on two threads must not see —
# or pop — each other's active tracer.
_active_tls = threading.local()


def _active_stack() -> List[Tracer]:
    stack = getattr(_active_tls, "stack", None)
    if stack is None:
        stack = _active_tls.stack = []
    return stack


def active_tracer() -> Tracer:
    """The tracer of the session currently executing a query ON THIS
    THREAD, or a shared disabled tracer.  Used by instrumentation that
    has no session handle (compile charges)."""
    stack = _active_stack()
    return stack[-1] if stack else _NULL_TRACER


@contextlib.contextmanager
def activate(tracer: Tracer) -> Iterator[Tracer]:
    stack = _active_stack()
    stack.append(tracer)
    try:
        yield tracer
    finally:
        stack.pop()
