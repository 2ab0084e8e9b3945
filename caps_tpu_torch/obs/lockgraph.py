"""Runtime lock-order tracking (the counterpart of
``caps_tpu/obs/lockgraph.py``): the lock-acquisition graph built from
what threads actually do, checked for cycles as edges appear.

Opt-in and zero-cost when off: every lock in the instrumented modules is
created through :func:`make_lock` / :func:`make_rlock` /
:func:`make_condition`, which return *plain* ``threading`` primitives
unless ``CAPS_TPU_LOCK_GRAPH`` is set at creation time:

* ``CAPS_TPU_LOCK_GRAPH=1`` (or ``strict``) — record per-thread
  acquisition-order edges and **raise** :class:`LockOrderViolation` the
  moment a new edge closes a cycle (two lock names acquired in both
  orders somewhere in the process = a potential deadlock, caught at the
  first reversal instead of at the eventual deadlock);
* ``CAPS_TPU_LOCK_GRAPH=record`` — record edges, never raise (for
  harvesting a graph from a soak whose verdict comes afterwards).

Edges are keyed by lock *name*, not instance: the names are the
reference's (``<module>.<Class>.<attr>`` for instance locks,
``<module>.<name>`` for module-level locks), so fine-grained
per-instance locks (every ``obs.metrics.Counter``) fold into one node.  Re-entrant
re-acquisition by the holding thread records nothing, and self-edges
(two same-named instances nested) are dropped — per-instance leaf locks
never nest by construction, and a name-level self-edge would be pure
noise.
"""
from __future__ import annotations

import os
import threading
from typing import Dict, List, Optional, Tuple

__all__ = [
    "LockOrderViolation", "enabled", "make_lock", "make_rlock",
    "make_condition", "lock_graph_snapshot", "find_cycle", "reset",
]

_ENV = "CAPS_TPU_LOCK_GRAPH"


class LockOrderViolation(RuntimeError):
    """A lock acquisition closed a cycle in the observed lock-order
    graph: somewhere in this process the same two locks were taken in
    the opposite order — a potential deadlock."""

    def __init__(self, cycle: List[str]):
        super().__init__("lock-order cycle observed at runtime: "
                         + " -> ".join(cycle))
        self.cycle = cycle


def enabled() -> bool:
    """Tracking requested via the environment (read at lock creation)."""
    return _mode() in ("1", "true", "strict", "record")


def _mode() -> str:
    return os.environ.get(_ENV, "").strip().lower()


# -- the observed graph ------------------------------------------------------

_graph_lock = threading.Lock()
#: (holder name, acquired name) -> first-observed thread name
_edges: Dict[Tuple[str, str], str] = {}
_nodes: set = set()
_tls = threading.local()


def reset() -> None:
    """Drop every recorded node and edge (tests call this before a
    tracked run so earlier sessions' edges don't bleed in)."""
    with _graph_lock:
        _edges.clear()
        _nodes.clear()


def lock_graph_snapshot() -> Dict[str, list]:
    """The observed graph: ``{"nodes": [...], "edges": [(a, b), ...]}``
    — ``(a, b)`` means some thread acquired ``b`` while holding ``a``."""
    with _graph_lock:
        return {"nodes": sorted(_nodes),
                "edges": sorted(_edges.keys())}


def find_cycle(edges=None) -> Optional[List[str]]:
    """A cycle in the (observed or given) edge set as a node list
    ``[a, b, ..., a]``, or None when the graph is acyclic."""
    if edges is None:
        with _graph_lock:
            edges = list(_edges.keys())
    adj: Dict[str, List[str]] = {}
    for a, b in edges:
        adj.setdefault(a, []).append(b)
    WHITE, GREY, BLACK = 0, 1, 2
    color: Dict[str, int] = {}
    parent: Dict[str, str] = {}
    for start in sorted(adj):
        if color.get(start, WHITE) != WHITE:
            continue
        stack = [(start, iter(adj.get(start, ())))]
        color[start] = GREY
        while stack:
            node, it = stack[-1]
            advanced = False
            for nxt in it:
                c = color.get(nxt, WHITE)
                if c == GREY:  # back edge: walk parents to print the loop
                    cycle = [nxt, node]
                    cur = node
                    while cur != nxt:
                        cur = parent[cur]
                        cycle.append(cur)
                    cycle.reverse()
                    return cycle
                if c == WHITE:
                    color[nxt] = GREY
                    parent[nxt] = node
                    stack.append((nxt, iter(adj.get(nxt, ()))))
                    advanced = True
                    break
            if not advanced:
                color[node] = BLACK
                stack.pop()
    return None


def _held_stack() -> List[str]:
    stack = getattr(_tls, "held", None)
    if stack is None:
        stack = _tls.held = []
    return stack


def _note_acquired(name: str, strict: bool) -> None:
    held = _held_stack()
    if name in held:           # re-entrant: no new ordering information
        held.append(name)
        return
    new_edges = [(h, name) for h in dict.fromkeys(held) if h != name]
    held.append(name)
    added = False
    with _graph_lock:
        _nodes.add(name)
        for edge in new_edges:
            if edge not in _edges:
                _edges[edge] = threading.current_thread().name
                added = True
    if strict and added:
        # cycle check outside _graph_lock (find_cycle re-takes it)
        cycle = find_cycle()
        if cycle is not None:
            raise LockOrderViolation(cycle)


def _note_released(name: str) -> None:
    held = _held_stack()
    # release order may differ from acquisition order (condition waits,
    # hand-over-hand): remove the LAST occurrence of this name
    for i in range(len(held) - 1, -1, -1):
        if held[i] == name:
            del held[i]
            return


class TrackedLock:
    """Proxy around a ``threading`` lock that records acquisition-order
    edges.  Supports the Lock/RLock surface the engine uses (context
    manager, ``acquire(blocking, timeout)``, ``release``) and works as a
    :class:`threading.Condition` backing lock (the Condition falls back
    to its generic release-save/acquire-restore path)."""

    __slots__ = ("_inner", "name", "_strict")

    def __init__(self, inner, name: str, strict: bool = False):
        self._inner = inner
        self.name = name
        self._strict = strict

    def acquire(self, blocking: bool = True, timeout: float = -1) -> bool:
        got = self._inner.acquire(blocking, timeout)
        if got:
            try:
                _note_acquired(self.name, self._strict)
            except LockOrderViolation:
                # don't leave the lock held under an exception the
                # caller's ``with`` never got to manage
                self._inner.release()
                _note_released(self.name)
                raise
        return got

    def release(self) -> None:
        self._inner.release()
        _note_released(self.name)

    def __enter__(self) -> bool:
        return self.acquire()

    def __exit__(self, *exc) -> None:
        self.release()

    def locked(self) -> bool:
        locked = getattr(self._inner, "locked", None)
        return bool(locked()) if locked is not None else False

    # -- threading.Condition backing-lock protocol ---------------------
    # Delegating these keeps an RLock-backed tracked Condition exactly
    # as re-entrant as the stdlib default (Condition() uses an RLock):
    # wait() releases ALL recursion levels via the inner lock's own
    # save/restore, and ownership checks use the inner lock's real
    # bookkeeping instead of the acquire(0) fallback (which is wrong
    # for re-entrant locks).

    def _release_save(self):
        # an RLock's _release_save drops EVERY recursion level at once;
        # the held-stack must shed the same number of entries or later
        # acquisitions would record phantom edges from this lock
        held_count = _held_stack().count(self.name)
        rs = getattr(self._inner, "_release_save", None)
        state = rs() if rs is not None else self._inner.release()
        for _ in range(max(1, held_count)):
            _note_released(self.name)
        return (state, held_count)

    def _acquire_restore(self, saved) -> None:
        state, held_count = saved
        ar = getattr(self._inner, "_acquire_restore", None)
        if ar is not None:
            ar(state)
        else:
            self._inner.acquire()
        # push every recursion level FIRST (non-strict), then run one
        # cycle check: a violation mid-loop would leave the held stack
        # short of the restored levels, and the enclosing with-block's
        # releases would then corrupt it
        for _ in range(max(1, held_count)):
            _note_acquired(self.name, False)
        if self._strict:
            cycle = find_cycle()
            if cycle is not None:
                raise LockOrderViolation(cycle)

    def _is_owned(self) -> bool:
        owned = getattr(self._inner, "_is_owned", None)
        if owned is not None:
            return owned()
        if self._inner.acquire(False):
            self._inner.release()
            return False
        return True

    def __repr__(self) -> str:  # pragma: no cover — debugging aid
        return f"<TrackedLock {self.name!r} {self._inner!r}>"


def _strict() -> bool:
    return _mode() != "record"


def make_lock(name: str):
    """A ``threading.Lock`` — tracked under ``name`` when
    ``CAPS_TPU_LOCK_GRAPH`` is set at creation time."""
    if enabled():
        return TrackedLock(threading.Lock(), name, strict=_strict())
    return threading.Lock()


def make_rlock(name: str):
    """A ``threading.RLock`` — tracked under ``name`` when enabled
    (re-entrant re-acquisition records no edges)."""
    if enabled():
        return TrackedLock(threading.RLock(), name, strict=_strict())
    return threading.RLock()


def make_condition(name: str):
    """A ``threading.Condition`` whose backing lock is tracked under
    ``name`` when enabled.  The tracked lock wraps an RLock — exactly
    the stdlib default's semantics (``Condition()`` is RLock-backed),
    so re-entrant ``with cond:`` nesting behaves identically with
    tracking on or off.  Waiters release/re-acquire through the proxy's
    Condition protocol, so edges taken while re-acquiring after a
    wakeup are recorded like any other acquisition."""
    if enabled():
        return threading.Condition(
            TrackedLock(threading.RLock(), name, strict=_strict()))
    return threading.Condition()
