"""Composable, thread-safe fault injection (the counterpart of
``caps_tpu/testing/faults.py``, with the injectors the serving tier and
its tests use).

The failure-containment layer (``caps_tpu_torch/serve/``: transient
retry, plan quarantine, degraded execution, device fault domains) needs
faults it can practice against.  This module provides them:

* :func:`failing_operator` — raise a chosen exception from one
  relational operator's ``_compute``, transiently (``n_times=1`` fails
  the next execution then heals) or permanently (``n_times=None``);
* :func:`slow_operator` — deterministic per-operator delay (deadline /
  cancellation tests without sleep-and-hope timing);
* :func:`slow_compile` — deterministic delay + accounting inflation at
  every compile-boundary charge (obs/compile.py), so cold-start and
  warmup tests run on the fake clock;
* :func:`device_oom` — a ``torch.cuda.OutOfMemoryError``, injected at
  an operator boundary or into ingest placement;
* :func:`device_loss` / :func:`sick_device` — device-SCOPED faults for
  the fault-domain serving tier (serve/devices.py): a permanent CUDA
  runtime error stream (a lost card) or a deterministic error-rate
  trickle (a flaky one), injected ONLY into the replica whose
  ``executing_device_index()`` matches — other replicas' operator
  streams never see them;
* :func:`failing_wcoj` — fail the multiway join's device path; the
  port does not answer it from the cascade (the fault propagates), so
  under the server the retry ladder contains it;
* :func:`abort_write` — abort a versioned-graph commit after N delta
  columns placed (the failure-atomicity probe: the commit must roll
  back completely and a retried write must succeed);
* :func:`flaky_compaction` — fail a deterministic fraction of
  compaction folds, scoped to the compaction thread only (serving
  and writes never see it);
* :func:`stale_cache` — forge a wrong-version result-cache entry
  (relational/result_cache.py) at the load seam, proving the
  snapshot-version check rejects it;
* :func:`flaky_ingest` — fail the next device column placements of an
  ingest (the string pool must roll back);
* :func:`stale_statistics` — a graph reports a scaled statistics sketch
  (the cost model's divergence → re-plan loop);
* :func:`slow_network` / :func:`drop_connection` — slow or drop fleet
  wire sends (serve/wire.py ``send_frame``);
* :func:`torn_wal` / :func:`failing_fsync` — tear a commit-log frame or
  fail its fsync (durability/wal.py ``_write_frame`` / ``_fsync``);
* :class:`FaultPlan` — compose any of the above into one context
  manager.

* :func:`shard_loss` / :func:`sick_shard` — kill or flake one member of
  a shard group (serve/shards.py), inside that group's brackets only;
* :func:`corrupt_shard` — silently damage the rows of one mesh shard at
  ingest (``DeviceBackend.place_column``).

All operator-level faults route through ONE locked patch point
(:class:`_OperatorPatch`): each operator class is monkey-patched at most
once, active hooks stack in installation order, nesting and concurrent
``with`` blocks from different threads are safe, and the original
``_compute`` is restored exactly when the last hook leaves.  Injection
counts land in the process-global MetricsRegistry under
``faults.injected.*`` so a soak run can assert how much damage was
actually dealt.

Exception freshness: injectors construct a NEW exception object per
injection (an instance argument is treated as a template and re-built
via ``type(exc)(*exc.args)``).  Two batch members hit by "the same"
fault must never share one mutable error object — the serving tier's
per-member isolation contract depends on it.
"""
from __future__ import annotations

import contextlib
import dataclasses
import warnings
from typing import Callable, Dict, List, Optional, Type, Union

import torch

from caps_tpu_torch.obs import clock
from caps_tpu_torch.obs.lockgraph import make_lock, make_rlock
from caps_tpu_torch.obs.metrics import global_registry


def make_oom(note: str = "") -> BaseException:
    """A fresh out-of-memory error in the shape the card's allocator
    raises it (serve/failure.py classifies it TRANSIENT)."""
    return torch.cuda.OutOfMemoryError(
        "CUDA out of memory. Tried to allocate 2.50 GiB. GPU 0 has a "
        "total capacity of 79.19 GiB of which 1.25 GiB is free."
        + (f" [{note}]" if note else ""))


def _resolve_operator(op_name: str) -> type:
    """Resolve ``"Filter"``/``"FilterOp"`` to its operator class.  Looks
    in relational/ops.py first, then the satellite operator modules
    (count_pattern's SpMV pushdown, var_expand, wcoj) — a fault aimed at
    ``"CountPattern"`` must hook the operator that actually executes
    when the planner pushes an aggregate down."""
    from caps_tpu_torch.relational import count_pattern as CP
    from caps_tpu_torch.relational import ops as R
    from caps_tpu_torch.relational import var_expand as VE
    from caps_tpu_torch.relational import wcoj as WJ
    cls_name = op_name if op_name.endswith("Op") else op_name + "Op"
    for mod in (R, CP, VE, WJ):
        cls = getattr(mod, cls_name, None)
        if isinstance(cls, type) and issubclass(cls, R.RelationalOperator):
            return cls
    raise ValueError(f"unknown relational operator {op_name!r}")


ExcSpec = Union[BaseException, Type[BaseException],
                Callable[[], BaseException], None]


def _fresh_exception(spec: ExcSpec) -> BaseException:
    """Build a NEW exception object from a spec (see module docstring)."""
    if spec is None:
        return make_oom()
    if isinstance(spec, BaseException):
        try:
            return type(spec)(*spec.args)
        except Exception:
            return type(spec)(str(spec))
    return spec()  # class or zero-arg factory


class _Budget:
    """Locked injection schedule shared across threads: fire on every
    ``every_n``-th eligible invocation (1 = every one), at most
    ``n_times`` total (None = unlimited — a permanent fault).

    ``every_n > 1`` is the deterministic "~1/N of executions fail once"
    shape the soak acceptance uses: an immediate retry is invocation
    k+1, never again on the every-N boundary, so a single-shot retry
    always heals — no luck involved."""

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


class _OperatorPatch:
    """The ONE patch point for relational-operator fault hooks.

    Each operator class's ``_compute`` is replaced (at most once, under
    the lock) by a dispatcher that runs the class's active hooks in
    installation order and then calls the original.  Hooks are plain
    callables ``hook(op_instance) -> None`` that may sleep or raise.
    When a class's last hook is removed its original ``_compute`` is
    restored — nothing stays patched after the outermost ``with``
    exits, however the contexts were nested or threaded."""

    def __init__(self):
        self._lock = make_rlock("faults._OperatorPatch._lock")
        self._originals: Dict[type, Callable] = {}
        self._hooks: Dict[type, List[Callable]] = {}

    def _dispatcher(self, cls: type) -> Callable:
        def _compute_with_hooks(op_self):
            with self._lock:
                hooks = list(self._hooks.get(cls, ()))
                orig = self._originals.get(cls)
            for hook in hooks:  # hooks run OUTSIDE the lock: they sleep
                hook(op_self)
            if orig is None:  # pragma: no cover — unpatch raced us; the
                return cls._compute(op_self)  # restored original is live
            return orig(op_self)
        return _compute_with_hooks

    @contextlib.contextmanager
    def hooked(self, cls: type, hook: Callable):
        with self._lock:
            if cls not in self._originals:
                # the class's own _compute if it defines one, else the
                # inherited one (restored verbatim either way)
                self._originals[cls] = cls.__dict__.get(
                    "_compute", cls._compute)
                cls._compute = self._dispatcher(cls)
            self._hooks.setdefault(cls, []).append(hook)
        try:
            yield
        finally:
            with self._lock:
                hooks = self._hooks.get(cls, [])
                if hook in hooks:
                    hooks.remove(hook)
                if not hooks:
                    self._hooks.pop(cls, None)
                    orig = self._originals.pop(cls, None)
                    if orig is not None:
                        cls._compute = orig


#: process-wide patch point (module-level: every FaultPlan and bare
#: context manager composes through the same locks)
OPERATOR_PATCH = _OperatorPatch()


def _count_injection(name: str) -> None:
    global_registry().counter(f"faults.injected.{name}").inc()


@contextlib.contextmanager
def _patched(owner, name: str, wrap: Callable[[Callable], Callable]):
    """The ONE install/restore path for the attribute faults: replaces
    ``owner.<name>`` with ``wrap(original)`` under the shared fault lock
    and restores the captured original on exit.  The owners: a
    backend's ``place_column`` (abort_write, flaky_compaction,
    flaky_ingest, device_oom at ingest), ``serve/wire.py send_frame``
    (the wire faults here and in testing/chaos.py: the backend's reply
    path and the client's request path both resolve it at call time),
    and ``durability/wal.py _write_frame`` / ``_fsync``.  Nesting is
    LIFO (each context captures whatever is installed when it enters,
    like the operator hooks)."""
    with OPERATOR_PATCH._lock:
        orig = getattr(owner, name)
        setattr(owner, name, wrap(orig))
    try:
        yield
    finally:
        with OPERATOR_PATCH._lock:
            setattr(owner, name, orig)


def _placement_backend(session, who: str):
    backend = getattr(session, "backend", None)
    if backend is None or not hasattr(backend, "place_column"):
        raise ValueError(f"{who} needs a device-backed session")
    return backend


@contextlib.contextmanager
def slow_operator(op_name: str, delay_s: float):
    """While active, every ``_compute`` of the named relational operator
    class (``"Filter"`` or ``"FilterOp"``) sleeps ``delay_s`` first —
    process-wide, so any session's queries slow down deterministically.

    The serving tests use this to force a deadline to expire INSIDE the
    execute phase: the delayed operator finishes (cancellation is
    cooperative — dispatched work is never torn down), and the next
    operator boundary's checkpoint raises ``DeadlineExceeded`` with
    ``phase="execute"``.  No test ever has to guess how long a real
    query takes."""
    cls = _resolve_operator(op_name)

    def hook(_op):
        _count_injection("slow_operator")
        clock.sleep(delay_s)

    with OPERATOR_PATCH.hooked(cls, hook):
        yield


@contextlib.contextmanager
def slow_compile(delay_s: float, n_times: Optional[int] = None,
                 kinds=None):
    """While active, compile-boundary charges are deterministically slow:
    every :class:`caps_tpu_torch.obs.compile.CompileLedger` charge (optionally
    filtered to ``kinds`` — e.g. ``("plan", "fused_record")``) sleeps
    ``delay_s`` through ``obs.clock`` and reports ``seconds + delay_s``,
    so on a fake clock a "35-second cold compile" costs zero real time
    and its ledger accounting is exactly assertable.

    The cold-start and warmup tests use this instead of relying on real
    first-run times: ``n_times=1`` makes
    only the FIRST boundary slow (the cliff a warmed process must not
    pay again), ``n_times=None`` slows every one.  Installed/restored
    under the shared fault lock like every other patch point; injections
    count ``faults.injected.slow_compile``.  Yields the budget
    (``.injected``)."""
    from caps_tpu_torch.obs.compile import CompileLedger
    budget = _Budget(n_times)
    want = None if kinds is None else frozenset(kinds)

    with OPERATOR_PATCH._lock:
        orig = CompileLedger.charge

        def slowed(self, family, kind, seconds, shape=None):
            if (want is None or kind in want) and budget.take():
                _count_injection("slow_compile")
                clock.sleep(delay_s)
                seconds = float(seconds) + delay_s
            return orig(self, family, kind, seconds, shape=shape)

        CompileLedger.charge = slowed
    try:
        yield budget
    finally:
        with OPERATOR_PATCH._lock:
            CompileLedger.charge = orig


class _ForgedCacheEntry:
    """A wrong-version result-cache entry (see :func:`stale_cache`):
    the version reads one AHEAD of the real entry's, and touching
    ``rows`` — which only a BROKEN version check would do — raises a
    fresh marked exception.  A correct lookup rejects the forgery on
    version alone and never trips the trap."""

    def __init__(self, real, exc_spec: ExcSpec):
        self._real = real
        self._exc_spec = exc_spec
        self.key = real.key
        self.version = real.version + 1
        self.nbytes = real.nbytes
        self.service_s = real.service_s
        self.hits = real.hits
        self.stored_t = real.stored_t
        self.last_t = real.last_t

    @property
    def rows(self):
        err = _fresh_exception(self._exc_spec)
        if getattr(err, "caps_stale_cache", None) is None:
            # first-writer-wins marker discipline (serve/failure.py):
            # never overwrite a classification already stamped
            try:
                err.caps_stale_cache = True
            except Exception:  # pragma: no cover — slotted exception
                pass
        raise err


@contextlib.contextmanager
def stale_cache(n_times: Optional[int] = 1, every_n: int = 1,
                exc: ExcSpec = None):
    """While active, eligible result-cache loads
    (:meth:`caps_tpu_torch.relational.result_cache.ResultCache._load`) return
    a FORGED entry whose snapshot version is wrong (one ahead of the
    real entry's) — the deterministic probe that the cache's version
    check actually rejects stale entries.

    A correct ``lookup`` sees the version mismatch, counts a
    ``rescache.stale_rejects``, drops the (real) entry, and reports a
    miss — the caller re-executes and repopulates; the forgery's
    ``rows`` are NEVER touched.  A broken check that served the forgery
    would raise a fresh ``AssertionError`` per injection (template
    overridable via ``exc``), marked ``caps_stale_cache`` first-writer-
    wins — so the failure is attributable even after the serving tier's
    classify/retry ladder wraps it.  Loads that find no entry inject
    nothing (there is nothing to forge).  Installed/restored under the
    shared fault lock; injections count ``faults.injected.stale_cache``.
    Yields the budget (``.injected``)."""
    from caps_tpu_torch.relational.result_cache import ResultCache
    if exc is None:
        exc = lambda: AssertionError(  # noqa: E731 — fresh per injection
            "injected: stale result-cache entry was served")
    budget = _Budget(n_times, every_n)

    with OPERATOR_PATCH._lock:
        orig = ResultCache._load

        def forging(self, key):
            entry = orig(self, key)
            if entry is not None and budget.take():
                _count_injection("stale_cache")
                return _ForgedCacheEntry(entry, exc)
            return entry

        ResultCache._load = forging
    try:
        yield budget
    finally:
        with OPERATOR_PATCH._lock:
            ResultCache._load = orig


@contextlib.contextmanager
def failing_operator(op_name: str, exc: ExcSpec = None,
                     n_times: Optional[int] = None, every_n: int = 1):
    """While active, the named operator's ``_compute`` raises before
    computing — a FRESH exception per injection, built from ``exc`` (an
    exception template, an exception class, a zero-arg factory, or None
    for a realistic device OOM).

    ``n_times`` bounds the total injections across all threads:
    ``n_times=1`` is the canonical transient fault (fails once, then
    heals — the retry path must succeed), ``n_times=None`` is a
    permanent fault (the circuit-breaker path must trip).  ``every_n``
    spaces injections out deterministically — ``every_n=5`` fails every
    5th execution, i.e. ~20% of requests fail exactly once and every
    single retry lands between boundaries and heals (the soak
    acceptance's fault shape).  Yields the budget object so tests can
    read ``.injected``."""
    cls = _resolve_operator(op_name)
    budget = _Budget(n_times, every_n)

    def hook(_op):
        if budget.take():
            _count_injection("failing_operator")
            raise _fresh_exception(exc)

    with OPERATOR_PATCH.hooked(cls, hook):
        yield budget


@contextlib.contextmanager
def failing_wcoj(exc: ExcSpec = None, n_times: Optional[int] = 1):
    """Fail the worst-case-optimal multiway join's DEVICE path
    (relational/wcoj.py ``MultiwayJoinOp._compute_wcoj``).  The port's
    operator does not answer a fault from its cascade (only an
    unsuitable input falls back — ROADMAP "Differences"), so the fault
    propagates; under the server the retry ladder contains it, and the
    request is answered by a later execution once the budget is spent.

    A FRESH exception per injection (``exc`` semantics as
    :func:`failing_operator`; default a realistic device OOM), stamped
    ``caps_wcoj_fault`` first-writer-wins at construction so assertions
    can attribute what they caught.  ``n_times=1`` fails exactly the
    next WCOJ execution then heals; ``n_times=None`` is permanent.
    Installed/restored on the shared fault
    lock like every other patch point; injections count
    ``faults.injected.wcoj``.  Yields the budget (``.injected``)."""
    from caps_tpu_torch.relational.wcoj import MultiwayJoinOp
    budget = _Budget(n_times)

    with OPERATOR_PATCH._lock:
        orig = MultiwayJoinOp._compute_wcoj

        def faulted(op_self):
            if budget.take():
                _count_injection("wcoj")
                e = _fresh_exception(exc)
                if getattr(e, "caps_wcoj_fault", None) is None:
                    e.caps_wcoj_fault = True
                raise e
            return orig(op_self)

        MultiwayJoinOp._compute_wcoj = faulted
    try:
        yield budget
    finally:
        with OPERATOR_PATCH._lock:
            MultiwayJoinOp._compute_wcoj = orig


@contextlib.contextmanager
def failing_algo(exc: ExcSpec = None, n_times: Optional[int] = 1):
    """Fail the graph-algorithm procedure's DEVICE fixpoint path
    (algo/op.py ``AlgoProcedureOp._compute_device``).  The port's
    operator does not answer a fault from its NumPy kernels (the host
    strategy is a plan decision only — ROADMAP "Differences"), so the
    fault propagates; under the server the retry ladder contains it,
    and the request is answered by a later execution once the budget
    is spent.

    A FRESH exception per injection (``exc`` semantics as
    :func:`failing_operator`; default a realistic device OOM), stamped
    ``caps_algo_fault`` first-writer-wins at construction so assertions
    can attribute what they caught.  ``n_times=1`` fails exactly the
    next device fixpoint then heals; ``n_times=None`` is permanent.
    Installed/restored on the shared fault lock like every other patch
    point; injections count ``faults.injected.algo``.  Yields the
    budget (``.injected``)."""
    from caps_tpu_torch.algo.op import AlgoProcedureOp
    budget = _Budget(n_times)

    with OPERATOR_PATCH._lock:
        orig = AlgoProcedureOp._compute_device

        def faulted(op_self, data, bound):
            if budget.take():
                _count_injection("algo")
                e = _fresh_exception(exc)
                if getattr(e, "caps_algo_fault", None) is None:
                    e.caps_algo_fault = True
                raise e
            return orig(op_self, data, bound)

        AlgoProcedureOp._compute_device = faulted
    try:
        yield budget
    finally:
        with OPERATOR_PATCH._lock:
            AlgoProcedureOp._compute_device = orig


def _make_device_down(device_index: int) -> BaseException:
    """A fresh CUDA runtime error in the shape a lost card raises it
    (``torch.AcceleratorError``: serve/failure.py classifies it
    TRANSIENT — the retry lands on a DIFFERENT replica — and
    ``device_fault`` counts it against this replica's health ladder)."""
    exc = torch.AcceleratorError(
        f"CUDA error: unspecified launch failure [injected device loss "
        f"on replica {device_index}]")
    exc.caps_device_fault = True
    return exc


@contextlib.contextmanager
def device_loss(device_index: int, n_times: Optional[int] = None,
                op_name: str = "Scan"):
    """Kill ONE device replica: while active, every ``_compute`` of the
    named operator (default ``Scan`` — every query plan scans) raises a
    fresh CUDA runtime error, but ONLY on the replica whose
    ``serve.devices.executing_device_index()`` matches ``device_index``
    — other replicas' operator streams are untouched, which is the
    fault-domain isolation the multi-device soak asserts.

    ``n_times=None`` (default) is a permanent loss: the device keeps
    failing — including its background reinstate probes — until the
    context exits, so the server must quarantine it and degrade to N-1
    devices.  ``n_times=K`` is a K-shot glitch (the probe after it
    heals the device).  Composable with :class:`FaultPlan`; yields the
    injection budget (``.injected``)."""
    cls = _resolve_operator(op_name)
    budget = _Budget(n_times)

    def hook(_op):
        from caps_tpu_torch.serve.devices import executing_device_index
        if executing_device_index() != device_index:
            return
        if budget.take():
            _count_injection("device_loss")
            raise _make_device_down(device_index)

    with OPERATOR_PATCH.hooked(cls, hook):
        yield budget


@contextlib.contextmanager
def sick_device(device_index: int, error_rate: float = 0.2,
                n_times: Optional[int] = None, op_name: str = "Scan"):
    """A flaky (not dead) device replica: a deterministic ~``error_rate``
    fraction of the named operator's executions ON THIS DEVICE fail once
    with a transient device error (every ``round(1/error_rate)``-th
    eligible invocation — the same deterministic spacing as
    ``failing_operator(every_n=)``, so a single retry on another device
    always heals).  Scoped by ``executing_device_index()`` like
    :func:`device_loss`; yields the injection budget."""
    if not 0.0 < error_rate <= 1.0:
        raise ValueError(f"error_rate must be in (0, 1], got {error_rate}")
    cls = _resolve_operator(op_name)
    budget = _Budget(n_times, every_n=max(1, int(round(1.0 / error_rate))))

    def hook(_op):
        from caps_tpu_torch.serve.devices import executing_device_index
        if executing_device_index() != device_index:
            return
        if budget.take():
            _count_injection("sick_device")
            raise _make_device_down(device_index)

    with OPERATOR_PATCH.hooked(cls, hook):
        yield budget


def _make_shard_down(group: str, member: Optional[int]) -> BaseException:
    """A fresh CUDA runtime error attributed to one shard-group member
    (serve/shards.py): ``caps_device_fault`` makes the group's ladder
    count it, ``caps_shard_member`` attributes the member so the MEMBER
    breaker (not the group's) climbs."""
    exc = torch.AcceleratorError(
        f"CUDA error: unspecified launch failure [injected shard loss: "
        f"member {member} of group {group!r}]")
    exc.caps_device_fault = True
    if member is not None:
        exc.caps_shard_member = member
    return exc


def _shard_scope_matches(group: str, member: Optional[int]) -> bool:
    """True when the calling thread is executing inside the targeted
    shard scope: the member's own bracket, or — because a dead device
    also breaks every group-wide (cross-shard) program that spans it —
    the group-wide bracket (member None)."""
    from caps_tpu_torch.serve.shards import executing_shard
    scope = executing_shard()
    if scope is None or scope[0] != group:
        return False
    if member is None:
        return True
    return scope[1] is None or scope[1] == member


@contextlib.contextmanager
def shard_loss(group: str, member: int, n_times: Optional[int] = None,
               op_name: str = "Scan"):
    """Kill ONE shard-group member: while active, every ``_compute`` of
    the named operator raises a fresh member-attributed device error —
    but ONLY inside executions of group ``group`` that touch member
    ``member``: the member's own single-shard stream, AND the group-wide
    cross-shard programs (which span the dead member).  Other groups,
    other members' single-shard streams and plain replicas never see
    it.

    ``n_times=None`` is a permanent loss (the group must degrade and
    keep serving its other shards); ``n_times=K`` is a K-shot glitch —
    the background rebuild's canary after it heals the member.  Yields
    the injection budget (``.injected``)."""
    cls = _resolve_operator(op_name)
    budget = _Budget(n_times)

    def hook(_op):
        if not _shard_scope_matches(group, member):
            return
        if budget.take():
            _count_injection("shard_loss")
            raise _make_shard_down(group, member)

    with OPERATOR_PATCH.hooked(cls, hook):
        yield budget


@contextlib.contextmanager
def sick_shard(group: str, member: Optional[int] = None,
               error_rate: float = 0.2, n_times: Optional[int] = None,
               op_name: str = "Scan"):
    """A flaky (not dead) shard scope: a deterministic ~``error_rate``
    fraction of the named operator's executions inside group ``group``
    (optionally narrowed to one ``member``) fail once with a transient
    member-attributed device error — the every-Nth spacing of
    ``sick_device``, so a single retry through the server's ladder
    always heals.  Yields the injection budget."""
    if not 0.0 < error_rate <= 1.0:
        raise ValueError(f"error_rate must be in (0, 1], got {error_rate}")
    cls = _resolve_operator(op_name)
    budget = _Budget(n_times, every_n=max(1, int(round(1.0 / error_rate))))

    def hook(_op):
        if not _shard_scope_matches(group, member):
            return
        if budget.take():
            _count_injection("sick_shard")
            from caps_tpu_torch.serve.shards import executing_shard
            scope = executing_shard()
            raise _make_shard_down(group, scope[1] if scope else member)

    with OPERATOR_PATCH.hooked(cls, hook):
        yield budget


@contextlib.contextmanager
def corrupt_shard(session, shard: int = 0, flip_bits: int = 1):
    """While active, every *data* buffer placed on the session's mesh
    gets ``flip_bits`` added to shard ``shard``'s resident block, and to
    no other block (validity masks are left intact — the corruption is
    silent, like real bit damage).  Only affects tables placed inside
    the ``with`` block.

    A column the injector CANNOT damage (placed whole: its row count
    does not divide over the shards; or a bool or non-numeric dtype
    where "+1" is not bit damage) is skipped with a warning, and if
    NOTHING was corrupted by the time the block exits the context
    raises — a fault test that injected no fault must fail loudly, not
    pass vacuously."""
    backend = _placement_backend(session, "corrupt_shard")
    if getattr(backend, "mesh", None) is None:
        raise ValueError("corrupt_shard needs a sharded session "
                         "(EngineConfig.mesh_shape)")
    n_shards = backend.mesh.size
    counts = {"corrupted": 0, "skipped": 0}

    def wrap(orig):
        def poisoned(col):
            n = col.data.shape[0]
            placed = orig(col)
            if isinstance(placed, list) and col.data.dtype != torch.bool:
                # the named shard's resident block, only
                block = placed[shard]
                placed = list(placed)
                placed[shard] = dataclasses.replace(
                    block, data=block.data + flip_bits)
                counts["corrupted"] += 1
                _count_injection("corrupt_shard")
            else:
                counts["skipped"] += 1
                reason = ("bool dtype" if col.data.dtype == torch.bool
                          else f"{n} rows not divisible by "
                               f"{n_shards} shards")
                warnings.warn(f"corrupt_shard skipped a column ({reason}) "
                              f"— this column was placed UNDAMAGED",
                              stacklevel=2)
            return placed
        return poisoned

    with _patched(backend, "place_column", wrap):
        yield counts
    # only reached on a CLEAN exit (an exception unwinding the body
    # propagates above and must not be masked by the vacuity check)
    if counts["corrupted"] == 0:
        raise RuntimeError(
            "corrupt_shard corrupted NOTHING "
            f"({counts['skipped']} column(s) skipped) — the fault "
            "test would pass vacuously; ingest a divisible-row, "
            "non-bool column inside the block")


@contextlib.contextmanager
def device_oom(phase: str = "execute", op_name: str = "Scan",
               session=None, n_times: Optional[int] = 1):
    """A device out-of-memory error (``torch.cuda.OutOfMemoryError``,
    classified TRANSIENT by serve/failure.py).

    ``phase="execute"`` raises from the named operator's compute (any
    query touching it); ``phase="ingest"`` raises from ``session``'s
    column placement (``DeviceBackend.place_column``) — ingest faults
    need the session whose backend is being damaged.  Yields the
    injection budget."""
    if phase == "execute":
        with failing_operator(op_name, make_oom, n_times=n_times) as budget:
            yield budget
        return
    if phase != "ingest":
        raise ValueError(f"device_oom phase must be 'execute' or "
                         f"'ingest', got {phase!r}")
    if session is None:
        raise ValueError("device_oom(phase='ingest') needs session=")
    backend = _placement_backend(session, "device_oom")
    budget = _Budget(n_times)

    def wrap(orig):
        def poisoned(col):
            if budget.take():
                _count_injection("device_oom")
                raise make_oom("injected at ingest")
            return orig(col)
        return poisoned

    with _patched(backend, "place_column", wrap):
        yield budget


def _make_write_abort() -> BaseException:
    """A fresh transient ``ABORTED`` error: retrying the write is safe
    precisely because the commit it interrupted rolled back."""
    exc = RuntimeError("ABORTED: transfer interrupted mid-commit "
                       "[injected write abort]")
    exc.caps_transient = True
    return exc


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

    with _patched(backend, "place_column", wrap):
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

    with _patched(backend, "place_column", wrap):
        yield budget


@contextlib.contextmanager
def flaky_ingest(session, n_times: Optional[int] = 1, exc: ExcSpec = None):
    """Fail the session's next ``n_times`` device column placements with
    a transient device error (default: the realistic OOM).  The engine's
    containment obligations under this fault: the ingest raises cleanly,
    and the string pool rolls back to its pre-ingest size so fused
    replayability is not silently invalidated (backends/cuda/table.py
    ``from_columns``).  Yields the injection budget."""
    backend = _placement_backend(session, "flaky_ingest")
    budget = _Budget(n_times)

    def wrap(orig):
        def poisoned(col):
            if budget.take():
                _count_injection("flaky_ingest")
                raise _fresh_exception(exc)
            return orig(col)
        return poisoned

    with _patched(backend, "place_column", wrap):
        yield budget


@contextlib.contextmanager
def stale_statistics(graph, scale: float = 0.001):
    """While active, ``graph`` reports a statistics sketch whose node
    and relationship cardinalities are scaled by ``scale`` — the
    deterministic stats-violating workload.  The cost model
    (relational/cost.py) prices plans from the distorted prior while
    executions observe the TRUE cardinalities, so ``opstats``
    divergence fires on real model error and the divergence →
    quarantine → re-plan loop can be asserted end-to-end.  Exiting
    restores the honest sketch.  Statistics are advisory by contract:
    results must stay exact throughout.

    Works on any graph exposing ``statistics()`` (ScanGraph,
    GraphSnapshot, VersionedGraph); raises for graphs without a sketch
    — a fault test that distorts nothing must fail loudly."""
    import dataclasses as _dc

    from caps_tpu_torch.relational.stats import GraphStatistics

    real = graph.statistics()
    if not isinstance(real, GraphStatistics) or not real.total_nodes:
        raise ValueError("stale_statistics needs a graph with a "
                         "non-empty statistics sketch")
    scale = float(scale)
    distorted = GraphStatistics(
        {combo: max(1, int(n * scale))
         for combo, n in real.node_combos.items()},
        {t: _dc.replace(r, rows=max(1, int(r.rows * scale)))
         for t, r in real.rels.items()},
        real.property_distinct, version=real.version)
    _count_injection("stale_statistics")
    # instance attribute shadows the class method; VersionedGraph
    # delegates to its current snapshot, so the shadow covers every
    # snapshot resolved while the fault is active
    graph.statistics = lambda: distorted
    try:
        yield distorted
    finally:
        del graph.statistics


@contextlib.contextmanager
def slow_network(delay_s: float, n_times: Optional[int] = None,
                 every_n: int = 1):
    """While active, fleet wire sends (``serve/wire.py send_frame``) are
    deterministically slow: each eligible send sleeps ``delay_s``
    through ``obs.clock`` before hitting the socket — on a fake clock a
    "congested fleet link" costs zero real time, and router latency /
    snapshot-lag assertions become exact.  Injections count
    ``faults.injected.slow_network``.  Yields the budget
    (``.injected``)."""
    budget = _Budget(n_times, every_n)

    def wrap(orig):
        def slowed(sock, obj):
            if budget.take():
                _count_injection("slow_network")
                clock.sleep(delay_s)
            return orig(sock, obj)
        return slowed

    from caps_tpu_torch.serve import wire
    with _patched(wire, "send_frame", wrap):
        yield budget


@contextlib.contextmanager
def drop_connection(exc: ExcSpec = None, n_times: Optional[int] = 1,
                    every_n: int = 1):
    """While active, eligible fleet wire sends fail with a FRESH
    connection-level error (default: ``ConnectionResetError``) instead
    of reaching the socket — the deterministic stand-in for a backend
    process dying mid-call.

    The injected OSError surfaces exactly as the real path would —
    wrapped into a transient :class:`~caps_tpu_torch.serve.errors.WireError`
    (what ``send_frame`` raises when ``sendall`` fails), counting a
    ``wire.drops`` — so the router's next steps (degrade the ring
    segment, retry on the next node) run without killing a real
    process.  Yields the budget (``.injected``); injections count
    ``faults.injected.drop_connection``."""
    from caps_tpu_torch.serve.errors import ServeError, WireError
    if exc is None:
        exc = ConnectionResetError("injected: connection dropped")
    budget = _Budget(n_times, every_n)

    def wrap(orig):
        def dropping(sock, obj):
            if budget.take():
                _count_injection("drop_connection")
                err = _fresh_exception(exc)
                if isinstance(err, ServeError):
                    raise err
                # the patch point sits where send_frame's own OSError
                # conversion lives — surface the same typed shape
                global_registry().counter("wire.drops").inc()
                raise WireError(
                    f"send failed: {type(err).__name__}: {err}")
            return orig(sock, obj)
        return dropping

    from caps_tpu_torch.serve import wire
    with _patched(wire, "send_frame", wrap):
        yield budget


@contextlib.contextmanager
def torn_wal(n_bytes: int = 6, n_times: Optional[int] = 1):
    """While active, the next ``n_times`` commit-log frame writes TEAR:
    only the first ``n_bytes`` bytes of the frame reach the file (then
    a flush, then a fresh ``caps_wal_fault``-marked RuntimeError) — the
    on-disk image a SIGKILL mid-write leaves.  Deliberately NOT an
    OSError: ``CommitLog.append``'s OSError path truncates the partial
    frame away, and this injector proves RECOVERY drops a torn tail, so
    the torn bytes must survive on disk.  Patches the
    ``durability/wal.py`` module attribute under the shared fault lock;
    injections count ``faults.injected.torn_wal``.  Yields the
    budget."""
    from caps_tpu_torch.durability import wal
    budget = _Budget(n_times)

    def wrap(orig):
        def tearing(f, body):
            if budget.take():
                _count_injection("torn_wal")
                frame = wal.frame_bytes(body)
                f.write(frame[:max(0, int(n_bytes))])
                f.flush()
                ex = RuntimeError(
                    f"injected torn WAL write ({n_bytes} of "
                    f"{len(frame)} bytes reached disk)")
                ex.caps_wal_fault = True
                raise ex
            return orig(f, body)
        return tearing

    with _patched(wal, "_write_frame", wrap):
        yield budget


@contextlib.contextmanager
def failing_fsync(n_times: Optional[int] = 1):
    """While active, the next ``n_times`` commit-log fsyncs fail with a
    fresh ``caps_wal_fault``-marked OSError.  The commit must abort
    with a typed TRANSIENT
    :class:`~caps_tpu_torch.serve.errors.WalWriteError` — never a silent
    acknowledgement — with the graph unchanged, and a retried write
    must succeed once the disk heals.  Patches the ``durability/wal.py``
    module attribute under the shared fault lock; injections count
    ``faults.injected.failing_fsync``.  Yields the budget."""
    from caps_tpu_torch.durability import wal
    budget = _Budget(n_times)

    def wrap(orig):
        def failing(f):
            if budget.take():
                _count_injection("failing_fsync")
                ex = OSError("injected fsync failure")
                ex.caps_wal_fault = True
                raise ex
            return orig(f)
        return failing

    with _patched(wal, "_fsync", wrap):
        yield budget


class FaultPlan:
    """Compose several faults into one context manager.

    >>> plan = FaultPlan(slow_operator("Filter", 0.01),
    ...                  failing_operator("Scan", n_times=1))
    >>> with plan:
    ...     ...  # both faults active, LIFO-unwound on exit

    ``add()`` appends before (not during) activation; plans nest freely
    with each other and with bare fault context managers — every
    operator hook goes through the same locked patch point."""

    def __init__(self, *faults):
        self._faults = list(faults)
        self._stack: Optional[contextlib.ExitStack] = None

    def add(self, fault) -> "FaultPlan":
        if self._stack is not None:
            raise RuntimeError("FaultPlan is active; build a nested "
                               "FaultPlan instead")
        self._faults.append(fault)
        return self

    def __enter__(self) -> "FaultPlan":
        if self._stack is not None:
            raise RuntimeError("FaultPlan is not re-entrant")
        stack = contextlib.ExitStack()
        try:
            for fault in self._faults:
                stack.enter_context(fault)
        except BaseException:
            stack.close()
            raise
        self._stack = stack
        return self

    def __exit__(self, *exc) -> bool:
        stack, self._stack = self._stack, None
        return stack.__exit__(*exc)
