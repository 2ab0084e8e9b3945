"""capslint ``lock-order``: the static lock-acquisition graph.

The serving tier's thread safety and its device fault domains grew the
lock population across ``serve/``, ``obs/``, ``relational/``, ``okapi/`` and
``testing/faults.py``; nothing machine-checked that those locks are
always taken in one global order.  This pass:

1. collects every lock **definition** — ``threading.Lock/RLock/
   Condition()`` creations, ``caps_tpu_torch.obs.lockgraph.make_lock/
   make_rlock/make_condition(...)`` creations, dataclass fields
   annotated as locks, and calls to same-module helpers whose return
   annotation is a lock type — normalized to the node ids the runtime
   lock graph uses (``<module>.<Class>.<attr>`` / ``<module>.<name>``);
2. builds **acquisition edges** from ``with <lock>:`` nesting inside
   each function, plus one level of same-module / same-class call
   resolution (holding A while calling a neighbour that takes B is an
   A->B edge).  A foreign-attribute acquisition whose name is defined
   as a lock on several classes (``member.lock`` behind the serve
   tier's duck-typed replica/shard-group seam) resolves to EVERY
   candidate — bounded may-alias, each alias keeps its edges, no edge
   is fabricated between aliases of the one runtime lock;
3. reports every **cycle** as a potential deadlock, and every lock
   acquired in a ``__del__`` or an ``atexit.register``-ed function
   (finalizer-time acquisition deadlocks interpreter shutdown).

The runtime complement (``caps_tpu_torch/obs/lockgraph.py``) records the same
graph from live threads under ``CAPS_TPU_LOCK_GRAPH=1``; the device-loss
soak asserts the two agree (acyclic, serve-tier edges observed).
"""
from __future__ import annotations

import ast
from typing import Dict, List, Optional, Set, Tuple

from caps_tpu_torch.analysis.core import (Finding, Project, Source,
                                    analysis_pass, dotted, terminal_name,
                                    walk_functions)

PASS = "lock-order"

_LOCK_TYPES = frozenset({"Lock", "RLock", "Condition"})
_LOCK_MAKERS = frozenset({"make_lock", "make_rlock", "make_condition"})


def _lock_helper_names(tree: ast.AST) -> Set[str]:
    """Module functions whose return annotation is a lock type (e.g.
    ``def _session_exec_lock(session) -> threading.Lock``): calls to
    them create/fetch locks."""
    out: Set[str] = set()
    for qual, fn, _cls in walk_functions(tree):
        if fn.returns is not None and \
                terminal_name(fn.returns) in _LOCK_TYPES and "." not in qual:
            out.add(fn.name)
    return out


def _is_lock_creator(node: ast.AST, helpers: Set[str]) -> bool:
    if not isinstance(node, ast.Call):
        return False
    name = terminal_name(node.func)
    if name in _LOCK_TYPES or name in _LOCK_MAKERS:
        return True
    return isinstance(node.func, ast.Name) and node.func.id in helpers


def _node_prefixes(sources: List[Source]) -> Dict[str, str]:
    """rel path -> node-id prefix: the short module basename when it is
    unique across the analyzed set, else the dotted path minus the
    package dir — two ``__init__.py`` (or a future serve/session.py
    next to relational/session.py) must never merge into one node."""
    counts: Dict[str, int] = {}
    for s in sources:
        counts[s.modname] = counts.get(s.modname, 0) + 1
    out: Dict[str, str] = {}
    for s in sources:
        if counts[s.modname] == 1:
            out[s.rel] = s.modname
        else:
            out[s.rel] = ".".join(s.module.split(".")[1:]) or s.module
    return out


class _LockIndex:
    """Lock definitions across the configured dirs.

    Keys are (rel path, ...) — unique per file; node ids come from
    :func:`_node_prefixes`.  ``attr_map``: attr -> {ids} for resolving
    ``other.attr`` acquisitions by attribute name."""

    def __init__(self) -> None:
        self.ids: Set[str] = set()
        self.module_level: Dict[Tuple[str, str], str] = {}
        self.class_attrs: Dict[Tuple[str, str, str], str] = {}
        self.attr_map: Dict[str, Set[str]] = {}
        self.def_sites: Dict[str, Tuple[str, int]] = {}

    def add_module(self, src: Source, prefix: str, var: str,
                   lineno: int) -> None:
        lid = f"{prefix}.{var}"
        self.ids.add(lid)
        self.module_level[(src.rel, var)] = lid
        self.def_sites.setdefault(lid, (src.rel, lineno))

    def add_attr(self, src: Source, prefix: str, cls: str, attr: str,
                 lineno: int) -> None:
        lid = f"{prefix}.{cls}.{attr}"
        self.ids.add(lid)
        self.class_attrs[(src.rel, cls, attr)] = lid
        self.attr_map.setdefault(attr, set()).add(lid)
        self.def_sites.setdefault(lid, (src.rel, lineno))


def collect_locks(project: Project) -> _LockIndex:
    index = _LockIndex()
    sources = project.sources_under(*project.config.lock_dirs)
    prefixes = _node_prefixes(sources)
    for src in sources:
        prefix = prefixes[src.rel]
        helpers = _lock_helper_names(src.tree)
        # module-level definitions
        for node in src.tree.body:
            if isinstance(node, ast.Assign) and \
                    _is_lock_creator(node.value, helpers):
                for tgt in node.targets:
                    if isinstance(tgt, ast.Name):
                        index.add_module(src, prefix, tgt.id, node.lineno)
            elif isinstance(node, ast.AnnAssign) and node.value is not None \
                    and _is_lock_creator(node.value, helpers) \
                    and isinstance(node.target, ast.Name):
                index.add_module(src, prefix, node.target.id, node.lineno)
        # class attributes: self.X = <creator> in any method, plus
        # annotated dataclass fields ``X: threading.Lock = field(...)``
        for qual, fn, cls in walk_functions(src.tree):
            if cls is None:
                continue
            for node in ast.walk(fn):
                if isinstance(node, ast.Assign) and \
                        _is_lock_creator(node.value, helpers):
                    for tgt in node.targets:
                        if isinstance(tgt, ast.Attribute) and \
                                isinstance(tgt.value, ast.Name) and \
                                tgt.value.id == "self":
                            index.add_attr(src, prefix, cls.name,
                                           tgt.attr, node.lineno)
        for node in ast.walk(src.tree):
            if isinstance(node, ast.ClassDef):
                for stmt in node.body:
                    if isinstance(stmt, ast.AnnAssign) and \
                            isinstance(stmt.target, ast.Name) and \
                            terminal_name(stmt.annotation) in _LOCK_TYPES:
                        index.add_attr(src, prefix, node.name,
                                       stmt.target.id, stmt.lineno)
    return index


#: foreign-attribute may-alias bound: an attribute name defined as a
#: lock on more than this many classes is too generic to resolve
#: (e.g. ``x._lock``) — edges through it would be mostly noise
_MAY_ALIAS_CAP = 3


def _resolve_locks(expr: ast.AST, src: Source, cls_name: Optional[str],
                   index: _LockIndex) -> Tuple[str, ...]:
    """The lock ids a ``with`` item / expression may refer to (usually
    exactly one; empty = not a tracked lock).  ``self.X`` and
    module-level names resolve precisely.  A foreign attribute
    (``replica.lock``) resolves to EVERY class defining that attribute
    as a lock, up to :data:`_MAY_ALIAS_CAP` — duck-typed execution
    seams (a ShardGroup standing in for a DeviceReplica behind one call
    site) genuinely may-alias, and dropping the acquisition would
    silently erase the serve tier's real nesting edges."""
    if isinstance(expr, ast.Name):
        lid = index.module_level.get((src.rel, expr.id))
        return (lid,) if lid is not None else ()
    if isinstance(expr, ast.Attribute):
        attr = expr.attr
        if isinstance(expr.value, ast.Name) and expr.value.id == "self" \
                and cls_name is not None:
            lid = index.class_attrs.get((src.rel, cls_name, attr))
            if lid is not None:
                return (lid,)
        cands = index.attr_map.get(attr, ())
        if 0 < len(cands) <= _MAY_ALIAS_CAP:
            return tuple(sorted(cands))
    return ()


class _FnLockInfo:
    __slots__ = ("acquisitions", "calls_under")

    def __init__(self) -> None:
        #: (lock id, lineno) acquired directly by a ``with`` in this fn
        self.acquisitions: List[Tuple[str, int]] = []
        #: (held lock ids, callee key, lineno) — calls made while >= 1
        #: lock is held, for one-level resolution
        self.calls_under: List[Tuple[Tuple[str, ...], Tuple[str, str],
                                     int]] = []


def _callee_key(call: ast.Call, src: Source,
                cls_name: Optional[str]) -> Optional[Tuple[str, str]]:
    """(rel path, qualname) of a same-module / same-class callee, or
    ``("*", method)`` for an attribute call on another object — resolved
    later iff exactly one analyzed class defines a lock-acquiring method
    of that name (``req._shed.inc()`` -> ``metrics.Counter.inc``)."""
    fnc = call.func
    if isinstance(fnc, ast.Name):
        return (src.rel, fnc.id)
    if isinstance(fnc, ast.Attribute):
        if isinstance(fnc.value, ast.Name) and fnc.value.id == "self" \
                and cls_name is not None:
            return (src.rel, f"{cls_name}.{fnc.attr}")
        return ("*", fnc.attr)
    return None


def _scan_function(fn: ast.AST, src: Source, cls_name: Optional[str],
                   index: _LockIndex,
                   edges: Dict[Tuple[str, str], Tuple[str, int]]
                   ) -> _FnLockInfo:
    info = _FnLockInfo()
    held: List[str] = []

    def visit(node: ast.AST) -> None:
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef,
                             ast.ClassDef)):
            return  # nested defs run later, under their own held set
        if isinstance(node, (ast.With, ast.AsyncWith)):
            acquired: List[str] = []
            for item in node.items:
                lids = _resolve_locks(item.context_expr, src,
                                      cls_name, index)
                # edges only from locks held BEFORE this item: the lids
                # of one item are may-aliases of ONE runtime lock, and
                # an edge between aliases would be a fabricated order
                prior = list(dict.fromkeys(held))
                for lid in lids:
                    for h in prior:
                        if h != lid:
                            edges.setdefault((h, lid),
                                             (src.rel, node.lineno))
                    info.acquisitions.append((lid, node.lineno))
                    held.append(lid)
                    acquired.append(lid)
            for stmt in node.body:
                visit(stmt)
            for _ in acquired:
                held.pop()
            return
        if isinstance(node, ast.Call) and held:
            key = _callee_key(node, src, cls_name)
            if key is not None:
                info.calls_under.append(
                    (tuple(dict.fromkeys(held)), key, node.lineno))
        for child in ast.iter_child_nodes(node):
            visit(child)

    for stmt in getattr(fn, "body", ()):
        visit(stmt)
    return info


def static_lock_graph(project: Project
                      ) -> Tuple[Dict[Tuple[str, str], Tuple[str, int]],
                                 _LockIndex,
                                 Dict[Tuple[str, str], _FnLockInfo]]:
    """(edges, lock index, per-function info).  Edge values are an
    example (path, line) where the ordering was observed."""
    index = collect_locks(project)
    edges: Dict[Tuple[str, str], Tuple[str, int]] = {}
    fn_info: Dict[Tuple[str, str], _FnLockInfo] = {}
    for src in project.sources_under(*project.config.lock_dirs):
        for qual, fn, cls in walk_functions(src.tree):
            cls_name = cls.name if cls is not None else None
            fn_info[(src.rel, qual)] = _scan_function(
                fn, src, cls_name, index, edges)
    # ("*", method) fallback table: methods that DIRECTLY acquire a
    # lock, by simple name — used only when the name is unambiguous
    # across every analyzed module
    acquiring_by_simple: Dict[str, List[Tuple[str, str]]] = {}
    for key, info in fn_info.items():
        if info.acquisitions and "." in key[1]:
            simple = key[1].rsplit(".", 1)[-1]
            acquiring_by_simple.setdefault(simple, []).append(key)
    # one level of call resolution: holding H while calling a neighbour
    # that directly acquires L is an H -> L edge
    for (caller_rel, _qual), info in fn_info.items():
        for held, callee, lineno in info.calls_under:
            if callee[0] == "*":
                cands = acquiring_by_simple.get(callee[1], ())
                target = fn_info[cands[0]] if len(cands) == 1 else None
            else:
                target = fn_info.get(callee)
                if target is None and "." in callee[1]:
                    # self.method falling back to a module-level function
                    # of the same name (decorator-wrapped helpers)
                    target = fn_info.get((callee[0],
                                          callee[1].split(".", 1)[1]))
            if target is None:
                continue
            for acq, _ln in target.acquisitions:
                for h in held:
                    if h != acq and (h, acq) not in edges:
                        edges[(h, acq)] = (caller_rel, lineno)
    return edges, index, fn_info


def _cycles(edges) -> List[List[str]]:
    """Elementary cycles via Tarjan SCCs (each SCC with > 1 node, or a
    self-loop, reported once as a representative node loop)."""
    adj: Dict[str, List[str]] = {}
    for a, b in edges:
        adj.setdefault(a, []).append(b)
        adj.setdefault(b, [])
    index_counter = [0]
    stack: List[str] = []
    lowlink: Dict[str, int] = {}
    num: Dict[str, int] = {}
    on_stack: Dict[str, bool] = {}
    out: List[List[str]] = []

    def strongconnect(v: str) -> None:
        work = [(v, 0)]
        while work:
            node, pi = work.pop()
            if pi == 0:
                num[node] = lowlink[node] = index_counter[0]
                index_counter[0] += 1
                stack.append(node)
                on_stack[node] = True
            recursed = False
            neighbours = adj.get(node, [])
            for i in range(pi, len(neighbours)):
                w = neighbours[i]
                if w not in num:
                    work.append((node, i + 1))
                    work.append((w, 0))
                    recursed = True
                    break
                if on_stack.get(w):
                    lowlink[node] = min(lowlink[node], num[w])
            if recursed:
                continue
            if lowlink[node] == num[node]:
                scc = []
                while True:
                    w = stack.pop()
                    on_stack[w] = False
                    scc.append(w)
                    if w == node:
                        break
                if len(scc) > 1 or (node, node) in edges:
                    out.append(sorted(scc))
            if work:
                parent = work[-1][0]
                lowlink[parent] = min(lowlink[parent], lowlink[node])
    for v in sorted(adj):
        if v not in num:
            strongconnect(v)
    return out


@analysis_pass(PASS, "lock-acquisition graph: cycles (potential "
                     "deadlocks) and locks taken in __del__/atexit paths")
def check(project: Project) -> List[Finding]:
    edges, index, fn_info = static_lock_graph(project)
    findings: List[Finding] = []
    for scc in _cycles(edges):
        in_cycle = [(a, b) for (a, b) in sorted(edges)
                    if a in scc and b in scc]
        rel, line = edges[in_cycle[0]]
        sites = "; ".join(
            f"{a} -> {b} at {edges[(a, b)][0]}:{edges[(a, b)][1]}"
            for a, b in in_cycle[:4])
        findings.append(Finding(
            rel, line, PASS,
            f"lock-order cycle (potential deadlock) among "
            f"{{{', '.join(scc)}}}: {sites}"))
    # finalizer-time acquisition: __del__ and atexit-registered functions
    for src in project.sources_under(*project.config.lock_dirs):
        for qual, fn, cls in walk_functions(src.tree):
            if fn.name != "__del__":
                continue
            info = fn_info.get((src.rel, qual))
            if info is not None and info.acquisitions:
                lid, line = info.acquisitions[0]
                findings.append(Finding(
                    src.rel, line, PASS,
                    f"{lid} acquired inside __del__ — finalizers run at "
                    f"arbitrary points (GC, interpreter shutdown) and "
                    f"deadlock against live holders"))
        for node in ast.walk(src.tree):
            if isinstance(node, ast.Call) and \
                    dotted(node.func) in ("atexit.register",) and \
                    node.args and isinstance(node.args[0], ast.Name):
                target = fn_info.get((src.rel, node.args[0].id))
                if target is not None and target.acquisitions:
                    findings.append(Finding(
                        src.rel, node.lineno, PASS,
                        f"atexit-registered {node.args[0].id!r} acquires "
                        f"{target.acquisitions[0][0]} — shutdown-time "
                        f"lock acquisition can deadlock teardown"))
    return findings
