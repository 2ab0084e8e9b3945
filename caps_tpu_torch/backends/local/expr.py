"""Expression evaluator for the local oracle backend.

The analog of the reference's ``SparkSQLExprMapper`` (ref:
spark-cypher/.../impl/SparkSQLExprMapper.scala — reconstructed, mount
empty; SURVEY.md §2): compiles okapi ``Expr`` trees against a RecordHeader,
here by direct columnar interpretation with 3-valued null logic.
"""
from __future__ import annotations

import math
import re
from typing import Any, Callable, Dict, List, Mapping, Optional, Tuple

from caps_tpu_torch.ir import exprs as E
from caps_tpu_torch.okapi.types import _CTList, _CTNode, _CTRelationship
from caps_tpu_torch.okapi.values import (
    CypherDate, CypherDateTime, CypherDuration, cypher_equals, cypher_lt,
    is_temporal, temporal_component, temporal_construct,
)
from caps_tpu_torch.relational.header import RecordHeader
from caps_tpu_torch.relational.table import ExprEvalError  # noqa: F401

GetCol = Callable[[str], List[Any]]




def evaluate(expr: E.Expr, n_rows: int, getcol: GetCol, header: RecordHeader,
             params: Mapping[str, Any]) -> List[Any]:
    """Evaluate ``expr`` to a column of ``n_rows`` Python values."""
    ev = _Evaluator(n_rows, getcol, header, params)
    return ev.eval(expr)


def _kind_of_type(t) -> Optional[str]:
    m = t.material
    if isinstance(m, _CTNode):
        return "node"
    if isinstance(m, _CTRelationship):
        return "rel"
    return None


def _kind_at(kinds, idx: int) -> Optional[str]:
    """Entity kind for list position ``idx`` given a uniform kind or a
    per-position kind list (see _Evaluator._elem_kind)."""
    if isinstance(kinds, list):
        return kinds[idx] if idx < len(kinds) else None
    return kinds


class _Evaluator:
    def __init__(self, n: int, getcol: GetCol, header: RecordHeader,
                 params: Mapping[str, Any], entity_ctx=None):
        self.n = n
        self.getcol = getcol
        self.header = header
        self.params = dict(params)
        # host-side entity rehydration (relational/ops.py EntityContext),
        # threaded via the reserved parameter key
        from caps_tpu_torch.relational.ops import ENTITY_CTX_PARAM
        self.entity_ctx = self.params.pop(ENTITY_CTX_PARAM, entity_ctx)

    def const(self, v: Any) -> List[Any]:
        return [v] * self.n

    def eval(self, e: E.Expr) -> List[Any]:  # noqa: C901
        if self.header.has(e):
            return list(self.getcol(self.header.column(e)))

        if isinstance(e, E.Lit):
            return self.const(e.value)
        if isinstance(e, E.Param):
            if e.name not in self.params:
                raise ExprEvalError(f"missing parameter ${e.name}")
            return self.const(self.params[e.name])
        if isinstance(e, E.ListLit):
            cols = [self.eval(i) for i in e.items]
            return [[c[i] for c in cols] for i in range(self.n)]
        if isinstance(e, E.MapLit):
            cols = [self.eval(v) for v in e.values]
            return [{k: c[i] for k, c in zip(e.keys, cols)}
                    for i in range(self.n)]

        if isinstance(e, E.Id):
            return self.eval(e.entity)  # entities evaluate to their id
        if isinstance(e, E.Labels):
            if isinstance(e.node, E.Var):
                pairs = []
                for he in self.header.exprs:
                    if isinstance(he, E.HasLabel) and he.node == e.node:
                        pairs.append((he.label, self.getcol(self.header.column(he))))
                pairs.sort(key=lambda p: p[0])
                ids = self.eval(e.node)
                return [None if ids[i] is None else
                        [lbl for lbl, col in pairs if col[i] is True]
                        for i in range(self.n)]
            raise ExprEvalError(f"labels() on non-variable {e.node!r}")
        if isinstance(e, E.Keys) or isinstance(e, E.Properties):
            ent = e.entity
            if isinstance(ent, E.Var):
                props: Dict[str, List[Any]] = {}
                for he in self.header.exprs:
                    if isinstance(he, E.Property) and he.entity == ent:
                        props[he.key] = self.getcol(self.header.column(he))
                ids = self.eval(ent)
                if isinstance(e, E.Keys):
                    return [None if ids[i] is None else
                            sorted(k for k, col in props.items()
                                   if col[i] is not None)
                            for i in range(self.n)]
                return [None if ids[i] is None else
                        {k: col[i] for k, col in props.items()
                         if col[i] is not None}
                        for i in range(self.n)]
            raise ExprEvalError(f"keys()/properties() on {ent!r}")
        if isinstance(e, E.Property):
            # property of a map value (header-resident entity props were
            # handled by the header lookup above) or a temporal component
            base = self.eval(e.entity)
            return [None if m is None
                    else (m.get(e.key) if isinstance(m, dict)
                          else temporal_component(m, e.key) if is_temporal(m)
                          else None)
                    for m in base]
        if isinstance(e, E.HasLabel):
            raise ExprEvalError(f"{e!r} not in header (unknown label column)")

        # -- boolean 3VL ----------------------------------------------------
        if isinstance(e, E.Ands):
            cols = [self.eval(x) for x in e.exprs]
            out = []
            for i in range(self.n):
                vals = [c[i] for c in cols]
                if any(v is False for v in vals):
                    out.append(False)
                elif any(v is None for v in vals):
                    out.append(None)
                else:
                    out.append(True)
            return out
        if isinstance(e, E.Ors):
            cols = [self.eval(x) for x in e.exprs]
            out = []
            for i in range(self.n):
                vals = [c[i] for c in cols]
                if any(v is True for v in vals):
                    out.append(True)
                elif any(v is None for v in vals):
                    out.append(None)
                else:
                    out.append(False)
            return out
        if isinstance(e, E.Xor):
            l, r = self.eval(e.lhs), self.eval(e.rhs)
            return [None if a is None or b is None else bool(a) != bool(b)
                    for a, b in zip(l, r)]
        if isinstance(e, E.Not):
            c = self.eval(e.expr)
            return [None if v is None else not v for v in c]
        if isinstance(e, E.IsNull):
            return [v is None for v in self.eval(e.expr)]
        if isinstance(e, E.IsNotNull):
            return [v is not None for v in self.eval(e.expr)]

        # -- comparisons ----------------------------------------------------
        if isinstance(e, E.Equals):
            l, r = self.eval(e.lhs), self.eval(e.rhs)
            return [cypher_equals(a, b) for a, b in zip(l, r)]
        if isinstance(e, E.NotEquals):
            l, r = self.eval(e.lhs), self.eval(e.rhs)
            return [None if (v := cypher_equals(a, b)) is None else not v
                    for a, b in zip(l, r)]
        if isinstance(e, E.LessThan):
            return self._cmp(e, lambda a, b: cypher_lt(a, b))
        if isinstance(e, E.LessThanOrEqual):
            return self._cmp(e, _lte)
        if isinstance(e, E.GreaterThan):
            return self._cmp(e, lambda a, b: cypher_lt(b, a))
        if isinstance(e, E.GreaterThanOrEqual):
            return self._cmp(e, lambda a, b: _lte(b, a))
        if isinstance(e, E.In):
            l, r = self.eval(e.lhs), self.eval(e.rhs)
            out = []
            for a, lst in zip(l, r):
                if lst is None:
                    out.append(None)
                    continue
                found = False
                has_null = False
                for item in lst:
                    eq = cypher_equals(a, item)
                    if eq is True:
                        found = True
                        break
                    if eq is None:
                        has_null = True
                out.append(True if found else (None if has_null or
                                               (a is None and len(lst) > 0) else False))
            return out
        if isinstance(e, E.Disjoint):
            l, r = self.eval(e.lhs), self.eval(e.rhs)
            return [None if a is None or b is None
                    else not (set(a) & set(b))
                    for a, b in zip(l, r)]
        if isinstance(e, E.StartsWith):
            return self._strpred(e, lambda a, b: a.startswith(b))
        if isinstance(e, E.EndsWith):
            return self._strpred(e, lambda a, b: a.endswith(b))
        if isinstance(e, E.Contains):
            return self._strpred(e, lambda a, b: b in a)
        if isinstance(e, E.RegexMatch):
            return self._strpred(e, lambda a, b: re.fullmatch(b, a) is not None)

        # -- arithmetic -----------------------------------------------------
        if isinstance(e, (E.Add, E.Subtract, E.Multiply, E.Divide, E.Modulo,
                          E.Power)):
            return self._arith(e)
        if isinstance(e, E.Negate):
            return [None if v is None else -v for v in self.eval(e.expr)]

        # -- containers -----------------------------------------------------
        if isinstance(e, E.Index):
            base, idx = self.eval(e.expr), self.eval(e.idx)
            out = []
            for b, i in zip(base, idx):
                if b is None or i is None:
                    out.append(None)
                elif isinstance(b, dict):
                    out.append(b.get(i))
                elif isinstance(b, (list, tuple)):
                    ii = int(i)
                    out.append(b[ii] if -len(b) <= ii < len(b) else None)
                else:
                    out.append(None)
            return out
        if isinstance(e, E.Slice):
            base = self.eval(e.expr)
            lo = self.eval(e.lower) if e.lower is not None else self.const(None)
            hi = self.eval(e.upper) if e.upper is not None else self.const(None)
            out = []
            for b, l, h in zip(base, lo, hi):
                if b is None:
                    out.append(None)
                else:
                    out.append(list(b[(l if l is not None else 0):
                                      (h if h is not None else len(b))]))
            return out
        if isinstance(e, E.ListComprehension):
            lists = self.eval(e.list_expr)
            kind = self._elem_kind(e.list_expr)
            out = []
            for i, lst in enumerate(lists):
                if lst is None:
                    out.append(None)
                    continue
                row_getcol = _row_slice(self.getcol, i)
                acc = []
                for idx, item in enumerate(lst):
                    sub = self._bind(row_getcol, e.var, item,
                                     _kind_at(kind, idx))
                    if e.predicate is not None \
                            and sub.eval(e.predicate)[0] is not True:
                        continue
                    acc.append(sub.eval(e.projection)[0]
                               if e.projection is not None else item)
                out.append(acc)
            return out
        if isinstance(e, E.QuantifiedPredicate):
            lists = self.eval(e.list_expr)
            kind = self._elem_kind(e.list_expr)
            out = []
            for i, lst in enumerate(lists):
                if lst is None:
                    out.append(None)
                    continue
                row_getcol = _row_slice(self.getcol, i)
                verdicts = [
                    self._bind(row_getcol, e.var, item, _kind_at(kind, idx))
                    .eval(e.predicate)[0] for idx, item in enumerate(lst)]
                out.append(_quantify(e.kind, verdicts))
            return out
        if isinstance(e, E.Reduce):
            lists = self.eval(e.list_expr)
            inits = self.eval(e.init)
            kind = self._elem_kind(e.list_expr)
            out = []
            for i, lst in enumerate(lists):
                if lst is None:
                    out.append(None)
                    continue
                row_getcol = _row_slice(self.getcol, i)
                acc_v = inits[i]
                for idx, item in enumerate(lst):
                    sub = self._bind(row_getcol, e.var, item,
                                     _kind_at(kind, idx),
                                     extra2=(e.acc, acc_v))
                    acc_v = sub.eval(e.expr)[0]
                out.append(acc_v)
            return out
        if isinstance(e, E.PathNodes):
            return self._path_nodes(e)

        if isinstance(e, E.CaseExpr):
            conds = [self.eval(c) for c in e.conditions]
            vals = [self.eval(v) for v in e.values]
            dflt = self.eval(e.default) if e.default is not None else self.const(None)
            out = []
            for i in range(self.n):
                chosen = dflt[i]
                for c, v in zip(conds, vals):
                    if c[i] is True:
                        chosen = v[i]
                        break
                out.append(chosen)
            return out
        if isinstance(e, E.Exists):
            return [v is not None for v in self.eval(e.expr)]
        if isinstance(e, E.Coalesce):
            cols = [self.eval(x) for x in e.exprs]
            out = []
            for i in range(self.n):
                val = None
                for c in cols:
                    if c[i] is not None:
                        val = c[i]
                        break
                out.append(val)
            return out

        if isinstance(e, E.FunctionExpr):
            return self._function(e)
        if isinstance(e, E.PathExpr):
            raise ExprEvalError(
                "path values can only be returned, compared with =/<>, or "
                "passed to length()/nodes()/relationships()/count(); this "
                "expression uses a path variable in an unsupported position")
        if isinstance(e, E.Aggregator):
            raise ExprEvalError(
                f"aggregator {e!r} outside aggregation context")
        raise ExprEvalError(f"cannot evaluate {type(e).__name__}: {e!r}")

    # -- helpers ------------------------------------------------------------

    def _bind(self, row_getcol: GetCol, var: str, item: Any,
              kind: Optional[str],
              extra2: Optional[Tuple[str, Any]] = None) -> "_BoundEvaluator":
        extra = {var: [item]}
        kinds = {var: kind} if kind is not None else {}
        if extra2 is not None:
            extra[extra2[0]] = [extra2[1]]
        return _BoundEvaluator(1, row_getcol, self.header, self.params,
                               extra, entity_kinds=kinds,
                               entity_ctx=self.entity_ctx)

    def _single_kind(self, item: E.Expr) -> Optional[str]:
        """'node' | 'rel' | None: static entity kind of a scalar expr."""
        if isinstance(item, E.PathNode):
            return "node"
        if isinstance(item, E.PathSeg):
            return None if item.is_varlen else "rel"
        if isinstance(item, (E.StartNode, E.EndNode)):
            return "node"
        if self.header.has(item):
            return _kind_of_type(self.header.type_of(item))
        return None

    def _elem_kind(self, le: E.Expr):
        """Static entity kind(s) of a list-valued expr, so comprehension /
        quantifier variables ranging over entity ids can rehydrate
        properties and labels.  Returns ``'node'`` / ``'rel'`` (uniform),
        a per-position LIST of kinds (list literals — mixed elements must
        not coerce plain integers into entity ids), or ``None``."""
        if isinstance(le, E.ListLit):
            kinds = [self._single_kind(i) for i in le.items]
            uniq = set(kinds)
            if len(uniq) == 1:
                return kinds[0]
            return kinds
        if isinstance(le, E.Add):
            lk, rk = self._elem_kind(le.lhs), self._elem_kind(le.rhs)
            if isinstance(lk, list) and isinstance(rk, list):
                return lk + rk  # concat of two literals: positions align
            if lk == rk:
                return lk  # uniform (possibly None) on both sides
            # literal + uniform of unknown length: positions can't align
            return None
        if isinstance(le, E.PathNodes):
            return "node"
        if isinstance(le, E.PathSeg) and le.is_varlen:
            return "rel"
        if isinstance(le, E.Slice):
            k = self._elem_kind(le.expr)
            return k if not isinstance(k, list) else None
        if isinstance(le, E.FunctionExpr) and le.name == "tail" and le.args:
            k = self._elem_kind(le.args[0])
            return k if not isinstance(k, list) else None
        if isinstance(le, E.Collect):
            return self._single_kind(le.expr) or self._elem_kind(le.expr)
        if self.header.has(le):
            t = self.header.type_of(le).material
            if isinstance(t, _CTList):
                return _kind_of_type(t.inner)
        return None

    def _path_nodes(self, e: "E.PathNodes") -> List[Any]:
        """Walk each hop's relationship endpoints to rebuild the node-id
        sequence (mirrors relational/session.py _materialize_paths)."""
        starts = self.eval(e.start)
        piece_cols = [self.eval(p) for p in e.pieces]
        ctx = self.entity_ctx
        out: List[Any] = []
        for i in range(self.n):
            cur = starts[i]
            if cur is None:
                out.append(None)
                continue
            nodes = [cur]
            dead = False
            for j, col in enumerate(piece_cols):
                cell = col[i]
                if cell is None:
                    dead = True  # null hop (optional path): whole value null
                    break
                for rid in (cell if e.is_list[j] else [cell]):
                    rec = ctx.rel(rid) if ctx is not None else None
                    if rec is None:
                        raise ExprEvalError(
                            f"nodes(<path>): relationship {rid} not found in "
                            "the current graph (no entity context)")
                    src, tgt, _typ, _props = rec
                    cur = tgt if src == cur else src
                    nodes.append(cur)
            out.append(None if dead else nodes)
        return out

    def _cmp(self, e, fn) -> List[Any]:
        l, r = self.eval(e.lhs), self.eval(e.rhs)
        return [fn(a, b) for a, b in zip(l, r)]

    def _strpred(self, e, fn) -> List[Any]:
        l, r = self.eval(e.lhs), self.eval(e.rhs)
        return [None if a is None or b is None
                or not isinstance(a, str) or not isinstance(b, str)
                else fn(a, b) for a, b in zip(l, r)]

    def _arith(self, e) -> List[Any]:
        l, r = self.eval(e.lhs), self.eval(e.rhs)
        out = []
        for a, b in zip(l, r):
            if a is None or b is None:
                out.append(None)
                continue
            if is_temporal(a) or is_temporal(b):
                out.append(self._temporal_arith(e, a, b))
                continue
            try:
                if isinstance(e, E.Add):
                    if isinstance(a, str) or isinstance(b, str):
                        out.append(f"{_to_str(a)}{_to_str(b)}")
                    elif isinstance(a, list) or isinstance(b, list):
                        la = a if isinstance(a, list) else [a]
                        lb = b if isinstance(b, list) else [b]
                        out.append(la + lb)
                    else:
                        out.append(a + b)
                elif isinstance(e, E.Subtract):
                    out.append(a - b)
                elif isinstance(e, E.Multiply):
                    out.append(a * b)
                elif isinstance(e, E.Divide):
                    if isinstance(a, int) and isinstance(b, int):
                        if b == 0:
                            raise ZeroDivisionError
                        # Cypher/Java integer division truncates toward zero.
                        q = abs(a) // abs(b)
                        out.append(-q if (a < 0) != (b < 0) else q)
                    else:
                        out.append(a / b)
                elif isinstance(e, E.Modulo):
                    out.append(math.fmod(a, b) if isinstance(a, float)
                               or isinstance(b, float) else _imod(a, b))
                else:  # Power
                    out.append(float(a) ** float(b))
            except ZeroDivisionError:
                raise ExprEvalError("division by zero")
        return out

    @staticmethod
    def _temporal_arith(e, a, b):
        """date/datetime ± duration, duration ± duration (openCypher's
        defined temporal arithmetic; anything else is a type error →
        lenient null, matching the engine's out-of-domain convention)."""
        if isinstance(e, E.Add):
            if isinstance(a, (CypherDate, CypherDateTime)) \
                    and isinstance(b, CypherDuration):
                return a.plus(b)
            if isinstance(a, CypherDuration) \
                    and isinstance(b, (CypherDate, CypherDateTime)):
                return b.plus(a)
            if isinstance(a, CypherDuration) and isinstance(b, CypherDuration):
                return a.plus(b)
        elif isinstance(e, E.Subtract):
            if isinstance(a, (CypherDate, CypherDateTime)) \
                    and isinstance(b, CypherDuration):
                return a.plus(b.negate())
            if isinstance(a, CypherDuration) and isinstance(b, CypherDuration):
                return a.plus(b.negate())
        return None

    def _function(self, e: E.FunctionExpr) -> List[Any]:
        args = [self.eval(a) for a in e.args]
        fn = _FUNCTIONS.get(e.name)
        if fn is None:
            raise ExprEvalError(f"unknown function {e.name}()")
        return [fn(*[a[i] for a in args]) for i in range(self.n)]


class _BoundEvaluator(_Evaluator):
    """Evaluator with extra column bindings (list-comprehension /
    quantifier / reduce variables).  When a bound variable ranges over
    entity ids (``entity_kinds``), property / label / endpoint access on
    it rehydrates through the entity context — intercepted BEFORE the
    header lookup so the lambda variable shadows any same-named header
    column (Cypher scoping)."""

    def __init__(self, n: int, getcol: GetCol, header: RecordHeader,
                 params: Mapping[str, Any], extra: Dict[str, List[Any]],
                 entity_kinds: Optional[Dict[str, str]] = None,
                 entity_ctx=None):
        super().__init__(n, getcol, header, params, entity_ctx=entity_ctx)
        self.extra = extra
        self.entity_kinds = entity_kinds or {}

    def eval(self, e: E.Expr) -> List[Any]:
        if isinstance(e, E.Var) and e.name in self.extra:
            return self.extra[e.name]
        hit = self._bound_access(e)
        if hit is not None:
            return hit
        return super().eval(e)

    def _bind(self, row_getcol: GetCol, var: str, item: Any,
              kind: Optional[str],
              extra2: Optional[Tuple[str, Any]] = None) -> "_BoundEvaluator":
        sub = super()._bind(row_getcol, var, item, kind, extra2)
        # nested scopes still see the enclosing bound variables
        for k, v in self.extra.items():
            sub.extra.setdefault(k, v)
        for k, v in self.entity_kinds.items():
            sub.entity_kinds.setdefault(k, v)
        return sub

    def _bound_access(self, e: E.Expr) -> Optional[List[Any]]:
        if isinstance(e, (E.Property, E.Keys, E.Properties)):
            tgt = e.entity
        elif isinstance(e, (E.Labels, E.HasLabel)):
            tgt = e.node
        elif isinstance(e, (E.Type, E.HasType, E.StartNode, E.EndNode)):
            tgt = e.rel
        else:
            return None
        if not (isinstance(tgt, E.Var) and tgt.name in self.extra):
            return None
        kind = self.entity_kinds.get(tgt.name)
        return [self._entity_field(e, v, kind) for v in self.extra[tgt.name]]

    def _entity_field(self, e: E.Expr, v: Any, kind: Optional[str]) -> Any:
        if v is None:
            return None
        if is_temporal(v):
            return temporal_component(v, e.key) \
                if isinstance(e, E.Property) else None
        if isinstance(v, dict):  # map values bound to the variable
            if isinstance(e, E.Property):
                return v.get(e.key)
            if isinstance(e, E.Keys):
                return sorted(v.keys())
            if isinstance(e, E.Properties):
                return dict(v)
            return None
        ctx = self.entity_ctx
        if kind is None or ctx is None or isinstance(v, bool) \
                or not isinstance(v, int):
            return None  # non-entity element: lenient null (engine-wide)
        if kind == "node":
            rec = ctx.node(v)
            labels, props = rec if rec is not None else ((), {})
            if isinstance(e, E.Property):
                return props.get(e.key)
            if isinstance(e, E.Labels):
                return [lbl for lbl in sorted(labels)]
            if isinstance(e, E.HasLabel):
                return e.label in labels
            if isinstance(e, E.Keys):
                return sorted(k for k, p in props.items() if p is not None)
            if isinstance(e, E.Properties):
                return {k: p for k, p in props.items() if p is not None}
            return None
        rec = ctx.rel(v)
        src, tgt, typ, props = rec if rec is not None else (None, None, None, {})
        if isinstance(e, E.Property):
            return props.get(e.key)
        if isinstance(e, E.Type):
            return typ
        if isinstance(e, E.HasType):
            return typ == e.rel_type
        if isinstance(e, E.StartNode):
            return src
        if isinstance(e, E.EndNode):
            return tgt
        if isinstance(e, E.Keys):
            return sorted(k for k, p in props.items() if p is not None)
        if isinstance(e, E.Properties):
            return {k: p for k, p in props.items() if p is not None}
        return None


def _quantify(kind: str, verdicts: List[Any]) -> Optional[bool]:
    """openCypher 3VL for all/any/none/single over a predicate's verdicts."""
    n_true = sum(1 for v in verdicts if v is True)
    n_null = sum(1 for v in verdicts if v is not True and v is not False)
    if kind == "any":
        return True if n_true else (None if n_null else False)
    if kind == "all":
        if any(v is False for v in verdicts):
            return False
        return None if n_null else True
    if kind == "none":
        return False if n_true else (None if n_null else True)
    # single: exactly one element satisfies
    if n_true > 1:
        return False
    if n_null:
        return None
    return n_true == 1


def _row_slice(getcol: GetCol, row: int) -> GetCol:
    return lambda col: [getcol(col)[row]]


def _lte(a, b) -> Optional[bool]:
    lt = cypher_lt(a, b)
    if lt is True:
        return True
    eq = cypher_equals(a, b)
    if eq is True:
        return True
    if lt is None or eq is None:
        return None
    return False


def _imod(a, b):
    if b == 0:
        raise ZeroDivisionError
    # Cypher % follows the sign of the dividend (like Java), not Python.
    r = abs(a) % abs(b)
    return -r if a < 0 else r


def _to_str(v) -> str:
    if isinstance(v, str):
        return v
    if isinstance(v, bool):
        return "true" if v else "false"
    if v is None:
        return "null"
    if is_temporal(v):
        return v.iso()
    return str(v)


def _null_guard(fn):
    def wrapped(*args):
        if any(a is None for a in args):
            return None
        return fn(*args)
    return wrapped


_MISSING = object()


def _temporal_fn(name):
    def make(v=_MISSING):
        if v is _MISSING:
            raise ExprEvalError(
                f"{name}() without an argument (current time) is "
                "non-deterministic and not supported")
        if v is None:
            return None  # null argument propagates
        try:
            return temporal_construct(name, v)
        except ValueError as ex:
            raise ExprEvalError(str(ex))
    return make


_FUNCTIONS: Dict[str, Callable] = {
    "date": _temporal_fn("date"),
    "datetime": _temporal_fn("datetime"),
    "localdatetime": _temporal_fn("localdatetime"),
    "duration": _temporal_fn("duration"),
    "tostring": lambda v: None if v is None else _to_str(v),
    "tointeger": lambda v: _to_int(v),
    "toint": lambda v: _to_int(v),
    "tofloat": lambda v: _to_float(v),
    "toboolean": lambda v: _to_bool(v),
    "abs": _null_guard(abs),
    "sign": _null_guard(lambda v: (v > 0) - (v < 0)),
    "round": _null_guard(lambda v: float(math.floor(v + 0.5))),
    "ceil": _null_guard(lambda v: float(math.ceil(v))),
    "floor": _null_guard(lambda v: float(math.floor(v))),
    "sqrt": _null_guard(lambda v: math.sqrt(v) if v >= 0 else None),
    "exp": _null_guard(math.exp),
    "log": _null_guard(lambda v: math.log(v) if v > 0 else None),
    "log10": _null_guard(lambda v: math.log10(v) if v > 0 else None),
    "sin": _null_guard(math.sin), "cos": _null_guard(math.cos),
    "tan": _null_guard(math.tan), "atan": _null_guard(math.atan),
    "asin": _null_guard(lambda v: math.asin(v) if -1 <= v <= 1 else None),
    "acos": _null_guard(lambda v: math.acos(v) if -1 <= v <= 1 else None),
    "e": lambda: math.e, "pi": lambda: math.pi,
    "touppercase": _null_guard(lambda s: s.upper()),
    "toupper": _null_guard(lambda s: s.upper()),
    "tolowercase": _null_guard(lambda s: s.lower()),
    "tolower": _null_guard(lambda s: s.lower()),
    "trim": _null_guard(lambda s: s.strip()),
    "ltrim": _null_guard(lambda s: s.lstrip()),
    "rtrim": _null_guard(lambda s: s.rstrip()),
    "reverse": _null_guard(lambda s: s[::-1] if isinstance(s, str) else list(reversed(s))),
    "left": _null_guard(lambda s, n: s[:n]),
    "right": _null_guard(lambda s, n: s[-n:] if n > 0 else ""),
    "substring": lambda s, start, length=None: (
        None if s is None or start is None else
        (s[start:] if length is None else s[start:start + length])),
    "replace": _null_guard(lambda s, find, repl: s.replace(find, repl)),
    "split": _null_guard(lambda s, sep: s.split(sep)),
    "size": lambda v: None if v is None else len(v),
    "length": lambda v: None if v is None else len(v),
    "head": lambda v: None if not v else v[0],
    "last": lambda v: None if not v else v[-1],
    "tail": lambda v: None if v is None else list(v[1:]),
    "range": lambda a, b, step=1: list(range(a, b + (1 if step > 0 else -1), step)),
}


def _to_int(v):
    if v is None:
        return None
    if isinstance(v, bool):
        return None
    if isinstance(v, (int, float)):
        return int(v)
    if isinstance(v, str):
        try:
            return int(float(v)) if "." in v or "e" in v.lower() else int(v)
        except ValueError:
            return None
    return None


def _to_float(v):
    if v is None or isinstance(v, bool):
        return None
    if isinstance(v, (int, float)):
        return float(v)
    if isinstance(v, str):
        try:
            return float(v)
        except ValueError:
            return None
    return None


def _to_bool(v):
    if v is None:
        return None
    if isinstance(v, bool):
        return v
    if isinstance(v, str):
        if v.lower() == "true":
            return True
        if v.lower() == "false":
            return False
    return None
