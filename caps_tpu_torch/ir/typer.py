"""Expression typing against a schema and a variable-type environment.

Mirrors the reference's ``SchemaTyper`` (ref: okapi-ir/.../ir/impl/typer/
SchemaTyper.scala — reconstructed, mount empty; SURVEY.md §2 "IR").
"""
from __future__ import annotations

from typing import Mapping, Optional

from caps_tpu_torch.ir import exprs as E
from caps_tpu_torch.okapi.schema import Schema
from caps_tpu_torch.okapi.types import (
    CTAny, CTBoolean, CTFloat, CTInteger, CTList, CTMap, CTNull, CTNumber,
    CTString, CTVoid, CypherType, _CTList, _CTNode, _CTRelationship,
    from_python, join_all,
)


class TypingError(Exception):
    pass


class SchemaTyper:
    """Types expressions; node/relationship property types come from the
    schema restricted by the entity's declared labels/types."""

    def __init__(self, schema: Schema,
                 parameters: Optional[Mapping[str, object]] = None):
        self.schema = schema
        # kept as-is (not copied): a PlanParams view must keep recording
        # plan-time value reads for the plan cache (relational/plan_cache)
        self.parameters: Mapping[str, object] = \
            parameters if parameters is not None else {}

    def type_of(self, expr: E.Expr, env: Mapping[str, CypherType]) -> CypherType:
        t = self._type_of(expr, env)
        if t is None:
            raise TypingError(f"cannot type expression {expr!r}")
        return t

    def _type_of(self, e: E.Expr, env) -> CypherType:  # noqa: C901
        rec = lambda x: self.type_of(x, env)  # noqa: E731

        if isinstance(e, E.Var):
            if e.name not in env:
                raise TypingError(f"variable `{e.name}` not in scope")
            return env[e.name]
        if isinstance(e, E.Param):
            # Only the COARSE type of a parameter is consumed here: go
            # through the type-level accessor when planning under a
            # PlanParams view so the read keys the plan by signature, not
            # by value (plain dicts use the value directly).
            coarse = getattr(self.parameters, "coarse_type", None)
            if coarse is not None:
                return coarse(e.name) or CTAny
            if e.name in self.parameters:
                return from_python(self.parameters[e.name])
            return CTAny
        if isinstance(e, E.Lit):
            return from_python(e.value)
        if isinstance(e, E.ListLit):
            return CTList(join_all(rec(i) for i in e.items))
        if isinstance(e, E.MapLit):
            return CTMap

        if isinstance(e, E.Property):
            from caps_tpu_torch.okapi.types import CTDate, CTDateTime, CTDuration
            et = rec(e.entity)
            m = et.material
            if isinstance(m, _CTNode):
                t = self.schema.node_property_type(m.labels, e.key)
            elif isinstance(m, _CTRelationship):
                t = self.schema.relationship_property_type(m.rel_types, e.key)
            elif m in (CTDate, CTDateTime, CTDuration):
                t = CTInteger.nullable  # temporal component accessor
            else:
                t = CTAny  # maps / CTAny entities: untyped property access
            return t.nullable if et.is_nullable and t != CTNull else t

        if isinstance(e, E.PathExpr):
            from caps_tpu_torch.okapi.types import CTPath
            return CTPath
        if isinstance(e, E.PathSeg):
            from caps_tpu_torch.okapi.types import CTRelationship
            t = rec(e.path)
            out: CypherType = (CTList(CTRelationship()) if e.is_varlen
                               else CTRelationship())
            return out.nullable if t.is_nullable else out
        if isinstance(e, E.PathNode):
            from caps_tpu_torch.okapi.types import CTNode
            t = rec(e.path)
            out = CTNode()
            return out.nullable if t.is_nullable else out

        if isinstance(e, (E.HasLabel, E.HasType)):
            return CTBoolean
        if isinstance(e, E.Id):
            t = rec(e.entity)
            return CTInteger.nullable if t.is_nullable else CTInteger
        if isinstance(e, (E.StartNode, E.EndNode)):
            from caps_tpu_torch.okapi.types import CTNode
            t = rec(e.rel)
            out = CTNode()
            return out.nullable if t.is_nullable else out
        if isinstance(e, E.Labels):
            return CTList(CTString)
        if isinstance(e, E.Type):
            t = rec(e.rel)
            return CTString.nullable if t.is_nullable else CTString
        if isinstance(e, E.Keys):
            return CTList(CTString)
        if isinstance(e, E.Properties):
            return CTMap

        if isinstance(e, (E.Ands, E.Ors)):
            ts = [rec(x) for x in e.exprs]
            nullable = any(t.is_nullable or t == CTNull for t in ts)
            return CTBoolean.nullable if nullable else CTBoolean
        if isinstance(e, (E.Xor, E.Not)):
            inner = [rec(c) for c in e.children]
            nullable = any(t.is_nullable or t == CTNull for t in inner)
            return CTBoolean.nullable if nullable else CTBoolean
        if isinstance(e, (E.IsNull, E.IsNotNull)):
            return CTBoolean
        if isinstance(e, E.ExistsSubQuery):
            return CTBoolean  # EXISTS is never null

        if isinstance(e, (E.Equals, E.NotEquals, E.LessThan, E.LessThanOrEqual,
                          E.GreaterThan, E.GreaterThanOrEqual, E.In,
                          E.Disjoint, E.StartsWith, E.EndsWith, E.Contains,
                          E.RegexMatch)):
            lt, rt = rec(e.lhs), rec(e.rhs)
            nullable = (lt.is_nullable or rt.is_nullable
                        or lt == CTNull or rt == CTNull)
            return CTBoolean.nullable if nullable else CTBoolean

        if isinstance(e, (E.Add, E.Subtract, E.Multiply, E.Divide, E.Modulo,
                          E.Power)):
            from caps_tpu_torch.okapi.types import CTDate, CTDateTime, CTDuration
            lt, rt = rec(e.lhs), rec(e.rhs)
            if lt == CTNull or rt == CTNull:
                return CTNull
            lm, rm = lt.material, rt.material
            temporal = {CTDate, CTDateTime, CTDuration}
            if lm in temporal or rm in temporal:
                # only the DEFINED temporal combinations produce values;
                # everything else is null at runtime (_temporal_arith) and
                # must not be typed as a guaranteed temporal
                pair = (lm, rm)
                out = None
                if isinstance(e, E.Add):
                    if pair in ((CTDate, CTDuration), (CTDuration, CTDate)):
                        out = CTDate
                    elif pair in ((CTDateTime, CTDuration),
                                  (CTDuration, CTDateTime)):
                        out = CTDateTime
                    elif pair == (CTDuration, CTDuration):
                        out = CTDuration
                elif isinstance(e, E.Subtract):
                    if pair == (CTDate, CTDuration):
                        out = CTDate
                    elif pair == (CTDateTime, CTDuration):
                        out = CTDateTime
                    elif pair == (CTDuration, CTDuration):
                        out = CTDuration
                if out is None:
                    if CTAny in (lm, rm):
                        return CTAny  # untyped operand: could be defined
                    return CTNull
                return out.nullable if (lt.is_nullable or rt.is_nullable) \
                    else out
            # String/list concatenation via +
            if isinstance(e, E.Add) and (lm == CTString or rm == CTString):
                out: CypherType = CTString
            elif isinstance(e, E.Add) and (isinstance(lm, _CTList) or isinstance(rm, _CTList)):
                out = lm.join(rm) if isinstance(lm, _CTList) and isinstance(rm, _CTList) else (
                    lm if isinstance(lm, _CTList) else rm)
            elif isinstance(e, (E.Divide,)) and lm == CTInteger and rm == CTInteger:
                out = CTInteger
            elif isinstance(e, E.Power):
                out = CTFloat
            else:
                out = lm.join(rm)
                if out == CTAny:
                    out = CTNumber
            return out.nullable if (lt.is_nullable or rt.is_nullable) else out
        if isinstance(e, E.Negate):
            return rec(e.expr)

        if isinstance(e, E.Index):
            ct = rec(e.expr).material
            if isinstance(ct, _CTList):
                return ct.inner.nullable
            return CTAny
        if isinstance(e, E.Slice):
            return rec(e.expr)
        if isinstance(e, E.ListComprehension):
            lt = rec(e.list_expr).material
            inner = lt.inner if isinstance(lt, _CTList) else CTAny
            env2 = dict(env)
            env2[e.var] = inner
            if e.projection is not None:
                return CTList(self.type_of(e.projection, env2))
            return CTList(inner)
        if isinstance(e, E.QuantifiedPredicate):
            lt = rec(e.list_expr).material
            inner = lt.inner if isinstance(lt, _CTList) else CTAny
            env2 = dict(env)
            env2[e.var] = inner
            self.type_of(e.predicate, env2)  # scope/arity validation
            return CTBoolean.nullable
        if isinstance(e, E.Reduce):
            lt = rec(e.list_expr).material
            env2 = dict(env)
            env2[e.var] = lt.inner if isinstance(lt, _CTList) else CTAny
            acc_t = rec(e.init)
            env2[e.acc] = acc_t
            step_t = self.type_of(e.expr, env2)
            # one widening pass: the accumulator's steady-state type is the
            # join of init and one step's result
            env2[e.acc] = acc_t.join(step_t)
            return acc_t.join(self.type_of(e.expr, env2))
        if isinstance(e, E.PathNodes):
            from caps_tpu_torch.okapi.types import CTNode
            t = rec(e.start)
            out = CTList(CTNode())
            return out.nullable if t.is_nullable else out

        if isinstance(e, E.CaseExpr):
            branches = [rec(v) for v in e.values]
            if e.default is not None:
                branches.append(rec(e.default))
                return join_all(branches)
            return join_all(branches).nullable
        if isinstance(e, E.Exists):
            return CTBoolean
        if isinstance(e, E.Coalesce):
            ts = [rec(x) for x in e.exprs]
            out = join_all(t.material for t in ts if t != CTNull)
            if out == CTVoid:
                return CTNull
            return out.nullable if all(t.is_nullable or t == CTNull for t in ts) else out

        # Aggregators
        if isinstance(e, E.CountStar):
            return CTInteger
        if isinstance(e, E.Count):
            return CTInteger
        if isinstance(e, E.Sum):
            t = rec(e.expr).material
            return t if t in (CTInteger, CTFloat, CTNumber) else CTNumber
        if isinstance(e, E.Avg):
            return CTFloat
        if isinstance(e, (E.Min, E.Max)):
            return rec(e.expr).nullable
        if isinstance(e, E.Collect):
            return CTList(rec(e.expr).material)
        if isinstance(e, E.StDev):
            return CTFloat
        if isinstance(e, (E.PercentileCont, E.PercentileDisc)):
            return CTFloat

        if isinstance(e, E.FunctionExpr):
            return self._function_type(e, env)

        raise TypingError(f"no typing rule for {type(e).__name__}")

    _NUMERIC_FNS = {"abs": None, "sign": CTInteger, "round": CTFloat,
                    "ceil": CTFloat, "floor": CTFloat, "sqrt": CTFloat,
                    "exp": CTFloat, "log": CTFloat, "log10": CTFloat,
                    "sin": CTFloat, "cos": CTFloat, "tan": CTFloat,
                    "atan": CTFloat, "asin": CTFloat, "acos": CTFloat}
    _STRING_FNS = {"touppercase", "toupper", "tolowercase", "tolower", "trim",
                   "ltrim", "rtrim", "reverse", "left", "right", "substring",
                   "replace"}

    def _function_type(self, e: E.FunctionExpr, env) -> CypherType:
        name = e.name
        args = [self.type_of(a, env) for a in e.args]
        nullable = any(t.is_nullable or t == CTNull for t in args)

        def wrap(t: CypherType) -> CypherType:
            return t.nullable if nullable else t

        if name in self._NUMERIC_FNS:
            fixed = self._NUMERIC_FNS[name]
            if fixed is not None:
                return wrap(fixed)
            return wrap(args[0].material if args else CTNumber)
        if name in self._STRING_FNS:
            return wrap(CTString)
        if name == "tostring":
            return wrap(CTString)
        if name in ("tointeger", "toint"):
            return CTInteger.nullable
        if name == "tofloat":
            return CTFloat.nullable
        if name == "toboolean":
            return CTBoolean.nullable
        if name in ("size", "length"):
            return wrap(CTInteger)
        if name == "split":
            return wrap(CTList(CTString))
        if name == "range":
            return CTList(CTInteger)
        if name in ("head", "last"):
            t = args[0].material if args else CTAny
            return (t.inner if isinstance(t, _CTList) else CTAny).nullable
        if name == "tail":
            return wrap(args[0] if args else CTList(CTAny))
        if name in ("nodes",):
            from caps_tpu_torch.okapi.types import CTNode
            return wrap(CTList(CTNode()))
        if name in ("relationships", "rels"):
            from caps_tpu_torch.okapi.types import CTRelationship
            return wrap(CTList(CTRelationship()))
        if name in ("e", "pi", "rand"):
            return CTFloat
        if name == "timestamp":
            return CTInteger
        if name == "date":
            from caps_tpu_torch.okapi.types import CTDate
            return wrap(CTDate)
        if name in ("datetime", "localdatetime"):
            from caps_tpu_torch.okapi.types import CTDateTime
            return wrap(CTDateTime)
        if name == "duration":
            from caps_tpu_torch.okapi.types import CTDuration
            return wrap(CTDuration)
        return CTAny
