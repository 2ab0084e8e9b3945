"""Semantic analysis over the clause AST.

A lightweight analog of the reference front-end's ``SemanticState`` phase:
variable scoping through the clause chain, WITH aliasing rules, and
aggregation placement checks.  Raises :class:`CypherSemanticError` with a
clear message; the IR builder runs this before building blocks.
"""
from __future__ import annotations

from typing import Optional, Set, Tuple

from caps_tpu_torch.frontend import ast
from caps_tpu_torch.ir import exprs as E


class CypherSemanticError(Exception):
    pass


def check_statement(stmt: ast.Statement) -> None:
    if isinstance(stmt, ast.UnionQuery):
        cols: Optional[Tuple[str, ...]] = None
        for q in stmt.queries:
            qcols = _check_single(q)
            if cols is not None and qcols is not None and cols != qcols:
                raise CypherSemanticError(
                    f"UNION branches must return the same columns: {cols} vs {qcols}")
            cols = qcols if qcols is not None else cols
    elif isinstance(stmt, ast.SingleQuery):
        _check_single(stmt)
    elif isinstance(stmt, ast.CatalogCreateGraph):
        check_statement(stmt.inner)
    elif isinstance(stmt, ast.CatalogDropGraph):
        pass
    else:
        raise CypherSemanticError(f"unknown statement type {type(stmt).__name__}")


def _pattern_vars(pattern: ast.Pattern) -> Set[str]:
    out: Set[str] = set()
    for part in pattern.parts:
        if part.path_var:
            out.add(part.path_var)
        for el in part.elements:
            if el.var:
                out.add(el.var)
    return out


def _check_expr_vars(expr: E.Expr, scope: Set[str], where: str) -> None:
    local = set()
    # binder vars first: they are visible anywhere in this expr
    for n in expr.walk():
        if isinstance(n, E.ExistsSubQuery):
            continue  # its own scope — checked recursively below
        if isinstance(n, (E.ListComprehension, E.QuantifiedPredicate)):
            local.add(n.var)
        elif isinstance(n, E.Reduce):
            local.add(n.var)
            local.add(n.acc)

    def check(n: E.Expr) -> None:
        if isinstance(n, E.ExistsSubQuery):
            # EXISTS pattern vars are visible ONLY inside the subquery
            inner = scope | local | (_pattern_vars(n.pattern)
                                     if isinstance(n.pattern, ast.Pattern)
                                     else set())
            if n.where is not None:
                _check_expr_vars(n.where, inner, where)
            return
        if isinstance(n, E.Var) and n.name not in scope \
                and n.name not in local:
            raise CypherSemanticError(
                f"variable `{n.name}` not defined ({where})")
        for c in n.children:
            if isinstance(c, E.Expr):
                check(c)

    check(expr)


def _check_no_aggregation(expr: E.Expr, where: str) -> None:
    if E.is_aggregating(expr):
        raise CypherSemanticError(f"aggregation is not allowed in {where}")


def _check_single(q: ast.SingleQuery) -> Optional[Tuple[str, ...]]:
    scope: Set[str] = set()
    returned: Optional[Tuple[str, ...]] = None
    clauses = q.clauses
    if not clauses:
        raise CypherSemanticError("empty query")
    for idx, clause in enumerate(clauses):
        is_last = idx == len(clauses) - 1
        if isinstance(clause, ast.MatchClause):
            new_vars = _pattern_vars(clause.pattern)
            for part in clause.pattern.parts:
                for el in part.elements:
                    if el.properties is not None:
                        _check_expr_vars(el.properties, scope | new_vars, "pattern properties")
                        _check_no_aggregation(el.properties, "pattern properties")
                    if isinstance(el, ast.RelPattern) and el.var and el.var in scope:
                        raise CypherSemanticError(
                            f"relationship variable `{el.var}` already bound")
            scope |= new_vars
            if clause.where is not None:
                _check_expr_vars(clause.where, scope, "WHERE")
                _check_no_aggregation(clause.where, "WHERE")
        elif isinstance(clause, ast.UnwindClause):
            _check_expr_vars(clause.expr, scope, "UNWIND")
            scope.add(clause.var)
        elif isinstance(clause, (ast.WithClause, ast.ReturnClause)):
            body = clause.body if isinstance(clause, ast.WithClause) else clause.body
            names = _check_projection(body, scope,
                                      is_with=isinstance(clause, ast.WithClause))
            if isinstance(clause, ast.WithClause):
                scope = set(names)
                if clause.where is not None:
                    _check_expr_vars(clause.where, scope, "WHERE after WITH")
                    _check_no_aggregation(clause.where, "WHERE")
            else:
                if not is_last:
                    raise CypherSemanticError("RETURN must be the last clause")
                returned = tuple(names)
        elif isinstance(clause, ast.CreateClause):
            for part in clause.pattern.parts:
                for el in part.elements:
                    if el.properties is not None:
                        _check_expr_vars(el.properties, scope, "CREATE properties")
            scope |= _pattern_vars(clause.pattern)
        elif isinstance(clause, ast.SetClause):
            for item in clause.items:
                if item.var not in scope:
                    raise CypherSemanticError(f"variable `{item.var}` not defined (SET)")
                if item.value is not None:
                    _check_expr_vars(item.value, scope, "SET")
        elif isinstance(clause, ast.DeleteClause):
            for e in clause.exprs:
                _check_expr_vars(e, scope, "DELETE")
        elif isinstance(clause, ast.FromGraphClause):
            pass
        elif isinstance(clause, ast.ConstructClause):
            for c in clause.clones:
                _check_expr_vars(c.source, scope, "CLONE")
            construct_scope = scope | {c.var for c in clause.clones}
            for pat in clause.news:
                for part in pat.parts:
                    for el in part.elements:
                        if el.properties is not None:
                            _check_expr_vars(el.properties, construct_scope, "NEW properties")
                construct_scope |= _pattern_vars(pat)
            for item in clause.sets:
                if item.var not in construct_scope:
                    raise CypherSemanticError(
                        f"variable `{item.var}` not defined (CONSTRUCT SET)")
        elif isinstance(clause, ast.ReturnGraphClause):
            if not is_last:
                raise CypherSemanticError("RETURN GRAPH must be the last clause")
        elif isinstance(clause, ast.CallClause):
            names = _check_call(clause, scope)
            scope |= set(names)
            if is_last:
                returned = tuple(names)
        else:
            raise CypherSemanticError(f"unsupported clause {type(clause).__name__}")
    return returned


def _arg_is_driver_side(expr: E.Expr) -> bool:
    """Procedure arguments must be host-evaluable at dispatch time:
    literals, parameters, or negations thereof (mirrors SKIP/LIMIT)."""
    if isinstance(expr, (E.Lit, E.Param)):
        return True
    if isinstance(expr, E.Negate):
        return _arg_is_driver_side(expr.expr)
    return False


def _check_call(clause: ast.CallClause, scope: Set[str]):
    """Resolve one CALL against the procedure registry: typed errors
    for unknown names, arity/type mismatches, and bad YIELD columns —
    each naming the procedure and its registered signature(s)."""
    # imported lazily: the registry subclasses CypherSemanticError, so a
    # module-level import here would be circular
    from caps_tpu_torch.algo import registry
    sig = registry.lookup(clause.procedure)
    sig.check_arity(len(clause.args))
    for pos, arg in enumerate(clause.args):
        if not _arg_is_driver_side(arg):
            raise registry.ProcedureArgumentError(
                f"procedure {sig.name} argument {pos} must be a literal "
                f"or parameter, got {arg.cypher_repr()}; "
                f"signature: {sig.render()}")
        if isinstance(arg, E.Lit):
            sig.check_literal(pos, arg.value)
        elif isinstance(arg, E.Negate) and isinstance(arg.expr, E.Lit):
            sig.check_literal(pos, -arg.expr.value)
    yields = clause.yields or tuple((n, None) for n in sig.yield_names)
    names = []
    for yname, alias in yields:
        sig.yield_type(yname)  # unknown column -> ProcedureYieldError
        names.append(alias or yname)
    dupes = {n for n in names if names.count(n) > 1}
    if dupes:
        raise CypherSemanticError(
            f"duplicate YIELD column name(s): {sorted(dupes)}")
    rebound = set(names) & scope
    if rebound:
        raise CypherSemanticError(
            f"YIELD would rebind variable(s) already in scope: "
            f"{sorted(rebound)}; alias them with AS")
    if clause.where is not None:
        if not clause.yields:
            raise CypherSemanticError(
                "WHERE after CALL requires an explicit YIELD")
        _check_expr_vars(clause.where, scope | set(names),
                         "WHERE after YIELD")
        _check_no_aggregation(clause.where, "WHERE after YIELD")
    return names


def _check_projection(body: ast.ProjectionBody, scope: Set[str], is_with: bool):
    names = []
    if body.star:
        names.extend(sorted(scope))
    for item in body.items:
        _check_expr_vars(item.expr, scope, "projection")
        if item.alias is not None:
            names.append(item.alias)
        elif isinstance(item.expr, E.Var):
            names.append(item.expr.name)
        elif is_with:
            raise CypherSemanticError(
                f"expression in WITH must be aliased: {item.expr.cypher_repr()}")
        else:
            names.append(item.expr.cypher_repr())
    dupes = {n for n in names if names.count(n) > 1}
    if dupes:
        raise CypherSemanticError(f"duplicate column name(s): {sorted(dupes)}")
    # ORDER BY / SKIP / LIMIT see both input scope and projected names
    order_scope = scope | set(names)
    for oi in body.order_by:
        _check_expr_vars(oi.expr, order_scope, "ORDER BY")
    for e, label in ((body.skip, "SKIP"), (body.limit, "LIMIT")):
        if e is not None:
            _check_expr_vars(e, set(), label)  # literals/params only
            _check_no_aggregation(e, label)
    return names
