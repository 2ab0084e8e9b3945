"""Recursive-descent openCypher parser.

Covers the subset the engine supports (SURVEY.md §7): MATCH / OPTIONAL
MATCH / WHERE / WITH / RETURN / ORDER BY / SKIP / LIMIT / UNWIND / UNION /
CREATE / SET / DELETE, variable-length relationships, full expression
grammar with precedence climbing, and the multiple-graph extensions
FROM GRAPH / USE, CONSTRUCT (ON/CLONE/NEW/SET), RETURN GRAPH,
CATALOG CREATE GRAPH.  Grammar follows the openCypher 9 EBNF; the
reference got this from the external Neo4j front-end dependency.
"""
from __future__ import annotations

import functools
from typing import List, Optional, Tuple

from caps_tpu_torch.frontend import ast
from caps_tpu_torch.frontend.lexer import (
    EOF, FLOAT, IDENT, INT, KEYWORD, QUERY_MODES, STRING, SYM,
    CypherSyntaxError, Token, tokenize,
)
from caps_tpu_torch.ir import exprs as E


class CypherParser:
    def __init__(self, query: str):
        self.query = query
        self.toks = tokenize(query)
        self.i = 0

    # -- token helpers ------------------------------------------------------

    def peek(self, offset: int = 0) -> Token:
        return self.toks[min(self.i + offset, len(self.toks) - 1)]

    def advance(self) -> Token:
        t = self.toks[self.i]
        if t.kind != EOF:
            self.i += 1
        return t

    def error(self, msg: str) -> CypherSyntaxError:
        return CypherSyntaxError(msg, self.query, self.peek().pos)

    def at_kw(self, *kws: str) -> bool:
        t = self.peek()
        return t.kind == KEYWORD and t.text in kws

    def at_sym(self, *syms: str) -> bool:
        t = self.peek()
        return t.kind == SYM and t.text in syms

    def accept_kw(self, *kws: str) -> bool:
        if self.at_kw(*kws):
            self.advance()
            return True
        return False

    def accept_sym(self, *syms: str) -> bool:
        if self.at_sym(*syms):
            self.advance()
            return True
        return False

    def expect_kw(self, kw: str) -> Token:
        if not self.at_kw(kw):
            raise self.error(f"expected {kw}, found {self.peek().text or 'end of input'!r}")
        return self.advance()

    def expect_sym(self, sym: str) -> Token:
        if not self.at_sym(sym):
            raise self.error(f"expected {sym!r}, found {self.peek().text or 'end of input'!r}")
        return self.advance()

    def ident_like(self, what: str = "identifier") -> str:
        """An identifier; keywords are allowed as names in name positions
        (aliases, property keys, labels), like the reference grammar."""
        t = self.peek()
        if t.kind == IDENT:
            self.advance()
            return t.text
        if t.kind == KEYWORD:
            self.advance()
            return str(t.value)  # original spelling
        raise self.error(f"expected {what}, found {t.text or 'end of input'!r}")

    # -- entry points -------------------------------------------------------

    def parse_statement(self) -> ast.Statement:
        # EXPLAIN / PROFILE query prefixes (observability — obs/):
        # consumed here so `parse_query` validates prefixed text; mode
        # DISPATCH lives solely in `query_mode`, which the session calls
        # to strip the prefix BEFORE planning, so plan-cache and
        # fused-executor keys never see it.  They are prefix markers,
        # not keywords: a leading bare identifier is never valid
        # openCypher, so consuming one here is unambiguous and the words
        # stay usable as names/variables elsewhere.
        t = self.peek()
        if t.kind == IDENT and t.text.upper() in QUERY_MODES:
            self.advance()
        if self.at_kw("CATALOG"):
            stmt = self._parse_catalog_statement()
        else:
            stmt = self.parse_regular_query()
        self.accept_sym(";")
        if self.peek().kind != EOF:
            raise self.error(f"unexpected input after query: {self.peek().text!r}")
        return stmt

    def _parse_catalog_statement(self) -> ast.Statement:
        self.expect_kw("CATALOG")
        if self.accept_kw("CREATE"):
            self.expect_kw("GRAPH")
            name = self._parse_qualified_name()
            self.expect_sym("{")
            inner = self.parse_regular_query()
            self.expect_sym("}")
            return ast.CatalogCreateGraph(name, inner)
        if self.accept_kw("DELETE") or (self.at_kw("DETACH") and self.advance()):
            self.expect_kw("GRAPH")
            return ast.CatalogDropGraph(self._parse_qualified_name())
        raise self.error("expected CREATE GRAPH or DELETE GRAPH after CATALOG")

    def parse_regular_query(self) -> ast.Statement:
        first = self.parse_single_query()
        queries = [first]
        union_all: Optional[bool] = None
        while self.at_kw("UNION"):
            self.advance()
            this_all = self.accept_kw("ALL")
            if union_all is not None and union_all != this_all:
                raise self.error("cannot mix UNION and UNION ALL")
            union_all = this_all
            queries.append(self.parse_single_query())
        if len(queries) == 1:
            return first
        return ast.UnionQuery(tuple(queries), union_all=bool(union_all))

    def parse_single_query(self) -> ast.SingleQuery:
        clauses: List[ast.Clause] = []
        while True:
            t = self.peek()
            if t.kind == EOF or self.at_kw("UNION") or self.at_sym(";", "}"):
                break
            clauses.append(self.parse_clause())
        if not clauses:
            raise self.error("empty query")
        return ast.SingleQuery(tuple(clauses))

    # -- clauses ------------------------------------------------------------

    def parse_clause(self) -> ast.Clause:
        if self.at_kw("OPTIONAL"):
            self.advance()
            self.expect_kw("MATCH")
            return self._parse_match(optional=True)
        if self.accept_kw("MATCH"):
            return self._parse_match(optional=False)
        if self.accept_kw("UNWIND"):
            expr = self.parse_expr()
            self.expect_kw("AS")
            var = self.ident_like("variable")
            return ast.UnwindClause(expr, var)
        if self.accept_kw("WITH"):
            body = self._parse_projection_body()
            where = self.parse_expr() if self.accept_kw("WHERE") else None
            return ast.WithClause(body, where)
        if self.at_kw("RETURN"):
            self.advance()
            if self.at_kw("GRAPH"):
                self.advance()
                return ast.ReturnGraphClause()
            return ast.ReturnClause(self._parse_projection_body())
        if self.accept_kw("CREATE"):
            return ast.CreateClause(self.parse_pattern())
        if self.accept_kw("SET"):
            return ast.SetClause(self._parse_set_items())
        if self.accept_kw("DETACH"):
            self.expect_kw("DELETE")
            return ast.DeleteClause(self._parse_expr_list(), detach=True)
        if self.accept_kw("DELETE"):
            return ast.DeleteClause(self._parse_expr_list(), detach=False)
        if self.accept_kw("FROM"):
            self.accept_kw("GRAPH")
            return ast.FromGraphClause(self._parse_qualified_name())
        if self.accept_kw("USE"):
            self.accept_kw("GRAPH")
            return ast.FromGraphClause(self._parse_qualified_name())
        if self.accept_kw("CONSTRUCT"):
            return self._parse_construct()
        if self.accept_kw("CALL"):
            return self._parse_call()
        raise self.error(f"unexpected token {self.peek().text!r} at clause start")

    def _parse_call(self) -> ast.CallClause:
        """``CALL`` consumed: dotted procedure name, optional argument
        list, optional ``YIELD`` items with ``AS`` aliases.  Name
        resolution (and arity/type checking) is the semantic pass's job
        — the grammar accepts any dotted name."""
        parts = [self.ident_like("procedure name")]
        while self.accept_sym("."):
            parts.append(self.ident_like("procedure name"))
        name = ".".join(parts)
        args: List[E.Expr] = []
        if self.accept_sym("("):
            if not self.at_sym(")"):
                args.append(self.parse_expr())
                while self.accept_sym(","):
                    args.append(self.parse_expr())
            self.expect_sym(")")
        yields: List[Tuple[str, Optional[str]]] = []
        where: Optional[E.Expr] = None
        if self.accept_kw("YIELD"):
            while True:
                yname = self.ident_like("yield column")
                alias = self.ident_like("alias") if self.accept_kw("AS") \
                    else None
                yields.append((yname, alias))
                if not self.accept_sym(","):
                    break
            if self.accept_kw("WHERE"):
                where = self.parse_expr()
        return ast.CallClause(name, tuple(args), tuple(yields), where)

    def _parse_match(self, optional: bool) -> ast.MatchClause:
        pattern = self.parse_pattern()
        where = self.parse_expr() if self.accept_kw("WHERE") else None
        return ast.MatchClause(pattern, where, optional)

    def _parse_expr_list(self) -> Tuple[E.Expr, ...]:
        out = [self.parse_expr()]
        while self.accept_sym(","):
            out.append(self.parse_expr())
        return tuple(out)

    def _parse_qualified_name(self) -> str:
        parts = [self.ident_like("graph name")]
        while self.accept_sym("."):
            parts.append(self.ident_like("graph name"))
        return ".".join(parts)

    def _parse_set_items(self) -> Tuple[ast.SetItem, ...]:
        items = []
        while True:
            var = self.ident_like("variable")
            if self.accept_sym("."):
                key = self.ident_like("property key")
                self.expect_sym("=")
                items.append(ast.SetItem(var, key=key, value=self.parse_expr()))
            elif self.at_sym(":"):
                labels = []
                while self.accept_sym(":"):
                    labels.append(self.ident_like("label"))
                items.append(ast.SetItem(var, labels=tuple(labels)))
            elif self.accept_sym("+="):
                items.append(ast.SetItem(var, value=self.parse_expr(), merge=True))
            elif self.accept_sym("="):
                items.append(ast.SetItem(var, value=self.parse_expr()))
            else:
                raise self.error("expected '.', ':', '=' or '+=' in SET item")
            if not self.accept_sym(","):
                return tuple(items)

    def _parse_construct(self) -> ast.ConstructClause:
        on: List[str] = []
        clones: List[ast.CloneItem] = []
        news: List[ast.Pattern] = []
        sets: List[ast.SetItem] = []
        if self.accept_kw("ON"):
            on.append(self._parse_qualified_name())
            while self.accept_sym(","):
                on.append(self._parse_qualified_name())
        while True:
            if self.accept_kw("CLONE"):
                while True:
                    src = self.parse_expr()
                    if self.accept_kw("AS"):
                        var = self.ident_like("variable")
                    elif isinstance(src, E.Var):
                        var = src.name
                    else:
                        raise self.error("CLONE of an expression requires AS alias")
                    clones.append(ast.CloneItem(var, src))
                    if not self.accept_sym(","):
                        break
            elif self.accept_kw("NEW") or self.accept_kw("CREATE"):
                news.append(self.parse_pattern())
            elif self.accept_kw("SET"):
                sets.extend(self._parse_set_items())
            else:
                break
        return ast.ConstructClause(tuple(on), tuple(clones), tuple(news), tuple(sets))

    # -- projection ---------------------------------------------------------

    def _parse_projection_body(self) -> ast.ProjectionBody:
        distinct = self.accept_kw("DISTINCT")
        star = False
        items: List[ast.ReturnItem] = []
        if self.accept_sym("*"):
            star = True
            while self.accept_sym(","):
                items.append(self._parse_return_item())
        else:
            items.append(self._parse_return_item())
            while self.accept_sym(","):
                items.append(self._parse_return_item())
        order_by: List[ast.OrderItem] = []
        if self.at_kw("ORDER"):
            self.advance()
            self.expect_kw("BY")
            while True:
                expr = self.parse_expr()
                asc = True
                if self.accept_kw("DESC", "DESCENDING"):
                    asc = False
                else:
                    self.accept_kw("ASC", "ASCENDING")
                order_by.append(ast.OrderItem(expr, asc))
                if not self.accept_sym(","):
                    break
        skip = self.parse_expr() if self.accept_kw("SKIP") else None
        limit = self.parse_expr() if self.accept_kw("LIMIT") else None
        return ast.ProjectionBody(tuple(items), star, distinct, tuple(order_by), skip, limit)

    def _parse_return_item(self) -> ast.ReturnItem:
        expr = self.parse_expr()
        alias = None
        if self.accept_kw("AS"):
            alias = self.ident_like("alias")
        return ast.ReturnItem(expr, alias)

    # -- patterns -----------------------------------------------------------

    def parse_pattern(self) -> ast.Pattern:
        parts = [self._parse_pattern_part()]
        while self.accept_sym(","):
            parts.append(self._parse_pattern_part())
        return ast.Pattern(tuple(parts))

    def _parse_pattern_part(self) -> ast.PatternPart:
        path_var = None
        if self.peek().kind == IDENT and self.peek(1).kind == SYM and self.peek(1).text == "=":
            path_var = self.advance().text
            self.advance()  # '='
        elements: List = [self._parse_node_pattern()]
        while self.at_sym("-", "<-"):
            rel = self._parse_rel_pattern()
            node = self._parse_node_pattern()
            elements.extend([rel, node])
        return ast.PatternPart(tuple(elements), path_var)

    def _parse_node_pattern(self) -> ast.NodePattern:
        self.expect_sym("(")
        var = None
        t = self.peek()
        if t.kind == IDENT:
            var = self.advance().text
        labels: List[str] = []
        while self.accept_sym(":"):
            labels.append(self.ident_like("label"))
        props = None
        if self.at_sym("{"):
            props = self._parse_map_literal()
        elif self.at_sym("$"):
            props = self._parse_parameter()
        self.expect_sym(")")
        return ast.NodePattern(var, tuple(labels), props)

    def _parse_rel_pattern(self) -> ast.RelPattern:
        if self.accept_sym("<-"):
            direction = ast.Direction.INCOMING
        else:
            self.expect_sym("-")
            direction = None  # decided by the closing arrow
        var = None
        rel_types: List[str] = []
        props = None
        var_length = None
        if self.accept_sym("["):
            if self.peek().kind == IDENT and not self.at_sym(":"):
                var = self.advance().text
            if self.accept_sym(":"):
                rel_types.append(self.ident_like("relationship type"))
                while self.accept_sym("|"):
                    self.accept_sym(":")  # tolerate `|:TYPE` form
                    rel_types.append(self.ident_like("relationship type"))
            if self.accept_sym("*"):
                var_length = self._parse_range()
            if self.at_sym("{"):
                props = self._parse_map_literal()
            elif self.at_sym("$"):
                props = self._parse_parameter()
            self.expect_sym("]")
        if self.accept_sym("->"):
            if direction is None:
                direction = ast.Direction.OUTGOING
            else:
                raise self.error("relationship cannot point both ways")
        else:
            self.expect_sym("-")
            if direction is None:
                direction = ast.Direction.BOTH
        return ast.RelPattern(var, tuple(rel_types), props, direction, var_length)

    def _parse_range(self) -> Tuple[int, Optional[int]]:
        """After `*`: [n][..[m]] — `*`→(1,None), `*2`→(2,2), `*1..3`→(1,3),
        `*..3`→(1,3), `*2..`→(2,None)."""
        lower = 1
        upper: Optional[int] = None
        fixed = None
        if self.peek().kind == INT:
            fixed = int(self.advance().value)
            lower = fixed
        if self.accept_sym(".."):
            if self.peek().kind == INT:
                upper = int(self.advance().value)
        elif fixed is not None:
            upper = fixed
        return (lower, upper)

    # -- expressions (precedence climbing) ----------------------------------

    def parse_expr(self) -> E.Expr:
        return self._parse_or()

    def _parse_or(self) -> E.Expr:
        terms = [self._parse_xor()]
        while self.accept_kw("OR"):
            terms.append(self._parse_xor())
        return terms[0] if len(terms) == 1 else E.Ors(tuple(terms))

    def _parse_xor(self) -> E.Expr:
        out = self._parse_and()
        while self.accept_kw("XOR"):
            out = E.Xor(out, self._parse_and())
        return out

    def _parse_and(self) -> E.Expr:
        terms = [self._parse_not()]
        while self.accept_kw("AND"):
            terms.append(self._parse_not())
        return terms[0] if len(terms) == 1 else E.Ands(tuple(terms))

    def _parse_not(self) -> E.Expr:
        if self.accept_kw("NOT"):
            return E.Not(self._parse_not())
        return self._parse_comparison()

    _COMPARISONS = {
        "=": E.Equals, "<>": E.NotEquals, "<": E.LessThan, "<=": E.LessThanOrEqual,
        ">": E.GreaterThan, ">=": E.GreaterThanOrEqual,
    }

    def _parse_comparison(self) -> E.Expr:
        lhs = self._parse_add_sub()
        comparisons: List[E.Expr] = []
        while True:
            t = self.peek()
            if t.kind == SYM and t.text in self._COMPARISONS:
                self.advance()
                rhs = self._parse_add_sub()
                comparisons.append(self._COMPARISONS[t.text](lhs, rhs))
                lhs = rhs
                continue
            if t.kind == SYM and t.text == "=~":
                self.advance()
                comparisons.append(E.RegexMatch(lhs, self._parse_add_sub()))
                continue
            if self.at_kw("IN"):
                self.advance()
                comparisons.append(E.In(lhs, self._parse_add_sub()))
                continue
            if self.at_kw("STARTS"):
                self.advance()
                self.expect_kw("WITH")
                comparisons.append(E.StartsWith(lhs, self._parse_add_sub()))
                continue
            if self.at_kw("ENDS"):
                self.advance()
                self.expect_kw("WITH")
                comparisons.append(E.EndsWith(lhs, self._parse_add_sub()))
                continue
            if self.at_kw("CONTAINS"):
                self.advance()
                comparisons.append(E.Contains(lhs, self._parse_add_sub()))
                continue
            if self.at_kw("IS"):
                self.advance()
                if self.accept_kw("NOT"):
                    self.expect_kw("NULL")
                    comparisons.append(E.IsNotNull(lhs))
                else:
                    self.expect_kw("NULL")
                    comparisons.append(E.IsNull(lhs))
                continue
            break
        if not comparisons:
            return lhs
        if len(comparisons) == 1:
            return comparisons[0]
        return E.Ands(tuple(comparisons))  # chained comparison: a < b < c

    def _parse_add_sub(self) -> E.Expr:
        out = self._parse_mul_div()
        while True:
            if self.accept_sym("+"):
                out = E.Add(out, self._parse_mul_div())
            elif self.accept_sym("-"):
                out = E.Subtract(out, self._parse_mul_div())
            else:
                return out

    def _parse_mul_div(self) -> E.Expr:
        out = self._parse_power()
        while True:
            if self.accept_sym("*"):
                out = E.Multiply(out, self._parse_power())
            elif self.accept_sym("/"):
                out = E.Divide(out, self._parse_power())
            elif self.accept_sym("%"):
                out = E.Modulo(out, self._parse_power())
            else:
                return out

    def _parse_power(self) -> E.Expr:
        base = self._parse_unary()
        if self.accept_sym("^"):
            return E.Power(base, self._parse_power())  # right-assoc
        return base

    def _parse_unary(self) -> E.Expr:
        if self.accept_sym("-"):
            inner = self._parse_unary()
            if isinstance(inner, E.Lit) and isinstance(inner.value, (int, float)):
                return E.Lit(-inner.value)
            return E.Negate(inner)
        if self.accept_sym("+"):
            return self._parse_unary()
        return self._parse_postfix()

    def _parse_postfix(self) -> E.Expr:
        out = self._parse_atom()
        while True:
            if self.at_sym(".") :
                self.advance()
                out = E.Property(out, self.ident_like("property key"))
            elif self.at_sym("["):
                self.advance()
                lower: Optional[E.Expr] = None
                if not self.at_sym(".."):
                    lower = self.parse_expr()
                if self.accept_sym(".."):
                    upper = None if self.at_sym("]") else self.parse_expr()
                    out = E.Slice(out, lower, upper)
                else:
                    assert lower is not None
                    out = E.Index(out, lower)
                self.expect_sym("]")
            elif self.at_sym(":") and isinstance(out, E.Var):
                # label predicate in expression position: n:Person[:More]*
                checks: List[E.Expr] = []
                while self.accept_sym(":"):
                    checks.append(E.HasLabel(out, self.ident_like("label")))
                out = checks[0] if len(checks) == 1 else E.Ands(tuple(checks))
            else:
                return out

    def _parse_parameter(self) -> E.Param:
        self.expect_sym("$")
        t = self.peek()
        if t.kind == INT:
            self.advance()
            return E.Param(t.text)
        return E.Param(self.ident_like("parameter name"))

    def _parse_map_literal(self) -> E.MapLit:
        self.expect_sym("{")
        keys: List[str] = []
        values: List[E.Expr] = []
        if not self.at_sym("}"):
            while True:
                keys.append(self.ident_like("map key"))
                self.expect_sym(":")
                values.append(self.parse_expr())
                if not self.accept_sym(","):
                    break
        self.expect_sym("}")
        return E.MapLit(tuple(keys), tuple(values))

    def _parse_list_atom(self) -> E.Expr:
        """`[` already peeked: list literal or list comprehension."""
        self.expect_sym("[")
        if self.at_sym("]"):
            self.advance()
            return E.ListLit(())
        # Lookahead for comprehension: IDENT IN ...
        if self.peek().kind == IDENT and self.peek(1).kind == KEYWORD \
                and self.peek(1).text == "IN":
            var = self.advance().text
            self.advance()  # IN
            list_expr = self._parse_or()
            predicate = self.parse_expr() if self.accept_kw("WHERE") else None
            projection = None
            if self.accept_sym("|"):
                projection = self.parse_expr()
            self.expect_sym("]")
            return E.ListComprehension(var, list_expr, predicate, projection)
        items = [self.parse_expr()]
        while self.accept_sym(","):
            items.append(self.parse_expr())
        self.expect_sym("]")
        return E.ListLit(tuple(items))

    def _parse_case(self) -> E.Expr:
        """CASE [e] WHEN c THEN v ... [ELSE d] END; the simple form is
        normalized to searched form with equality conditions."""
        subject: Optional[E.Expr] = None
        if not self.at_kw("WHEN"):
            subject = self.parse_expr()
        conditions: List[E.Expr] = []
        values: List[E.Expr] = []
        while self.accept_kw("WHEN"):
            cond = self.parse_expr()
            if subject is not None:
                cond = E.Equals(subject, cond)
            self.expect_kw("THEN")
            conditions.append(cond)
            values.append(self.parse_expr())
        if not conditions:
            raise self.error("CASE requires at least one WHEN")
        default = self.parse_expr() if self.accept_kw("ELSE") else None
        self.expect_kw("END")
        return E.CaseExpr(tuple(conditions), tuple(values), default)

    def _parse_function_call(self, name: str) -> E.Expr:
        """After `name(`."""
        lname = name.lower()
        if lname in ("all", "any", "none", "single", "filter", "extract",
                     "reduce"):
            return self._parse_iterable_call(lname)
        distinct = self.accept_kw("DISTINCT")
        args: List[E.Expr] = []
        if self.at_sym("*") and lname == "count":
            self.advance()
            self.expect_sym(")")
            return E.CountStar()
        if not self.at_sym(")"):
            args.append(self.parse_expr())
            while self.accept_sym(","):
                args.append(self.parse_expr())
        self.expect_sym(")")
        if distinct and lname not in E.AGGREGATOR_NAMES:
            raise self.error(f"DISTINCT is only valid in aggregations, not {name}()")
        if lname in E.AGGREGATOR_NAMES:
            return self._make_aggregator(lname, args, distinct)
        if lname == "exists":
            if len(args) != 1:
                raise self.error("exists() takes exactly one argument")
            return E.Exists(args[0])
        if lname == "coalesce":
            return E.Coalesce(tuple(args))
        if lname == "id":
            return E.Id(args[0])
        if lname == "labels":
            return E.Labels(args[0])
        if lname == "type":
            return E.Type(args[0])
        if lname == "startnode":
            return E.StartNode(args[0])
        if lname == "endnode":
            return E.EndNode(args[0])
        if lname == "keys":
            return E.Keys(args[0])
        if lname == "properties":
            return E.Properties(args[0])
        return E.FunctionExpr(lname, tuple(args))

    def _parse_iterable_call(self, lname: str) -> E.Expr:
        """After `all(`/`any(`/`none(`/`single(`/`filter(`/`extract(`/
        `reduce(`: the iterable-predicate forms ``f(var IN list WHERE p)``
        and ``reduce(acc = init, var IN list | expr)``."""
        if lname == "reduce":
            acc = self.ident_like("accumulator")
            self.expect_sym("=")
            init = self.parse_expr()
            self.expect_sym(",")
            var = self.ident_like("variable")
            self.expect_kw("IN")
            list_expr = self._parse_or()
            self.expect_sym("|")
            expr = self.parse_expr()
            self.expect_sym(")")
            return E.Reduce(acc, init, var, list_expr, expr)
        var = self.ident_like("variable")
        self.expect_kw("IN")
        list_expr = self._parse_or()
        predicate = self.parse_expr() if self.accept_kw("WHERE") else None
        projection = None
        if lname == "extract" and self.accept_sym("|"):
            projection = self.parse_expr()
        self.expect_sym(")")
        if lname == "extract":
            return E.ListComprehension(var, list_expr, predicate, projection)
        if predicate is None:
            raise self.error(f"{lname}(...) requires a WHERE predicate")
        if lname == "filter":
            return E.ListComprehension(var, list_expr, predicate, None)
        return E.QuantifiedPredicate(lname, var, list_expr, predicate)

    def _make_aggregator(self, lname: str, args: List[E.Expr], distinct: bool) -> E.Expr:
        def one() -> E.Expr:
            if len(args) != 1:
                raise self.error(f"{lname}() takes exactly one argument")
            return args[0]

        if lname == "count":
            return E.Count(one(), distinct)
        if lname == "sum":
            return E.Sum(one(), distinct)
        if lname == "avg":
            return E.Avg(one(), distinct)
        if lname == "min":
            return E.Min(one())
        if lname == "max":
            return E.Max(one())
        if lname == "collect":
            return E.Collect(one(), distinct)
        if lname == "stdev":
            return E.StDev(one())
        if lname in ("percentilecont", "percentiledisc"):
            if len(args) != 2:
                raise self.error(f"{lname}() takes two arguments")
            cls = E.PercentileCont if lname == "percentilecont" else E.PercentileDisc
            return cls(args[0], args[1], distinct)
        raise self.error(f"unknown aggregator {lname}")

    def _parse_atom(self) -> E.Expr:
        t = self.peek()
        if t.kind == INT or t.kind == FLOAT:
            self.advance()
            return E.Lit(t.value)
        if t.kind == STRING:
            self.advance()
            return E.Lit(t.value)
        if t.kind == KEYWORD:
            if t.text == "TRUE":
                self.advance()
                return E.TRUE
            if t.text == "FALSE":
                self.advance()
                return E.FALSE
            if t.text == "NULL":
                self.advance()
                return E.NULL
            if t.text == "CASE":
                self.advance()
                return self._parse_case()
            if t.text in ("COUNT",):
                # COUNT is not a keyword in our lexer; defensive only.
                pass
        if self.at_sym("$"):
            return self._parse_parameter()
        if self.at_sym("["):
            return self._parse_list_atom()
        if self.at_sym("{"):
            return self._parse_map_literal()
        if self.at_sym("("):
            self.advance()
            inner = self.parse_expr()
            self.expect_sym(")")
            return inner
        if t.kind == IDENT:
            if t.text.upper() == "EXISTS" and self.peek(1).kind == SYM \
                    and self.peek(1).text == "{":
                self.advance()  # EXISTS
                self.advance()  # {
                self.accept_kw("MATCH")  # the MATCH keyword is optional
                pattern = self.parse_pattern()
                where = self.parse_expr() if self.accept_kw("WHERE") else None
                self.expect_sym("}")
                return E.ExistsSubQuery(pattern, where)
            if self.peek(1).kind == SYM and self.peek(1).text == "(":
                name = self.advance().text
                self.advance()  # '('
                return self._parse_function_call(name)
            self.advance()
            return E.Var(t.text)
        # Function-style keywords (e.g. `exists(` after keyword promotion)
        if t.kind == KEYWORD and self.peek(1).kind == SYM and self.peek(1).text == "(":
            name = str(self.advance().value)
            self.advance()
            return self._parse_function_call(name)
        raise self.error(f"unexpected token {t.text or 'end of input'!r} in expression")


@functools.lru_cache(maxsize=512)
def _parse_memo(query: str) -> ast.Statement:
    return CypherParser(query).parse_statement()


def parse_query(query: str, memo: bool = True) -> ast.Statement:
    """Parse a Cypher statement into the clause AST.

    Parses are memoized per query text (the AST is a frozen tree, shared
    safely across sessions); the memo is the first stage of the prepared
    -statement fast path (relational/plan_cache.py).  ``memo=False``
    forces a fresh parse (tests of the parser itself)."""
    if memo:
        return _parse_memo(query)
    return CypherParser(query).parse_statement()


@functools.lru_cache(maxsize=2048)
def query_mode(query: str) -> Tuple[Optional[str], str]:
    """Split an ``EXPLAIN`` / ``PROFILE`` prefix off a query.

    Returns ``(mode, body)`` where ``mode`` is ``'explain'``,
    ``'profile'``, or None, and ``body`` is the query text with the
    prefix removed (byte-exact tail of the original, so downstream
    cache keys — plan cache, fused executor — are identical to the
    un-prefixed query's; a PROFILE run can therefore HIT the plan cache
    entry a plain run stored, and vice versa).  Token-level detection:
    leading comments/whitespace are handled, and unlexable text passes
    through for the parser to report."""
    try:
        toks = tokenize(query)
    except CypherSyntaxError:
        return None, query
    if toks and toks[0].kind == IDENT and toks[0].text.upper() in QUERY_MODES:
        mode = toks[0].text.lower()
        body = query[toks[1].pos:] if len(toks) > 1 and \
            toks[1].kind != EOF else ""
        return mode, body
    return None, query


@functools.lru_cache(maxsize=2048)
def normalize_query(query: str) -> str:
    """Token-level normal form of a query, safe as a plan-cache key:
    whitespace and comments drop, keywords are case-folded (the lexer
    upper-cases them), but string literals keep their EXACT parsed value
    — naive whitespace collapsing would merge ``'a  b'`` with ``'a b'``
    and serve wrong plans.  Unlexable text falls back to itself (the
    parse will raise the real error downstream)."""
    try:
        toks = tokenize(query)
    except CypherSyntaxError:
        return query
    parts = []
    for t in toks:
        if t.kind == EOF:
            break
        if t.kind in (STRING, INT, FLOAT):
            parts.append(f"{t.kind}:{t.value!r}")
        else:
            parts.append(f"{t.kind}:{t.text}")
    return " ".join(parts)
