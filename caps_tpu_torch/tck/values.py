"""TCK result-table value literals.

Parses the value syntax used in openCypher TCK expected-result tables —
integers, floats, strings, booleans, null, lists, maps, node literals
``(:L1:L2 {k: v})`` and relationship literals ``[:T {k: v}]`` — into
Python values / structural matchers comparable against engine output
(ref: opencypher TCK tck-api value model — reconstructed; SURVEY.md §4.3).
"""
from __future__ import annotations

import dataclasses
from typing import Any, Dict, List, Tuple

from caps_tpu_torch.okapi.values import (
    CypherNode, CypherPath, CypherRelationship,
)


@dataclasses.dataclass(frozen=True)
class NodeMatcher:
    """Structural node expectation: labels + properties (TCK compares
    nodes structurally, not by id)."""
    labels: Tuple[str, ...]
    properties: Tuple[Tuple[str, Any], ...]

    def matches(self, v: Any) -> bool:
        return (isinstance(v, CypherNode)
                and tuple(sorted(v.labels)) == self.labels
                and values_equal(dict(self.properties), dict(v.properties)))

    def __repr__(self):
        lbl = "".join(f":{l}" for l in self.labels)
        props = ", ".join(f"{k}: {v!r}" for k, v in self.properties)
        return f"({lbl} {{{props}}})" if props else f"({lbl})"


@dataclasses.dataclass(frozen=True)
class RelMatcher:
    rel_type: str
    properties: Tuple[Tuple[str, Any], ...]

    def matches(self, v: Any) -> bool:
        return (isinstance(v, CypherRelationship)
                and v.rel_type == self.rel_type
                and values_equal(dict(self.properties), dict(v.properties)))

    def __repr__(self):
        props = ", ".join(f"{k}: {v!r}" for k, v in self.properties)
        return f"[:{self.rel_type}" + (f" {{{props}}}]" if props else "]")


@dataclasses.dataclass(frozen=True)
class PathMatcher:
    """Structural path expectation ``<(:A)-[:T]->(:B)>``: node/rel matchers
    in order plus per-hop direction (True = forward as written)."""
    nodes: Tuple[NodeMatcher, ...]
    rels: Tuple[RelMatcher, ...]
    forward: Tuple[bool, ...]

    def matches(self, v: Any) -> bool:
        if not isinstance(v, CypherPath):
            return False
        if len(v.nodes) != len(self.nodes) or len(v.rels) != len(self.rels):
            return False
        if not all(m.matches(n) for m, n in zip(self.nodes, v.nodes)):
            return False
        for i, (m, r) in enumerate(zip(self.rels, v.rels)):
            if not m.matches(r):
                return False
            prev, nxt = v.nodes[i].id, v.nodes[i + 1].id
            want = (prev, nxt) if self.forward[i] else (nxt, prev)
            if (r.start, r.end) != want:
                return False
        return True

    def __repr__(self):
        parts = [repr(self.nodes[0])]
        for i, r in enumerate(self.rels):
            arrow = f"-{r!r}->" if self.forward[i] else f"<-{r!r}-"
            parts.append(arrow)
            parts.append(repr(self.nodes[i + 1]))
        return "<" + "".join(parts) + ">"


def values_equal(expected: Any, actual: Any) -> bool:
    """Structural equality between a parsed TCK value and an engine value.
    Booleans are distinct from integers (Cypher has no bool/int coercion)."""
    if isinstance(expected, (NodeMatcher, RelMatcher, PathMatcher)):
        return expected.matches(actual)
    if expected is None or actual is None:
        return expected is None and actual is None
    if isinstance(expected, bool) or isinstance(actual, bool):
        return isinstance(expected, bool) and isinstance(actual, bool) \
            and expected == actual
    if isinstance(expected, float) or isinstance(actual, float):
        if not isinstance(actual, (int, float)) or isinstance(actual, bool):
            return False
        if not isinstance(expected, (int, float)):
            return False
        return abs(float(expected) - float(actual)) <= 1e-9 * max(
            1.0, abs(float(expected)), abs(float(actual)))
    if isinstance(expected, list):
        return (isinstance(actual, (list, tuple)) and
                len(expected) == len(actual) and
                all(values_equal(e, a) for e, a in zip(expected, actual)))
    if isinstance(expected, dict):
        return (isinstance(actual, dict) and
                set(expected) == set(actual) and
                all(values_equal(v, actual[k]) for k, v in expected.items()))
    return type(expected) == type(actual) and expected == actual


class _Parser:
    def __init__(self, text: str):
        self.text = text
        self.pos = 0

    def error(self, msg: str) -> ValueError:
        return ValueError(f"TCK value parse error at {self.pos} in "
                          f"{self.text!r}: {msg}")

    def skip_ws(self):
        while self.pos < len(self.text) and self.text[self.pos] in " \t":
            self.pos += 1

    def peek(self) -> str:
        return self.text[self.pos] if self.pos < len(self.text) else ""

    def expect(self, ch: str):
        if self.peek() != ch:
            raise self.error(f"expected {ch!r}, found {self.peek()!r}")
        self.pos += 1

    def accept(self, ch: str) -> bool:
        if self.peek() == ch:
            self.pos += 1
            return True
        return False

    def parse(self) -> Any:
        self.skip_ws()
        v = self.value()
        self.skip_ws()
        if self.pos != len(self.text):
            raise self.error("trailing input")
        return v

    def value(self) -> Any:
        self.skip_ws()
        c = self.peek()
        if c == "'":
            return self.string()
        if c == "[":
            return self.bracket()
        if c == "{":
            return self.map_literal()
        if c == "(":
            return self.node()
        if c == "<":
            return self.path()
        if c.isdigit() or c == "-":
            return self.number()
        return self.word()

    def path(self) -> "PathMatcher":
        self.expect("<")
        self.skip_ws()
        nodes = [self.node()]
        rels: List[RelMatcher] = []
        forward: List[bool] = []
        while True:
            self.skip_ws()
            if self.accept(">"):
                return PathMatcher(tuple(nodes), tuple(rels), tuple(forward))
            if self.accept("<"):  # <-[:T]-
                self.expect("-")
                self.skip_ws()
                rel = self.bracket_rel()
                self.skip_ws()
                self.expect("-")
                forward.append(False)
            else:                 # -[:T]->
                self.expect("-")
                self.skip_ws()
                rel = self.bracket_rel()
                self.skip_ws()
                self.expect("-")
                self.expect(">")
                forward.append(True)
            rels.append(rel)
            self.skip_ws()
            nodes.append(self.node())

    def bracket_rel(self) -> "RelMatcher":
        v = self.bracket()
        if not isinstance(v, RelMatcher):
            raise self.error("expected a relationship in path")
        return v

    def string(self) -> str:
        self.expect("'")
        out = []
        while True:
            if self.pos >= len(self.text):
                raise self.error("unterminated string")
            c = self.text[self.pos]
            self.pos += 1
            if c == "\\":
                out.append(self.text[self.pos])
                self.pos += 1
            elif c == "'":
                return "".join(out)
            else:
                out.append(c)

    def number(self) -> Any:
        start = self.pos
        if self.accept("-"):
            pass
        while self.peek().isdigit():
            self.pos += 1
        is_float = False
        if self.peek() == "." and self.pos + 1 < len(self.text) \
                and self.text[self.pos + 1].isdigit():
            is_float = True
            self.pos += 1
            while self.peek().isdigit():
                self.pos += 1
        if self.peek() and self.peek() in "eE":
            is_float = True
            self.pos += 1
            if self.peek() and self.peek() in "+-":
                self.pos += 1
            while self.peek().isdigit():
                self.pos += 1
        text = self.text[start:self.pos]
        return float(text) if is_float else int(text)

    def word(self) -> Any:
        start = self.pos
        while self.peek().isalnum() or self.peek() == "_":
            self.pos += 1
        w = self.text[start:self.pos]
        if w == "null":
            return None
        if w == "true":
            return True
        if w == "false":
            return False
        raise self.error(f"unknown literal {w!r}")

    def bracket(self) -> Any:
        # list [1, 2] or relationship [:T {...}]
        self.expect("[")
        self.skip_ws()
        if self.peek() == ":":
            self.pos += 1
            rel_type = self.identifier()
            props: Dict[str, Any] = {}
            self.skip_ws()
            if self.peek() == "{":
                props = self.map_literal()
            self.skip_ws()
            self.expect("]")
            return RelMatcher(rel_type, tuple(sorted(props.items())))
        items: List[Any] = []
        if not self.accept("]"):
            while True:
                items.append(self.value())
                self.skip_ws()
                if self.accept("]"):
                    break
                self.expect(",")
        return items

    def identifier(self) -> str:
        start = self.pos
        while self.peek().isalnum() or self.peek() == "_":
            self.pos += 1
        if start == self.pos:
            raise self.error("expected identifier")
        return self.text[start:self.pos]

    def map_literal(self) -> Dict[str, Any]:
        self.expect("{")
        out: Dict[str, Any] = {}
        self.skip_ws()
        if self.accept("}"):
            return out
        while True:
            self.skip_ws()
            key = self.identifier()
            self.skip_ws()
            self.expect(":")
            out[key] = self.value()
            self.skip_ws()
            if self.accept("}"):
                return out
            self.expect(",")

    def node(self) -> NodeMatcher:
        self.expect("(")
        labels: List[str] = []
        self.skip_ws()
        while self.peek() == ":":
            self.pos += 1
            labels.append(self.identifier())
            self.skip_ws()
        props: Dict[str, Any] = {}
        if self.peek() == "{":
            props = self.map_literal()
        self.skip_ws()
        self.expect(")")
        return NodeMatcher(tuple(sorted(labels)), tuple(sorted(props.items())))


def parse_value(cell: str) -> Any:
    return _Parser(cell.strip()).parse()
