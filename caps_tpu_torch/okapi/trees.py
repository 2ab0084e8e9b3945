"""Immutable tree nodes with structural rewriting.

The substrate under every expression / plan tree in the engine, mirroring the
role of ``TreeNode``/``AbstractTreeNode`` + ``BottomUp``/``TopDown`` rewriters
in the reference (ref: okapi-trees/.../trees/TreeNode.scala,
BottomUp.scala, TopDown.scala — reconstructed, mount empty; SURVEY.md §2).

Python adaptation: nodes are frozen dataclasses.  Children are discovered
structurally — any dataclass field whose value is a ``TreeNode`` or a
tuple containing ``TreeNode``s contributes children, in field order (use
tuples, not sets, for child collections — sets are not traversed).  ``rewrite`` applied bottom-up / top-down rebuilds nodes via
``dataclasses.replace`` only when a child actually changed, preserving
sharing like the reference's rewriters.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable, Iterator, Tuple, TypeVar

T = TypeVar("T", bound="TreeNode")


@dataclasses.dataclass(frozen=True)
class TreeNode:
    """Base class for immutable trees with generic traversal and rewriting."""

    @property
    def children(self) -> Tuple["TreeNode", ...]:
        out = []
        for f in dataclasses.fields(self):
            v = getattr(self, f.name)
            if isinstance(v, TreeNode):
                out.append(v)
            elif isinstance(v, tuple):
                out.extend(c for c in v if isinstance(c, TreeNode))
        return tuple(out)

    def map_children(self: T, fn: Callable[["TreeNode"], "TreeNode"]) -> T:
        """Rebuild this node with ``fn`` applied to every direct child."""
        changes = {}
        for f in dataclasses.fields(self):
            v = getattr(self, f.name)
            if isinstance(v, TreeNode):
                nv = fn(v)
                if nv is not v:
                    changes[f.name] = nv
            elif isinstance(v, tuple) and any(isinstance(c, TreeNode) for c in v):
                nvs = tuple(fn(c) if isinstance(c, TreeNode) else c for c in v)
                if any(a is not b for a, b in zip(v, nvs)):
                    changes[f.name] = nvs
        if not changes:
            return self
        return dataclasses.replace(self, **changes)

    # -- traversal ----------------------------------------------------------

    def walk(self) -> Iterator["TreeNode"]:
        """Pre-order traversal of this subtree (self first)."""
        stack = [self]
        while stack:
            node = stack.pop()
            yield node
            stack.extend(reversed(node.children))

    def exists(self, pred: Callable[["TreeNode"], bool]) -> bool:
        return any(pred(n) for n in self.walk())

    def collect(self, pred: Callable[["TreeNode"], bool]) -> Tuple["TreeNode", ...]:
        return tuple(n for n in self.walk() if pred(n))

    @property
    def height(self) -> int:
        kids = self.children
        return 1 + (max(k.height for k in kids) if kids else 0)

    @property
    def size(self) -> int:
        return sum(1 for _ in self.walk())

    # -- rewriting (ref: BottomUp / TopDown rewriters) ----------------------

    def transform_up(self: T, rule: Callable[["TreeNode"], "TreeNode"]) -> "TreeNode":
        """Bottom-up rewrite: children first, then ``rule`` on the rebuilt node."""
        rebuilt = self.map_children(lambda c: c.transform_up(rule))
        return rule(rebuilt)

    def transform_down(self: T, rule: Callable[["TreeNode"], "TreeNode"]) -> "TreeNode":
        """Top-down rewrite: ``rule`` on this node first, then recurse."""
        replaced = rule(self)
        return replaced.map_children(lambda c: c.transform_down(rule))

    # -- pretty printing (ref: TreeNode#pretty) -----------------------------

    def args_string(self) -> str:
        parts = []
        for f in dataclasses.fields(self):
            v = getattr(self, f.name)
            if isinstance(v, TreeNode):
                continue
            if isinstance(v, tuple) and any(isinstance(c, TreeNode) for c in v):
                continue
            parts.append(f"{f.name}={v!r}")
        return ", ".join(parts)

    def pretty(self, _depth: int = 0) -> str:
        lines = [("    " * _depth) + ("└─" if _depth else "") +
                 f"{type(self).__name__}({self.args_string()})"]
        for c in self.children:
            lines.append(c.pretty(_depth + 1))
        return "\n".join(lines)

    def __str__(self) -> str:
        return f"{type(self).__name__}({self.args_string()})"
