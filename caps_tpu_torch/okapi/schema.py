"""Property graph schema: label combinations and relationship types mapped to
property keys/types, with implicit schema union.

Mirrors the reference's ``Schema``/``SchemaImpl``/``PropertyKeys`` and the
``withNodePropertyKeys`` / ``withRelationshipPropertyKeys`` / ``++`` API
(ref: okapi-api/.../api/schema/Schema.scala — reconstructed, mount empty;
SURVEY.md §2 "Schema").

A node schema is keyed by the *exact label combination* of a node (the
reference's core modeling decision: one scan table per label-combo).  Asking
for the property keys of ``CTNode({"Person"})`` unions over every combo
containing ``Person``: property types join, and a key missing from some
combo becomes nullable.
"""
from __future__ import annotations

from typing import Dict, FrozenSet, Iterable, Mapping, Optional, Tuple

from caps_tpu_torch.okapi.types import CTNull, CypherType

PropertyKeys = Dict[str, CypherType]
LabelCombo = FrozenSet[str]


def _merge_keys(a: Mapping[str, CypherType], b: Mapping[str, CypherType]) -> PropertyKeys:
    """Join property-key maps: shared keys join types; one-sided keys go
    nullable (a row from the other side has null there)."""
    out: PropertyKeys = {}
    for k in set(a) | set(b):
        ta = a.get(k)
        tb = b.get(k)
        if ta is None:
            out[k] = tb.nullable  # type: ignore[union-attr]
        elif tb is None:
            out[k] = ta.nullable
        else:
            out[k] = ta.join(tb)
    return out


class Schema:
    """Immutable property-graph schema."""

    def __init__(
        self,
        label_property_keys: Optional[Mapping[LabelCombo, PropertyKeys]] = None,
        rel_type_property_keys: Optional[Mapping[str, PropertyKeys]] = None,
    ):
        self._nodes: Dict[LabelCombo, PropertyKeys] = {
            frozenset(k): dict(v) for k, v in (label_property_keys or {}).items()
        }
        self._rels: Dict[str, PropertyKeys] = {
            k: dict(v) for k, v in (rel_type_property_keys or {}).items()
        }

    # -- construction -------------------------------------------------------

    @staticmethod
    def empty() -> "Schema":
        return Schema()

    def with_node_property_keys(
        self, labels: Iterable[str] = (), keys: Optional[Mapping[str, CypherType]] = None
    ) -> "Schema":
        combo = frozenset([labels] if isinstance(labels, str) else labels)
        nodes = dict(self._nodes)
        existing = nodes.get(combo)
        nodes[combo] = _merge_keys(existing, keys or {}) if existing is not None else dict(keys or {})
        return Schema(nodes, self._rels)

    def with_relationship_property_keys(
        self, rel_type: str, keys: Optional[Mapping[str, CypherType]] = None
    ) -> "Schema":
        rels = dict(self._rels)
        existing = rels.get(rel_type)
        rels[rel_type] = _merge_keys(existing, keys or {}) if existing is not None else dict(keys or {})
        return Schema(self._nodes, rels)

    def union(self, other: "Schema") -> "Schema":
        """The reference's ``++``: schemas of unioned graphs."""
        nodes = dict(self._nodes)
        for combo, keys in other._nodes.items():
            nodes[combo] = _merge_keys(nodes[combo], keys) if combo in nodes else dict(keys)
        rels = dict(self._rels)
        for rt, keys in other._rels.items():
            rels[rt] = _merge_keys(rels[rt], keys) if rt in rels else dict(keys)
        return Schema(nodes, rels)

    __add__ = union

    # -- queries ------------------------------------------------------------

    @property
    def labels(self) -> FrozenSet[str]:
        out: set = set()
        for combo in self._nodes:
            out |= combo
        return frozenset(out)

    @property
    def label_combinations(self) -> Tuple[LabelCombo, ...]:
        return tuple(self._nodes.keys())

    @property
    def relationship_types(self) -> FrozenSet[str]:
        return frozenset(self._rels.keys())

    def combinations_for(self, known_labels: Iterable[str]) -> Tuple[LabelCombo, ...]:
        """All label combos containing every label in ``known_labels``."""
        known = frozenset(known_labels)
        return tuple(c for c in self._nodes if known <= c)

    def node_property_keys(self, labels: Iterable[str] = ()) -> PropertyKeys:
        """Property keys/types of ``CTNode(labels)``: union over matching
        combos; keys absent from some combo become nullable."""
        combos = self.combinations_for(labels)
        if not combos:
            return {}
        out = dict(self._nodes[combos[0]])
        for combo in combos[1:]:
            out = _merge_keys(out, self._nodes[combo])
        return out

    def node_property_type(self, labels: Iterable[str], key: str) -> CypherType:
        return self.node_property_keys(labels).get(key, CTNull)

    def property_keys_for_combo(self, combo: Iterable[str]) -> PropertyKeys:
        return dict(self._nodes.get(frozenset(combo), {}))

    def relationship_property_keys(self, rel_types: Iterable[str] = ()) -> PropertyKeys:
        types = frozenset(rel_types) or self.relationship_types
        present = [t for t in types if t in self._rels]
        if not present:
            return {}
        out = dict(self._rels[present[0]])
        for t in present[1:]:
            out = _merge_keys(out, self._rels[t])
        return out

    def relationship_property_type(self, rel_types: Iterable[str], key: str) -> CypherType:
        return self.relationship_property_keys(rel_types).get(key, CTNull)

    # -- dunder -------------------------------------------------------------

    def __eq__(self, other):
        return (isinstance(other, Schema) and self._nodes == other._nodes
                and self._rels == other._rels)

    def __hash__(self):
        return hash((
            tuple(sorted((tuple(sorted(c)), tuple(sorted(k.items(), key=lambda kv: kv[0])))
                         for c, k in self._nodes.items())),
            tuple(sorted((t, tuple(sorted(k.items(), key=lambda kv: kv[0])))
                         for t, k in self._rels.items())),
        ))

    def __repr__(self):
        lines = ["Schema("]
        for combo in sorted(self._nodes, key=lambda c: tuple(sorted(c))):
            lbl = ":".join(sorted(combo)) or "(no label)"
            keys = ", ".join(f"{k}: {t!r}" for k, t in sorted(self._nodes[combo].items()))
            lines.append(f"  ({lbl}) {{{keys}}}")
        for rt in sorted(self._rels):
            keys = ", ".join(f"{k}: {t!r}" for k, t in sorted(self._rels[rt].items()))
            lines.append(f"  [:{rt}] {{{keys}}}")
        lines.append(")")
        return "\n".join(lines)

    def to_json_dict(self) -> dict:
        """Serializable form used by the fs PGDS (schema.json convention)."""
        return {
            "nodes": [
                {"labels": sorted(combo), "properties": {k: repr(t) for k, t in keys.items()}}
                for combo, keys in self._nodes.items()
            ],
            "relationships": [
                {"type": rt, "properties": {k: repr(t) for k, t in keys.items()}}
                for rt, keys in self._rels.items()
            ],
        }
