"""openCypher front-end: lexer, AST, recursive-descent parser, semantics.

The reference consumed Neo4j's external ``org.opencypher:front-end``
dependency (parboiled parser, ~100k LoC); we implement the needed openCypher
subset in-house (SURVEY.md §7 "hard part #1"): MATCH / OPTIONAL MATCH /
WHERE / WITH / RETURN / ORDER BY / SKIP / LIMIT / UNWIND / UNION / CREATE,
variable-length relationships, and the multiple-graph extensions
(FROM GRAPH, CONSTRUCT, RETURN GRAPH, CATALOG CREATE GRAPH).
"""
from caps_tpu_torch.frontend.parser import CypherParser, parse_query  # noqa: F401
