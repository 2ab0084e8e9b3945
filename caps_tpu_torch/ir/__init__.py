"""IR layer: typed expression tree, query blocks, pattern, IR builder, typer.

Mirrors the reference's ``okapi-ir`` module (ref:
okapi-ir/src/main/scala/org/opencypher/okapi/ir/ — reconstructed, mount
empty; SURVEY.md §2 "IR").
"""
