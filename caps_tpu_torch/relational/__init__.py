"""Relational layer: RecordHeader, Table SPI, relational operators, planner,
graphs, session.

Mirrors the reference's ``okapi-relational`` module (ref:
okapi-relational/src/main/scala/org/opencypher/okapi/relational/ —
reconstructed, mount empty; SURVEY.md §2).
"""
