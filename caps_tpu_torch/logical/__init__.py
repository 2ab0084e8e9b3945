"""Logical planning: operator algebra, planner, optimizer.

Mirrors the reference's ``okapi-logical`` module (ref:
okapi-logical/src/main/scala/org/opencypher/okapi/logical/ — reconstructed,
mount empty; SURVEY.md §2 "Logical planner").
"""
