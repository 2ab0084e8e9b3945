"""Deterministic datasets: the LDBC-SNB-like generator and its reads."""
