"""Failure classification: the counterpart of
``caps_tpu/serve/failure.py``, reduced to :func:`classify`.

Maps a raised exception to how containment treats it: ``TRANSIENT``
(retry as is — the cached state is fine), ``POISONED_PLAN`` (suspect the
cached plan or fused memo) or ``FATAL`` (the query itself is wrong).  A
device out-of-memory error (``torch.cuda.OutOfMemoryError``) is
transient, as the JAX package treats ``RESOURCE_EXHAUSTED``.
"""
from __future__ import annotations

import torch

TRANSIENT = "transient"
POISONED_PLAN = "poisoned_plan"
FATAL = "fatal"

#: Frontend / user-error exception class names (by name: the frontend
#: must stay importable without pulling the serving tier and vice versa).
_FATAL_NAMES = frozenset({"CypherSyntaxError", "SemanticError",
                          "HeaderError", "NondeterministicResultError"})


def classify(exc: BaseException) -> str:
    """Map one raised exception to its containment treatment."""
    # explicit marker wins: code that KNOWS an error is retryable (or is
    # not) stamps it
    marker = getattr(exc, "caps_transient", None)
    if marker is True:
        return TRANSIENT
    if marker is False:
        return FATAL
    if isinstance(exc, torch.cuda.OutOfMemoryError):
        return TRANSIENT
    if isinstance(exc, (ConnectionError, TimeoutError)):
        return TRANSIENT
    if isinstance(exc, (SyntaxError, KeyError, NotImplementedError)) \
            or type(exc).__name__ in _FATAL_NAMES:
        # user error (bad query text / missing $param / unsupported
        # feature): deterministic, never the cache's fault
        return FATAL
    return POISONED_PLAN
