"""Run the JAX package's own test modules against this package.

The reference's suites (``tests/acceptance/``, the front-end and okapi
unit tests, ``tests/test_e2e_local.py``, ``tests/test_analysis.py``)
are loaded from their source with every ``caps_tpu`` name rewritten to
``caps_tpu_torch``, and their ``test_*`` functions are handed to a test
module of the port (or to ``chip_smoke.py``), which provides the
fixtures.  Nothing of the reference is imported: its files are read as
text, so the suites stay exactly as they are.
"""
from __future__ import annotations

import functools
import inspect
import os
import re
import sys
import types
from typing import Callable, Dict, Iterable, List, Mapping, Optional, Tuple

REPO_DIR = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
TESTS_DIR = os.path.join(REPO_DIR, "tests")

# the reference's suites of behaviour tests, in file order
ACCEPTANCE_SUITES = (
    "aggregation", "comprehension", "functions", "match", "optional_match",
    "path", "predicate", "temporal", "with",
)

_NAME = re.compile(r"\bcaps_tpu\b")


def port_source(text: str, renames: Mapping[str, str] = ()) -> str:
    """``text`` with the reference's package name (``caps_tpu``, not
    ``caps_tpu_torch``) replaced by the port's, then each of ``renames``
    (a dotted module name to another) applied."""
    text = _NAME.sub("caps_tpu_torch", text)
    for old, new in dict(renames).items():
        text = re.sub(r"\b%s\b" % re.escape(old), new, text)
    return text


def load_module(relpath: str, name: Optional[str] = None,
                renames: Mapping[str, str] = ()) -> types.ModuleType:
    """Load ``tests/<relpath>`` as a module of the port (see
    :func:`port_source`), registered in ``sys.modules`` under ``name``
    (``_ported_<stem>`` by default) so that it can be imported by the
    next module loaded with a rename to it."""
    path = os.path.join(TESTS_DIR, relpath)
    with open(path, encoding="utf-8") as f:
        text = port_source(f.read(), renames)
    if name is None:
        stem = os.path.splitext(relpath)[0].replace(os.sep, "_")
        name = "_ported_" + stem.replace("/", "_")
    mod = types.ModuleType(name)
    mod.__file__ = path
    sys.modules[name] = mod
    try:
        exec(compile(text, path, "exec"), mod.__dict__)
    except BaseException:
        sys.modules.pop(name, None)
        raise
    return mod


def collect_tests(mod: types.ModuleType) -> Dict[str, Callable]:
    """The module's ``test_*`` functions, by name, in source order."""
    out = {}
    for name, obj in vars(mod).items():
        if name.startswith("test_") and inspect.isfunction(obj) \
                and obj.__module__ == mod.__name__:
            out[name] = obj
    return out


def load_acceptance(suite: str) -> types.ModuleType:
    """``tests/acceptance/test_<suite>_behaviour.py`` on the port."""
    return load_module(os.path.join("acceptance",
                                    f"test_{suite}_behaviour.py"))


# -- the acceptance suites' strict list of the CUDA backend's gaps ----------

ACCEPTANCE_GAPS = os.path.join(
    REPO_DIR, "caps_tpu_torch", "tck", "blacklists", "acceptance_cuda.txt")


def load_acceptance_gaps() -> Dict[str, str]:
    """``{"<suite>::<test>": cause}`` from the list: one test a line,
    ``<suite>::<test> # <cause>``; ``#`` lines are comments."""
    gaps: Dict[str, str] = {}
    with open(ACCEPTANCE_GAPS, encoding="utf-8") as f:
        for raw in f:
            line = raw.strip()
            if not line or line.startswith("#"):
                continue
            key, _, cause = line.partition(" # ")
            gaps[key.strip()] = cause.strip()
    return gaps


def call_listed(fn: Callable, kwargs: Mapping, cause: str) -> None:
    """Run a listed test's body: it must raise the device backend's "no
    device path" error, or the "not yet ported" one, with ``cause`` in
    its message.  A listed body that passes, or raises anything else,
    raises AssertionError."""
    from caps_tpu_torch.backends.cuda.expr import UnsupportedOnDevice
    try:
        fn(**kwargs)
    except (UnsupportedOnDevice, NotImplementedError) as exc:
        if cause not in str(exc):
            raise AssertionError(
                f"listed for {cause!r}, raised {type(exc).__name__}: "
                f"{exc}") from exc
        return
    except AssertionError as exc:
        # a body that expects an error, pytest.raises(match=...), and got
        # the gap's instead: the mismatch names the error it got
        _, _, got = str(exc).partition("Input: ")
        if cause in got:
            return
        raise AssertionError(
            f"listed for {cause!r}, but an assertion failed: {exc}") from exc
    raise AssertionError(
        f"listed for {cause!r} but passed: take it off the list")


def with_params(fn: Callable, extra: Iterable[str],
                body: Callable) -> Callable:
    """A function with ``fn``'s name and parameters plus ``extra``
    (fixtures the caller needs), calling ``body(kwargs)`` with all of
    them; what pytest collects in place of ``fn``."""
    sig = inspect.signature(fn)
    params = list(sig.parameters.values())
    names = [p.name for p in params]
    for e in extra:
        if e not in names:
            params.append(inspect.Parameter(
                e, inspect.Parameter.POSITIONAL_OR_KEYWORD))

    @functools.wraps(fn)
    def wrapper(**kwargs):
        return body(kwargs)

    del wrapper.__wrapped__
    wrapper.__signature__ = sig.replace(parameters=params)
    return wrapper


def fn_kwargs(fn: Callable, available: Mapping) -> Dict:
    """The subset of ``available`` that ``fn`` takes."""
    return {n: available[n] for n in inspect.signature(fn).parameters}


def suite_tests() -> List[Tuple[str, str, Callable]]:
    """(suite, test name, function) of every acceptance test."""
    out = []
    for suite in ACCEPTANCE_SUITES:
        for name, fn in collect_tests(load_acceptance(suite)).items():
            out.append((suite, name, fn))
    return out
