"""The JAX package's acceptance suites on two backends of the port.

The 117 behaviour tests of ``tests/acceptance/test_*_behaviour.py`` are
loaded from their source with ``caps_tpu`` rewritten to
``caps_tpu_torch`` (``caps_tpu_torch/testing/suites.py``) and run
unedited, with the fixtures (``session``, ``init_graph``, ``run``,
``bag``) of ``tests/acceptance/conftest.py`` built from the port's
``testing/sessions.py``, ``factory.py`` and ``bag.py``:

* ``local``, the pure-Python oracle: every test passes;
* ``cuda`` on the CPU: every test passes except those on the strict list
  ``caps_tpu_torch/tck/blacklists/acceptance_cuda.txt``, each of which
  must raise the cause the list names (an expression with no device
  path: ROADMAP item 2).  A listed test that passes fails here until it
  is taken off the list.

Each behaviour file becomes one class: ``TestMatchBehaviour`` holds
``tests/acceptance/test_match_behaviour.py``'s tests.
"""
import pytest

from caps_tpu_torch.testing.bag import Bag
from caps_tpu_torch.testing.factory import create_graph
from caps_tpu_torch.testing.sessions import BACKENDS, make_backend_session
from caps_tpu_torch.testing.suites import (
    ACCEPTANCE_SUITES, call_listed, collect_tests, fn_kwargs,
    load_acceptance, load_acceptance_gaps, with_params,
)

GAPS = load_acceptance_gaps()
# The longest the list may be; each slice that closes gaps lowers it.
MAX_LISTED = 37
COUNTS = {"aggregation": 16, "comprehension": 19, "functions": 12,
          "match": 15, "optional_match": 6, "path": 19, "predicate": 12,
          "temporal": 6, "with": 12}


@pytest.fixture(params=BACKENDS, scope="module")
def backend(request):
    return request.param


@pytest.fixture(scope="module")
def session(backend):
    return make_backend_session(backend, device="cpu")


@pytest.fixture()
def init_graph(session):
    def make(create_query: str, **params):
        return create_graph(session, create_query, params)
    return make


@pytest.fixture()
def run():
    def _run(graph, query, **params):
        return graph.cypher(query, params).records.to_maps()
    return _run


@pytest.fixture()
def bag():
    return Bag


def _wrap(suite, name, fn):
    key = f"{suite}::{name}"

    def body(kwargs):
        args = fn_kwargs(fn, kwargs)
        cause = GAPS.get(key) if kwargs["backend"] == "cuda" else None
        if cause is None:
            fn(**args)
        else:
            call_listed(fn, args, cause)
    return with_params(fn, ("backend",), body)


_LOADED = {}
for _suite in ACCEPTANCE_SUITES:
    _tests = collect_tests(load_acceptance(_suite))
    _LOADED[_suite] = sorted(_tests)
    _name = "Test" + "".join(p.capitalize() for p in _suite.split("_")) \
        + "Behaviour"
    globals()[_name] = type(_name, (), {
        n: staticmethod(_wrap(_suite, n, f)) for n, f in _tests.items()})


def test_every_reference_test_is_collected():
    assert {s: len(t) for s, t in _LOADED.items()} == COUNTS
    assert sum(COUNTS.values()) == 117


def test_the_gap_list_is_strict():
    keys = {f"{s}::{n}" for s, names in _LOADED.items() for n in names}
    assert set(GAPS) <= keys
    assert len(GAPS) <= MAX_LISTED
    assert all(GAPS.values()), "every listed test names its cause"
