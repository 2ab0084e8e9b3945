"""The JAX package's end-to-end cases (``tests/test_e2e_local.py``) on
both backends of the port.

The 23 cases are loaded from their source with ``caps_tpu`` rewritten
to ``caps_tpu_torch`` and ``tests.util`` to the port's copy of it
(``caps_tpu_torch/testing/suites.py``), and run unedited on the
SocialNetworkExample graph of a ``local`` session and of a ``cuda`` one
on the CPU.  On ``cuda`` a case that reaches an expression with no
device path (ROADMAP item 2) must raise it, strictly, as the acceptance
suites' listed tests do; none does since ``labels`` has one.
"""
import pytest

from caps_tpu_torch.testing.sessions import BACKENDS, make_backend_session
from caps_tpu_torch.testing.suites import (
    call_listed, collect_tests, fn_kwargs, load_module, with_params,
)

_UTIL = load_module("util.py", name="_ported_tests_util")
_E2E = load_module("test_e2e_local.py",
                   renames={"tests.util": "_ported_tests_util"})
_TESTS = collect_tests(_E2E)
# the CUDA backend's gaps: test name -> the cause it must raise
CUDA_GAPS: dict = {}


@pytest.fixture(params=BACKENDS)
def backend(request):
    return request.param


@pytest.fixture()
def session(backend):
    return make_backend_session(backend, device="cpu")


@pytest.fixture()
def graph(session):
    return _UTIL.social_graph(session)


def _wrap(name, fn):
    def body(kwargs):
        cause = CUDA_GAPS.get(name) if kwargs["backend"] == "cuda" else None
        if cause is None:
            fn(**fn_kwargs(fn, kwargs))
        else:
            call_listed(fn, fn_kwargs(fn, kwargs), cause)
    return with_params(fn, ("backend",), body)


globals().update({n: _wrap(n, f) for n, f in _TESTS.items()})


def test_every_reference_case_is_collected():
    assert len(_TESTS) == 23
    assert set(CUDA_GAPS) <= set(_TESTS)
