"""TCK-subset conformance of the port on the CPU.

Every scenario of ``caps_tpu_torch/tck/features`` runs on
``caps_tpu_torch.local_session(device="cpu")``, one session per feature
file.  The list ``caps_tpu_torch/tck/blacklists/cuda.txt`` is strict:
an unlisted scenario must match its expected table (or raise, where it
expects an error), and a listed one must raise the port's "not ported
yet" error with the message the list gives.  A listed scenario that
starts to pass fails here until it is taken off the list.

The same scenarios run on the port's pure-Python oracle
(``local_session(backend="local")``) with no list, as the reference's
local backend runs them (``test_tck_local``), and on the ``"sharded"``
backend (the device backend over an 8-shard mesh on the CPU) under the
strict list ``caps_tpu_torch/tck/blacklists/sharded.txt``
(``test_tck_sharded``).
"""
import pytest

import caps_tpu_torch
from caps_tpu_torch.backends.cuda.expr import UnsupportedOnDevice
from caps_tpu_torch.tck import NotPorted, load_features, run_scenario
from caps_tpu_torch.tck.runner import (
    BLACKLIST, SHARDED_BLACKLIST, Expectation, Scenario, load_gaps,
)
from caps_tpu_torch.testing.sessions import make_backend_session

SCENARIOS = load_features()
GAPS = load_gaps(BLACKLIST)
SHARDED_GAPS = load_gaps(SHARDED_BLACKLIST)
# The longest the list may be; each slice that closes gaps lowers it.
MAX_LISTED = 0
# Operators with a device path: no listed scenario may raise for one.
PORTED_OPERATORS = ("explode", "collect", "cross join", "DISTINCT",
                    "percentile")

_SESSIONS = {}


def _session(feature, backend="cuda"):
    key = (backend, feature)
    if key not in _SESSIONS:
        if backend == "local":
            _SESSIONS[key] = caps_tpu_torch.local_session(backend="local")
        elif backend == "sharded":
            _SESSIONS[key] = make_backend_session("sharded", device="cpu")
        else:
            _SESSIONS[key] = caps_tpu_torch.local_session(device="cpu")
    return _SESSIONS[key]


def test_corpus_and_list_size():
    assert len(SCENARIOS) == 465
    assert len({s.key for s in SCENARIOS}) == 465
    assert len({s.feature for s in SCENARIOS}) == 29
    assert set(GAPS) <= {s.key for s in SCENARIOS}
    assert len(GAPS) <= MAX_LISTED
    assert all(GAPS.values()), "every listed scenario names its cause"
    assert len(SHARDED_GAPS) <= MAX_LISTED


def test_no_listed_scenario_raises_for_a_ported_operator():
    hits = {k: c for k, c in GAPS.items()
            if any(op in c for op in PORTED_OPERATORS)}
    assert not hits


@pytest.mark.parametrize("scenario", SCENARIOS, ids=lambda s: s.key)
def test_tck(scenario):
    session = _session(scenario.feature)
    cause = GAPS.get(scenario.key)
    if cause is None:
        run_scenario(session, scenario)
        return
    with pytest.raises(NotPorted) as info:
        run_scenario(session, scenario)
    assert cause in str(info.value), \
        f"listed for {cause!r}, raised {info.value}"


@pytest.mark.parametrize("scenario", SCENARIOS, ids=lambda s: s.key)
def test_tck_sharded(scenario):
    session = _session(scenario.feature, "sharded")
    cause = SHARDED_GAPS.get(scenario.key)
    if cause is None:
        run_scenario(session, scenario)
        return
    with pytest.raises(NotPorted) as info:
        run_scenario(session, scenario)
    assert cause in str(info.value), \
        f"listed for {cause!r}, raised {info.value}"


@pytest.mark.parametrize("scenario", SCENARIOS, ids=lambda s: s.key)
def test_tck_local(scenario):
    run_scenario(_session(scenario.feature, "local"), scenario)


class _RaisingGraph:
    def __init__(self, exc):
        self.exc = exc

    def cypher(self, query, params):
        raise self.exc


class _Session:
    """A session whose graph raises ``exc`` on every query."""

    def __init__(self, exc):
        self.exc = exc

    def create_graph(self, nodes=(), rels=()):
        return _RaisingGraph(self.exc)


@pytest.mark.parametrize("exc,not_ported", [
    (UnsupportedOnDevice("group: an aggregation"), True),
    (NotImplementedError("CALL: not yet ported, see ROADMAP"), True),
    (NotImplementedError("a query the engine rejects"), False),
    (ValueError("bad input"), False),
], ids=["unsupported_on_device", "see_roadmap", "not_implemented",
        "engine_error"])
def test_not_ported_never_satisfies_an_error_expectation(exc, not_ported):
    scenario = Scenario("f", "s", None, {}, "RETURN 1",
                        Expectation("error", error="SyntaxError"))
    if not_ported:
        with pytest.raises(NotPorted):
            run_scenario(_Session(exc), scenario)
    else:
        run_scenario(_Session(exc), scenario)
