"""Micro-batching: group compatible in-flight requests into one run.

The counterpart of ``caps_tpu/serve/batcher.py``: the serving analogue
of continuous batching in LLM inference (PAPERS.md, *Ragged Paged
Attention*): throughput comes from pushing many small requests through
one prepared program.  Here the program is a cached prepared plan — requests are compatible when they
would hit the SAME plan-cache entry family, i.e. share

    (graph plan token, normalized query text, parameter signature)

which is exactly the session plan cache's value-independent key minus
the catalog fingerprint (the batch executes at one instant, so all
members see the same catalog).  A batch executes as one pass over the
cached operator tree — one cache lookup, one plan lock, one tracer
span — with per-member parameter rebinding; the members' fused replays
dispatch back to back as one uninterrupted stream of launches on the
card (backends/cuda/fused.py ``batch``).

Never batched (batch key None): EXPLAIN/PROFILE requests (PROFILE
mutates session profiling state and must run alone), queries against
graphs that cannot anchor a plan-cache entry, and parameter sets whose
signatures diverge — those fall back to per-request execution.

**Ragged bucket batching** (``ServerConfig.ragged_batching``): the
batch key widens from the exact plan-key family to a (graph, parameter
shape-bucket signature) — see ``relational/shapes.py`` — so *different*
queries whose operator launches are shape-compatible pack into one
shared device launch window.  Exactness is untouched: every member
still executes its OWN cached plan with per-member parameter rebinding
(and, on device backends, bucket-padded tables with validity masks —
the exact-row masks of the pad-and-pack scheme), and per-member
exception isolation is the same ``cypher_batch`` contract as before.
The request keeps its exact plan key alongside (``Request.plan_key``)
for everything that must stay per-family: circuit breakers, plan
quarantine, and telemetry labels.
"""
from __future__ import annotations

from typing import Any, List, Mapping, Optional, Tuple

from caps_tpu_torch.serve.admission import AdmissionController
from caps_tpu_torch.serve.request import Request


def request_keys(graph: Any, query: str, params: Mapping[str, Any],
                 ragged: bool = False, lattice: Any = None
                 ) -> Tuple[Optional[str], Optional[Tuple],
                            Optional[Tuple]]:
    """(query mode, plan key, batch key).  Plan key None = the request
    can never anchor shared cached state (EXPLAIN/PROFILE, writes,
    uncacheable graphs); batch key None = never batch.  Update
    statements report mode ``"write"``: they never coalesce (each is one
    atomic commit with its own read half) and the server routes them to
    the versioned handle instead of a pinned snapshot.  With ``ragged``
    the batch key is the shape-bucket signature instead of the exact
    plan family."""
    from caps_tpu_torch.frontend.parser import normalize_query, query_mode
    from caps_tpu_torch.relational.plan_cache import (graph_plan_token,
                                                param_signature)
    from caps_tpu_torch.relational.updates import is_update_query
    mode, body = query_mode(query)
    if mode is not None:
        return mode, None, None
    if is_update_query(body):
        return "write", None, None
    gtok = graph_plan_token(graph)
    if gtok is None:
        return None, None, None
    try:
        sig = param_signature(params)
    except Exception:
        return None, None, None
    plan_key = (gtok, normalize_query(body), sig)
    if not ragged:
        return None, plan_key, plan_key
    # ``lattice`` should be the serving session's shape lattice so the
    # bucket key agrees with the padding ladder and compile-shape
    # labels (one boundary set); None falls back to the process default
    from caps_tpu_torch.relational.shapes import param_shape_signature
    return None, plan_key, (gtok, "bucket",
                            param_shape_signature(params, lattice))


def batch_key(graph: Any, query: str,
              params: Mapping[str, Any]) -> Tuple[Optional[str],
                                                  Optional[Tuple]]:
    """(query mode, exact-family batch key) — the pre-ragged view, kept
    for callers that only need plan-key compatibility."""
    mode, _plan_key, key = request_keys(graph, query, params)
    return mode, key


class MicroBatcher:
    """Pulls a leader from the admission queue, then gathers compatible
    followers — everything already queued, plus (optionally) whatever
    arrives inside ``window_s``.  ``window_s`` trades leader latency
    for batch size; the default 0 batches only what is already there."""

    def __init__(self, admission: AdmissionController, max_batch: int = 8,
                 window_s: float = 0.0):
        self.admission = admission
        self.max_batch = max(1, int(max_batch))
        self.window_s = float(window_s)

    def next_batch(self, timeout: Optional[float] = None) -> List[Request]:
        leader = self.admission.take(timeout)
        if leader is None:
            return []
        if leader.batch_key is None or self.max_batch == 1:
            return [leader]
        if self.window_s > 0:
            # don't wait past the leader's own deadline
            window = self.window_s
            rem = leader.scope.remaining()
            if rem is not None:
                window = min(window, max(0.0, rem))
            self.admission.wait_for_compatible(
                leader.batch_key, self.max_batch - 1, window)
        followers = self.admission.take_compatible(
            leader.batch_key, self.max_batch - 1)
        return [leader] + followers
