"""What drives the window: closed-loop clients through ``QueryServer``
(``"driver": "served"``) or one client calling ``graph.cypher``
(``"driver": "direct"``).

The served loop is a copy of ``serve_load`` in ``chip_smoke.py``, cut to
a timed window: each client submits, waits for its rows, and submits
the next until the window closes; what is in flight then finishes and
is waited for.  A request's latency runs from its ``submit`` to its
rows in hand.
"""
from __future__ import annotations

import dataclasses
import threading
import time
from typing import Any, Dict, List, Optional

from portbench.harness.traffic import client_stream, param_space

ANSWER_WAIT_S = 60.0     # how long past the close an answer is waited for


@dataclasses.dataclass
class Record:
    client: int
    family: int
    params: Dict[str, Any]
    t_submit: float
    t_done: Optional[float] = None
    rows: Optional[list] = None
    error: Optional[str] = None
    info: Dict[str, Any] = dataclasses.field(default_factory=dict)
    ok: Optional[bool] = None            # set by the judge

    @property
    def latency_s(self) -> Optional[float]:
        return None if self.t_done is None else self.t_done - self.t_submit


def _cypher_rows(sync, graph, query, params):
    rows = graph.cypher(query, params).records.to_maps()
    sync()
    return rows


class Driver:
    """The program under test behind the cell's entry point."""

    def __init__(self, sync, session, graph, mix: Dict[str, Any],
                 seed: int):
        """``sync`` waits for the card (``torch.cuda.synchronize``)."""
        self.sync, self.session, self.graph = sync, session, graph
        self.mix, self.seed = mix, seed
        self.families = mix["families"]
        self.clients = int(mix.get("clients", 1))
        self.server = None
        self.window_start = self.window_end = 0.0

    # -- set-up ------------------------------------------------------------

    def _replans(self) -> int:
        return self.session.metrics_snapshot().get("replan.triggered", 0)

    def warm(self) -> Dict[str, Any]:
        """Every parameter set of every family once, through
        ``graph.cypher``, until a pass triggers no re-plan (the first
        run of a family records, the next ones replay); then, served,
        ``warm_requests`` from each client through the server."""
        passes = 0
        runs = 0
        for passes in range(1, 4):
            before = self._replans()
            for f in self.families:
                for p in param_space(f) or [{}]:
                    _cypher_rows(self.sync, self.graph, f["query"], p)
                    runs += 1
            if passes >= int(self.mix.get("warm_passes", 1)) \
                    and self._replans() == before:
                break
        if self.mix["driver"] == "served":
            from caps_tpu_torch.serve import QueryServer, ServerConfig
            self.server = QueryServer(self.session, graph=self.graph,
                                      config=ServerConfig(
                                          **self.mix.get("server", {})))
            n = int(self.mix.get("warm_requests", 0))
            if n:
                self._served_loop(deadline=None, count=n, stream_base=1000)
        return {"warm_runs": runs, "warm_passes": passes}

    # -- the window --------------------------------------------------------

    def window(self, seconds: float) -> List[Record]:
        if self.mix["driver"] == "served":
            return self._served_loop(deadline=seconds)
        return self._direct_loop(seconds)

    def _direct_loop(self, seconds: float) -> List[Record]:
        stream = client_stream(self.mix, self.seed, 0)
        out: List[Record] = []
        self.window_start = time.perf_counter()
        self.window_end = self.window_start + seconds
        while time.perf_counter() < self.window_end:
            i, p = next(stream)
            rec = Record(0, i, p, time.perf_counter())
            try:
                rec.rows = _cypher_rows(self.sync, self.graph,
                                        self.families[i]["query"], p)
            except Exception as ex:  # a failed count is recorded, not raised
                rec.error = f"{type(ex).__name__}: {ex}"
            rec.t_done = time.perf_counter()
            out.append(rec)
        return out

    def _served_loop(self, deadline: Optional[float], count: int = 0,
                     stream_base: int = 0) -> List[Record]:
        """Closed-loop clients: for ``deadline`` seconds, or ``count``
        requests each (the served warm-up)."""
        records: List[List[Record]] = [[] for _ in range(self.clients)]
        go = threading.Event()
        errors: List[BaseException] = []

        def client(c: int) -> None:
            stream = client_stream(self.mix, self.seed, stream_base + c)
            mine = records[c]
            go.wait()
            try:
                while (len(mine) < count if deadline is None
                       else time.perf_counter() < self.window_end):
                    i, p = next(stream)
                    rec = Record(c, i, p, time.perf_counter())
                    mine.append(rec)
                    try:
                        h = self.server.submit(self.families[i]["query"], p,
                                               deadline_s=None)
                        rec.rows = h.rows(timeout=ANSWER_WAIT_S + (
                            deadline or 0.0))
                        rec.info = dict(h.info)
                    except Exception as ex:  # failed, not raised: counted
                        rec.error = f"{type(ex).__name__}: {ex}"
                    rec.t_done = time.perf_counter()
            except BaseException as ex:   # the run fails below
                errors.append(ex)
                raise

        threads = [threading.Thread(target=client, args=(c,), daemon=True)
                   for c in range(self.clients)]
        for t in threads:
            t.start()
        self.window_start = time.perf_counter()
        self.window_end = self.window_start + (deadline or 0.0)
        go.set()
        limit = (deadline or 0.0) + ANSWER_WAIT_S + 30.0
        for t in threads:
            t.join(timeout=limit)
        if any(t.is_alive() for t in threads):
            raise RuntimeError("a client did not finish within "
                               f"{limit:.0f} s of the window's start")
        if errors:
            raise RuntimeError(f"a client failed: {errors[0]!r}")
        return [r for mine in records for r in mine]

    def close(self) -> None:
        if self.server is not None:
            self.server.shutdown(timeout=60)
            self.server = None
