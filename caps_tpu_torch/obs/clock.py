"""The single sanctioned time source for the engine.

The counterpart of ``caps_tpu/obs/clock.py``.  The observability
modules, the operators and the session read time through this module.
Centralizing the clock keeps all
measurements on one monotonic base (spans, per-operator metrics, and the
chrome-trace export timestamps all compare), and gives tests a single
seam to stub.
"""
from __future__ import annotations

import time as _time

#: Monotonic high-resolution seconds — span durations, operator timings.
now = _time.perf_counter

#: Epoch seconds — only for human-facing timestamps, never for deltas.
wall = _time.time

#: The single sanctioned *wait* primitive (retry backoff, poll loops).
#: Routing sleeps through here lets a test install a fake clock whose
#: ``sleep`` advances ``now`` instantly — retry/backoff timing becomes
#: exactly assertable with zero real waiting (tests/test_faults.py).
sleep = _time.sleep


def _event_wait(event, timeout):
    return event.wait(timeout)


#: The single sanctioned *interruptible* wait: block up to ``timeout``
#: seconds on a ``threading.Event``, returning True the moment it fires.
#: Retry backoff sleeps route through here with the request's cancel
#: event, so ``cancel()`` / non-drain shutdown wake a backing-off worker
#: immediately instead of burning the rest of the backoff.  Fake clocks
#: stub this alongside ``now``/``sleep`` (advance time, honor a
#: pre-fired event instantly).
wait = _event_wait
