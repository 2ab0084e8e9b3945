#!/usr/bin/env python3
"""Run one cell of the benchmark of ``caps_tpu_torch`` once.

    python3 portbench/run.py --workload <name> --seed <n> \\
        --seconds <s> --trace <0|1>

from the root of a checkout on a machine with an NVIDIA card.  Loads
the cell's configuration and traffic mix (named in ``BENCHMARK.json``),
makes its data from ``--seed``, sets up and warms the program, measures
for ``--seconds``, checks every answer of the window against the plain
reference, and prints one JSON line as the last line of standard out:
``correct``, ``attempted``, ``failed``, ``metrics`` (the cell's
end-to-end metrics, or with ``--trace 1`` its per-layer ones),
``device`` and, traced, ``breakdown``; ``checks``, the numbers compared
beside their limits, comes last.  Without a card, or with a module of
JAX or of the JAX package loaded, it exits non-zero and prints no
result.  ``--control 1`` judges the control's answers in the program's
place (it has to come out not correct); the benchmark's runs never
pass it.
"""
from __future__ import annotations

import time

STARTED = time.perf_counter()

import argparse  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def process_age_s() -> float:
    """Seconds since this process started (its start time in clock
    ticks since boot against the uptime), 0 where /proc is missing."""
    try:
        with open("/proc/self/stat") as f:
            start = int(f.read().rsplit(")", 1)[1].split()[19])
        with open("/proc/uptime") as f:
            up = float(f.read().split()[0])
        return max(0.0, up - start / os.sysconf("SC_CLK_TCK"))
    except (OSError, ValueError, IndexError):
        return 0.0


def parse(argv):
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    p.add_argument("--control", type=int, choices=(0, 1), default=0)
    return p.parse_args(argv)


def main(argv=None) -> int:
    started = STARTED - process_age_s()
    args = parse(argv)
    if ROOT not in sys.path:
        sys.path.insert(0, ROOT)
    from portbench.harness import cell, env
    env.prepare()
    try:
        result = cell.run(args.workload, args.seed, args.seconds,
                          bool(args.trace), started,
                          control=bool(args.control))
        env.check_imports()
    except (env.NoCard, env.ForbiddenImport) as ex:
        print(f"portbench: {ex}", file=sys.stderr)
        return 3
    cell.print_result(result)
    return 0


if __name__ == "__main__":
    sys.exit(main())
