#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (caps_tpu_torch) on one NVIDIA card.

Run from the repository root with no arguments:

    python3 chip_smoke.py [--seed 0] [--persons 1000000] [--edges 10000000]

Phases, one JSON line each; any failure raises and exits nonzero:

  1. env      — torch / CUDA versions and the card's name and power limit;
  2. build    — nvcc builds every kernel from ``caps_tpu_torch/ops/csrc``;
  3. slice    — a seeded graph (1M :Person {age 18-89, city: one of 1,000
                strings}, 10M uniform :KNOWS edges) is built on the card
                and the grouped 2-hop query runs through ``local_session``
                once with the launch counts zeroed just before and read
                just after (a fused record run and a plan-cache miss; it
                runs every kernel family's self-test first); then warm
                runs (plan-cache hits, exact replays) and the ``count(*)``
                form.  Both results must equal a numpy oracle of the same
                graph;
  4. warm     — on the same session: the eager path (plan cache and fused
                replay off), exact replays (0 size reads each), and 24
                rotating ``$age`` values (param-generic replay), each equal
                to its own numpy oracle; one exact and one generic replay
                run under ``torch.cuda.set_sync_debug_mode("warn")``;
  5. patterns — on the same session: the ``count(*)`` form on count
                pushdown (``fused-spmv``: 5 exact replays with 0 size
                reads, 24 rotating ``$age`` values against the oracle, the
                join cascade of a ``use_count_pushdown=False`` session),
                the 3-hop count and the cycle count (``cycle-probe``, on
                the graph with its self-loops dropped) against the
                cascade, the var-length grouped query in its join form
                (K1, K2 and K3 launched by a replay) and, with
                ``a.city = $city``, its matrix form, each against the
                oracle, and the var-length ``count(*)``; per query the
                cold and warm latencies, strategy, size reads, launches
                and peak allocated bytes;
  6. unwind   — on the same session: collect then UNWIND, DISTINCT
                count with percentileDisc and percentileCont, and a cross
                join of about 13.3M rows; per query its cold run, exact
                replays (0 size reads) and the warm phase's 24 rotating
                ``$age`` values, each against its numpy oracle, with
                launches, size reads, peak allocated bytes and the
                device busy time of one exact replay (``torch.profiler``);
  7. tck      — the 465 TCK scenarios on the card under the CPU tests'
                strict list (``caps_tpu_torch/tck/blacklists/cuda.txt``),
                and the port's float64 sqrt on 2^20 values bit for bit
                against numpy;
  8. ldbc     — the LDBC-like reads IS1–IS7 and IC1–IC14 on the port's
                generator: at scale 11 (about LDBC SF1) 3 parameter draws
                each, equal to the port's CPU session; at scale 110
                (about SF10) a cold run, 5 exact replays and 3 generic
                draws, each equal to an eager run, the device busy time
                of one exact replay, and IS1/IS4/IS5 against numpy;
  9. selftest — the seconds each kernel family's self-test took, and a
                check that a second request launches nothing;
 10. kernels  — each kernel wrapper against its plain PyTorch version on
                the card, on the inputs of every call one exact replay
                made (of the grouped query, the var-expand forms, the
                unwind queries and IC12) and at edge shapes (the segment
                kernel: bit for bit, NaN and signed zeros included, and
                two calls bitwise equal), with the median time of 20 launches (CUDA
                events) at the largest call and at each call (summed:
                ``ms_per_query``), the plain version's and one library
                call's time, and, for the expand and segment kernels,
                device time and launches by kernel name
                (``torch.profiler``);
 11. the ``{"kernels": [...]}`` line, the card line, and the last line
     ``{"ok": true, "device": {...}}``.

Needs one card; without CUDA, or outside the repository, it exits
nonzero before printing any result.
"""
from __future__ import annotations

import argparse
import json
import os
import statistics
import subprocess
import sys
import time
import warnings

ROOT = os.path.dirname(os.path.abspath(__file__))

QUERY_GROUPED = (
    "MATCH (a:Person)-[:KNOWS]->(b)-[:KNOWS]->(c) WHERE a.age = $age "
    "RETURN c.city AS city, count(*) AS n ORDER BY n DESC, city LIMIT 20")
QUERY_COUNT = ("MATCH (a:Person)-[:KNOWS]->(b)-[:KNOWS]->(c) "
               "WHERE a.age = $age RETURN count(*) AS c")
# The patterns phase: count pushdown (2 and 3 hops, the cycle), and the
# bounded var-length expand in its join and matrix forms.
QUERY_COUNT3 = ("MATCH (a:Person)-[:KNOWS]->(b)-[:KNOWS]->(c)-[:KNOWS]->(d) "
                "WHERE a.age = $age RETURN count(*) AS c")
QUERY_CYCLE = ("MATCH (a:Person)-[:KNOWS]->(b)-[:KNOWS]->(c)-[:KNOWS]->(a) "
               "WHERE a.age = $age RETURN count(*) AS c")
QUERY_VARLEN = (
    "MATCH (a:Person)-[:KNOWS*1..2]->(c) WHERE a.age = $age "
    "RETURN c.city AS city, count(*) AS n ORDER BY n DESC, city LIMIT 20")
QUERY_VARLEN_CITY = (
    "MATCH (a:Person)-[:KNOWS*1..2]->(c) WHERE a.age = $age "
    "AND a.city = $city "
    "RETURN c.city AS city, count(*) AS n ORDER BY n DESC, city LIMIT 20")
QUERY_VARLEN_COUNT = ("MATCH (a:Person)-[:KNOWS*1..2]->(c) "
                      "WHERE a.age = $age RETURN count(*) AS c")
# The unwind phase: collect then UNWIND, DISTINCT aggregates with the two
# percentiles, and a cross join, each on the slice's graph.
QUERY_UNWIND = (
    "MATCH (a:Person)-[:KNOWS]->(b) WHERE a.age = $age "
    "WITH a, collect(b.city) AS cs UNWIND cs AS c "
    "RETURN c AS city, count(*) AS n ORDER BY n DESC, city LIMIT 20")
QUERY_PERCENTILES = (
    "MATCH (a:Person)-[:KNOWS]->(b) WHERE a.age = $age "
    "RETURN a.city AS city, count(DISTINCT b.city) AS nc, "
    "percentileDisc(b.age, 0.5) AS p50, percentileCont(b.age, 0.9) AS p90 "
    "ORDER BY city LIMIT 20")
QUERY_CROSS = ("MATCH (a:Person), (b:Person) WHERE a.age = $age "
               "AND b.city = $city RETURN count(*) AS n")
CITY = "city0007"   # with AGE: about 14 seeds, the var-expand matrix form
# The graph's dictionary-coded property and the seed filter.  1,000 cities
# keep the group-by under the dense gate (S <= 4096), so it runs on K1.
CITIES = 1000
AGE = 30

# One H100 SXM at its full 700 W (NVIDIA's data sheet): HBM rate and the
# float32 rate outside the tensor cores, used for 32-bit integer work too.
HBM_BYTES_PER_S = 3.35e12
OPS_PER_S = 67e12

KERNELS = {
    "segment_agg": ("caps_tpu_torch/ops/csrc/segment_agg.cu",
                    "caps_tpu/ops/segment.py:129"),
    "expand_positions": ("caps_tpu_torch/ops/csrc/expand_positions.cu",
                         "caps_tpu/ops/expand.py:81"),
    "bitonic_sort": ("caps_tpu_torch/ops/csrc/bitonic_sort.cu",
                     "caps_tpu/ops/sort.py:171"),
    "prefetch_gather": ("caps_tpu_torch/ops/csrc/prefetch_gather.cu",
                        "caps_tpu/ops/probe.py:94"),
}
ROTATING = 24   # $age values of the warm phase's param-generic sequence
# Launches one run of the grouped query makes of the kernels it runs
# itself (K4 runs only in the self-test): two joins per hop, one
# group-by, one sort of the grouped rows.
MIN_QUERY_LAUNCHES = {"segment_agg": 1, "expand_positions": 4,
                      "bitonic_sort": 1}
# The same for one run of the var-expand query's matrix form: its two
# assembling joins (K2 each), the sort of the seed-target pairs (the
# first join's build side) and of the grouped rows (K3), the group-by.
MIN_MATRIX_LAUNCHES = {"segment_agg": 1, "expand_positions": 2,
                       "bitonic_sort": 2}
# The same for one run of the collect/UNWIND query: its two joins (K2),
# the dense group-by of the unwound cities (K1), the sort of about 1,000
# grouped rows (K3).
MIN_UNWIND_LAUNCHES = {"segment_agg": 1, "expand_positions": 1,
                       "bitonic_sort": 1}
# The LDBC phase's scales: 11 is about LDBC SF1 (11k persons, 150k
# nodes), 110 about SF10 (BASELINE.md configs 2 and 3).
LDBC_SCALES = (11.0, 110.0)
LDBC_SEED = 7
LDBC_DRAWS = 3
# the kernel wrappers a query calls, each with the size its Recorder
# keeps the largest call by
QUERY_KERNELS = (("segment", "dense_segment_agg_cuda",
                  lambda a: a[0].shape[0]),
                 ("expand", "expand_positions_cuda", lambda a: a[2]),
                 ("sort", "bitonic_sort_perm_cuda",
                  lambda a: a[0][0].shape[0]))


def emit(obj) -> None:
    print(json.dumps(obj), flush=True)


def card_line() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], check=True, capture_output=True,
        text=True).stdout.strip().splitlines()[0]


def time_ms(torch, fn, reps: int = 20, warmup: int = 3) -> float:
    """Median device time of ``fn`` over ``reps`` launches (CUDA events).
    A spin kernel queued first keeps the card busy while the host
    enqueues the launches, so host overhead between launches does not
    count as device time."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    torch.cuda._sleep(50_000_000)  # ~25 ms of device cycles
    pairs = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        pairs.append((start, end))
    torch.cuda.synchronize()
    return statistics.median(s.elapsed_time(e) for s, e in pairs)


def bound(bytes_moved: int, ops: int):
    t_bytes = bytes_moved / HBM_BYTES_PER_S * 1e3
    t_ops = ops / OPS_PER_S * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


class Recorder:
    """Wraps a kernel wrapper to keep the arguments of every call on the
    main path and of its largest one (references only; nothing is
    copied or launched)."""

    def __init__(self, module, name: str, size_of):
        self.module, self.name, self.size_of = module, name, size_of
        self.inner = getattr(module, name)
        self.largest = None
        self.calls = []

    def __call__(self, *args):
        self.calls.append(args)
        if self.largest is None or self.size_of(args) > \
                self.size_of(self.largest):
            self.largest = args
        return self.inner(*args)

    def __enter__(self):
        setattr(self.module, self.name, self)
        return self

    def __exit__(self, *exc):
        setattr(self.module, self.name, self.inner)


def make_graph(np, seed: int, n_persons: int, n_edges: int, n_cities: int):
    rng = np.random.default_rng(seed)
    cities = np.array([f"city{i:04d}" for i in range(n_cities)])
    nodes = {"Person": {
        "_id": np.arange(n_persons, dtype=np.int64),
        "age": rng.integers(18, 90, n_persons, dtype=np.int64),
        "city": cities[rng.integers(0, n_cities, n_persons)]}}
    rels = {"KNOWS": {
        "_id": np.arange(n_persons, n_persons + n_edges, dtype=np.int64),
        "_src": rng.integers(0, n_persons, n_edges, dtype=np.int64),
        "_tgt": rng.integers(0, n_persons, n_edges, dtype=np.int64)}}
    return nodes, rels


def hop_counts(np, nodes, rels, seeds):
    """Paths from the ``seeds`` indicator ending at each node after one
    hop and after two.  A path may not use one relationship twice
    (Cypher's relationship uniqueness), so a-[r]->a-[r]->a over a
    self-loop r is taken out."""
    k = rels["KNOWS"]
    n = len(nodes["Person"]["_id"])
    hop1 = np.bincount(k["_tgt"], weights=seeds[k["_src"]], minlength=n)
    hop2 = np.bincount(k["_tgt"], weights=hop1[k["_src"]], minlength=n)
    loops = k["_src"] == k["_tgt"]
    hop2 -= np.bincount(k["_tgt"][loops], weights=seeds[k["_src"][loops]],
                        minlength=n)
    return hop1, hop2


def top_cities(np, nodes, per_node):
    """``per_node`` summed by city: the top-20 rows, count descending."""
    names, codes = np.unique(nodes["Person"]["city"], return_inverse=True)
    per_city = np.rint(np.bincount(codes, weights=per_node,
                                   minlength=len(names))).astype(np.int64)
    rows = sorted(((str(c), int(v)) for c, v in zip(names, per_city) if v),
                  key=lambda r: (-r[1], r[0]))[:20]
    return [{"city": c, "n": v} for c, v in rows]


def oracle(np, nodes, rels, age: int):
    """Per-seed out-degree weights pushed over the edges twice, then
    summed by city: (top-20 grouped rows, total 2-hop count)."""
    seeds = (nodes["Person"]["age"] == age).astype(np.int64)
    _hop1, hop2 = hop_counts(np, nodes, rels, seeds)
    return top_cities(np, nodes, hop2), int(round(hop2.sum()))


def run_info(session, result) -> dict:
    """How one query ran: fused mode, plan cache, size reads."""
    return {"mode": session.fused.last_mode,
            "plan_cache": result.metrics["plan_cache"],
            "size_syncs": result.metrics["size_syncs"]}


def check_query_launches(label: str, launches: dict, floor=None) -> None:
    """Fail unless one run of a query launched each of its kernels at
    least as often as ``floor`` (by default MIN_QUERY_LAUNCHES, the
    grouped query's) says."""
    floor = MIN_QUERY_LAUNCHES if floor is None else floor
    short = {k: launches.get(k, 0) for k in floor
             if launches.get(k, 0) < floor[k]}
    if short:
        raise RuntimeError(f"{label} did not go through the kernels: "
                           f"{short} of {launches}")


def timed_query(torch, graph, query, params):
    """(rows, result, seconds): host clock around the query and its
    materialization, ending in a synchronize."""
    t0 = time.perf_counter()
    result = graph.cypher(query, params)
    rows = result.records.to_maps()
    torch.cuda.synchronize()
    return rows, result, time.perf_counter() - t0


def run_slice(torch, np, args, card: str):
    import caps_tpu_torch
    from caps_tpu_torch import ops
    from caps_tpu_torch.interop import graph_from_numpy
    from caps_tpu_torch.ops import prefetch, probe

    t0 = time.perf_counter()
    nodes, rels = make_graph(np, args.seed, args.persons, args.edges,
                             CITIES)
    session = caps_tpu_torch.local_session()  # the card
    graph = graph_from_numpy(session, nodes, rels)
    torch.cuda.synchronize()
    ingest_s = time.perf_counter() - t0
    params = {"age": AGE}

    recorders = query_recorders() + [
        Recorder(prefetch, "prefetch_gather_cuda", lambda a: a[0].shape[0])]
    for r in recorders:
        r.__enter__()
    try:
        ops.reset_launches()
        rows, result, cold_s = timed_query(torch, graph, QUERY_GROUPED,
                                           params)
        launches = ops.launches()
    finally:
        for r in recorders:
            r.__exit__()
    for name in KERNELS:
        if launches.get(name, 0) <= 0:
            raise RuntimeError(f"main path never launched kernel {name}: "
                               f"{launches}")
    # the first query runs every family's self-test; its own launches
    # are what is left
    selftest = probe.selftest_launches()
    own = {k: launches.get(k, 0) - selftest.get(k, 0) for k in KERNELS}
    check_query_launches("the record run", own)
    runs = [run_info(session, result)]
    if runs[0]["mode"] != "record" or runs[0]["plan_cache"] != "miss":
        raise RuntimeError(f"first run was not a record run and a plan-cache "
                           f"miss: {runs[0]}")

    # the first warm run is an exact replay: keep every kernel call it
    # makes, so the kernels phase can time one query's calls
    per_query = query_recorders()
    warm = []
    for i in range(5):
        if i == 0:
            for r in per_query:
                r.__enter__()
        try:
            warm_rows, warm_result, s = timed_query(torch, graph,
                                                    QUERY_GROUPED, params)
        finally:
            if i == 0:
                for r in per_query:
                    r.__exit__()
        warm.append(s)
        runs.append(run_info(session, warm_result))
    count_rows, count_result, count_s = timed_query(torch, graph,
                                                    QUERY_COUNT, params)
    count_run = run_info(session, count_result)

    want_rows, want_count = oracle(np, nodes, rels, AGE)
    if rows != want_rows or warm_rows != want_rows:
        raise RuntimeError(f"grouped query disagrees with the oracle:\n"
                           f"got  {rows}\nwant {want_rows}")
    if count_rows != [{"c": want_count}]:
        raise RuntimeError(f"count query {count_rows} != {want_count}")
    for r in runs[1:]:
        if r != {"mode": "replay", "plan_cache": "hit", "size_syncs": 0}:
            raise RuntimeError(f"warm run was not a sync-free exact replay "
                               f"of a cached plan: {runs}")
    joined = sum(m["rows"] for m in result.metrics["operators"]
                 if m["op"] == "Join")
    warm_s = statistics.median(warm)
    emit({"phase": "slice", "card": card, "persons": args.persons,
          "edges": args.edges, "cities": CITIES, "age": AGE,
          "ingest_s": ingest_s, "cold_s": cold_s, "warm_s": warm_s,
          "warm_runs_s": warm, "count_query_s": count_s,
          "rows_joined": joined, "rows_joined_per_s": joined / warm_s,
          "two_hop_rows": want_count, "top_city": rows[0],
          "size_syncs_total": session.backend.syncs,
          "runs": runs, "count_query_run": count_run,
          # host clock per operator of the last warm run (exclusive of
          # children is not tracked: an operator's seconds include the
          # lazily evaluated inputs it pulled)
          "warm_operators": [[m["op"], m["seconds"], m["rows"]]
                             for m in warm_result.metrics["operators"]],
          "warm_phases_s": {k: warm_result.metrics[k] for k in (
              "parse_s", "ir_s", "plan_s", "relational_s", "execute_s")},
          "peak_mem_bytes": torch.cuda.max_memory_allocated(),
          "launches": launches, "selftest_launches": selftest,
          "record_run_launches": own, "oracle": "equal"})
    # each kernel's largest call of the exact replay (the record run's
    # for K4, which only the self-test launches)
    largest = {r.name: r.largest for r in recorders + per_query}
    return ({"first_run": launches, "selftest": selftest}, largest,
            {r.name: r.calls for r in per_query},
            (session, graph, nodes, rels, {"count_cold_s": count_s,
                                           "count_cold_run": count_run}))


def count_syncs(torch, fn):
    """Run ``fn`` under ``torch.cuda.set_sync_debug_mode("warn")``;
    returns (its value, the synchronizing calls warned, as
    "file:line" of the Python line that made each)."""
    torch.cuda.synchronize()
    with warnings.catch_warnings(record=True) as seen:
        warnings.simplefilter("always")
        torch.cuda.set_sync_debug_mode("warn")
        try:
            value = fn()
        finally:
            torch.cuda.set_sync_debug_mode("default")
    # the mode's own one-time notice ("prototype feature ...") is not a
    # synchronizing call: match the per-call warning only
    return value, [f"{os.path.relpath(w.filename, ROOT)}:{w.lineno}"
                   for w in seen if "called a synchronizing CUDA operation"
                   in str(w.message)]


def device_profile(torch, fn) -> dict:
    """One run of ``fn`` under ``torch.profiler``: wall time (host clock,
    profiler on), device busy time (the union of the kernels' and
    copies' intervals), the idle share, and the device time of the
    eight heaviest kernels."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall_s = time.perf_counter() - t0
    spans = sorted((e.time_range.start, e.time_range.end)
                   for e in prof.events()
                   if e.device_type == DeviceType.CUDA)
    if not spans:
        return {"wall_s": wall_s, "device_busy_s": "not measured"}
    busy, (lo, hi) = 0.0, spans[0]
    for a, b in spans[1:]:
        if a > hi:
            busy += hi - lo
            lo, hi = a, b
        else:
            hi = max(hi, b)
    busy = (busy + hi - lo) / 1e6   # profiler times are microseconds
    by_name: dict = {}
    for e in prof.events():
        if e.device_type == DeviceType.CUDA:
            by_name[e.name] = by_name.get(e.name, 0.0) + (
                e.time_range.end - e.time_range.start) / 1e3
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:8]
    return {"wall_s": wall_s, "device_busy_s": busy,
            "device_idle_share": max(0.0, 1.0 - busy / wall_s),
            "device_launches": len(spans),
            "top_kernels_ms": [[n[:60], ms] for n, ms in top]}


def run_warm(torch, np, args, card: str, state):
    """The warm query path on the slice's session: eager, exact replay,
    param-generic replay over rotating ages, and the synchronizing calls
    of one exact and one generic replay's execute part, each with its
    kernel launches counted."""
    from caps_tpu_torch import ops
    from caps_tpu_torch.relational.session import degraded_execution
    session, graph, nodes, rels, _ = state
    fused = session.fused
    want = oracle(np, nodes, rels, AGE)[0]

    # every sequence runs back to back; the oracles are checked after it
    # (host work between queries would let the card and host idle)
    eager, eager_exec = [], []
    for _ in range(5):
        with degraded_execution(no_plan_cache=True, no_fused=True):
            rows, result, s = timed_query(torch, graph, QUERY_GROUPED,
                                          {"age": AGE})
        if rows != want or result.metrics["plan_cache"] != "off":
            raise RuntimeError("eager run disagrees with the oracle or "
                               "used the plan cache")
        eager.append(s)
        eager_exec.append(result.metrics["execute_s"])

    exact, exact_exec = [], []
    for _ in range(5):
        rows, result, s = timed_query(torch, graph, QUERY_GROUPED,
                                      {"age": AGE})
        info = run_info(session, result)
        if rows != want or info != {"mode": "replay", "plan_cache": "hit",
                                    "size_syncs": 0}:
            raise RuntimeError(f"exact replay failed: {info}")
        exact.append(s)
        exact_exec.append(result.metrics["execute_s"])

    rng = np.random.default_rng(args.seed + 1)
    ages = [int(a) for a in rng.integers(18, 90, ROTATING)]
    before = (fused.recordings, fused.generic_replays, fused.mismatches)
    rotating, seq, got, generic_exec = [], [], [], []
    for age in ages:
        rows, result, s = timed_query(torch, graph, QUERY_GROUPED,
                                      {"age": age})
        rotating.append(s)
        seq.append(run_info(session, result))
        got.append(rows)
        if seq[-1]["mode"] == "replay_gen":
            generic_exec.append(result.metrics["execute_s"])
    for age, rows in zip(ages, got):
        if rows != oracle(np, nodes, rels, age)[0]:
            raise RuntimeError(f"rotating run at age {age} disagrees with "
                               f"the oracle")
    generic = [t for t, r in zip(rotating, seq) if r["mode"] == "replay_gen"]
    counts = {"recordings": fused.recordings - before[0],
              "generic_replays": fused.generic_replays - before[1],
              "mismatches": fused.mismatches - before[2]}
    if counts["generic_replays"] < 1:
        raise RuntimeError(f"no generic replay in the rotating sequence: "
                           f"{seq}")
    if any(r["size_syncs"] > 1 for r in seq[-3:]):
        raise RuntimeError(f"the rotating sequence did not settle at <= 1 "
                           f"size read a query: {seq}")

    # one exact and one generic replay's execute part (no to_maps) under
    # the sync debug mode, the launch counts zeroed just before each run
    # and read just after it.  The generic one takes an age the sequence
    # did not visit (its exact memo is empty); should that age exceed a
    # served bound, the run re-records and the next unvisited age is
    # tried, up to five.
    fresh = [a for a in range(18, 90) if a not in ages and a != AGE][:5]
    syncs, launches = {}, {}
    for label, candidates, mode in (("exact", [AGE], "replay"),
                                    ("generic", fresh, "replay_gen")):
        tried = []
        for age in candidates:
            ops.reset_launches()
            result, sites = count_syncs(
                torch, lambda: graph.cypher(QUERY_GROUPED, {"age": age}))
            rows = result.records.to_maps()
            run_launches = ops.launches()
            if rows != oracle(np, nodes, rels, age)[0]:
                raise RuntimeError(f"{label} run at age {age} disagrees "
                                   f"with the oracle")
            tried.append([age, fused.last_mode])
            if fused.last_mode == mode:
                check_query_launches(f"the {label} replay", run_launches)
                launches[label] = run_launches
                syncs[label] = {"age": age, "sync_calls": len(sites),
                                "sync_sites": sites,
                                "size_syncs": result.metrics["size_syncs"],
                                "launches": run_launches, "tried": tried}
                break
        else:
            raise RuntimeError(f"no {label} replay for the sync count: "
                               f"{tried}")

    def eager_run():
        with degraded_execution(no_plan_cache=True, no_fused=True):
            graph.cypher(QUERY_GROUPED, {"age": AGE}).records.to_maps()

    profiles = {
        "eager": device_profile(torch, eager_run),
        "exact_replay": device_profile(torch, lambda: graph.cypher(
            QUERY_GROUPED, {"age": AGE}).records.to_maps())}

    emit({"phase": "warm", "card": card,
          "eager_s": statistics.median(eager), "eager_runs_s": eager,
          "exact_replay_s": statistics.median(exact),
          "exact_runs_s": exact,
          "rotating_s": statistics.median(rotating),
          "rotating_runs_s": rotating, "ages": ages,
          "generic_replay_s": statistics.median(generic),
          # host seconds of the execute phase: under replay the time to
          # dispatch the whole query (nothing waits for the card)
          "execute_s": {"eager": statistics.median(eager_exec),
                        "exact_replay": statistics.median(exact_exec),
                        "generic_replay": statistics.median(generic_exec)},
          "rotating_size_syncs": [r["size_syncs"] for r in seq],
          "rotating_modes": [r["mode"] for r in seq], **counts,
          "sync_debug": syncs, "profiles": profiles, "oracle": "equal"})
    return launches


def query_recorders():
    """A Recorder for each kernel wrapper a query calls."""
    from caps_tpu_torch import ops
    return [Recorder(getattr(ops, mod), name, size_of)
            for mod, name, size_of in QUERY_KERNELS]


def pattern_runs(torch, session, graph, query, params, card, warm=5,
                 cold=True, recorders=()):
    """One query's cold run (unless ``cold`` is False: the caller ran it
    before) and ``warm`` repeats, each equal to the first; the launches
    of the last repeat, counted from zero, and its kernel calls kept by
    ``recorders``; peak allocated bytes.
    Returns (rows, {numbers, how each run went}, the last result)."""
    from caps_tpu_torch import ops
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    out = {"card": card}
    rows = None
    if cold:
        rows, result, out["cold_s"] = timed_query(torch, graph, query,
                                                  params)
        out["cold_run"] = run_info(session, result)
    times, runs = [], []
    for i in range(warm):
        last = i == warm - 1
        if last:
            ops.reset_launches()
            for r in recorders:
                r.__enter__()
        try:
            got, result, t = timed_query(torch, graph, query, params)
        finally:
            if last:
                for r in recorders:
                    r.__exit__()
        if rows is not None and got != rows:
            raise RuntimeError(f"repeat of {query!r} changed its rows")
        rows = got
        times.append(t)
        runs.append(run_info(session, result))
    out.update({
        "warm_s": statistics.median(times), "warm_runs_s": times,
        "replay_launches": ops.launches(),
        "strategies": {m["op"]: m["strategy"]
                       for m in result.metrics["operators"]
                       if "strategy" in m},
        "warm_runs": runs, "size_syncs": [r["size_syncs"] for r in runs],
        "peak_mem_bytes": torch.cuda.max_memory_allocated(),
        "base_mem_bytes": base})
    return rows, out, result


def expect(label, cond, detail, phase="patterns") -> None:
    if not cond:
        raise RuntimeError(f"{phase}/{label}: {detail}")


def expect_replays(label, info, reads: int, phase="patterns") -> None:
    """Every repeat an exact replay of a cached plan with ``reads`` size
    reads."""
    want = {"mode": "replay", "plan_cache": "hit", "size_syncs": reads}
    expect(label, all(r == want for r in info["warm_runs"]),
           f"repeats were not exact replays with {reads} size reads: "
           f"{info['warm_runs']}", phase)


def run_patterns(torch, np, args, card: str, state) -> dict:
    """Count pushdown and var-length expand on the slice's graph: each
    result against its numpy oracle or the port's own join cascade (a
    session with ``use_count_pushdown=False``), the strategy each query
    must take, size reads and kernel launches of its replays."""
    import caps_tpu_torch
    from caps_tpu_torch.interop import graph_from_numpy
    from caps_tpu_torch.okapi.config import EngineConfig
    session, graph, nodes, rels, slice_info = state
    age = {"age": AGE}
    t0 = time.perf_counter()
    # the same graph with its self-loops dropped: the cycle count's
    # structural guarantee (with loops it takes the join plan)
    knows = rels["KNOWS"]
    no_loops = knows["_src"] != knows["_tgt"]
    rels2 = {"KNOWS": {c: v[no_loops] for c, v in knows.items()}}
    graph2 = graph_from_numpy(session, nodes, rels2)
    cascade = caps_tpu_torch.local_session(
        config=EngineConfig(use_count_pushdown=False))
    cgraph = graph_from_numpy(cascade, nodes, rels)
    cgraph2 = graph_from_numpy(cascade, nodes, rels2)
    torch.cuda.synchronize()
    ingest_s = time.perf_counter() - t0
    out = {"phase": "patterns", "card": card, "ingest_s": ingest_s,
           "self_loops_dropped": int((~no_loops).sum())}
    persons = nodes["Person"]
    seeds = (persons["age"] == AGE).astype(np.int64)
    hop1, hop2 = hop_counts(np, nodes, rels, seeds)

    # -- 2 hops: exact replays, 24 rotating ages, the cascade ------------
    rows, info, result = pattern_runs(torch, session, graph, QUERY_COUNT,
                                      age, card, cold=False)
    info["cold_s"] = slice_info["count_cold_s"]
    info["cold_run"] = slice_info["count_cold_run"]
    expect("count_2hop", rows == [{"c": int(round(hop2.sum()))}],
           f"{rows} != oracle {hop2.sum()}")
    expect("count_2hop", info["strategies"] == {"CountPattern":
                                                "fused-spmv"},
           info["strategies"])
    expect_replays("count_2hop", info, 0)
    rng = np.random.default_rng(args.seed + 2)
    ages = [int(a) for a in rng.integers(18, 90, ROTATING)]
    gen_times, gen_runs, got = [], [], []
    for a in ages:
        r, res, t = timed_query(torch, graph, QUERY_COUNT, {"age": a})
        got.append(r)
        gen_runs.append(run_info(session, res))
        if gen_runs[-1]["mode"] == "replay_gen":
            gen_times.append(t)
    for a, r in zip(ages, got):
        want = int(round(hop_counts(
            np, nodes, rels, (persons["age"] == a).astype(np.int64))[1].sum()))
        expect("count_2hop", r == [{"c": want}],
               f"age {a}: {r} != oracle {want}")
    expect("count_2hop", all(r["mode"] in ("replay", "replay_gen")
                             and r["size_syncs"] <= 1 for r in gen_runs),
           f"rotating ages: {gen_runs}")
    expect("count_2hop", gen_times, f"no generic replay: {gen_runs}")
    info.update({"generic_s": statistics.median(gen_times),
                 "generic_runs_s": gen_times, "ages": ages,
                 "generic_size_syncs": [r["size_syncs"] for r in gen_runs],
                 "generic_modes": [r["mode"] for r in gen_runs],
                 "profile_exact_replay": device_profile(
                     torch, lambda: graph.cypher(
                         QUERY_COUNT, age).records.to_maps())})
    crows, cinfo, cres = pattern_runs(torch, cascade, cgraph, QUERY_COUNT,
                                      age, card, warm=3)
    expect("count_2hop", crows == rows, f"cascade {crows} != {rows}")
    expect("count_2hop", "CountPattern" not in
           [m["op"] for m in cres.metrics["operators"]],
           "the cascade session pushed the count down")
    info["cascade"] = cinfo
    out["count_2hop"] = info

    # -- 3 hops, against the cascade -----------------------------------------
    rows, info, _ = pattern_runs(torch, session, graph, QUERY_COUNT3, age,
                                 card)
    expect("count_3hop", info["strategies"] == {"CountPattern":
                                                "fused-spmv"},
           info["strategies"])
    expect_replays("count_3hop", info, 0)
    crows, info["cascade"], _ = pattern_runs(torch, cascade, cgraph,
                                             QUERY_COUNT3, age, card, warm=1)
    expect("count_3hop", crows == rows, f"cascade {crows} != {rows}")
    out["count_3hop"] = info

    # -- the cycle, on the loop-free graph, against the cascade ---------------
    rows, info, _ = pattern_runs(torch, session, graph2, QUERY_CYCLE, age,
                                 card)
    expect("cycle", info["strategies"] == {"CountCycle": "cycle-probe"},
           info["strategies"])
    expect_replays("cycle", info, 0)
    crows, info["cascade"], _ = pattern_runs(torch, cascade, cgraph2,
                                             QUERY_CYCLE, age, card, warm=1)
    expect("cycle", crows == rows, f"cascade {crows} != {rows}")
    out["cycle"] = info

    # -- var-expand, join form: ~13.7k seeds give more than 64 chunks --------
    # (the kernel calls of one exact replay of each form go to the
    # kernels phase, to be held against their plain versions)
    join_calls = query_recorders()
    rows, info, _ = pattern_runs(torch, session, graph, QUERY_VARLEN, age,
                                 card, recorders=join_calls)
    expect("varlen_join", rows == top_cities(np, nodes, hop1 + hop2),
           f"disagrees with the oracle: {rows}")
    expect("varlen_join", info["strategies"] == {"VarExpand": "join"},
           info["strategies"])
    expect_replays("varlen_join", info, 0)
    check_query_launches("the var-expand join form's replay",
                         info["replay_launches"])
    info["profile_exact_replay"] = device_profile(
        torch, lambda: graph.cypher(QUERY_VARLEN, age).records.to_maps())
    out["varlen_join"] = info

    # -- var-expand, matrix form: ~14 seeds ------------------------------------
    city_seeds = seeds * (np.asarray(persons["city"]) == CITY)
    c1, c2 = hop_counts(np, nodes, rels, city_seeds)
    params = {"age": AGE, "city": CITY}
    matrix_calls = query_recorders()
    rows, info, _ = pattern_runs(torch, session, graph, QUERY_VARLEN_CITY,
                                 params, card, recorders=matrix_calls)
    expect("varlen_matrix", rows == top_cities(np, nodes, c1 + c2),
           f"disagrees with the oracle: {rows}")
    expect("varlen_matrix", info["strategies"] == {"VarExpand": "matrix"},
           info["strategies"])
    expect_replays("varlen_matrix", info, 0)
    check_query_launches("the var-expand matrix form's replay",
                         info["replay_launches"], MIN_MATRIX_LAUNCHES)
    info["seeds"] = int(city_seeds.sum())
    out["varlen_matrix"] = info

    # -- var-length count ----------------------------------------------------------
    rows, info, res = pattern_runs(torch, session, graph, QUERY_VARLEN_COUNT,
                                   age, card)
    expect("varlen_count", rows == [{"c": int(round((hop1 + hop2).sum()))}],
           f"{rows} != oracle")
    expect("varlen_count", info["strategies"] == {"CountPattern":
                                                  "fused-spmv"}
           and "lengths=[1, 2]" in res.plans["relational"],
           f"{info['strategies']}: {res.plans['relational']}")
    expect_replays("varlen_count", info, 0)
    out["varlen_count"] = info
    out["count_builds"] = session.backend.count_builds
    out["phase_s"] = time.perf_counter() - t0
    emit(out)
    return ({"varlen_join": out["varlen_join"]["replay_launches"],
             "varlen_matrix": out["varlen_matrix"]["replay_launches"]},
            {"varlen_join": {r.name: r.calls for r in join_calls},
             "varlen_matrix": {r.name: r.calls for r in matrix_calls}})


def unwind_oracle(np, nodes, rels, age: int):
    """The collect/UNWIND query: one unwound row per edge out of a seed,
    so each city counts the 1-hop paths ending in it."""
    seeds = (nodes["Person"]["age"] == age).astype(np.int64)
    return top_cities(np, nodes, hop_counts(np, nodes, rels, seeds)[0])


def percentile_oracle(np, nodes, rels, age: int):
    """The DISTINCT/percentile query: per city of a seed, over the edges
    out of its seeds, the distinct target cities, the nearest-rank
    median target age and the interpolated 90th percentile (float64)."""
    person, knows = nodes["Person"], rels["KNOWS"]
    sel = person["age"][knows["_src"]] == age
    city_a = person["city"][knows["_src"][sel]]
    city_b = person["city"][knows["_tgt"][sel]]
    age_b = person["age"][knows["_tgt"][sel]]
    order = np.lexsort((age_b, city_a))
    city_a, city_b, age_b = city_a[order], city_b[order], age_b[order]
    names, starts = np.unique(city_a, return_index=True)
    ends = list(starts[1:]) + [len(city_a)]
    rows = []
    for name, lo, hi in list(zip(names, starts, ends))[:20]:
        ages = age_b[lo:hi]
        n = len(ages)
        disc = max(int(np.ceil(0.5 * n)), 1) - 1
        pos = 0.9 * (n - 1)
        low = int(np.floor(pos))
        high = min(low + 1, n - 1)
        frac = pos - low
        rows.append({"city": str(name), "nc": len(set(city_b[lo:hi])),
                     "p50": int(ages[disc]),
                     "p90": float(ages[low]) * (1.0 - frac)
                     + float(ages[high]) * frac})
    return rows


def rows_equal(got, want, float_ulps: int = 0) -> bool:
    """Equal rows in order; floats within ``float_ulps`` ulp."""
    import math
    if len(got) != len(want):
        return False
    for g, w in zip(got, want):
        if g.keys() != w.keys():
            return False
        for k, wv in w.items():
            gv = g[k]
            if isinstance(wv, float) and isinstance(gv, float):
                if abs(gv - wv) > float_ulps * math.ulp(max(abs(gv),
                                                            abs(wv))):
                    return False
            elif gv != wv:
                return False
    return True


def run_unwind(torch, np, args, card: str, state):
    """collect then UNWIND, DISTINCT aggregates with percentiles, and a
    cross join on the slice's graph: each query's cold run, exact
    replays and the warm phase's 24 rotating ages (param-generic
    replays), every run against its numpy oracle; the kernel calls of
    the last exact replay of each, its launches, and one more exact
    replay under the profiler."""
    session, graph, nodes, rels, _ = state
    person = nodes["Person"]
    n_city = int((np.asarray(person["city"]) == CITY).sum())
    oracles = {
        "collect_unwind": (QUERY_UNWIND, lambda a: {"age": a},
                           lambda a: unwind_oracle(np, nodes, rels, a)),
        "distinct_percentiles": (
            QUERY_PERCENTILES, lambda a: {"age": a},
            lambda a: percentile_oracle(np, nodes, rels, a)),
        "cross_join": (QUERY_CROSS, lambda a: {"age": a, "city": CITY},
                       lambda a: [{"n": int((person["age"] == a).sum())
                                   * n_city}]),
    }
    rng = np.random.default_rng(args.seed + 1)   # the warm phase's ages
    ages = [int(a) for a in rng.integers(18, 90, ROTATING)]
    t0 = time.perf_counter()
    out = {"phase": "unwind", "card": card, "age": AGE, "ages": ages}
    launches, calls = {}, {}
    for label, (query, params, want) in oracles.items():
        recorders = query_recorders()
        rows, info, result = pattern_runs(torch, session, graph, query,
                                          params(AGE), card,
                                          recorders=recorders)
        expect(label, rows_equal(rows, want(AGE), 2),
               f"disagrees with the oracle:\ngot  {rows}\n"
               f"want {want(AGE)}", "unwind")
        expect_replays(label, info, 0, "unwind")
        gen_times, gen_runs, got = [], [], []
        for a in ages:
            r, res, t = timed_query(torch, graph, query, params(a))
            got.append(r)
            gen_runs.append(run_info(session, res))
            if gen_runs[-1]["mode"] == "replay_gen":
                gen_times.append(t)
        for a, r in zip(ages, got):
            expect(label, rows_equal(r, want(a), 2),
                   f"age {a}: {r} != oracle {want(a)}", "unwind")
        expect(label, gen_times, f"no generic replay: {gen_runs}", "unwind")
        info.update({
            "rows": len(rows),
            "profile_exact_replay": device_profile(
                torch, lambda: graph.cypher(
                    query, params(AGE)).records.to_maps()),
            "rows_joined": sum(m["rows"] for m in result.metrics["operators"]
                               if m["op"] in ("Join", "Cross")),
            "operators": [[m["op"], m["seconds"], m["rows"]]
                          for m in result.metrics["operators"]],
            "generic_s": statistics.median(gen_times),
            "generic_runs_s": gen_times,
            "generic_size_syncs": [r["size_syncs"] for r in gen_runs],
            "generic_modes": [r["mode"] for r in gen_runs]})
        launches[label] = info["replay_launches"]
        calls[label] = {r.name: r.calls for r in recorders}
        out[label] = info
    check_query_launches("the collect/UNWIND query's replay",
                         launches["collect_unwind"], MIN_UNWIND_LAUNCHES)
    out["phase_s"] = time.perf_counter() - t0
    emit(out)
    return ({"unwind": launches["collect_unwind"]},
            {f"unwind_{k}": v for k, v in calls.items()})


def run_tck(torch, np, args, card: str) -> None:
    """The TCK corpus on the card, one session per feature file, under
    the CPU tests' strict list (``tck/blacklists/cuda.txt``): an
    unlisted scenario must match its expected table, a listed one must
    raise the error the list names or return the expected table; then
    the port's float64 sqrt on the card against numpy, bit for bit."""
    import caps_tpu_torch
    from caps_tpu_torch.backends.cuda import kernels as K
    from caps_tpu_torch.tck import NotPorted, load_features, run_scenario
    from caps_tpu_torch.tck.runner import BLACKLIST, TckFailure, load_gaps
    t0 = time.perf_counter()
    gaps = load_gaps(BLACKLIST)
    sessions = {}
    counts = {"scenarios": 0, "matched": 0, "raised_as_listed": 0,
              "listed_but_matched": 0}
    failures = []
    for scenario in load_features():
        counts["scenarios"] += 1
        session = sessions.get(scenario.feature)
        if session is None:
            session = sessions[scenario.feature] = \
                caps_tpu_torch.local_session()
        cause = gaps.get(scenario.key)
        try:
            run_scenario(session, scenario)
        except NotPorted as ex:
            if cause is not None and cause in str(ex):
                counts["raised_as_listed"] += 1
            else:
                failures.append(f"{scenario.key}: {ex}")
        except TckFailure as ex:
            failures.append(str(ex))
        else:
            counts["listed_but_matched" if cause else "matched"] += 1
    if failures:
        raise RuntimeError(f"tck: {len(failures)} scenarios failed on the "
                           f"card:\n" + "\n".join(failures[:20]))
    # the sqrt: the integers 0 … 99,999 (where PyTorch's CPU kernel is
    # one ulp off) and seeded values over 40 binades, 2^20 in all
    rng = np.random.default_rng(args.seed + 3)
    n_int = 100_000
    x = np.concatenate([np.arange(n_int, dtype=np.float64),
                        rng.random((1 << 20) - n_int)
                        * 2.0 ** rng.integers(-20, 20, (1 << 20) - n_int)])
    got = K.sqrt_f64(torch.from_numpy(x).cuda()).cpu().numpy()
    differ = int((got.view(np.int64) != np.sqrt(x).view(np.int64)).sum())
    if differ:
        raise RuntimeError(f"tck: sqrt on the card differs from np.sqrt "
                           f"in {differ} of {len(x)} values")
    emit({"phase": "tck", "card": card, **counts, "listed": len(gaps),
          "sqrt_values": len(x), "sqrt_bitwise_equal": True,
          "phase_s": time.perf_counter() - t0})


def ldbc_rows_agree(query: str, got, want) -> bool:
    """Equal in order, or, for ORDER BY … LIMIT, equal before the cutoff
    key and the same count at it (ties at the cutoff may be broken
    either way); without ORDER BY, equal as multisets."""
    from caps_tpu_torch.testing.bag import Bag
    if got == want:
        return True
    if "ORDER BY" not in query:
        return Bag(got) == want
    if "LIMIT" not in query or len(got) != len(want):
        return False
    keys = [k.strip().split()[0] for k in
            query.split("ORDER BY")[1].split("LIMIT")[0].split(",")]

    def key_of(r):
        return tuple(r[k] for k in keys)

    cutoff = key_of(want[-1])
    head_got = [r for r in got if key_of(r) != cutoff]
    head_want = [r for r in want if key_of(r) != cutoff]
    return (head_got == head_want and
            all(key_of(r) == cutoff for r in got[len(head_got):]))


def run_ldbc(torch, np, args, card: str):
    """The LDBC-like reads (IS1–IS7, IC1–IC14) on the port's generator.
    At the small scale every read with 3 parameter draws on the card
    equals the port's CPU session on the same graph; at the large scale
    each read runs cold, then 5 exact replays (each equal to an eager
    run), 3 generic draws (each equal to its eager run) and one more
    exact replay under the profiler, with IS1, IS4 and IS5 against
    numpy answers."""
    import caps_tpu_torch
    from caps_tpu_torch.datasets import ldbc
    from caps_tpu_torch.relational.session import degraded_execution
    reads = {**ldbc.SHORT_READS, **ldbc.COMPLEX_READS}
    small, large = LDBC_SCALES
    t0 = time.perf_counter()
    out = {"phase": "ldbc", "card": card, "scales": [small, large],
           "seed": LDBC_SEED}

    # -- the small scale: the card against the CPU session -----------------
    gcard, d = ldbc.build_graph(caps_tpu_torch.local_session(), small,
                                LDBC_SEED)
    gcpu, _ = ldbc.build_graph(caps_tpu_torch.local_session(device="cpu"),
                               small, LDBC_SEED)
    torch.cuda.synchronize()
    out["small_ingest_s"] = time.perf_counter() - t0
    for name, (query, make) in reads.items():
        rng = np.random.RandomState(11)
        for _ in range(LDBC_DRAWS):
            params = make(d, rng)
            got = gcard.cypher(query, params).records.to_maps()
            want = gcpu.cypher(query, params).records.to_maps()
            expect(name, ldbc_rows_agree(query, got, want),
                   f"scale {small} {params}: card {got} != cpu {want}",
                   "ldbc")
    out["small_reads_equal"] = len(reads) * LDBC_DRAWS
    out["small_s"] = time.perf_counter() - t0
    del gcard, gcpu

    # -- the large scale: cold, exact replays, generic draws --------------
    t1 = time.perf_counter()
    session = caps_tpu_torch.local_session()
    graph, d = ldbc.build_graph(session, large, LDBC_SEED)
    torch.cuda.synchronize()
    out["large_ingest_s"] = time.perf_counter() - t1
    out["large_persons"] = len(d.person_ids)
    per_read, ic12_calls, ic12_launches = {}, {}, {}
    for name, (query, make) in reads.items():
        rng = np.random.RandomState(11)
        draws = [make(d, rng) for _ in range(1 + LDBC_DRAWS)]
        recorders = query_recorders() if name == "IC12" else []
        rows, info, _ = pattern_runs(torch, session, graph, query, draws[0],
                                     card, recorders=recorders)
        with degraded_execution(no_plan_cache=True, no_fused=True):
            eager = graph.cypher(query, draws[0]).records.to_maps()
        expect(name, rows == eager, f"replays {rows} != eager {eager}",
               "ldbc")
        gen_times, gen_runs = [], []
        for params in draws[1:]:
            got, res, t = timed_query(torch, graph, query, params)
            gen_runs.append(run_info(session, res))
            gen_times.append(t)
            with degraded_execution(no_plan_cache=True, no_fused=True):
                eager = graph.cypher(query, params).records.to_maps()
            expect(name, got == eager, f"draw {params}: {got} != eager "
                   f"{eager}", "ldbc")
        info.update({"rows": len(rows), "draw_s": gen_times,
                     "draw_runs": gen_runs,
                     "profile_exact_replay": device_profile(
                         torch, lambda: graph.cypher(
                             query, draws[0]).records.to_maps())})
        per_read[name] = info
        if name == "IC12":
            ic12_calls = {r.name: r.calls for r in recorders}
            ic12_launches = info["replay_launches"]
    # IS1, IS4, IS5 against the generator's arrays
    i = len(d.person_ids) // 3
    got = graph.cypher(ldbc.SHORT_READS["IS1"][0],
                       {"personId": int(d.person_ids[i])}).records.to_maps()
    expect("IS1", got == [{
        "firstName": d.person_first[i], "lastName": d.person_last[i],
        "birthday": int(d.person_birthday[i]),
        "cityId": int(d.city_ids[d.person_city[i]]),
        "creationDate": int(d.person_creation[i])}], got, "ldbc")
    j = len(d.post_ids) // 3
    mid, creator = int(d.post_ids[j]), int(d.post_creator[j])
    got = graph.cypher(ldbc.SHORT_READS["IS4"][0],
                       {"messageId": mid}).records.to_maps()
    expect("IS4", got == [{"messageCreationDate": int(d.post_creation[j]),
                           "messageId": mid}], got, "ldbc")
    got = graph.cypher(ldbc.SHORT_READS["IS5"][0],
                       {"messageId": mid}).records.to_maps()
    expect("IS5", got == [{"personId": int(d.person_ids[creator]),
                           "firstName": d.person_first[creator],
                           "lastName": d.person_last[creator]}], got, "ldbc")
    out["large"] = per_read
    out["numpy_checked"] = ["IS1", "IS4", "IS5"]
    out["phase_s"] = time.perf_counter() - t0
    emit(out)
    return {"ldbc_ic12": ic12_launches}, {"ldbc_ic12": ic12_calls}


def run_selftest(card: str) -> None:
    """Seconds of each family's first self-test (in the slice's first
    query); a second request must launch nothing."""
    import torch
    from caps_tpu_torch import ops
    from caps_tpu_torch.ops import probe
    seconds = probe.selftest_seconds()
    if sorted(seconds) != sorted(probe.FEATURES):
        raise RuntimeError(f"self-tests run: {seconds}")
    ops.reset_launches()
    for feature in probe.FEATURES:
        ops.ensure_kernels(feature, torch.device("cuda"))
    if ops.launches():
        raise RuntimeError(f"a second self-test request launched "
                           f"{ops.launches()}")
    emit({"phase": "selftest", "card": card, "first_call_s": seconds,
          "second_call_launches": 0})


def check_equal(torch, name, got, want, rtol=0.0, atol=0.0) -> float:
    """Max abs difference over a tuple of outputs; raises past tolerance.
    Floats: a NaN equals a NaN in the same place and nothing else."""
    got = got if isinstance(got, tuple) else (got,)
    want = want if isinstance(want, tuple) else (want,)
    err = 0.0
    for g, w in zip(got, want):
        if g.shape != w.shape or g.dtype != w.dtype:
            raise RuntimeError(f"{name}: {g.shape} {g.dtype} vs plain "
                               f"{w.shape} {w.dtype}")
        if g.dtype.is_floating_point:
            g_nan, w_nan = torch.isnan(g), torch.isnan(w)
            if not torch.equal(g_nan, w_nan):
                raise RuntimeError(f"{name}: kernel and plain version have "
                                   f"NaNs in different places")
            same = g_nan | (torch.isinf(g) & (g == w))
            diff = torch.where(same, torch.zeros_like(g, dtype=torch.float64),
                               (g.double() - w.double()).abs())
            ok = diff <= atol + rtol * torch.where(
                same, torch.zeros_like(diff), w.double().abs())
        else:
            diff = (g.long() - w.long()).abs()
            ok = diff == 0
        if not bool(ok.all()):
            raise RuntimeError(f"{name}: kernel disagrees with plain version "
                               f"(max abs err {float(diff.max())})")
        if diff.numel():
            err = max(err, float(diff.max()))
    return err


def bits(torch, t):
    """The raw bits of a 32-bit tensor, so -0.0 != +0.0 and a NaN
    equals a NaN of the same bits."""
    return t.view(torch.int32) if t.dtype == torch.float32 else t


def segment_cases(torch, S, dev):
    """K1's edge cases: every kind at S in {1, 3, 1001, 4096, 5000,
    70000} over 1,400,017 rows (1 % of float rows +-0, NaN of both
    signs or +-inf), a 90 %-one-code skew, n in {0, 1, 3} and a view one
    row in (not 16-byte aligned)."""
    gen = torch.Generator(device=dev).manual_seed(1)
    special = torch.tensor([0.0, -0.0, float("nan"), -float("nan"),
                            float("inf"), -float("inf")], device=dev)

    def draw(kind, n, s, skew=False):
        codes = torch.randint(0, s, (n,), generator=gen, device=dev,
                              dtype=torch.int32)
        if skew:
            codes[torch.rand(n, generator=gen, device=dev) < 0.9] = s // 2
        ok = torch.rand(n, generator=gen, device=dev) < 0.8
        if kind.endswith("f32"):
            vals = torch.randn(n, generator=gen, device=dev)
            pick = torch.rand(n, generator=gen, device=dev) < 0.01
            vals[pick] = special[torch.randint(
                0, 6, (n,), generator=gen, device=dev)[pick]]
        elif kind == "count":
            vals = codes
        else:
            vals = torch.randint(-1000, 1000, (n,), generator=gen,
                                 device=dev, dtype=torch.int32)
        return codes, ok, vals

    n = 1_400_000 + 17     # the slice's scale, not a multiple of 4
    cases = []
    for kind in S.KINDS:
        for s in (1, 3, 1001, 4096, 5000, 70000):
            cases.append((f"{kind}/S={s}", (*draw(kind, n, s), s, kind)))
        codes, ok, vals = draw(kind, n, 1001, skew=True)
        cases.append((f"{kind}/S=1001/skew", (codes, ok, vals, 1001, kind)))
        cases.append((f"{kind}/S=1001/misaligned",
                      (codes[1:], ok[1:], vals[1:], 1001, kind)))
        for small in (0, 1, 3):
            cases.append((f"{kind}/S=1001/n={small}",
                          (*draw(kind, small, 1001), 1001, kind)))
    codes = torch.zeros(3000, dtype=torch.int32, device=dev)
    cases.append(("all_masked", (codes, torch.zeros_like(codes, dtype=torch.bool),
                                 codes, 7, "max_i32")))
    return cases


def segment_bound(a):
    """(bound ms, by) of one K1 call: codes and ok read once, values
    too unless the kind is count, out written once."""
    codes, _, _, s, kind = a
    n = codes.shape[0]
    return bound(5 * n + (0 if kind == "count" else 4 * n) + 4 * s, n)


def check_segment(torch, main_args, calls, dev, pattern_calls=()):
    from caps_tpu_torch.ops import segment as S
    cases = [("main_path", main_args)]
    cases += [(f"replay_call_{i}", a) for i, a in enumerate(calls)]
    cases += list(pattern_calls)
    cases += segment_cases(torch, S, dev)
    err = 0.0
    for label, a in cases:
        tol = (1e-5, 1e-5) if a[4] == "sum_f32" else (0.0, 0.0)
        got = S.dense_segment_agg_cuda(*a)
        again = S.dense_segment_agg_cuda(*a)
        want = S.dense_segment_agg_plain(*a)
        e = check_equal(torch, f"segment_agg[{label}]", got, want, *tol)
        if not torch.equal(bits(torch, got), bits(torch, again)):
            raise RuntimeError(f"segment_agg[{label}]: two calls differ")
        if a[4] != "sum_f32" and not torch.equal(bits(torch, got),
                                                  bits(torch, want)):
            raise RuntimeError(f"segment_agg[{label}]: kernel and plain "
                               f"version differ in their bits")
        if label == "main_path":
            err = e
    codes, ok, vals, s, kind = main_args
    safe = torch.where(ok, codes, torch.full_like(codes, s))
    ms = time_ms(torch, lambda: S.dense_segment_agg_cuda(*main_args))
    call_ms = time_calls(torch, S.dense_segment_agg_cuda, calls)
    plain_ms = time_ms(torch, lambda: S.dense_segment_agg_plain(*main_args))
    library_ms = time_ms(torch, lambda: torch.bincount(safe, minlength=s + 1))
    b, by = segment_bound(main_args)
    # the edge shapes beside the main one, each with its bound
    by_label = dict(cases)
    shapes = {}
    for label in ("count/S=1", "count/S=3", "count/S=4096",
                  "count/S=1001/skew", "count/S=70000", "max_f32/S=1001",
                  "sum_f32/S=1001", "sum_f32/S=4096"):
        a = by_label[label]
        shapes[label] = {"n": a[0].shape[0],
                         "ms": time_ms(torch, lambda a=a:
                                       S.dense_segment_agg_cuda(*a)),
                         "bound_ms": segment_bound(a)[0]}
    return {"max_abs_err": err, "ms": ms, "ms_per_query": sum(call_ms),
            "call_ms": call_ms, "plain_ms": plain_ms,
            "bound_ms": b, "bound_by": by, "library_ms": library_ms,
            "cases": len(cases), "deterministic": "bitwise, every case",
            "shape": {"n": codes.shape[0], "S": s, "kind": kind},
            "geometry": S.segment_geometry(codes.shape[0], s, kind,
                                           S._sm_count(dev.index or 0)),
            "shapes": shapes,
            # an empty kernel timed the same way: what any launch costs
            "launch_floor_ms": time_ms(torch, lambda: torch.cuda._sleep(0)),
            # device time and launches by kernel name, per call
            "device_ms_by_kernel": {
                "main_path": kernel_split_ms(
                    torch, lambda: S.dense_segment_agg_cuda(*main_args)),
                "count/S=70000": kernel_split_ms(
                    torch, lambda: S.dense_segment_agg_cuda(
                        *by_label["count/S=70000"]))},
            "library_call": "torch.bincount"}


def time_calls(torch, fn, calls) -> list:
    """Median device time of ``fn`` on each recorded call's arguments."""
    return [time_ms(torch, lambda a=a: fn(*a)) for a in calls]


def kernel_split_ms(torch, fn, reps: int = 10) -> dict:
    """Device ms and launches per call of ``fn`` by kernel name, from
    one ``torch.profiler`` run of ``reps`` calls."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    by_name: dict = {}
    for e in prof.events():
        if e.device_type == DeviceType.CUDA:
            name = e.name.split("(")[0][:60]
            ms, n = by_name.get(name, (0.0, 0))
            by_name[name] = (ms + (e.time_range.end - e.time_range.start)
                             / 1e3 / reps, n + 1)
    return ({k: {"ms": ms, "launches": n / reps}
             for k, (ms, n) in by_name.items()}
            or {"device time": "not measured"})


def check_expand(torch, main_args, calls, dev, pattern_calls=()):
    from caps_tpu_torch.ops import expand as X
    counts, lo, out_cap = main_args
    gen = torch.Generator(device=dev).manual_seed(2)

    def rnd(n, hi=5, dtype=torch.int64):
        return torch.randint(0, hi, (n,), generator=gen, device=dev,
                             dtype=dtype)

    def case(c, lo_, out):
        return (c, lo_, int(out))

    cases = [("main_path", main_args)]
    cases += [(f"replay_call_{i}", a) for i, a in enumerate(calls)]
    cases += list(pattern_calls)
    cases.append(("main_path_int64", (counts.long(), lo.long(), out_cap)))
    zrun = rnd(3 * X.NV, dtype=torch.int32)
    zrun[:X.NV + 500] = 0                 # zero rows over more than a tile
    cases.append(("zero_run_over_a_tile", case(
        zrun, rnd(3 * X.NV, 10 ** 6, torch.int32), zrun.sum() + 1000)))
    big = rnd(1000, 3)
    big[500] = 50 * X.NV                  # one row over 50 tiles
    cases.append(("row_over_many_tiles", case(
        big, rnd(1000, 2 ** 31 - 1), big.sum() + 123)))
    full = rnd(5000)
    cases.append(("total_eq_out_cap", case(full, rnd(5000, 10 ** 6),
                                           full.sum())))
    cases.append(("total_zero", case(torch.zeros(5000, dtype=torch.int32,
                                                 device=dev),
                                     rnd(5000, 100, torch.int32), 4096)))
    cases.append(("cap_l_1", case(torch.tensor([7777], device=dev),
                                  torch.tensor([5], device=dev), 8192)))
    sparse = torch.zeros(100_000, dtype=torch.int32, device=dev)
    sparse[::97] = 3                      # cap_l > out_cap
    cases.append(("cap_l_over_out_cap", case(sparse, rnd(100_000, 10 ** 6),
                                             4096)))
    cases.append(("out_cap_not_tile_multiple", case(
        rnd(700), torch.arange(700, device=dev, dtype=torch.int32),
        3 * X.NV + 77)))
    cases.append(("int32_counts_int64_lo", case(
        counts, lo.long() + 2 ** 31, out_cap)))   # r_pos wraps as int32
    err = 0.0
    for label, a in cases:
        e = check_equal(torch, f"expand_positions[{label}]",
                        X.expand_positions_cuda(*a),
                        X.expand_positions_plain(*a))
        if label == "main_path":
            err = e
    offsets = torch.cumsum(counts, 0)
    t = torch.arange(out_cap, device=dev)
    ms = time_ms(torch, lambda: X.expand_positions_cuda(*main_args))
    call_ms = time_calls(torch, X.expand_positions_cuda, calls)
    plain_ms = time_ms(torch, lambda: X.expand_positions_plain(*main_args))
    library_ms = time_ms(torch, lambda: torch.searchsorted(offsets, t,
                                                           right=True))
    # the earlier design's prelude (torch cumsum to int32 and the lo
    # cast), which the scan passes replace
    prelude_ms = time_ms(torch, lambda: (
        torch.cumsum(counts, 0, dtype=torch.int32), lo.to(torch.int32)))
    # device ms by kernel (scan passes against the expand pass), for
    # each call of the replay
    split = [kernel_split_ms(torch, lambda a=a: X.expand_positions_cuda(*a))
             for a in calls]
    cap_l = counts.shape[0]
    total = int(offsets[-1])
    b, by = bound(cap_l * (counts.element_size() + lo.element_size())
                  + out_cap * 9, out_cap + cap_l)
    return {"max_abs_err": err, "ms": ms, "ms_per_query": sum(call_ms),
            "call_ms": call_ms, "plain_ms": plain_ms,
            "bound_ms": b, "bound_by": by, "library_ms": library_ms,
            "prelude_torch_ms": prelude_ms, "device_ms_by_kernel": split,
            "cases": len(cases),
            "shape": {"cap_l": cap_l, "out_cap": out_cap, "total": total},
            "call_shapes": [[a[0].shape[0], a[2]] for a in calls],
            "library_call": "torch.searchsorted"}


def check_sort(torch, main_args, calls, dev, pattern_calls=()):
    from caps_tpu_torch.backends.cuda import kernels as K
    from caps_tpu_torch.ops import sort as S
    (planes,) = main_args
    gen = torch.Generator(device=dev).manual_seed(3)

    def ties(cap, n):
        return [torch.randint(0, 3, (cap,), generator=gen, device=dev,
                              dtype=torch.int32) for _ in range(n)]

    cases = [("main_path", planes)]
    cases += [(f"replay_call_{i}", a[0]) for i, a in enumerate(calls)]
    cases += [(label, a[0]) for label, a in pattern_calls]
    cap = 256
    while S.sort_cap_supported(cap):
        for n in (1, 3, 10):              # merge passes run above cap 1024
            p = ties(cap, n)
            if n > 1:
                p[0].fill_(-5)            # a constant plane, dropped
            cases.append((f"ties/P={n}/cap={cap}", p))
        cap *= 2
    cap = 4096
    ramp = torch.arange(cap, device=dev, dtype=torch.int32)
    cases += [("all_equal", [torch.full((cap,), 9, dtype=torch.int32,
                                        device=dev)] * 3),
              ("sorted", [ramp // 7, ramp]),
              ("reversed", [-ramp // 7, -ramp]),
              ("wide_values", [torch.randint(-2 ** 31, 2 ** 31 - 1, (cap,),
                                             generator=gen, device=dev,
                                             dtype=torch.int32)
                               for _ in range(2)]),
              ("stacked_planes/P=65/cap=512", ties(512, 65)),
              # many planes: smaller chunks (512, 256) and their merge
              # passes, through the pointer and the stacked route
              ("chunk_512/P=50/cap=4096", ties(4096, 50)),
              ("chunk_256/P=100/cap=2048", ties(2048, 100))]
    pick = torch.randint(0, 7, (cap,), generator=gen, device=dev)
    table = torch.tensor([-1.5, 0.0, -0.0, 2.0, float("inf"),
                          float("-inf"), float("nan")], dtype=torch.float64,
                         device=dev)
    cases.append(("f64", S.split_planes(
        [table[pick], torch.randint(0, 3, (cap,), generator=gen,
                                    device=dev)])))
    err = 0.0
    for label, p in cases:
        e = check_equal(torch, f"bitonic_sort[{label}]",
                        S.bitonic_sort_perm_cuda(p),
                        S.bitonic_sort_perm_plain(p))
        if label == "main_path":
            err = e
    cap = planes[0].shape[0]
    wide = [p.to(torch.int64) for p in planes]
    ms = time_ms(torch, lambda: S.bitonic_sort_perm_cuda(planes))
    call_ms = time_calls(torch, S.bitonic_sort_perm_cuda, calls)
    plain_ms = time_ms(torch, lambda: S.bitonic_sort_perm_plain(planes))
    library_ms = time_ms(torch, lambda: K.sort_perm(wide, cap))
    levels = cap.bit_length() - 1
    stages = levels * (levels + 1) // 2
    b, by = bound(4 * cap * (len(planes) + 1),
                  stages * (cap // 2) * (len(planes) + 1))
    return {"max_abs_err": err, "ms": ms, "ms_per_query": sum(call_ms),
            "call_ms": call_ms, "plain_ms": plain_ms,
            "bound_ms": b, "bound_by": by, "library_ms": library_ms,
            "cases": len(cases),
            "geometry": dict(zip(("chunk", "smem_bytes", "merge_passes"),
                                 S.sort_geometry(cap, len(planes)))),
            "shape": {"cap": cap, "planes": len(planes)},
            "call_shapes": [[a[0][0].shape[0], len(a[0])] for a in calls],
            "library_call": "torch.sort(stable) chained over the keys"}


def check_prefetch(torch, main_args, dev):
    from caps_tpu_torch.ops import prefetch as P
    x, blk, tile = main_args
    gen = torch.Generator(device=dev).manual_seed(4)
    n_big = 1 << 16
    big_x = torch.randint(-2 ** 30, 2 ** 30, (tile * n_big,), generator=gen,
                          device=dev, dtype=torch.int32)
    big_blk = torch.randint(0, n_big, (n_big,), generator=gen, device=dev,
                            dtype=torch.int32)   # repeats: a random draw
    cases = [("main_path", main_args), ("tiles=65536", (big_x, big_blk, 256)),
             ("tile=100", (torch.arange(700, dtype=torch.int32, device=dev),
                           torch.tensor([6, 0, 3, 3], dtype=torch.int32,
                                        device=dev), 100))]
    err = 0.0
    for label, (a, b, t) in cases:
        out, bad = P.prefetch_gather_cuda(a, b, t)
        if int(bad):
            raise RuntimeError(f"prefetch_gather[{label}]: in-range blocks "
                               f"flagged")
        e = check_equal(torch, f"prefetch_gather[{label}]", out,
                        P.prefetch_gather_plain(a, b, t))
        if label == "main_path":
            err = e
    # one out-of-range block: the flag is set, that tile is zeros, the
    # other tiles agree with the plain version, nothing is read past x
    oob = blk.clone()
    oob[1] = x.shape[0] // tile
    out, bad = P.prefetch_gather_cuda(x, oob, tile)
    if int(bad) != 1:
        raise RuntimeError("prefetch_gather: out-of-range block not flagged")
    good = torch.ones(oob.shape[0], dtype=torch.bool, device=dev)
    good[1] = False
    check_equal(torch, "prefetch_gather[out_of_range]",
                out.view(-1, tile)[good].reshape(-1),
                P.prefetch_gather_plain(x, oob[good], tile))
    if bool(out.view(-1, tile)[1].any()):
        raise RuntimeError("prefetch_gather: out-of-range tile not zeroed")

    def timings(a, b, t):
        n_tiles = b.shape[0]
        ms = time_ms(torch, lambda: P.prefetch_gather_cuda(a, b, t))
        plain_ms = time_ms(torch, lambda: P.prefetch_gather_plain(a, b, t))
        library_ms = time_ms(torch, lambda: torch.index_select(
            a.view(-1, t), 0, b).mul_(2))
        bound_ms, by = bound(8 * t * n_tiles + 4 * n_tiles, t * n_tiles)
        return {"ms": ms, "plain_ms": plain_ms, "library_ms": library_ms,
                "bound_ms": bound_ms, "bound_by": by,
                "shape": {"tile": t, "n_tiles": n_tiles}}

    main = timings(x, blk, tile)
    # a query launches it no time (the self-test does, once a process)
    return {"max_abs_err": err, "ms_per_query": 0.0, **{k: main[k] for k in (
                "ms", "plain_ms", "bound_ms", "bound_by", "library_ms")},
            "cases": len(cases) + 1, "shape": main["shape"],
            "at_16Mi": timings(big_x, big_blk, 256),
            "library_call": "torch.index_select(...).mul_(2)"}


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--seed", type=int, default=0)
    # --persons / --edges shrink the graph for a quick first call after a
    # kernel change; the defaults are the slice's size
    ap.add_argument("--persons", type=int, default=1_000_000)
    ap.add_argument("--edges", type=int, default=10_000_000)
    args = ap.parse_args()

    if not os.path.isdir(os.path.join(ROOT, "caps_tpu_torch")):
        print("chip_smoke.py: caps_tpu_torch/ not found beside this script",
              file=sys.stderr)
        return 2
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke.py: CUDA is not available; this script needs a "
              "card", file=sys.stderr)
        return 2
    sys.path.insert(0, ROOT)
    import numpy as np
    from caps_tpu_torch.ops import build

    card = card_line()
    emit({"phase": "env", "python": sys.version.split()[0],
          "torch": torch.__version__, "cuda": torch.version.cuda,
          "device": torch.cuda.get_device_name(0),
          "device_count": torch.cuda.device_count(), "card": card})

    t0 = time.perf_counter()
    libs = build.build()
    emit({"phase": "build", "seconds": time.perf_counter() - t0,
          "libraries": [os.path.basename(str(p)) for p in libs]})

    launches, main_args, query_calls, state = run_slice(torch, np, args,
                                                        card)
    launches.update(run_warm(torch, np, args, card, state))
    pattern_launches, pattern_calls = run_patterns(torch, np, args, card,
                                                   state)
    launches.update(pattern_launches)
    unwind_launches, unwind_calls = run_unwind(torch, np, args, card, state)
    launches.update(unwind_launches)
    pattern_calls.update(unwind_calls)
    del state
    run_tck(torch, np, args, card)
    ldbc_launches, ldbc_calls = run_ldbc(torch, np, args, card)
    launches.update(ldbc_launches)
    pattern_calls.update(ldbc_calls)
    run_selftest(card)

    def of_patterns(wrapper):
        """Every call of ``wrapper`` in one exact replay of each
        var-expand form, of each unwind-phase query and of IC12,
        labelled by query."""
        return [(f"{form}_call_{i}", a)
                for form, calls in pattern_calls.items()
                for i, a in enumerate(calls[wrapper])]

    dev = torch.device("cuda")
    checks = {}
    for name, wrapper, check in (
            ("segment_agg", "dense_segment_agg_cuda", check_segment),
            ("expand_positions", "expand_positions_cuda", check_expand),
            ("bitonic_sort", "bitonic_sort_perm_cuda", check_sort)):
        checks[name] = check(torch, main_args[wrapper], query_calls[wrapper],
                             dev, of_patterns(wrapper))
        # the calls of the var-expand forms, the unwind-phase queries and
        # IC12 held against the plain version, by query
        checks[name]["pattern_calls"] = {
            form: len(calls[wrapper]) for form, calls in pattern_calls.items()}
    checks["prefetch_gather"] = check_prefetch(
        torch, main_args["prefetch_gather_cuda"], dev)
    for name, c in checks.items():
        emit({"phase": "kernel", "name": name, "card": card, **c})

    kernels = []
    for name, (source, replaces) in KERNELS.items():
        c = checks[name]
        kernels.append({
            "name": name, "route": "cuda", "source": source,
            "replaces": replaces, "launches": launches["first_run"][name],
            # the first run's launches made by the kernel self-test, and
            # those of one exact and one generic replay, each counted
            # from zero for that run
            "launches_selftest": launches["selftest"].get(name, 0),
            "launches_exact_replay": launches["exact"].get(name, 0),
            "launches_generic_replay": launches["generic"].get(name, 0),
            # one exact replay of the grouped var-expand, join form and
            # matrix form
            "launches_varlen_join_replay": launches["varlen_join"].get(
                name, 0),
            "launches_varlen_matrix_replay": launches["varlen_matrix"].get(
                name, 0),
            # one exact replay of the collect/UNWIND query and of IC12 at
            # the large LDBC scale
            "launches_unwind_replay": launches["unwind"].get(name, 0),
            "launches_ldbc_ic12_replay": launches["ldbc_ic12"].get(name, 0),
            "max_abs_err": c["max_abs_err"], "ms": c["ms"],
            # the sum over the calls of one exact replay, each timed
            "ms_per_query": c["ms_per_query"],
            "plain_ms": c["plain_ms"], "bound_ms": c["bound_ms"],
            "bound_by": c["bound_by"], "library_ms": c["library_ms"]})
    emit({"kernels": kernels})
    print(card, flush=True)
    emit({"ok": True, "device": {"platform": "gpu",
                                 "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
