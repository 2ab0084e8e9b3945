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
                graph.  The session plans as the port does by default,
                with the cost model, WCOJ and re-planning on; the grouped
                query's plan must be the one the fixed heuristics give;
  4. warm     — on the same session: the eager path (plan cache and fused
                replay off), exact replays (0 size reads each), and 24
                rotating ``$age`` values (param-generic replay), each equal
                to its own numpy oracle; one exact and one generic replay
                run under ``torch.cuda.set_sync_debug_mode("warn")``;
  5. patterns — on a ``use_cost_model=False`` session (the fixed
                heuristics' plans): the ``count(*)`` form on count
                pushdown (``fused-spmv``: 5 exact replays with 0 size
                reads, 8 rotating ``$age`` values against the oracle, the
                join cascade of a ``use_count_pushdown=False`` session),
                the 3-hop count and the cycle count (``cycle-probe``, on
                the graph with its self-loops dropped) against the
                cascade, the var-length grouped query in its join form
                (K1, K2 and K3 launched by a replay) and, with
                ``a.city = $city``, its matrix form, each against the
                oracle, and the var-length ``count(*)``; per query the
                cold and warm latencies, strategy, size reads, launches
                and peak allocated bytes; then each query's plan on the
                slice's session, and where the cost model plans otherwise
                (the cascade for a selective seed) its run there, on the
                strategy its EXPLAIN cost section chose;
  6. unwind   — on the same session: collect then UNWIND, DISTINCT
                count with percentileDisc and percentileCont, and a cross
                join of about 13.3M rows; per query its cold run, exact
                replays (0 size reads) and the warm phase's 8 rotating
                ``$age`` values, each against its numpy oracle, with
                launches, size reads, peak allocated bytes and the
                device busy time of one exact replay (``torch.profiler``);
  7. lists    — list expressions on the slice's session and graph: a
                seeded query whose lambdas range over collected friends
                (a comprehension, ``all``, ``single`` and ``reduce`` over
                their properties, ``labels`` and ``keys``), the whole
                graph's collected ages folded by comprehension, ``any``
                and ``reduce`` then grouped by city, and var-length paths
                ordered by two list keys (``nodes(p)`` through the
                relationship index; with a city filter too, whose few
                rows sort on K3); each cold, 5 exact replays (0 size
                reads) and, for the first, the 8 rotating ages, every
                run against a numpy oracle, with launches, size reads,
                peak allocated bytes and one exact replay's device busy
                time (``torch.profiler``);
     values, gaps — each in a session of its own over the slice's
                arrays: temporal values, maps and mixed values (V1–V4),
                then the expressions and aggregations the JAX package
                answers on its host fallback (G1–G8 over the 2-hop rows
                of ``$age``); each query cold and 5 exact replays (0 size
                reads) against a numpy oracle, with its held-value reads,
                K1–K3 launches, peak bytes and busy time;
     nested   — nested list columns, in a session of its own over the
                slice's arrays with a seeded list-of-lists ``visits`` on
                every person (0-8 inner lists of 0-6 int64 values; 10 %
                null rows, 5 % null inner lists, 15 % null values),
                ingested through ``from_columns`` (its seconds and device
                bytes): N1 both levels unwound and grouped by city on
                K1, N2 three levels collected over the 2-hop rows and
                read back, N3 1-hop rows grouped and ordered by
                ``visits``, N4 three levels of mixed values built by
                comprehensions and folded, N5 inner lists compared
                across a hop; each cold and 5 exact replays (0 size
                reads) against a numpy oracle, with K1–K3 launches, peak
                bytes and one exact replay's busy time and idle share;
     mixed    — lists and maps among values of other types, in a session
                of its own over the slice's arrays: X1 a list-or-string
                CASE grouped and ordered, X2 a string, a list and a map
                unwound and counted DISTINCT, X3 toString of a map
                grouped on K1, X4 a reduce whose accumulator turns into
                maps over the 2-hop rows, X5 a UNION ALL of a list and a
                string column, X6 lists of two depths chosen and
                compared; each cold and 5 exact replays (0 size reads)
                against a numpy oracle, with its held-value reads, K1–K3
                launches, peak bytes and one exact replay's busy time
                and idle share;
  8. cyclic   — the seeded triangle on the slice's graph through the
                multiway join (MultiwayJoinOp, K2 for every extend and
                close): cold, 5 exact replays (0 size reads, no
                synchronizing call), the 8 rotating ages, each against a
                numpy oracle, and the cascade; then bench config 10 at its
                TPU size (100,000 :Person, uniform :KNOWS at densities 4,
                8 and 16): the triangle, diamond and 4-cycle enumerated
                (cold and 3 exact replays), each a bag of id rows equal
                to a numpy oracle and, where
                its open rows stay at or under 16M (the card holds the
                cascade's intermediate tables up to there), to the
                forced cascade;
  9. profile  — on the slice's session: PROFILE of the grouped query
                eager with per-operator sync (timing tag ``device``) and
                on an exact replay without it (``dispatch`` and one
                aggregate device span), each operator's profiled rows
                equal to the run's; the plain query after it hits the
                plan cache with no profile text and replays with 0 size
                reads and no synchronizing call; device time by
                ``caps_tpu_torch.<Op>`` range (``torch.profiler``); a
                traced run exported as a Chrome trace; exact-replay
                latency with tracing off, on and under PROFILE; the
                ``compile.*`` and ``mem.*`` metrics;
 10. updates  — the slice's graph wrapped by ``versioned`` (the base
                never changes): the structures the write path reads over
                the base, each timed on first use; 500 LDBC-SNB-Interactive-shaped
                writes (edge inserts, person creates, property sets,
                relationship and detaching node deletes) in an order
                drawn from --seed, the grouped query after every 100
                equal to a numpy oracle of the mutated arrays and a
                snapshot pinned before the first write equal to the
                base's answer; 5 exact replays on the final snapshot (0
                size reads, no synchronizing call); an aborted write
                (``testing/faults.py abort_write``) that changes neither
                the version nor the string pool, and its retry; a
                compaction, after which the query reads the same; write
                latency by kind, the first commit, fresh and stable
                snapshot reads, delta rows and bytes, tombstones,
                compaction seconds, peak bytes and launches; and
                ``algo.degree()`` on the final snapshot against the
                mutated arrays;
 11. construct — CONSTRUCT / RETURN GRAPH on the slice's graph, stored
                as ``session.base``: a new graph of the seeds' clones and
                one ``:MET`` per ``:KNOWS`` edge out of them (its grouped
                query against numpy, its minted ids disjoint from the
                base's), the same edges ON the base (a union: the grouped
                2-hop query gives the base's answer), and the overlay
                (SET on the persons of a base cut by 10, 100k persons and
                1M edges, since the overlay copies its base on the host:
                the grouped query at age + 100 gives that base's answer);
                each CONSTRUCT's seconds split into the driving MATCH,
                the entity build and the table build, warm latencies,
                peak bytes and launches;
 12. fs       — the slice's graph stored through the port's
                ``FSGraphSource`` as parquet (a temporary directory
                outside the repository, removed at the end) and loaded
                by a fresh session from the ``fs`` namespace: the
                grouped query on it cold, 5 exact replays (0 size reads)
                and the 8 rotating ages, each equal to the numpy oracle,
                its replay's kernel calls held in the kernels phase; the
                federated MATCH of BASELINE config 5 across
                ``session.base`` and ``fs.social`` against numpy; store
                and load seconds (the Arrow read, the column build, the
                upload), bytes on disk, peak card memory;
 13. graph500 — BASELINE config 4: ``rmat_edges(18, 16, seed=1)``
                canonicalized (3,806,326 edges over 2^18 vertices; scale
                22 cut to 18) and the triangle count on the default
                session (``CountCycle`` / ``cycle-probe``), cold and 3
                exact replays against a scipy oracle run in a child
                process meanwhile; edges joined per second, peak bytes,
                size reads, the launches and idle share of one replay
                under the profiler (none of the hand-written kernels);
 14. algo     — ``CALL algo.*`` on the slice's graph ingested once more
                with a float ``w`` per edge (uniform 1-10 from --seed),
                with the native host runtime and with it opted out
                (string encode, CSR build and upload timed apart); the
                five procedures each cold and 5 warm (exact replays),
                every run equal to the numpy kernels of
                ``caps_tpu_torch/algo/kernels.py`` with their iteration
                counts, on ``device-fixpoint`` / ``edge-list``: per call
                the latency, the operator's split (graph arrays,
                fixpoint, emit), synchronizing calls, size reads, peak
                bytes and compile charges; two PageRank runs with one
                digest; the top 20 by PageRank with their cities; then
                each procedure on a 2,000-node graph of 600,000 edges on
                the ``dense-tile`` layout;
 15. serve    — ``QueryServer`` on the card over the slice's graph: 8
                closed-loop clients send 400 requests (80 % the grouped
                query, 20 % its ``count(*)`` form on count pushdown,
                ``$age`` over the warm phase's rotating ages), each equal
                to its oracle, against the same requests from one thread;
                latency and queue-wait percentiles, batch sizes, size
                reads and launches a request, the card's idle share over
                2 s of load; one ``cypher_batch`` of 8 exact replays with
                no size read and no synchronizing call; the result cache;
                an overload burst (``Overloaded`` with a retry hint); a
                deadline expiring in the execute phase; a server warmed
                from the first one's plan store against a cold one; and
                failover between two replicas on the card (each on its
                own stream) under ``device_loss(0)``;
 16. mesh     — the multi-GPU slice on a mesh of 4 shards (4 cards where
                the process sees as many, else all on the one card, run
                one after another): M1 the grouped 2-hop query on a
                ``mesh_shape=(4,), use_csr=False`` session (radix-exchange
                joins, K2 on every shard's expansion, K1 once per shard
                then the combine, K3), cold, 5 exact replays (0 size
                reads), eager and the 8 rotating ages, each against the
                numpy oracle and an unsharded session, each shard's K1
                combine against the plain version over the whole column;
                M2 the same query with every join a broadcast join
                (EXPLAIN's ``dist_strategy``); M3 a salted radix join
                through a hub node (20 % of the edges, seeded; hot above
                half a shard's fair share); M4 the ring 2-hop count and a
                ``[*1..3]`` ring-matrix var-expand against the unsharded
                session; M5 the sharded two-hop step and the collectives
                smoke over the 10M edges against numpy; M6 a re-shard to
                the 3 healthy slots (2 shards, the power-of-two rule),
                then M1 again; M7 a ``QueryServer`` whose graph a shard
                group of 4 members serves (partitioned by city): 8
                clients, 300 requests (routed single-city reads and
                M1), a member lost under traffic and rebuilt, one write
                read back.  Per query cold and warm latency, size reads,
                dist joins, bytes between shards, launches, peak bytes
                and one exact replay's busy time and idle share;
 17. fleet    — durability and the fleet with backend processes on the
                card, each a new interpreter with its own CUDA context
                building the same ``foaf`` graph (250k people, 2.5M edge
                draws: the slice's cut by 4) from one spec: the grouped
                query through one backend and through a router over three
                (one closed-loop client per ``$age`` family, every reply
                equal to a numpy oracle; requests/s, router latency, requests per backend,
                ``utilization.gpu`` every 100 ms, each child's card
                memory and kernel launches), the soak again with a
                non-owner SIGKILLed (availability 1.0), a shipped write
                read back with one digest everywhere; three durable
                backends on one store (WAL ``always``) through a write
                soak with the owner SIGKILLed (recovery seconds, no
                acknowledged write lost, the WAL's append latency under
                each fsync policy, the restarted owner's start and its
                refused write frames); two routers behind a
                ``RouterSet`` under a seeded ``ChaosSchedule`` that kills
                the active one (takeover, availability, the dead
                router's epoch fenced, every invariant green);
 18. tck      — the 465 TCK scenarios on the card under the CPU tests'
                strict list (``caps_tpu_torch/tck/blacklists/cuda.txt``),
                and the port's float64 sqrt on 2^20 values bit for bit
                against numpy;
 19. acceptance — the 117 behaviour tests of ``tests/acceptance`` against
                a session on the card, every query's rows equal to the
                port's pure-Python oracle on the same graph, the strict
                list's tests raising their causes; counts by suite;
 20. ldbc     — the LDBC-like reads IS1–IS7 and IC1–IC14 on the port's
                generator: at scale 11 (about LDBC SF1) 1 parameter draw
                each, equal to the port's CPU session; at scale 110
                (about SF10) a cold run, 5 exact replays and 1 generic
                draw, each equal to an eager run, the device busy time
                of one exact replay, and IS1/IS4/IS5 against numpy; a read
                whose plan the cost model changed runs on a
                ``use_cost_model=False`` session too;
 21. plan     — bench config 9 at its TPU size: the five query families
                on the default session and a ``use_cost_model=False``
                one, equal binding by binding, re-roots as intended, warm
                latency of each; the re-plan loop from a seeded distorted
                sketch to a re-planned exact replay;
 22. selftest — the seconds each kernel family's self-test took, and a
                check that a second request launches nothing;
 23. kernels  — each kernel wrapper against its plain PyTorch version on
                the card, on the inputs of every call one exact replay
                made (of the grouped query, the var-expand forms, the
                unwind, lists, values, gaps, nested and mixed queries,
                the
                multiway joins, the final snapshot of the updates phase,
                IC12, a served batch and the mesh phase's M1: every
                shard's K1 and K2 calls) and at edge
                shapes (the segment
                kernel: bit for bit, NaN and signed zeros included, and
                two calls bitwise equal), with the median time of 20 launches (CUDA
                events) at the largest call and at each call (summed:
                ``ms_per_query``), the plain version's and one library
                call's time, and, for the expand and segment kernels,
                device time and launches by kernel name
                (``torch.profiler``);
 24. the script's seconds, the ``{"kernels": [...]}`` line, the card
     line, and the last line
     ``{"ok": true, "device": {...}}``.

Needs one card; without CUDA, or outside the repository, it exits
nonzero before printing any result.
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import os
import re
import shutil
import statistics
import subprocess
import sys
import threading
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
# The lists phase: lambdas over collected friends (L1), the whole graph's
# collected ages folded per person and grouped by city (L2), and
# var-length paths ordered by two list keys (L3, and with a city filter;
# its end cities are aliased ``cities``: ``ends`` is the keyword of ENDS
# WITH to the parser).
QUERY_LISTS_L1 = (
    "MATCH (a:Person)-[:KNOWS]->(b:Person) WHERE a.age = $age "
    "WITH a, collect(b) AS fs RETURN id(a) AS a, "
    "[f IN fs WHERE f.age > $age | f.age] AS older, "
    "all(f IN fs WHERE f.age >= 18) AS adults, "
    "single(f IN fs WHERE f.city = a.city) AS one_local, "
    "reduce(s = 0, f IN fs | s + f.age) AS total, labels(a) AS l, "
    "keys(a) AS k")
QUERY_LISTS_L2 = (
    "MATCH (a:Person)-[:KNOWS]->(b:Person) WITH a, collect(b.age) AS ages "
    "RETURN a.city AS city, sum(size([x IN ages WHERE x > 60])) AS old, "
    "count(CASE WHEN any(x IN ages WHERE x < 20) THEN 1 END) AS young, "
    "max(reduce(m = 0, x IN ages | CASE WHEN x > m THEN x ELSE m END)) "
    "AS oldest ORDER BY city")
QUERY_LISTS_L3 = (
    "MATCH p = (a:Person)-[:KNOWS*1..2]->(c:Person) WHERE a.age = $age "
    "RETURN [n IN nodes(p) | n.age] AS ages, [a.city, c.city] AS cities "
    "ORDER BY ages, cities LIMIT 1000")
QUERY_LISTS_L3_CITY = QUERY_LISTS_L3.replace(
    "WHERE a.age = $age", "WHERE a.age = $age AND a.city = $city")
# The values phase, on the slice's graph with three temporal properties
# added (born, joined, since): temporal grouping over the seeds' friends
# (V1), the whole graph's temporal arithmetic (V2), maps and strings built
# from columns (V3), mixed-type values (V4).
QUERY_VALUES_V1 = (
    "MATCH (a:Person)-[k:KNOWS]->(b:Person) WHERE a.age = $age "
    "AND k.since >= datetime($from) RETURN b.born.year AS year, "
    "count(*) AS n, min(b.born) AS first, max(k.since) AS last "
    "ORDER BY year")
QUERY_VALUES_V2 = (
    "MATCH (a:Person)-[k:KNOWS]->(b:Person) "
    "WITH a, k.since + duration({days: 30}) AS due, b.born AS born "
    "WHERE due.year = 2020 AND date(due) > born + duration('P18Y') "
    "RETURN a.city AS city, count(*) AS n, min(due) AS first")
QUERY_VALUES_V3 = (
    "MATCH (a:Person)-[:KNOWS]->(b:Person) WHERE a.age = $age "
    "RETURN {pair: a.city + '/' + b.city, born: toString(b.born), "
    "age: b.age} AS m, properties(b) AS p, keys(b) AS ks, id(b) AS b "
    "ORDER BY m.pair, b LIMIT 1000")
QUERY_VALUES_V4 = (
    "MATCH (a:Person)-[:KNOWS]->(b:Person) WHERE a.age = $age "
    "UNWIND [b.age, toFloat(b.age) / 4, b.city, b.born] AS v "
    "RETURN DISTINCT v ORDER BY v LIMIT 30000")
VALUES_FROM = "2015-06-01T00:00:00"   # V1's $from
# The cyclic phase on the slice's graph: the seeded triangle, enumerated
# (the multiway join, MultiwayJoinOp over K2).
QUERY_TRIANGLE = ("MATCH (a:Person)-[r1:KNOWS]->(b)-[r2:KNOWS]->(c), "
                  "(a)-[r3:KNOWS]->(c) WHERE a.age = $age "
                  "RETURN id(a) AS x, id(b) AS y, id(c) AS z")
CITY = "city0007"   # with AGE: about 14 seeds, the var-expand matrix form
# The graph's dictionary-coded property and the seed filter.  1,000 cities
# keep the group-by under the dense gate (S <= 4096), so it runs on K1.
CITIES = 1000
# The gaps phase: expressions and aggregations the JAX package answers on
# its host fallback, over the 2-hop rows from the seeds of ``$age``.
GAPS_MATCH = ("MATCH (a:Person)-[:KNOWS]->(:Person)-[:KNOWS]->(b:Person) "
              "WHERE a.age = $age ")
QUERY_GAPS = {
    # A: a string function of a column argument, grouped on K1
    "G1_substring": GAPS_MATCH + (
        "RETURN substring(b.city, b.age % 2) AS s, count(*) AS n "
        "ORDER BY n DESC, s LIMIT 20"),
    # A: a string predicate with a column right side
    "G2_starts_with": GAPS_MATCH + (
        "AND b.city STARTS WITH left(a.city, 6) RETURN count(*) AS n"),
    # A: range() of column bounds, unwound
    "G3_range": GAPS_MATCH + (
        "UNWIND range(0, b.age % 8) AS x RETURN x, count(*) AS n "
        "ORDER BY x"),
    # B: collect of maps per city
    "G4_collect_maps": GAPS_MATCH + (
        "RETURN b.city AS city, collect({age: b.age}) AS m "
        "ORDER BY city LIMIT 20"),
    # B: percentileDisc of strings per age
    "G5_percentile_strings": GAPS_MATCH + (
        "RETURN b.age AS age, percentileDisc(b.city, 0.5) AS p "
        "ORDER BY age"),
    # C: CASE between maps of different keys, grouped
    "G6_case_maps": GAPS_MATCH + (
        "RETURN CASE WHEN b.age > 50 THEN {k: b.city} "
        "ELSE {k: b.age, old: false} END AS m, count(*) AS n"),
    # D: arithmetic on values of mixed types, grouped
    "G7_mixed_arith": GAPS_MATCH + (
        "RETURN (CASE WHEN b.age > 50 THEN b.city ELSE b.age END) + 1 "
        "AS v, count(*) AS n"),
    # E: a list of durations collected per city, filtered by element
    "G8_duration_lists": GAPS_MATCH + (
        "WITH b.city AS city, collect(duration({days: b.age})) AS ds "
        "RETURN city, size(ds) AS n, [d IN ds WHERE d.days > 80] AS old "
        "ORDER BY city LIMIT 20"),
}
# Launches one exact replay of each gaps query makes at least: two joins
# per hop on K2 for each; G1 groups by a string on K1 (the phase's pool
# stays under 4,096 strings) and sorts its groups on K3; G3 and G5 sort
# their grouped rows (8 and 72) on K3.
MIN_GAPS_LAUNCHES = {
    "G1_substring": {"expand_positions": 2, "segment_agg": 1,
                     "bitonic_sort": 1},
    "G2_starts_with": {"expand_positions": 2},
    "G3_range": {"expand_positions": 2, "bitonic_sort": 1},
    "G4_collect_maps": {"expand_positions": 2},
    "G5_percentile_strings": {"expand_positions": 2, "bitonic_sort": 1},
    "G6_case_maps": {"expand_positions": 2},
    "G7_mixed_arith": {"expand_positions": 2},
    "G8_duration_lists": {"expand_positions": 2},
}
# held-value reads of one exact replay of each: the strings G1 builds and
# the pairs G2 decides, one each; G7's texts of the values and their
# concatenation, three
GAPS_HELD_READS = {"G1_substring": 1, "G2_starts_with": 2,
                   "G7_mixed_arith": 3}

# The nested phase: a seeded list-of-lists property on every person
# (0-8 inner lists of 0-6 int64 values; null rows, null inner lists and
# null values at these rates), queried from the seeds of ``$age``.
NESTED_MAX_INNER = 8
NESTED_MAX_VALUES = 6
NESTED_NULLS = (0.10, 0.05, 0.15)   # rows, inner lists, values
NESTED_SEEDS = "MATCH (a:Person) WHERE a.age = $age "
NESTED_HOP = ("MATCH (a:Person)-[:KNOWS]->(b:Person) WHERE a.age = $age ")
QUERY_NESTED = {
    # both levels unwound, grouped by city on K1 (K1 folds count, min and
    # max), the groups ordered on K3
    "N1_unwind_twice": NESTED_SEEDS + (
        "UNWIND a.visits AS v UNWIND v AS x "
        "RETURN a.city AS city, count(x) AS n, max(x) AS hi "
        "ORDER BY n DESC, city LIMIT 20"),
    # three levels built by collect over the 2-hop rows and read back
    "N2_collect_three_levels": (
        "MATCH (a:Person)-[:KNOWS]->(b:Person)-[:KNOWS]->(c:Person) "
        "WHERE a.age = $age WITH c.city AS city, collect([[b.age, c.age]]) "
        "AS v RETURN city, size(v) AS n, "
        "size([x IN v WHERE x[0][0] = $age]) AS k, v[0][0][0] AS first "
        "ORDER BY city LIMIT 20"),
    # grouped and ordered by the nested property
    "N3_group_by_nested": NESTED_HOP + (
        "RETURN b.visits AS v, count(*) AS n ORDER BY n DESC, v LIMIT 20"),
    # three levels of mixed values built by comprehensions, folded
    "N4_comprehensions": NESTED_SEEDS + (
        "WITH [v IN a.visits WHERE size(v) > 2 | "
        "[x IN v WHERE x IS NOT NULL | [x, a.city]]] AS l "
        "RETURN count(*) AS c, sum(size(l)) AS s, sum(size(l[0])) AS s0, "
        "count(l[0][0][1]) AS k"),
    # inner lists compared element by element across a hop
    "N5_equal_inner_lists": NESTED_HOP + (
        "AND a.visits[0] = b.visits[0] RETURN count(*) AS n"),
}
# Launches one exact replay of each nested query makes at least: N1's
# group-by on K1 and the sort of its 1,000 groups on K3; one join per
# hop on K2 (N2 two, N3 and N5 one); N4 reads no join.
MIN_NESTED_LAUNCHES = {
    "N1_unwind_twice": {"segment_agg": 1, "bitonic_sort": 1},
    "N2_collect_three_levels": {"expand_positions": 2},
    "N3_group_by_nested": {"expand_positions": 1},
    "N4_comprehensions": {},
    "N5_equal_inner_lists": {"expand_positions": 1},
}

# The mixed phase: lists and maps among values of other types ("any"
# values holding a list or a map by its row), over the 1- and 2-hop rows
# from the seeds of ``$age``, one query per group of the census's causes.
MIXED_HOP = "MATCH (a:Person)-[:KNOWS]->(b:Person) WHERE a.age = $age "
QUERY_MIXED = {
    # CASE between a list and a string, grouped and ordered (lists first)
    "X1_group_list_or_string": MIXED_HOP + (
        "RETURN CASE WHEN b.age > 50 THEN [b.age % 5] ELSE b.city END AS v, "
        "count(*) AS n ORDER BY n DESC, v LIMIT 20"),
    # a list literal of a string, a list and a map, unwound, DISTINCT
    "X2_unwind_distinct": MIXED_HOP + (
        "UNWIND [b.city, [b.age % 7], {age: b.age}] AS x "
        "RETURN count(DISTINCT x) AS n, count(*) AS m"),
    # toString of a map (one held read a run), grouped by the text on K1
    "X3_to_string_map": MIXED_HOP + (
        "RETURN toString({city: b.city, age: b.age % 2}) AS s, "
        "count(*) AS n ORDER BY n DESC, s LIMIT 20"),
    # reduce whose accumulator turns from an int into maps, over 2 hops
    "X4_reduce_to_map": (
        "MATCH (a:Person)-[:KNOWS]->(b:Person)-[:KNOWS]->(c:Person) "
        "WHERE a.age = $age "
        "WITH reduce(s = 0, x IN [b.age, c.age] | {k: x}) AS s "
        "RETURN s.k AS k, count(*) AS n ORDER BY k"),
    # UNION ALL of a list column and a string column (a tenth of the
    # 1-hop rows: the result's values are made on the host, one by one)
    "X5_union_list_string": MIXED_HOP + (
        "AND b.age % 10 = 0 RETURN [b.age] AS v UNION ALL "
        "MATCH (a:Person) WHERE a.age = $age RETURN a.city AS v"),
    # CASE between lists of two depths, compared with = at both depths
    "X6_two_depths_equal": MIXED_HOP + (
        "WITH CASE WHEN b.age > 50 THEN [[b.age % 3]] ELSE [b.age % 3] END "
        "AS l RETURN l = [[1]] AS e, l = [1] AS f, count(*) AS n"),
}
# Launches one exact replay of each mixed query makes at least: one join
# per hop on K2; X1's and X3's groups (about 1,005 and 2,000) and X4's 72
# sorted on K3; X3 groups by one string on K1 (the phase's pool stays
# under 4,096 strings: 1,000 cities and X3's 2,000 texts).
MIN_MIXED_LAUNCHES = {
    "X1_group_list_or_string": {"expand_positions": 1, "bitonic_sort": 1},
    "X2_unwind_distinct": {"expand_positions": 1},
    "X3_to_string_map": {"expand_positions": 1, "segment_agg": 1,
                         "bitonic_sort": 1},
    "X4_reduce_to_map": {"expand_positions": 2, "bitonic_sort": 1},
    "X5_union_list_string": {"expand_positions": 1},
    "X6_two_depths_equal": {"expand_positions": 1},
}
# held-value reads of one exact replay: X3's maps read once to be
# formatted
MIXED_HELD_READS = {"X3_to_string_map": 1}

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
ROTATING = 8    # $age values of the warm phase's param-generic sequence
# Launches one exact replay of each values query makes at least: the
# joins on K2, the sort of up to 16,384 rows on K3 (V1's ORDER BY of its
# years); V1 groups, V3 orders and V4 deduplicates the seeds' 137,125
# friend rows (or 4 times as many) and orders about 25,000 distinct
# values, and V2 groups 10M, on the torch sort.
MIN_VALUES_LAUNCHES = {"V1": {"expand_positions": 1, "bitonic_sort": 1},
                       "V2": {"expand_positions": 1},
                       "V3": {"expand_positions": 1},
                       "V4": {"expand_positions": 1}}
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
# The same for one exact replay of each lists-phase query: L1 and L2 join
# each edge to its endpoints (K2 twice), L3's var-length expand joins
# (K2), and L3 with the city filter sorts its few hundred rows on K3.
MIN_LISTS_LAUNCHES = {"L1": {"expand_positions": 2},
                      "L2": {"expand_positions": 2},
                      "L3": {"expand_positions": 2},
                      "L3_city": {"expand_positions": 1, "bitonic_sort": 1}}
# The same for one run of the seeded triangle on the multiway join: two
# extends and one close, each through K2.
MIN_TRIANGLE_LAUNCHES = {"expand_positions": 3}
# The cyclic phase (bench.py config 10 at its TPU size): nodes, densities,
# the forced cascade compared wherever its open-pattern rows stay at or
# under CASCADE_MAX_OPEN, and the shapes cut (their last extend would
# enumerate about 410M candidate slots).  The cascade keeps every
# intermediate table of its plan on the card until the query ends, about
# 2.8 KB an open row (18.1 GB at the triangle's 6.4M at density 8): the
# triangle at density 16 (25.6M) and the diamond and 4-cycle at density
# 8 (51.2M) need more than the card's 80 GB, so they run on the
# multiway join alone.
CYCLIC_NODES = 100_000
CYCLIC_DENSITIES = (4, 8, 16)
CASCADE_MAX_OPEN = 16_000_000
CYCLIC_CUT = {("diamond", 16), ("cycle4", 16)}
# warm repeats of each config-10 query (each materializes and compares
# up to tens of millions of rows on the host; the seeded triangle keeps 5)
CYCLIC_WARM = 3
# The LDBC phase's scales: 11 is about LDBC SF1 (11k persons, 150k
# nodes), 110 about SF10 (BASELINE.md configs 2 and 3).
LDBC_SCALES = (11.0, 110.0)
LDBC_SEED = 7
LDBC_DRAWS = 1
# The updates phase: 500 single-statement writes of the LDBC SNB
# Interactive update shapes this graph's schema holds (IU-8-style edge
# inserts, IU-1-style person creates, property sets, relationship and
# node deletes), in an order drawn from --seed; the grouped query is
# held to its oracle after every WRITE_CHECK_EVERY writes.
WRITES = {"edge": 200, "person": 100, "set": 100, "delete_rel": 50,
          "detach": 50}
WRITE_CHECK_EVERY = 100
UPDATE_QUERIES = {
    "edge": ("MATCH (a:Person), (b:Person) WHERE id(a) = $a AND id(b) = $b "
             "CREATE (a)-[:KNOWS]->(b)"),
    "person": "CREATE (:Person {age: $age, city: $city})",
    "set": "MATCH (a:Person) WHERE id(a) = $id SET a.age = $age",
    "delete_rel": "MATCH ()-[r:KNOWS]->() WHERE id(r) = $id DELETE r",
    "detach": "MATCH (a:Person) WHERE id(a) = $id DETACH DELETE a",
}
# The construct phase: CONSTRUCT / RETURN GRAPH on the slice's graph,
# stored in the catalog as ``session.base``.
CONSTRUCT_MET = (
    "CATALOG CREATE GRAPH session.met { MATCH (a:Person)-[:KNOWS]->"
    "(b:Person) WHERE a.age = $age CONSTRUCT CLONE a, b "
    "NEW (a)-[:MET {w: b.age}]->(b) RETURN GRAPH }")
CONSTRUCT_UNION = (
    "CATALOG CREATE GRAPH session.union { MATCH (a:Person)-[:KNOWS]->"
    "(b:Person) WHERE a.age = $age CONSTRUCT ON session.base "
    "NEW (a)-[:MET {w: b.age}]->(b) RETURN GRAPH }")
# the overlay's base: the slice's graph cut by CONSTRUCT_CUT
CONSTRUCT_CUT = 10
CONSTRUCT_OVERLAY = (
    "CATALOG CREATE GRAPH session.older { MATCH (a:Person) "
    "WHERE a.age = $age CONSTRUCT ON session.small CLONE a "
    "SET a.age = a.age + 100 RETURN GRAPH }")
QUERY_MET = ("MATCH (a)-[m:MET]->(b) RETURN b.city AS city, count(*) AS n, "
             "sum(m.w) AS w ORDER BY n DESC, city LIMIT 20")
QUERY_MET_COUNT = "MATCH ()-[m:MET]->() RETURN count(*) AS c"
# The serve phase: closed-loop clients, the requests each sends, every
# request's deadline, and the requests sent while replica 0 is lost.
SERVE_CLIENTS = 8
SERVE_REQUESTS = 400
SERVE_DEADLINE_S = 10.0
SERVE_FAILOVER_REQUESTS = 200
SERVE_PROFILED = 400   # requests of the run the profiler watches for 2 s
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

    def reset(self) -> None:
        self.calls, self.largest = [], None

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


# (city array, its np.unique(..., return_inverse=True)) of the last
# top_cities call: the oracles of one graph's rotating ages share it
_CODED = [None, None]


def top_cities(np, nodes, per_node, coded=None):
    """``per_node`` summed by city: the top-20 rows, count descending.
    ``coded`` is ``np.unique(city, return_inverse=True)`` when the caller
    has it (it takes about a second at 1M persons); otherwise the last
    call's, when the city array is the same object."""
    if coded is None:
        city = nodes["Person"]["city"]
        if _CODED[0] is not city:
            _CODED[:] = [city, np.unique(city, return_inverse=True)]
        coded = _CODED[1]
    names, codes = coded
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


def replans(session) -> int:
    """Re-plans the session's divergence loop has triggered so far."""
    return session.metrics_snapshot().get("replan.triggered", 0)


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
    # the cost model's statistics, computed once per graph before its
    # first plan (timed apart, so cold_s compares with runs without a
    # cost model): the distinct counts on the card, the degree sketches
    # on the host over the edge endpoints' host copies (``_host_ints``,
    # timed again alone)
    from caps_tpu_torch.relational import stats as ST
    t1 = time.perf_counter()
    graph.statistics()
    statistics_s = time.perf_counter() - t1
    rt = graph.rel_tables[0]
    t1 = time.perf_counter()
    for col in (rt.mapping.source_col, rt.mapping.target_col):
        ST._host_ints(rt.table, col)
    host_ints_s = time.perf_counter() - t1

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
    # makes, so the kernels phase can time one query's calls.  A query
    # whose rows keep diverging from the cost model's estimates (here
    # the LIMIT's 20 rows against ~1,100 estimated) re-plans once, as
    # in the JAX package: the run after the trigger is the re-plan, and
    # the warm runs are counted anew after it.
    per_query = query_recorders()
    warm, replan_runs = [], []
    seen = replans(session)
    while len(warm) < 5 or replans(session) != seen:
        if replans(session) != seen:
            seen = replans(session)
            _rows, res, s = timed_query(torch, graph, QUERY_GROUPED, params)
            replan_runs.append({"s": s, "retired_warm_s": warm,
                                **run_info(session, res)})
            warm, runs = [], runs[:1]
            for r in per_query:
                r.reset()
            continue
        first = not warm
        if first:
            for r in per_query:
                r.__enter__()
        try:
            warm_rows, warm_result, s = timed_query(torch, graph,
                                                    QUERY_GROUPED, params)
        finally:
            if first:
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
    # the default session plans with the cost model: the grouped query's
    # plan must be the heuristic one, so its numbers compare with runs
    # without a cost model
    plans = {"grouped": plan_check(session, graph, QUERY_GROUPED, params),
             "count": plan_check(session, graph, QUERY_COUNT, params)}
    expect("grouped", plans["grouped"]["same_as_heuristic"],
           f"the cost model changed the grouped query's plan: "
           f"{plans['grouped']}", "slice")
    emit({"phase": "slice", "card": card, "persons": args.persons,
          "edges": args.edges, "cities": CITIES, "age": AGE,
          "ingest_s": ingest_s, "statistics_cold_s": statistics_s,
          "host_ints_s": host_ints_s, "cold_s": cold_s, "warm_s": warm_s,
          "warm_runs_s": warm, "count_query_s": count_s,
          "rows_joined": joined, "rows_joined_per_s": joined / warm_s,
          "two_hop_rows": want_count, "top_city": rows[0],
          "size_syncs_total": session.backend.syncs,
          "runs": runs, "replan_runs": replan_runs,
          "count_query_run": count_run,
          # host clock per operator of the last warm run (exclusive of
          # children is not tracked: an operator's seconds include the
          # lazily evaluated inputs it pulled)
          "warm_operators": [[m["op"], m["seconds"], m["rows"]]
                             for m in warm_result.metrics["operators"]],
          "warm_phases_s": {k: warm_result.metrics[k] for k in (
              "parse_s", "ir_s", "plan_s", "relational_s", "execute_s")},
          "peak_mem_bytes": torch.cuda.max_memory_allocated(),
          "launches": launches, "selftest_launches": selftest,
          "record_run_launches": own, "plans": plans,
          "count_query_operators": [
              [m["op"], m.get("strategy")]
              for m in count_result.metrics["operators"]],
          "oracle": "equal"})
    # each kernel's largest call of the exact replay (the record run's
    # for K4, which only the self-test launches)
    largest = {r.name: r.largest for r in recorders + per_query}
    return ({"first_run": launches, "selftest": selftest}, largest,
            {r.name: r.calls for r in per_query},
            (session, graph, nodes, rels, {}))


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
    # the operators' ``caps_tpu_torch.<Op>`` ranges also appear on the
    # device timeline, spanning their kernels and the gaps between
    # them: they are not device work.  The profiler's raw event list
    # (nanoseconds) is read where it exists: building ``prof.events()``
    # takes minutes for a run of a few hundred thousand launches.
    raw = getattr(getattr(prof, "profiler", None), "kineto_results", None)
    kernels = None
    if raw is not None:
        try:
            kernels = [(e.name(), e.start_ns() / 1e3, e.end_ns() / 1e3)
                       for e in raw.events()
                       if e.device_type() == DeviceType.CUDA
                       and not e.name().startswith("caps_tpu_torch.")]
        except (AttributeError, TypeError):
            kernels = None
    if kernels is None:
        kernels = [(e.name, e.time_range.start, e.time_range.end)
                   for e in prof.events()
                   if e.device_type == DeviceType.CUDA
                   and not e.name.startswith("caps_tpu_torch.")]
    spans = sorted((a, b) for _n, a, b in kernels)
    if not spans:
        return {"wall_s": wall_s, "device_busy_s": "not measured"}
    busy, (lo, hi) = 0.0, spans[0]
    for a, b in spans[1:]:
        if a > hi:
            busy += hi - lo
            lo, hi = a, b
        else:
            hi = max(hi, b)
    busy = (busy + hi - lo) / 1e6   # microseconds
    by_name: dict = {}
    for name, a, b in kernels:
        by_name[name] = by_name.get(name, 0.0) + (b - a) / 1e3
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

    A family whose rows keep diverging from the cost model's estimates
    re-plans once (``EngineConfig.replan_threshold`` executions; the
    JAX package does the same): when a run triggers it, the next run is
    the re-plan (``replan_run``), the repeats before it go to
    ``retired_runs_s``, and ``warm`` repeats are counted anew.
    Returns (rows, {numbers, how each run went}, the last result)."""
    from caps_tpu_torch import ops

    def same_rows(a, b):
        if "ORDER BY" in query:
            return a == b
        return sorted(map(repr, a)) == sorted(map(repr, b))

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    out = {"card": card, "retired_runs_s": [], "replan_runs": []}
    rows = None
    seen = replans(session)
    if cold:
        rows, result, out["cold_s"] = timed_query(torch, graph, query,
                                                  params)
        out["cold_run"] = run_info(session, result)
    times, runs = [], []
    while len(times) < warm or replans(session) != seen:
        if len(out["replan_runs"]) > 2:
            raise RuntimeError(f"{query!r} keeps re-planning: "
                               f"{out['replan_runs']}")
        if replans(session) != seen:
            # the run before retired the plan: this run is the re-plan
            seen = replans(session)
            out["retired_runs_s"] += times
            times, runs = [], []
            got, result, t = timed_query(torch, graph, query, params)
            out["replan_runs"].append({"s": t, **run_info(session, result)})
        else:
            last = len(times) == warm - 1
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
            if replans(session) != seen and last:
                for r in recorders:
                    r.reset()
            times.append(t)
            runs.append(run_info(session, result))
        if rows is not None and not same_rows(got, rows):
            raise RuntimeError(f"repeat of {query!r} changed its rows")
        rows = got
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


def strip_estimates(plan: str) -> str:
    """A relational plan without the cost model's ``~rows=`` suffixes."""
    return re.sub(r"  ~rows=\d+ \((?:model|observed)\)", "", plan)


def plan_check(session, graph, query, params) -> dict:
    """The query's plan on ``session``: its EXPLAIN cost section, and
    whether it is the plan the fixed heuristics give (the same EXPLAIN
    with the session's cost model off, as an
    ``EngineConfig(use_cost_model=False)`` session plans; estimates
    stripped).  EXPLAIN executes nothing."""
    planned = graph.cypher("EXPLAIN " + query, params).plans
    config = session.config
    session.config = dataclasses.replace(config, use_cost_model=False)
    try:
        heuristic = graph.cypher("EXPLAIN " + query, params).plans
    finally:
        session.config = config
    return {"same_as_heuristic": strip_estimates(planned["relational"])
            == heuristic["relational"],
            "cost": planned.get("cost", "")}


def run_patterns(torch, np, args, card: str, state) -> dict:
    """Count pushdown and var-length expand on the slice's graph, on a
    session with the fixed heuristics (``use_cost_model=False``), so the
    measurements compare with runs without a cost model: each result
    against its numpy oracle or the port's own join cascade (a session
    with ``use_count_pushdown=False``, ``use_wcoj=False``), the strategy
    each query must take, size reads and kernel launches of its replays.
    Then each query's plan on the default session (the cost model on):
    where the model plans otherwise, the query runs there too, equal to
    the heuristic session's rows and on the strategy its EXPLAIN cost
    section chose."""
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
    heur = caps_tpu_torch.local_session(
        config=EngineConfig(use_cost_model=False))
    hgraph = graph_from_numpy(heur, nodes, rels)
    hgraph2 = graph_from_numpy(heur, nodes, rels2)
    cascade = caps_tpu_torch.local_session(
        config=EngineConfig(use_count_pushdown=False, use_cost_model=False,
                            use_wcoj=False))
    cgraph = graph_from_numpy(cascade, nodes, rels)
    cgraph2 = graph_from_numpy(cascade, nodes, rels2)
    torch.cuda.synchronize()
    ingest_s = time.perf_counter() - t0
    # the cyclic phase compares its seeded triangle with this cascade;
    # the serve phase serves on the heuristic session (its count form
    # runs on count pushdown there)
    slice_info["cascade"] = (cascade, cgraph)
    slice_info["heuristic"] = (heur, hgraph)
    out = {"phase": "patterns", "card": card, "ingest_s": ingest_s,
           "self_loops_dropped": int((~no_loops).sum()),
           "session": "use_cost_model=False"}
    persons = nodes["Person"]
    seeds = (persons["age"] == AGE).astype(np.int64)
    hop1, hop2 = hop_counts(np, nodes, rels, seeds)
    heuristic_rows = {}

    # -- 2 hops: exact replays, 8 rotating ages, the cascade ------------
    rows, info, result = pattern_runs(torch, heur, hgraph, QUERY_COUNT,
                                      age, card)
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
        r, res, t = timed_query(torch, hgraph, QUERY_COUNT, {"age": a})
        got.append(r)
        gen_runs.append(run_info(heur, res))
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
                     torch, lambda: hgraph.cypher(
                         QUERY_COUNT, age).records.to_maps())})
    crows, cinfo, cres = pattern_runs(torch, cascade, cgraph, QUERY_COUNT,
                                      age, card, warm=3)
    expect("count_2hop", crows == rows, f"cascade {crows} != {rows}")
    expect("count_2hop", "CountPattern" not in
           [m["op"] for m in cres.metrics["operators"]],
           "the cascade session pushed the count down")
    info["cascade"] = cinfo
    out["count_2hop"] = info
    heuristic_rows["count_2hop"] = rows

    # -- 3 hops, against the cascade -----------------------------------------
    rows, info, _ = pattern_runs(torch, heur, hgraph, QUERY_COUNT3, age,
                                 card)
    expect("count_3hop", info["strategies"] == {"CountPattern":
                                                "fused-spmv"},
           info["strategies"])
    expect_replays("count_3hop", info, 0)
    crows, info["cascade"], _ = pattern_runs(torch, cascade, cgraph,
                                             QUERY_COUNT3, age, card, warm=1)
    expect("count_3hop", crows == rows, f"cascade {crows} != {rows}")
    out["count_3hop"] = info
    heuristic_rows["count_3hop"] = rows

    # -- the cycle, on the loop-free graph, against the cascade ---------------
    rows, info, _ = pattern_runs(torch, heur, hgraph2, QUERY_CYCLE, age,
                                 card)
    expect("cycle", info["strategies"] == {"CountCycle": "cycle-probe"},
           info["strategies"])
    expect_replays("cycle", info, 0)
    crows, info["cascade"], _ = pattern_runs(torch, cascade, cgraph2,
                                             QUERY_CYCLE, age, card, warm=1)
    expect("cycle", crows == rows, f"cascade {crows} != {rows}")
    out["cycle"] = info
    heuristic_rows["cycle"] = rows

    # -- var-expand, join form: ~13.7k seeds give more than 64 chunks --------
    # (the kernel calls of one exact replay of each form go to the
    # kernels phase, to be held against their plain versions)
    join_calls = query_recorders()
    rows, info, _ = pattern_runs(torch, heur, hgraph, QUERY_VARLEN, age,
                                 card, recorders=join_calls)
    expect("varlen_join", rows == top_cities(np, nodes, hop1 + hop2),
           f"disagrees with the oracle: {rows}")
    expect("varlen_join", info["strategies"] == {"VarExpand": "join"},
           info["strategies"])
    expect_replays("varlen_join", info, 0)
    check_query_launches("the var-expand join form's replay",
                         info["replay_launches"])
    info["profile_exact_replay"] = device_profile(
        torch, lambda: hgraph.cypher(QUERY_VARLEN, age).records.to_maps())
    out["varlen_join"] = info
    heuristic_rows["varlen_join"] = rows

    # -- var-expand, matrix form: ~14 seeds ------------------------------------
    city_seeds = seeds * (np.asarray(persons["city"]) == CITY)
    c1, c2 = hop_counts(np, nodes, rels, city_seeds)
    params = {"age": AGE, "city": CITY}
    matrix_calls = query_recorders()
    rows, info, _ = pattern_runs(torch, heur, hgraph, QUERY_VARLEN_CITY,
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
    heuristic_rows["varlen_matrix"] = rows

    # -- var-length count ----------------------------------------------------------
    rows, info, res = pattern_runs(torch, heur, hgraph, QUERY_VARLEN_COUNT,
                                   age, card)
    expect("varlen_count", rows == [{"c": int(round((hop1 + hop2).sum()))}],
           f"{rows} != oracle")
    expect("varlen_count", info["strategies"] == {"CountPattern":
                                                  "fused-spmv"}
           and "lengths=[1, 2]" in res.plans["relational"],
           f"{info['strategies']}: {res.plans['relational']}")
    expect_replays("varlen_count", info, 0)
    out["varlen_count"] = info
    heuristic_rows["varlen_count"] = rows
    out["count_builds"] = heur.backend.count_builds

    # -- the default session (the cost model on) -------------------------------
    # each query's plan there; where it is not the heuristic plan, the
    # query runs on the default session, on the count strategy its
    # EXPLAIN cost section chose, equal to the heuristic session's rows
    default_graph2 = []
    default = {}
    for label, query, params, loop_free in (
            ("count_2hop", QUERY_COUNT, age, False),
            ("count_3hop", QUERY_COUNT3, age, False),
            ("cycle", QUERY_CYCLE, age, True),
            ("varlen_join", QUERY_VARLEN, age, False),
            ("varlen_matrix", QUERY_VARLEN_CITY,
             {"age": AGE, "city": CITY}, False),
            ("varlen_count", QUERY_VARLEN_COUNT, age, False)):
        g = graph
        if loop_free:
            if not default_graph2:
                default_graph2.append(graph_from_numpy(session, nodes,
                                                       rels2))
            g = default_graph2[0]
        check = plan_check(session, g, query, params)
        entry = {"plan": check}
        if not check["same_as_heuristic"]:
            rows, info, res = pattern_runs(torch, session, g, query, params,
                                           card, warm=3)
            expect(label, rows == heuristic_rows[label],
                   f"default session {rows} != heuristic "
                   f"{heuristic_rows[label]}", "patterns/default")
            expect_replays(label, info, 0, "patterns/default")
            ops_run = [m["op"] for m in res.metrics["operators"]]
            if "count_strategy:" in check["cost"]:
                pushed = "count_strategy: chosen=fused-spmv" in check["cost"]
                expect(label, ("CountPattern" in ops_run) == pushed,
                       f"cost section {check['cost']!r} but operators "
                       f"{ops_run}", "patterns/default")
            entry.update(info)
        default[label] = entry
    out["default_session"] = default
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
    replays and the warm phase's 8 rotating ages (param-generic
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
        # the heuristic plan (the cost model changes nothing here), so
        # its numbers compare with runs without a cost model
        plan = plan_check(session, graph, query, params(AGE))
        expect(label, plan["same_as_heuristic"],
               f"the cost model changed the plan: {plan}", "unwind")
        rows, info, result = pattern_runs(torch, session, graph, query,
                                          params(AGE), card,
                                          recorders=recorders)
        info["plan"] = plan
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


def city_codes(np, nodes):
    """``np.unique(city, return_inverse=True)`` of the persons' cities,
    shared with :func:`top_cities`'s cache (the codes follow the names'
    order, the string order the card sorts by)."""
    city = nodes["Person"]["city"]
    if _CODED[0] is not city:
        _CODED[:] = [city, np.unique(city, return_inverse=True)]
    return _CODED[1]


def lists_l1_oracle(np, nodes, rels, age: int) -> list:
    """L1 per seed with an out-edge: its friends' ages above ``age``
    (sorted: collect's order is the engine's), whether all are adults,
    whether exactly one lives in its city, the sum of their ages, its
    labels and keys; rows by id."""
    person, knows = nodes["Person"], rels["KNOWS"]
    p_age, p_city = person["age"], city_codes(np, nodes)[1]
    src, tgt = knows["_src"], knows["_tgt"]
    sel = np.flatnonzero(p_age[src] == age)
    order = np.argsort(src[sel], kind="stable")
    s, t = src[sel][order], tgt[sel][order]
    if not len(s):
        return []
    heads = np.flatnonzero(np.r_[True, s[1:] != s[:-1]])
    ends = np.r_[heads[1:], len(s)]
    ages = p_age[t]
    local = np.add.reduceat((p_city[t] == p_city[s]).astype(np.int64),
                            heads)
    totals = np.add.reduceat(ages, heads)
    adults = np.minimum.reduceat(ages, heads) >= 18
    return [{"a": int(s[h]),
             "older": sorted(int(x) for x in ages[h:e] if x > age),
             "adults": bool(ad), "one_local": int(nl) == 1,
             "total": int(tot), "l": ["Person"], "k": ["age", "city"]}
            for h, e, nl, tot, ad in zip(heads, ends, local, totals, adults)]


def lists_l2_oracle(np, nodes, rels) -> list:
    """L2: per person with an out-edge, its friends' ages over 60
    counted, whether one is under 20, and the oldest; per city the sum,
    the count of such persons and the maximum, in city order."""
    person, knows = nodes["Person"], rels["KNOWS"]
    n = len(person["age"])
    src, tgt = knows["_src"], knows["_tgt"]
    order, indptr = edge_index(np, src, tgt, n, "by_src")
    ages = person["age"][tgt[order]]
    has = indptr[1:] > indptr[:-1]
    heads = indptr[:-1][has]
    old = np.add.reduceat((ages > 60).astype(np.int64), heads)
    young = np.add.reduceat((ages < 20).astype(np.int64), heads) > 0
    oldest = np.maximum.reduceat(ages, heads)
    names, codes = city_codes(np, nodes)
    c = codes[np.flatnonzero(has)]
    k = len(names)
    old_c = np.bincount(c, weights=old, minlength=k)
    young_c = np.bincount(c, weights=young, minlength=k)
    oldest_c = np.zeros(k, np.int64)
    np.maximum.at(oldest_c, c, oldest)
    present = np.bincount(c, minlength=k) > 0
    return [{"city": str(names[i]), "old": int(round(old_c[i])),
             "young": int(round(young_c[i])), "oldest": int(oldest_c[i])}
            for i in np.flatnonzero(present)]


def lists_l3_oracle(np, nodes, rels, age: int, city=None) -> list:
    """L3: every 1- and 2-hop path out of a seed (no relationship twice),
    its node ages and end cities, in openCypher list order (a shorter
    prefix first), the first 1,000."""
    person, knows = nodes["Person"], rels["KNOWS"]
    p_age = person["age"]
    names, codes = city_codes(np, nodes)
    src, tgt = knows["_src"], knows["_tgt"]
    seed = p_age[src] == age
    if city is not None:
        seed &= person["city"][src] == city
    first = np.flatnonzero(seed)
    e1, e2 = np_two_paths(np, src, tgt, len(p_age), first)
    start = np.r_[src[first], src[e1]]
    mid = np.r_[tgt[first], tgt[e1]]
    last = np.r_[tgt[first], tgt[e2]]
    third = np.r_[np.full(len(first), -1), p_age[tgt[e2]]]
    keys = (codes[last], codes[start], third, p_age[mid], p_age[start])
    top = np.lexsort(keys)[:1000]
    return [{"ages": [int(p_age[start[i]]), int(p_age[mid[i]])]
             + ([int(third[i])] if third[i] >= 0 else []),
             "cities": [str(names[codes[start[i]]]),
                        str(names[codes[last[i]]])]} for i in top]


def run_lists(torch, np, args, card: str, state):
    """List expressions on the slice's session and graph: each query's
    cold run and 5 exact replays, L1 also over the warm phase's 24
    rotating ages (param-generic replays), every run against its numpy
    oracle; the kernel calls and launches of the last exact replay of
    each, and one more exact replay under the profiler."""
    session, graph, nodes, rels, _ = state
    rng = np.random.default_rng(args.seed + 1)   # the warm phase's ages
    ages = [int(a) for a in rng.integers(18, 90, ROTATING)]
    t0 = time.perf_counter()
    out = {"phase": "lists", "card": card, "age": AGE, "city": CITY,
           "ages": ages}

    def l1_rows(rows):
        return sorted(({**r, "older": sorted(r["older"])} for r in rows),
                      key=lambda r: r["a"])

    queries = {
        "L1": (QUERY_LISTS_L1, lambda a: {"age": a},
               lambda a: lists_l1_oracle(np, nodes, rels, a), l1_rows),
        "L2": (QUERY_LISTS_L2, lambda a: {},
               lambda a: lists_l2_oracle(np, nodes, rels), list),
        "L3": (QUERY_LISTS_L3, lambda a: {"age": a},
               lambda a: lists_l3_oracle(np, nodes, rels, a), list),
        "L3_city": (QUERY_LISTS_L3_CITY,
                    lambda a: {"age": a, "city": CITY},
                    lambda a: lists_l3_oracle(np, nodes, rels, a, CITY),
                    list),
    }
    launches, calls = {}, {}
    for label, (query, params, want, norm) in queries.items():
        recorders = query_recorders()
        t1 = time.perf_counter()
        expected = want(AGE)
        oracle_s = time.perf_counter() - t1
        rows, info, result = pattern_runs(torch, session, graph, query,
                                          params(AGE), card,
                                          recorders=recorders)
        expect(label, norm(rows) == expected,
               f"disagrees with numpy ({len(rows)} rows, {len(expected)} "
               f"expected):\ngot  {norm(rows)[:3]}\nwant {expected[:3]}",
               "lists")
        expect_replays(label, info, 0, "lists")
        check_query_launches(f"the lists query {label}'s replay",
                             info["replay_launches"],
                             MIN_LISTS_LAUNCHES[label])
        info.update({
            "rows": len(rows), "oracle_s": oracle_s,
            "profile_exact_replay": device_profile(
                torch, lambda: graph.cypher(
                    query, params(AGE)).records.to_maps()),
            "operators": [[m["op"], m["seconds"], m["rows"]]
                          for m in result.metrics["operators"]]})
        if label == "L1":
            gen_times, gen_runs = [], []
            for a in ages:
                r, res, t = timed_query(torch, graph, query, params(a))
                gen_runs.append(run_info(session, res))
                if gen_runs[-1]["mode"] == "replay_gen":
                    gen_times.append(t)
                expect(label, norm(r) == want(a),
                       f"age {a}: {len(r)} rows disagree with numpy", "lists")
            expect(label, gen_times, f"no generic replay: {gen_runs}",
                   "lists")
            info.update({
                "generic_s": statistics.median(gen_times),
                "generic_runs_s": gen_times,
                "generic_size_syncs": [r["size_syncs"] for r in gen_runs],
                "generic_modes": [r["mode"] for r in gen_runs]})
        launches[label] = info["replay_launches"]
        calls[label] = {r.name: r.calls for r in recorders}
        out[label] = info
    out["phase_s"] = time.perf_counter() - t0
    emit(out)
    return ({"lists": launches["L1"]},
            {f"lists_{k}": v for k, v in calls.items()})


# The values phase's temporal properties: born uniform over 1940-01-01 …
# 2005-12-31 (epoch days, 5 % null), joined over 2000 … 2024 and since
# over 2010 … 2024 (epoch microseconds)
VALUES_BORN_DAYS = (-10_957, 13_148)
VALUES_JOINED_US = (946_684_800_000_000, 1_735_689_600_000_000)
VALUES_SINCE_US = (1_262_304_000_000_000, 1_735_689_600_000_000)
US_PER_DAY = 86_400_000_000


def values_arrays(np, nodes, rels, seed: int):
    """The slice's arrays with born, joined (persons) and since (KNOWS)
    added as ``datetime64`` columns, drawn from the seed."""
    rng = np.random.default_rng(seed + 7)
    person, knows = nodes["Person"], rels["KNOWS"]
    n, m = len(person["_id"]), len(knows["_id"])
    born = rng.integers(VALUES_BORN_DAYS[0], VALUES_BORN_DAYS[1] + 1,
                        n).astype("datetime64[D]")
    born[rng.random(n) < 0.05] = np.datetime64("NaT")
    joined = rng.integers(*VALUES_JOINED_US, n).astype("datetime64[us]")
    since = rng.integers(*VALUES_SINCE_US, m).astype("datetime64[us]")
    return ({"Person": {**person, "born": born, "joined": joined}},
            {"KNOWS": {**knows, "since": since}})


def np_years(np, days):
    """The calendar year of epoch days."""
    return days.astype("datetime64[D]").astype("datetime64[Y]").astype(
        np.int64) + 1970


def np_add_months(np, days, months: int):
    """Epoch days moved by ``months``, the day clamped to the month's
    length (``CypherDate.plus``)."""
    d = days.astype("datetime64[D]")
    mo = d.astype("datetime64[M]")
    day = (d - mo.astype("datetime64[D]")).astype(np.int64)
    tm = mo + months
    first = tm.astype("datetime64[D]")
    length = ((tm + 1).astype("datetime64[D]") - first).astype(np.int64)
    return first.astype(np.int64) + np.minimum(day, length - 1)


def values_columns(np, vnodes, vrels):
    """(born days, born null, since µs) as int64 / bool arrays."""
    born = vnodes["Person"]["born"]
    nat = np.isnat(born)
    days = np.where(nat, 0, born.astype(np.int64))
    return days, nat, vrels["KNOWS"]["since"].astype(np.int64)


def values_v1_oracle(np, vnodes, vrels, age: int) -> list:
    person, knows = vnodes["Person"], vrels["KNOWS"]
    days, nat, since = values_columns(np, vnodes, vrels)
    src, tgt = knows["_src"], knows["_tgt"]
    start = int(np.datetime64(VALUES_FROM, "us").astype(np.int64))
    sel = np.flatnonzero((person["age"][src] == age) & (since >= start))
    t, s_us = tgt[sel], since[sel]
    ok = ~nat[t]
    year = np.where(ok, np_years(np, days[t]), 1 << 40)
    rows = []
    for y in np.unique(year):
        g = year == y
        rows.append({"year": None if y == 1 << 40 else int(y),
                     "n": int(g.sum()),
                     "first": int(days[t][g & ok].min()) if (g & ok).any()
                     else None, "last": int(s_us[g].max())})
    return rows


def values_v2_oracle(np, vnodes, vrels) -> list:
    person, knows = vnodes["Person"], vrels["KNOWS"]
    days, nat, since = values_columns(np, vnodes, vrels)
    src, tgt = knows["_src"], knows["_tgt"]
    due = since + 30 * US_PER_DAY
    due_days = due // US_PER_DAY
    adult = np_add_months(np, days[tgt], 18 * 12)
    ok = ~nat[tgt] & (np_years(np, due_days) == 2020) & (due_days > adult)
    names, codes = city_codes(np, vnodes)
    c = codes[src[ok]]
    count = np.bincount(c, minlength=len(names))
    first = np.full(len(names), np.iinfo(np.int64).max)
    np.minimum.at(first, c, due[ok])
    return [{"city": str(names[i]), "n": int(count[i]),
             "first": int(first[i])} for i in np.flatnonzero(count)]


def values_v3_oracle(np, vnodes, vrels, age: int) -> list:
    person, knows = vnodes["Person"], vrels["KNOWS"]
    days, nat, _since = values_columns(np, vnodes, vrels)
    joined = person["joined"].astype(np.int64)
    src, tgt = knows["_src"], knows["_tgt"]
    sel = np.flatnonzero(person["age"][src] == age)
    s, t = src[sel], tgt[sel]
    city = person["city"]
    pair = np.char.add(np.char.add(city[s].astype(str), "/"),
                       city[t].astype(str))
    top = np.lexsort((t, pair))[:1000]
    iso = np.datetime_as_string(days.astype("datetime64[D]"))
    rows = []
    for i in top:
        b = int(t[i])
        p = {"age": int(person["age"][b]), "city": str(city[b]),
             "joined": int(joined[b])}
        if not nat[b]:
            p["born"] = int(days[b])
        rows.append({"m": {"pair": str(pair[i]),
                           "born": None if nat[b] else str(iso[b]),
                           "age": int(person["age"][b])},
                     "p": p, "ks": sorted(p), "b": b})
    return rows


def values_v4_oracle(np, vnodes, vrels, age: int) -> list:
    """V4's distinct values in the global sort order as (class, value)
    keys: strings, then numbers (an int and a float of one value are
    one), then dates, then null."""
    person, knows = vnodes["Person"], vrels["KNOWS"]
    days, nat, _since = values_columns(np, vnodes, vrels)
    t = knows["_tgt"][person["age"][knows["_src"]] == age]
    ages = person["age"][t]
    keys = sorted({(0, str(c)) for c in person["city"][t]}) + sorted(
        {(2, float(v)) for v in np.r_[ages, ages / 4.0]}) + sorted(
        {(4, int(d)) for d in days[t][~nat[t]]})
    return ((keys + [(9,)]) if nat[t].any() else keys)[:30000]


def values_norm(v):
    """An engine's value as the oracles write it: dates as epoch days,
    datetimes as epoch microseconds, maps as dicts."""
    name = type(v).__name__
    if name == "CypherDate":
        return v.days
    if name == "CypherDateTime":
        return v.micros
    if isinstance(v, dict):
        return {k: values_norm(x) for k, x in v.items()}
    if isinstance(v, list):
        return [values_norm(x) for x in v]
    return v


def values_v4_key(v):
    if v is None:
        return (9,)
    if isinstance(v, str):
        return (0, v)
    if type(v).__name__ == "CypherDate":
        return (4, v.days)
    return (2, float(v))


def run_values(torch, np, args, card: str, state):
    """Temporal values, maps, mixed-type values and strings built from
    columns on the slice's graph with born, joined and since added in
    bulk, in a session of its own: each query's cold run and 5 exact replays, V1 also over the
    warm phase's 8 rotating ages (param-generic replays), every run
    against its numpy oracle; per query the size reads and held-value
    reads of one more exact replay, the kernel calls and launches of
    the last exact replay, and one exact replay under the profiler."""
    import caps_tpu_torch
    from caps_tpu_torch.interop import graph_from_numpy
    _session, _graph, nodes, rels, _ = state
    t0 = time.perf_counter()
    vnodes, vrels = values_arrays(np, nodes, rels, args.seed)
    arrays_s = time.perf_counter() - t0
    # a session of its own: the strings V3 builds (about 150,000) stay in
    # its pool, which would take the later phases' group-bys by city off
    # the dense path (K1 takes a pool of at most 4,095 strings)
    session = caps_tpu_torch.local_session()
    graph = graph_from_numpy(session, vnodes, vrels)
    torch.cuda.synchronize()
    ingest_s = time.perf_counter() - t0 - arrays_s
    rng = np.random.default_rng(args.seed + 1)   # the warm phase's ages
    ages = [int(a) for a in rng.integers(18, 90, ROTATING)]
    out = {"phase": "values", "card": card, "age": AGE, "ages": ages,
           "arrays_s": arrays_s, "ingest_s": ingest_s,
           "added_bytes": int(sum(a.nbytes for a in (
               vnodes["Person"]["born"], vnodes["Person"]["joined"],
               vrels["KNOWS"]["since"])))}

    def v1_rows(rows):
        return [{k: values_norm(r[k]) for k in ("year", "n", "first",
                                                "last")} for r in rows]

    def v2_rows(rows):
        return sorted(({k: values_norm(r[k]) for k in ("city", "n",
                                                        "first")}
                       for r in rows), key=lambda r: r["city"])

    def v3_rows(rows):
        return [{k: values_norm(r[k]) for k in ("m", "p", "ks", "b")}
                for r in rows]

    def v4_rows(rows):
        return [values_v4_key(r["v"]) for r in rows]

    queries = {
        "V1": (QUERY_VALUES_V1, lambda a: {"age": a, "from": VALUES_FROM},
               lambda a: values_v1_oracle(np, vnodes, vrels, a), v1_rows),
        "V2": (QUERY_VALUES_V2, lambda a: {},
               lambda a: values_v2_oracle(np, vnodes, vrels), v2_rows),
        "V3": (QUERY_VALUES_V3, lambda a: {"age": a},
               lambda a: values_v3_oracle(np, vnodes, vrels, a), v3_rows),
        "V4": (QUERY_VALUES_V4, lambda a: {"age": a},
               lambda a: values_v4_oracle(np, vnodes, vrels, a), v4_rows),
    }
    launches, calls, phase_launches = {}, {}, {}
    for label, (query, params, want, norm) in queries.items():
        recorders = query_recorders()
        t1 = time.perf_counter()
        expected = want(AGE)
        oracle_s = time.perf_counter() - t1
        rows, info, result = pattern_runs(torch, session, graph, query,
                                          params(AGE), card,
                                          recorders=recorders)
        expect(label, norm(rows) == expected,
               f"disagrees with numpy ({len(rows)} rows, {len(expected)} "
               f"expected):\ngot  {norm(rows)[:3]}\nwant {expected[:3]}",
               "values")
        replay = graph.cypher(query, params(AGE))
        expect(label, norm(replay.records.to_maps()) == expected,
               "the counted replay disagrees with numpy", "values")
        expect(label, session.fused.last_mode == "replay",
               f"the counted run was a {session.fused.last_mode}", "values")
        info["replay_size_syncs"] = replay.metrics["size_syncs"]
        info["replay_held_reads"] = replay.metrics["held_reads"]
        expect(label, replay.metrics["size_syncs"] == 0,
               f"an exact replay read {replay.metrics['size_syncs']} sizes",
               "values")
        # V3 builds strings (a.city + '/', then that + b.city, and
        # toString of a date): one read of the held values each; the
        # others none
        expect(label, replay.metrics["held_reads"] == (
            3 if label == "V3" else 0),
               f"an exact replay read held values "
               f"{replay.metrics['held_reads']} times", "values")
        check_query_launches(f"the values query {label}'s replay",
                             info["replay_launches"],
                             MIN_VALUES_LAUNCHES.get(label, {}))
        info.update({
            "rows": len(rows), "oracle_s": oracle_s,
            "k_launches": {k: info["replay_launches"].get(k, 0)
                           for k in ("segment_agg", "expand_positions",
                                     "bitonic_sort")},
            "profile_exact_replay": device_profile(
                torch, lambda: graph.cypher(
                    query, params(AGE)).records.to_maps()),
            "operators": [[m["op"], m["seconds"], m["rows"]]
                          for m in result.metrics["operators"]]})
        if label == "V1":
            gen_times, gen_runs = [], []
            for a in ages:
                r, res, t = timed_query(torch, graph, query, params(a))
                gen_runs.append(run_info(session, res))
                if gen_runs[-1]["mode"] == "replay_gen":
                    gen_times.append(t)
                expect(label, norm(r) == want(a),
                       f"age {a}: {len(r)} rows disagree with numpy",
                       "values")
            expect(label, gen_times, f"no generic replay: {gen_runs}",
                   "values")
            info.update({
                "generic_s": statistics.median(gen_times),
                "generic_runs_s": gen_times,
                "generic_size_syncs": [r["size_syncs"] for r in gen_runs],
                "generic_modes": [r["mode"] for r in gen_runs]})
        launches[label] = info["replay_launches"]
        for k, n in info["replay_launches"].items():
            phase_launches[k] = phase_launches.get(k, 0) + n
        calls[label] = {r.name: r.calls for r in recorders}
        out[label] = info
    expect("phase", not MIN_VALUES_LAUNCHES or all(
        phase_launches.get(k, 0) for k in ("expand_positions",
                                           "bitonic_sort")),
           f"K2 or K3 never launched: {phase_launches}", "values")
    out["phase_launches"] = phase_launches
    out["pool_strings"] = len(session.backend.pool)
    del graph, session
    out["phase_s"] = time.perf_counter() - t0
    emit(out)
    return ({"values": launches},
            {f"values_{k}": v for k, v in calls.items()})


def np_expand(np, starts, counts):
    """(repeat index, position) of every slot of the ranges
    [starts[i], starts[i] + counts[i])."""
    idx = np.repeat(np.arange(len(counts)), counts)
    within = np.arange(int(counts.sum())) - np.repeat(
        np.cumsum(counts) - counts, counts)
    return idx, np.repeat(starts, counts) + within


# the last edge list's sorted indexes: (src, tgt, n, {name: arrays});
# the seeded triangle's oracle runs once per rotating age on one graph
_EDGE_INDEX = [None, None, None, {}]


def edge_index(np, src, tgt, n: int, name: str):
    """Sorted indexes of an edge list, built once per (src, tgt, n):
    ``"by_src"`` (the stable order of ``src`` and its CSR offsets) and
    ``"keys"`` (the stable order of ``src * n + tgt`` and the sorted
    keys)."""
    if _EDGE_INDEX[0] is not src or _EDGE_INDEX[1] is not tgt \
            or _EDGE_INDEX[2] != n:
        _EDGE_INDEX[:] = [src, tgt, n, {}]
    cache = _EDGE_INDEX[3]
    if name not in cache:
        if name == "by_src":
            indptr = np.zeros(n + 1, np.int64)
            np.cumsum(np.bincount(src, minlength=n), out=indptr[1:])
            cache[name] = (np.argsort(src, kind="stable"), indptr)
        else:
            keys = src * n + tgt
            order = np.argsort(keys, kind="stable")
            cache[name] = (order, keys[order])
    return cache[name]


def np_two_paths(np, src, tgt, n, first=None):
    """(e1, e2) of every 2-path -e1-> -e2-> with e1 != e2, e1 drawn from
    ``first`` (every edge when None)."""
    order, indptr = edge_index(np, src, tgt, n, "by_src")
    e1 = np.arange(len(src)) if first is None else first
    mid = tgt[e1]
    i, pos = np_expand(np, indptr[mid], indptr[mid + 1] - indptr[mid])
    e1, e2 = e1[i], order[pos]
    keep = e1 != e2
    return e1[keep], e2[keep]


def np_match(np, k1, k2, sorted_k2=None):
    """Every (i, j) with k1[i] == k2[j]; ``sorted_k2`` is k2's stable
    order and its sorted values when the caller has them."""
    order, ks = sorted_k2 if sorted_k2 is not None else (
        np.argsort(k2, kind="stable"), None)
    if ks is None:
        ks = k2[order]
    lo = np.searchsorted(ks, k1, "left")
    i, pos = np_expand(np, lo, np.searchsorted(ks, k1, "right") - lo)
    return i, order[pos]


def np_bag(np, cols):
    """Rows (one array per column) as a lexicographically sorted 2-D
    array: equal multisets give equal arrays."""
    a = np.stack([np.asarray(c, np.int64) for c in cols], axis=1) \
        if len(cols[0]) else np.zeros((0, len(cols)), np.int64)
    return a[np.lexsort(a.T[::-1])] if len(a) else a


def rows_bag(np, rows, keys):
    return np_bag(np, [[r[k] for r in rows] for k in keys]) if rows \
        else np.zeros((0, len(keys)), np.int64)


def cyclic_oracle(np, name, src, tgt, n, first=None):
    """The bag of id rows of a cyclic pattern, with relationship
    uniqueness (no edge bound twice), and the rows a binary cascade
    holds open before its closing edge."""
    e1, e2 = np_two_paths(np, src, tgt, n, first)
    a, b, c = src[e1], tgt[e1], tgt[e2]
    out_deg = np.bincount(src, minlength=n)
    if name == "triangle":
        i, e3 = np_match(np, a * n + c, None,
                         edge_index(np, src, tgt, n, "keys"))
        keep = (e3 != e1[i]) & (e3 != e2[i])
        i = i[keep]
        return np_bag(np, [a[i], b[i], c[i]]), len(e1)
    if name == "diamond":
        # a -e1-> b -e2-> d beside a -f1-> c -f2-> d
        i, j = np_match(np, a * n + c, a * n + c)
        keep = ((e1[i] != e1[j]) & (e1[i] != e2[j]) & (e2[i] != e1[j])
                & (e2[i] != e2[j]))
        i, j = i[keep], j[keep]
        return (np_bag(np, [a[i], b[i], b[j], c[i]]),
                int(out_deg[a].sum()))
    # cycle4: a -e1-> b -e2-> c, then c -f1-> d -f2-> a
    i, j = np_match(np, a * n + c, c * n + a)
    keep = ((e1[i] != e1[j]) & (e1[i] != e2[j]) & (e2[i] != e1[j])
            & (e2[i] != e2[j]))
    i, j = i[keep], j[keep]
    return np_bag(np, [a[i], b[i], c[i], b[j]]), int(out_deg[c].sum())


def anchors_of(plan: str) -> str:
    m = re.search(r"anchors=\[([^\]]*)\]", plan)
    return m.group(1) if m else ""


def run_cyclic(torch, np, args, card: str, state):
    """Worst-case-optimal multiway joins on the card.  First the seeded
    triangle on the slice's graph: cold, 5 exact replays (0 size reads,
    no synchronizing call), the warm phase's 8 rotating ages (generic
    replays), each against a numpy oracle and the port's cascade.  Then
    bench config 10 at its TPU size: 100,000 :Person and uniform :KNOWS
    at densities 4, 8 and 16, the triangle, diamond and 4-cycle
    enumerated on the multiway join (cold and CYCLIC_WARM exact
    replays) against a numpy oracle (bags of id rows) and, wherever its open rows stay at or under
    CASCADE_MAX_OPEN, against the forced cascade.  Records the K2 calls
    of one exact replay of each."""
    import caps_tpu_torch
    from caps_tpu_torch import ops
    from caps_tpu_torch.backends.cuda import fused as fused_mod
    from caps_tpu_torch.datasets.patterns import (
        CYCLIC_PATTERNS, CYCLIC_RETURN, cyclic_graph,
    )
    from caps_tpu_torch.interop import graph_from_numpy
    from caps_tpu_torch.okapi.config import EngineConfig
    session, graph, nodes, rels, slice_info = state
    cascade, cgraph = slice_info["cascade"]
    t0 = time.perf_counter()
    out = {"phase": "cyclic", "card": card}
    calls = {}
    knows = rels["KNOWS"]
    src, tgt = knows["_src"], knows["_tgt"]
    n_main = len(nodes["Person"]["_id"])
    person_age = nodes["Person"]["age"]
    keys = ("x", "y", "z")

    def triangle_oracle(age):
        first = np.flatnonzero(person_age[src] == age)
        return cyclic_oracle(np, "triangle", src, tgt, n_main, first)[0]

    # -- the seeded triangle on the slice's graph ----------------------------
    check = plan_check(session, graph, QUERY_TRIANGLE, {"age": AGE})
    expect("triangle", "wcoj_strategy: chosen=wcoj" in check["cost"],
           f"the cost model did not choose the multiway join: {check}",
           "cyclic")
    recorders = query_recorders()
    rows, info, res = pattern_runs(torch, session, graph, QUERY_TRIANGLE,
                                   {"age": AGE}, card, recorders=recorders)
    want = triangle_oracle(AGE)
    expect("triangle", np.array_equal(rows_bag(np, rows, keys), want),
           f"{len(rows)} rows disagree with the oracle's {len(want)}",
           "cyclic")
    expect("triangle", info["strategies"] == {"MultiwayJoin": "wcoj"},
           info["strategies"], "cyclic")
    expect_replays("triangle", info, 0, "cyclic")
    check_query_launches("the seeded triangle's replay",
                         info["replay_launches"], MIN_TRIANGLE_LAUNCHES)
    ops.reset_launches()
    _, sites = count_syncs(torch, lambda: graph.cypher(
        QUERY_TRIANGLE, {"age": AGE}))
    expect("triangle", session.fused.last_mode == "replay" and not sites,
           f"an exact replay synchronized: {sites}", "cyclic")
    crows, cinfo, _ = pattern_runs(torch, cascade, cgraph, QUERY_TRIANGLE,
                                   {"age": AGE}, card, warm=3)
    expect("triangle", np.array_equal(rows_bag(np, crows, keys), want),
           "the cascade disagrees with the oracle", "cyclic")
    rng = np.random.default_rng(args.seed + 1)   # the warm phase's ages
    ages = [int(a) for a in rng.integers(18, 90, ROTATING)]
    gen_times, gen_runs, got, rotating = [], [], [], []
    for a in ages:
        r, res_a, t = timed_query(torch, graph, QUERY_TRIANGLE, {"age": a})
        rotating.append(t)
        got.append(r)
        gen_runs.append(run_info(session, res_a))
        if gen_runs[-1]["mode"] == "replay_gen":
            gen_times.append(t)
    for a, r in zip(ages, got):
        expect("triangle", np.array_equal(rows_bag(np, r, keys),
                                          triangle_oracle(a)),
               f"age {a} disagrees with the oracle", "cyclic")
    expect("triangle", all(r["size_syncs"] <= 1 for r in gen_runs
                           if r["mode"] == "replay_gen"),
           f"a generic replay read more than one size: {gen_runs}",
           "cyclic")
    # Each new age replays generically unless a size exceeds its served
    # bound: the run then re-records and widens that bound, and after
    # three violations in a row the fused executor stops trying generic
    # replay for the query (the JAX package's rule).  Reported, not
    # required: the seeded triangle's sizes (seeds, two expansions,
    # the few triangles) exceed their bounds one group at a time.
    generic = session.fused._generic.get(
        (graph._fused_epoch, QUERY_TRIANGLE))
    info.update({
        "generic_replays": sum(r["mode"] == "replay_gen" for r in gen_runs),
        "generic_stopped": generic is None
        or generic[2] >= fused_mod._GENERIC_VIOLATION_LIMIT,
        "rows": len(rows), "anchors": anchors_of(res.plans["relational"]),
        "plan": check, "sync_calls_exact_replay": len(sites),
        "generic_s": (statistics.median(gen_times) if gen_times
                      else "no generic replay"),
        "generic_runs_s": gen_times,
        "rotating_runs_s": [t for t in rotating],
        "generic_size_syncs": [r["size_syncs"] for r in gen_runs],
        "generic_modes": [r["mode"] for r in gen_runs],
        "profile_exact_replay": device_profile(
            torch, lambda: graph.cypher(
                QUERY_TRIANGLE, {"age": AGE}).records.to_maps()),
        "cascade": cinfo})
    emit({**out, "part": "seeded_triangle", **info})
    launches = {"wcoj_triangle": info["replay_launches"]}
    calls["wcoj_triangle"] = {r.name: r.calls for r in recorders}
    # the main graph's cascade session is not needed past this point
    del cascade, cgraph
    slice_info.pop("cascade")
    torch.cuda.empty_cache()

    # -- bench config 10: the cyclic graphs ---------------------------------
    out = {"phase": "cyclic", "card": card, "nodes": CYCLIC_NODES,
           "densities": list(CYCLIC_DENSITIES),
           "cascade_max_open_rows": CASCADE_MAX_OPEN,
           "cut": sorted(f"{p}@{d}" for p, d in CYCLIC_CUT)}
    for deg in CYCLIC_DENSITIES:
        t1 = time.perf_counter()
        c_nodes, c_rels = cyclic_graph(CYCLIC_NODES, deg, 17 + args.seed)
        wsession = caps_tpu_torch.local_session()
        wgraph = graph_from_numpy(wsession, c_nodes, c_rels)
        csession = caps_tpu_torch.local_session(config=EngineConfig(
            use_wcoj=False, use_count_pushdown=False))
        cg = graph_from_numpy(csession, c_nodes, c_rels)
        torch.cuda.synchronize()
        t_stats = time.perf_counter()
        wgraph.statistics()
        stats_s = time.perf_counter() - t_stats
        per = {"ingest_s": t_stats - t1, "statistics_cold_s": stats_s}
        ks = c_rels["KNOWS"]
        for name, match in CYCLIC_PATTERNS.items():
            if (name, deg) in CYCLIC_CUT:
                continue
            query = match + CYCLIC_RETURN[name]
            cols = ("x", "y", "z") if name == "triangle" \
                else ("w", "x", "y", "z")
            want, open_rows = cyclic_oracle(np, name, ks["_src"],
                                            ks["_tgt"], CYCLIC_NODES)
            label = f"{name}@{deg}"
            check = plan_check(wsession, wgraph, query, {})
            expect(label, "wcoj_strategy: chosen=wcoj" in check["cost"],
                   f"the cost model did not choose the multiway join: "
                   f"{check}", "cyclic")
            recorders = query_recorders()
            rows, info, res = pattern_runs(torch, wsession, wgraph, query,
                                           {}, card, warm=CYCLIC_WARM,
                                           recorders=recorders)
            expect(label, np.array_equal(rows_bag(np, rows, cols), want),
                   f"{len(rows)} rows disagree with the oracle's "
                   f"{len(want)}", "cyclic")
            expect(label, info["strategies"] == {"MultiwayJoin": "wcoj"},
                   info["strategies"], "cyclic")
            expect_replays(label, info, 0, "cyclic")
            info.update({"rows": len(rows), "open_rows": open_rows,
                         "anchors": anchors_of(res.plans["relational"]),
                         "plan": check})
            if open_rows <= CASCADE_MAX_OPEN:
                crows, info["cascade"], _ = pattern_runs(
                    torch, csession, cg, query, {}, card, warm=2)
                expect(label, np.array_equal(rows_bag(np, crows, cols),
                                             want),
                       "the cascade disagrees with the oracle", "cyclic")
            per[name] = info
            calls[f"wcoj_{name}_{deg}"] = {r.name: r.calls
                                           for r in recorders}
        emit({**out, "part": f"degree_{deg}", **per})
        del wsession, wgraph, csession, cg
        torch.cuda.empty_cache()
    emit({**out, "part": "end", "phase_s": time.perf_counter() - t0})
    return launches, calls


def run_plan(torch, np, args, card: str):
    """Bench config 9 at its TPU size (100,000 persons, 200 cities, 1,000
    tags, 500,000 Zipfian :KNOWS): the five query families with their
    bindings on the default session and on a ``use_cost_model=False``
    session, equal binding by binding; the three re-root families show
    ``chosen=reversed`` in the EXPLAIN cost section and the two guards do
    not; the warm latency of each family on both, in rotations that
    alternate the sessions.  Then the re-plan loop: a graph seeded with a
    distorted sketch (cardinalities times 0.001) runs a family until
    ``replan.triggered`` ticks, and the re-planned query must replay
    with no size read and equal the eager result."""
    import caps_tpu_torch
    from caps_tpu_torch.datasets.patterns import (
        PLAN_FAMILIES, PLAN_TPU_SIZE, plan_graph,
    )
    from caps_tpu_torch.interop import graph_from_numpy
    from caps_tpu_torch.okapi.config import EngineConfig
    from caps_tpu_torch.relational.session import degraded_execution
    t0 = time.perf_counter()
    p_nodes, p_rels = plan_graph(*PLAN_TPU_SIZE)
    sessions = {}
    for label, config in (("planned", None),
                          ("heuristic", EngineConfig(use_cost_model=False))):
        s = caps_tpu_torch.local_session(config=config)
        sessions[label] = (s, graph_from_numpy(s, p_nodes, p_rels))
    torch.cuda.synchronize()
    out = {"phase": "plan", "card": card, "size": list(PLAN_TPU_SIZE),
           "ingest_s": time.perf_counter() - t0}
    planned_s, planned_g = sessions["planned"]
    t_stats = time.perf_counter()
    planned_g.statistics()
    out["statistics_cold_s"] = time.perf_counter() - t_stats
    families = {}
    for fam, (query, bindings) in PLAN_FAMILIES.items():
        cost = planned_g.cypher("EXPLAIN " + query, bindings[0]).plans.get(
            "cost", "")
        rerooted = "chosen=reversed" in cost
        expect(fam, rerooted == fam.endswith("_reroot"),
               f"re-root {rerooted} against the family's intent: {cost!r}",
               "plan")
        for params in bindings:
            got = {label: sorted(map(repr, g.cypher(
                query, params).records.to_maps()))
                for label, (_s, g) in sessions.items()}
            expect(fam, got["planned"] == got["heuristic"],
                   f"{params}: the planned and heuristic sessions disagree",
                   "plan")
        families[fam] = {"cost": cost, "rerooted": rerooted,
                         "planned_ms": [], "heuristic_ms": []}
    for _ in range(3):   # rotations alternating the two sessions
        for label, (_s, g) in sessions.items():
            for fam, (query, bindings) in PLAN_FAMILIES.items():
                times = [timed_query(torch, g, query, p)[2]
                         for p in bindings]
                families[fam][f"{label}_ms"].append(
                    1e3 * statistics.mean(times))
    for fam, f in families.items():
        f["planned_warm_ms"] = statistics.median(f["planned_ms"])
        f["heuristic_warm_ms"] = statistics.median(f["heuristic_ms"])
    out["families"] = families

    # -- the re-plan loop --------------------------------------------------
    s, g = planned_s, graph_from_numpy(planned_s, p_nodes, p_rels)
    honest = planned_g.statistics().to_payload()
    distorted = dict(honest)
    distorted["node_combos"] = [[k, max(1, int(v * 0.001))]
                                for k, v in honest["node_combos"]]
    distorted["rels"] = {t: dict(r, rows=max(1, int(r["rows"] * 0.001)))
                         for t, r in honest["rels"].items()}
    expect("replan", g.seed_statistics(distorted), "the seed was refused",
           "plan")
    query, bindings = PLAN_FAMILIES["city_reroot"]
    snap0 = s.metrics_snapshot()
    runs = []
    for _ in range(8):
        res = g.cypher(query, bindings[0])
        runs.append(run_info(s, res))
        if s.metrics_snapshot().get("replan.triggered", 0) > \
                snap0.get("replan.triggered", 0):
            break
    expect("replan", s.metrics_snapshot().get("replan.triggered", 0)
           == snap0.get("replan.triggered", 0) + 1,
           f"no re-plan in {runs}", "plan")
    replanned, after = [], []
    for _ in range(3):
        replanned.append(timed_query(torch, g, query, bindings[0]))
        after.append(run_info(s, replanned[-1][1]))
    with degraded_execution(no_plan_cache=True, no_fused=True):
        eager = g.cypher(query, bindings[0]).records.to_maps()
    expect("replan", all(sorted(map(repr, rows)) == sorted(map(repr, eager))
                         for rows, _r, _t in replanned),
           "the re-planned query disagrees with the eager run", "plan")
    expect("replan", after[0]["plan_cache"] == "miss"
           and after[1:] == [{"mode": "replay", "plan_cache": "hit",
                              "size_syncs": 0}] * 2,
           f"the re-planned query did not replay: {after}", "plan")
    snap = s.metrics_snapshot()
    out["replan"] = {
        "runs_to_trigger": runs, "after": after,
        "replan_warm_ms": [1e3 * t for _r, _res, t in replanned],
        "counters": {k: snap.get(k, 0) - snap0.get(k, 0) for k in (
            "replan.triggered", "replan.completed", "plan_cache.quarantined",
            "opstats.divergences")},
        "plan_after": strip_estimates(replanned[-1][1].plans["relational"])}
    out["phase_s"] = time.perf_counter() - t0
    emit(out)


def walk_profile(tree):
    yield tree
    for c in tree["children"]:
        yield from walk_profile(c)


def check_profile(label, result, want, timing) -> list:
    """A PROFILE result against the grouped query's oracle: each
    executed operator's profiled rows equal the rows of the same run's
    ``metrics["operators"]``, the root's equal the 20 result rows, and
    every node carries the timing tag ``timing``.  Returns
    [op, rows, seconds, device seconds] per executed operator."""
    rows = result.records.to_maps()
    expect(label, rows == want, "rows disagree with the oracle", "profile")
    tree = result.profile
    nodes = [n for n in walk_profile(tree) if n["executed"]]
    profiled = {n["op_id"]: n["rows"] for n in nodes}
    ran = {m["op_id"]: m["rows"] for m in result.metrics["operators"]}
    expect(label, profiled == ran,
           f"profiled rows {profiled} differ from the run's {ran}",
           "profile")
    expect(label, tree["rows"] == len(rows) == 20,
           f"root rows {tree['rows']} for {len(rows)} result rows",
           "profile")
    tags = {n.get("timing") for n in walk_profile(tree)}
    expect(label, tags == {timing}, f"timing tags {tags}, not {timing}",
           "profile")
    return [[n["op"], n["rows"], n["seconds"], n.get("device_s")]
            for n in nodes]


def range_device_ms(torch, fn) -> dict:
    """Device time by ``caps_tpu_torch.<Op>`` range (``torch.profiler``)
    over one run of ``fn``: per operator name, the ranges opened, their
    device time including the operators they pulled (``device_ms``) and
    excluding nested operator ranges (``own_device_ms``, the kernels
    launched under the range and not under a nested one)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()

    def device_us(e):
        v = getattr(e, "device_time_total", None)
        return getattr(e, "cuda_time_total", 0.0) if v is None else v

    def own_us(e):
        t = sum(k.duration for k in getattr(e, "kernels", ()))
        for c in e.cpu_children:
            if not c.name.startswith("caps_tpu_torch."):
                t += own_us(c)
        return t

    out: dict = {}
    for e in prof.events():
        # the host-side range (each also has a device-side copy on the
        # card's timeline, which launches nothing)
        if not e.name.startswith("caps_tpu_torch.") \
                or e.device_type != DeviceType.CPU:
            continue
        slot = out.setdefault(e.name.split(".", 1)[1], {
            "ranges": 0, "device_ms": 0.0, "own_device_ms": 0.0,
            "host_ms": 0.0})
        slot["ranges"] += 1
        slot["device_ms"] += device_us(e) / 1e3
        slot["own_device_ms"] += own_us(e) / 1e3
        slot["host_ms"] += (e.time_range.end - e.time_range.start) / 1e3
    return out


def run_profile(torch, np, args, card: str, state):
    """PROFILE and tracing on the slice's session: PROFILE of the
    grouped query at ``$age = 30`` eager with per-operator sync (timing
    tag ``device``) and on an exact replay without it (``dispatch``, one
    aggregate device span), each operator's profiled rows equal to the
    same run's; a plain run afterwards hits the plan cache with no
    profile text and replays with 0 size reads and no synchronizing
    call; device time by ``caps_tpu_torch.<Op>`` range; a traced run
    exported as a Chrome trace; exact-replay latency with tracing off,
    on and under PROFILE; the ``compile.*`` and ``mem.*`` metrics."""
    import tempfile
    from caps_tpu_torch.relational.session import degraded_execution
    session, graph, nodes, rels, _ = state
    params = {"age": AGE}
    want = oracle(np, nodes, rels, AGE)[0]
    out = {"phase": "profile", "card": card}
    q_prof = "PROFILE " + QUERY_GROUPED

    # PROFILE with per-operator sync, eager (no plan cache, no fusing),
    # twice: the first run also pays the allocator's growth
    eager_s = []
    for _ in range(2):
        with degraded_execution(no_plan_cache=True, no_fused=True):
            _, res, s = timed_query(torch, graph, q_prof, params)
        eager_s.append(s)
        expect("eager", res.metrics["fused_mode"] == "eager",
               res.metrics["fused_mode"], "profile")
        operators = check_profile("eager", res, want, "device")
    out["eager_sync"] = {"runs_s": eager_s, "operators": operators}

    # PROFILE without it, on an exact replay of the cached plan
    for _ in range(2):
        timed_query(torch, graph, QUERY_GROUPED, params)
    config = session.config
    session.config = dataclasses.replace(config, profile_sync_each_op=False)
    try:
        _, res, s = timed_query(torch, graph, q_prof, params)
    finally:
        session.config = config
    expect("replay", res.metrics["fused_mode"] == "replay"
           and res.metrics["plan_cache"] == "hit"
           and res.metrics["size_syncs"] == 0,
           f"PROFILE did not replay: {run_info(session, res)}", "profile")
    out["replay_dispatch"] = {
        "s": s, "replay_device_s": res.metrics["replay_device_s"],
        "operators": check_profile("replay", res, want, "dispatch")}

    # the plain query afterwards: the cached plan and the fused memo are
    # unpoisoned
    entries = session.plan_cache.stats()["entries"]
    res, sites = count_syncs(torch, lambda: graph.cypher(QUERY_GROUPED,
                                                         params))
    expect("after", res.records.to_maps() == want
           and res.metrics["plan_cache"] == "hit"
           and "profile" not in res.plans and res.profile is None
           and session.fused.last_mode == "replay"
           and res.metrics["size_syncs"] == 0 and not sites
           and session.plan_cache.stats()["entries"] == entries,
           f"the plain run after PROFILE: {run_info(session, res)}, "
           f"plans {sorted(res.plans)}, synchronizing calls {sites}",
           "profile")

    def replay():
        graph.cypher(QUERY_GROUPED, params).records.to_maps()

    out["device_ms_by_operator_range"] = range_device_ms(torch, replay)
    out["exact_replay_profile"] = device_profile(torch, replay)

    # exact-replay latency: tracing off, on, PROFILE (sync off, then
    # on), tracing off again — one call, in turns
    def warm(query, n=5):
        return [timed_query(torch, graph, query, params)[2]
                for _ in range(n)]

    lat = {"trace_off": warm(QUERY_GROUPED)}
    session.tracer.enabled = True
    session.tracer.clear()
    try:
        lat["trace_on"] = warm(QUERY_GROUPED)
        expect("trace", session.fused.last_mode == "replay",
               "a traced run did not replay", "profile")
        spans = len(session.tracer.spans)
        with tempfile.TemporaryDirectory() as tmp:
            path = session.export_trace(os.path.join(tmp, "trace.json"))
            with open(path) as f:
                events = json.load(f)["traceEvents"]
    finally:
        session.tracer.enabled = False
        session.tracer.clear()
    op_events = sum(1 for e in events if e["name"].startswith("op."))
    expect("trace", op_events > 0 and spans >= 5,
           f"the trace has {len(events)} events, {spans} root spans",
           "profile")
    out["trace"] = {"root_spans": spans, "events": len(events),
                    "operator_events": op_events}
    session.config = dataclasses.replace(config, profile_sync_each_op=False)
    try:
        lat["profile_dispatch"] = warm(q_prof)
    finally:
        session.config = config
    lat["profile_sync"] = warm(q_prof)
    lat["trace_off_again"] = warm(QUERY_GROUPED)
    out["exact_replay_s"] = {k: statistics.median(v) for k, v in lat.items()}
    out["exact_replay_runs_s"] = lat
    snap = session.metrics_snapshot()
    out["metrics"] = {k: v for k, v in snap.items()
                      if k.startswith(("compile.", "mem.", "tracer."))}
    out["compile_summary"] = session.compile_ledger.summary(top=4)
    out["memory"] = session.memory_ledger.report()["devices"]
    emit(out)


def live_oracle(np, people, edges, age: int):
    """``oracle``'s grouped rows over the live persons and relationships
    after writes: ids with gaps (deleted persons, ids allocated past the
    base's), values as the writes left them."""
    alive = people["alive"]
    ids = people["_id"][alive]
    ok = edges["alive"]
    src, tgt = edges["_src"][ok], edges["_tgt"][ok]
    dom = int(people["_id"].max()) + 1
    seeds = np.zeros(dom)
    seeds[ids[people["age"][alive] == age]] = 1.0
    hop1 = np.bincount(tgt, weights=seeds[src], minlength=dom)
    hop2 = np.bincount(tgt, weights=hop1[src], minlength=dom)
    loops = src == tgt
    hop2 -= np.bincount(tgt[loops], weights=seeds[src[loops]],
                        minlength=dom)
    return top_cities(np, {"Person": {"city": people["city"][alive]}},
                      hop2[ids])


def run_updates(torch, np, args, card: str, state):
    """Live updates on the slice's graph, wrapped by ``versioned``; the
    base itself is never changed.  The structures the write path reads
    over the base (the id allocator's start, the node and relationship
    lookups, the incidence index) are timed one by one on first use;
    then 500 single-statement writes (WRITES) in an order drawn from
    --seed, the grouped query after every WRITE_CHECK_EVERY writes equal
    to a numpy oracle of the mutated arrays and a snapshot pinned before
    the first write equal to the base's answer; 5 exact replays on the
    final snapshot (0 size reads, no synchronizing call), whose K1–K3
    calls the kernels phase holds against the plain versions; an
    aborted write that leaves the version and the string pool as they
    were and whose retry commits; a compaction, after which the grouped
    query reads the same and the delta is empty."""
    from caps_tpu_torch import ops
    from caps_tpu_torch.relational import updates as U
    from caps_tpu_torch.testing.faults import abort_write
    session, graph, nodes, rels, _ = state
    params = {"age": AGE}
    out = {"phase": "updates", "card": card}
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    ops.reset_launches()
    t_phase = time.perf_counter()
    base_want = oracle(np, nodes, rels, AGE)[0]

    # the structures the write path reads over the base, each timed on
    # its first use: the id allocator's start (the largest id, from the
    # id columns' sorted indexes), a node and a relationship lookup, an
    # incidence lookup (the endpoint columns' indexes)
    host = {}
    t0 = time.perf_counter()
    vg = U.versioned(session, graph)
    host["versioned_s"] = time.perf_counter() - t0
    first_rel = int(rels["KNOWS"]["_id"][0])
    for name, fn in (("node_lookup_s", lambda: U._BaseNodes(graph)[0]),
                     ("rel_lookup_s",
                      lambda: U._BaseRels(graph)[first_rel]),
                     ("incidence_s",
                      lambda: U._BaseIncidence(graph).get(0))):
        t0 = time.perf_counter()
        fn()
        host[name] = time.perf_counter() - t0
    out["base_structures"] = host
    pinned = vg.current()

    # the numpy side of every write: the base arrays with room for the
    # created entities behind them (a slot is live once written)
    def with_room(cols, extra):
        out = {k: np.concatenate([np.asarray(v), np.zeros(
            extra, np.asarray(v).dtype)]) for k, v in cols.items()}
        out["alive"] = np.arange(len(out["_id"])) < len(cols["_id"])
        out["n"] = len(cols["_id"])
        return out

    person = with_room(dict(nodes["Person"], city=nodes["Person"]["city"]
                            .astype("U32")), WRITES["person"] + 1)
    knows = with_room(rels["KNOWS"], WRITES["edge"])
    cities = np.unique(nodes["Person"]["city"])
    rng = np.random.default_rng(args.seed + 2)
    order = [k for k, n in WRITES.items() for _ in range(n)]
    rng.shuffle(order)

    def append(arrays, **vals):
        i = arrays["n"]
        for k, v in vals.items():
            arrays[k][i] = v
        arrays["alive"][i] = True
        arrays["n"] += 1

    def pick(arrays):
        while True:
            i = int(rng.integers(arrays["n"]))
            if arrays["alive"][i]:
                return i

    latency = {k: [] for k in WRITES}
    first_commit = None
    checks = []
    for n, kind in enumerate(order, 1):
        if kind == "edge":
            a, b = person["_id"][pick(person)], person["_id"][pick(person)]
            p = {"a": int(a), "b": int(b)}
        elif kind == "person":
            p = {"age": int(rng.integers(18, 90)),
                 "city": str(cities[rng.integers(len(cities))])}
        elif kind == "set":
            i = pick(person)
            p = {"id": int(person["_id"][i]),
                 "age": int(rng.integers(18, 90))}
        elif kind == "delete_rel":
            i = pick(knows)
            p = {"id": int(knows["_id"][i])}
        else:
            i = pick(person)
            p = {"id": int(person["_id"][i])}
        new_id = vg._next_id
        t0 = time.perf_counter()
        res = vg.cypher(UPDATE_QUERIES[kind], p)
        torch.cuda.synchronize()
        dt = time.perf_counter() - t0
        if first_commit is None:
            first_commit = {"kind": kind, "s": dt}
        latency[kind].append(dt)
        counts = res.metrics["updates"]
        if kind == "edge":
            expect(kind, counts["created_rels"] == 1, counts, "updates")
            append(knows, _id=new_id, _src=p["a"], _tgt=p["b"])
        elif kind == "person":
            expect(kind, counts["created_nodes"] == 1, counts, "updates")
            append(person, _id=new_id, age=p["age"], city=p["city"])
        elif kind == "set":
            expect(kind, counts["props_set"] == 1, counts, "updates")
            person["age"][i] = p["age"]
        elif kind == "delete_rel":
            expect(kind, counts["deleted_rels"] == 1, counts, "updates")
            knows["alive"][i] = False
        else:
            gone = knows["alive"] & ((knows["_src"] == p["id"])
                                     | (knows["_tgt"] == p["id"]))
            expect(kind, counts["deleted_nodes"] == 1
                   and counts["deleted_rels"] == int(gone.sum()),
                   f"{counts}, {int(gone.sum())} incident", "updates")
            knows["alive"] &= ~gone
            person["alive"][i] = False
        if n % WRITE_CHECK_EVERY == 0:
            rows, r, s = timed_query(torch, vg, QUERY_GROUPED, params)
            expect(f"after {n} writes", rows == live_oracle(
                np, person, knows, AGE), "the grouped query disagrees "
                "with the oracle of the mutated arrays", "updates")
            checks.append({"writes": n, "s": s, **run_info(session, r),
                           "version": vg.current().snapshot_version})
    rows = pinned.cypher(QUERY_GROUPED, params).records.to_maps()
    expect("pinned", rows == base_want, "the snapshot pinned before the "
           "first write changed its answer", "updates")
    final = live_oracle(np, person, knows, AGE)

    # exact replays on the final snapshot; the kernel calls of one
    recorders = query_recorders()
    snap = vg.current()
    rows, info, _ = pattern_runs(torch, session, snap, QUERY_GROUPED,
                                 params, card, cold=False,
                                 recorders=recorders)
    expect("final", rows == final, "replays disagree with the oracle",
           "updates")
    expect_replays("final", info, 0, "updates")
    check_query_launches("the final snapshot's replay",
                         info["replay_launches"])
    _, sites = count_syncs(torch, lambda: snap.cypher(QUERY_GROUPED,
                                                      params))
    expect("final", session.fused.last_mode == "replay" and not sites,
           f"an exact replay of the final snapshot synchronized: {sites}",
           "updates")
    state_now = snap.state
    out.update({
        "checks": checks,
        "snapshot_replay": {k: info[k] for k in (
            "warm_s", "warm_runs_s", "warm_runs", "replay_launches")},
        "delta_rows": vg.delta_rows(), "delta_bytes": vg.delta_nbytes(),
        "tombstones": len(state_now.hidden_nodes)
        + len(state_now.hidden_rels),
        "delta_records": len(state_now.nodes) + len(state_now.rels)})

    # an aborted write on the card, then its retry
    version = vg.current().snapshot_version
    pool = len(session.backend.pool)
    p = {"age": 30, "city": "city_written_once"}
    with abort_write(session, after_n_columns=1, n_times=1) as budget:
        try:
            vg.cypher(UPDATE_QUERIES["person"], p)
        except RuntimeError as ex:
            aborted = str(ex)
        else:
            raise RuntimeError("updates/abort: the write was not aborted")
    expect("abort", budget.injected == 1
           and vg.current().snapshot_version == version
           and len(session.backend.pool) == pool,
           "the aborted write changed the version or the string pool",
           "updates")
    new_id = vg._next_id
    res = vg.cypher(UPDATE_QUERIES["person"], p)
    expect("abort", res.metrics["snapshot_version"] == version + 1,
           "the retry did not commit", "updates")
    append(person, _id=new_id, age=p["age"], city=p["city"])
    out["abort"] = {"error": aborted[:80], "retry_version": version + 1}

    # compaction
    want = live_oracle(np, person, knows, AGE)
    before = vg.cypher(QUERY_GROUPED, params).records.to_maps()
    t0 = time.perf_counter()
    expect("compact", vg.compact(), "nothing to fold", "updates")
    torch.cuda.synchronize()
    out["compaction_s"] = time.perf_counter() - t0
    rows, r, s = timed_query(torch, vg, QUERY_GROUPED, params)
    expect("compact", before == want == rows and vg.delta_rows() == 0,
           "the grouped query changed across the compaction or the delta "
           "is not empty", "updates")
    out["after_compaction"] = {"first_read_s": s, **run_info(session, r)}

    # algo.degree() on the final snapshot against the mutated arrays
    alive = person["alive"]
    ids = np.sort(person["_id"][alive])
    ok = knows["alive"]
    si = np.minimum(np.searchsorted(ids, knows["_src"][ok]), len(ids) - 1)
    ti = np.minimum(np.searchsorted(ids, knows["_tgt"][ok]), len(ids) - 1)
    live = (ids[si] == knows["_src"][ok]) & (ids[ti] == knows["_tgt"][ok])
    want_deg = (np.bincount(si[live], minlength=len(ids))
                + np.bincount(ti[live], minlength=len(ids)))
    t0 = time.perf_counter()
    res = vg.cypher("CALL algo.degree() YIELD node, degree "
                    "RETURN node, degree")
    got = result_arrays(np, res, ["node", "degree"])
    torch.cuda.synchronize()
    (op,) = [m for m in res.metrics["operators"]
             if m["op"] == "AlgoProcedure"]
    expect("algo.degree", np.array_equal(got[0], ids)
           and np.array_equal(got[1], want_deg),
           "algo.degree() on the final snapshot disagrees with the "
           "mutated arrays", "updates")
    out["algo_degree"] = {"s": time.perf_counter() - t0,
                          "strategy": op["strategy"], "layout": op["layout"],
                          "nodes": int(len(ids)), "edges": int(live.sum())}

    def pct(v, q):
        return float(np.percentile(np.asarray(v), q)) if v else None

    out.update({
        "writes": {k: {"n": len(v), "p50_s": pct(v, 50), "p99_s": pct(v, 99)}
                   for k, v in latency.items()},
        "first_commit": first_commit,
        "fresh_snapshot_read_s": [c["s"] for c in checks],
        "stable_snapshot_read_s": info["warm_s"],
        "peak_mem_bytes": torch.cuda.max_memory_allocated(),
        "launches": ops.launches(),
        "seconds": time.perf_counter() - t_phase,
        "metrics": {k: v for k, v in session.metrics_snapshot().items()
                    if k.startswith(("updates.", "compaction."))},
        "oracle": "equal"})
    emit(out)
    del vg, pinned, snap
    return ({"snapshot_replay": info["replay_launches"]},
            {"snapshot": {r.name: r.calls for r in recorders}})


# -- phase construct: CONSTRUCT / RETURN GRAPH on the slice's graph ----------

def met_oracle(np, nodes, rels, age: int):
    """The :MET relationships step 1 builds: one per :KNOWS edge out of a
    person aged ``age`` (self-loops included), weighted by the target's
    age; grouped by the target's city (top 20 by count, then city), and
    their number."""
    p, k = nodes["Person"], rels["KNOWS"]
    sel = p["age"][k["_src"]] == age
    tgt = k["_tgt"][sel]
    names, codes = np.unique(p["city"], return_inverse=True)
    n = np.bincount(codes[tgt], minlength=len(names))
    w = np.bincount(codes[tgt], weights=p["age"][tgt], minlength=len(names))
    rows = sorted(((str(c), int(a), int(round(b)))
                   for c, a, b in zip(names, n, w) if a),
                  key=lambda r: (-r[1], r[0]))[:20]
    return [{"city": c, "n": a, "w": b} for c, a, b in rows], int(sel.sum())


def construct_run(torch, graph, query, params):
    """One CATALOG CREATE GRAPH: (the stored graph, its seconds split —
    the driving MATCH, the entity build, the table build — and what it
    built)."""
    t0 = time.perf_counter()
    built = graph.cypher(query, params).graph
    torch.cuda.synchronize()
    return built, dict(built.construct_stats,
                       total_s=time.perf_counter() - t0)


def column_range(torch, table, col):
    """(min, max) of an integer column's live values, on the card."""
    c = table._cols[col]
    live = c.data[:table._n][c.valid[:table._n]]
    return int(live.min()), int(live.max())


def run_construct(torch, np, args, card: str, state):
    """CONSTRUCT / RETURN GRAPH on the slice's graph, stored in the
    catalog as ``session.base``: (1) a new graph of the seeds' clones and
    one :MET per :KNOWS edge out of them, held to a numpy oracle, its
    minted ids disjoint from the base's; (2) the same :MET edges ON the
    base (a union), where the grouped 2-hop query still gives the base's
    answer, cold and 5 exact replays against the base's replays; (3)
    the overlay (SET on the persons of a base cut by CONSTRUCT_CUT,
    stored as ``session.small`` in a session of its own), on which the grouped query at age + 100
    gives that base's answer and at the old age none (the build copies
    every entity of its base into Python dicts,
    ``_materialize_graph_into``, as the reference does: on the host, at
    a cost that grows with the base, so the base is cut).
    Each CONSTRUCT's seconds split into the driving MATCH, the entity
    build (the overlay's copy of the base, ``materialize_s``, apart) and
    the table build; warm latencies, peak bytes and launches."""
    from caps_tpu_torch import ops
    session, graph, nodes, rels, _ = state
    params = {"age": AGE}
    out = {"phase": "construct", "card": card}
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    ops.reset_launches()
    t_phase = time.perf_counter()
    session.catalog.store("base", graph)
    want_rows = oracle(np, nodes, rels, AGE)[0]
    met_rows, met_count = met_oracle(np, nodes, rels, AGE)
    n_ids = args.persons + args.edges

    # (1) a new graph: the seeds' clones and their :MET edges
    met, out["met"] = construct_run(torch, graph, CONSTRUCT_MET, params)
    rows, info, _ = pattern_runs(torch, session, met, QUERY_MET, {}, card)
    expect("met", rows == met_rows, f"{rows} != oracle {met_rows}",
           "construct")
    expect_replays("met", info, 0, "construct")
    met_table = [rt for rt in met.rel_tables if rt.rel_type == "MET"][0]
    lo, hi = column_range(torch, met_table.table, met_table.mapping.id_col)
    expect("met", lo >= n_ids and hi - lo + 1 == met_count,
           f"minted ids {lo}..{hi} overlap the base's 0..{n_ids - 1} or "
           f"miss some of {met_count}", "construct")
    out["met"].update(query=info, minted_ids=[lo, hi], met_rels=met_count)

    # (2) the same edges ON the base: a union graph
    union, out["union"] = construct_run(torch, graph, CONSTRUCT_UNION,
                                        params)
    rows, info, _ = pattern_runs(torch, session, union, QUERY_GROUPED,
                                 params, card)
    expect("union", rows == want_rows, f"{rows} != the base's answer",
           "construct")
    expect_replays("union", info, 0, "construct")
    counted = union.cypher(QUERY_MET_COUNT).records.to_maps()
    expect("union", counted == [{"c": met_count}],
           f"{counted} :MET != step 1's {met_count}", "construct")
    _rows, base_info, _ = pattern_runs(torch, session, graph, QUERY_GROUPED,
                                       params, card, cold=False)
    out["union"].update(query=info, base_replay_s=base_info["warm_s"],
                        base_replay_runs_s=base_info["warm_runs_s"])

    # (3) the overlay: SET on the own persons of a cut base, in a session
    # of its own: a query family's re-plan history is the session's, not
    # the graph's, so after the grouped query's re-plan on the slice's
    # graph the same family on a graph 10 times smaller would re-plan
    # every other run (as in the JAX package)
    import caps_tpu_torch
    from caps_tpu_torch.interop import graph_from_numpy
    s_nodes, s_rels = make_graph(np, args.seed + 20,
                                 args.persons // CONSTRUCT_CUT,
                                 args.edges // CONSTRUCT_CUT, CITIES)
    osession = caps_tpu_torch.local_session()
    small = graph_from_numpy(osession, s_nodes, s_rels)
    osession.catalog.store("small", small)
    small_rows = oracle(np, s_nodes, s_rels, AGE)[0]
    older, out["overlay"] = construct_run(torch, small, CONSTRUCT_OVERLAY,
                                          params)
    out["overlay"]["base"] = {"persons": args.persons // CONSTRUCT_CUT,
                              "edges": args.edges // CONSTRUCT_CUT}
    rows, info, _ = pattern_runs(torch, osession, older, QUERY_GROUPED,
                                 {"age": AGE + 100}, card)
    expect("overlay", rows == small_rows,
           f"age {AGE + 100}: {rows} != the base's age-{AGE} answer",
           "construct")
    expect_replays("overlay", info, 0, "construct")
    none = older.cypher(QUERY_GROUPED, params).records.to_maps()
    expect("overlay", none == [], f"age {AGE} still matches: {none}",
           "construct")
    out["overlay"]["query"] = info
    for name in ("met", "union"):
        session.catalog.delete(f"session.{name}")
    del older, small, osession
    out.update(phase_s=time.perf_counter() - t_phase,
               peak_mem_bytes=torch.cuda.max_memory_allocated(),
               launches=ops.launches(), oracle="equal")
    emit(out)


# -- phase fs: the slice's graph through the filesystem source --------------

QUERY_FEDERATED = (
    "FROM GRAPH session.base MATCH (a:Person) WHERE a.age = $age "
    "WITH a.city AS city, count(*) AS k "
    "FROM GRAPH fs.social MATCH (p:Person) "
    "WHERE p.city = city AND p.age = $age2 "
    "RETURN city, k, count(p) AS n ORDER BY city")
FEDERATED_AGE2 = AGE + 10


def federated_oracle(np, nodes, age: int, age2: int) -> list:
    """Per city: the base's persons of ``age`` (k) and the stored
    graph's persons of ``age2`` (n), for the cities that have both."""
    person = nodes["Person"]
    names, codes = np.unique(person["city"], return_inverse=True)
    k = np.bincount(codes[person["age"] == age], minlength=len(names))
    n = np.bincount(codes[person["age"] == age2], minlength=len(names))
    return [{"city": str(c), "k": int(a), "n": int(b)}
            for c, a, b in zip(names, k, n) if a and b]


def dir_bytes(path: str) -> int:
    return sum(os.path.getsize(os.path.join(d, f))
               for d, _dirs, files in os.walk(path) for f in files)


def run_fs(torch, np, args, card: str, state):
    """BASELINE config 5's data source on the card: the slice's graph
    stored through the port's ``FSGraphSource`` as parquet (a temporary
    directory outside the repository, removed at the end), loaded by a
    fresh session from the ``fs`` namespace, the grouped 2-hop query on
    it (cold, 5 exact replays with 0 size reads, the warm phase's 24
    rotating ages), each equal to the numpy oracle; then the federated
    MATCH across ``session.base`` (the same arrays ingested in memory)
    and ``fs.social`` against numpy.  Store seconds, load seconds by
    part (the Arrow read, the column build, the upload), bytes on disk,
    peak card memory, and the launches and kernel calls of one exact
    replay."""
    import tempfile
    import caps_tpu_torch
    from caps_tpu_torch.interop import graph_from_numpy
    from caps_tpu_torch.io.fs import FSGraphSource
    from caps_tpu_torch.okapi.graph import GraphName, Namespace
    session, graph, nodes, rels, _ = state
    out = {"phase": "fs", "card": card, "format": "parquet"}
    t_phase = time.perf_counter()
    root = tempfile.mkdtemp(prefix="caps_fs_")
    try:
        src = FSGraphSource(session, root)
        t0 = time.perf_counter()
        src.store(GraphName("social"), graph)
        out["store_s"] = time.perf_counter() - t0
        out["store_parts_s"] = src.last_store_s
        out["bytes_on_disk"] = dir_bytes(root)

        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        fs_session = caps_tpu_torch.local_session()
        fs_src = FSGraphSource(fs_session, root)
        fs_session.catalog.register_source(Namespace("fs"), fs_src)
        t0 = time.perf_counter()
        loaded = fs_session.catalog.graph("fs.social")
        torch.cuda.synchronize()
        out["load_s"] = time.perf_counter() - t0
        out["load_parts_s"] = fs_src.last_load_s

        params = {"age": AGE}
        want = oracle(np, nodes, rels, AGE)[0]
        recorders = query_recorders()
        rows, info, _result = pattern_runs(torch, fs_session, loaded,
                                           QUERY_GROUPED, params, card,
                                           recorders=recorders)
        expect("grouped", rows == want, f"{rows} != oracle {want}", "fs")
        expect_replays("grouped", info, 0, "fs")
        check_query_launches("the fs graph's exact replay",
                             info["replay_launches"])
        out["grouped"] = info
        rng = np.random.default_rng(args.seed + 1)   # the warm phase's ages
        ages = [int(a) for a in rng.integers(18, 90, ROTATING)]
        times, modes, got = [], [], []
        for a in ages:
            r, res, t = timed_query(torch, loaded, QUERY_GROUPED, {"age": a})
            times.append(t)
            modes.append(run_info(fs_session, res))
            got.append(r)
        for a, r in zip(ages, got):
            expect("rotating", r == oracle(np, nodes, rels, a)[0],
                   f"age {a} disagrees with the oracle", "fs")
        out["rotating"] = {"ages": ages, "median_s": statistics.median(times),
                           "runs_s": times,
                           "modes": [m["mode"] for m in modes],
                           "size_syncs": [m["size_syncs"] for m in modes]}

        t0 = time.perf_counter()
        base = graph_from_numpy(fs_session, nodes, rels)
        fs_session.catalog.store("base", base)
        torch.cuda.synchronize()
        out["federated_base_ingest_s"] = time.perf_counter() - t0
        fparams = {"age": AGE, "age2": FEDERATED_AGE2}
        fed_rows, fed_info, _res = pattern_runs(
            torch, fs_session, fs_session, QUERY_FEDERATED, fparams, card,
            warm=3)
        fed_want = federated_oracle(np, nodes, AGE, FEDERATED_AGE2)
        expect("federated", fed_rows == fed_want and fed_rows,
               f"{fed_rows[:5]} != oracle {fed_want[:5]}", "fs")
        out["federated"] = dict(fed_info, rows=len(fed_rows))
        out["peak_mem_bytes"] = torch.cuda.max_memory_allocated()
        fs_session.catalog.delete("session.base")
        del loaded, base, fs_session
    finally:
        shutil.rmtree(root, ignore_errors=True)
    torch.cuda.empty_cache()
    out.update(phase_s=time.perf_counter() - t_phase, oracle="equal")
    emit(out)
    return ({"fs_replay": info["replay_launches"]},
            {"fs_grouped": {r.name: r.calls for r in recorders}})


# -- phase algo: CALL algo.* on the slice's graph ----------------------------

# the dense-tile graph: nodes and edges.  Its session's bucket lattice
# is seeded with the node count (relational/shapes.py ``seed``, as the
# serving tier's warmup seeds it), so 2,000 nodes pad to 2,048 and the
# graph is dense-eligible (600,000 * 8 >= 2048^2); the unseeded ladder
# (256, 1024, 4096, ...) pads them to 4,096, past DENSE_MAX_NODES
ALGO_DENSE = (2_000, 600_000)
ALGO_WARM = 5
# the composed query: PageRank's top 20, then their cities through a
# MATCH (the plan joins 20 rows with the 1M persons at most)
QUERY_ALGO_TOP = ("CALL algo.pagerank() YIELD node, score "
                  "WITH node, score ORDER BY score DESC, node LIMIT 20 "
                  "MATCH (p:Person) WHERE id(p) = node "
                  "RETURN node, score, p.city AS city "
                  "ORDER BY score DESC, node")


def algo_queries(source: int):
    """(label, query, procedure, bound arguments of the oracle, value
    column) of the five procedures; ``source`` is the BFS/SSSP seed's
    id (node ids are 0..n-1, so it is also its index)."""
    return [
        ("degree", "CALL algo.degree('both') YIELD node, degree "
         "RETURN node, degree", "algo.degree", {"direction": "both"},
         "degree"),
        ("pagerank", "CALL algo.pagerank() YIELD node, score "
         "RETURN node, score", "algo.pagerank",
         {"damping": 0.85, "max_iterations": 20, "tolerance": 1e-6},
         "score"),
        ("wcc", "CALL algo.wcc() YIELD node, component "
         "RETURN node, component", "algo.wcc", {"max_iterations": 100},
         "component"),
        ("bfs", f"CALL algo.bfs({source}) YIELD node, dist "
         "RETURN node, dist", "algo.bfs",
         {"source_index": source, "max_depth": -1}, "dist"),
        ("sssp", f"CALL algo.sssp({source}, 'w') YIELD node, dist "
         "RETURN node, dist", "algo.sssp",
         {"source_index": source, "max_iterations": -1}, "dist"),
    ]


def algo_oracle(np, name, n, src, tgt, w, bound):
    """The numpy kernel's answer as the operator emits it: (node ids,
    values) in id order (ids are 0..n-1), reachable nodes only for
    BFS/SSSP; and (iterations, converged)."""
    from caps_tpu_torch.algo import kernels
    out, iters, conv = kernels.run_host(name, n, src, tgt, w, bound)
    ids = np.arange(n, dtype=np.int64)
    keep = np.ones(n, bool)
    if name == "algo.bfs":
        keep = out != kernels.UNREACHED
    elif name == "algo.sssp":
        keep = np.isfinite(out)
    return (ids[keep], out[keep]), (int(iters), bool(conv))


def result_arrays(np, result, names):
    """The first rows of a result's columns as numpy arrays (one read
    each), ordered by the first column."""
    from caps_tpu_torch.ir import exprs as E
    rec = result.records
    table, header = rec.table, rec.header
    n = table.exact_size()
    cols = []
    for name in names:
        col = table._cols[header.column(E.Var(name))]
        if not bool(col.valid[:n].all()):
            raise RuntimeError(f"algo: null in column {name}")
        cols.append(col.data[:n].cpu().numpy())
    order = np.argsort(cols[0], kind="stable")
    return [c[order] for c in cols]


def algo_runs(torch, np, session, graph, query, names, want, stats,
              layout, label, warm=ALGO_WARM):
    """One CALL's cold run and ``warm`` repeats (re-plans handled as in
    ``pattern_runs``), each equal to the oracle ``want`` (arrays, bit
    for bit) with its ``stats`` (iterations, converged), on strategy
    device-fixpoint and ``layout``.  Per run: host seconds to the
    fetched columns, the operator's split, size reads; the cold run's
    synchronizing calls ("file:line" each; the fetch of the two result
    columns makes four) and compile charges, a warm run's again."""
    def one():
        t0 = time.perf_counter()
        res = graph.cypher(query)
        got = result_arrays(np, res, names)
        torch.cuda.synchronize()
        return res, got, time.perf_counter() - t0

    def checked(res, got):
        (op,) = [m for m in res.metrics["operators"]
                 if m["op"] == "AlgoProcedure"]
        expect(label, all(np.array_equal(g, w) for g, w in zip(got, want)),
               "the rows disagree with the numpy oracle", "algo")
        expect(label, (op["iterations"], op["converged"]) == stats,
               f"iterations/converged {op['iterations']}/"
               f"{op['converged']} != the oracle's {stats}", "algo")
        expect(label, op["strategy"] == "device-fixpoint"
               and op["layout"] == layout,
               f"ran {op['strategy']}/{op['layout']}", "algo")
        return {"s": None, "strategy": op["strategy"],
                "layout": op["layout"],
                "graph_arrays_s": op["graph_arrays_s"],
                "fixpoint_s": op["fixpoint_s"], "emit_s": op["emit_s"],
                "size_syncs": res.metrics["size_syncs"],
                "mode": session.fused.last_mode,
                "plan_cache": res.metrics["plan_cache"],
                "algo_compile_s": sum(
                    c["seconds"] for c in res.metrics.get(
                        "compile_charges", ()) if c["kind"] == "algo"),
                "compile_s_charged": res.metrics["compile_s_charged"]}

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    (res, got, s), sites = count_syncs(torch, one)
    cold = dict(checked(res, got), s=s, sync_sites=sites,
                iterations=stats[0], converged=stats[1])
    expect(label, cold["algo_compile_s"] > 0, "the cold run charged no "
           "algo compile", "algo")
    runs, replan_runs, seen = [], [], replans(session)
    while len(runs) < warm or replans(session) != seen:
        if len(replan_runs) > 2:
            raise RuntimeError(f"algo/{label}: keeps re-planning")
        res, got, s = one()
        info = dict(checked(res, got), s=s)
        if replans(session) != seen and info["mode"] == "record":
            seen = replans(session)
            replan_runs.append(info)
            runs = []
            continue
        expect(label, info["algo_compile_s"] == 0, "a warm run charged the "
               "algo kind", "algo")
        runs.append(info)
    (res, got, s), sites = count_syncs(torch, one)
    synced = dict(checked(res, got), s=s, sync_sites=sites)
    return {"cold": cold, "warm_s": statistics.median(r["s"] for r in runs),
            "warm_runs": runs, "replan_runs": replan_runs,
            "warm_sync_run": synced,
            "peak_mem_bytes": torch.cuda.max_memory_allocated()}, got


def timed_ingest(torch, np, nodes, rels, native: bool):
    """A fresh default session and the slice's graph ingested into it,
    with the native host runtime or with it opted out
    (``CAPS_TPU_NO_NATIVE=1``): total seconds, split into string encode
    (the pool's ``encode_many``), CSR build (``ops.build_csr``, its
    upload included) and column upload (``column._to``, synchronized)."""
    import caps_tpu_torch
    from caps_tpu_torch import native as N
    from caps_tpu_torch import ops
    from caps_tpu_torch.backends.cuda import column, pool
    from caps_tpu_torch.interop import graph_from_numpy
    spent = {"encode_s": 0.0, "csr_s": 0.0, "upload_s": 0.0}

    def timed(key, fn):
        def wrapper(*a, **k):
            t0 = time.perf_counter()
            out = fn(*a, **k)
            torch.cuda.synchronize()
            spent[key] += time.perf_counter() - t0
            return out
        return wrapper

    patches = [(pool.StringPool, "encode_many"),
               (pool.NativeStringPool, "encode_many"),
               (ops, "build_csr"), (column, "_to")]
    saved = [(o, a, o.__dict__[a]) for o, a in patches]
    before = os.environ.get(N.OPT_OUT_ENV)
    try:
        for o, a, fn in saved:
            key = {"encode_many": "encode_s", "build_csr": "csr_s",
                   "_to": "upload_s"}[a]
            setattr(o, a, timed(key, fn))
        if native:
            os.environ.pop(N.OPT_OUT_ENV, None)
        else:
            os.environ[N.OPT_OUT_ENV] = "1"
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        session = caps_tpu_torch.local_session()
        graph = graph_from_numpy(session, nodes, rels)
        torch.cuda.synchronize()
        total = time.perf_counter() - t0
    finally:
        for o, a, fn in saved:
            setattr(o, a, fn)
        if before is None:
            os.environ.pop(N.OPT_OUT_ENV, None)
        else:
            os.environ[N.OPT_OUT_ENV] = before
    return session, graph, {"native": native, "seconds": total,
                            "pool": type(session.backend.pool).__name__,
                            **spent}


def run_algo(torch, np, args, card: str, state):
    """``CALL algo.*`` on the slice's graph ingested once more with a
    float ``w`` on each :KNOWS edge (uniform integers 1-10 from --seed):
    the ingest timed with the native host runtime and with it opted
    out; each procedure cold and 5 warm runs, every one equal to the
    numpy kernels of ``algo/kernels.py`` with their iteration counts, on
    the edge-list layout; two PageRank runs with one digest; the
    composed top-20 query; then each procedure on a 2,000-node graph of
    600,000 edges on the dense-tile layout."""
    import hashlib
    _session, _graph, nodes, rels, _ = state
    out = {"phase": "algo", "card": card}
    t_phase = time.perf_counter()
    rng = np.random.default_rng(args.seed + 3)
    knows = dict(rels["KNOWS"])
    knows["w"] = rng.integers(1, 11, len(knows["_id"])).astype(np.float64)
    rels_w = {"KNOWS": knows}
    ingest = []
    for native in (True, False, True):
        session, graph, info = timed_ingest(torch, np, nodes, rels_w,
                                            native)
        ingest.append(info)
        if not native:
            del session, graph
    out["ingest"] = ingest
    expect("ingest", [i["pool"] for i in ingest] == [
        "NativeStringPool", "StringPool", "NativeStringPool"],
           f"pools {[i['pool'] for i in ingest]}", "algo")

    n = args.persons
    src, tgt, w = knows["_src"], knows["_tgt"], knows["w"]
    source = int(rng.integers(n))
    out["source"] = source
    calls, scores = {}, None
    for label, query, name, bound, col in algo_queries(source):
        t0 = time.perf_counter()
        want, stats = algo_oracle(np, name, n, src, tgt, w, bound)
        oracle_s = time.perf_counter() - t0
        info, got = algo_runs(torch, np, session, graph, query,
                              ["node", col], want, stats, "edge-list",
                              label)
        info["oracle_s"] = oracle_s
        info["rows"] = int(len(want[0]))
        if label == "pagerank":
            # the last warm run's scores, then one more run's
            scores = want
            again = result_arrays(np, graph.cypher(query), ["node", col])
            digests = [hashlib.sha256(a[1].tobytes()).hexdigest()
                       for a in (got, again)]
            expect("pagerank", digests[0] == digests[1],
                   f"two runs on the card differ: {digests}", "algo")
            info["digests"] = digests
        calls[label] = info
        emit({"phase": "algo", "part": label, "card": card, **info})

    # the composed query: top 20 by score, then their cities
    order = np.lexsort((scores[0], -scores[1]))[:20]
    city = nodes["Person"]["city"]
    want_top = [{"node": int(scores[0][i]), "score": float(scores[1][i]),
                 "city": str(city[scores[0][i]])} for i in order]
    rows, info, result = pattern_runs(torch, session, graph, QUERY_ALGO_TOP,
                                      {}, card)
    expect("top20", rows == want_top, f"{rows[:3]} != {want_top[:3]}",
           "algo")
    joined = max((m["rows"] for m in result.metrics["operators"]
                  if m["op"] in ("Join", "CartesianProduct", "Filter")),
                 default=0)
    expect("top20", joined <= 20 * n, f"{joined} rows in a join", "algo")
    info["operators"] = [[m["op"], m["rows"]]
                         for m in result.metrics["operators"]]
    calls["top20"] = info

    # the dense-tile family
    dn, de = ALGO_DENSE
    rng = np.random.default_rng(args.seed + 4)
    dsrc = rng.integers(0, dn, de, dtype=np.int64)
    dtgt = rng.integers(0, dn, de, dtype=np.int64)
    dw = rng.integers(1, 11, de).astype(np.float64)
    dnodes = {"Person": {"_id": np.arange(dn, dtype=np.int64)}}
    drels = {"KNOWS": {"_id": np.arange(dn, dn + de, dtype=np.int64),
                       "_src": dsrc, "_tgt": dtgt, "w": dw}}
    import caps_tpu_torch
    from caps_tpu_torch.interop import graph_from_numpy
    dsession = caps_tpu_torch.local_session()
    dsession.shape_lattice.seed([dn])
    dgraph = graph_from_numpy(dsession, dnodes, drels)
    dsource = int(rng.integers(dn))
    dense = {}
    for label, query, name, bound, col in algo_queries(dsource):
        want, stats = algo_oracle(np, name, dn, dsrc, dtgt, dw, bound)
        info, _got = algo_runs(torch, np, dsession, dgraph, query,
                               ["node", col], want, stats, "dense-tile",
                               f"dense/{label}")
        dense[label] = info
    out.update(calls={k: {"cold_s": v["cold"]["s"] if "cold" in v
                          else v["cold_s"], "warm_s": v["warm_s"]}
                      for k, v in calls.items()},
               dense=dense, nodes=n, edges=int(len(src)),
               dense_graph=list(ALGO_DENSE),
               phase_s=time.perf_counter() - t_phase, oracle="equal")
    emit(out)


# -- phase serve: QueryServer on the card ------------------------------------

def latency_summary(values) -> dict:
    """p50 and p99 (nearest rank) of a list of seconds."""
    v = sorted(values)
    if not v:
        return {"p50_s": None, "p99_s": None, "n": 0}
    at = lambda q: v[min(len(v) - 1, int(q * len(v)))]  # noqa: E731
    return {"p50_s": at(0.50), "p99_s": at(0.99), "n": len(v)}


def profile_window(torch, seconds: float) -> dict:
    """The card's busy time and idle share over ``seconds`` of whatever
    the other threads run (``torch.profiler`` traces every kernel on the
    card, whichever thread launched it)."""
    return device_profile(torch, lambda: time.sleep(seconds))


def serve_load(torch, server, graph, requests, want, threads: int,
               window_s=None, deadline_s=SERVE_DEADLINE_S):
    """``requests`` [(query, params, key)] from ``threads`` closed-loop
    clients (each submits, waits for its rows, submits the next) through
    ``server``, or, with ``server`` None, from one thread calling
    ``graph.cypher`` in turn.  Every answer is held to ``want[key]``.
    With ``window_s``, ``torch.profiler`` traces the card for that long
    while the clients run (its trace is parsed on the calling thread,
    which holds the interpreter for seconds: the latencies of such a run
    are not the load's).  Returns the numbers and the handles' info
    dicts."""
    from caps_tpu_torch import ops
    session = graph.session
    syncs0 = session.backend.syncs
    ops.reset_launches()
    infos, errors = [None] * len(requests), []
    profile = {}

    def serve(i):
        q, p, key = requests[i]
        if server is None:
            t0 = time.perf_counter()
            rows = graph.cypher(q, p).records.to_maps()
            info = {"latency_s": time.perf_counter() - t0,
                    "queue_wait_s": 0.0}
        else:
            h = server.submit(q, p, deadline_s=deadline_s)
            rows = h.rows(timeout=60)
            info = h.info
        if rows != want[key]:
            errors.append((i, key, rows))
        infos[i] = info

    t0 = time.perf_counter()
    if server is None:
        for i in range(len(requests)):
            serve(i)
    else:
        import threading
        per = [list(range(t, len(requests), threads))
               for t in range(threads)]

        def client(mine):
            try:
                for i in mine:
                    serve(i)
            except Exception as ex:  # the run fails below
                errors.append(ex)

        workers = [threading.Thread(target=client, args=(m,)) for m in per]
        for w in workers:
            w.start()
        if window_s:
            time.sleep(0.5)
            profile = profile_window(torch, window_s)
        for w in workers:
            w.join(timeout=600)
        if any(w.is_alive() for w in workers):
            raise RuntimeError("serve: a client thread did not finish")
    torch.cuda.synchronize()
    elapsed = time.perf_counter() - t0
    if errors:
        done = [i["latency_s"] for i in infos if i is not None]
        raise RuntimeError(f"serve: {len(errors)} of {len(requests)} "
                           f"requests failed or disagree with their "
                           f"oracles, first {errors[0]!r}; answered "
                           f"{len(done)} in {elapsed:.1f} s, latency "
                           f"{latency_summary(done)}")
    n = len(requests)
    launches = ops.launches()
    return {"requests": n, "seconds": elapsed, "requests_per_s": n / elapsed,
            "latency": latency_summary([i["latency_s"] for i in infos]),
            "queue_wait": latency_summary([i["queue_wait_s"]
                                           for i in infos]),
            "size_reads_per_request": (session.backend.syncs - syncs0) / n,
            "launches_per_request": sum(launches.values()) / n,
            "launches": launches, "profile": profile}, infos


def batch_sizes(infos) -> dict:
    sizes = [i.get("batch_size", 1) for i in infos if "batch_size" in i]
    return {"mean": statistics.mean(sizes) if sizes else None,
            "max": max(sizes) if sizes else None}


def run_serve(torch, np, args, card: str, state):
    """The serving tier on the card (``QueryServer``), over the slice's
    graph on the heuristic session (``use_cost_model=False``: the count
    form runs on count pushdown; the grouped query's plan is the
    default session's, checked in the slice phase): 8 closed-loop
    clients send SERVE_REQUESTS requests — 80 % the grouped 2-hop query,
    20 % its ``count(*)`` form, ``$age`` drawn from --seed over the warm
    phase's 8 rotating ages — each held to its oracle, then the same
    requests from one thread; one ``cypher_batch`` of 8 exact replays
    (no size read, no synchronizing call before its rows are read, its
    K1–K3 calls kept for the kernels phase); the load again with the
    result cache on; an overload burst; an expiring deadline; a second
    and a third session, warmed from the plan store the first server
    saved and cold; and failover between two replicas on the one card
    under ``device_loss(0)``."""
    import tempfile
    import threading
    import caps_tpu_torch
    from caps_tpu_torch import ops
    from caps_tpu_torch.interop import graph_from_numpy
    from caps_tpu_torch.okapi.config import EngineConfig
    from caps_tpu_torch.relational.plan_store import (PlanStore,
                                                      collect_warm_state)
    from caps_tpu_torch.relational.result_cache import (ResultCacheConfig,
                                                        params_digest,
                                                        result_cache_key)
    from caps_tpu_torch.serve import (DeadlineExceeded, Overloaded,
                                      QueryServer, RetryPolicy, ServerConfig,
                                      WarmupConfig)
    from caps_tpu_torch.testing.faults import device_loss, slow_operator
    _s, _g, nodes, rels, slice_info = state
    session, graph = slice_info["heuristic"]
    out = {"phase": "serve", "card": card, "session": "use_cost_model=False"}
    t_phase = time.perf_counter()

    # the load: the warm phase's 8 rotating ages, kinds and ages from
    # --seed; the oracles of every (kind, age)
    ages = [int(a) for a in np.random.default_rng(args.seed + 1).integers(
        18, 90, ROTATING)]
    want = {}
    coded = np.unique(nodes["Person"]["city"], return_inverse=True)
    for a in sorted(set(ages)):
        # oracle()'s answer, with the cities coded once for all ages
        _hop1, hop2 = hop_counts(np, nodes, rels, (
            nodes["Person"]["age"] == a).astype(np.int64))
        want[("grouped", a)] = top_cities(np, nodes, hop2, coded)
        want[("count", a)] = [{"c": int(round(hop2.sum()))}]
    rng = np.random.default_rng(args.seed + 9)
    grouped = rng.random(SERVE_REQUESTS) < 0.8
    picks = rng.integers(0, len(ages), SERVE_REQUESTS)
    requests = [(QUERY_GROUPED, {"age": ages[j]}, ("grouped", ages[j])) if g
                else (QUERY_COUNT, {"age": ages[j]}, ("count", ages[j]))
                for g, j in zip(grouped, picks)]
    out["load"] = {"requests": SERVE_REQUESTS, "clients": SERVE_CLIENTS,
                   "grouped_share": float(grouped.mean()),
                   "deadline_s": SERVE_DEADLINE_S}
    # each query recorded at AGE before the load: the load's other ages
    # then replay its generic stream, and AGE replays exactly
    want_age = oracle(np, nodes, rels, AGE)
    for q, rows in ((QUERY_GROUPED, want_age[0]),
                    (QUERY_COUNT, [{"c": want_age[1]}])):
        got = graph.cypher(q, {"age": AGE}).records.to_maps()
        expect("record", got == rows, f"{q!r} disagrees with its oracle",
               "serve")
    store = os.path.join(tempfile.mkdtemp(prefix="caps-serve-"),
                         "plans.json")

    # the load through one server (one replica on the card), then from
    # one thread calling graph.cypher
    server = QueryServer(session, graph=graph, config=ServerConfig(
        warmup=WarmupConfig(store_path=store, families=(),
                            background=False)))
    served, infos = serve_load(torch, server, graph, requests, want,
                               SERVE_CLIENTS)
    served["batch_size"] = batch_sizes(infos)
    served["stats"] = {k: server.stats()[k] for k in ("batching",)}
    # the worker's service time per member (a batch's time on its
    # replica, inside the replica's lock, over its members), windowed
    served["service_s_per_member_mean"] = server.telemetry.recent_service_s()
    out["server"] = served
    # the card's busy time and idle share over 2 s of the same load
    # (a run of its own: the trace's parse stalls the clients)
    profiled, _ = serve_load(torch, server, graph,
                             requests[:SERVE_PROFILED], want, SERVE_CLIENTS,
                             window_s=2.0, deadline_s=None)
    out["server"]["profile"] = profiled["profile"]
    one, _ = serve_load(torch, None, graph, requests, want, 1)
    out["one_thread"] = one

    # one served request's launches (an exact replay through the worker)
    ops.reset_launches()
    h = server.submit(QUERY_GROUPED, {"age": AGE})
    expect("request", h.rows(timeout=60) == want_age[0],
           "the served request disagrees with its oracle", "serve")
    served_launches = ops.launches()
    check_query_launches("one served request", served_launches)

    # host work done per request (the result cache's key and its params
    # digest, over the load's requests) and per plan-store save (the
    # fused streams' export, the warm state, the file)
    t0 = time.perf_counter()
    digests = [params_digest(p) for _q, p, _k in requests]
    digest_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    keys = [result_cache_key(graph, q, p) for q, p, _k in requests]
    key_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    streams = session.fused.export_streams(graph)
    export_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    payload = collect_warm_state(session, graph=graph)
    collect_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    saved = PlanStore(store).save(payload)
    save_s = time.perf_counter() - t0
    expect("host_work", None not in digests and None not in keys
           and streams and saved,
           f"digests {digests.count(None)} None, keys {keys.count(None)} "
           f"None, {len(streams)} streams, saved {saved}", "serve")
    out["host_work"] = {
        "requests": len(requests),
        "params_digest_s_per_request": digest_s / len(requests),
        "result_cache_key_s_per_request": key_s / len(requests),
        "export_streams_s": export_s, "streams": len(streams),
        "collect_warm_state_s": collect_s, "plan_store_save_s": save_s,
        "plan_store_bytes": os.path.getsize(store)}
    server.shutdown(timeout=60)

    # one micro-batch of 8 exact replays: no size read and no
    # synchronizing call until its rows are read
    batch_calls = query_recorders()
    for r in batch_calls:
        r.__enter__()
    try:
        results, sites = count_syncs(torch, lambda: session.cypher_batch(
            graph, [(QUERY_GROUPED, {"age": AGE})] * 8))
    finally:
        for r in batch_calls:
            r.__exit__()
    bad = [r for r in results if isinstance(r, BaseException)]
    expect("batch", not bad, f"members failed: {bad}", "serve")
    reads = [r.metrics["size_syncs"] for r in results]
    expect("batch", reads == [0] * 8 and not sites,
           f"size reads {reads}, synchronizing calls at {sites}", "serve")
    expect("batch", all(r.records.to_maps() == want_age[0]
                        for r in results),
           "a member's rows disagree with the oracle", "serve")
    out["batch"] = {"members": 8, "size_reads": reads, "sync_calls": 0,
                    "fused_batches": session.fused.batches}

    # the load again with the result cache on
    server = QueryServer(session, graph=graph, config=ServerConfig(
        result_cache=ResultCacheConfig()))
    cached, infos = serve_load(torch, server, graph, requests, want,
                               SERVE_CLIENTS)
    hits = [i for i in infos if i.get("cache") == "hit"]
    cached.update(hit_ratio=len(hits) / len(infos),
                  hit_latency=latency_summary([i["latency_s"]
                                               for i in hits]),
                  batch_size=batch_sizes(infos))
    expect("result_cache", hits, "no result-cache hit", "serve")
    server.shutdown(timeout=60)
    out["result_cache"] = cached

    # overload: a burst of 4 x max_queue from 16 threads
    config = ServerConfig()
    server = QueryServer(session, graph=graph, config=config)
    burst = [requests[i % len(requests)]
             for i in range(4 * config.max_queue)]
    admitted, shed, errors = [], [], []

    def burster(mine):
        for q, p, key in mine:
            try:
                admitted.append((server.submit(q, p), key))
            except Overloaded as ex:
                shed.append(ex.retry_after_s)
            except Exception as ex:
                errors.append(ex)

    threads = [threading.Thread(target=burster, args=(burst[t::16],))
               for t in range(16)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=120)
    t_end = time.perf_counter()
    healthy_after = None
    while time.perf_counter() - t_end < 5.0:
        if server.health() == "healthy":
            healthy_after = time.perf_counter() - t_end
            break
        time.sleep(0.01)
    wrong = [key for h, key in admitted if h.rows(timeout=60) != want[key]]
    expect("overload", shed and all(r > 0 for r in shed) and not errors
           and not wrong and healthy_after is not None,
           f"shed {len(shed)} (retry_after {shed[:3]}), errors {errors[:2]},"
           f" wrong {wrong[:3]}, healthy after {healthy_after}", "serve")
    out["overload"] = {"burst": len(burst), "admitted": len(admitted),
                       "shed": len(shed),
                       "retry_after_s": latency_summary(shed),
                       "healthy_after_s": healthy_after}

    # a deadline that expires inside the execute phase, then a request
    # served correctly
    with slow_operator("Scan", 0.2):
        h = server.submit(QUERY_GROUPED, {"age": AGE}, deadline_s=0.1)
        try:
            h.rows(timeout=60)
            raise RuntimeError("serve: the slowed request met its deadline")
        except DeadlineExceeded as ex:
            phase = ex.phase
    expect("deadline", phase == "execute", f"expired in {phase}", "serve")
    h = server.submit(QUERY_GROUPED, {"age": AGE})
    expect("deadline", h.rows(timeout=60) == oracle(np, nodes, rels,
                                                    AGE)[0],
           "the request after the deadline disagrees", "serve")
    server.shutdown(timeout=60)
    out["deadline"] = {"phase": phase, "next_request": "equal"}

    # warmup: a fresh session and server warmed from the store the first
    # server saved, beside a cold one; the first request of each family
    firsts = (("grouped", QUERY_GROUPED), ("count", QUERY_COUNT))
    out["warmup"] = {}
    for label, warm in (("warmed", True), ("cold", False)):
        fresh = caps_tpu_torch.local_session(
            config=EngineConfig(use_cost_model=False))
        t0 = time.perf_counter()
        fgraph = graph_from_numpy(fresh, nodes, rels)
        torch.cuda.synchronize()
        ingest_s = time.perf_counter() - t0
        t0 = time.perf_counter()
        server = QueryServer(fresh, graph=fgraph, config=ServerConfig(
            warmup=WarmupConfig(store_path=store, background=False,
                                save_on_shutdown=False)
            if warm else None))
        start_s = time.perf_counter() - t0
        snap0 = fresh.metrics_snapshot()
        first = {}
        for family, q in firsts:
            syncs0 = fresh.backend.syncs
            t0 = time.perf_counter()
            h = server.submit(q, {"age": AGE})
            rows = h.rows(timeout=120)
            first[family] = {"latency_s": time.perf_counter() - t0,
                             "size_reads": fresh.backend.syncs - syncs0,
                             "compile_s": h.info["ledger"]["compile_s"]}
            expect("warmup", rows == (want_age[0] if family == "grouped"
                                      else [{"c": want_age[1]}]),
                   f"{label} {family} disagrees", "serve")
        snap1 = fresh.metrics_snapshot()
        out["warmup"][label] = {
            "ingest_s": ingest_s, "server_start_s": start_s,
            "first_request": first,
            "warmup": server.warmer.report() if warm else None,
            "compile": {k: snap1.get(k, 0) - snap0.get(k, 0)
                        for k in snap1 if k.startswith("compile.")}}
        server.shutdown(timeout=60)
        del server, fgraph, fresh
    torch.cuda.empty_cache()

    # failover: two replicas on the one card, each on its own stream;
    # replica 0 lost for 200 requests, then, after the fault lifts,
    # reinstated by the probe where it was quarantined, and serving
    t0 = time.perf_counter()
    server = QueryServer(session, graph=graph, config=ServerConfig(
        devices=2, device_cooldown_s=0.5,
        retry=RetryPolicy(backoff_base_s=0.001)))
    replicate_s = time.perf_counter() - t0
    replicas = server.devices.replicas
    streams = {id(r.stream) for r in replicas if r.stream is not None}
    on_card = session.device.type == "cuda"
    expect("failover", all(r.device.type == session.device.type
                           for r in replicas)
           and len(streams) == (2 if on_card else 0),
           f"replicas on {[str(r.device) for r in replicas]}, "
           f"{len(streams)} streams", "serve")
    fault = requests[:SERVE_FAILOVER_REQUESTS]
    with device_loss(0) as budget:
        during, infos = serve_load(torch, server, graph, fault, want,
                                   SERVE_CLIENTS)
    at_lift = dict(server.stats()["devices"][0])
    health_during = dict(server.device_health())
    t_lift = time.perf_counter()
    # after the lift: a replica quarantined at the lift needs a NEW
    # reinstatement, and replica 0 must then answer a request right
    reinstated_after = served_on_0_after = None
    wrong_after = []
    while time.perf_counter() - t_lift < 10.0 and served_on_0_after is None:
        handles = [server.submit(QUERY_GROUPED, {"age": AGE})
                   for _ in range(4)]
        for h in handles:
            if h.rows(timeout=60) != want_age[0]:
                wrong_after.append(h.info.get("device"))
            elif h.info.get("device") == 0 and served_on_0_after is None \
                    and server.device_health()[0] == "healthy":
                served_on_0_after = time.perf_counter() - t_lift
        if reinstated_after is None and server.stats()["devices"][0][
                "reinstates"] > at_lift["reinstates"]:
            reinstated_after = time.perf_counter() - t_lift
        time.sleep(0.05)
    devs = server.stats()["devices"]
    quarantined_at_lift = health_during[0] != "healthy"
    expect("failover", budget.injected > 0 and devs[0]["quarantines"] >= 1
           and not wrong_after and served_on_0_after is not None
           and (reinstated_after is not None or not quarantined_at_lift),
           f"injected {budget.injected}, health at lift {health_during}, "
           f"reinstated after {reinstated_after}, served on 0 after "
           f"{served_on_0_after}, wrong {wrong_after}, devices {devs}",
           "serve")
    server.shutdown(timeout=60)
    out["failover"] = {"requests": len(fault), "all_correct": True,
                       "replicate_s": replicate_s,
                       "injected": budget.injected,
                       "p99_during_fault_s": during["latency"]["p99_s"],
                       "latency_during_fault": during["latency"],
                       "health_during_fault": health_during,
                       "replica0_at_lift": at_lift,
                       "reinstated_after_lift_s": reinstated_after,
                       "served_on_0_after_lift_s": served_on_0_after,
                       "devices": devs}
    out["phase_s"] = time.perf_counter() - t_phase
    emit(out)
    return ({"served_request": served_launches},
            {"served_batch": {r.name: r.calls for r in batch_calls}})


# -- phase fleet: durability and the fleet, backend processes on the card ----

QUERY_FLEET = (
    "MATCH (a:Person)-[:KNOWS]->(b)-[:KNOWS]->(c) WHERE a.age = $age "
    "RETURN c.age AS age, count(*) AS n ORDER BY n DESC, age LIMIT 20")
QUERY_FLEET_SET = "MATCH (p:Person {name: $name}) SET p.v = $v"
QUERY_FLEET_WRITTEN = ("MATCH (p:Person) WHERE p.v IS NOT NULL "
                       "RETURN p.name AS name, p.v AS v")
FLEET_BACKEND = "cuda"      # the children's sessions ("cpu" to rehearse)
FLEET_PER_BACKEND = 3       # read families (one $age each) per backend
FLEET_SOAK_S = 5.0          # each read soak: 1 backend, 3, 3 with a kill
FLEET_WRITE_SOAK_S = 6.0    # the durable write soak; the owner dies at 1/3
FLEET_HA_SOAK_S = 8.0       # the router HA soak under a chaos schedule
FLEET_NAMES = 16            # persons the idempotent SETs rotate over
FLEET_LEASE_TTL_S = 2.0
FLEET_ROUTER_TTL_S = 1.0
FLEET_WAL_APPENDS = 200     # appends timed per fsync policy
# the fleet's graph is the slice's cut by this factor: six children build
# it at once on the host's cores, and the zombie owner once more
FLEET_CUT = 4


def nvidia_smi(*query) -> list:
    """Rows of ``nvidia-smi <query> --format=csv,noheader,nounits``."""
    out = subprocess.run(["nvidia-smi", *query,
                          "--format=csv,noheader,nounits"], check=True,
                         capture_output=True, text=True, timeout=20).stdout
    return [[c.strip() for c in line.split(",")]
            for line in out.strip().splitlines() if line.strip()]


class UtilSampler:
    """``utilization.gpu`` every ``period_s`` while the block runs: the
    driver's share of the last sample period in which a kernel ran on
    the card (a coarse measure: a tiny kernel counts as a busy period)."""

    def __init__(self, period_s: float = 0.1):
        import threading
        self.period_s, self.samples = period_s, []
        self._stop = threading.Event()
        self._thread = threading.Thread(target=self._run, daemon=True)

    def _run(self):
        while not self._stop.is_set():
            t0 = time.perf_counter()
            self.samples.append(float(nvidia_smi(
                "--query-gpu=utilization.gpu")[0][0]))
            self._stop.wait(max(0.0, self.period_s
                                - (time.perf_counter() - t0)))

    def __enter__(self):
        self._thread.start()
        return self

    def __exit__(self, *exc):
        self._stop.set()
        self._thread.join(timeout=10)

    def summary(self) -> dict:
        v = sorted(self.samples)
        if not v:
            return {"samples": 0}
        return {"samples": len(v), "period_s": self.period_s,
                "mean_pct": statistics.mean(v), "p50_pct": v[len(v) // 2],
                "max_pct": v[-1],
                "note": "nvidia-smi utilization.gpu: the share of each "
                        "sample period with a kernel running, coarse"}


def fleet_oracle(np, a, age: int) -> list:
    """QUERY_FLEET's rows from the foaf arrays: 2-hop paths from the
    persons of ``age``, counted per end person, summed per end age."""
    ages, src, tgt = a["age"], a["src"], a["tgt"]
    n = ages.shape[0]
    hop1 = np.bincount(tgt[ages[src] == age], minlength=n)
    hop2 = np.bincount(tgt, weights=hop1[src], minlength=n)
    per_age = np.bincount(ages, weights=hop2)
    rows = [{"age": int(x), "n": int(round(per_age[x]))}
            for x in np.nonzero(per_age)[0]]
    rows.sort(key=lambda r: (-r["n"], r["age"]))
    return rows[:20]


class Fleet:
    """The phase's child processes: each one's name, process, port, and
    whether the script killed it.  A child that dies unasked fails the
    run with its stderr's tail."""

    def __init__(self):
        self.procs, self.ports, self.killed = {}, {}, set()
        self.spawn_s, self.replaced = {}, []

    def spawn(self, specs, spawn):
        """Start every spec at once (a thread each); returns when all
        report their ports, or raises with the first failure."""
        import threading
        errors = []

        def one(spec):
            t0 = time.perf_counter()
            try:
                proc, port = spawn(spec)
            except Exception as ex:
                errors.append(ex)
                return
            if spec.name in self.procs:   # a restart: keep the old one
                self.replaced.append(self.procs[spec.name])
            self.procs[spec.name], self.ports[spec.name] = proc, port
            self.spawn_s[spec.name] = time.perf_counter() - t0
            self.killed.discard(spec.name)

        threads = [threading.Thread(target=one, args=(s,)) for s in specs]
        for t in threads:
            t.start()
        return threads, errors

    @staticmethod
    def join(started):
        threads, errors = started
        for t in threads:
            t.join()
        if errors:
            raise errors[0]

    def addr(self, name):
        return ("127.0.0.1", self.ports[name])

    def kill(self, name):
        self.killed.add(name)
        self.procs[name].kill()
        self.procs[name].wait()

    def check_alive(self, where: str):
        from caps_tpu_torch.serve.fleet import stderr_tail
        for name, proc in self.procs.items():
            if name not in self.killed and proc.poll() is not None:
                raise RuntimeError(
                    f"fleet/{where}: child {name} exited unasked (code "
                    f"{proc.returncode}); its stderr ends:\n"
                    f"{stderr_tail(proc)}")

    def stop_all(self):
        for proc in [*self.procs.values(), *self.replaced]:
            if proc.poll() is None:
                proc.kill()
            proc.wait()
            try:
                os.unlink(proc.caps_stderr_path)
            except OSError:
                pass


def fleet_read_soak(router, families, want, seconds, kill=None):
    """One closed-loop client thread per family through ``router`` for
    ``seconds``; every reply is held to its oracle.  ``kill`` is
    ``(after_s, fn)``: ``fn`` runs once that far into the soak."""
    import collections
    import threading
    lock = threading.Lock()
    lat, per_backend, failed, wrong = [], collections.Counter(), [], []
    t_start = time.perf_counter()
    stop_at = t_start + seconds

    def client(fam, params):
        while time.perf_counter() < stop_at:
            t0 = time.perf_counter()
            try:
                out = router.query(QUERY_FLEET, params, family=fam)
            except Exception as ex:
                with lock:
                    failed.append(f"{type(ex).__name__}: {ex}")
                continue
            dt = time.perf_counter() - t0
            with lock:
                if out["rows"] != want[params["age"]]:
                    wrong.append((fam, out.get("backend")))
                lat.append(dt)
                per_backend[out["backend"]] += 1

    threads = [threading.Thread(target=client, args=(f, p), daemon=True)
               for f, p in families]
    for t in threads:
        t.start()
    killed_at = None
    if kill is not None:
        time.sleep(kill[0])
        killed_at = time.perf_counter() - t_start
        kill[1]()
    for t in threads:
        t.join(timeout=seconds + 120)
    elapsed = time.perf_counter() - t_start
    if any(t.is_alive() for t in threads):
        raise RuntimeError("fleet: a read client did not finish")
    n = len(lat)
    return {"requests": n, "failed": len(failed), "wrong": len(wrong),
            "availability": n / (n + len(failed)) if n + len(failed)
            else 0.0, "seconds": elapsed, "requests_per_s": n / elapsed,
            "latency": latency_summary(lat),
            "per_backend": dict(sorted(per_backend.items())),
            "killed_at_s": killed_at, "first_failure":
            failed[0] if failed else None,
            "first_wrong": wrong[0] if wrong else None}


def wal_append_latency(payload, policies=("always", "rotate", "never")):
    """Seconds per ``CommitLog.append`` of ``payload`` (the soak's
    cumulative delta) under each fsync policy, FLEET_WAL_APPENDS each,
    in a log beside the fleet's store."""
    import tempfile
    from caps_tpu_torch.durability import CommitLog
    from caps_tpu_torch.obs.metrics import MetricsRegistry
    out = {}
    for policy in policies:
        reg = MetricsRegistry()
        log = CommitLog(tempfile.mkdtemp(prefix=f"caps-wal-{policy}-"),
                        fsync=policy, registry=reg)
        times = []
        for v in range(1, FLEET_WAL_APPENDS + 1):
            t0 = time.perf_counter()
            log.append(v, payload)
            times.append(time.perf_counter() - t0)
        log.close()
        shutil.rmtree(log.dir_path, ignore_errors=True)
        snap = reg.snapshot()
        out[policy] = {**latency_summary(times),
                       "mean_s": statistics.mean(times),
                       "bytes_per_append": snap["wal.append_bytes"]
                       / FLEET_WAL_APPENDS,
                       "fsyncs": snap.get("wal.fsyncs", 0),
                       "rotations": snap.get("wal.rotations", 0)}
    return out


def run_fleet(torch, np, args, card: str) -> dict:
    """Durability and the fleet with backend processes on the card, all
    built from one ``foaf`` spec (``--persons`` people and ``--edges``
    edge draws, each cut by FLEET_CUT, ``--seed``):

    1. read scaling: 3 backends (``spawn_backend``, ``versioned``,
       ``workers=2``), FLEET_PER_BACKEND families per backend (one $age
       each, balanced on the ring), one closed-loop client per family
       for FLEET_SOAK_S through a solo router over ``p0``, then through
       the router over all 3; every reply equal to the numpy oracle;
       requests/s, router latency, requests per backend, card
       utilization sampled every 100 ms, each child's card memory;
    2. the soak again with a non-owner SIGKILLed a third of the way in:
       availability 1.0;
    3. a write through the owner, its ship lag, equal read-back digests
       on every live backend;
    4. 3 durable backends on one store (fsync ``always``), a write soak
       of idempotent SETs with 2 readers, the owner SIGKILLed: recovery
       seconds, no acknowledged write lost on any live backend, WAL
       append latency per fsync policy, the restarted owner's start and
       its write frames refused (stale epoch, no epoch);
    5. 2 routers (``spawn_router``) behind a ``RouterSet`` over the
       durable fleet, a seeded ``ChaosSchedule`` whose headline kills
       the active router: takeover seconds, read availability, the dead
       router's epoch fenced, every ``ChaosInvariants`` check green.

    The children are new interpreters: each builds the graph from the
    spec into its own CUDA context.  Returns the kernel launches the
    3-backend soak made in the children."""
    import tempfile
    import threading
    import caps_tpu_torch
    from caps_tpu_torch import native
    from caps_tpu_torch.obs.metrics import MetricsRegistry
    from caps_tpu_torch.serve.errors import ServeError, StaleEpoch
    from caps_tpu_torch.serve.fleet import (BackendSpec, foaf_arrays,
                                            rows_digest, spawn_backend)
    from caps_tpu_torch.serve.ha import RouterSet, RouterSpec, spawn_router
    from caps_tpu_torch.serve.router import FleetRouter, RouterConfig
    from caps_tpu_torch.serve.wire import WireClient
    from caps_tpu_torch.testing.chaos import (ChaosInvariants, ChaosRunner,
                                              ChaosSchedule)
    t_phase = time.perf_counter()
    out = {"phase": "fleet", "card": card, "backend": FLEET_BACKEND}
    gspec = {"kind": "foaf", "n_people": args.persons // FLEET_CUT,
             "n_edges": args.edges // FLEET_CUT, "seed": args.seed}
    store = tempfile.mkdtemp(prefix="caps-fleet-")
    out["graph"] = gspec
    out["durable_dir_fs"] = subprocess.run(
        ["df", "-T", store], capture_output=True, text=True
    ).stdout.strip().splitlines()[-1].split()[1]
    # every kernel and the native runtime are built (atomically, keyed by
    # source hash) before a child starts: the children load them
    native.runtime()
    torch.cuda.empty_cache()

    def spec(name, **kw):
        return BackendSpec(name=name, backend=FLEET_BACKEND, graph=gspec,
                           versioned=True, workers=2, max_queue=512, **kw)

    def durable(name):
        return spec(name, durable_dir=store, wal_fsync="always",
                    lease_ttl_s=FLEET_LEASE_TTL_S)

    fleet = Fleet()
    routers = []
    try:
        # the read fleet and the durable fleet start together; the
        # script builds the same arrays once for its oracle meanwhile
        started = fleet.spawn([spec(f"p{i}") for i in range(3)]
                              + [durable(f"d{i}") for i in range(3)],
                              spawn_backend)
        t0 = time.perf_counter()
        arrays = foaf_arrays(gspec["n_people"], gspec["n_edges"],
                             args.seed)
        oracle_s = time.perf_counter() - t0
        fleet.join(started)
        out["start"] = {"spawn_s": dict(fleet.spawn_s),
                        "oracle_arrays_s": oracle_s,
                        "edges_kept": int(arrays["src"].shape[0])}
        pnames = ["p0", "p1", "p2"]
        router = FleetRouter({n: fleet.addr(n) for n in pnames}, owner="p0",
                             config=RouterConfig(max_attempts=3),
                             registry=MetricsRegistry())
        solo = FleetRouter({"p0": fleet.addr("p0")},
                           registry=MetricsRegistry())
        routers += [router, solo]

        # a balanced family set: FLEET_PER_BACKEND ages homed per backend
        rng = np.random.default_rng(args.seed + 11)
        groups = {n: [] for n in pnames}
        for age in [int(a) for a in rng.permutation(np.arange(20, 70))]:
            fam = f"age-{age}"
            home = router.ring.preference(
                FleetRouter.routing_key("default", fam, QUERY_FLEET))[0]
            if len(groups[home]) < FLEET_PER_BACKEND:
                groups[home].append((fam, {"age": age}))
        families = [fp for g in groups.values() for fp in g]
        if len(families) != FLEET_PER_BACKEND * len(pnames):
            raise RuntimeError(f"fleet: unbalanced family set {groups}")
        want = {p["age"]: fleet_oracle(np, arrays, p["age"])
                for _f, p in families}
        # warm every family on its home backend and on p0 (record, then
        # a replay), each reply held to its oracle
        t0 = time.perf_counter()
        for fam, params in families:
            for r in (router, solo, router, solo):
                got = r.query(QUERY_FLEET, params, family=fam)["rows"]
                expect(fam, got == want[params["age"]],
                       f"{got[:3]} != {want[params['age']][:3]}", "fleet")
        out["warm_s"] = time.perf_counter() - t0

        # every child is on the card: its session's device, its own
        # allocator's memory there, and nvidia-smi's list of processes
        clients = {n: WireClient(*fleet.addr(n)) for n in fleet.procs}
        devices = {n: c.call("device") for n, c in clients.items()}
        for n, d in devices.items():
            expect(f"{n}_device", d["device"].startswith(FLEET_BACKEND),
                   f"child {n} runs on {d['device']}", "fleet")
            if FLEET_BACKEND == "cuda":
                expect(f"{n}_memory", d["memory_reserved"] > 0,
                       f"child {n} holds no memory on the card", "fleet")
        apps = {int(r[0]): float(r[1]) for r in nvidia_smi(
            "--query-compute-apps=pid,used_memory")}
        pids = {n: d["pid"] for n, d in devices.items()}
        listed = {n: apps.get(p) for n, p in pids.items()}
        if any(v is not None for v in listed.values()):
            # the listing shows this machine's pids: every child in it
            missing = [n for n, v in listed.items() if not v]
            expect("smi_pids", not missing,
                   f"children not listed on the card: {missing}", "fleet")
        out["card_memory"] = {
            "nvidia_smi_mib_by_child": listed,
            "nvidia_smi_apps": {str(p): m for p, m in apps.items()},
            "child_pids": pids, "script_pid": os.getpid(),
            "reserved_bytes_by_child": {n: d.get("memory_reserved")
                                        for n, d in devices.items()},
            "script_reserved_bytes": int(torch.cuda.memory_reserved())}
        # K4 ran in each child's self-test; zero the counts for the soaks
        selftest = {n: clients[n].call("launches", reset=True)
                    for n in pnames}
        # (a CPU rehearsal launches no kernel: the checks are the card's)
        on_card = FLEET_BACKEND == "cuda"
        expect("selftest", not on_card or all(
            s.get("prefetch_gather", 0) >= 1 for s in selftest.values()),
               f"a child ran no kernel self-test: {selftest}", "fleet")
        out["launches_since_start"] = selftest
        fleet.check_alive("warm")

        # 1. read scaling: the same clients through 1 backend, then 3
        with UtilSampler() as util:
            solo_run = fleet_read_soak(solo, families, want, FLEET_SOAK_S)
        solo_run["utilization"] = util.summary()
        for n in pnames:
            clients[n].call("launches", reset=True)
        with UtilSampler() as util:
            fleet_run = fleet_read_soak(router, families, want,
                                        FLEET_SOAK_S)
        fleet_run["utilization"] = util.summary()
        launches = {n: clients[n].call("launches") for n in pnames}
        total = {}
        for counts in launches.values():
            for k, v in counts.items():
                total[k] = total.get(k, 0) + v
        fleet_run["launches"] = launches
        for label, run in (("solo", solo_run), ("three", fleet_run)):
            expect(label, run["failed"] == 0 and run["wrong"] == 0,
                   f"{run['failed']} failed, {run['wrong']} wrong: "
                   f"{run['first_failure'] or run['first_wrong']}", "fleet")
        expect("spread", len(fleet_run["per_backend"]) == 3,
               f"requests reached {fleet_run['per_backend']}", "fleet")
        for k in ("expand_positions", "bitonic_sort"):
            expect(f"launches_{k}", not on_card or all(
                launches[n].get(k, 0) > 0 for n in pnames),
                   f"a backend never launched {k}: {launches}", "fleet")
        fleet_run["speedup_vs_solo"] = (fleet_run["requests_per_s"]
                                        / solo_run["requests_per_s"])
        out["read"] = {"families": len(families), "solo": solo_run,
                       "three": fleet_run}
        fleet.check_alive("read")

        # 2. a non-owner SIGKILLed a third of the way into the soak
        victim = "p2"
        kill_run = fleet_read_soak(
            router, families, want, FLEET_SOAK_S,
            kill=(FLEET_SOAK_S / 3, lambda: fleet.kill(victim)))
        expect("kill", kill_run["availability"] == 1.0
               and kill_run["wrong"] == 0,
               f"availability {kill_run['availability']}, "
               f"{kill_run['wrong']} wrong: {kill_run['first_failure']}",
               "fleet")
        kill_run["victim"] = victim
        kill_run["router"] = {k: v for k, v in
                              router.registry.snapshot().items()
                              if k.startswith(("router.", "fleet."))}
        out["kill"] = kill_run
        fleet.check_alive("kill")

        # 3. read-your-writes across the live backends
        w = router.write(QUERY_FLEET_SET, {"name": "p7", "v": 1})
        digests = {}
        for n in ("p0", "p1"):
            rep = clients[n].call(
                "query", query="MATCH (p:Person {name: 'p7'}) "
                               "RETURN p.name AS name, p.v AS v",
                params={}, digest=True)
            expect(f"ryw_{n}", rep["rows"] == [{"name": "p7", "v": 1}],
                   f"{n} reads {rep['rows']}", "fleet")
            digests[n] = rep["digest"]
        expect("ryw", len(set(digests.values())) == 1,
               f"digests differ: {digests}", "fleet")
        out["read_your_writes"] = {
            "version": w["version"], "ship": w["ship"],
            "snapshot_lag_s": router.registry.snapshot()[
                "fleet.snapshot_lag_s"], "digests_equal": True}
        for n in pnames:
            if n != victim:
                fleet.kill(n)
        for c in (router, solo):
            c.close()

        # 4. durability: write soak over the durable fleet, owner killed
        dnames = ["d0", "d1", "d2"]
        dreg = MetricsRegistry()
        drouter = FleetRouter({n: fleet.addr(n) for n in dnames},
                              owner="d0", config=RouterConfig(
                                  max_attempts=3, failover_wait_s=30.0),
                              registry=dreg)
        routers.append(drouter)
        readers = families[:2]
        for fam, params in readers:
            for n in dnames:
                got = clients[n].call("query", query=QUERY_FLEET,
                                      params=params)["rows"]
                expect(f"warm_{n}", got == want[params["age"]],
                       "durable backend disagrees with the oracle", "fleet")
        acked = {}
        seq = [0]

        def write_soak(write, read, seconds, kill=None):
            """Idempotent SETs through ``write`` (each retried until
            acknowledged) with 2 readers through ``read``; ``kill`` is
            ``(after_s, fn)``.  Returns the reads' outcomes, the acks
            and the seconds from the kill to the next acknowledged write
            and served read."""
            stop = threading.Event()
            reads = {"ok": 0, "fail": 0, "wrong": 0, "after_kill": None,
                     "first_failure": None}
            t_kill = [None]

            def reader(fam, params):
                while not stop.is_set():
                    try:
                        got = read(fam, params)
                    except Exception as ex:
                        reads["fail"] += 1
                        reads["first_failure"] = reads["first_failure"] \
                            or f"{type(ex).__name__}: {ex}"
                        continue
                    reads["ok"] += 1
                    if got != want[params["age"]]:
                        reads["wrong"] += 1
                    if t_kill[0] is not None and reads["after_kill"] is None:
                        reads["after_kill"] = time.perf_counter() - t_kill[0]

            ts = [threading.Thread(target=reader, args=fp, daemon=True)
                  for fp in readers]
            for t in ts:
                t.start()
            t0 = time.perf_counter()
            n_acked, recovered, write_s = 0, None, []
            while time.perf_counter() - t0 < seconds:
                if kill is not None and t_kill[0] is None and \
                        time.perf_counter() - t0 >= kill[0]:
                    kill[1]()
                    t_kill[0] = time.perf_counter()
                params = {"name": f"p{1 + seq[0] % FLEET_NAMES}",
                          "v": seq[0]}
                tw = time.perf_counter()
                try:
                    write(params)
                except ServeError:
                    time.sleep(0.02)
                    continue   # the SAME idempotent write, until acked
                write_s.append(time.perf_counter() - tw)
                acked[params["name"]] = params["v"]
                n_acked += 1
                if t_kill[0] is not None and recovered is None:
                    recovered = time.perf_counter() - t_kill[0]
                seq[0] += 1
            stop.set()
            for t in ts:
                t.join(timeout=120)
            return {"acked": n_acked, "write_latency":
                    latency_summary(write_s), "reads": reads,
                    "recovery_s": recovered}

        owner_proc = fleet.procs["d0"]
        dsoak = write_soak(
            lambda p: drouter.write(QUERY_FLEET_SET, p, ship=False),
            lambda fam, p: drouter.query(QUERY_FLEET, p,
                                         family=fam)["rows"],
            FLEET_WRITE_SOAK_S,
            kill=(FLEET_WRITE_SOAK_S / 3, lambda: fleet.kill("d0")))
        expect("recovery", dsoak["recovery_s"] is not None,
               "no write was acknowledged after the owner died", "fleet")
        expect("durable_reads", dsoak["reads"]["fail"] == 0
               and dsoak["reads"]["wrong"] == 0,
               f"reads through the owner's loss: {dsoak['reads']}", "fleet")
        # the restarted owner starts while the router tier is measured
        zombie_started = fleet.spawn([durable("d0")], spawn_backend)
        drouter.ship_snapshots()
        expected = sorted(({"name": k, "v": v} for k, v in acked.items()),
                          key=lambda r: r["name"])
        live = [n for n in dnames if n != "d0"]
        for n in live:
            got = sorted(clients[n].call(
                "query", query=QUERY_FLEET_WRITTEN, params={})["rows"],
                key=lambda r: r["name"])
            expect(f"acked_{n}", got == expected,
                   f"{n} lost acknowledged writes: {len(got)} rows vs "
                   f"{len(expected)}", "fleet")
        wal_metrics = {n: {k: v for k, v in clients[n].call(
            "metrics_snapshot").items() if k.startswith("wal.")}
            for n in live}
        out["durability"] = {
            "fsync": "always", "lease_ttl_s": FLEET_LEASE_TTL_S,
            "killed": "d0", "killed_pid": owner_proc.pid,
            "new_owner": drouter.owner,
            "owner_epoch": drouter._owner_epoch, **dsoak,
            "acked_names": len(acked), "acked_write_loss": 0,
            "failovers": dreg.snapshot().get("router.failovers", 0),
            "wal_metrics": wal_metrics,
            "wal_append": wal_append_latency(clients[drouter.owner].call(
                "export_delta")["state"])}
        fleet.check_alive("durability")

        # 5. router HA over the durable fleet: 2 routers, a RouterSet, a
        #    seeded chaos schedule whose headline kills the active router
        rspecs = [RouterSpec(name=f"r{i}",
                             backends={n: fleet.addr(n) for n in dnames},
                             durable_dir=store, owner=drouter.owner,
                             lease_ttl_s=FLEET_ROUTER_TTL_S, poll_s=0.1,
                             failover_wait_s=30.0) for i in range(2)]
        drouter.close()
        rfleet = Fleet()
        fleet.join(rfleet.spawn(rspecs, spawn_router))
        rset = RouterSet({n: rfleet.addr(n) for n in rfleet.procs},
                         wait_s=10.0, registry=MetricsRegistry())
        routers.append(rset)
        t0 = time.perf_counter()
        while rset.active() is None:
            expect("active", time.perf_counter() - t0 < 10.0,
                   "no router became active", "fleet")
            time.sleep(0.05)
        schedule = ChaosSchedule.compose(
            args.seed, FLEET_HA_SOAK_S, n_events=6,
            headline="kill_router_active")
        expect("digest", schedule.digest() == ChaosSchedule.compose(
            args.seed, FLEET_HA_SOAK_S, n_events=6,
            headline="kill_router_active").digest(),
            "the same seed composed two schedules", "fleet")
        invariants = ChaosInvariants()
        dead = {}

        def kill_active(_ev):
            name = rset.active()
            dead["epoch"] = rset._clients[name].call("ping")["epoch"]
            dead["name"] = name
            rfleet.kill(name)
            dead["t"] = time.perf_counter()

        def ha_read(fam, params):
            rep = rset.query(QUERY_FLEET, params, family=fam, wait_s=10.0)
            invariants.note_read(f"{fam}@{rep.get('backend')}", True,
                                 version=rep.get("snapshot_version"))
            if "t" in dead and "read_after_s" not in dead:
                dead["read_after_s"] = time.perf_counter() - dead["t"]
            return rep["rows"]

        def ha_write(p):
            rset.write(QUERY_FLEET_SET, p, ship=True, wait_s=10.0)
            invariants.note_write_ack()
            if "t" in dead and "write_after_s" not in dead:
                dead["write_after_s"] = time.perf_counter() - dead["t"]

        runner = ChaosRunner(schedule,
                             actions={"kill_router_active": kill_active})
        with runner:
            def polled(p):
                runner.poll(time.perf_counter() - t_soak)
                ha_write(p)
            t_soak = time.perf_counter()
            hsoak = write_soak(polled, ha_read, FLEET_HA_SOAK_S)
            runner.poll(FLEET_HA_SOAK_S)
        for _ in range(hsoak["reads"]["fail"]):
            invariants.note_read("failed", False)
        expect("killed_router", "name" in dead,
               "the schedule's headline never fired", "fleet")
        new_active = rset.active()
        takeover = {"killed": dead["name"], "killed_epoch": dead["epoch"],
                    "new_active": new_active,
                    "first_read_after_kill_s": dead.get("read_after_s"),
                    "first_write_after_kill_s": dead.get("write_after_s")}
        expect("takeover", new_active not in (None, dead["name"])
               and dead.get("write_after_s") is not None,
               f"no takeover: {takeover}", "fleet")
        # the zombie-ROUTER fence at the owner: frames stamped with the
        # dead active's epoch, with and without the owner's epoch
        stats = rset.stats()
        owner = stats["owner"]
        with open(os.path.join(store, "lease.json")) as f:
            owner_epoch = int(json.load(f)["epoch"])
        with WireClient(*fleet.addr(owner)) as oc:
            v0 = oc.call("ping")["snapshot_version"]
            fence = []
            for fields in ({"router_epoch": dead["epoch"]},
                           {"router_epoch": dead["epoch"],
                            "epoch": owner_epoch}):
                try:
                    oc.call("write", query=QUERY_FLEET_SET,
                            params={"name": "p1", "v": -1}, **fields)
                    fence.append("APPLIED")
                except StaleEpoch:
                    fence.append("StaleEpoch")
            v1 = oc.call("ping")["snapshot_version"]
        router_fenced = fence == ["StaleEpoch", "StaleEpoch"] and v0 == v1
        invariants.note_fence(router_fenced)
        takeover.update(fence=fence, stats_epoch=stats.get("epoch"))

        # the restarted owner: its write frames are refused, nothing
        # applied (one write through the HA tier renews the lease first)
        fleet.join(zombie_started)
        ha_write({"name": "p1", "v": seq[0]})
        acked["p1"] = seq[0]
        with WireClient(*fleet.addr("d0")) as zc:
            zinfo = zc.call("ping")
            zfence = []
            for fields in ({"epoch": 1}, {}):
                try:
                    zc.call("write", query=QUERY_FLEET_SET,
                            params={"name": "p2", "v": -1}, **fields)
                    zfence.append("APPLIED")
                except StaleEpoch:
                    zfence.append("StaleEpoch")
            zversion = zc.call("ping")["snapshot_version"]
        zombie_fenced = (zfence == ["StaleEpoch", "StaleEpoch"]
                         and zversion == zinfo["snapshot_version"])
        invariants.note_fence(zombie_fenced)
        with WireClient(*fleet.addr(owner)) as oc:
            observed = rows_digest(oc.call("query", query=QUERY_FLEET_WRITTEN,
                                           params={})["rows"])
        oracle_digest = rows_digest([{"name": k, "v": v}
                                     for k, v in acked.items()])
        report = invariants.report(availability_floor=0.5,
                                   oracle_digest=oracle_digest,
                                   observed_digest=observed)
        expect("router_fence", router_fenced,
               f"the dead router's frames: {fence}, version {v0} -> {v1}",
               "fleet")
        expect("zombie_fence", zombie_fenced,
               f"the restarted owner's frames: {zfence}", "fleet")
        expect("invariants", report["ok"], f"{report}", "fleet")
        out["ha"] = {**hsoak, "takeover": takeover,
                     "schedule_digest": schedule.digest(),
                     "schedule_events": [e.as_dict()
                                         for e in schedule.events],
                     "invariants": report}
        out["zombie_owner"] = {"fence": zfence, "startup": zinfo["startup"],
                               "spawn_s": fleet.spawn_s["d0"],
                               "recovered_version":
                                   zinfo["snapshot_version"]}
        fleet.check_alive("ha")
        for c in clients.values():
            c.close()
        rfleet.check_alive("ha")
        rfleet.stop_all()
    finally:
        for r in routers:
            r.close()
        fleet.stop_all()
        shutil.rmtree(store, ignore_errors=True)
    out["phase_s"] = time.perf_counter() - t_phase
    emit(out)
    return total


# The mesh phase: a 4-shard mesh (4 cards where the process sees as
# many, else a virtual mesh on one card) driving the hand-scheduled
# distributed joins, the sharded K1 group-by, the ring schedules, the
# sharded query steps, a re-shard and a shard group.
MESH_SHARDS = 4
MESH_HUB_SHARE = 0.2        # M3: the share of edges that target node 0
MESH_HOT_FACTOR = 0.5       # M3: hot above half a shard's fair share
QUERY_HUB = ("MATCH (a:Person)-[:KNOWS]->(b:Person) WHERE a.age = $age "
             "RETURN b.city AS city, count(*) AS n ORDER BY n DESC, city "
             "LIMIT 20")
QUERY_VARLEN3_CITY = (
    "MATCH (a:Person)-[:KNOWS*1..3]->(c) WHERE a.age = $age "
    "AND a.city = $city "
    "RETURN c.city AS city, count(*) AS n ORDER BY n DESC, city LIMIT 20")
# M7: the shard group's traffic, and the member loss under it
SHARD_CLIENTS = 8
SHARD_REQUESTS = 300
SHARD_LOSS_REQUESTS = 200
SHARD_LOSS_FAULTS = 6
QUERY_CITY = ("MATCH (p:Person {city: $c}) "
              "RETURN count(*) AS n, min(p.age) AS lo, max(p.age) AS hi")
QUERY_SHARD_WRITE = "CREATE (:Person {city: $c, age: 200})"
QUERY_SHARD_READBACK = ("MATCH (p:Person {city: $c}) WHERE p.age = 200 "
                        "RETURN count(*) AS n")
# K1 launches one group-by of M1 makes at least: once per shard
MIN_MESH_LAUNCHES = {"segment_agg": MESH_SHARDS,
                     "expand_positions": MESH_SHARDS, "bitonic_sort": 1}


def mesh_numbers(torch, session, graph, query, params, card, recorders=(),
                 warm=5):
    """``pattern_runs`` plus the mesh's accounting of one exact replay:
    its dist joins, bytes between shards (padded buffers and live
    payload), and its device busy time and idle share."""
    rows, info, result = pattern_runs(torch, session, graph, query, params,
                                      card, warm=warm, recorders=recorders)
    expect_replays(query[:40], info, 0, "mesh")
    m = result.metrics
    info.update({k: m[k] for k in ("dist_joins", "broadcast_joins",
                                   "salted_joins", "ici_bytes",
                                   "ici_payload_bytes")})
    info["mesh"] = m.get("mesh")
    info["replay_profile"] = device_profile(
        torch, lambda: graph.cypher(query, params).records.to_maps())
    return rows, info, result


def hub_oracle(np, nodes, rels, age: int):
    """M3: the seeds' one-hop friends grouped by city (top 20)."""
    k = rels["KNOWS"]
    seeds = (nodes["Person"]["age"] == age).astype(np.int64)
    per_node = np.bincount(k["_tgt"], weights=seeds[k["_src"]],
                           minlength=len(seeds))
    return top_cities(np, nodes, per_node)


def shard_oracles(np, nodes, rels, ages):
    """M7's oracles: per city its persons' count, least and greatest
    age; and the grouped 2-hop rows of each of ``ages``."""
    persons = nodes["Person"]
    names, codes = np.unique(persons["city"], return_inverse=True)
    counts = np.bincount(codes, minlength=len(names))
    lo = np.full(len(names), 1 << 30)
    hi = np.full(len(names), -1)
    np.minimum.at(lo, codes, persons["age"])
    np.maximum.at(hi, codes, persons["age"])
    city = {str(c): [{"n": int(k), "lo": int(a), "hi": int(b)}]
            for c, k, a, b in zip(names, counts, lo, hi)}
    return city, {a: oracle(np, nodes, rels, a)[0] for a in ages}


def run_shard_group(torch, np, nodes, rels, card: str) -> dict:
    """M7: a ``QueryServer`` whose default graph is served by a shard
    group of MESH_SHARDS members partitioned by city (the members are
    sessions on the card, each on its own stream; the cross-shard
    session a MESH_SHARDS-shard mesh session): closed-loop clients send
    routed single-city reads and the grouped 2-hop query, every answer
    against its oracle; then a member lost under traffic, its rebuild
    and reinstatement; then one write through the group read back."""
    import caps_tpu_torch
    from caps_tpu_torch.interop import graph_from_numpy
    from caps_tpu_torch.serve import (QueryServer, RetryPolicy,
                                      ServerConfig, ShardGroupConfig)
    from caps_tpu_torch.testing.faults import shard_loss
    t0 = time.perf_counter()
    session = caps_tpu_torch.local_session()
    graph = graph_from_numpy(session, nodes, rels)
    ages = [AGE, AGE + 7, AGE + 19, AGE + 33]
    city_want, m1_want = shard_oracles(np, nodes, rels, ages)
    cities = sorted(city_want)
    server = QueryServer(session, graph=graph, config=ServerConfig(
        shards=MESH_SHARDS, max_queue=4 * SHARD_CLIENTS,
        shard_config=ShardGroupConfig(
            name="m7", partition_property="city",
            member_failure_threshold=1, member_cooldown_s=0.5),
        device_failure_threshold=1000, breaker_threshold=1000,
        retry=RetryPolicy(max_attempts=60, backoff_base_s=0.01,
                          backoff_max_s=0.1)))
    group = server.shard_groups[0]
    torch.cuda.synchronize()
    out = {"card": card, "members": MESH_SHARDS,
           "build_s": time.perf_counter() - t0,
           "partition_rows": [p.rows for p in group.partitions],
           "cross_mesh": group.cross_session.backend.mesh.describe()}

    def request(i):
        if i % 2 == 0:
            c = cities[(i * 7919) % len(cities)]
            return QUERY_CITY, {"c": c}, city_want[c]
        a = ages[(i // 2) % len(ages)]
        return QUERY_GROUPED, {"age": a}, m1_want[a]

    def soak(n_requests):
        lat, wrong, failed = [], [], []
        lock = threading.Lock()
        nxt = [0]

        def client():
            while True:
                with lock:
                    i = nxt[0]
                    nxt[0] += 1
                if i >= n_requests:
                    return
                q, params, want = request(i)
                t1 = time.perf_counter()
                try:
                    rows = server.submit(q, params).rows(timeout=120)
                except Exception as ex:
                    with lock:
                        failed.append(type(ex).__name__)
                    continue
                with lock:
                    lat.append(time.perf_counter() - t1)
                    if rows != want:
                        wrong.append((q[:30], params))
        threads = [threading.Thread(target=client)
                   for _ in range(SHARD_CLIENTS)]
        t1 = time.perf_counter()
        for t in threads:
            t.start()
        for t in threads:
            t.join()
        return time.perf_counter() - t1, lat, wrong, failed

    try:
        before = session.metrics_snapshot()
        wall, lat, wrong, failed = soak(SHARD_REQUESTS)
        snap = session.metrics_snapshot()
        single = snap["shard.requests.single"] \
            - before.get("shard.requests.single", 0)
        cross = snap["shard.requests.cross"] \
            - before.get("shard.requests.cross", 0)
        expect("M7", not wrong and not failed,
               f"wrong {wrong[:3]} failed {failed[:3]}", "mesh")
        out["soak"] = {"requests": SHARD_REQUESTS, "clients": SHARD_CLIENTS,
                       "wall_s": wall,
                       "requests_per_s": SHARD_REQUESTS / wall,
                       **latency_summary(lat),
                       "routed_share": single / max(1, single + cross)}

        # a member lost under traffic: quarantined, rebuilt, reinstated
        t_loss = time.perf_counter()
        with shard_loss("m7", 1, n_times=SHARD_LOSS_FAULTS) as budget:
            wall, lat, wrong, failed = soak(SHARD_LOSS_REQUESTS)
        expect("M7", not wrong, f"wrong answers {wrong[:3]}", "mesh")
        deadline = time.perf_counter() + 60
        while group.health() != "healthy" \
                and time.perf_counter() < deadline:
            time.sleep(0.01)
        m1s = group.summary()["members"][1]
        expect("M7", group.health() == "healthy"
               and m1s["quarantines"] >= 1 and m1s["reinstates"] >= 1,
               group.summary(), "mesh")
        out["loss"] = {"requests": SHARD_LOSS_REQUESTS,
                       "injected": budget.injected,
                       "right_share": len(lat) / SHARD_LOSS_REQUESTS,
                       "failed": len(failed), "wall_s": wall,
                       "seconds_to_reinstated": time.perf_counter() - t_loss,
                       "member": m1s,
                       "transitions": [t["state"] for t in
                                       group.summary()["transitions"]]}

        # one write through the group, read back on the owning member
        c = cities[0]
        server.submit(QUERY_SHARD_WRITE, {"c": c}).result(timeout=60)
        got = server.submit(QUERY_SHARD_READBACK,
                            {"c": c}).rows(timeout=60)
        expect("M7", got == [{"n": 1}], got, "mesh")
        out["write_readback"] = got
    finally:
        server.shutdown()
    return out


def run_mesh(torch, np, args, card: str, state) -> dict:
    """M1–M6 of the mesh phase (module docstring)."""
    import caps_tpu_torch
    from caps_tpu_torch import ops
    from caps_tpu_torch.interop import graph_from_numpy
    from caps_tpu_torch.okapi.config import EngineConfig
    from caps_tpu_torch.parallel.mesh import make_mesh
    from caps_tpu_torch.parallel.query_step import (
        make_collectives_smoke, make_sharded_two_hop)
    from caps_tpu_torch.relational.session import degraded_execution
    _session, _graph, nodes, rels, slice_info = state
    t_phase = time.perf_counter()
    age = {"age": AGE}
    out = {"phase": "mesh", "card": card, "shards": MESH_SHARDS}

    def mesh_session(graph_rels=rels, **cfg):
        s = caps_tpu_torch.local_session(config=EngineConfig(
            mesh_shape=(MESH_SHARDS,), **cfg))
        return s, graph_from_numpy(s, nodes, graph_rels)

    t0 = time.perf_counter()
    msess, mgraph = mesh_session(use_csr=False)
    psess = caps_tpu_torch.local_session(config=EngineConfig(use_csr=False))
    pgraph = graph_from_numpy(psess, nodes, rels)
    torch.cuda.synchronize()
    out["ingest_s"] = time.perf_counter() - t0
    out["mesh"] = msess.backend.mesh.describe()

    # -- M1: the grouped 2-hop query: radix joins, sharded K1, K3 ------
    want = oracle(np, nodes, rels, AGE)[0]
    sharded = Recorder(ops, "dense_segment_agg_sharded",
                       lambda a: a[1].shape[0])
    per_query = query_recorders()
    rows, m1, result = mesh_numbers(torch, msess, mgraph, QUERY_GROUPED, age,
                                    card, recorders=per_query + [sharded])
    expect("M1", rows == want, f"{rows[:3]} != oracle {want[:3]}", "mesh")
    check_query_launches("mesh M1", m1["replay_launches"], MIN_MESH_LAUNCHES)
    expect("M1", m1["dist_joins"] > 0, m1, "mesh")
    prow, pinfo, _ = pattern_runs(torch, psess, pgraph, QUERY_GROUPED, age,
                                  card)
    expect("M1", prow == rows, "unsharded rows differ", "mesh")
    m1["unsharded_cold_s"], m1["unsharded_warm_s"] = (pinfo["cold_s"],
                                                      pinfo["warm_s"])
    # each K1 call of the replay ran on one shard's block: the combine of
    # each sharded group-by equals the plain version over the whole column
    combines = 0
    for args_ in sharded.calls:
        mesh, codes, okm, vals, S, kind = args_
        got = ops.segment.dense_segment_agg_sharded(*args_)
        whole = ops.dense_segment_agg_plain(codes, okm, vals, S, kind)
        expect("M1", torch.equal(got, whole),
               f"sharded {kind} over {codes.shape[0]} rows differs from "
               f"the plain version", "mesh")
        combines += 1
    expect("M1", combines > 0, "no sharded group-by ran", "mesh")
    m1["sharded_group_bys"] = combines
    m1["k1_calls"] = len(per_query[0].calls)
    m1["k2_calls"] = len(per_query[1].calls)
    # eager and the 8 rotating ages (param-generic replays)
    with degraded_execution(no_plan_cache=True, no_fused=True):
        erows, _r, m1["eager_s"] = timed_query(torch, mgraph, QUERY_GROUPED,
                                               age)
    expect("M1", erows == want, "eager run differs", "mesh")
    rng = np.random.default_rng(args.seed + 1)
    ages = [int(a) for a in rng.integers(18, 90, ROTATING)]
    gen = []
    for a in ages:
        got, res, s = timed_query(torch, mgraph, QUERY_GROUPED, {"age": a})
        gen.append((a, got, s, msess.fused.last_mode))
    for a, got, _s, _mode in gen:
        expect("M1", got == oracle(np, nodes, rels, a)[0],
               f"age {a} differs from the oracle", "mesh")
    m1["rotating_s"] = statistics.median(s for _a, _g, s, _m in gen)
    m1["rotating_modes"] = sorted({m for *_x, m in gen})
    out["M1"] = m1

    # -- M2: broadcast joins for the seeds' hop --------------------------
    bsess, bgraph = mesh_session(use_csr=False,
                                 broadcast_join_threshold=1 << 24)
    plan = bgraph.cypher("EXPLAIN " + QUERY_GROUPED, age).plans.get("cost",
                                                                    "")
    expect("M2", "chosen=broadcast" in plan, plan, "mesh")
    rows, m2, _ = mesh_numbers(torch, bsess, bgraph, QUERY_GROUPED, age,
                               card)
    expect("M2", rows == want and m2["broadcast_joins"] > 0, m2, "mesh")
    m2["cost"] = plan
    out["M2"] = m2
    del bsess, bgraph

    # -- M3: a salted radix join through a hub ---------------------------
    hub_rng = np.random.default_rng(args.seed + 15)
    k = rels["KNOWS"]
    hub_tgt = np.where(hub_rng.random(k["_tgt"].shape[0]) < MESH_HUB_SHARE,
                       0, k["_tgt"])
    hub_rels = {"KNOWS": dict(k, _tgt=hub_tgt)}
    hsess, hgraph = mesh_session(graph_rels=hub_rels, use_csr=False,
                                 join_hot_factor=MESH_HOT_FACTOR)
    rows, m3, _ = mesh_numbers(torch, hsess, hgraph, QUERY_HUB, age, card)
    hub_want = hub_oracle(np, nodes, hub_rels, AGE)
    expect("M3", rows == hub_want, f"{rows[:3]} != {hub_want[:3]}", "mesh")
    expect("M3", m3["salted_joins"] > 0, m3, "mesh")
    m3["hub_edges"] = int((hub_tgt == 0).sum())
    out["M3"] = m3
    del hsess, hgraph

    # -- M4: the ring schedules ------------------------------------------
    rsess, rgraph = mesh_session(use_cost_model=False)
    heur = slice_info.get("heuristic")
    rows, m4c, _ = mesh_numbers(torch, rsess, rgraph, QUERY_COUNT, age, card)
    hop2 = hop_counts(np, nodes, rels,
                      (nodes["Person"]["age"] == AGE).astype(np.int64))[1]
    expect("M4", rows == [{"c": int(round(hop2.sum()))}], rows, "mesh")
    expect("M4", m4c["strategies"].get("CountPattern") == "ring",
           m4c["strategies"], "mesh")
    p3 = {"age": AGE, "city": CITY}
    rows, m4v, _ = mesh_numbers(torch, rsess, rgraph, QUERY_VARLEN3_CITY, p3,
                                card)
    expect("M4", m4v["strategies"].get("VarExpand") == "ring-matrix",
           m4v["strategies"], "mesh")
    if heur is not None:
        want3 = heur[1].cypher(QUERY_VARLEN3_CITY, p3).records.to_maps()
        want_c = heur[1].cypher(QUERY_COUNT, age).records.to_maps()
        expect("M4", rows == want3, "ring-matrix rows differ", "mesh")
        expect("M4", want_c == [{"c": int(round(hop2.sum()))}], want_c,
               "mesh")
    out["M4"] = {"count": m4c, "varlen3": m4v}
    del rsess, rgraph

    # -- M5: the sharded query steps over the 10M edges -----------------
    mesh = make_mesh(MESH_SHARDS, device=msess.device)
    dev = mesh.lead
    ages_d = torch.from_numpy(nodes["Person"]["age"].astype(np.int32)).to(dev)
    src = torch.from_numpy(k["_src"].astype(np.int32)).to(dev)
    dst = torch.from_numpy(k["_tgt"].astype(np.int32)).to(dev)
    okd = torch.ones(src.shape[0], dtype=torch.bool, device=dev)
    step = make_sharded_two_hop(mesh, len(nodes["Person"]["_id"]))
    t0 = time.perf_counter()
    total, _cnt2 = step(ages_d, src, dst, okd, AGE)
    total = int(total)
    two_hop_s = time.perf_counter() - t0
    seeds = nodes["Person"]["age"][k["_src"]] == AGE
    cnt1 = np.bincount(k["_tgt"][seeds], minlength=len(nodes["Person"]["_id"]))
    expect("M5", total == int(cnt1[k["_src"]].sum()), total, "mesh")
    t0 = time.perf_counter()
    smoke = int(make_collectives_smoke(mesh)(src))
    smoke_s = time.perf_counter() - t0
    blocks = k["_src"].reshape(MESH_SHARDS, -1)
    want_smoke = 2 * int(k["_src"].sum()) \
        + MESH_SHARDS * int(blocks[:, :4].sum())
    expect("M5", smoke == want_smoke, (smoke, want_smoke), "mesh")
    out["M5"] = {"two_hop_paths": total, "two_hop_s": two_hop_s,
                 "collectives_smoke": smoke, "smoke_s": smoke_s}

    # -- M6: a re-shard --------------------------------------------------
    msess.catalog.store("mesh", mgraph)
    slots = list(msess.backend.mesh.slots)
    t0 = time.perf_counter()
    n_after = msess.shrink_and_reshard(healthy=slots[:MESH_SHARDS - 1])
    reshard_s = time.perf_counter() - t0
    rows, m6, _ = mesh_numbers(torch, msess, mgraph, QUERY_GROUPED, age,
                               card)
    expect("M6", rows == want, "rows after the re-shard differ", "mesh")
    expect("M6", m6["cold_run"]["mode"] == "record", m6["cold_run"], "mesh")
    m6.update({"healthy": MESH_SHARDS - 1, "shards_after": n_after,
               "reshard_s": reshard_s})
    out["M6"] = m6
    del msess, mgraph, psess, pgraph
    out["M7"] = run_shard_group(torch, np, nodes, rels, card)
    out["seconds"] = time.perf_counter() - t_phase
    emit(out)
    # the phase's sessions hold several copies of the graph: hand their
    # memory back before the fleet's backend processes start
    import gc
    gc.collect()
    torch.cuda.empty_cache()
    return ({"mesh_replay": m1["replay_launches"]},
            {"mesh_m1": {r.name: r.calls for r in per_query}})


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
    At the small scale every read with 2 parameter draws on the card
    equals the port's CPU session on the same graph; at the large scale
    each read runs cold, then 5 exact replays (each equal to an eager
    run), 2 generic draws (each equal to its eager run) and one more
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
    heuristic = []   # (session, graph) with use_cost_model=False, if needed
    for name, (query, make) in reads.items():
        rng = np.random.RandomState(11)
        draws = [make(d, rng) for _ in range(1 + LDBC_DRAWS)]
        recorders = query_recorders() if name == "IC12" else []
        plan = plan_check(session, graph, query, draws[0])
        rows, info, _ = pattern_runs(torch, session, graph, query, draws[0],
                                     card, recorders=recorders)
        info["plan"] = plan
        if not plan["same_as_heuristic"]:
            # the cost model planned otherwise: the heuristic plan's
            # numbers beside it, on a session of its own
            if not heuristic:
                from caps_tpu_torch.okapi.config import EngineConfig
                hs = caps_tpu_torch.local_session(
                    config=EngineConfig(use_cost_model=False))
                heuristic.append((hs, ldbc.build_graph(hs, large,
                                                       LDBC_SEED)[0]))
            hs, hg = heuristic[0]
            hrows, info["heuristic"], _ = pattern_runs(
                torch, hs, hg, query, draws[0], card)
            expect(name, ldbc_rows_agree(query, rows, hrows),
                   f"default {rows} != heuristic {hrows}", "ldbc")
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


# -- phase graph500: BASELINE config 4 --------------------------------------

GRAPH500_SCALE = 18          # BASELINE.md's scale 22, cut (PERF.md §4)
GRAPH500_EDGEFACTOR = 16
GRAPH500_SEED = 1
GRAPH500_WARM = 3
GRAPH500_CHUNK = 1 << 16     # rows of the oracle's product at a time


def triangle_oracle(np, lo, hi, n: int, chunk: int = GRAPH500_CHUNK) -> int:
    """Triangles of the undirected simple graph with edges (lo, hi): each
    edge oriented from the endpoint of lower (degree, id) rank to the
    higher, L the n x n adjacency of that orientation, and the count the
    sum over row chunks R of ``(L[R] @ L).multiply(L[R])`` (a path
    x -> y -> z closed by x -> z, each triangle once).  scipy is imported
    here only: the package never uses it."""
    import scipy.sparse as sp
    lo = np.asarray(lo, np.int64)
    hi = np.asarray(hi, np.int64)
    if lo.shape[0] == 0:
        return 0
    deg = np.bincount(lo, minlength=n) + np.bincount(hi, minlength=n)
    rank = np.empty(n, np.int64)
    rank[np.lexsort((np.arange(n), deg))] = np.arange(n)
    a, b = rank[lo], rank[hi]
    u, v = np.minimum(a, b), np.maximum(a, b)
    L = sp.csr_matrix((np.ones(u.shape[0], np.int64), (u, v)), shape=(n, n))
    total = 0
    for s in range(0, n, chunk):
        rows = L[s:s + chunk]
        total += int((rows @ L).multiply(rows).sum())
    return total


def run_graph500(torch, np, args, card: str) -> None:
    """BASELINE config 4 on the card: ``rmat_edges(18, 16, seed=1)``
    canonicalized by ``triangle_graph`` (3,806,326 edges over 2^18
    vertices) on the default session, ``TRIANGLE_QUERY`` cold and 3
    exact replays, each equal to a host oracle (:func:`triangle_oracle`
    in a child process that draws the same edge list, run while this
    process builds the graph and the card works); the plan's strategy,
    build seconds (the RMAT draw included), peak bytes, size reads,
    edges joined per second (3 |E| / median, as ``bench.py``'s triangle
    mode reckons it), and the device time, idle share and launches of
    one replay under the profiler.  The path launches none of the
    hand-written kernels: it is measured as a path."""
    import caps_tpu_torch
    from caps_tpu_torch import ops
    from caps_tpu_torch.datasets import graph500 as g500
    out = {"phase": "graph500", "card": card, "scale": GRAPH500_SCALE,
           "edgefactor": GRAPH500_EDGEFACTOR, "seed": GRAPH500_SEED,
           "cut": f"BASELINE.md scale 22 -> {GRAPH500_SCALE}"}
    t_phase = time.perf_counter()
    # the oracle in a child process, from the edge list it draws itself,
    # while this process builds the graph and the card counts
    child = subprocess.Popen(
        [sys.executable, "-c",
         "import sys, time, json; sys.path.insert(0, sys.argv[1]); "
         "import numpy as np, chip_smoke; "
         "from caps_tpu_torch.datasets import graph500 as g; "
         "t = time.perf_counter(); "
         "s, ef, seed = (int(a) for a in sys.argv[2:5]); "
         "lo, hi = g.canonical_edges(s, ef, seed); "
         "c = chip_smoke.triangle_oracle(np, lo, hi, 1 << s); "
         "print(json.dumps([c, int(lo.shape[0]), int(lo.sum()), "
         "int(hi.sum()), time.perf_counter() - t]))",
         ROOT, str(GRAPH500_SCALE), str(GRAPH500_EDGEFACTOR),
         str(GRAPH500_SEED)], stdout=subprocess.PIPE, text=True)
    try:
        session = caps_tpu_torch.local_session()
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        graph, lo, hi = g500.triangle_graph(
            session, GRAPH500_SCALE, GRAPH500_EDGEFACTOR, GRAPH500_SEED)
        torch.cuda.synchronize()
        out["build_s"] = time.perf_counter() - t0
        n = 1 << GRAPH500_SCALE
        deg = np.bincount(lo, minlength=n) + np.bincount(hi, minlength=n)
        out.update(vertices=n, edges=int(lo.shape[0]),
                   max_degree=int(deg.max()))
        ops.reset_launches()
        rows, result, cold_s = timed_query(torch, graph, g500.TRIANGLE_QUERY,
                                           {})
        cold = run_info(session, result)
        strategies = [[m["op"], m.get("strategy")]
                      for m in result.metrics["operators"]]
        warm, warm_runs = [], []
        for _ in range(GRAPH500_WARM):
            r, res, t = timed_query(torch, graph, g500.TRIANGLE_QUERY, {})
            expect("replay", r == rows, f"{r} != the cold run's {rows}",
                   "graph500")
            warm.append(t)
            warm_runs.append(run_info(session, res))
        launches = ops.launches()
        profile = device_profile(torch, lambda: graph.cypher(
            g500.TRIANGLE_QUERY).records.to_maps())
        peak = torch.cuda.max_memory_allocated()
        stdout, _ = child.communicate(timeout=900)
    finally:
        if child.poll() is None:
            child.kill()
            child.wait()
    if child.returncode != 0:
        raise RuntimeError(f"graph500: the oracle's process exited "
                           f"{child.returncode}")
    want, n_edges, lo_sum, hi_sum, oracle_s = json.loads(
        stdout.strip().splitlines()[-1])
    expect("edges", [n_edges, lo_sum, hi_sum] == [
        int(lo.shape[0]), int(lo.sum()), int(hi.sum())],
           "the oracle's edge list is not the graph's", "graph500")
    expect("count", rows == [{"triangles": want}],
           f"{rows} != oracle {want}", "graph500")
    expect("strategy", ["CountCycle", "cycle-probe"] in strategies,
           f"not planned to the cycle probe: {strategies}", "graph500")
    expect("launches", not any(launches.get(k, 0) for k in KERNELS),
           f"the triangle count launched a hand-written kernel: {launches}",
           "graph500")
    med = statistics.median(warm)
    out.update(triangles=want, strategies=strategies, cold_s=cold_s,
               cold_run=cold, warm_s=med, warm_runs_s=warm,
               warm_runs=warm_runs,
               size_syncs=[r["size_syncs"] for r in warm_runs],
               edges_joined_per_s=3 * int(lo.shape[0]) / med,
               kernel_launches=launches, profile_replay=profile,
               peak_mem_bytes=peak, oracle_s=oracle_s,
               phase_s=time.perf_counter() - t_phase, oracle="equal")
    del graph, session
    torch.cuda.empty_cache()
    emit(out)


# -- phase acceptance: the reference's behaviour suites on the card -----------

def acceptance_rows_agree(query: str, got, want) -> bool:
    """Equal as multisets (in order under ORDER BY), floats within 4
    ulp."""
    from caps_tpu_torch.testing.bag import Bag
    if "ORDER BY" in query:
        if got == want:
            return True
    elif Bag(got) == want:
        return True

    def key(row):
        return repr(sorted((k, round(v, 9) if isinstance(v, float) else v)
                           for k, v in row.items()))
    if "ORDER BY" not in query:
        got, want = sorted(got, key=key), sorted(want, key=key)
    return rows_equal(got, want, 4)


class _GraphPair:
    """One CREATE text built on the card's session and on the port's
    local backend."""

    def __init__(self, cuda, local):
        self.cuda, self.local = cuda, local


def run_acceptance(torch, np, args, card: str) -> None:
    """The 117 behaviour tests of ``tests/acceptance`` (loaded with
    ``caps_tpu`` rewritten to ``caps_tpu_torch``, as the CPU tests load
    them) against a session on the card: every ``init_graph`` builds
    its graph on the card and on the port's pure-Python oracle
    (``local_session(backend="local")``), and every ``run`` must give
    the oracle's rows; a test on the strict list
    (``caps_tpu_torch/tck/blacklists/acceptance_cuda.txt``) must raise
    the cause it names.  Counts by suite."""
    import caps_tpu_torch
    from caps_tpu_torch.testing import suites
    from caps_tpu_torch.testing.bag import Bag
    from caps_tpu_torch.testing.factory import create_graph
    t0 = time.perf_counter()
    gaps = suites.load_acceptance_gaps()
    cuda = caps_tpu_torch.local_session()
    local = caps_tpu_torch.local_session(backend="local")
    compared = {"queries": 0}

    def init_graph(create_query: str, **params):
        return _GraphPair(create_graph(cuda, create_query, params),
                          create_graph(local, create_query, params))

    def run(pair, query, **params):
        rows = pair.cuda.cypher(query, params).records.to_maps()
        want = pair.local.cypher(query, params).records.to_maps()
        if not acceptance_rows_agree(query, rows, want):
            raise AssertionError(f"{query!r}: the card's rows {rows} != "
                                 f"the local backend's {want}")
        compared["queries"] += 1
        return rows

    fixtures = {"session": cuda, "init_graph": init_graph, "run": run,
                "bag": Bag}
    counts, failures = {}, []
    for suite, name, fn in suites.suite_tests():
        c = counts.setdefault(suite, {"tests": 0, "passed": 0,
                                      "raised_as_listed": 0})
        c["tests"] += 1
        key = f"{suite}::{name}"
        kwargs = suites.fn_kwargs(fn, fixtures)
        try:
            if key in gaps:
                suites.call_listed(fn, kwargs, gaps[key])
                c["raised_as_listed"] += 1
            else:
                fn(**kwargs)
                c["passed"] += 1
        except (KeyboardInterrupt, SystemExit):
            raise
        except BaseException as ex:   # pytest.raises' Failed included
            failures.append(f"{key}: {type(ex).__name__}: {ex}")
    if failures:
        raise RuntimeError(f"acceptance: {len(failures)} tests failed on "
                           f"the card:\n" + "\n".join(failures[:20]))
    total = {k: sum(c[k] for c in counts.values())
             for k in ("tests", "passed", "raised_as_listed")}
    expect("counts", total["tests"] == 117 and total["raised_as_listed"]
           == len(gaps), f"{total} with {len(gaps)} listed", "acceptance")
    emit({"phase": "acceptance", "card": card, "by_suite": counts, **total,
          "listed": len(gaps), "queries_compared": compared["queries"],
          "phase_s": time.perf_counter() - t0})


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
    call_ms = time_calls(torch, X.expand_positions_cuda, calls)
    # the earlier design's prelude (torch cumsum to int32 and the lo
    # cast), which the scan passes replace
    prelude_ms = time_ms(torch, lambda: (
        torch.cumsum(counts, 0, dtype=torch.int32), lo.to(torch.int32)))
    # device ms by kernel (scan passes against the expand pass), for
    # each call of the replay
    split = [kernel_split_ms(torch, lambda a=a: X.expand_positions_cuda(*a))
             for a in calls]
    return {"max_abs_err": err, "ms_per_query": sum(call_ms),
            "call_ms": call_ms, **expand_timings(torch, main_args),
            "prelude_torch_ms": prelude_ms, "device_ms_by_kernel": split,
            "cases": len(cases),
            "call_shapes": [[a[0].shape[0], a[2]] for a in calls],
            "library_call": "torch.searchsorted"}


def expand_timings(torch, args) -> dict:
    """K2 at one call's arguments: its time, the plain version's, the
    library call's (``torch.searchsorted`` of each slot in the running
    counts) and the bound (counts and lo read once, three outputs
    written once)."""
    from caps_tpu_torch.ops import expand as X
    counts, lo, out_cap = args
    offsets = torch.cumsum(counts, 0)
    t = torch.arange(out_cap, device=counts.device)
    cap_l = counts.shape[0]
    b, by = bound(cap_l * (counts.element_size() + lo.element_size())
                  + out_cap * 9, out_cap + cap_l)
    return {"ms": time_ms(torch, lambda: X.expand_positions_cuda(*args)),
            "plain_ms": time_ms(torch,
                                lambda: X.expand_positions_plain(*args)),
            "library_ms": time_ms(torch, lambda: torch.searchsorted(
                offsets, t, right=True)),
            "bound_ms": b, "bound_by": by,
            "shape": {"cap_l": cap_l, "out_cap": out_cap,
                      "total": int(offsets[-1]) if cap_l else 0}}


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


def gaps_oracles(np, nodes, rels, age: int) -> dict:
    """numpy answers of the gaps queries, from the 2-hop path counts to
    each person (``hop_counts``); G2 propagates each 6-letter city
    prefix's seeds on their own."""
    person = nodes["Person"]
    ages, cities = person["age"], person["city"]
    names, codes = city_codes(np, nodes)
    seeds = (ages == age).astype(np.int64)
    _h1, hop2 = hop_counts(np, nodes, rels, seeds)
    w = np.rint(hop2).astype(np.int64)
    live = w > 0
    out = {}
    # G1: the substring's groups, top 20 by count then string
    cut = ages % 2
    per = {}
    for start in (0, 1):
        sel = live & (cut == start)
        counts = np.bincount(codes[sel], weights=w[sel],
                             minlength=len(names))
        for name, n in zip(names, counts):
            if n:
                sub = str(name)[start:]
                per[sub] = per.get(sub, 0) + int(round(n))
    out["G1_substring"] = [{"s": k, "n": v} for k, v in sorted(
        per.items(), key=lambda kv: (-kv[1], kv[0]))[:20]]
    # G2: paths whose end's city starts with the first six letters of
    # the seed's city
    prefix = np.array([str(c)[:6] for c in names])
    groups, group_of = np.unique(prefix, return_inverse=True)
    total = 0
    for g in range(len(groups)):
        in_g = group_of[codes] == g
        _h, h2 = hop_counts(np, nodes, rels, seeds * in_g)
        total += int(round(h2[in_g].sum()))
    out["G2_starts_with"] = [{"n": total}]
    # G3: x in range(0, age % 8) for each path
    top = ages % 8
    out["G3_range"] = [{"x": x, "n": int(w[live & (top >= x)].sum())}
                       for x in range(8) if w[live & (top >= x)].sum()]
    # G4: per city (first 20 present) the multiset of ages
    present = np.bincount(codes[live], minlength=len(names)) > 0
    first = [i for i in range(len(names)) if present[i]][:20]
    g4 = []
    for i in first:
        sel = live & (codes == i)
        g4.append({"city": str(names[i]), "m": sorted(
            int(a) for a, n in zip(ages[sel], w[sel]) for _ in range(n))})
    out["G4_collect_maps"] = g4
    # G5: per age the nearest-rank median city
    g5 = []
    for a in range(18, 90):
        sel = live & (ages == a)
        if not sel.any():
            continue
        counts = np.bincount(codes[sel], weights=w[sel],
                             minlength=len(names)).astype(np.int64)
        n = int(counts.sum())
        rank = max(1, -(-n // 2))
        at = int(np.searchsorted(np.cumsum(counts), rank))
        g5.append({"age": a, "p": str(names[at])})
    out["G5_percentile_strings"] = g5
    # G6 / G7: a map or a mixed value per person, counted
    old = ages > 50
    g6, g7 = {}, {}
    city_n = np.bincount(codes[live & old], weights=w[live & old],
                         minlength=len(names))
    age_n = np.bincount(ages[live & ~old], weights=w[live & ~old],
                        minlength=90)
    for i in np.flatnonzero(city_n):
        g6[("city", str(names[i]))] = int(round(city_n[i]))
        g7[str(names[i]) + "1"] = int(round(city_n[i]))
    for a in np.flatnonzero(age_n):
        g6[("age", int(a))] = int(round(age_n[a]))
        g7[int(a) + 1] = int(round(age_n[a]))
    out["G6_case_maps"] = sorted(g6.items(), key=repr)
    out["G7_mixed_arith"] = sorted(g7.items(), key=repr)
    # G8: per city (first 20 present) the count and the days over 80
    g8 = []
    for i in first:
        sel = live & (codes == i)
        days = [int(a) for a, n in zip(ages[sel], w[sel]) for _ in range(n)]
        g8.append({"city": str(names[i]), "n": len(days),
                   "old": sorted(d for d in days if d > 80)})
    out["G8_duration_lists"] = g8
    return out


def gaps_norm(label: str, rows):
    """A gaps query's rows in its oracle's form: collected lists as
    sorted values, maps and mixed values as sortable keys."""
    if label == "G4_collect_maps":
        return [{"city": r["city"], "m": sorted(x["age"] for x in r["m"])}
                for r in rows]
    if label == "G6_case_maps":
        return sorted(((("city", r["m"]["k"]) if "old" not in r["m"]
                        else ("age", r["m"]["k"]), r["n"]) for r in rows),
                      key=repr)
    if label == "G7_mixed_arith":
        return sorted(((r["v"], r["n"]) for r in rows), key=repr)
    if label == "G8_duration_lists":
        return [{"city": r["city"], "n": r["n"],
                 "old": sorted(d.days for d in r["old"])} for r in rows]
    return rows


def run_queries(torch, session, graph, phase: str, queries, want, norm,
                min_launches, held_reads, out, card):
    """Each query of a phase (``queries``: label -> text, over ``$age``)
    cold and 5 exact replays against its oracle (``want[label]``, the
    rows in ``norm(label, rows)``'s form); per query the size reads of
    one more exact replay (0) and, where ``held_reads`` is given, its
    held-value reads (``held_reads.get(label, 0)``), the kernel calls and
    launches of the last exact replay (held to ``min_launches``), peak
    allocated bytes and one exact replay under the profiler, written to
    ``out``; the phase must launch K1, K2 and K3 where ``min_launches``
    is set.  Returns ({phase: launches by label}, {phase_label: calls})."""
    launches, calls, phase_launches = {}, {}, {}
    for label, query in queries.items():
        recorders = query_recorders()
        params = {"age": AGE}
        rows, info, result = pattern_runs(torch, session, graph, query,
                                          params, card, recorders=recorders)
        got = norm(label, rows)
        expect(label, got == want[label],
               f"disagrees with numpy ({len(got)} rows, "
               f"{len(want[label])} expected):\ngot  {list(got)[:3]}\n"
               f"want {list(want[label])[:3]}", phase)
        replay = graph.cypher(query, params)
        expect(label, norm(label, replay.records.to_maps()) == want[label],
               "the counted replay disagrees with numpy", phase)
        expect(label, session.fused.last_mode == "replay",
               f"the counted run was a {session.fused.last_mode}", phase)
        info["replay_size_syncs"] = replay.metrics["size_syncs"]
        expect(label, replay.metrics["size_syncs"] == 0,
               f"an exact replay read {replay.metrics['size_syncs']} sizes",
               phase)
        if held_reads is not None:
            info["replay_held_reads"] = replay.metrics["held_reads"]
            expect(label, replay.metrics["held_reads"]
                   == held_reads.get(label, 0),
                   f"an exact replay read held values "
                   f"{replay.metrics['held_reads']} times", phase)
        check_query_launches(f"the {phase} query {label}'s replay",
                             info["replay_launches"],
                             min_launches.get(label, {}))
        info.update({
            "rows": len(rows),
            "k_launches": {k: info["replay_launches"].get(k, 0)
                           for k in ("segment_agg", "expand_positions",
                                     "bitonic_sort")},
            "profile_exact_replay": device_profile(
                torch, lambda: graph.cypher(query,
                                            params).records.to_maps()),
            "operators": [[m["op"], m["seconds"], m["rows"]]
                          for m in result.metrics["operators"]]})
        launches[label] = info["replay_launches"]
        for k, n in info["replay_launches"].items():
            phase_launches[k] = phase_launches.get(k, 0) + n
        calls[label] = {r.name: r.calls for r in recorders}
        out[label] = info
    expect("phase", not min_launches or all(
        phase_launches.get(k, 0) for k in ("segment_agg", "expand_positions",
                                           "bitonic_sort")),
           f"K1, K2 or K3 never launched: {phase_launches}", phase)
    out["phase_launches"] = phase_launches
    return ({phase: launches},
            {f"{phase}_{k}": v for k, v in calls.items()})


def run_gaps(torch, np, args, card: str, state):
    """Expressions and aggregations the JAX package answers on its host
    fallback, on the slice's graph in a session of its own: each query
    over the 2-hop rows from the seeds of ``$age``, its cold run and 5
    exact replays against its numpy oracle; per query the size reads
    and held-value reads of one more exact replay (0 size reads), the
    kernel calls and launches of the last exact replay (held to
    ``MIN_GAPS_LAUNCHES``), peak allocated bytes and one exact replay
    under the profiler."""
    import caps_tpu_torch
    from caps_tpu_torch.interop import graph_from_numpy
    _session, _graph, nodes, rels, _ = state
    t0 = time.perf_counter()
    # a session of its own: the strings the queries build stay in its
    # pool, off the later phases' dense group-bys
    session = caps_tpu_torch.local_session()
    graph = graph_from_numpy(session, nodes, rels)
    torch.cuda.synchronize()
    ingest_s = time.perf_counter() - t0
    t1 = time.perf_counter()
    want = gaps_oracles(np, nodes, rels, AGE)
    out = {"phase": "gaps", "card": card, "age": AGE, "ingest_s": ingest_s,
           "oracle_s": time.perf_counter() - t1}
    found = run_queries(torch, session, graph, "gaps", QUERY_GAPS, want,
                        gaps_norm, MIN_GAPS_LAUNCHES, GAPS_HELD_READS, out,
                        card)
    out["pool_strings"] = len(session.backend.pool)
    del graph, session
    out["phase_s"] = time.perf_counter() - t0
    emit(out)
    return found


def nested_visits(np, n: int, seed: int):
    """The seeded ``visits`` property of ``n`` persons: (its flat numpy
    arrays, the Python lists ``from_columns`` takes).  Each person has
    0-``NESTED_MAX_INNER`` inner lists of 0-``NESTED_MAX_VALUES`` int64
    values (null at ``NESTED_NULLS``: the row, an inner list, a
    value)."""
    rng = np.random.default_rng(seed + 18)
    row_null = rng.random(n) < NESTED_NULLS[0]
    n_inner = np.where(row_null, 0,
                       rng.integers(0, NESTED_MAX_INNER + 1, n))
    n_lists = int(n_inner.sum())
    inner_null = rng.random(n_lists) < NESTED_NULLS[1]
    inner_len = np.where(inner_null, 0, rng.integers(
        0, NESTED_MAX_VALUES + 1, n_lists))
    n_values = int(inner_len.sum())
    value = rng.integers(0, 1000, n_values, dtype=np.int64)
    value_null = rng.random(n_values) < NESTED_NULLS[2]
    flat = value.tolist()
    for i in np.flatnonzero(value_null).tolist():
        flat[i] = None
    ends = np.cumsum(inner_len)
    inner = [flat[a:b] for a, b in zip((ends - inner_len).tolist(),
                                       ends.tolist())]
    for i in np.flatnonzero(inner_null).tolist():
        inner[i] = None
    row_end = np.cumsum(n_inner)
    rows = [inner[a:b] for a, b in zip((row_end - n_inner).tolist(),
                                       row_end.tolist())]
    for i in np.flatnonzero(row_null).tolist():
        rows[i] = None
    arrays = {"row_null": row_null, "n_inner": n_inner,
              "inner_null": inner_null, "inner_len": inner_len,
              "value": value, "value_null": value_null,
              # each inner list's person, each value's inner list
              "inner_owner": np.repeat(np.arange(n), n_inner),
              "value_owner": np.repeat(np.arange(n_lists), inner_len)}
    return arrays, rows


def nested_key(v):
    """A nested list value as a hashable key (None stays None)."""
    return None if v is None else tuple(
        None if x is None else tuple(x) for x in v)


def nested_order(v):
    """openCypher's ascending order of a list of lists of ints: a prefix
    first, a null (element or list) after every value."""
    if v is None:
        return (2,)
    if isinstance(v, tuple):
        return (1, tuple(nested_order(x) for x in v))
    return (0, v)


def nested_oracles(np, nodes, rels, vis, visits, age: int) -> dict:
    """numpy answers of the nested queries from the seeded arrays (N2's
    ``first``: the set of ages of the paths' middle nodes per city,
    which the query's row order picks one of)."""
    person = nodes["Person"]
    ages = person["age"]
    names, codes = city_codes(np, nodes)
    k = rels["KNOWS"]
    src, tgt = k["_src"], k["_tgt"]
    n = len(ages)
    seeds = (ages == age).astype(np.int64)
    out = {}
    # N1: the seeds' non-null values, counted and their largest by city
    vperson = vis["inner_owner"][vis["value_owner"]]
    rows_at = seeds[vperson] > 0
    got = rows_at & ~vis["value_null"]
    cnt = np.bincount(codes[vperson[got]], minlength=len(names))
    hi = np.full(len(names), -1, dtype=np.int64)
    np.maximum.at(hi, codes[vperson[got]], vis["value"][got])
    present = np.bincount(codes[vperson[rows_at]], minlength=len(names)) > 0
    n1 = [{"city": str(names[i]), "n": int(cnt[i]),
           "hi": int(hi[i]) if cnt[i] else None}
          for i in np.flatnonzero(present)]
    out["N1_unwind_twice"] = sorted(n1, key=lambda r: (-r["n"],
                                                       r["city"]))[:20]
    # N2: 2-hop paths into each city, those whose middle node has $age,
    # and the middle nodes' ages (a path may not use a loop twice)
    mid = (ages == age).astype(np.float64)
    hop1 = np.bincount(tgt, weights=seeds[src], minlength=n)
    loops = src == tgt
    w = hop1[src] - loops * seeds[src]
    per = np.bincount(codes[tgt], weights=w, minlength=len(names))
    per_k = np.bincount(codes[tgt], weights=w * mid[src],
                        minlength=len(names))
    firsts = {}
    live = w > 0
    # (city, age) pairs as one int64 each: ages are under 1,024
    pairs = np.unique(codes[tgt[live]].astype(np.int64) * 1024
                      + ages[src[live]])
    for c, a in zip((pairs // 1024).tolist(), (pairs % 1024).tolist()):
        firsts.setdefault(c, set()).add(a)
    out["N2_collect_three_levels"] = [
        {"city": str(names[i]), "n": int(round(per[i])),
         "k": int(round(per_k[i])), "first": firsts[i]}
        for i in np.flatnonzero(per > 0)[:20]]
    # N3: the 1-hop rows' visits, grouped
    groups = {}
    for b, m in zip(np.flatnonzero(hop1).tolist(),
                    hop1[hop1 > 0].astype(np.int64).tolist()):
        key = nested_key(visits[b])
        groups[key] = groups.get(key, 0) + m
    out["N3_group_by_nested"] = sorted(
        groups.items(), key=lambda kv: (-kv[1], nested_order(kv[0])))[:20]
    # N4: per seed its inner lists longer than 2, and the first one's
    # non-null values
    inner_p = vis["inner_owner"]
    long_ = (vis["inner_len"] > 2) & ~vis["inner_null"] & (seeds[inner_p] > 0)
    nonnull = np.bincount(vis["value_owner"][~vis["value_null"]],
                          minlength=len(inner_p))
    _who, first_long = np.unique(inner_p[long_], return_index=True)
    first_at = np.flatnonzero(long_)[first_long]
    out["N4_comprehensions"] = [{
        "c": int(seeds.sum()), "s": int(long_.sum()),
        "s0": int(nonnull[first_at].sum()),
        "k": int((nonnull[first_at] > 0).sum())}]
    # N5: the hop's pairs whose first inner lists are equal: both there,
    # equally long, no null value in either, the same values
    start = np.cumsum(vis["n_inner"]) - vis["n_inner"]
    has = vis["n_inner"] > 0
    first = np.where(has, start, 0)
    inner_ok = ~vis["inner_null"].copy()
    bad = np.bincount(vis["value_owner"][vis["value_null"]],
                      minlength=len(inner_p)) > 0
    inner_ok &= ~bad
    # one int64 code per inner list: its length, then its values in base
    # 1000 (values are under 1000, lists at most 6 long)
    pos = np.arange(len(vis["value"])) - np.repeat(
        np.cumsum(vis["inner_len"]) - vis["inner_len"], vis["inner_len"])
    code = vis["inner_len"].astype(np.int64).copy()
    np.add.at(code, vis["value_owner"],
              7 * vis["value"] * (1000 ** pos.astype(np.int64)))
    pcode = np.where(has & inner_ok[first], code[first], -1)
    pair = (seeds[src] > 0) & (pcode[src] >= 0) & (pcode[src] == pcode[tgt])
    out["N5_equal_inner_lists"] = [{"n": int(pair.sum())}]
    return out


def nested_norm(label: str, rows, want):
    """A nested query's rows in its oracle's form (N2's ``first`` kept
    as the oracle's set where it is one of its members)."""
    if label == "N2_collect_three_levels":
        return [dict(r, first=w["first"] if r["first"] in w["first"]
                     else r["first"]) for r, w in zip(rows, want)]
    if label == "N3_group_by_nested":
        return [(nested_key(r["v"]), r["n"]) for r in rows]
    return rows


def run_nested(torch, np, args, card: str, state):
    """Nested list columns on the card: the slice's graph in a session of
    its own with a seeded list-of-lists property ``visits`` on every
    person, ingested through ``from_columns``; each query (``QUERY_NESTED``)
    cold and 5 exact replays against its numpy oracle; per query the size
    reads of one more exact replay (0), the kernel calls and launches of
    the last exact replay (held to ``MIN_NESTED_LAUNCHES``), peak
    allocated bytes and one exact replay under the profiler."""
    import caps_tpu_torch
    from caps_tpu_torch.okapi.types import CTInteger, CTList, CTString
    from caps_tpu_torch.relational.entity_tables import (
        NodeMapping, NodeTable, RelationshipMapping, RelationshipTable,
    )
    _session, _graph, nodes, rels, _ = state
    t0 = time.perf_counter()
    person = nodes["Person"]
    vis, visits = nested_visits(np, len(person["_id"]), args.seed)
    arrays_s = time.perf_counter() - t0
    session = caps_tpu_torch.local_session()
    f = session.table_factory
    t1 = time.perf_counter()
    people = f.from_columns(
        {"_id": person["_id"], "age": person["age"], "city": person["city"],
         "visits": visits},
        {"_id": CTInteger, "age": CTInteger, "city": CTString,
         "visits": CTList(CTList(CTInteger))})
    torch.cuda.synchronize()
    ingest_s = time.perf_counter() - t1
    col = people._cols["visits"]
    visits_bytes = sum(t.nbytes for c in (col, col.child)
                       for t in (c.data, c.valid, c.lens, c.elem_valid)
                       if t is not None)
    knows = f.from_columns(rels["KNOWS"], {c: CTInteger
                                           for c in rels["KNOWS"]})
    mapping = NodeMapping.on("_id").with_implied_labels("Person")
    for key in ("age", "city", "visits"):
        mapping = mapping.with_property(key)
    graph = session.create_graph(
        [NodeTable(mapping, people)],
        [RelationshipTable(RelationshipMapping.on("KNOWS"), knows)])
    torch.cuda.synchronize()
    graph_s = time.perf_counter() - t1
    t2 = time.perf_counter()
    want = nested_oracles(np, nodes, rels, vis, visits, AGE)
    out = {"phase": "nested", "card": card, "age": AGE,
           "arrays_s": arrays_s, "ingest_s": ingest_s, "graph_s": graph_s,
           "oracle_s": time.perf_counter() - t2,
           "visits": {"rows": len(visits),
                      "inner_lists": int(vis["n_inner"].sum()),
                      "values": int(vis["inner_len"].sum()),
                      "width": int(col.data.shape[1]),
                      "inner_width": int(col.child.data.shape[1]),
                      "device_bytes": visits_bytes}}
    found = run_queries(
        torch, session, graph, "nested", QUERY_NESTED, want,
        lambda label, rows: nested_norm(label, rows, want[label]),
        MIN_NESTED_LAUNCHES, None, out, card)
    del graph, people, col, session
    out["phase_s"] = time.perf_counter() - t0
    emit(out)
    return found


def mixed_oracles(np, nodes, rels, age: int) -> dict:
    """numpy answers of the mixed queries, from the 1- and 2-hop path
    counts to each person (``hop_counts``)."""
    person = nodes["Person"]
    ages = person["age"]
    names, codes = city_codes(np, nodes)
    seeds = (ages == age).astype(np.int64)
    h1, h2 = hop_counts(np, nodes, rels, seeds)
    w1, w2 = np.rint(h1).astype(np.int64), np.rint(h2).astype(np.int64)
    live = w1 > 0
    old = ages > 50
    out = {}
    # X1: [age % 5] for the old, the city for the rest; lists order first
    per = {}
    for r in range(5):
        n = int(w1[live & old & (ages % 5 == r)].sum())
        if n:
            per[(0, r)] = n
    city_n = np.bincount(codes[live & ~old], weights=w1[live & ~old],
                         minlength=len(names))
    for i in np.flatnonzero(city_n):
        per[(1, str(names[i]))] = int(round(city_n[i]))
    top = sorted(per.items(), key=lambda kv: (-kv[1], kv[0]))[:20]
    out["X1_group_list_or_string"] = [
        {"v": [k[1]] if k[0] == 0 else k[1], "n": n} for k, n in top]
    # X2: the distinct cities, ages mod 7 and ages among the hop's ends
    n_distinct = (len(np.unique(codes[live])) + len(np.unique(
        ages[live] % 7)) + len(np.unique(ages[live])))
    out["X2_unwind_distinct"] = [{"n": n_distinct,
                                  "m": 3 * int(w1.sum())}]
    # X3: the text of {city, age % 2} per end, counted, top 20
    texts = {}
    for parity in (0, 1):
        sel = live & (ages % 2 == parity)
        counts = np.bincount(codes[sel], weights=w1[sel],
                             minlength=len(names))
        for i in np.flatnonzero(counts):
            texts[f"{{'city': '{names[i]}', 'age': {parity}}}"] = \
                int(round(counts[i]))
    out["X3_to_string_map"] = [{"s": t, "n": n} for t, n in sorted(
        texts.items(), key=lambda kv: (-kv[1], kv[0]))[:20]]
    # X4: the last map's k is the 2-hop end's age
    by_age = np.bincount(ages, weights=w2, minlength=90)
    out["X4_reduce_to_map"] = [{"k": int(a), "n": int(round(by_age[a]))}
                               for a in np.flatnonzero(by_age)]
    # X5: [b.age] per 1-hop row whose age is a multiple of 10, then the
    # seeds' cities
    bag = {}
    tenth = live & (ages % 10 == 0)
    for a, n in zip(*np.unique(np.repeat(ages[tenth], w1[tenth]),
                               return_counts=True)):
        bag[("list", int(a))] = int(n)
    for i, n in zip(*np.unique(codes[seeds > 0], return_counts=True)):
        bag[("str", str(names[i]))] = int(n)
    out["X5_union_list_string"] = bag
    # X6: [[age % 3]] for the old, [age % 3] for the rest, against [[1]]
    # and [1]
    one = ages % 3 == 1
    e, f = old & one, ~old & one
    groups = {}
    for key in ((True, False), (False, True), (False, False)):
        n = int(w1[live & (e == key[0]) & (f == key[1])].sum())
        if n:
            groups[key] = n
    out["X6_two_depths_equal"] = groups
    return out


def mixed_norm(label: str, rows):
    """A mixed query's rows in its oracle's form: the union's rows as a
    bag, the comparison's groups as a dict."""
    if label == "X5_union_list_string":
        bag = {}
        for r in rows:
            v = r["v"]
            key = ("list", v[0]) if isinstance(v, list) and len(v) == 1 \
                else ("str", v)
            bag[key] = bag.get(key, 0) + 1
        return bag
    if label == "X6_two_depths_equal":
        return {(r["e"], r["f"]): r["n"] for r in rows}
    return rows


def run_mixed(torch, np, args, card: str, state):
    """Lists and maps among values of other types on the card, on the
    slice's graph in a session of its own (the texts X3 builds stay in
    its pool): each query (``QUERY_MIXED``) cold and 5 exact replays
    against its numpy oracle; per query the size reads (0) and held-value
    reads of one more exact replay, the kernel calls and launches of the
    last exact replay (held to ``MIN_MIXED_LAUNCHES``), peak allocated
    bytes and one exact replay under the profiler."""
    import caps_tpu_torch
    from caps_tpu_torch.interop import graph_from_numpy
    _session, _graph, nodes, rels, _ = state
    t0 = time.perf_counter()
    session = caps_tpu_torch.local_session()
    graph = graph_from_numpy(session, nodes, rels)
    torch.cuda.synchronize()
    ingest_s = time.perf_counter() - t0
    t1 = time.perf_counter()
    want = mixed_oracles(np, nodes, rels, AGE)
    out = {"phase": "mixed", "card": card, "age": AGE, "ingest_s": ingest_s,
           "oracle_s": time.perf_counter() - t1}
    found = run_queries(torch, session, graph, "mixed", QUERY_MIXED, want,
                        mixed_norm, MIN_MIXED_LAUNCHES, MIXED_HELD_READS, out,
                        card)
    out["pool_strings"] = len(session.backend.pool)
    del graph, session
    out["phase_s"] = time.perf_counter() - t0
    emit(out)
    return found


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--seed", type=int, default=0)
    # --persons / --edges shrink the graph for a quick first call after a
    # kernel change; the defaults are the slice's size
    ap.add_argument("--persons", type=int, default=1_000_000)
    ap.add_argument("--edges", type=int, default=10_000_000)
    args = ap.parse_args()
    t_script = time.perf_counter()

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
    lists_launches, lists_calls = run_lists(torch, np, args, card, state)
    launches.update(lists_launches)
    pattern_calls.update(lists_calls)
    values_launches, values_calls = run_values(torch, np, args, card, state)
    launches.update(values_launches)
    pattern_calls.update(values_calls)
    gaps_launches, gaps_calls = run_gaps(torch, np, args, card, state)
    launches.update(gaps_launches)
    pattern_calls.update(gaps_calls)
    nested_launches, nested_calls = run_nested(torch, np, args, card,
                                               state)
    launches.update(nested_launches)
    pattern_calls.update(nested_calls)
    mixed_launches, mixed_calls = run_mixed(torch, np, args, card, state)
    launches.update(mixed_launches)
    pattern_calls.update(mixed_calls)
    cyclic_launches, cyclic_calls = run_cyclic(torch, np, args, card, state)
    launches.update(cyclic_launches)
    pattern_calls.update(cyclic_calls)
    run_profile(torch, np, args, card, state)
    update_launches, update_calls = run_updates(torch, np, args, card, state)
    launches.update(update_launches)
    pattern_calls.update(update_calls)
    run_construct(torch, np, args, card, state)
    fs_launches, fs_calls = run_fs(torch, np, args, card, state)
    launches.update(fs_launches)
    pattern_calls.update(fs_calls)
    run_graph500(torch, np, args, card)
    run_algo(torch, np, args, card, state)
    serve_launches, serve_calls = run_serve(torch, np, args, card, state)
    launches.update(serve_launches)
    pattern_calls.update(serve_calls)
    mesh_launches, mesh_calls = run_mesh(torch, np, args, card, state)
    launches.update(mesh_launches)
    pattern_calls.update(mesh_calls)
    del state
    launches["fleet_soak"] = run_fleet(torch, np, args, card)
    run_tck(torch, np, args, card)
    run_acceptance(torch, np, args, card)
    ldbc_launches, ldbc_calls = run_ldbc(torch, np, args, card)
    launches.update(ldbc_launches)
    pattern_calls.update(ldbc_calls)
    run_plan(torch, np, args, card)
    run_selftest(card)

    def of_patterns(wrapper):
        """Every call of ``wrapper`` in one exact replay of each
        var-expand form, of each unwind- and lists-phase query, of each
        multiway join of the cyclic phase, of the final snapshot, of the
        graph the fs phase loaded, of IC12 and of the served batch's 8
        exact replays, labelled by query."""
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
        if name == "expand_positions":
            # the kernels line takes K2's largest shape: the cyclic
            # phase's extends reach past the slice's largest call
            largest = max((a for _label, a in of_patterns(wrapper)),
                          key=lambda a: a[2])
            if largest[2] > main_args[wrapper][2]:
                checks[name] = dict(checks[name], slice_shape={
                    k: checks[name][k] for k in (
                        "ms", "plain_ms", "bound_ms", "bound_by",
                        "library_ms", "shape")},
                    **expand_timings(torch, largest))
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
            # one exact replay of the lists phase's first query (L1)
            "launches_lists_replay": launches["lists"].get(name, 0),
            # one exact replay of each values-phase query
            "launches_values_replay": {
                q: n.get(name, 0) for q, n in launches["values"].items()},
            # one exact replay of each nested-phase query (N1-N5)
            "launches_nested_replay": {
                q: n.get(name, 0) for q, n in launches["nested"].items()},
            # one exact replay of each mixed-phase query (X1-X6)
            "launches_mixed_replay": {
                q: n.get(name, 0) for q, n in launches["mixed"].items()},
            # one exact replay of the seeded triangle on the multiway join
            "launches_wcoj_triangle_replay": launches["wcoj_triangle"].get(
                name, 0),
            # one exact replay of the grouped query on the snapshot the
            # updates phase's 500 writes left
            "launches_snapshot_replay": launches["snapshot_replay"].get(
                name, 0),
            # one request of the grouped query (an exact replay) served
            # through QueryServer's worker
            "launches_served_request": launches["served_request"].get(
                name, 0),
            # one exact replay of the grouped query on the graph the fs
            # phase loaded from parquet
            "launches_fs_replay": launches["fs_replay"].get(name, 0),
            # one exact replay of the grouped query on the mesh phase's
            # 4-shard session (M1)
            "launches_mesh_replay": launches["mesh_replay"].get(name, 0),
            # the 3-backend read soak of the fleet phase, summed over the
            # backend processes (each counts its own launches)
            "launches_fleet_soak": launches["fleet_soak"].get(name, 0),
            "max_abs_err": c["max_abs_err"], "ms": c["ms"],
            # the sum over the calls of one exact replay, each timed
            "ms_per_query": c["ms_per_query"],
            "plain_ms": c["plain_ms"], "bound_ms": c["bound_ms"],
            "bound_by": c["bound_by"], "library_ms": c["library_ms"]})
    emit({"phase": "total", "seconds": time.perf_counter() - t_script})
    emit({"kernels": kernels})
    print(card, flush=True)
    emit({"ok": True, "device": {"platform": "gpu",
                                 "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
