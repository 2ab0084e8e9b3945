"""Whole runs without the card: the harness's look for a chip skipped
(``device="cpu"``, tiny sizes), the rest of a run driven, for the
benchmark's cells and the served test cells (``served/``).  A sound run
is correct; the control, and each fault planted under the timed path
that the cell can have, comes out not correct."""
import json
import os
import shutil
import subprocess
import sys
import time

import pytest

from portbench.harness import cell as C
from portbench.harness import env, spec

BENCH_CELLS = [w["name"] for w in spec.benchmark()["workloads"]]
SERVED_CELLS = [w["name"] for w in spec.load_json(os.path.join(
    os.path.dirname(__file__), "served", "bench.json"))["workloads"]]
CELLS = BENCH_CELLS + SERVED_CELLS


def load(workload, tree):
    bench, base = tree
    return spec.load_cell(workload, bench, base)


def run(workload, small, tree, seed=5, control=False, seconds=1.5):
    bench, base = tree
    return C.run(workload, seed, seconds, False, time.perf_counter(),
                 device="cpu",
                 config_override=small(load(workload, tree).config),
                 control=control, bench=bench, base=base)


@pytest.mark.parametrize("workload", CELLS)
def test_sound_run_is_correct(workload, small, tree):
    r = run(workload, small, tree)
    assert r["correct"], r["checks"]
    assert r["attempted"] >= 1 and r["failed"] == 0
    e2e = {m["name"] for m in load(workload, tree).end_to_end}
    assert set(r["metrics"]) == e2e
    assert all(v["value"] > 0 for v in r["metrics"].values())
    assert list(r)[-1] == "checks"
    assert r["program"]["window_fused"].get("fused.recordings", 0) == 0


@pytest.mark.parametrize("seed", [1, 2, 3])
@pytest.mark.parametrize("workload", CELLS)
def test_control_is_not_correct(workload, small, tree, seed):
    r = run(workload, small, tree, seed=seed, control=True)
    assert not r["correct"]
    assert r["checks"]["wrong_answers"]["value"] > 0


def _altered(rows):
    """The answer altered where it is produced: the first row's last
    whole number one higher."""
    rows = [dict(r) for r in rows]
    if rows:
        k = [k for k, v in rows[0].items() if isinstance(v, int)][-1]
        rows[0][k] += 1
    return rows


def fault_stale(inner):
    """A step that returns its state unchanged: every answer is the
    first one produced."""
    seen = {}

    def rows(self, *a, **k):
        got = inner(self, *a, **k)
        key = tuple(got[0]) if got else ()
        return seen.setdefault(key, got)
    return rows


def fault_altered(inner):
    return lambda self, *a, **k: _altered(inner(self, *a, **k))


def fault_half_left_out(inner):
    """Half of the batch left out: every second answer loses half of its
    rows."""
    calls = [0]

    def rows(self, *a, **k):
        calls[0] += 1
        got = inner(self, *a, **k)
        return got[:len(got) // 2] if calls[0] % 2 else got
    return rows


FAULTS = {"stale": fault_stale, "altered": fault_altered,
          "half_left_out": fault_half_left_out}


def served(workload):
    return workload in SERVED_CELLS


# the analytics cell has one graph and one answer: a count kept from an
# earlier run is the right one, so it has no stale fault
CASES = [(w, f) for w in CELLS for f in sorted(FAULTS)
         if served(w) or f != "stale"]


@pytest.mark.parametrize("workload,fault", CASES)
def test_fault_under_the_timed_path_is_caught(workload, fault, small, tree,
                                              monkeypatch):
    """Served cells: the fault where the server hands a client its rows
    (``QueryHandle.rows``); the analytics cell: where the count's rows
    are made (``RelationalCypherRecords.to_maps``), or, for half of the
    batch, half of the count's input edges left out."""
    from caps_tpu_torch.relational.session import RelationalCypherRecords
    from caps_tpu_torch.serve.request import QueryHandle
    if not served(workload) and fault == "half_left_out":
        import caps_tpu_torch.interop as interop
        inner = interop.graph_from_numpy

        def half(session, nodes, rels):
            rels = {t: {k: v[::2] for k, v in cols.items()}
                    for t, cols in rels.items()}
            return inner(session, nodes, rels)
        monkeypatch.setattr(interop, "graph_from_numpy", half)
    else:
        owner, name = ((QueryHandle, "rows") if served(workload)
                       else (RelationalCypherRecords, "to_maps"))
        monkeypatch.setattr(owner, name, FAULTS[fault](getattr(owner, name)))
    r = run(workload, small, tree)
    assert not r["correct"], r["checks"]


def test_forbidden_names_are_compared_whole():
    assert env.forbidden_loaded(["caps_tpu_torch", "caps_tpu_torch.ops",
                                 "numpy", "jaxtyping"]) == []
    assert env.forbidden_loaded(["caps_tpu.ops", "jax.numpy", "jaxlib",
                                 "flax.linen", "chip_smoke"]) == [
        "caps_tpu", "chip_smoke", "flax", "jax", "jaxlib"]


def test_a_run_loads_nothing_of_jax_or_the_jax_package(small, tree):
    """Whole runs of every cell on the CPU in a fresh process: nothing
    they load has a forbidden top-level name."""
    bench, base = tree
    sizes = {w: small(load(w, tree).config) for w in CELLS}
    code = (
        "import sys, time, json; sys.path.insert(0, sys.argv[1]); "
        "import portbench.run; from portbench.harness import cell, env; "
        "env.prepare(); bench, base, sizes = json.loads(sys.argv[2]); "
        "[cell.run(w, 3, 1.0, False, time.perf_counter(), device='cpu', "
        "config_override=s, bench=bench, base=base) "
        "for w, s in sizes.items()]; "
        "print(json.dumps(env.forbidden_loaded(list(sys.modules))))")
    out = subprocess.run([sys.executable, "-c", code, spec.ROOT,
                          json.dumps([bench, base, sizes])],
                         capture_output=True, text=True,
                         timeout=600, env=clean_env())
    assert out.returncode == 0, out.stderr[-3000:]
    assert json.loads(out.stdout.strip().splitlines()[-1]) == []


def test_no_card_exits_non_zero_with_no_result(monkeypatch, capsys):
    import torch
    from portbench import run as entry
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    monkeypatch.setattr(os, "environ", dict(os.environ))   # left as found
    rc = entry.main(["--workload", CELLS[0], "--seed", "1", "--seconds",
                     "1"])
    out = capsys.readouterr()
    assert rc != 0 and out.out.strip() == ""
    assert "card" in out.err


def test_an_empty_directory_exits_non_zero(tmp_path):
    """Beside only BENCHMARK.json and the benchmark's files, without the
    program, a run fails and prints no result."""
    shutil.copytree(spec.HERE, tmp_path / "portbench",
                    ignore=shutil.ignore_patterns(".cache", "__pycache__"))
    shutil.copy(os.path.join(spec.ROOT, "BENCHMARK.json"), tmp_path)
    out = subprocess.run([sys.executable, "portbench/run.py", "--workload",
                          CELLS[0], "--seed", "1", "--seconds", "1"],
                         cwd=tmp_path, capture_output=True, text=True,
                         timeout=300, env=clean_env())
    assert out.returncode != 0 and out.stdout.strip() == ""


def clean_env():
    return {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}


@pytest.mark.card
@pytest.mark.parametrize("workload", BENCH_CELLS)
def test_cell_on_the_card(workload, card):
    """A short run of each cell on the card is correct and reports every
    end-to-end metric of the cell."""
    out = subprocess.run([sys.executable, "portbench/run.py", "--workload",
                          workload, "--seed", "77", "--seconds", "3"],
                         cwd=spec.ROOT, capture_output=True, text=True,
                         timeout=1200)
    assert out.returncode == 0, out.stderr[-3000:]
    r = json.loads(out.stdout.strip().splitlines()[-1])
    assert r["correct"] and r["device"]["platform"] == "gpu"
    assert set(r["metrics"]) == {m["name"] for m in
                                 spec.load_cell(workload).end_to_end}
