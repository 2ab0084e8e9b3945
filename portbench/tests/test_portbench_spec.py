"""BENCHMARK.json against the contract's form, and every part found by
name."""
import json
import os
import shutil

import pytest

from portbench.harness import spec

BENCH = spec.benchmark()


def all_names():
    for key in ("configs", "workloads", "end_to_end", "per_layer"):
        for entry in BENCH[key]:
            yield entry["name"]
    for w in BENCH["workloads"]:
        yield w["config"]
        yield w["traffic"]
    for c in BENCH["configs"]:
        yield from c["reduced"]


@pytest.mark.parametrize("name", sorted(set(all_names())))
def test_names_are_allowed(name):
    assert spec.NAME.match(name), name


@pytest.mark.parametrize("metric", BENCH["end_to_end"] + BENCH["per_layer"],
                         ids=lambda m: m["name"])
def test_metric_form(metric):
    assert spec.UNIT.match(metric["unit"]), metric["unit"]
    assert metric["better"] in ("lower", "higher")
    keys = set(metric)
    if metric in BENCH["end_to_end"]:
        assert metric["source"] in ("host_clock", "device_trace")
        assert keys <= {"name", "unit", "better", "bound", "source",
                        "workloads"}
        assert 0.01 <= metric["bound"] <= 0.25
    else:
        assert keys <= {"name", "unit", "better", "source", "layer", "moves",
                        "workloads"}
        assert metric["moves"] in {m["name"] for m in BENCH["end_to_end"]}
        for w in metric.get("workloads", []):
            e2e, _ = spec.metrics_of(BENCH, w)
            assert metric["moves"] in {m["name"] for m in e2e}
    if metric["name"].endswith("_roofline_pct"):
        assert metric["unit"] == "%"


def test_top_level_form():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs",
                          "workloads", "end_to_end", "per_layer"}
    assert BENCH["command"] == ["python3", "portbench/run.py"]
    assert BENCH["paths"] == ["portbench"]
    assert 1 <= BENCH["run_seconds"] <= 51
    assert "setup_s" in {m["name"] for m in BENCH["end_to_end"]}
    assert os.path.getsize(os.path.join(spec.ROOT, "BENCHMARK.json")) \
        < 64 * 1024
    for text in ([c["why"] for c in BENCH["configs"]]
                 + [w["why"] for w in BENCH["workloads"]]
                 + [c["source"] for c in BENCH["configs"]]
                 + [m["layer"] for m in BENCH["per_layer"]]):
        assert 1 <= len(text) <= 200 and "\n" not in text \
            and "\t" not in text


@pytest.mark.parametrize("workload", [w["name"] for w in BENCH["workloads"]])
def test_cell_parts_found_by_name(workload):
    cell = spec.load_cell(workload)
    assert cell.chips == 1
    assert callable(cell.generator.make) and cell.generator.Reference
    assert cell.mix["families"]
    e2e = {m["name"] for m in cell.end_to_end}
    assert "setup_s" in e2e and len(e2e) >= 2 and cell.per_layer
    for m in cell.end_to_end + cell.per_layer:
        assert callable(cell.reader(m).read), m["name"]
    entry = [c for c in BENCH["configs"]
             if c["name"] == [w for w in BENCH["workloads"]
                              if w["name"] == workload][0]["config"]][0]
    assert entry["file"] == f"portbench/configs/{entry['name']}.json"
    assert cell.config["reduced"] == entry["reduced"]


def test_a_new_mix_is_found_without_an_edit(tmp_path):
    base = tmp_path / "portbench"
    shutil.copytree(spec.HERE, base, ignore=shutil.ignore_patterns(
        ".cache", "__pycache__"))
    mix = json.loads((base / "traffic" / "triangles.json").read_text())
    mix["warm_passes"] = 3
    (base / "traffic" / "triangles-w3.json").write_text(json.dumps(mix))
    bench = json.loads(json.dumps(BENCH))
    first = bench["workloads"][0]
    bench["workloads"].append({"name": "g500-triangles-w3",
                               "config": first["config"],
                               "traffic": "triangles-w3",
                               "chips": 1, "why": "a new mix"})
    for m in bench["end_to_end"] + bench["per_layer"]:
        if first["name"] in m.get("workloads", []):
            m["workloads"].append("g500-triangles-w3")
    cell = spec.load_cell("g500-triangles-w3", bench, base=str(base))
    assert cell.mix["warm_passes"] == 3
    assert {m["name"] for m in cell.per_layer} == {
        m["name"] for m in spec.load_cell(first["name"]).per_layer}


def test_unknown_names_are_refused():
    with pytest.raises(spec.SpecError):
        spec.load_cell("no-such-cell")
    with pytest.raises(spec.SpecError):
        spec.part_path("traffic", "../escape", ".json")
