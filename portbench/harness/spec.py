"""Find a cell's parts by name.

``BENCHMARK.json`` names each cell's configuration and traffic mix, and
each metric.  Every part is a file of its own, found by that name:

- ``configs/<config>.json``: the deployment's sizes, source, ``reduced``,
  ``assumed`` and guarantees; ``configs/<config>.py`` beside it: the
  seeded generator and the plain reference (numpy or torch only);
- ``traffic/<mix>.json``: the traffic mix, read by the one general
  generator (``harness/traffic.py``);
- ``end_to_end/<metric>.py`` and ``layer_metrics/<metric>.py``: one
  reader per metric, ``read(ctx) -> number or None``.

Adding a configuration, a mix, a cell or a metric adds files and
entries; no file here changes.
"""
from __future__ import annotations

import dataclasses
import importlib.util
import json
import os
import re
from types import ModuleType
from typing import Any, Dict, List, Optional

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ROOT = os.path.dirname(HERE)

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")


class SpecError(ValueError):
    """BENCHMARK.json or a part it names is missing or malformed."""


def load_json(path: str) -> Any:
    with open(path, encoding="utf-8") as f:
        return json.load(f)


def load_module(path: str, name: str) -> ModuleType:
    """Import the file at ``path`` as a module of its own (file names
    hold ``-`` and ``.``, so they are not importable by name)."""
    if not os.path.isfile(path):
        raise SpecError(f"missing file {os.path.relpath(path, ROOT)}")
    spec = importlib.util.spec_from_file_location(name, path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def part_path(kind: str, name: str, suffix: str, base: str = HERE) -> str:
    """``<base>/<kind>/<name><suffix>`` (``base`` is this folder), after
    checking the name."""
    if not NAME.match(name):
        raise SpecError(f"{kind} name {name!r} is not a valid name")
    return os.path.join(base, kind, name + suffix)


@dataclasses.dataclass
class Cell:
    """One entry of ``workloads`` with everything it names, loaded."""
    name: str
    chips: int
    config: Dict[str, Any]
    generator: ModuleType
    mix: Dict[str, Any]
    end_to_end: List[Dict[str, Any]]
    per_layer: List[Dict[str, Any]]
    base: str = HERE

    def reader(self, metric: Dict[str, Any]) -> ModuleType:
        kind = "end_to_end" if metric in self.end_to_end else "layer_metrics"
        return load_module(part_path(kind, metric["name"], ".py", self.base),
                           f"portbench_{kind}_{metric['name']}")


def benchmark(root: str = ROOT) -> Dict[str, Any]:
    path = os.path.join(root, "BENCHMARK.json")
    if not os.path.isfile(path):
        raise SpecError("no BENCHMARK.json at the checkout's root")
    return load_json(path)


def metrics_of(bench: Dict[str, Any], cell: str) -> tuple:
    """(end-to-end, per-layer) metrics the cell reports: an end-to-end
    metric with ``workloads`` only in those cells, else in all; a
    per-layer metric with ``workloads`` only there, else wherever its
    ``moves`` metric is reported."""
    e2e = [m for m in bench["end_to_end"]
           if cell in m.get("workloads", [cell])]
    names = {m["name"] for m in e2e}
    layer = [m for m in bench["per_layer"]
             if (cell in m["workloads"] if "workloads" in m
                 else m["moves"] in names)]
    return e2e, layer


def load_cell(name: str, bench: Optional[Dict[str, Any]] = None,
              base: str = HERE) -> Cell:
    bench = benchmark() if bench is None else bench
    found = [w for w in bench["workloads"] if w["name"] == name]
    if len(found) != 1:
        raise SpecError(f"workload {name!r} is not in BENCHMARK.json")
    w = found[0]
    config = load_json(part_path("configs", w["config"], ".json", base))
    generator = load_module(part_path("configs", w["config"], ".py", base),
                            f"portbench_config_{w['config']}")
    mix = load_json(part_path("traffic", w["traffic"], ".json", base))
    e2e, layer = metrics_of(bench, name)
    return Cell(name=name, chips=int(w["chips"]), config=config,
                generator=generator, mix=mix, end_to_end=e2e,
                per_layer=layer, base=base)
