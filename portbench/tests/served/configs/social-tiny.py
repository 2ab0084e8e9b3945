"""social-tiny: a test fixture's generator and plain reference, not a
deployment.  It drives the harness's served path (``QueryServer`` and
closed-loop clients, ``harness/drivers.py``) on the CPU.

The graph: persons with a uniform age and one of the cities, and
uniform ``KNOWS`` edges, all drawn from the seed.  The reference is
plain PyTorch over the generator's own arrays (it imports nothing of
the program): 2-hop path counts from the seeds a family picks, pushed
over the edges by ``index_add_`` in int64, then grouped by city.
"""
from __future__ import annotations

from typing import Any, Dict, List

import numpy as np
import torch


def make(seed: int, cfg: Dict[str, Any], device: str) -> Dict[str, Any]:
    """The arrays, on the host (the ingest takes host arrays)."""
    n, m, k = int(cfg["persons"]), int(cfg["knows"]), int(cfg["cities"])
    rng = np.random.default_rng(seed % (1 << 64))
    cities = np.array([f"city{i:04d}" for i in range(k)])
    age = rng.integers(int(cfg["age_min"]), int(cfg["age_max"]) + 1, n,
                       dtype=np.int64)
    city = rng.integers(0, k, n)
    src = rng.integers(0, n, m, dtype=np.int64)
    tgt = rng.integers(0, n, m, dtype=np.int64)
    nodes = {"Person": {"_id": np.arange(n, dtype=np.int64), "age": age,
                        "city": cities[city]}}
    rels = {"KNOWS": {"_id": np.arange(n, n + m, dtype=np.int64),
                      "_src": src, "_tgt": tgt}}
    return {"nodes": nodes, "rels": rels, "city_code": city,
            "cities": cities,
            "info": {"persons": n, "edges": m, "cities": k}}


class Reference:
    """Answers of the query families over the generator's arrays.

    ``hop2_top_cities``: 2-hop paths (a)-[r1]->(b)-[r2]->(c), r1 != r2,
    from the seeds the family's rule picks, counted by c's city: the 20
    rows of most paths, count descending, then city ascending.
    ``hop2_count``: the number of those paths."""

    def __init__(self, data: Dict[str, Any], cfg: Dict[str, Any],
                 device: str):
        k = data["rels"]["KNOWS"]
        p = data["nodes"]["Person"]
        dev = torch.device(device)
        self.src = torch.as_tensor(k["_src"], device=dev)
        self.tgt = torch.as_tensor(k["_tgt"], device=dev)
        self.props = {"age": torch.as_tensor(p["age"], device=dev)}
        self.city = torch.as_tensor(data["city_code"], device=dev)
        self.cities = data["cities"]          # sorted: code order = name order
        self.n = int(p["_id"].shape[0])
        self._hop2: Dict[tuple, torch.Tensor] = {}

    def seeds(self, rule: Dict[str, Any], params: Dict[str, Any]):
        col = self.props[rule["property"]]
        ok = torch.ones_like(col, dtype=torch.bool)
        if "eq" in rule:
            ok &= col == params[rule["eq"]]
        if "ge" in rule:
            ok &= col >= params[rule["ge"]]
        if "lt" in rule:
            ok &= col < params[rule["lt"]]
        return ok.to(torch.int64)

    def hop2(self, rule: Dict[str, Any], params: Dict[str, Any]):
        """Paths from the seeds ending at each node after two hops; a
        path may not use one relationship twice (Cypher's relationship
        uniqueness), so a-[r]->a-[r]->a over a self-loop r is taken
        out."""
        key = tuple(sorted((k, params[v]) for k, v in rule.items()
                           if k != "property"))
        if key not in self._hop2:
            seeds = self.seeds(rule, params)
            zero = torch.zeros(self.n, dtype=torch.int64,
                               device=self.src.device)
            hop1 = zero.clone().index_add_(0, self.tgt, seeds[self.src])
            hop2 = zero.clone().index_add_(0, self.tgt, hop1[self.src])
            loops = self.src == self.tgt
            hop2 -= zero.clone().index_add_(0, self.tgt[loops],
                                            seeds[self.src[loops]])
            self._hop2[key] = hop2
        return self._hop2[key]

    def answer(self, family: Dict[str, Any], params: Dict[str, Any]
               ) -> List[Dict[str, Any]]:
        hop2 = self.hop2(family["seeds"], params)
        if family["answer"] == "hop2_count":
            return [{"c": int(hop2.sum())}]
        if family["answer"] == "hop2_top_cities":
            per_city = torch.zeros(len(self.cities), dtype=torch.int64,
                                   device=hop2.device).index_add_(
                0, self.city, hop2).cpu().numpy()
            rows = sorted(((str(self.cities[i]), int(v))
                           for i, v in enumerate(per_city) if v),
                          key=lambda r: (-r[1], r[0]))[:20]
            return [{"city": c, "n": v} for c, v in rows]
        raise ValueError(f"unknown answer {family['answer']!r}")

    def control(self, family: Dict[str, Any], params: Dict[str, Any],
                recorded: Dict[str, Any]) -> List[Dict[str, Any]]:
        """The reference with the guarantee of fresh parameters broken:
        every request answered with the rows of the parameters its
        family was first run with (a replay that keeps what it
        recorded)."""
        return self.answer(family, recorded)
