"""CUDACypherSession — the user-facing session for the CUDA backend.

The counterpart of ``caps_tpu/backends/tpu/session.py``: the planning
stack is the backend-generic one; only the Table factory is
device-backed, and every query runs through the fused record/replay
executor (``fused.py``).  The session runs on the card unless the caller
asks for ``device="cpu"`` (the tests do), where every kernel wrapper
takes its plain PyTorch version.
"""
from __future__ import annotations

from typing import Optional

import torch

from caps_tpu_torch.backends.cuda.fused import FusedExecutor
from caps_tpu_torch.backends.cuda.table import DeviceBackend, DeviceTableFactory
from caps_tpu_torch.okapi.config import EngineConfig
from caps_tpu_torch.relational.session import (
    RelationalCypherSession, degraded_state,
)
from caps_tpu_torch.relational.shapes import ShapeBucketLattice


class CUDACypherSession(RelationalCypherSession):

    # count-only pattern chains lower to SpMV (relational/count_pattern.py)
    supports_count_pushdown = True
    # cyclic MATCH segments may run as one worst-case-optimal multiway
    # join (relational/wcoj.py)
    supports_wcoj = True

    def __init__(self, config: Optional[EngineConfig] = None,
                 device="cuda"):
        super().__init__(config)
        device = torch.device(device)
        if device.type == "cuda" and not torch.cuda.is_available():
            raise RuntimeError(
                "CUDACypherSession: device 'cuda' requested but CUDA is not "
                "available (pass device='cpu' to run the plain versions)")
        if device.type not in ("cuda", "cpu"):
            raise ValueError(f"unsupported device {device}")
        self.device = device
        self.backend = DeviceBackend(self.config, device)
        # one lattice: the session-level shape buckets
        # (relational/shapes.py) ARE the device padding ladder
        self.shape_lattice = ShapeBucketLattice(self.config.bucket_sizes)
        self.backend.shapes = self.shape_lattice
        self._factory = DeviceTableFactory(self.backend)
        self.fused = FusedExecutor(self.backend,
                                   max_entries=self.config.compile_cache_size)

    @property
    def table_factory(self) -> DeviceTableFactory:
        return self._factory

    def _cypher_on_graph(self, graph, query, parameters=None):
        """Route every query through the fused executor: the first run
        records the data-dependent sizes, repeats replay them with no
        device→host reads.  Attaches the per-query count of size reads
        (``size_syncs``) and of generic replays to the result's
        metrics."""
        be = self.backend
        # degraded unfused mode (relational/session.py): per-operator
        # eager execution, no memo touched
        use_fused = self.config.use_fused and not degraded_state()[1]
        syncs0 = be.syncs
        generic0 = self.fused.generic_replays
        if not use_fused:
            result = super()._cypher_on_graph(graph, query, parameters)
        else:
            key = self.fused.key(graph, query, dict(parameters or {}))
            result = self.fused.run(
                key, lambda: super(CUDACypherSession, self)._cypher_on_graph(
                    graph, query, parameters))
        if result.metrics is not None:
            result.metrics["size_syncs"] = be.syncs - syncs0
            if use_fused:
                result.metrics["fused_generic_replays"] = \
                    self.fused.generic_replays - generic0
        return result

    def _evict_catalog_dependents(self, qgn) -> None:
        """A query that reads a catalog graph (FROM GRAPH) sees other
        sizes once the name is stored anew: its recorded size streams go
        with its cached plan."""
        super()._evict_catalog_dependents(qgn)
        self.fused.evict_dependents(qgn)

    def metrics_snapshot(self) -> dict:
        """The backend's size-read count, the fused executor's
        record/replay counters, the count closures built, the plan
        cache's counters and the session's named counters (``cost.*``,
        ``wcoj.*``, ``replan.*``, ``stats.*``, ``opstats.*``)."""
        fused = self.fused
        snap = {
            "backend.syncs": self.backend.syncs,
            "fused.recordings": fused.recordings,
            "fused.replays": fused.replays,
            "fused.generic_replays": fused.generic_replays,
            "fused.mismatches": fused.mismatches,
            "fused.count_builds": self.backend.count_builds,
        }
        snap.update({f"plan_cache.{k}": v
                     for k, v in self.plan_cache.stats().items()})
        snap.update(self.metrics_registry.snapshot())
        return snap
