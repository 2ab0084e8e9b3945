"""Graph-algorithm procedures: the ``CALL algo.*`` analytics tier.

A registry of iterative graph algorithms (PageRank, WCC, BFS, SSSP,
degree) invocable from openCypher as ``CALL algo.<name>(...) YIELD
...`` and composable with the rest of the query.  The package splits
into:

* :mod:`caps_tpu_torch.algo.registry` — signatures, defaults, typed
  resolution errors (what the semantic pass consults);
* :mod:`caps_tpu_torch.algo.kernels` — host NumPy kernels: the planned
  ``host`` strategy and the differential oracle;
* :mod:`caps_tpu_torch.algo.fixpoint` — the torch device programs over
  shape-lattice bucketed capacities, with the state frozen on the card
  once converged and convergence read once every few iterations;
* :mod:`caps_tpu_torch.algo.op` — the relational operator dispatching
  device-fixpoint vs host, with ledger-charged first runs.  A device
  fault propagates: there is no degraded host fallback.

The counterpart of ``caps_tpu/algo/``.
"""
from caps_tpu_torch.algo.registry import (  # noqa: F401
    ProcedureArgumentError,
    ProcedureError,
    ProcedureSignature,
    ProcedureYieldError,
    UnknownProcedureError,
    lookup,
    maybe_lookup,
    procedure_names,
    registered_signatures,
)

__all__ = [
    "ProcedureArgumentError",
    "ProcedureError",
    "ProcedureSignature",
    "ProcedureYieldError",
    "UnknownProcedureError",
    "lookup",
    "maybe_lookup",
    "procedure_names",
    "registered_signatures",
]
