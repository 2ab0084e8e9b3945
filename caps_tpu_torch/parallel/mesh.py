"""Device mesh construction.

The counterpart of ``caps_tpu/parallel/mesh.py``.  One axis ("shard")
for horizontal table and graph partitioning — the analog of the
reference's Spark partition count (SURVEY.md §2 parallelism inventory
item 1); mesh size is config.

The JAX package's mesh is one controller over ``jax.devices()``; so is
this one.  A mesh is an array of shard slots, each naming the
``torch.device`` its shard runs on: shard ``i`` goes to the ``i``-th
card counted from the session's (round robin over
``torch.cuda.device_count()``), so on one card every shard is on
``cuda:0`` — a virtual mesh, as XLA's virtual CPU devices are — and on
the CPU every shard is on ``cpu``.  Slots are distinct objects even where
their devices coincide, so a shard can be named, lost and re-sharded
away on a virtual mesh as on a real one.
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Sequence, Tuple

import numpy as np
import torch

AXES_1D = ("shard",)
AXES_2D = ("dcn", "shard")


@dataclasses.dataclass(frozen=True)
class ShardSlot:
    """One position of a mesh: the shard's index when the mesh was first
    built, and the device it runs on."""
    index: int
    device: torch.device

    def __str__(self) -> str:
        return f"{self.device}#{self.index}"


class Mesh:
    """An n-D array of :class:`ShardSlot` with axis names (1-D
    ``("shard",)``; 2-D ``("dcn", "shard")``, the slow axis outer).
    Rows of a sharded array flatten over every axis, DCN-major."""

    def __init__(self, devices: np.ndarray, axis_names: Tuple[str, ...]):
        if devices.ndim != len(axis_names):
            raise ValueError(f"mesh of {devices.ndim} dims needs as many "
                             f"axis names, got {axis_names}")
        self.devices = devices
        self.axis_names = tuple(axis_names)

    @property
    def size(self) -> int:
        return int(self.devices.size)

    @property
    def slots(self) -> Tuple[ShardSlot, ...]:
        """The shards in row order (flattened DCN-major)."""
        return tuple(self.devices.flat)

    @property
    def shard_devices(self) -> Tuple[torch.device, ...]:
        """Each shard's device, in row order."""
        return tuple(s.device for s in self.devices.flat)

    @property
    def distinct_devices(self) -> Tuple[torch.device, ...]:
        out = []
        for d in self.shard_devices:
            if d not in out:
                out.append(d)
        return tuple(out)

    @property
    def lead(self) -> torch.device:
        """Shard 0's device: where whole tables live."""
        return self.devices.flat[0].device

    def describe(self) -> dict:
        return {"shards": self.size, "shape": list(self.devices.shape),
                "devices": [str(d) for d in self.distinct_devices]}

    def __repr__(self) -> str:
        return (f"Mesh(shape={tuple(self.devices.shape)}, "
                f"axes={self.axis_names}, "
                f"devices={[str(d) for d in self.distinct_devices]})")


def _take_devices(n: int, device="cuda") -> np.ndarray:
    """``n`` shard slots counted from ``device`` (default: the first
    card; raises where there is none — pass ``device="cpu"`` for a mesh
    on the CPU)."""
    if n < 1:
        raise ValueError(f"a mesh needs at least one shard, got {n}")
    device = torch.device(device)
    if device.type == "cuda":
        count = torch.cuda.device_count() if torch.cuda.is_available() \
            else 0
        if count < 1:
            raise RuntimeError(
                f"a mesh of {n} shards on {device} needs a CUDA card, and "
                f"none is visible; pass device='cpu' for a CPU mesh")
        first = device.index or 0
        devs = [torch.device("cuda", (first + i) % count) for i in range(n)]
    else:
        devs = [device] * n
    slots = np.empty(n, dtype=object)
    for i, d in enumerate(devs):
        slots[i] = ShardSlot(i, d)
    return slots


def make_mesh(n_devices: Optional[int] = None, device="cuda") -> Mesh:
    """A 1-D mesh of ``n_devices`` shards (default: one per card), on
    the card unless ``device`` says otherwise."""
    if n_devices is None:
        n_devices = max(1, torch.cuda.device_count())
    return Mesh(_take_devices(int(n_devices), device), AXES_1D)


def make_mesh_2d(shape: Sequence[int], device="cuda") -> Mesh:
    """Two-level mesh for multi-slice topologies: ("dcn", "shard") with
    the slow axis OUTER — row sharding flattens over both, so
    consecutive blocks live on one slice.  The hand-scheduled rings are
    a 1-D-mesh schedule; on 2-D meshes the engine takes its unsharded
    program paths."""
    n_dcn, n_ici = int(shape[0]), int(shape[1])
    arr = _take_devices(n_dcn * n_ici, device).reshape(n_dcn, n_ici)
    return Mesh(arr, AXES_2D)


def mesh_from_slots(rows) -> Optional[Mesh]:
    """A mesh over surviving slots: a list of slot lists (one per DCN
    row) or one flat list.  None for a single slot (no mesh)."""
    if rows and isinstance(rows[0], (list, tuple)):
        if len(rows) > 1:
            arr = np.empty((len(rows), len(rows[0])), dtype=object)
            for r, row in enumerate(rows):
                for c, s in enumerate(row):
                    arr[r, c] = s
            return Mesh(arr, AXES_2D)
        rows = rows[0]
    if len(rows) <= 1:
        return None
    arr = np.empty(len(rows), dtype=object)
    for i, s in enumerate(rows):
        arr[i] = s
    return Mesh(arr, AXES_1D)
