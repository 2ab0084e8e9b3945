"""CUDACypherSession — the user-facing session for the CUDA backend.

The counterpart of ``caps_tpu/backends/tpu/session.py``: the planning
stack is the backend-generic one; only the Table factory is
device-backed.  The session runs on the card unless the caller asks for
``device="cpu"`` (the tests do), where every kernel wrapper takes its
plain PyTorch version.
"""
from __future__ import annotations

from typing import Optional

import torch

from caps_tpu_torch.backends.cuda.table import DeviceBackend, DeviceTableFactory
from caps_tpu_torch.okapi.config import EngineConfig
from caps_tpu_torch.relational.session import RelationalCypherSession


class CUDACypherSession(RelationalCypherSession):

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
        self._factory = DeviceTableFactory(self.backend)

    @property
    def table_factory(self) -> DeviceTableFactory:
        return self._factory
