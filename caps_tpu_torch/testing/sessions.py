"""Backend session factory shared by the unit and acceptance suites
(the counterpart of ``caps_tpu/testing/sessions.py``: one shared session
per backend, as the reference's SparkSession fixture)."""
from __future__ import annotations

BACKENDS = ["local", "cuda", "sharded"]


def make_backend_session(backend: str, device="cuda"):
    """A session of ``backend``: ``"local"`` is the pure-Python oracle
    (host-only, so ``device`` is not passed on); ``"cuda"`` the device
    backend on ``device`` (the tests pass ``"cpu"``); ``"sharded"`` the
    same backend over an 8-shard mesh (on one card, or the CPU, a
    virtual mesh — mesh size is config)."""
    if backend == "local":
        from caps_tpu_torch.backends.local.session import LocalCypherSession
        return LocalCypherSession()
    if backend in ("cuda", "sharded"):
        from caps_tpu_torch.backends.cuda.session import CUDACypherSession
        from caps_tpu_torch.okapi.config import EngineConfig
        config = EngineConfig(mesh_shape=(8,)) if backend == "sharded" \
            else None
        return CUDACypherSession(device=device, config=config)
    raise ValueError(backend)
