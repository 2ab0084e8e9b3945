"""Backend session factory shared by the unit and acceptance suites
(the counterpart of ``caps_tpu/testing/sessions.py``: one shared session
per backend, as the reference's SparkSession fixture)."""
from __future__ import annotations

from caps_tpu_torch._unported import not_ported

BACKENDS = ["local", "cuda"]


def make_backend_session(backend: str, device="cuda"):
    """A session of ``backend``: ``"local"`` is the pure-Python oracle
    (host-only, so ``device`` is not passed on); ``"cuda"`` the device
    backend on ``device`` (the tests pass ``"cpu"``)."""
    if backend == "local":
        from caps_tpu_torch.backends.local.session import LocalCypherSession
        return LocalCypherSession()
    if backend == "cuda":
        from caps_tpu_torch.backends.cuda.session import CUDACypherSession
        return CUDACypherSession(device=device)
    if backend == "sharded":
        raise not_ported("parallel (item 12)")
    raise ValueError(backend)
