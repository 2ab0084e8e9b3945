"""The local oracle session.

Plays the role ``CAPSSession`` plays for Spark (ref:
spark-cypher/.../api/CAPSSession.scala — reconstructed, mount empty;
SURVEY.md §2), but over the pure-Python LocalTable backend.  Used as the
parity oracle; the user-facing TPU session lives in
``caps_tpu_torch.backends.tpu.session``.
"""
from __future__ import annotations

from caps_tpu_torch.backends.local.table import LocalTableFactory
from caps_tpu_torch.relational.session import RelationalCypherSession


class LocalCypherSession(RelationalCypherSession):
    def __init__(self, config=None):
        super().__init__(config)
        self._factory = LocalTableFactory()

    @property
    def table_factory(self) -> LocalTableFactory:
        return self._factory

    @staticmethod
    def local(**kwargs) -> "LocalCypherSession":
        return LocalCypherSession(**kwargs)
