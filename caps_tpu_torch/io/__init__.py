"""Property graph data sources.

The in-memory ``session`` source lives in
:mod:`caps_tpu_torch.okapi.catalog` (the default namespace); this package
holds the durable one: the filesystem source (Parquet / CSV / ORC
directories and ``schema.json``), the counterpart of ``caps_tpu/io``.
"""
from caps_tpu_torch.io.fs import FSGraphSource  # noqa: F401
