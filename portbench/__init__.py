"""The benchmark of ``caps_tpu_torch`` on an NVIDIA H100 (see
``run.py``)."""
