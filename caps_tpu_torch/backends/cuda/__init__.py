"""The CUDA backend: the ``Table`` SPI over device-resident columnar data.

The counterpart of ``caps_tpu/backends/tpu`` on PyTorch:

  * columns are device tensors with validity masks, padded to bucketed
    capacities;
  * strings are dictionary-encoded host-side (``StringPool``) — the device
    only sees int32 codes, plus order-preserving rank arrays and per-query
    predicate lookup tables;
  * joins probe a CSR built at ingest (or a sorted build side) and
    materialize through the expand-positions kernel; group-bys over
    dictionary-coded keys run the dense segment-aggregation kernel;
    small sorts run the bitonic kernel (``caps_tpu_torch/ops``);
  * operators without a device implementation raise
    ``UnsupportedOnDevice`` — there is no host fallback.
"""
