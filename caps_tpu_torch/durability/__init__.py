"""Durable writes: the write-ahead commit log and the owner write lease.

This package is the disk tier under the serving stack: `wal` persists
every acknowledged commit as the exact cumulative delta payload snapshot
shipping already moves between fleet peers, and `lease` arbitrates which
fleet backend may accept writes (epoch-fenced, so a deposed owner can
never split-brain).  Everything here is host-side JSON — compiled
executables and tensors on the card never touch the log.
"""
from caps_tpu_torch.durability.lease import (DEFAULT_LEASE_NAME,
                                             ROUTER_LEASE_NAME, LeaseStore)
from caps_tpu_torch.durability.wal import (CommitLog, WalRecovery,
                                           compose_delta_payloads,
                                           empty_payload, scan_durable_dir)

__all__ = [
    "CommitLog", "DEFAULT_LEASE_NAME", "LeaseStore",
    "ROUTER_LEASE_NAME", "WalRecovery", "compose_delta_payloads",
    "empty_payload", "scan_durable_dir",
]
