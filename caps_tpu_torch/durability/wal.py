"""Segmented, CRC-framed, append-only write-ahead commit log.

Entries are the exact ``delta_state_to_payload`` payloads snapshot
shipping already moves between fleet peers (serve/fleet.py): cumulative
full overlays over the spec'd base graph.  That choice does all the
heavy lifting here — recovery takes the single HIGHEST intact entry (no
per-version chain to replay), replaying twice is trivially idempotent,
and a torn or CRC-bad tail frame is dropped whole (an entry is either
fully decodable or it never happened; nothing is ever half-applied).

Frame layout (one commit per frame)::

    [4-byte big-endian body length][4-byte CRC32 of body][UTF-8 JSON body]
    body = {"version": int, "epoch": int|null, "state": <delta payload>}

Append-before-acknowledge: ``CommitLog.append`` runs inside the
versioned graph's commit lock (the ``pre_publish`` hook,
relational/updates.py) BEFORE the snapshot swap, so a write is
acknowledged only after its frame is on disk under the configured fsync
policy.  A failed append raises the typed transient
:class:`~caps_tpu_torch.serve.errors.WalWriteError` and the commit rolls back
through the existing string-pool mark — never a silent ack.

Fsync policy:

* ``"always"`` — fsync after every append (the durable default).
* ``"rotate"`` — fsync only when a segment fills and rotates; a crash
  can lose the un-synced tail of the live segment (weaker, faster).
* ``"never"`` — OS page cache only; a crash loses whatever the kernel
  had not written back.  For tests and throwaway graphs.

Compaction folds the overlay into a new base, so post-compaction entry
states are relative to the FOLDED base, not the spec'd one.  The owner
keeps recovery anchored to the spec'd base by composing
(:func:`compose_delta_payloads`) every appended state with the overlay
already folded away, and ``checkpoint()`` persists that composed state
atomically before truncating the covered segments.

Only host-side JSON ever touches the log — cached plans and tensors on
the card never migrate to disk.
"""
from __future__ import annotations

import dataclasses
import json
import os
import struct
import zlib
from typing import Any, Dict, List, Optional

from caps_tpu_torch.obs.lockgraph import make_lock
from caps_tpu_torch.obs.metrics import MetricsRegistry, global_registry
from caps_tpu_torch.serve.errors import WalWriteError

_FRAME_HEADER = struct.Struct(">II")
_SEGMENT_PREFIX = "wal-"
_SEGMENT_SUFFIX = ".log"
_CHECKPOINT_NAME = "checkpoint.json"
_FSYNC_POLICIES = ("always", "rotate", "never")

_PAYLOAD_KEYS = ("hidden_nodes", "hidden_rels", "nodes", "rels")


def empty_payload() -> Dict[str, list]:
    """The cumulative delta payload of an untouched graph."""
    return {"hidden_nodes": [], "hidden_rels": [], "nodes": [], "rels": []}


def frame_bytes(body: bytes) -> bytes:
    """One on-disk frame for ``body`` (length + CRC32 header)."""
    return _FRAME_HEADER.pack(len(body), zlib.crc32(body)) + body


def _write_frame(f, body: bytes) -> None:
    """Write one frame and push it to the OS.  Module-level on purpose:
    this is the shared locked patch point fault injectors rebind
    (testing/faults.py ``torn_wal``)."""
    f.write(frame_bytes(body))
    f.flush()


def _fsync(f) -> None:
    """Force ``f`` to stable storage.  Module-level patch point for
    ``failing_fsync`` (testing/faults.py)."""
    os.fsync(f.fileno())


def compose_delta_payloads(a: Dict[str, Any],
                           b: Dict[str, Any]) -> Dict[str, Any]:
    """Compose two cumulative delta payloads: ``b`` applied after ``a``.

    ``a`` is cumulative over some base B0 and ``b`` is cumulative over
    the graph ``a`` describes (the compaction fold of B0+a); the result
    is cumulative over B0.  Hidden sets union (a record both hidden and
    re-added stays correct because overlay lookups check ``added``
    before ``hidden`` — relational/updates.py ``_OverlayLookup``);
    ``b``'s records override ``a``'s, and ``a``'s records deleted by
    ``b`` (they were base entities of the folded graph, so the delete
    landed in ``b``'s hidden set) drop out.
    """
    b_hidden_nodes = {int(i) for i in b["hidden_nodes"]}
    b_hidden_rels = {int(i) for i in b["hidden_rels"]}
    nodes = {int(r[0]): r for r in a["nodes"]
             if int(r[0]) not in b_hidden_nodes}
    for r in b["nodes"]:
        nodes[int(r[0])] = r
    rels = {int(r[0]): r for r in a["rels"]
            if int(r[0]) not in b_hidden_rels}
    for r in b["rels"]:
        rels[int(r[0])] = r
    return {
        "hidden_nodes": sorted({int(i) for i in a["hidden_nodes"]}
                               | b_hidden_nodes),
        "hidden_rels": sorted({int(i) for i in a["hidden_rels"]}
                              | b_hidden_rels),
        "nodes": [nodes[k] for k in sorted(nodes)],
        "rels": [rels[k] for k in sorted(rels)],
    }


@dataclasses.dataclass(frozen=True)
class WalRecovery:
    """What one recovery pass found: the highest intact cumulative
    state, plus honest accounting of what was read and what was
    dropped."""

    version: int
    epoch: Optional[int]
    state: Dict[str, Any]
    entries: int
    torn_entries: int
    segments: int
    checkpoint_version: int
    path: str


class CommitLog:
    """One backend's append-only commit log under ``dir_path``.

    Thread-safe; every mutation holds the instance lock.  The commit
    path acquires it while already holding the versioned graph's commit
    lock (``pre_publish`` runs inside ``apply``), which is the one
    sanctioned nesting order — never call back into the graph from in
    here.
    """

    def __init__(self, dir_path: str, *, fsync: str = "always",
                 segment_max_bytes: int = 4 << 20,
                 registry: Optional[MetricsRegistry] = None,
                 event_log=None):
        if fsync not in _FSYNC_POLICIES:
            raise ValueError(
                f"unknown fsync policy {fsync!r} (one of {_FSYNC_POLICIES})")
        self.dir_path = os.path.abspath(dir_path)
        self.fsync_policy = fsync
        self.segment_max_bytes = int(segment_max_bytes)
        self._registry = registry if registry is not None else global_registry()
        self._event_log = event_log
        self._lock = make_lock("wal.CommitLog._lock")
        os.makedirs(self.dir_path, exist_ok=True)
        self._seg_index = max(
            (i for i, _ in self._segments()), default=0)
        self._seg_file = None
        self._seg_bytes = 0
        #: highest version known appended/checkpointed — duplicate or
        #: stale appends (idempotent peer installs) are skipped, never
        #: double-logged
        self._last_version = 0

    # -- paths ---------------------------------------------------------------

    def _segment_path(self, index: int) -> str:
        return os.path.join(self.dir_path,
                            f"{_SEGMENT_PREFIX}{index:08d}{_SEGMENT_SUFFIX}")

    @property
    def checkpoint_path(self) -> str:
        return os.path.join(self.dir_path, _CHECKPOINT_NAME)

    def _segments(self) -> List[tuple]:
        """Sorted ``(index, path)`` for every on-disk segment."""
        out = []
        for name in os.listdir(self.dir_path):
            if (name.startswith(_SEGMENT_PREFIX)
                    and name.endswith(_SEGMENT_SUFFIX)):
                stem = name[len(_SEGMENT_PREFIX):-len(_SEGMENT_SUFFIX)]
                try:
                    out.append((int(stem), os.path.join(self.dir_path, name)))
                except ValueError:
                    continue
        out.sort()
        return out

    # -- append path ---------------------------------------------------------

    def _open_segment(self):
        if self._seg_file is None:
            path = self._segment_path(self._seg_index)
            self._seg_file = open(path, "ab")
            self._seg_bytes = os.path.getsize(path)
        return self._seg_file

    def _rotate_locked(self) -> None:
        """Seal the live segment and start the next one.  Runs BETWEEN
        entries (before an append into a full segment), so a rotation
        fsync failure fails the incoming commit cleanly — the already
        acknowledged frames in the sealed segment were synced by their
        own appends under ``"always"``, or are exactly the exposure the
        weaker policies documented."""
        f = self._open_segment()
        if self.fsync_policy in ("always", "rotate"):
            try:
                _fsync(f)
                self._registry.counter("wal.fsyncs").inc()
            except OSError as ex:
                raise self._append_error("segment-seal fsync failed", ex)
        f.close()
        self._seg_file = None
        self._seg_index += 1
        self._seg_bytes = 0
        self._registry.counter("wal.rotations").inc()

    def _append_error(self, what: str, cause: BaseException) -> WalWriteError:
        self._registry.counter("wal.append_failures").inc()
        err = WalWriteError(f"WAL {what} in {self.dir_path}: {cause}")
        if (getattr(cause, "caps_wal_fault", None) is not None
                and getattr(err, "caps_wal_fault", None) is None):
            err.caps_wal_fault = True
        return err

    def append(self, version: int, state_payload: Dict[str, Any], *,
               epoch: Optional[int] = None) -> bool:
        """Append one commit frame; True once it is on disk under the
        configured fsync policy, False when ``version`` is already
        logged (idempotent re-install).  On failure the partial frame is
        truncated away and the typed transient
        :class:`~caps_tpu_torch.serve.errors.WalWriteError` raises — the
        caller's commit MUST roll back (never acknowledge a write whose
        frame did not land)."""
        version = int(version)
        body = json.dumps(
            {"version": version, "epoch": epoch, "state": state_payload},
            sort_keys=True).encode("utf-8")
        with self._lock:
            if version <= self._last_version:
                self._registry.counter("wal.skipped_appends").inc()
                return False
            f = self._open_segment()
            if self._seg_bytes >= self.segment_max_bytes and self._seg_bytes:
                self._rotate_locked()
                f = self._open_segment()
            offset = self._seg_bytes
            try:
                _write_frame(f, body)
                if self.fsync_policy == "always":
                    _fsync(f)
                    self._registry.counter("wal.fsyncs").inc()
            except OSError as ex:
                # keep the tail frame-aligned: drop the partial frame so
                # the NEXT append (the retried commit) lands cleanly
                try:
                    f.truncate(offset)
                except OSError:
                    pass
                raise self._append_error(
                    f"append failed (version {version})", ex) from ex
            self._seg_bytes = offset + len(body) + _FRAME_HEADER.size
            self._last_version = version
            self._registry.counter("wal.appends").inc()
            self._registry.counter("wal.append_bytes").inc(
                len(body) + _FRAME_HEADER.size)
            self._registry.gauge("wal.segment_bytes").set(
                float(self._seg_bytes))
            return True

    # -- checkpoint / truncation ---------------------------------------------

    def checkpoint(self, version: int, state_payload: Dict[str, Any], *,
                   epoch: Optional[int] = None) -> int:
        """Persist the cumulative state at ``version`` atomically
        (tmp + fsync + rename), then truncate every sealed-or-live
        segment it covers.  Returns the number of segments dropped.
        Runs from the compaction hook under the commit lock, so no
        append can race the truncation."""
        version = int(version)
        record = {"version": version, "epoch": epoch, "state": state_payload}
        with self._lock:
            tmp = f"{self.checkpoint_path}.tmp.{os.getpid()}"
            try:
                with open(tmp, "w", encoding="utf-8") as f:
                    f.write(json.dumps(record, sort_keys=True))
                    f.flush()
                    _fsync(f)
                os.replace(tmp, self.checkpoint_path)
            except OSError as ex:
                try:
                    os.unlink(tmp)
                except OSError:
                    pass
                raise self._append_error(
                    f"checkpoint failed (version {version})", ex) from ex
            if self._seg_file is not None:
                self._seg_file.close()
                self._seg_file = None
            dropped = 0
            for _idx, path in self._segments():
                try:
                    os.unlink(path)
                    dropped += 1
                except OSError:
                    # a stale segment is harmless: recovery takes the
                    # max version and the checkpoint already covers it
                    continue
            self._seg_index += 1
            self._seg_bytes = 0
            self._last_version = max(self._last_version, version)
            self._registry.counter("wal.checkpoints").inc()
            self._registry.counter("wal.truncated_segments").inc(dropped)
        # emit OUTSIDE the instance lock: the event log takes its own
        # lock, and holding ours across it would order the two
        if self._event_log is not None:
            self._event_log.emit(
                "wal.checkpoint", request_id=None, family=None,
                version=version, truncated_segments=dropped)
        return dropped

    def _read_checkpoint(self) -> Optional[Dict[str, Any]]:
        try:
            with open(self.checkpoint_path, encoding="utf-8") as f:
                record = json.load(f)
        except FileNotFoundError:
            return None
        except (OSError, ValueError) as ex:
            # the checkpoint is written atomically, so an unreadable one
            # is disk damage — older entries were truncated against it,
            # so pretending it was empty would SILENTLY lose acked
            # writes.  Refuse loudly instead.
            raise self._append_error("checkpoint unreadable", ex) from ex
        if (not isinstance(record, dict)
                or not isinstance(record.get("version"), int)
                or not isinstance(record.get("state"), dict)
                or any(k not in record["state"] for k in _PAYLOAD_KEYS)):
            raise self._append_error(
                "checkpoint malformed", ValueError(str(record)[:120]))
        return record

    # -- recovery ------------------------------------------------------------

    def recover(self, *, truncate_torn: bool = True) -> WalRecovery:
        """Replay the log: last checkpoint plus every intact entry, the
        highest version winning (entries are cumulative).  A torn or
        CRC-bad frame ends its segment's scan right there — counted in
        ``wal.torn_entries``, dropped whole, never half-applied; later
        segments still replay (each entry is self-contained).

        A torn tail is also truncated PHYSICALLY (``truncate_torn``):
        this log's next append must land where the last intact frame
        ended, or it would sit unreachable behind the garbage and a
        later recovery would silently lose it.  Failover scans over
        OTHER backends' logs pass ``truncate_torn=False`` — reading a
        peer's store must never write to it."""
        with self._lock:
            if self._seg_file is not None:
                self._seg_file.close()
                self._seg_file = None
            cp = self._read_checkpoint()
            version = 0
            epoch: Optional[int] = None
            state = empty_payload()
            cp_version = 0
            if cp is not None:
                cp_version = int(cp["version"])
                version, epoch, state = cp_version, cp.get("epoch"), cp["state"]
            entries = 0
            torn = 0
            segments = self._segments()
            for _idx, path in segments:
                with open(path, "rb") as f:
                    data = f.read()
                off = 0
                while off < len(data):
                    if off + _FRAME_HEADER.size > len(data):
                        torn += 1
                        break
                    length, crc = _FRAME_HEADER.unpack_from(data, off)
                    body = data[off + _FRAME_HEADER.size:
                                off + _FRAME_HEADER.size + length]
                    if len(body) < length or zlib.crc32(body) != crc:
                        torn += 1
                        break
                    try:
                        record = json.loads(body.decode("utf-8"))
                    except (ValueError, UnicodeDecodeError):
                        torn += 1
                        break
                    if (not isinstance(record, dict)
                            or not isinstance(record.get("version"), int)
                            or not isinstance(record.get("state"), dict)):
                        torn += 1
                        break
                    off += _FRAME_HEADER.size + length
                    entries += 1
                    if record["version"] >= version:
                        version = record["version"]
                        epoch = record.get("epoch")
                        state = record["state"]
                if truncate_torn and off < len(data):
                    try:
                        with open(path, "r+b") as tf:
                            tf.truncate(off)
                    except OSError:
                        pass  # unwritable store: recovery stays logical
            self._last_version = max(self._last_version, version)
            self._registry.counter("wal.recoveries").inc()
            self._registry.counter("wal.recovered_entries").inc(entries)
            self._registry.counter("wal.torn_entries").inc(torn)
        # emit OUTSIDE the instance lock (same ordering rule as
        # ``checkpoint``)
        if self._event_log is not None:
            self._event_log.emit(
                "wal.recovered", request_id=None, family=None,
                version=version, entries=entries, torn_entries=torn,
                segments=len(segments))
        return WalRecovery(
            version=version, epoch=epoch, state=state, entries=entries,
            torn_entries=torn, segments=len(segments),
            checkpoint_version=cp_version, path=self.dir_path)

    def close(self) -> None:
        with self._lock:
            if self._seg_file is not None:
                self._seg_file.close()
                self._seg_file = None


def scan_durable_dir(durable_dir: str, *,
                     registry: Optional[MetricsRegistry] = None
                     ) -> Optional[WalRecovery]:
    """Recover the best state across EVERY backend's log under a shared
    durable dir (``wal-<name>/`` subdirectories).  Failover runs this
    before claiming the lease: the dead owner's acked-but-unshipped
    writes live only in ITS log on the shared store, and the winner must
    replay them or acknowledged writes would vanish."""
    reg = registry if registry is not None else global_registry()
    best: Optional[WalRecovery] = None
    try:
        names = sorted(os.listdir(durable_dir))
    except OSError:
        return None
    for name in names:
        sub = os.path.join(durable_dir, name)
        if not (name.startswith(_SEGMENT_PREFIX) and os.path.isdir(sub)):
            continue
        rec = CommitLog(sub, fsync="never",
                        registry=reg).recover(truncate_torn=False)
        if best is None or rec.version > best.version:
            best = rec
    reg.counter("wal.recovery_scans").inc()
    return best
