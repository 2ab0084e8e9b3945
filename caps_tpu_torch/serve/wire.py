"""Fleet wire protocol: length-prefixed JSON frames over local sockets.

The thinnest transport that can carry the serving tier's typed surface
between processes: one frame is a 4-byte big-endian length header
followed by a UTF-8 JSON body.  Requests are ``{"op": ..., **fields}``;
replies are ``{"ok": true, "result": ...}`` or ``{"ok": false,
"error": <ServeError.to_payload()>}`` — the error payload reconstructs
the EXACT typed exception on the caller's side
(``serve/errors.py error_from_payload``), so ``Overloaded.retry_after_s``,
``QueryFailed.attempts``, and deadline phase attribution survive the
process boundary with full fidelity.

Transport failures (peer died, connection dropped, malformed or
oversized frame) raise :class:`~caps_tpu_torch.serve.errors.WireError` —
marked transient, so the router retries the request on the next ring
node.  ``faults.slow_network`` / ``faults.drop_connection``
(testing/faults.py) patch :func:`send_frame` under the shared fault
lock, which makes router failover tests deterministic.

Durable fleets fence writes AT this layer: write frames carry the
router's last-known lease ``epoch`` field, the owning backend checks it
against the live lease before staging anything
(serve/fleet.py ``_fence_write``), and a mismatch reconstructs as the
typed :class:`~caps_tpu_torch.serve.errors.StaleEpoch` on the caller's side —
``epoch`` / ``lease_epoch`` / ``owner`` payload fields intact — so a
zombie owner's frames die on the wire instead of splitting the log.

Frame traffic counts under ``wire.*`` in the process-global registry
(frames/bytes in both directions, drops), so a fleet soak can assert
how much actually crossed the wire.
"""
from __future__ import annotations

import json
import socket
import struct
import threading
from typing import Any, Dict, Optional

from caps_tpu_torch.obs.lockgraph import make_lock
from caps_tpu_torch.obs.metrics import global_registry
from caps_tpu_torch.serve.errors import (QueryFailed, ServeError, WireError,
                                         error_from_payload)

#: 4-byte big-endian frame length header
_HEADER = struct.Struct(">I")

#: hard bound on one frame's body — a corrupt header must not make the
#: receiver allocate gigabytes
MAX_FRAME_BYTES = 64 * 1024 * 1024


def _count(name: str, n: int = 1) -> None:
    global_registry().counter(name).inc(n)


def send_frame(sock: socket.socket, obj: Dict[str, Any]) -> None:
    """Serialize + send one frame.  Raises :class:`WireError` on any
    transport failure (connection reset, closed socket) and on a body
    that cannot be JSON-encoded or exceeds :data:`MAX_FRAME_BYTES`."""
    try:
        body = json.dumps(obj, separators=(",", ":")).encode("utf-8")
    except (TypeError, ValueError) as ex:
        raise WireError(f"frame body is not JSON-serializable: "
                        f"{type(ex).__name__}: {ex}")
    if len(body) > MAX_FRAME_BYTES:
        raise WireError(f"frame of {len(body)} bytes exceeds the "
                        f"{MAX_FRAME_BYTES}-byte bound")
    try:
        sock.sendall(_HEADER.pack(len(body)) + body)
    except OSError as ex:
        _count("wire.drops")
        raise WireError(f"send failed: {type(ex).__name__}: {ex}")
    _count("wire.frames_sent")
    _count("wire.bytes_sent", _HEADER.size + len(body))


def _recv_exact(sock: socket.socket, n: int) -> Optional[bytes]:
    """Read exactly ``n`` bytes; None on clean EOF at a frame boundary
    (nothing read yet), WireError on a mid-frame disconnect."""
    chunks = []
    got = 0
    while got < n:
        try:
            chunk = sock.recv(min(65536, n - got))
        except OSError as ex:
            _count("wire.drops")
            raise WireError(f"recv failed: {type(ex).__name__}: {ex}")
        if not chunk:
            if got == 0:
                return None
            _count("wire.drops")
            raise WireError(f"connection closed mid-frame "
                            f"({got}/{n} bytes)")
        chunks.append(chunk)
        got += len(chunk)
    return b"".join(chunks)


def recv_frame(sock: socket.socket) -> Optional[Dict[str, Any]]:
    """Receive one frame.  Returns the decoded object, or None on a
    clean EOF between frames (the peer hung up); raises
    :class:`WireError` on a torn frame or undecodable body."""
    header = _recv_exact(sock, _HEADER.size)
    if header is None:
        return None
    (length,) = _HEADER.unpack(header)
    if length > MAX_FRAME_BYTES:
        _count("wire.drops")
        raise WireError(f"frame header announces {length} bytes "
                        f"(bound {MAX_FRAME_BYTES})")
    body = _recv_exact(sock, length)
    if body is None:
        _count("wire.drops")
        raise WireError("connection closed between header and body")
    try:
        obj = json.loads(body.decode("utf-8"))
    except (ValueError, UnicodeDecodeError) as ex:
        _count("wire.drops")
        raise WireError(f"undecodable frame body: "
                        f"{type(ex).__name__}: {ex}")
    if not isinstance(obj, dict):
        _count("wire.drops")
        raise WireError(f"frame body must be an object, got "
                        f"{type(obj).__name__}")
    _count("wire.frames_received")
    _count("wire.bytes_received", _HEADER.size + length)
    return obj


class WireClient:
    """One connection to a fleet backend: synchronous request/reply.

    Thread-safe (one in-flight call at a time per client — the router
    holds one client per backend and serializes on it; concurrent
    routing across backends still parallelizes).  A transport failure
    closes the socket and raises :class:`WireError`; the next call
    reconnects, so a healed backend is reusable without rebuilding the
    client."""

    def __init__(self, host: str, port: int, timeout_s: float = 30.0):
        self.host = host
        self.port = int(port)
        self.timeout_s = timeout_s
        self._sock: Optional[socket.socket] = None
        self._lock = make_lock("wire.WireClient._lock")

    def _connect(self) -> socket.socket:
        try:
            sock = socket.create_connection((self.host, self.port),
                                            timeout=self.timeout_s)
            sock.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)
        except OSError as ex:
            _count("wire.connect_failures")
            raise WireError(f"connect to {self.host}:{self.port} failed: "
                            f"{type(ex).__name__}: {ex}")
        return sock

    def call(self, op: str, **fields: Any) -> Any:
        """Send ``{"op": op, **fields}``, wait for the reply, return its
        ``result``.  A remote typed error re-raises HERE as the exact
        class the backend raised; transport failures raise
        :class:`WireError` after closing the connection."""
        with self._lock:
            if self._sock is None:
                self._sock = self._connect()
            try:
                send_frame(self._sock, {"op": op, **fields})
                reply = recv_frame(self._sock)
            except ServeError:
                self._close_locked()
                raise
            if reply is None:
                self._close_locked()
                _count("wire.drops")
                raise WireError(f"{self.host}:{self.port} closed the "
                                f"connection before replying to {op!r}")
        if reply.get("ok"):
            return reply.get("result")
        raise error_from_payload(reply.get("error"))

    def _close_locked(self) -> None:
        if self._sock is not None:
            try:
                self._sock.close()
            except OSError:  # pragma: no cover — close must not raise
                pass
            self._sock = None

    def close(self) -> None:
        with self._lock:
            self._close_locked()

    def __enter__(self) -> "WireClient":
        return self

    def __exit__(self, *exc) -> None:
        self.close()


def serve_connection(conn: socket.socket, handler,
                     shutting_down: Optional[threading.Event] = None
                     ) -> None:
    """One connection's serve loop: frame in → ``handler(msg)`` →
    reply frame out, until the peer hangs up (or ``shutting_down``
    fires).  Every failure crosses the wire typed: a ServeError
    serializes as itself, anything else wraps into a
    :class:`QueryFailed` carrying the original class name — the remote
    client never sees an untyped error."""
    try:
        while shutting_down is None or not shutting_down.is_set():
            msg = recv_frame(conn)
            if msg is None:
                return
            try:
                reply = {"ok": True, "result": handler(msg)}
            except ServeError as ex:
                reply = {"ok": False, "error": ex.to_payload()}
            except Exception as ex:
                reply = {"ok": False,
                         "error": QueryFailed(
                             f"{type(ex).__name__}: {ex}").to_payload()}
            send_frame(conn, reply)
    except ServeError:
        # torn connection mid-serve: the client saw its own WireError;
        # nothing to reply to
        _count("wire.connections_torn")
    finally:
        try:
            conn.close()
        except OSError:  # pragma: no cover — close must not raise
            pass
