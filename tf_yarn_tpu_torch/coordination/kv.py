"""Coordination service: a key-value store with blocking waits and an
event log — the Python half of tf_yarn_tpu/coordination/kv.py.

The control plane of a run: the driver starts a server, every task
program connects to it, and the lifecycle events, the experiment, the
cluster layout, heartbeats and metric snapshots all travel through it.
Two interchangeable forms:

* :class:`InProcessKV` — pure Python, in process; the engine behind the
  server and the test double.
* :class:`KVServer` — a threaded TCP server speaking a tiny
  length-prefixed JSON protocol; runs on the driver.

Both are driven through the :class:`KVStore` interface. The wire is the
JAX package's, byte for byte, so a client of either package talks to a
server of either (and to the JAX package's native ``coordd``, which the
port does not start):

    frame   := uint32_be length, then `length` bytes of UTF-8 JSON
    request := {"op": ..., "key": ..., "value": <base64>, ...}
    reply   := {"ok": true, ...} | {"ok": false, "error": msg}

Semantics:

* ``put(key, value)``   — set bytes; appends (seq, key) to the event log.
* ``get(key)``          — bytes or None.
* ``wait(key, timeout)``— block until the key exists, return its value.
* ``events(since)``     — event-log suffix, for driver-side aggregation.
* ``keys(prefix)``      — sorted matching keys.
* ``incr(key, n)``      — atomic counter (rank tickets, barriers).
* ``delete(key)``       — remove (no event).
"""

from __future__ import annotations

import base64
import json
import logging
import os
import socket
import socketserver
import struct
import threading
from typing import Dict, List, Optional, Tuple


_logger = logging.getLogger(__name__)

_MAX_FRAME = 64 * 1024 * 1024


class KVTimeoutError(TimeoutError):
    """Raised when `wait` exceeds its timeout (the reference surfaces skein's
    timeout from `app.kv.wait`; we give it a first-class type)."""


class KVStore:
    """Abstract coordination-store interface shared by all implementations."""

    def put(self, key: str, value: bytes) -> None:
        raise NotImplementedError

    def get(self, key: str) -> Optional[bytes]:
        raise NotImplementedError

    def wait(self, key: str, timeout: Optional[float] = None) -> bytes:
        raise NotImplementedError

    def events(self, since: int = 0) -> Tuple[List[Tuple[int, str]], int]:
        raise NotImplementedError

    def keys(self, prefix: str = "") -> List[str]:
        raise NotImplementedError

    def incr(self, key: str, amount: int = 1) -> int:
        raise NotImplementedError

    def delete(self, key: str) -> None:
        raise NotImplementedError

    # Convenience string views (the reference stores UTF-8 text payloads).
    def put_str(self, key: str, value: str) -> None:
        self.put(key, value.encode("utf-8"))

    def get_str(self, key: str) -> Optional[str]:
        raw = self.get(key)
        return None if raw is None else raw.decode("utf-8")

    def wait_str(self, key: str, timeout: Optional[float] = None) -> str:
        return self.wait(key, timeout=timeout).decode("utf-8")


class InProcessKV(KVStore):
    """Dict + condition-variable implementation; thread-safe."""

    def __init__(self) -> None:
        self._data: Dict[str, bytes] = {}
        self._log: List[Tuple[int, str]] = []
        self._cond = threading.Condition()

    def put(self, key: str, value: bytes) -> None:
        if not isinstance(value, bytes):
            raise TypeError(f"value for {key!r} must be bytes, got {type(value)}")
        with self._cond:
            self._data[key] = value
            self._log.append((len(self._log), key))
            self._cond.notify_all()

    def get(self, key: str) -> Optional[bytes]:
        with self._cond:
            return self._data.get(key)

    def wait(self, key: str, timeout: Optional[float] = None) -> bytes:
        with self._cond:
            ok = self._cond.wait_for(lambda: key in self._data, timeout=timeout)
            if not ok:
                raise KVTimeoutError(f"timed out after {timeout}s waiting for {key!r}")
            return self._data[key]

    def events(self, since: int = 0) -> Tuple[List[Tuple[int, str]], int]:
        with self._cond:
            tail = self._log[since:]
            return list(tail), len(self._log)

    def keys(self, prefix: str = "") -> List[str]:
        with self._cond:
            return sorted(k for k in self._data if k.startswith(prefix))

    def incr(self, key: str, amount: int = 1) -> int:
        with self._cond:
            current = int(self._data.get(key, b"0"))
            current += amount
            self._data[key] = str(current).encode()
            self._log.append((len(self._log), key))
            self._cond.notify_all()
            return current

    def delete(self, key: str) -> None:
        with self._cond:
            self._data.pop(key, None)


# ---------------------------------------------------------------------------
# Wire protocol helpers (shared by the Python server, the Python client, and
# mirrored by the JAX package's native/coordd.cc).
# ---------------------------------------------------------------------------


def _send_frame(sock: socket.socket, obj: dict) -> None:
    payload = json.dumps(obj, separators=(",", ":")).encode("utf-8")
    sock.sendall(struct.pack(">I", len(payload)) + payload)


def _recv_exact(sock: socket.socket, n: int) -> bytes:
    buf = b""
    while len(buf) < n:
        chunk = sock.recv(n - len(buf))
        if not chunk:
            raise ConnectionError("coordination peer closed the connection")
        buf += chunk
    return buf


def _recv_frame(sock: socket.socket) -> dict:
    (length,) = struct.unpack(">I", _recv_exact(sock, 4))
    if length > _MAX_FRAME:
        raise ValueError(f"frame of {length} bytes exceeds limit {_MAX_FRAME}")
    return json.loads(_recv_exact(sock, length).decode("utf-8"))


def _b64e(value: bytes) -> str:
    return base64.b64encode(value).decode("ascii")


def _b64d(value: str) -> bytes:
    return base64.b64decode(value.encode("ascii"))


class _Handler(socketserver.BaseRequestHandler):
    def handle(self) -> None:  # one connection may issue many requests
        kv: InProcessKV = self.server.kv  # type: ignore[attr-defined]
        sock = self.request
        try:
            while True:
                req = _recv_frame(sock)
                try:
                    reply = self._dispatch(kv, req)
                except KVTimeoutError as exc:
                    reply = {"ok": False, "error": str(exc), "timeout": True}
                except Exception as exc:  # surface, don't kill the server
                    reply = {"ok": False, "error": f"{type(exc).__name__}: {exc}"}
                _send_frame(sock, reply)
                if req.get("op") == "shutdown":
                    # serve_forever must be stopped from another thread.
                    threading.Thread(
                        target=self.server.shutdown, daemon=True
                    ).start()
                    return
        except (ConnectionError, OSError, json.JSONDecodeError):
            return

    @staticmethod
    def _dispatch(kv: InProcessKV, req: dict) -> dict:
        op = req.get("op")
        if op == "put":
            kv.put(req["key"], _b64d(req["value"]))
            return {"ok": True}
        if op == "get":
            raw = kv.get(req["key"])
            return {"ok": True, "value": None if raw is None else _b64e(raw)}
        if op == "wait":
            raw = kv.wait(req["key"], timeout=req.get("timeout"))
            return {"ok": True, "value": _b64e(raw)}
        if op == "events":
            tail, nxt = kv.events(int(req.get("since", 0)))
            return {"ok": True, "events": tail, "next": nxt}
        if op == "keys":
            return {"ok": True, "keys": kv.keys(req.get("prefix", ""))}
        if op == "incr":
            return {"ok": True, "value": kv.incr(req["key"], int(req.get("amount", 1)))}
        if op == "del":
            kv.delete(req["key"])
            return {"ok": True}
        if op == "ping":
            return {"ok": True, "server": "py"}
        if op == "shutdown":
            return {"ok": True}
        return {"ok": False, "error": f"unknown op {op!r}"}


class _ThreadedTCPServer(socketserver.ThreadingTCPServer):
    daemon_threads = True
    allow_reuse_address = True


class KVServer:
    """Threaded TCP coordination server wrapping an :class:`InProcessKV`.

    One server per run, started by the driver (`client._setup_cluster`).
    """

    def __init__(self, host: str = "127.0.0.1", port: int = 0) -> None:
        self._server = _ThreadedTCPServer((host, port), _Handler)
        self._server.kv = InProcessKV()  # type: ignore[attr-defined]
        self._thread = threading.Thread(
            target=self._server.serve_forever, name="kv-server", daemon=True
        )

    @property
    def kv(self) -> InProcessKV:
        return self._server.kv  # type: ignore[attr-defined]

    @property
    def address(self) -> Tuple[str, int]:
        host, port = self._server.server_address[:2]
        return str(host), int(port)

    @property
    def endpoint(self) -> str:
        host, port = self.address
        return f"{host}:{port}"

    def start(self) -> "KVServer":
        self._thread.start()
        return self

    def stop(self) -> None:
        # shutdown() waits on serve_forever's is-shut-down event, which
        # starts UNSET — calling it when the acceptor never ran blocks
        # forever (stdlib BaseServer semantics). A dead/finished thread
        # means serve_forever already exited (event set), so shutdown()
        # then returns immediately.
        if self._thread.is_alive():
            self._server.shutdown()
        self._server.server_close()
        # shutdown() only signals serve_forever; without the join the
        # acceptor thread can still be mid-poll when the caller tears
        # down the process state it reads.
        try:
            self._thread.join(timeout=5.0)
        except RuntimeError:
            pass  # stop() before start(): nothing to join


class KVClient(KVStore):
    """Socket client for :class:`KVServer` (or the JAX package's coordd).

    Read-only ops (get/events/keys/ping) share ONE persistent connection
    under a lock — metric pollers and event listeners issue these every
    few seconds, and per-request connects were pure overhead; a stale
    pooled socket is dropped and the (idempotent) request retried once.
    Blocking `wait` calls get a dedicated connection each (they can park
    for minutes and would serialize everyone else), and mutating ops
    (put/incr/del/shutdown) also use fresh connections: retrying them
    after a mid-reply failure could apply the mutation twice (duplicate
    event-log entries, double-incremented rank tickets).
    """

    def __init__(
        self,
        endpoint: str,
        connect_timeout: float = 30.0,
        read_timeout: Optional[float] = None,
    ) -> None:
        host, _, port = endpoint.rpartition(":")
        self._addr = (host or "127.0.0.1", int(port))
        self._connect_timeout = connect_timeout
        # Reply-wait bound for the idempotent pooled reads (retried once on
        # a fresh connection, so a bounded timeout is safe for them —
        # unlike mutations). Generous default: it only needs to beat a
        # silent network partition, not a busy server.
        if read_timeout is None:
            read_timeout = float(
                os.environ.get("TPU_YARN_KV_READ_TIMEOUT", "300")
            )
        self._read_timeout = read_timeout if read_timeout > 0 else None
        self._lock = threading.Lock()
        self._sock: Optional[socket.socket] = None

    def _connect(self) -> socket.socket:
        sock = socket.create_connection(
            self._addr, timeout=self._connect_timeout
        )
        # Keepalive on every connection: mutations and waits keep unbounded
        # reply waits (see _request), so a silently-dead peer must
        # eventually surface as ECONNRESET via probe failures instead of
        # hanging the caller forever.
        sock.setsockopt(socket.SOL_SOCKET, socket.SO_KEEPALIVE, 1)
        for opt, val in (
            ("TCP_KEEPIDLE", 60), ("TCP_KEEPINTVL", 30), ("TCP_KEEPCNT", 6),
        ):
            if hasattr(socket, opt):  # linux; other platforms keep defaults
                sock.setsockopt(socket.IPPROTO_TCP, getattr(socket, opt), val)
        return sock

    @property
    def endpoint(self) -> str:
        return f"{self._addr[0]}:{self._addr[1]}"

    def close(self) -> None:
        with self._lock:
            self._drop_pooled_locked()

    def _drop_pooled_locked(self) -> None:
        if self._sock is not None:
            try:
                self._sock.close()
            except OSError:
                pass
            self._sock = None

    def _roundtrip(self, sock: socket.socket, req: dict) -> dict:
        _send_frame(sock, req)
        return _recv_frame(sock)

    _POOLED_OPS = frozenset({"get", "events", "keys", "ping"})

    def _request(self, req: dict, timeout: Optional[float] = None) -> dict:
        op = req.get("op")
        if op not in self._POOLED_OPS:
            # `wait` may block server-side until the key appears (socket
            # timeout must outlive it); mutations must be at-most-once, so
            # no pooled-socket reuse/retry for them either.
            sock = self._connect()
            try:
                if op == "wait":
                    # Must outlive the server-side wait (None = unbounded).
                    sock.settimeout(None if timeout is None else timeout + 5.0)
                else:
                    # Mutations: connect was bounded above, but the reply
                    # wait must be unbounded — a timeout mid-reply leaves
                    # "was it applied?" unanswerable (the double-apply
                    # hazard retries would have), e.g. a multi-MB put to a
                    # briefly stalled server.
                    sock.settimeout(None)
                reply = self._roundtrip(sock, req)
            finally:
                sock.close()
        else:
            with self._lock:
                reply = None
                for attempt in (0, 1):
                    if self._sock is None:
                        self._sock = self._connect()
                        # Reads are idempotent and retried once, so a
                        # bounded reply wait is safe for them — a
                        # stalled-but-connected server or silent partition
                        # must not park a worker here forever (a worker
                        # stuck in a KV read never reaches the preemption
                        # drain poll). socket.timeout is an OSError:
                        # handled by the drop-and-retry below.
                        self._sock.settimeout(self._read_timeout)
                    try:
                        reply = self._roundtrip(self._sock, req)
                        break
                    except (ConnectionError, OSError):
                        # Stale pooled socket (server restart, idle
                        # reset) or read timeout: drop it; these ops are
                        # idempotent, so retry once on a fresh connection.
                        self._drop_pooled_locked()
                        if attempt:
                            raise
                    except Exception:
                        # Framing/parse failure mid-stream: the socket may
                        # hold unread bytes — never reuse it.
                        self._drop_pooled_locked()
                        raise
        if not reply.get("ok"):
            if reply.get("timeout"):
                raise KVTimeoutError(reply.get("error", "wait timed out"))
            raise RuntimeError(f"coordination error: {reply.get('error')}")
        return reply

    def put(self, key: str, value: bytes) -> None:
        self._request({"op": "put", "key": key, "value": _b64e(value)})

    def get(self, key: str) -> Optional[bytes]:
        raw = self._request({"op": "get", "key": key}).get("value")
        return None if raw is None else _b64d(raw)

    def wait(self, key: str, timeout: Optional[float] = None) -> bytes:
        reply = self._request(
            {"op": "wait", "key": key, "timeout": timeout}, timeout=timeout
        )
        return _b64d(reply["value"])

    def events(self, since: int = 0) -> Tuple[List[Tuple[int, str]], int]:
        reply = self._request({"op": "events", "since": since})
        return [(int(i), str(k)) for i, k in reply["events"]], int(reply["next"])

    def keys(self, prefix: str = "") -> List[str]:
        return list(self._request({"op": "keys", "prefix": prefix})["keys"])

    def incr(self, key: str, amount: int = 1) -> int:
        return int(self._request({"op": "incr", "key": key, "amount": amount})["value"])

    def delete(self, key: str) -> None:
        self._request({"op": "del", "key": key})

    def ping(self) -> str:
        return str(self._request({"op": "ping"}).get("server", "?"))

    def shutdown_server(self) -> None:
        try:
            self._request({"op": "shutdown"})
        except (ConnectionError, OSError):
            pass

