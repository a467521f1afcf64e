"""Network KV backend for the elastic manager — the etcd stand-in.
(Copy of ``paddlebox_tpu/distributed/kv_server.py``; the wire protocol
is the reference's byte for byte, so a client of either package talks to
a server of the other.)

Reference: fleet elastic uses an etcd cluster for host leases, scale
events and the checkpoint pointer (fleet/elastic/manager.py:131 lease +
watch, :248-250 endpoints). The ElasticManager speaks
the tiny :class:`~paddlebox_tpu_torch.distributed.elastic.KVStore` interface
(put/get/delete/list_prefix/mtime — leases are heartbeat keys + mtime,
watches are polls), so a single-process TCP server covers the whole
contract without a shared filesystem: run :class:`KVServer` anywhere
reachable (e.g. alongside rank 0 or a scheduler), point every host's
:class:`TcpKVStore` at it.

Wire protocol (length-framed, one request per connection round):
  request : op u8 | klen u32 | key | vlen u64 | value
  response: ok u8 | vlen u64 | value
ops: 1=PUT 2=GET 3=DEL 4=LIST(prefix) 5=MTIME 6=TOUCH. LIST value =
repeated [klen u32 | key | vlen u64 | value]; MTIME value = the entry's
AGE in seconds as f64 (server now − write stamp) — ages, not absolute
timestamps, so lease liveness is immune to cross-host clock skew. TOUCH
refreshes the stamp without rewriting the payload (the heartbeat op);
its value is 1 byte: 1=refreshed, 0=key gone (lease was deleted)."""

from __future__ import annotations

import socket
import struct
import threading
import time
from typing import Dict, Optional, Tuple

from paddlebox_tpu_torch.distributed.elastic import KVStore
from paddlebox_tpu_torch.distributed.shuffle import _recv_exact
from paddlebox_tpu_torch.utils.logging import get_logger

log = get_logger(__name__)

_PUT, _GET, _DEL, _LIST, _MTIME, _TOUCH = 1, 2, 3, 4, 5, 6
_MAX_KEY = 1 << 16   # sanity caps: elastic keys/payloads are tiny;
_MAX_VAL = 1 << 26   # anything bigger is a stray/garbage connection
_VERY_OLD = 1e12     # age reported for missing keys


class KVServer:
    """Threaded in-memory KV server (one handler thread per connection;
    dict + lock — elastic traffic is heartbeats, not a datastore)."""

    def __init__(self, host: str = "127.0.0.1", port: int = 0) -> None:
        self._data: Dict[str, Tuple[bytes, float]] = {}
        self._lock = threading.Lock()
        self._closed = False
        self._srv = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
        self._srv.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
        self._srv.bind((host, port))
        self._srv.listen(64)
        self._thread = threading.Thread(target=self._accept_loop,
                                        daemon=True, name="kv-server")
        self._thread.start()

    @property
    def endpoint(self) -> str:
        h, p = self._srv.getsockname()
        return f"{h}:{p}"

    def close(self) -> None:
        self._closed = True
        try:
            self._srv.close()
        except OSError:
            pass

    def _accept_loop(self) -> None:
        while not self._closed:
            try:
                conn, _ = self._srv.accept()
            except OSError:
                return
            threading.Thread(target=self._handle, args=(conn,),
                             daemon=True).start()

    def _handle(self, conn: socket.socket) -> None:
        try:
            with conn:
                # reap half-open dead peers without an idle cap: keepalive
                # probes detect a power-failed/partitioned client, while a
                # quiet-but-alive TcpKVStore connection (poll cadence can
                # exceed any fixed idle timeout) is never dropped
                conn.setsockopt(socket.SOL_SOCKET, socket.SO_KEEPALIVE, 1)
                tuned_keepalive = False
                # linux spelling, then the macOS one (TCP_KEEPALIVE is
                # its idle-seconds knob) — tuned keepalive means a dead
                # peer is probed within ~2 min instead of the OS default
                # first probe at ~2h
                if hasattr(socket, "TCP_KEEPIDLE"):
                    conn.setsockopt(socket.IPPROTO_TCP,
                                    socket.TCP_KEEPIDLE, 60)
                    tuned_keepalive = True
                elif hasattr(socket, "TCP_KEEPALIVE"):
                    conn.setsockopt(socket.IPPROTO_TCP,
                                    socket.TCP_KEEPALIVE, 60)
                    tuned_keepalive = True
                if tuned_keepalive:
                    if hasattr(socket, "TCP_KEEPINTVL"):
                        conn.setsockopt(socket.IPPROTO_TCP,
                                        socket.TCP_KEEPINTVL, 15)
                    if hasattr(socket, "TCP_KEEPCNT"):
                        conn.setsockopt(socket.IPPROTO_TCP,
                                        socket.TCP_KEEPCNT, 4)
                # without ANY idle tuning, cap idle generously so a dead
                # peer can't pin this handler thread for hours; the cost
                # is that a quiet-but-alive client slower than the cap
                # reconnects (logged as idle, not as garbage)
                idle_timeout = None if tuned_keepalive else 900.0
                while True:
                    # idle between requests: tuned keepalive (above) owns
                    # dead-peer reaping with no idle cap — a quiet-but-alive
                    # TcpKVStore connection (poll cadence can exceed any
                    # fixed idle timeout) is never dropped on tuned
                    # platforms
                    conn.settimeout(idle_timeout)
                    try:
                        hdr = conn.recv(1)
                    except socket.timeout:
                        log.info("kv server: closing idle connection "
                                 "(>%.0fs, untuned-keepalive platform)",
                                 idle_timeout)
                        return
                    if not hdr:
                        return
                    # mid-request: a short timeout so a half-written
                    # request can't wedge the handler thread
                    conn.settimeout(30.0)
                    op = hdr[0]
                    (klen,) = struct.unpack("<I", _recv_exact(conn, 4))
                    if not _PUT <= op <= _TOUCH or klen > _MAX_KEY:
                        raise ValueError(f"bad kv request op={op}")
                    key = _recv_exact(conn, klen).decode("utf-8")
                    (vlen,) = struct.unpack("<Q", _recv_exact(conn, 8))
                    if vlen > _MAX_VAL:
                        raise ValueError(f"kv value too large ({vlen})")
                    value = _recv_exact(conn, vlen) if vlen else b""
                    resp = self._apply(op, key, value)
                    conn.sendall(b"\x01" + struct.pack("<Q", len(resp))
                                 + resp)
        except (OSError, ConnectionError, struct.error, ValueError,
                UnicodeDecodeError) as e:
            # garbage connections are dropped, never crash the handler
            log.warning("kv server: dropped bad connection (%s)", e)

    def _apply(self, op: int, key: str, value: bytes) -> bytes:
        with self._lock:
            if op == _PUT:
                self._data[key] = (value, time.time())
                return b""
            if op == _GET:
                ent = self._data.get(key)
                return b"\x00" if ent is None else b"\x01" + ent[0]
            if op == _DEL:
                self._data.pop(key, None)
                return b""
            if op == _LIST:
                parts = []
                for k, (v, _) in self._data.items():
                    if k.startswith(key):
                        kb = k.encode("utf-8")
                        parts.append(struct.pack("<I", len(kb)) + kb
                                     + struct.pack("<Q", len(v)) + v)
                return b"".join(parts)
            if op == _MTIME:
                ent = self._data.get(key)
                age = (time.time() - ent[1]) if ent else _VERY_OLD
                return struct.pack("<d", age)
            if op == _TOUCH:
                ent = self._data.get(key)
                if ent is None:
                    return b"\x00"
                self._data[key] = (ent[0], time.time())
                return b"\x01"
        raise ValueError(f"bad kv op {op}")


class TcpKVStore(KVStore):
    """KVStore client against a :class:`KVServer` endpoint — drop-in for
    FileKVStore, no shared filesystem needed. One persistent connection
    per store (heartbeat cadence), reconnects on failure."""

    def __init__(self, endpoint: str, timeout: float = 10.0) -> None:
        host, port = endpoint.rsplit(":", 1)
        self._addr = (host, int(port))
        self._timeout = timeout
        self._conn: Optional[socket.socket] = None
        self._lock = threading.Lock()

    def close(self) -> None:
        with self._lock:
            self._close_locked()

    def _close_locked(self) -> None:
        if self._conn is not None:
            try:
                self._conn.close()
            except OSError:
                pass
            self._conn = None

    def _request(self, op: int, key: str, value: bytes = b"") -> bytes:
        kb = key.encode("utf-8")
        msg = (bytes([op]) + struct.pack("<I", len(kb)) + kb
               + struct.pack("<Q", len(value)) + value)
        with self._lock:
            for attempt in (0, 1):  # one reconnect on a stale socket
                try:
                    if self._conn is None:
                        self._conn = socket.create_connection(
                            self._addr, timeout=self._timeout)
                    self._conn.sendall(msg)
                    ok = _recv_exact(self._conn, 1)
                    (vlen,) = struct.unpack(
                        "<Q", _recv_exact(self._conn, 8))
                    body = _recv_exact(self._conn, vlen) if vlen else b""
                    if ok != b"\x01":
                        raise ConnectionError("kv server error")
                    return body
                except (OSError, ConnectionError):
                    self._close_locked()
                    if attempt:
                        raise
        raise ConnectionError("unreachable")  # pragma: no cover

    def put(self, key: str, value: bytes) -> None:
        self._request(_PUT, key, value)

    def get(self, key: str) -> Optional[bytes]:
        body = self._request(_GET, key)
        return None if body[:1] == b"\x00" else body[1:]

    def delete(self, key: str) -> None:
        self._request(_DEL, key)

    def list_prefix(self, prefix: str) -> Dict[str, bytes]:
        body = self._request(_LIST, prefix)
        out: Dict[str, bytes] = {}
        pos = 0
        while pos < len(body):
            (klen,) = struct.unpack_from("<I", body, pos)
            pos += 4
            k = body[pos:pos + klen].decode("utf-8")
            pos += klen
            (vlen,) = struct.unpack_from("<Q", body, pos)
            pos += 8
            out[k] = body[pos:pos + vlen]
            pos += vlen
        return out

    def mtime(self, key: str) -> float:
        """Write time in THIS host's clock: the server reports the
        entry's AGE and we subtract locally, so lease checks
        (now − mtime ≤ ttl) are immune to cross-host clock skew."""
        (age,) = struct.unpack("<d", self._request(_MTIME, key))
        return max(time.time() - age, 0.0)

    def touch(self, key: str) -> bool:
        """Refresh the lease stamp server-side without resending the
        payload — the heartbeat op; False when the lease was deleted."""
        return self._request(_TOUCH, key) == b"\x01"
