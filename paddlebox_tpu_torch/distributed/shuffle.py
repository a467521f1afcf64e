"""Cross-host global-shuffle transport — the ``PaddleShuffler`` analogue.
(Copy of ``paddlebox_tpu/distributed/shuffle.py``.)

Reference: PadBoxSlotDataset::ShuffleData (data_set.cc:2573): each MPI rank
routes every record to ``hash(record) % mpi_size``, serializes batches with
``BinaryArchive`` and sends them through the closed ``boxps::PaddleShuffler``
callbacks; peers collect into ``ReceiveSuffleData`` (:2681).

Here the MPI plane is a plain TCP full mesh between the hosts: the record
exchange is host-side data, never device traffic (``torch.distributed``
stays for tensors). Records travel in a compact self-describing binary
layout (no pickle on the wire), one length-framed buffer per (src, dst)
pair, byte for byte the reference's, so a rank of either package can
take part in the other's mesh. The route hash is deterministic in
(uid | ins_id | record content, seed) so every rank computes the same
placement without coordination.
"""

from __future__ import annotations

import socket
import struct
import threading
import time
import zlib
from typing import Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np

from paddlebox_tpu_torch.data.dataset import Shuffler
from paddlebox_tpu_torch.data.record import SlotRecord
from paddlebox_tpu_torch.utils.logging import get_logger

log = get_logger(__name__)

_REC_HDR = struct.Struct("<iiii fff qqq ii")  # see serialize_records


def serialize_records(records: Sequence[SlotRecord]) -> bytes:
    """Records → one compact buffer (BinaryArchive role). Layout per
    record: fixed header (counts, scalars, metadata) followed by the
    keys/slot_offsets/dense arrays and the utf-8 ins_id."""
    parts: List[bytes] = [struct.pack("<q", len(records))]
    for r in records:
        keys = np.ascontiguousarray(r.keys, dtype=np.uint64)
        offs = np.ascontiguousarray(r.slot_offsets, dtype=np.int32)
        dense = np.ascontiguousarray(r.dense, dtype=np.float32)
        ins = r.ins_id.encode("utf-8")
        parts.append(_REC_HDR.pack(
            keys.size, offs.size, dense.size, len(ins),
            float(r.label), float(r.show), float(r.clk),
            int(r.search_id), int(r.uid), int(r.timestamp),
            int(r.rank), int(r.cmatch)))
        parts += [keys.tobytes(), offs.tobytes(), dense.tobytes(), ins]
    return b"".join(parts)


def deserialize_records(buf: bytes) -> List[SlotRecord]:
    (n,) = struct.unpack_from("<q", buf, 0)
    pos = 8
    out: List[SlotRecord] = []
    for _ in range(n):
        (nk, ns, nd, ni, label, show, clk, sid, uid, ts, rank,
         cmatch) = _REC_HDR.unpack_from(buf, pos)
        pos += _REC_HDR.size
        keys = np.frombuffer(buf, np.uint64, nk, pos).copy()
        pos += nk * 8
        offs = np.frombuffer(buf, np.int32, ns, pos).copy()
        pos += ns * 4
        dense = np.frombuffer(buf, np.float32, nd, pos).copy()
        pos += nd * 4
        ins = buf[pos:pos + ni].decode("utf-8")
        pos += ni
        out.append(SlotRecord(keys=keys, slot_offsets=offs, dense=dense,
                              label=label, show=show, clk=clk, ins_id=ins,
                              search_id=sid, uid=uid, timestamp=ts,
                              rank=rank, cmatch=cmatch))
    return out


def default_route(rec: SlotRecord, world: int, seed: int) -> int:
    """hash(record) % world — uid first (keeps user timelines on one host
    for the WuAUC/uid-merge paths), then ins_id, then record content."""
    if rec.uid:
        h = zlib.crc32(struct.pack("<qq", rec.uid, seed))
    elif rec.ins_id:
        h = zlib.crc32(rec.ins_id.encode() + struct.pack("<q", seed))
    else:
        h = zlib.crc32(rec.keys.tobytes() + struct.pack("<q", seed))
    return h % world


def _recv_exact(conn: socket.socket, n: int) -> bytes:
    chunks = []
    while n:
        b = conn.recv(min(n, 1 << 20))
        if not b:
            raise ConnectionError("peer closed mid-message")
        chunks.append(b)
        n -= len(b)
    return b"".join(chunks)


class TcpMesh:
    """Full-mesh TCP byte exchange — the host-side data/metrics plane
    shared by the record shuffler (global shuffle) and the host
    collective (cross-worker metric allreduce, metrics.cc:288-304 role).

    ``endpoints`` — "host:port" per rank, index == rank. One
    :meth:`exchange_bytes` per round on every rank (a data barrier, like
    the reference's shuffler wait, data_set.cc:2681). A PERSISTENT
    listener thread drains peers continuously, so inter-round skew is
    bounded only by ``timeout``, never by socket buffers."""

    def __init__(self, rank: int, world: int, endpoints: Sequence[str],
                 timeout: float = 120.0) -> None:
        if len(endpoints) != world:
            raise ValueError("need one endpoint per rank")
        self.rank, self.world = rank, world
        self.endpoints = [(e.rsplit(":", 1)[0], int(e.rsplit(":", 1)[1]))
                          for e in endpoints]
        self.timeout = timeout
        self._round = 0
        # payloads stashed by (round, src). A PERSISTENT listener thread
        # accepts and drains continuously, so a fast peer's sendall never
        # blocks on our socket buffers while we are still training the
        # previous pass — inter-pass skew is bounded only by ``timeout``
        # against a genuinely dead peer, not by buffer sizes.
        self._stash: Dict[Tuple[int, int], bytes] = {}
        self._cv = threading.Condition()
        self._listen_err: Optional[BaseException] = None
        self._closed = False
        host, port = self.endpoints[rank]
        self._srv = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
        self._srv.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
        self._srv.bind((host, port))
        self._srv.listen(world)
        self._listener = threading.Thread(target=self._listen_loop,
                                          daemon=True,
                                          name=f"shuffler-r{rank}")
        self._listener.start()

    @property
    def bound_port(self) -> int:
        return self._srv.getsockname()[1]

    def close(self) -> None:
        self._closed = True
        try:
            self._srv.close()
        except OSError:
            pass

    def _listen_loop(self) -> None:
        while not self._closed:
            try:
                conn, _ = self._srv.accept()
            except OSError:
                return  # socket closed
            try:
                with conn:
                    conn.settimeout(self.timeout)
                    src, rnd, nbytes = struct.unpack(
                        "<iiq", _recv_exact(conn, 16))
                    payload = _recv_exact(conn, nbytes)
            except (OSError, ConnectionError, struct.error) as e:
                # stray probes / aborted sends are DROPPED, not fatal:
                # the listener lives for the whole process, and a health
                # check must not kill the next round (a genuinely lost
                # payload surfaces as that round's TimeoutError naming
                # the silent rank)
                log.warning("mesh listener: dropped bad connection (%s)",
                            e)
                continue
            with self._cv:
                if rnd < self._round:
                    self._listen_err = RuntimeError(
                        f"shuffle round mismatch: got stale round {rnd} "
                        f"from rank {src}, at {self._round}")
                else:
                    self._stash[(rnd, src)] = payload
                self._cv.notify_all()

    def _send_to(self, dst: int, payload: bytes,
                 errors: List[BaseException], rnd: int) -> None:
        # ``rnd`` is captured at spawn: exchange_bytes may advance
        # self._round (inbox complete) while a slow sender is still
        # writing — the stamp must stay this round's
        try:
            deadline = time.monotonic() + self.timeout
            delay = 0.05
            while True:
                try:
                    c = socket.create_connection(
                        self.endpoints[dst],
                        timeout=max(0.05, deadline - time.monotonic()))
                    break
                except socket.gaierror:
                    raise  # bad hostname — permanent, fail fast
                except OSError:
                    # peer hasn't bound its shuffler / its host or route
                    # is still coming up (ECONNREFUSED, ENETUNREACH,
                    # EHOSTUNREACH, timeouts) — retry until the deadline
                    if time.monotonic() >= deadline:
                        raise
                    time.sleep(delay)
                    delay = min(delay * 2, 1.0)
            with c:
                c.sendall(struct.pack("<iiq", self.rank, rnd,
                                      len(payload)))
                c.sendall(payload)
        except BaseException as e:
            errors.append(e)
            # wake exchange_bytes' inbox wait so a dead peer aborts the
            # round immediately instead of burning the full timeout
            with self._cv:
                self._cv.notify_all()

    def exchange_bytes(self, payloads: Dict[int, bytes]
                       ) -> Dict[int, bytes]:
        """One full-mesh round: send payloads[dst] to each peer, return
        {src: payload} for every other rank. All ranks must call once
        per round."""
        errors: List[BaseException] = []
        senders = []
        for dst in range(self.world):
            if dst == self.rank:
                continue
            t = threading.Thread(
                target=self._send_to,
                args=(dst, payloads[dst], errors, self._round),
                daemon=True)
            t.start()
            senders.append(t)
        # collect this round's payloads from the background listener while
        # the sender threads run; a send failure wakes the wait and aborts
        want = [(self._round, src) for src in range(self.world)
                if src != self.rank]
        deadline = time.monotonic() + self.timeout
        inbox: Dict[int, bytes] = {}
        with self._cv:
            while True:
                if self._listen_err is not None:
                    err, self._listen_err = self._listen_err, None
                    raise err
                if errors:
                    raise errors[0]
                for key in want:
                    if key in self._stash and key[1] not in inbox:
                        inbox[key[1]] = self._stash.pop(key)
                if len(inbox) == len(want):
                    break
                left = deadline - time.monotonic()
                if left <= 0 or not self._cv.wait(timeout=left):
                    missing = [k[1] for k in want if k[1] not in inbox]
                    raise TimeoutError(
                        f"mesh round {self._round}: no payload from "
                        f"ranks {missing} within {self.timeout}s")
            self._round += 1
        for t in senders:
            t.join()
        if errors:
            raise errors[0]
        return inbox


class TcpShuffler(TcpMesh, Shuffler):
    """Record global shuffle over the TCP mesh: rank i sends partition j
    to rank j and returns its own partition plus everything received —
    PadBoxSlotDataset::ShuffleData / ReceiveSuffleData."""

    def __init__(self, rank: int, world: int, endpoints: Sequence[str],
                 seed: int = 0,
                 route_fn: Optional[Callable[[SlotRecord, int, int], int]]
                 = None, timeout: float = 120.0) -> None:
        super().__init__(rank, world, endpoints, timeout=timeout)
        self.seed = seed
        self.route_fn = route_fn or default_route

    def exchange(self, records: List[SlotRecord]) -> List[SlotRecord]:
        parts: List[List[SlotRecord]] = [[] for _ in range(self.world)]
        for r in records:
            parts[self.route_fn(r, self.world, self.seed)].append(r)
        inbox = self.exchange_bytes(
            {dst: serialize_records(parts[dst])
             for dst in range(self.world) if dst != self.rank})
        out = list(parts[self.rank])
        kept = len(out)
        for src in sorted(inbox):
            out.extend(deserialize_records(inbox[src]))
        log.info("shuffle r%d: kept %d, received %d records", self.rank,
                 kept, len(out) - kept)
        return out

    def allgather(self, records: List[SlotRecord]) -> List[SlotRecord]:
        """Every rank returns EVERY rank's records, in rank order (rank
        0's first) with each rank's original order preserved —
        deterministic and identical on all ranks. This is the host data
        plane of multi-controller SPMD training (train/multihost.py):
        each host reads only its own file shard, then allgathers so
        every process builds byte-identical global batches and routing
        plans. O(world) duplication — intended for host-count ≪
        chip-count jobs (one process per host)."""
        blob = serialize_records(records)
        inbox = self.exchange_bytes(
            {dst: blob for dst in range(self.world)
             if dst != self.rank})
        out: List[SlotRecord] = []
        for src in range(self.world):
            if src == self.rank:
                out.extend(records)
            else:
                out.extend(deserialize_records(inbox[src]))
        log.info("allgather r%d: %d local -> %d global records",
                 self.rank, len(records), len(out))
        return out
