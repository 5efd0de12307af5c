"""Host-to-host bucket exchange: the per-step all-to-all of byte blobs that
the host-sharded engine runs beside the device group.

Port of ``deeprec_tpu/parallel/host_exchange.py``. Each rank ships the id
buckets its requester slice routed to the other ranks' table shards and
receives the buckets for its own shard, so its resolver can assign slots
one step ahead of the device (the reference's StarServer pull/push role,
one length-prefixed frame per peer per step instead of per-key RPCs).

Transport: a full TCP mesh apart from the ``torch.distributed`` group.
Rank p accepts connections from every q > p and dials every q < p; frames
are ``[u64 seq][u64 len][payload]``. Each rank binds a listening socket
and advertises ``host:port`` through the group's c10d store
(``multihost.store``), the host taken from the rendezvous the group joined
(``multihost.advertise_host``), never from an environment variable.

Deadline semantics: the engine wants the exchange finished while the
device runs the previous step. ``deadline_ms`` is a soft deadline: a late
frame is still waited for, but ``late_steps`` counts the step (the
collection's ``host_health`` reports it as ``exchange_late_steps``). A
dead peer raises after the hard timeout of 60 s.
"""
from __future__ import annotations

import itertools
import socket
import struct
import threading
import time
from typing import List, Optional

from . import multihost

_HDR = struct.Struct("<QQ")
_HARD_TIMEOUT_S = 60.0
_instances = itertools.count()  # every rank forms its exchanges in order


class HostBucketExchange:
    """Per-step all-to-all of byte blobs between the ranks of ``axis``."""

    def __init__(self, axis, tag: str, deadline_ms: float = 0.0):
        self.nproc = axis.size
        self.pid = axis.rank
        self.deadline_ms = float(deadline_ms)
        self.late_steps = 0
        self.address = None  # the host:port this rank advertised
        self._seq = 0
        self._socks: List[Optional[socket.socket]] = [None] * self.nproc
        if self.nproc == 1:
            return
        kv = multihost.store()
        prefix = f"deeprec/hx/{tag}/{next(_instances)}"
        srv = socket.create_server(("0.0.0.0", 0))
        srv.listen(self.nproc)
        self.address = f"{multihost.advertise_host()}:{srv.getsockname()[1]}"
        kv.set(f"{prefix}/{self.pid}", self.address)
        n_accept = self.nproc - 1 - self.pid

        def _accept():
            for _ in range(n_accept):
                conn, _ = srv.accept()
                conn.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)
                peer = struct.unpack("<Q", _recvn(conn, 8))[0]
                self._socks[peer] = conn

        acc = threading.Thread(target=_accept, daemon=True)
        acc.start()
        for q in range(self.pid):  # the store's get blocks until q has set
            host, p = kv.get(f"{prefix}/{q}").decode().rsplit(":", 1)
            sk = socket.create_connection((host, int(p)),
                                          timeout=_HARD_TIMEOUT_S)
            sk.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)
            sk.settimeout(None)
            sk.sendall(struct.pack("<Q", self.pid))
            self._socks[q] = sk
        acc.join(timeout=_HARD_TIMEOUT_S)
        srv.close()
        if any(self._socks[q] is None
               for q in range(self.nproc) if q != self.pid):
            raise RuntimeError("host-exchange mesh failed to form")

    def all_to_all(self, blobs: List[bytes]) -> List[Optional[bytes]]:
        """Send ``blobs[q]`` to rank q; return what each q sent here
        (``None`` at this rank's own index, whose blob is ignored)."""
        if self.nproc == 1:
            return [None]
        seq = self._seq
        self._seq += 1
        t0 = time.perf_counter()

        def _send(q):
            self._socks[q].sendall(_HDR.pack(seq, len(blobs[q])) + blobs[q])

        senders = []
        for q in range(self.nproc):
            if q != self.pid:
                t = threading.Thread(target=_send, args=(q,), daemon=True)
                t.start()
                senders.append(t)
        out: List[Optional[bytes]] = [None] * self.nproc
        for q in range(self.nproc):
            if q == self.pid:
                continue
            sk = self._socks[q]
            sk.settimeout(_HARD_TIMEOUT_S)
            rseq, ln = _HDR.unpack(_recvn(sk, _HDR.size))
            if rseq != seq:
                raise RuntimeError(
                    f"host-exchange desync with rank {q}: got seq {rseq}, "
                    f"expected {seq}")
            out[q] = _recvn(sk, ln)
        for t in senders:
            t.join(timeout=_HARD_TIMEOUT_S)
        if self.deadline_ms and \
                (time.perf_counter() - t0) * 1e3 > self.deadline_ms:
            self.late_steps += 1
        return out

    def close(self):
        for sk in self._socks:
            if sk is not None:
                try:
                    sk.close()
                except OSError:
                    pass
        self._socks = [None] * self.nproc


def _recvn(sk: socket.socket, n: int) -> bytes:
    buf = bytearray(n)
    view = memoryview(buf)
    got = 0
    while got < n:
        r = sk.recv_into(view[got:], n - got)
        if not r:
            raise ConnectionError("host-exchange peer closed")
        got += r
    return bytes(buf)
