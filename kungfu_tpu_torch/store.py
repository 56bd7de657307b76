"""P2P versioned blob store: host-side model exchange between peers
(counterpart of kungfu_tpu.store).

Re-design of the reference's store + p2p endpoint (srcs/go/store/{store,
versionedstore}.go and srcs/go/rchannel/handler/p2p.go): every peer runs a
tiny TCP service holding named blobs; `save` publishes this peer's (fused)
model, `request` pulls a blob from any other peer by name: the transport
under the asynchronous gossip (optimizers/gossip.py HostPairAveraging).

This is not the data plane: gradient reductions ride the process group
and the ring kernels.  The store carries what they cannot: a remote,
possibly stale model version, pulled outside the step.

Wire protocol (length-prefixed, big-endian), byte for byte the JAX
package's, so either package's client talks to either's server:
  request:  op:u8  ver_len:u32 ver  name_len:u32 name  payload_len:u64 payload
  response: status:u8  payload_len:u64 payload
ops: 1=SAVE(blob to target's store), 2=REQUEST(blob from target's store),
3=PING.  A blob's payload is `meta_len:u32 "dtype;shape" data` (`Blob`).
The versioned store keeps a sliding window of the last 3 versions
(versionedstore.go:19-56).

The JAX package counts each direction's bytes at the transport for its
monitoring endpoint (kungfu_tpu/store.py:41-50); the port's counters come
with ROADMAP A.8, and until then the store counts nothing.
"""
from __future__ import annotations

import socket
import socketserver
import struct
import threading
import time
from typing import Dict, Optional, Tuple

import numpy as np

from .plan import PeerID
from .utils import get_logger
from .utils.ports import bind_when_free

log = get_logger("kungfu.store")

# store listens on worker_port + offset.  Default worker ports are
# 10000-10999 (plan), putting stores at 25000-25999: below Linux's default
# ephemeral range (32768+).  A host whose range starts lower can have an
# outbound socket on one, which the bind waits out (utils.ports).
STORE_PORT_OFFSET = 15000


def store_port(worker_port: int) -> int:
    p = worker_port + STORE_PORT_OFFSET
    if not (0 < p <= 65535):
        raise ValueError(
            f"worker port {worker_port} leaves no room for the store port "
            f"(+{STORE_PORT_OFFSET} exceeds 65535); pick worker ports <= 50535"
        )
    return p


WINDOW_SIZE = 3  # last-3-versions GC window (reference p2p.go:11)

_OP_SAVE = 1
_OP_REQUEST = 2
_OP_PING = 3
_ST_OK = 0
_ST_NOT_FOUND = 1


class Blob:
    """A named byte buffer + dtype/shape sidecar for numpy round-trips.

    shape=None means a raw flat buffer (no reshape on read); shape=() is a
    genuine 0-d scalar and round-trips as such.
    """

    def __init__(self, data: bytes, dtype: str = "u1",
                 shape: Optional[Tuple[int, ...]] = None):
        self.data = data
        self.dtype = dtype
        self.shape = shape

    @classmethod
    def from_array(cls, arr: np.ndarray) -> "Blob":
        # NOT ascontiguousarray: it silently promotes 0-d scalars to 1-d
        arr = np.asarray(arr, order="C")
        return cls(arr.tobytes(), arr.dtype.str, arr.shape)

    def to_array(self) -> np.ndarray:
        # copy: frombuffer views are read-only, but callers aggregate into
        # received blobs in place (native.transform2/average_f32)
        a = np.frombuffer(self.data, dtype=np.dtype(self.dtype)).copy()
        return a if self.shape is None else a.reshape(self.shape)

    # sidecar is serialized into the payload header so remote blobs
    # reconstruct with dtype+shape intact ("*" marks a raw flat buffer)
    def pack(self) -> bytes:
        shape_s = "*" if self.shape is None else ",".join(map(str, self.shape))
        meta = f"{self.dtype};{shape_s}".encode()
        return struct.pack(">I", len(meta)) + meta + self.data

    @classmethod
    def unpack(cls, payload) -> "Blob":
        """The blob of a packed payload; its data is a view of `payload`."""
        (mlen,) = struct.unpack(">I", payload[:4])
        meta = bytes(payload[4 : 4 + mlen]).decode()
        dtype, shape_s = meta.split(";")
        shape = None if shape_s == "*" else tuple(int(x) for x in shape_s.split(",") if x)
        return cls(memoryview(payload)[4 + mlen :], dtype, shape)


class Store:
    """Named blob store (reference store/store.go)."""

    def __init__(self):
        self._blobs: Dict[str, Blob] = {}
        self._lock = threading.RLock()

    def save(self, name: str, blob: Blob) -> None:
        with self._lock:
            self._blobs[name] = blob

    def get(self, name: str) -> Optional[Blob]:
        with self._lock:
            return self._blobs.get(name)

    def names(self):
        with self._lock:
            return sorted(self._blobs)


class VersionedStore:
    """Sliding-window versioned store (reference store/versionedstore.go:19-56)."""

    def __init__(self, window: int = WINDOW_SIZE):
        self._versions: Dict[str, Store] = {}
        self._order: list = []
        self._window = window
        self._lock = threading.RLock()

    def save(self, version: str, name: str, blob: Blob) -> None:
        with self._lock:
            if version not in self._versions:
                self._versions[version] = Store()
                self._order.append(version)
                while len(self._order) > self._window:
                    dead = self._order.pop(0)
                    del self._versions[dead]
            self._versions[version].save(name, blob)

    def get(self, version: str, name: str) -> Optional[Blob]:
        with self._lock:
            st = self._versions.get(version)
        return st.get(name) if st is not None else None

    def latest(self, name: str) -> Optional[Blob]:
        with self._lock:
            for version in reversed(self._order):
                b = self._versions[version].get(name)
                if b is not None:
                    return b
        return None


def poll_until(fn, wait: bool = True, deadline: float = 0.0, interval: float = 0.02):
    """Call fn() until it returns non-None (the shared Request wait loop;
    reference p2p.go:37-49 blocks the same way).  Non-wait mode tries once."""
    while True:
        got = fn()
        if got is not None or not wait or time.monotonic() > deadline:
            return got
        time.sleep(interval)


def _read_exact(sock: socket.socket, n: int) -> bytearray:
    """n bytes into one buffer allocated once: a blob of several GiB (a
    buddy snapshot) is received without a copy."""
    buf = bytearray(n)
    view = memoryview(buf)
    got = 0
    while got < n:
        k = sock.recv_into(view[got:], min(1 << 20, n - got))
        if not k:
            raise ConnectionError("peer closed")
        got += k
    return buf


def _read_frame(sock) -> Tuple[int, str, str, bytes]:
    op = _read_exact(sock, 1)[0]
    (vlen,) = struct.unpack(">I", _read_exact(sock, 4))
    version = _read_exact(sock, vlen).decode() if vlen else ""
    (nlen,) = struct.unpack(">I", _read_exact(sock, 4))
    name = _read_exact(sock, nlen).decode()
    (plen,) = struct.unpack(">Q", _read_exact(sock, 8))
    payload = _read_exact(sock, plen) if plen else b""
    return op, version, name, payload


def _write_frame(sock, op: int, version: str, name: str, payload) -> None:
    """One frame; `payload` is bytes, or a tuple of buffers sent one after
    the other (a large array's bytes go out without being copied)."""
    parts = payload if isinstance(payload, tuple) else (payload,)
    v, nm = version.encode(), name.encode()
    sock.sendall(
        struct.pack(">BI", op, len(v)) + v
        + struct.pack(">I", len(nm)) + nm
        + struct.pack(">Q", sum(memoryview(p).nbytes for p in parts))
    )
    for p in parts:
        sock.sendall(p)


class StoreServer:
    """Per-peer TCP blob service (the PeerToPeerEndpoint analog, p2p.go:99-122)."""

    def __init__(self, host: str = "127.0.0.1", port: int = 0):
        self.store = Store()
        self.versioned = VersionedStore()
        outer = self

        class Handler(socketserver.BaseRequestHandler):
            def handle(self):
                try:
                    while True:
                        op, version, name, payload = _read_frame(self.request)
                        if op == _OP_SAVE:
                            blob = Blob.unpack(payload)
                            if version:
                                outer.versioned.save(version, name, blob)
                            else:
                                outer.store.save(name, blob)
                            self.request.sendall(struct.pack(">BQ", _ST_OK, 0))
                        elif op == _OP_PING:
                            self.request.sendall(struct.pack(">BQ", _ST_OK, 0))
                        elif op == _OP_REQUEST:
                            blob = (
                                outer.versioned.get(version, name)
                                if version
                                else outer.store.get(name)
                            )
                            if blob is None:
                                self.request.sendall(struct.pack(">BQ", _ST_NOT_FOUND, 0))
                            else:
                                head = Blob(b"", blob.dtype, blob.shape).pack()
                                self.request.sendall(struct.pack(
                                    ">BQ", _ST_OK, len(head) + memoryview(blob.data).nbytes)
                                    + head)
                                self.request.sendall(blob.data)
                        else:
                            return
                except (ConnectionError, OSError):
                    return

        class Server(socketserver.ThreadingTCPServer):
            allow_reuse_address = True
            daemon_threads = True

        self._srv = bind_when_free(lambda: Server((host, port), Handler), port, host,
                                   "the blob store")
        self.host, self.port = self._srv.server_address[:2]
        self._thread = threading.Thread(target=self._srv.serve_forever, daemon=True)

    def start(self) -> "StoreServer":
        self._thread.start()
        log.debug("store server on %s:%d", self.host, self.port)
        return self

    # local fast paths (no socket round-trip for self access)
    def save(self, name: str, arr: np.ndarray, version: str = "") -> None:
        blob = Blob.from_array(arr)
        if version:
            self.versioned.save(version, name, blob)
        else:
            self.store.save(name, blob)

    def get(self, name: str, version: str = "") -> Optional[np.ndarray]:
        blob = self.versioned.get(version, name) if version else self.store.get(name)
        return blob.to_array() if blob is not None else None

    def close(self) -> None:
        self._srv.shutdown()
        self._srv.server_close()


class StoreClient:
    """Pooled client to other peers' stores (reference rchannel/client pattern:
    one cached connection per target, auto-reconnect with bounded retries —
    connection/config.go:16-19 uses 500x200ms; scaled down here)."""

    # bound on a deadline-less round-trip: a connected-but-hung peer (the
    # bad_worker hang failure mode) must fail fast, never block forever
    DEFAULT_OP_TIMEOUT = 5.0

    def __init__(self, retries: int = 50, retry_interval: float = 0.1,
                 op_timeout: Optional[float] = None):
        self._conns: Dict[Tuple[str, int], socket.socket] = {}
        self._locks: Dict[Tuple[str, int], threading.Lock] = {}
        self._retries = retries
        self._interval = retry_interval
        self._op_timeout = (
            self.DEFAULT_OP_TIMEOUT if op_timeout is None else op_timeout
        )
        self._global_lock = threading.Lock()

    def _endpoint(self, peer: PeerID) -> Tuple[str, int]:
        return (peer.host, store_port(peer.port))

    def _connect(self, ep: Tuple[str, int], retries: Optional[int] = None,
                 deadline: Optional[float] = None) -> socket.socket:
        last = None
        for _ in range(retries if retries is not None else self._retries):
            if deadline is not None and time.monotonic() > deadline:
                break
            try:
                # short per-attempt connect timeout so the caller's deadline
                # is honored even while the peer host is dropping SYNs
                return socket.create_connection(ep, timeout=5)
            except OSError as e:
                last = e
                time.sleep(self._interval)
        raise ConnectionError(f"cannot reach store at {ep}: {last}")

    def _with_conn(self, peer: PeerID):
        ep = self._endpoint(peer)
        with self._global_lock:
            lock = self._locks.setdefault(ep, threading.Lock())
        return ep, lock

    def _roundtrip(self, peer: PeerID, op: int, version: str, name: str,
                   payload: bytes, connect_retries: Optional[int] = None,
                   deadline: Optional[float] = None):
        ep, lock = self._with_conn(peer)
        with lock:
            sock = self._conns.get(ep)
            for attempt in (0, 1):  # one transparent reconnect on stale pool conn
                if sock is None:
                    sock = self._connect(ep, retries=connect_retries, deadline=deadline)
                    self._conns[ep] = sock
                # the caller's deadline must bound the round-trip itself, not
                # just connection establishment: a connected-but-hung peer
                # would otherwise block for the socket's default timeout
                if deadline is not None:
                    remaining = deadline - time.monotonic()
                    if remaining <= 0:
                        raise ConnectionError(f"deadline exceeded for {ep}")
                    sock.settimeout(remaining)
                else:
                    sock.settimeout(self._op_timeout)
                try:
                    _write_frame(sock, op, version, name, payload)
                    status, plen = struct.unpack(">BQ", _read_exact(sock, 9))
                    body = _read_exact(sock, plen) if plen else b""
                    return status, body
                except (ConnectionError, OSError):
                    sock.close()
                    self._conns.pop(ep, None)
                    sock = None
                    if attempt:
                        raise
        raise ConnectionError(f"store roundtrip to {ep} failed")

    def save(self, peer: PeerID, name: str, arr: np.ndarray, version: str = "") -> None:
        """Push a blob into a remote peer's store; the array's bytes go out
        as they are, without a copy."""
        arr = np.asarray(arr, order="C")
        head = Blob(b"", arr.dtype.str, arr.shape).pack()
        self._roundtrip(peer, _OP_SAVE, version, name, (head, arr.reshape(-1).view(np.uint8)))

    def ping(self, peer: PeerID, timeout: float = 5.0) -> float:
        """Round-trip time to the peer's store in seconds (reference
        client.Ping, rchannel/client/client.go:29-44)."""
        t0 = time.perf_counter()
        status, _ = self._roundtrip(
            peer, _OP_PING, "", "", b"",
            deadline=time.monotonic() + timeout,
        )
        if status != _ST_OK:
            raise ConnectionError(f"ping to {peer} failed: status {status}")
        return time.perf_counter() - t0

    def request(
        self, peer: PeerID, name: str, version: str = "",
        wait: bool = True, timeout: float = 30.0,
    ) -> Optional[np.ndarray]:
        """Pull `name` from `peer`'s store.

        With wait=True, polls until the blob exists (the reference Request
        blocks until the remote answers, p2p.go:37-49).  With wait=False an
        unreachable peer — e.g. its store server hasn't started yet — is a
        miss (None), not an error: async gossip never waits for a partner.
        """
        deadline = time.monotonic() + timeout

        def attempt():
            try:
                status, body = self._roundtrip(
                    peer, _OP_REQUEST, version, name, b"",
                    connect_retries=None if wait else 1, deadline=deadline,
                )
            except (ConnectionError, OSError):
                return None
            return Blob.unpack(body).to_array() if status == _ST_OK else None

        return poll_until(attempt, wait=wait, deadline=deadline)

    def close(self) -> None:
        with self._global_lock:
            for s in self._conns.values():
                try:
                    s.close()
                except OSError:
                    pass
            self._conns.clear()
