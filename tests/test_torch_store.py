"""The port's p2p blob store, Peer and host gossip against the JAX package's.

* every case of tests/unit/test_store.py on the port's store (its ingress
  counters aside: they wait for ROADMAP A.8), and its interop with the JAX
  package's over loopback in both directions: the port's client against
  the JAX server and the JAX client against the port's server, every
  array bit for bit;
* `Peer`: identity from the env contract, the self path's wait semantics,
  the store's port;
* `HostPairAveraging` and `OverlappedHostPairAveraging`: the two-peer
  cases of the JAX tests on in-process stores; on 4 gloo ranks over real
  TCP stores (each rank's `Peer`), the peers pulled in the order the JAX
  package's `RandomState` draws them and each mixed model bit-equal to
  the numpy average of the rank's blob and the pulled one; a pull of
  another layout of the same size skipped; `close()` keeping a queued
  publish (differences kept on purpose: the JAX package compares sizes
  only, and its close() can drop the publish).
"""
from __future__ import annotations

import gc
import textwrap
import threading
import time
import weakref

import numpy as np
import pytest
import torch

from _torch_ranks import start_ranks, wait_ranks
from _torch_reference import jax_reference
from kungfu_tpu_torch import env as kfenv
from kungfu_tpu_torch.optimizers.gossip import (HEADER, HostPairAveraging,
                                                OverlappedHostPairAveraging, layout_digest)
from kungfu_tpu_torch.peer import Peer
from kungfu_tpu_torch.plan import Cluster, PeerID, PeerList
from kungfu_tpu_torch.store import (STORE_PORT_OFFSET, Blob, Store, StoreClient, StoreServer,
                                    VersionedStore, store_port)

N = 4
HOST_STEPS = 4


@pytest.fixture(scope="module")
def ref():
    with jax_reference() as kf:
        from kungfu_tpu import store as jstore
        from kungfu_tpu.optimizers.gossip import HostPairAveraging as JaxHost

        yield jstore, JaxHost


# -- the store (tests/unit/test_store.py) ---------------------------------------

def test_blob_array_roundtrip():
    a = np.arange(12, dtype=np.float32).reshape(3, 4)
    b = Blob.unpack(Blob.from_array(a).pack()).to_array()
    np.testing.assert_array_equal(a, b)
    assert b.dtype == np.float32 and b.shape == (3, 4)


def test_blob_scalar_and_raw_roundtrip():
    s = Blob.unpack(Blob.from_array(np.array(3.5, np.float64)).pack()).to_array()
    assert s.shape == () and float(s) == 3.5
    r = Blob.unpack(Blob(b"\x01\x02\x03").pack()).to_array()
    assert r.shape == (3,)


def test_store_save_get():
    s = Store()
    s.save("x", Blob.from_array(np.ones(3)))
    assert s.get("x") is not None
    assert s.get("y") is None
    assert s.names() == ["x"]


def test_versioned_store_window_gc():
    vs = VersionedStore(window=3)
    for v in range(5):
        vs.save(str(v), "m", Blob.from_array(np.full(2, v)))
    assert vs.get("0", "m") is None and vs.get("1", "m") is None
    for v in (2, 3, 4):
        np.testing.assert_array_equal(vs.get(str(v), "m").to_array(), np.full(2, v))
    np.testing.assert_array_equal(vs.latest("m").to_array(), np.full(2, 4))


@pytest.fixture
def server():
    srv = StoreServer(host="127.0.0.1", port=0).start()
    yield srv
    srv.close()


def _peer_for(srv) -> PeerID:
    return PeerID(host="127.0.0.1", port=srv.port - STORE_PORT_OFFSET)


def test_tcp_save_request_roundtrip(server):
    client = StoreClient(retries=3, retry_interval=0.01)
    peer = _peer_for(server)
    arr = np.random.RandomState(0).randn(100, 7).astype(np.float32)
    client.save(peer, "model", arr)
    np.testing.assert_array_equal(client.request(peer, "model"), arr)
    client.close()


def test_tcp_request_missing_nowait(server):
    client = StoreClient(retries=3, retry_interval=0.01)
    assert client.request(_peer_for(server), "nope", wait=False) is None
    client.close()


def test_tcp_request_waits_for_publication(server):
    client = StoreClient(retries=3, retry_interval=0.01)
    arr = np.ones(5, np.float32)
    t = threading.Timer(0.1, lambda: server.save("late", arr))
    t.start()
    np.testing.assert_array_equal(client.request(_peer_for(server), "late", timeout=5.0), arr)
    t.join()
    client.close()


def test_tcp_versioned(server):
    client = StoreClient(retries=3, retry_interval=0.01)
    peer = _peer_for(server)
    client.save(peer, "m", np.zeros(2, np.float32), version="v1")
    client.save(peer, "m", np.ones(2, np.float32), version="v2")
    np.testing.assert_array_equal(client.request(peer, "m", version="v1"), np.zeros(2))
    np.testing.assert_array_equal(client.request(peer, "m", version="v2"), np.ones(2))
    assert client.ping(peer) > 0
    client.close()


def test_concurrent_clients(server):
    peer = _peer_for(server)
    server.save("shared", np.arange(1000, dtype=np.float32))
    errs = []

    def worker():
        try:
            c = StoreClient(retries=3, retry_interval=0.01)
            for _ in range(20):
                assert c.request(peer, "shared").shape == (1000,)
            c.close()
        except Exception as e:  # noqa: BLE001 - collected and asserted below
            errs.append(e)

    threads = [threading.Thread(target=worker) for _ in range(8)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=30)
    assert not any(t.is_alive() for t in threads) and not errs


def test_store_port_bounds():
    assert store_port(10000) == 25000
    with pytest.raises(ValueError, match="50535"):
        store_port(60000)


# -- interop with the JAX package's store ----------------------------------------

ARRAYS = {
    "f32": np.random.RandomState(1).randn(64, 3).astype(np.float32),
    "bf16_bits": np.random.RandomState(2).randint(0, 2**16, (7, 5)).astype(np.uint16),
    "i64": np.arange(-5, 6, dtype=np.int64),
    "f64_scalar": np.array(2.5, np.float64),
    "f16": np.random.RandomState(3).randn(9).astype(np.float16),
}


@pytest.mark.parametrize("direction", ["port_client_jax_server", "jax_client_port_server"])
def test_store_interop(ref, direction):
    jstore = ref[0]
    from kungfu_tpu.plan import PeerID as JaxPeerID

    if direction == "port_client_jax_server":
        srv, client = jstore.StoreServer(host="127.0.0.1", port=0).start(), StoreClient(
            retries=3, retry_interval=0.01)
        peer = PeerID("127.0.0.1", srv.port - STORE_PORT_OFFSET)
    else:
        srv, client = StoreServer(host="127.0.0.1", port=0).start(), jstore.StoreClient(
            retries=3, retry_interval=0.01)
        peer = JaxPeerID("127.0.0.1", srv.port - STORE_PORT_OFFSET)
    try:
        for name, arr in ARRAYS.items():
            client.save(peer, name, arr)
            client.save(peer, name, arr * 2 if arr.dtype.kind == "f" else arr, version="v1")
            for version, want in (("", arr), ("v1", arr * 2 if arr.dtype.kind == "f" else arr)):
                got = client.request(peer, name, version=version)
                assert got.dtype == want.dtype and got.shape == want.shape, name
                assert got.tobytes() == want.tobytes(), name
                assert srv.get(name, version=version).tobytes() == want.tobytes(), name
        srv.save("raw", np.frombuffer(b"\x00\x01\x02", np.uint8))
        np.testing.assert_array_equal(client.request(peer, "raw"), [0, 1, 2])
        assert client.request(peer, "missing", wait=False) is None
    finally:
        client.close()
        srv.close()


# -- Peer ---------------------------------------------------------------------------

def _config(rank=0, n=2, host="127.0.0.1", port=21000):
    peers = PeerList(PeerID(host, port + r) for r in range(n))
    return kfenv.Config(self_id=peers[rank], peers=peers, runners=PeerList())


def test_peer_identity_and_refusals():
    peers = PeerList([PeerID("10.0.0.1", 10000), PeerID("10.0.0.1", 10001),
                      PeerID("10.0.0.2", 10000)])
    p = Peer(kfenv.Config(self_id=peers[1], peers=peers, runners=PeerList(), cluster_version=3),
             device="cpu")
    assert (p.rank, p.size, p.local_rank, p.local_size, p.host_count) == (1, 3, 1, 2, 2)
    assert p.uid() == (3 << 32) | 1 and p.self_id == peers[1]
    assert p._bind_host() == "0.0.0.0"
    with pytest.raises(NotImplementedError, match="A.8"):
        p.interference_detector()


def test_peer_update_cluster_detaches_a_removed_peer():
    """A document without this peer: update_cluster returns False and the
    peer is detached, its identity untouched (the survivors' side runs on
    gloo ranks in tests/test_torch_elastic.py)."""
    peers = PeerList([PeerID("10.0.0.1", 10000), PeerID("10.0.0.1", 10001),
                      PeerID("10.0.0.2", 10000)])
    p = Peer(kfenv.Config(self_id=peers[2], peers=peers, runners=PeerList(), cluster_version=3),
             device="cpu")
    shrunk = Cluster(runners=PeerList([PeerID("10.0.0.1", 38080)]), workers=PeerList(peers[:2]))
    assert p.update_cluster(shrunk, 4) is False
    assert p.detached and p.cluster_version == 3 and p.config.peers == peers


def test_peer_self_path_waits():
    """request(self) polls the local store with the wait semantics of a
    remote pull; a single peer needs no group."""
    p = Peer(kfenv.Config(self_id=PeerID("127.0.0.1", 0), peers=PeerList([PeerID("127.0.0.1", 0)]),
                          runners=PeerList(), single_machine=True), device="cpu")
    try:
        p.start()
        p._store_server, p._store_client = StoreServer(port=0).start(), StoreClient()
        assert p.request(0, "w", wait=False) is None
        t = threading.Timer(0.1, lambda: p.save("w", np.full(3, 7.0, np.float32)))
        t.start()
        np.testing.assert_array_equal(p.request(0, "w", timeout=5.0), np.full(3, 7.0))
        t.join()
        assert p.get_peer_latencies() == [0.0]
    finally:
        p.close()


# -- host gossip, two in-process peers (tests/unit/test_store.py) ---------------------

class _StubPeers:
    """n in-process peers over real TCP stores; `saves` and `pulls` record
    (rank, blob) and (rank, target, blob)."""

    def __init__(self, n, save_delay=0.0):
        self.servers = [StoreServer(host="127.0.0.1", port=0).start() for _ in range(n)]
        self.ids = [_peer_for(s) for s in self.servers]
        self.clients = [StoreClient(retries=3, retry_interval=0.01) for _ in range(n)]
        self.saves, self.pulls, self.delay, self.n = [], [], save_delay, n

    def peer(self, rank):
        outer = self

        class StubPeer:
            def __init__(self):
                self.rank, self.size = rank, outer.n

            def save(self, name, arr, version=""):
                time.sleep(outer.delay)
                outer.servers[rank].save(name, np.asarray(arr), version=version)
                outer.saves.append((rank, np.array(arr)))

            def request(self, target, name, version="", wait=True, timeout=30.0):
                got = outer.clients[rank].request(outer.ids[target], name, version=version,
                                                  wait=wait)
                outer.pulls.append((rank, target, got))
                return got

        return StubPeer()

    def close(self):
        for c in self.clients:
            c.close()
        for s in self.servers:
            s.close()


def _w(v, n=4):
    return [torch.full((n,), float(v))]


def test_host_pair_averaging_two_peers():
    stubs = _StubPeers(2)
    try:
        p0, p1 = (HostPairAveraging(stubs.peer(r)) for r in range(2))
        m0, m1 = _w(0.0), _w(8.0)
        p0.mix(m0)  # publishes 0, pulls nothing yet
        p1.mix(m1)  # publishes 8, pulls 0: (8 + 0) / 2
        np.testing.assert_array_equal(m1[0].numpy(), 4.0)
        m1[0] += 1.0  # the local step -> 5, then the post-step publish
        p1.publish(m1)
        blob = stubs.clients[0].request(stubs.ids[1], HostPairAveraging.NAME)
        np.testing.assert_array_equal(blob[HEADER:], 5.0)
        np.testing.assert_array_equal(blob[:HEADER].view(np.uint32), layout_digest(m1))
        p0.mix(m0)  # pulls 1's post-step model: (0 + 5) / 2
        np.testing.assert_array_equal(m0[0].numpy(), 2.5)
    finally:
        stubs.close()


def test_host_pull_of_another_layout_is_skipped(monkeypatch):
    """Same element count, another shape: the JAX package would mix it
    (it compares sizes); the port's digest differs and the pull is
    skipped, for both variants."""
    from kungfu_tpu_torch.optimizers import gossip

    warned = []
    monkeypatch.setattr(gossip.log, "warning", lambda msg, *a: warned.append(msg % a))
    for cls in (HostPairAveraging, OverlappedHostPairAveraging):
        stubs = _StubPeers(2)
        try:
            p0, p1 = (cls(stubs.peer(r)) for r in range(2))
            mine, theirs = [torch.zeros(3, 4)], [torch.ones(2, 6)]
            p1.mix(theirs)  # publishes the (2, 6) layout
            for _ in range(50):
                p0.mix(mine)
                time.sleep(0.01)
            assert any(r == 0 and got is not None for r, _, got in stubs.pulls)
            assert torch.equal(mine[0], torch.zeros(3, 4))
            assert any("layout digest" in w for w in warned)
        finally:
            for p in (p0, p1):
                if isinstance(p, OverlappedHostPairAveraging):
                    p.close()
            stubs.close()


def test_overlapped_host_pair_averaging_two_peers():
    stubs = _StubPeers(2)
    p0, p1 = (OverlappedHostPairAveraging(stubs.peer(r)) for r in range(2))
    try:
        m0 = [torch.zeros(4), torch.tensor([3], dtype=torch.int32)]
        m1 = [torch.full((4,), 8.0), torch.tensor([3], dtype=torch.int32)]
        p0.mix(m0)
        np.testing.assert_array_equal(m0[0].numpy(), 0.0)
        p1.mix(m1)  # bootstrap publish; starts p1's pull

        def mix_until_changed(p, m):
            before = m[0].clone()
            for _ in range(200):
                time.sleep(0.02)
                p.mix(m)
                if not torch.equal(m[0], before):
                    return
            raise AssertionError("no pull consumed")

        mix_until_changed(p1, m1)  # (8 + 0) / 2; the int leaf untouched
        np.testing.assert_array_equal(m1[0].numpy(), 4.0)
        assert m1[1].item() == 3
        m1[0] += 1.0
        p1.publish(m1)
        assert p1.flush()
        blob = stubs.clients[0].request(stubs.ids[1], OverlappedHostPairAveraging.NAME)
        np.testing.assert_array_equal(blob[HEADER:], 5.0)
        for _ in range(200):  # a stale pull (8 -> 4) may come first
            time.sleep(0.02)
            probe = [torch.zeros(4), torch.tensor([3], dtype=torch.int32)]
            p0.mix(probe)
            if torch.equal(probe[0], torch.full((4,), 2.5)):
                break
        else:
            raise AssertionError("never mixed p1's post-step model")
    finally:
        p0.close()
        p1.close()
        stubs.close()


class _SoloPeer:
    rank, size = 0, 1

    def __init__(self):
        self.blob = None

    def save(self, name, arr, version=""):
        self.blob = np.array(arr)

    def request(self, *a, **k):
        return None


def test_overlapped_publish_survives_an_in_place_update():
    """publish() copies on the device first: the next step updates the
    parameters in place while the worker thread still reads them (the
    JAX test's donated buffer)."""
    peer = _SoloPeer()
    p = OverlappedHostPairAveraging(peer)
    try:
        params = [torch.arange(64, dtype=torch.float32)]
        p.mix(params)
        p.publish(params)
        params[0].mul_(2.0)
        assert p.flush(timeout=10.0)
        np.testing.assert_array_equal(peer.blob[HEADER:], np.arange(64, dtype=np.float32))
    finally:
        p.close()


def test_overlapped_instance_collectable():
    p = OverlappedHostPairAveraging(_SoloPeer())
    p.mix([torch.ones(4)])
    thread = p._thread
    ref = weakref.ref(p)
    del p
    gc.collect()
    assert ref() is None, "the worker thread pins the instance"
    thread.join(timeout=5)
    assert not thread.is_alive()


def test_overlapped_flush_reports_a_failed_publish():
    class FailingPeer(_SoloPeer):
        boots = 0

        def save(self, name, arr, version=""):
            self.boots += 1
            if self.boots > 1:  # the bootstrap publish succeeds
                raise ConnectionError("store down")
            super().save(name, arr, version)

    p = OverlappedHostPairAveraging(FailingPeer())
    try:
        params = [torch.ones(4)]
        p.mix(params)
        p.publish(params)
        assert p.flush(timeout=10.0) is False
    finally:
        p.close()


def test_overlapped_close_keeps_a_queued_publish():
    """A publish queued right before close() reaches the store: close()
    flushes first (bounded), where the JAX package stops the thread and
    can drop it."""
    stubs = _StubPeers(1, save_delay=0.2)
    try:
        p = OverlappedHostPairAveraging(stubs.peer(0))
        params = [torch.zeros(8)]
        p.mix(params)  # the bootstrap publish (synchronous)
        params[0] += 3.0
        p.publish(params)
        p.close()
        assert not p._thread.is_alive()
        assert len(stubs.saves) == 2
        np.testing.assert_array_equal(stubs.saves[-1][1][HEADER:], 3.0)
    finally:
        stubs.close()


# -- host gossip on 4 ranks over real TCP stores ---------------------------------------

HOST_WORKER = textwrap.dedent("""
    import sys, time
    import numpy as np
    import torch
    import torch.distributed as dist
    from kungfu_tpu_torch.optimizers import HostPairAveraging, OverlappedHostPairAveraging
    from kungfu_tpu_torch.peer import Peer

    steps = int(sys.argv[2])
    peer = Peer(device="cpu").start()
    r, n = peer.rank, peer.size

    class Recording:
        def __init__(self):
            self.rank, self.size, self.pulls, self.saves = r, n, [], []

        def save(self, name, arr, version=""):
            self.saves.append(np.array(arr))
            peer.save(name, arr, version)

        def request(self, target, name, version="", wait=True, timeout=30.0):
            got = peer.request(target, name, version, wait=wait, timeout=timeout)
            self.pulls.append((target, None if got is None else np.array(got)))
            return got

    out = {}
    for kind, cls in (("host", HostPairAveraging), ("overlapped", OverlappedHostPairAveraging)):
        rec = Recording()
        g = cls(rec, seed=7)
        params = [torch.full((3, 5), float(r + 1)), torch.arange(4, dtype=torch.float32) * (r + 1),
                  torch.tensor([r], dtype=torch.int64)]
        befores, afters = [], []
        g.publish(params)  # every rank's first model, before any pull
        if kind == "overlapped":
            assert g.flush()
        for t in range(steps):
            dist.barrier()  # every rank has published its step-(t - 1) model
            befores.append(np.concatenate([p.reshape(-1).numpy() for p in params[:2]]))
            g.mix(params)
            afters.append(np.concatenate([p.reshape(-1).numpy() for p in params[:2]]))
            params[0] += 0.5 * (r + 1)  # the local step
            params[1] -= 0.25
            g.publish(params)
            if kind == "overlapped":
                assert g.flush()
                time.sleep(0.05)  # let the worker's pull land before the next mix
        if kind == "overlapped":
            g.close()
        dist.barrier()
        out[kind + "/targets"] = np.array([t for t, _ in rec.pulls])
        out[kind + "/pulled"] = np.array([np.full(23, np.nan, np.float32) if b is None else b
                                          for _, b in rec.pulls])
        out[kind + "/saves"] = np.array(rec.saves)
        out[kind + "/before"], out[kind + "/after"] = np.array(befores), np.array(afters)
        out[kind + "/int"] = params[2].numpy()
    np.savez(sys.argv[1] + f".{r}.npz", **out)
    dist.barrier()
    peer.close()
""")


@pytest.fixture(scope="module")
def host_ranks(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("host")
    wait_ranks(start_ranks(HOST_WORKER, N, [tmp / "out", HOST_STEPS],
                           max_port=65535 - STORE_PORT_OFFSET, offsets=[STORE_PORT_OFFSET]))
    return [np.load(tmp / f"out.{r}.npz") for r in range(N)]


def _jax_targets(ref, rank, count, seed=7):
    class Stub:
        size = N

        def __init__(self):
            self.rank = rank

    g = ref[1](Stub(), seed=seed)
    return [g._random_peer() for _ in range(count)]


@pytest.mark.parametrize("kind", ["host", "overlapped"])
def test_host_gossip_on_four_ranks(ref, host_ranks, kind):
    for r, res in enumerate(host_ranks):
        targets = list(res[kind + "/targets"])
        assert len(targets) >= HOST_STEPS - 1
        assert targets == _jax_targets(ref, r, len(targets)), r
        assert r not in targets and (res[kind + "/int"] == r).all()
        # every blob each rank published (the overlapped run starts on the
        # stores the host run left)
        saves = {r2: np.concatenate([host_ranks[r2][k + "/saves"] for k in ("host", kind)])
                 for r2 in range(N)}
        for target, blob in zip(targets, res[kind + "/pulled"]):
            if np.isnan(blob).all():
                continue  # a miss: the partner had not published yet
            # bit-equal to one of the blobs its owner published
            assert any(np.array_equal(blob.view(np.uint32), s.view(np.uint32))
                       for s in saves[target]), (r, target)
        before, after = res[kind + "/before"], res[kind + "/after"]
        pulled = [b for b in res[kind + "/pulled"] if not np.isnan(b).all()]
        for t in range(HOST_STEPS):
            if np.array_equal(before[t], after[t]):
                continue
            # the mixed model: the numpy average of this rank's blob and a pulled one
            means = [(before[t] + b[HEADER:]) * np.float32(0.5) for b in pulled]
            assert any(np.array_equal(after[t], m) for m in means), (r, t)
        if kind == "host":  # every step pulls a published model (the barrier)
            assert all(not np.array_equal(before[t], after[t]) for t in range(HOST_STEPS))
