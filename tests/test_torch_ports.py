"""Fixed-port binds that wait out an outbound socket (`utils.ports`).

The blob store (worker port + 15000), a config replica (its old port when
respawned) and rank 0's rendezvous (root port + 20000 + version) bind
ports fixed by rule.  On a host whose ephemeral range covers them, an
outbound connection, or its TIME_WAIT, can hold one.  Each binder here
must wait until such a socket is gone, fail at once where a listener
holds the port, and name the holders when it gives up.
"""
from __future__ import annotations

import errno
import socket
import threading
import time

import numpy as np
import pytest

from kungfu_tpu_torch import distributed
from kungfu_tpu_torch import env as kfenv
from kungfu_tpu_torch.elastic.config_client import ConfigClient
from kungfu_tpu_torch.elastic.config_server import ConfigServer
from kungfu_tpu_torch.plan import PeerID, PeerList
from kungfu_tpu_torch.store import StoreClient, StoreServer
from kungfu_tpu_torch.utils import ports


def _listener():
    srv = socket.socket()
    srv.bind(("127.0.0.1", 0))
    srv.listen()
    return srv


def _outbound(srv):
    """A connection to `srv`: (client socket, its local port, server's side)."""
    c = socket.create_connection(srv.getsockname())
    a, _ = srv.accept()
    return c, c.getsockname()[1], a


def _store(port):
    s = StoreServer(host="127.0.0.1", port=port).start()
    try:
        s.save("w", np.arange(4, dtype=np.float32))
        got = StoreClient().request(PeerID("127.0.0.1", port - 15000), "w")
        assert np.array_equal(got, np.arange(4, dtype=np.float32))
    finally:
        s.close()


def _config_replica(port):
    s = ConfigServer(host="127.0.0.1", port=port).start()
    try:
        assert ConfigClient(s.url).get_health() is not None
    finally:
        s.stop()


def _rendezvous_probe(port):
    ports.wait_until_bindable(port, "127.0.0.1", "the rendezvous")


BINDERS = {"store": _store, "config_replica": _config_replica, "rendezvous": _rendezvous_probe}


def test_holders_name_a_listener_and_both_ends_of_a_connection():
    srv = _listener()
    c, cport, a = _outbound(srv)
    try:
        lport = srv.getsockname()[1]
        states = sorted(h["state"] for h in ports.port_holders(lport, "127.0.0.1"))
        assert states == ["ESTABLISHED", "LISTEN"]
        (mine,) = ports.port_holders(cport, "127.0.0.1")
        assert mine["state"] == "ESTABLISHED" and mine["remote"] == f"127.0.0.1:{lport}"
        assert ports.port_holders(cport, "127.0.0.2") == []  # another address binds freely
    finally:
        for sock in (c, a, srv):
            sock.close()


@pytest.mark.parametrize("binder", sorted(BINDERS))
def test_bind_waits_out_an_outbound_socket(binder):
    srv = _listener()
    c, cport, a = _outbound(srv)

    def release():  # the far side closes first, so the port leaves no TIME_WAIT
        time.sleep(0.6)
        a.close()
        time.sleep(0.05)
        c.close()

    t = threading.Thread(target=release)
    t0 = time.monotonic()
    t.start()
    try:
        with pytest.raises(OSError):  # held now: a plain bind fails
            socket.socket().bind(("127.0.0.1", cport))
        BINDERS[binder](cport)
        assert time.monotonic() - t0 >= 0.5
    finally:
        t.join()
        srv.close()


@pytest.mark.parametrize("binder", sorted(BINDERS))
def test_a_listener_fails_at_once(binder):
    srv = _listener()
    try:
        t0 = time.monotonic()
        with pytest.raises(OSError) as err:
            BINDERS[binder](srv.getsockname()[1])
        assert time.monotonic() - t0 < 5
        assert err.value.errno == errno.EADDRINUSE and "a listener holds it" in str(err.value)
    finally:
        srv.close()


@pytest.mark.parametrize("binder", sorted(BINDERS))
def test_a_holder_past_the_wait_is_named(binder, monkeypatch):
    monkeypatch.setenv(ports.PORT_WAIT_ENV, "0.5")
    srv = _listener()
    c, cport, a = _outbound(srv)
    c.close()  # this side closes first: its port stays in FIN_WAIT2, then TIME_WAIT
    try:
        with pytest.raises(OSError) as err:
            BINDERS[binder](cport)
        msg = str(err.value)
        assert err.value.errno == errno.EADDRINUSE and "held after" in msg
        assert "FIN_WAIT2" in msg or "TIME_WAIT" in msg
    finally:
        a.close()
        srv.close()


@pytest.mark.parametrize("rank", [0, 1])
def test_only_rank_zero_waits_for_the_rendezvous_port(rank, monkeypatch):
    seen = []

    class Joined(Exception):
        pass

    def join(*a, **kw):
        raise Joined(kw["init_method"])

    monkeypatch.setattr(distributed, "wait_until_bindable",
                        lambda port, **kw: seen.append(port))
    monkeypatch.setattr(distributed.dist, "init_process_group", join)
    peers = PeerList([PeerID("127.0.0.1", 10000), PeerID("127.0.0.1", 10001)])
    cfg = kfenv.Config(self_id=peers[rank], peers=peers, runners=PeerList(), cluster_version=7)
    with pytest.raises(Joined, match="tcp://127.0.0.1:30007"):
        distributed.init_distributed(cfg, device="cpu")
    assert seen == ([30007] if rank == 0 else [])
