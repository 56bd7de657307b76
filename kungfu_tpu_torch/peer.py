"""Peer: this process's identity in the cluster, its Session and its p2p
blob store (counterpart of kungfu_tpu.peer).

Re-design of the reference Peer (srcs/go/kungfu/peer/peer.go:27-48): a
Peer owns this process's identity from the KungFu env contract, joins the
process group (`distributed.init_distributed`), builds the Session over
the ranks (`current_session`: a ("dcn", "ici") mesh when the cluster spans
several hosts with several ranks on a host, else "dp" over every rank)
and runs its blob store (`store.StoreServer` on `store.store_port(worker
port)`), through which the asynchronous gossip pulls other peers' models.

Its device is the caller's, else the launcher's KFT_PLATFORM
(`env.platform_device`: "cpu" puts the Peer and its Session on the CPU),
else the card.  The module singleton (`default_peer`) is what the scalar
api (`api.py`) and the torch interop (`kungfu_tpu_torch.torch`) use.

Version fencing: the group's rendezvous port is derived from the cluster
version (`coordinator_port`), so a peer holding a stale cluster document
cannot reach the group of the new one, the counterpart of the
cluster-version token check on collective connections
(srcs/go/rchannel/connection/connection.go:81-87).  `update_cluster`
adopts a resized document and rejoins at the new version's port.  The
interference detector raises until the monitors are ported (ROADMAP A.8).
"""
from __future__ import annotations

import atexit
import time
from typing import List, Optional

import numpy as np

from . import env as kfenv
from .plan import PeerID
from .utils import get_logger

log = get_logger("kungfu.peer")

COORDINATOR_PORT_OFFSET = 20000
# versions cycle through a window of ports: an elastic job bumps its
# version without bound, and only consecutive versions need fencing from
# each other (a stale peer is at most a few versions behind)
COORDINATOR_PORT_WINDOW = 1000


def coordinator_port(root_port: int, cluster_version: int) -> int:
    """The version-fenced rendezvous port of the group whose first peer
    listens at `root_port`.  The range check covers the whole window, not
    this version alone, so a root port too high fails at start-up and not
    hours into an elastic job."""
    if not (0 < root_port + COORDINATOR_PORT_OFFSET + COORDINATOR_PORT_WINDOW - 1 <= 65535):
        raise ValueError(
            f"worker port {root_port} leaves no room for the coordinator "
            f"window (+{COORDINATOR_PORT_OFFSET}+{COORDINATOR_PORT_WINDOW} "
            f"exceeds 65535); pick worker ports <= "
            f"{65535 - COORDINATOR_PORT_OFFSET - COORDINATOR_PORT_WINDOW + 1}"
        )
    return root_port + COORDINATOR_PORT_OFFSET + (cluster_version % COORDINATOR_PORT_WINDOW)


class Peer:
    def __init__(self, config: Optional[kfenv.Config] = None, device=None):
        self.config = config if config is not None else kfenv.parse_config_from_env()
        self.cluster_version = self.config.cluster_version
        self.device = device if device is not None else kfenv.platform_device()
        self.detached = False
        self._session = None
        self._started = False
        self._store_server = None
        self._store_client = None

    # -- identity (reference peer.go + python/__init__.py:36-103) ---------------

    @property
    def self_id(self) -> PeerID:
        return self.config.self_id

    @property
    def rank(self) -> int:
        return self.config.rank

    @property
    def size(self) -> int:
        return len(self.config.peers)

    @property
    def local_rank(self) -> int:
        r = self.config.peers.local_rank(self.self_id)
        return 0 if r is None else r

    @property
    def local_size(self) -> int:
        return max(1, sum(p.host == self.self_id.host for p in self.config.peers))

    @property
    def host_count(self) -> int:
        return max(1, self.config.peers.host_count())

    def uid(self) -> int:
        """(version << 32) | rank, reference libkungfu-comm/main.go uid."""
        return (self.cluster_version << 32) | self.rank

    # -- lifecycle ----------------------------------------------------------------

    def start(self) -> "Peer":
        """With more than one peer, start the blob store, then join the
        process group (`device`: "cuda" unless "cpu") and build the Session.
        The store's port is fixed (worker port + STORE_PORT_OFFSET), so it
        binds before the group's transport takes ephemeral ports that could
        hold it; and a faster peer must find it listening before its first
        pull (a miss, never a connection error)."""
        if self._started:
            return self
        from .distributed import init_distributed
        from .monitor.journal import set_journal_context

        if self.size > 1:
            self._ensure_store()
        init_distributed(self.config, device=self.device)
        self._session = self._build_session()
        # journal stamps follow the current incarnation
        set_journal_context(rank=self.rank, cluster_version=self.cluster_version)
        self._started = True
        log.info("peer up: rank %d/%d local %d/%d hosts %d version %d", self.rank, self.size,
                 self.local_rank, self.local_size, self.host_count, self.cluster_version)
        return self

    def _bind_host(self) -> str:
        """The store's listen address: loopback aliases ("hosts" 127.0.0.1
        and 127.0.0.2 on one machine) each bind their own; every other
        host binds 0.0.0.0 (it may be listed by an address it cannot
        bind: NAT, a published port)."""
        if self.config.single_machine:
            return "127.0.0.1"
        host = self.self_id.host
        return host if host.startswith("127.") else "0.0.0.0"

    def _build_session(self):
        """The Session over every rank: hierarchical (dcn x ici) when there
        are several hosts and several ranks on a host (the JAX package
        counts the devices of a host; here a rank is one card), else flat."""
        from .plan import make_hierarchical_mesh, make_mesh
        from .session import Session

        if self.host_count > 1 and self.local_size > 1:
            mesh = make_hierarchical_mesh(self.host_count)
        else:
            mesh = make_mesh(dp=-1)
        return Session(mesh=mesh, strategy=self.config.strategy, host_count=self.host_count,
                       device=self.device)

    def current_session(self):
        """The Session, starting the peer first if it has not started."""
        if not self._started:
            self.start()
        return self._session

    def update_cluster(self, cluster, version: int) -> bool:
        """Adopt a new cluster document; False if this peer was removed.

        The reference's Peer.updateTo (peer/peer.go:144-166): leave the
        old group (the store, the ring workspaces, the Session's mesh
        groups, the process group), adopt the new peer list and rejoin at
        the new version's fenced port.  A removed peer leaves the old group
        too, since the ring workspaces' release is collective over it, and
        is then `detached`."""
        if cluster.workers.rank(self.self_id) is None:
            self.close()
            self.detached = True
            log.info("detached from cluster at version %d", version)
            return False
        self.close()
        self.config = kfenv.Config(
            self_id=self.self_id,
            peers=cluster.workers,
            runners=cluster.runners,
            cluster_version=version,
            strategy=self.config.strategy,
            config_server=self.config.config_server,
            parent=self.config.parent,
            single_machine=self.config.single_machine,
        )
        self.cluster_version = version
        self.start()
        return True

    def interference_detector(self):
        raise NotImplementedError("Peer.interference_detector: the monitors are not ported yet "
                                  "(ROADMAP A.8)")

    # -- p2p blob store (reference peer/p2p.go Save/Request + handler/p2p.go) ------

    def _ensure_store(self):
        from .store import StoreClient, StoreServer, store_port

        if self._store_server is None:
            self._store_server = StoreServer(host=self._bind_host(),
                                             port=store_port(self.self_id.port)).start()
            self._store_client = StoreClient()
        return self._store_server, self._store_client

    def save(self, name: str, arr, version: str = "") -> None:
        """Publish a named blob in this peer's store (GoKungfuSave)."""
        srv, _ = self._ensure_store()
        srv.save(name, np.asarray(arr), version=version)

    def request(self, target_rank: int, name: str, version: str = "", wait: bool = True,
                timeout: float = 30.0):
        """Pull a named blob from peer `target_rank`'s store (GoKungfuRequest);
        None if it is not there (after `timeout` seconds of polling with
        `wait`)."""
        from .store import poll_until

        srv, client = self._ensure_store()
        if target_rank == self.rank:
            # the wait semantics hold on the self path too: correct code
            # must not break only when the target happens to be self
            return poll_until(lambda: srv.get(name, version=version), wait=wait,
                              deadline=time.monotonic() + timeout)
        return client.request(self.config.peers[target_rank], name, version=version,
                              wait=wait, timeout=timeout)

    def get_peer_latencies(self, timeout: float = 5.0) -> List[float]:
        """RTT to every peer's store, seconds; 0 for self (reference
        GetPeerLatencies, tensorflow/ops/cpu/topology.cpp:84)."""
        if self.size <= 1:
            return [0.0] * self.size
        _, client = self._ensure_store()
        return [0.0 if r == self.rank else client.ping(p, timeout=timeout)
                for r, p in enumerate(self.config.peers)]

    def close(self, graceful: bool = True) -> None:
        """Stop the store; leave the process group if this peer joined it.
        graceful=False is a heal's teardown, with a dead rank in the group
        (`distributed.shutdown_distributed(graceful=False)`)."""
        if self._store_server is not None:
            self._store_server.close()
            self._store_server = None
        if self._store_client is not None:
            self._store_client.close()
            self._store_client = None
        if self._started:
            from .distributed import shutdown_distributed

            shutdown_distributed(graceful, self.config.peers)
        self._started = False
        self._session = None


# -- module singleton (reference src/python/init.cpp:12-41 _default_peer) -------------

_default_peer: Optional[Peer] = None


def default_peer() -> Peer:
    """The process's Peer, started on first use (closed at exit)."""
    global _default_peer
    if _default_peer is None:
        _default_peer = Peer().start()
        atexit.register(finalize_default_peer)
    return _default_peer


def set_default_peer(p: Optional[Peer]) -> None:
    global _default_peer
    _default_peer = p


def finalize_default_peer() -> None:
    global _default_peer
    if _default_peer is not None:
        _default_peer.close()
        _default_peer = None
