"""Top-level scalar API: the `kungfu.python` surface (counterpart of
kungfu_tpu/api.py).

Reference: srcs/python/kungfu/python/__init__.py:36-103 (current_rank,
cluster_size, local_rank/size, detached, run_barrier, propose_new_size)
built on ctypes into libkungfu.  Here they read the default Peer
(`peer.default_peer`).

As in the JAX package init is lazy: importing kungfu_tpu_torch does not
start the peer; any API call or an explicit `init()` starts it.
`propose_new_size` goes through the elastic config server
(`elastic.propose_new_size`).  `egress_rates` and `check_interference`
need the monitors (ROADMAP A.8) and raise until then.
"""
from __future__ import annotations

import atexit

from . import peer as _peer_mod
from .peer import Peer, default_peer
from .plan import Cluster


def init(config=None) -> Peer:
    """Start (or return) the default peer.  Idempotent.  It runs on the
    card, or on the CPU under KFT_PLATFORM=cpu (the launcher's -platform)."""
    if config is not None:
        _peer_mod.finalize_default_peer()  # close any lazily-started peer first
        p = Peer(config).start()
        _peer_mod.set_default_peer(p)
        atexit.register(_peer_mod.finalize_default_peer)
        return p
    return default_peer()


def finalize() -> None:
    _peer_mod.finalize_default_peer()


def current_rank() -> int:
    return default_peer().rank


def cluster_size() -> int:
    return default_peer().size


def current_local_rank() -> int:
    return default_peer().local_rank


def current_local_size() -> int:
    return default_peer().local_size


def host_count() -> int:
    return default_peer().host_count


def current_cluster() -> Cluster:
    return default_peer().config.cluster()


def detached() -> bool:
    return default_peer().detached


def uid() -> int:
    return default_peer().uid()


def run_barrier() -> None:
    """Global barrier (reference python/__init__.py run_barrier): the
    Session's barrier over every rank."""
    default_peer().current_session().barrier()


def calc_stats() -> dict:
    """Per-op throughput stats (reference GoKungfuCalcStats)."""
    return default_peer().current_session().calc_stats()


def log_stats() -> None:
    """Log the current throughput stats (reference python/__init__.py log_stats)."""
    from .utils import get_logger

    get_logger("kungfu.stats").info("throughput stats: %s", calc_stats())


def egress_rates() -> dict:
    """Windowed egress byte rates per op (reference EgressRates op)."""
    raise NotImplementedError("egress_rates needs the monitor's byte counters, not ported "
                              "yet (ROADMAP A.8)")


def check_interference() -> bool:
    """Majority-vote interference check (reference check_interference)."""
    raise NotImplementedError("check_interference needs the interference detector, not "
                              "ported yet (ROADMAP A.8)")


def save_variable(name: str, arr, version: str = "") -> None:
    """Publish a blob in this peer's p2p store (reference ops/local.py save_variable)."""
    default_peer().save(name, arr, version=version)


def request_variable(target_rank: int, name: str, version: str = ""):
    """Pull a blob from another peer's store (reference ops/p2p.py request_variable)."""
    return default_peer().request(target_rank, name, version=version)


def get_peer_latencies(timeout: float = 5.0) -> list:
    """Per-peer RTTs over the blob stores (reference GetPeerLatencies op)."""
    return default_peer().get_peer_latencies(timeout=timeout)


def minimum_spanning_tree(latencies) -> list:
    """Father-array MST over a symmetric latency matrix (reference
    MinimumSpanningTree op + include/kungfu/mst.hpp)."""
    from .plan import minimum_spanning_tree as mst

    return mst(latencies)


def get_neighbour_mask(father) -> list:
    """This peer's neighbour mask in the (father-array) tree (reference
    GetNeighbourMask op, cpu/topology.cpp:154-192); pair with
    plan.RoundRobinSelector to cycle gossip partners over the MST."""
    from .plan import mst_neighbour_mask

    return mst_neighbour_mask(father, default_peer().rank)


def set_tree(forest) -> None:
    """Adopt an explicit bcast tree for later collectives (reference
    SetTree op; see Session.set_tree).  Call at the same point on every
    peer."""
    default_peer().current_session().set_tree(forest)


def set_strategy(strategy) -> None:
    """Runtime strategy swap (reference SetGlobalStrategy)."""
    from .plan import Strategy

    s = Strategy.parse(strategy) if isinstance(strategy, str) else strategy
    default_peer().current_session().set_strategy(s)


def get_variable(name: str, default=None):
    """Read a named global training variable (reference variables.py)."""
    from . import variables as V

    return V.get_variable(name, default)


def set_variable(name: str, value: float) -> None:
    from . import variables as V

    V.set_variable(name, value)


def propose_new_size(new_size: int) -> None:
    """Rank 0 proposes a resize via the config server (legacy.go:18-37);
    every other rank does nothing."""
    from .elastic import propose_new_size as _propose

    _propose(default_peer(), new_size)
