"""torch.distributed bootstrap from the KungFu env contract.

Counterpart of kungfu_tpu.distributed, which brings up the JAX
coordination service.  Here the process group is torch.distributed's,
with rendezvous over TCP on the first peer's host of KFT_INIT_PEERS, at
the version-fenced port `peer.coordinator_port(its port, cluster
version)` as in the JAX package, and world size and rank from the peer
list.  A cluster of one needs no group, and
nothing is started for it.

Card and backend (`placement`): a rank uses card port mod the number of
cards it sees, so ranks may share a card.  The port is the peer's
identity, where its rank is not: a rank that a heal or a resize shifts
keeps the card its model and state live on, and a worker regrown at its
port takes the card its predecessor left (the launcher's consecutive
ports from 10000 give local rank mod the cards).  The group is NCCL
when every rank of a host has a card of its own and gloo when ranks share
one (more ranks than cards, or two ports of a host with one residue, as a
worker grown at the lowest free port from 10000 beside ranks launched
from another base can get), since NCCL refuses two ranks of one
communicator on one card; the CPU is always gloo.  The group carries only the broadcast at init, the loss
mean and the ring workspace's handle exchange: the gradient mean of
impl="pallas_ring" runs through the ring kernels on either backend.
`sub_group` makes the groups of a mesh axis (`plan/mesh.py`) on the same
backend.
"""
from __future__ import annotations

import collections
import datetime
import importlib
import os
import time
from typing import Optional, Sequence, Tuple

import torch
import torch.distributed as dist

from . import compat
from .env import Config, parse_config_from_env
from .plan import PeerID, PeerList
from .utils import get_logger
from .utils.ports import wait_until_bindable

log = get_logger("kungfu.distributed")


INIT_TIMEOUT_ENV = "KFT_INIT_TIMEOUT_S"  # the group's rendezvous timeout, default 300
# the group's operations, whatever the rendezvous got: a rank that waits
# long in one (a peer's snapshot or save) must not read as a failure
OP_TIMEOUT = datetime.timedelta(seconds=300)


def _rendezvous_timeout() -> datetime.timedelta:
    """KFT_INIT_TIMEOUT_S, as in the JAX package (a heal-armed worker gets
    45 s from the launcher, so a rejoin that cannot convene fails in time
    to chase a newer document)."""
    return datetime.timedelta(seconds=float(os.environ.get(INIT_TIMEOUT_ENV) or 300))


def placement(peers: PeerList, self_id: PeerID, device_type: str,
              device_count: int) -> Tuple[Optional[int], str]:
    """(card index or None on the CPU, backend) of `self_id` in `peers`.

    Every host is assumed to see the same number of cards, so every rank
    picks the same backend."""
    if device_type == "cpu":
        return None, "gloo"
    if device_count < 1:
        raise RuntimeError("no CUDA card to place a rank on")
    cards = collections.defaultdict(list)
    for p in peers:
        cards[p.host].append(p.port % device_count)
    own_card = all(len(set(c)) == len(c) for c in cards.values())
    return self_id.port % device_count, "nccl" if own_card else "gloo"


def init_distributed(config: Optional[Config] = None, device=None) -> int:
    """Join the process group the env describes; returns the world size.

    `device` is "cuda" (the default) or "cpu"; on CUDA the rank's card
    becomes the current device and the backend follows `placement`.  Does
    nothing at world size 1 or when a group already exists.
    """
    cfg = config if config is not None else parse_config_from_env()
    world = len(cfg.peers)
    if world <= 1:
        return 1
    if dist.is_initialized():
        return dist.get_world_size()
    dev = compat.resolve_device(device)
    count = torch.cuda.device_count() if dev.type == "cuda" else 0
    card, backend = placement(cfg.peers, cfg.self_id, dev.type, count)
    if card is not None:
        torch.cuda.set_device(card)
    from .peer import coordinator_port

    # torch's optimizers import torch._dynamo at their first construction;
    # imported while a process group exists, it keeps references to that
    # group (seen with torch 2.13), which then outlives
    # destroy_process_group with its gloo sockets open.  A heal's dirty
    # teardown relies on those sockets closing: a peer blocked opposite
    # this rank sees the reset and enters its own recovery.  So it is
    # imported before the first group.
    importlib.import_module("torch._dynamo")

    root = cfg.peers[0]
    port = coordinator_port(root.port, cfg.cluster_version)
    if cfg.rank == 0:  # rank 0's TCP store listens there, on every address
        wait_until_bindable(port, what="the rendezvous")
    dist.init_process_group(
        backend,
        init_method=f"tcp://{root.host}:{port}",
        world_size=world,
        rank=cfg.rank,
        timeout=_rendezvous_timeout(),
    )
    # torch gives the group's operations the rendezvous's timeout; the JAX
    # package bounds only its rendezvous with KFT_INIT_TIMEOUT_S.  The TCP
    # store keeps it, so NCCL's lazy communicator setup is bounded too.
    dist.distributed_c10d._set_pg_timeout(OP_TIMEOUT)
    where = f"card {card} of {count}" if card is not None else "cpu"
    log.info("rank %d/%d joined at %s:%d (version %d): %s, backend %s", cfg.rank, world,
             root.host, port, cfg.cluster_version, where, backend)
    return world


def sub_group(partition: Sequence[Sequence[int]]):
    """One process group per list of global ranks in `partition` (every
    rank in exactly one list), made in the same order on every rank, as
    `dist.new_group` requires; returns the group that holds this rank.
    The groups take the world's backend: gloo where ranks share a card."""
    mine, _ = dist.new_subgroups_by_enumeration([list(ranks) for ranks in partition])
    return mine


def shutdown_distributed(graceful: bool = True, peers: Optional[PeerList] = None) -> None:
    """Free the ring workspaces, then leave the process group, if any.

    graceful=False is the suspected-dead-peer path of a heal (the JAX
    package's `teardown_distributed_runtime(graceful=False)`), which must
    return with a dead rank in the group: no barrier and no collective.
    NCCL's communicators are aborted (`_abort_process_group`: its
    `destroy_process_group` can block on a communicator with a dead rank),
    a gloo group is dropped (its destroy touches no peer), and the ring
    workspaces are set aside (`peer_memory.abandon_all`, with `peers`, the
    world's peer list) until `peer_memory.reap_orphans` frees them once
    the healed group has met."""
    if not dist.is_initialized():
        return
    from .ops import peer_memory

    if graceful:
        peer_memory.close_all()
        dist.destroy_process_group()
        return
    t0 = time.perf_counter()
    abort = getattr(dist.distributed_c10d, "_abort_process_group", None)
    if dist.get_backend() == "nccl" and abort is not None:
        abort()  # before the card sync below: an aborted NCCL kernel ends
    else:
        dist.destroy_process_group()
    peer_memory.abandon_all(peers if peers is not None else [])
    dt = time.perf_counter() - t0
    from .monitor.journal import journal_event

    journal_event("dirty_teardown", duration_s=round(dt, 4))
    log.info("dirty distributed teardown in %.2fs", dt)
