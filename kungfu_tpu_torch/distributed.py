"""torch.distributed bootstrap from the KungFu env contract.

Counterpart of kungfu_tpu.distributed, which brings up the JAX
coordination service.  Here the process group is torch.distributed's,
with rendezvous over TCP at the first peer of KFT_INIT_PEERS and world
size and rank from the peer list.  A cluster of one needs no group, and
nothing is started for it.

Card and backend (`placement`): a rank uses card local_rank mod the
number of cards it sees, so ranks may share a card.  The group is NCCL
when every rank of a host has a card of its own and gloo when ranks share
one, since NCCL refuses two ranks of one communicator on one card; the CPU
is always gloo.  The group carries only the broadcast at init, the loss
mean and the ring workspace's handle exchange: the gradient mean of
impl="pallas_ring" runs through the ring kernels on either backend.
`sub_group` makes the groups of a mesh axis (`plan/mesh.py`) on the same
backend.
"""
from __future__ import annotations

import collections
import datetime
from typing import Optional, Sequence, Tuple

import torch
import torch.distributed as dist

from . import compat
from .env import Config, parse_config_from_env
from .plan import PeerID, PeerList
from .utils import get_logger

log = get_logger("kungfu.distributed")


_RENDEZVOUS_TIMEOUT = datetime.timedelta(seconds=300)


def placement(peers: PeerList, self_id: PeerID, device_type: str,
              device_count: int) -> Tuple[Optional[int], str]:
    """(card index or None on the CPU, backend) of `self_id` in `peers`.

    Every host is assumed to see the same number of cards, so every rank
    picks the same backend."""
    if device_type == "cpu":
        return None, "gloo"
    if device_count < 1:
        raise RuntimeError("no CUDA card to place a rank on")
    per_host = max(collections.Counter(p.host for p in peers).values())
    backend = "nccl" if per_host <= device_count else "gloo"
    return peers.local_rank(self_id) % device_count, backend


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
    root = cfg.peers[0]
    dist.init_process_group(
        backend,
        init_method=f"tcp://{root.host}:{root.port}",
        world_size=world,
        rank=cfg.rank,
        timeout=_RENDEZVOUS_TIMEOUT,
    )
    where = f"card {card} of {count}" if card is not None else "cpu"
    log.info("rank %d/%d joined at %s: %s, backend %s", cfg.rank, world, root, where, backend)
    return world


def sub_group(partition: Sequence[Sequence[int]]):
    """One process group per list of global ranks in `partition` (every
    rank in exactly one list), made in the same order on every rank, as
    `dist.new_group` requires; returns the group that holds this rank.
    The groups take the world's backend: gloo where ranks share a card."""
    mine, _ = dist.new_subgroups_by_enumeration([list(ranks) for ranks in partition])
    return mine


def shutdown_distributed() -> None:
    """Free the ring workspaces, then leave the process group, if any."""
    if dist.is_initialized():
        from .ops import peer_memory

        peer_memory.close_all()
        dist.destroy_process_group()
