"""torch.distributed bootstrap from the KungFu env contract.

Counterpart of kungfu_tpu.distributed, which brings up the JAX
coordination service.  Here the process group is torch.distributed's:
gloo for CPU tensors, NCCL for CUDA tensors, rendezvous over TCP at the
first peer of KFT_INIT_PEERS, world size and rank from the peer list.  A
cluster of one needs no group, and nothing is started for it.
"""
from __future__ import annotations

import datetime
from typing import Optional

import torch
import torch.distributed as dist

from . import compat
from .env import Config, parse_config_from_env
from .utils import get_logger

log = get_logger("kungfu.distributed")


_RENDEZVOUS_TIMEOUT = datetime.timedelta(seconds=300)


def init_distributed(config: Optional[Config] = None, device=None) -> int:
    """Join the process group the env describes; returns the world size.

    `device` selects the backend (NCCL for "cuda", the default; gloo for
    "cpu") and, on CUDA, the local card (the peer's local rank).  Does
    nothing at world size 1 or when a group already exists.
    """
    cfg = config if config is not None else parse_config_from_env()
    world = len(cfg.peers)
    if world <= 1:
        return 1
    if dist.is_initialized():
        return dist.get_world_size()
    dev = compat.resolve_device(device)
    if dev.type == "cuda":
        torch.cuda.set_device(cfg.peers.local_rank(cfg.self_id))
    root = cfg.peers[0]
    dist.init_process_group(
        "nccl" if dev.type == "cuda" else "gloo",
        init_method=f"tcp://{root.host}:{root.port}",
        world_size=world,
        rank=cfg.rank,
        timeout=_RENDEZVOUS_TIMEOUT,
    )
    log.info("rank %d/%d joined at %s", cfg.rank, world, root)
    return world


def shutdown_distributed() -> None:
    """Leave the process group, if any."""
    if dist.is_initialized():
        dist.destroy_process_group()
