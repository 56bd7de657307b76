"""Worker process construction: the KungFu env block and optional card
slots (counterpart of kungfu_tpu.run.job).

Each worker inherits the launcher's environment plus `env.worker_env`.
Card slots are opt-in, as `chips_per_host` is in the JAX package: with
`cards_per_host` > 0 a worker sees only its slot through
CUDA_VISIBLE_DEVICES.  By default nothing is narrowed, since a rank's ring
peers must stay visible to it (the ring kernels map their memory); each
rank then picks card local_rank mod count itself
(`distributed.placement`).
"""
from __future__ import annotations

import dataclasses
import os
from typing import Dict, List, Optional

from ..env import worker_env
from ..plan import Cluster, PeerID, Strategy


class ChipPool:
    """Smallest-free-id card slot allocator."""

    def __init__(self, n: int):
        self._free = list(range(n))

    def get(self) -> Optional[int]:
        return self._free.pop(0) if self._free else None


@dataclasses.dataclass
class Proc:
    name: str
    args: List[str]
    env: Dict[str, str]
    peer: PeerID
    chip: int = -1


@dataclasses.dataclass
class Job:
    prog: str
    args: List[str]
    strategy: Strategy
    cards_per_host: int = 0  # 0 = leave CUDA_VISIBLE_DEVICES alone

    def new_proc(self, peer: PeerID, chip: int, cluster: Cluster, version: int,
                 parent: Optional[PeerID] = None) -> Proc:
        env = dict(os.environ)
        env.update(worker_env(self_id=peer, cluster=cluster, version=version,
                              strategy=self.strategy, parent=parent))
        if self.cards_per_host > 0 and chip >= 0:
            # a pre-set visible list is respected: the slot indexes into it
            pre = env.get("CUDA_VISIBLE_DEVICES")
            if pre:
                visible = pre.split(",")
                env["CUDA_VISIBLE_DEVICES"] = visible[chip % len(visible)]
            else:
                env["CUDA_VISIBLE_DEVICES"] = str(chip)
        return Proc(name=f"{cluster.workers.rank(peer)}", args=[self.prog] + list(self.args),
                    env=env, peer=peer, chip=chip)
