"""Worker process construction: the KungFu env block and optional card
slots (counterpart of kungfu_tpu.run.job).

Each worker inherits the launcher's environment plus `env.worker_env`.
Card slots are opt-in, as `chips_per_host` is in the JAX package: with
`cards_per_host` > 0 a worker sees only its slot through
CUDA_VISIBLE_DEVICES.  By default nothing is narrowed, since a rank's ring
peers must stay visible to it (the ring kernels map their memory); each
rank then picks card port mod count itself (`distributed.placement`: a
peer keeps its card when its rank shifts).  `platform` ("cpu" or "gpu", "" to inherit)
reaches the workers as KFT_PLATFORM (`env.platform_device`); a worker is
one rank with one card, so `devices_per_worker` takes 1 only.
`config_server` (the elastic config service's URL, watch mode) reaches
the workers as KFT_CONFIG_SERVER.  `heal` arms the workers' recovery path
(KFT_HEAL, the JAX package's timeouts), and `heartbeat_dir` gives each
worker a heartbeat file the healer's hang detection reads.
"""
from __future__ import annotations

import dataclasses
import os
from typing import Dict, List, Optional

from ..env import PLATFORM, platform_device, worker_env
from ..plan import Cluster, PeerID, Strategy


class ChipPool:
    """Smallest-free-id card slot allocator."""

    def __init__(self, n: int):
        self._free = list(range(n))

    def get(self) -> Optional[int]:
        return self._free.pop(0) if self._free else None

    def put(self, i: int) -> None:
        if i >= 0 and i not in self._free:
            self._free.append(i)
            self._free.sort()


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
    config_server: str = ""  # the elastic config service (watch mode)
    platform: str = ""  # "" = inherit; "cpu" puts the workers on the CPU
    devices_per_worker: int = 1
    heal: bool = False  # arm the workers' suspected-dead-peer recovery path
    heartbeat_dir: str = ""  # workers touch a per-peer file every step

    def __post_init__(self):
        if self.devices_per_worker != 1:
            raise ValueError(
                f"devices_per_worker={self.devices_per_worker}: a worker of the port is one "
                "rank with one card (or the CPU); start one worker a card instead")
        platform_device({PLATFORM: self.platform})  # refuse an unknown platform at launch

    def new_proc(self, peer: PeerID, chip: int, cluster: Cluster, version: int,
                 parent: Optional[PeerID] = None) -> Proc:
        env = dict(os.environ)
        env.update(worker_env(self_id=peer, cluster=cluster, version=version,
                              strategy=self.strategy, parent=parent,
                              config_server=self.config_server))
        if self.heal:
            env["KFT_HEAL"] = "1"
            # a rejoin in recovery must fail fast enough for the retry loop
            # to chase newer documents (default 300 s); user env wins
            env.setdefault("KFT_INIT_TIMEOUT_S", "45")
            # the JAX runtime's missed-heartbeat kill, pushed past every heal
            # horizon there; the port's group has no heartbeat service, and
            # the worker block stays the JAX launcher's
            env.setdefault("KFT_MAX_MISSING_HEARTBEATS", "100")
            # peer death is the healer's to judge: an NCCL error aborts the
            # communicator and raises in the worker (2, CleanUpOnly) instead
            # of killing the process; user env wins
            env.setdefault("TORCH_NCCL_ASYNC_ERROR_HANDLING", "2")
        if self.heartbeat_dir:
            # keyed on the peer's identity, not its rank: ranks shift
            env["KFT_HEARTBEAT_FILE"] = os.path.join(self.heartbeat_dir,
                                                     f"hb-{peer.host}-{peer.port}")
            # a wedge inside a monitored op keeps the heartbeat fresh (the
            # stall watchdog touches it), so hang detection needs the hard
            # deadline as its complement; user env wins
            env.setdefault("KFT_STALL_DEADLINE_S", "120")
        if self.platform:
            env[PLATFORM] = self.platform
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
