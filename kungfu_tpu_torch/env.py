"""Worker environment contract (counterpart of kungfu_tpu.env).

The launcher configures each worker through these variables:

  KFT_SELF_SPEC            "host:port" identity of this worker
  KFT_INIT_PEERS           comma-separated worker list (rank order)
  KFT_INIT_RUNNERS         comma-separated runner list
  KFT_INIT_CLUSTER_VERSION integer config version at spawn
  KFT_PARENT_ID            "host:port" of the spawning runner
  KFT_ALLREDUCE_STRATEGY   strategy name (plan/strategy.py)
  KFT_CONFIG_SERVER        URL of the elastic config service
  KFT_CONFIG_URLS          comma-separated replica URLs (wins over
                           KFT_CONFIG_SERVER)
  KFT_JOB_START / KFT_PROC_START  timestamps for event tracing
  KFT_PLATFORM             the launcher's -platform: "cpu" puts the Peer and
                           its Session on the CPU; "" or "gpu" on the card
                           (`platform_device`)

Tuning tier: every KFT_CONFIG_* variable of the launcher's environment is
forwarded to the workers (`worker_env`).

Single-process fallback (no KFT_SELF_SPEC): one worker 127.0.0.1:10000,
exactly as the JAX package does.
"""
from __future__ import annotations

import dataclasses
import os
from typing import Dict, List, Optional

from .plan import DEFAULT_STRATEGY, Cluster, PeerID, PeerList, Strategy

SELF_SPEC = "KFT_SELF_SPEC"
INIT_PEERS = "KFT_INIT_PEERS"
INIT_RUNNERS = "KFT_INIT_RUNNERS"
INIT_CLUSTER_VERSION = "KFT_INIT_CLUSTER_VERSION"
PARENT_ID = "KFT_PARENT_ID"
ALLREDUCE_STRATEGY = "KFT_ALLREDUCE_STRATEGY"
CONFIG_SERVER = "KFT_CONFIG_SERVER"
CONFIG_URLS = "KFT_CONFIG_URLS"
JOB_START = "KFT_JOB_START"
PROC_START = "KFT_PROC_START"
PLATFORM = "KFT_PLATFORM"

CONFIG_PREFIX = "KFT_CONFIG_"

ALL_WORKER_ENVS: List[str] = [
    SELF_SPEC, INIT_PEERS, INIT_RUNNERS, INIT_CLUSTER_VERSION,
    PARENT_ID, ALLREDUCE_STRATEGY, CONFIG_SERVER, JOB_START, PROC_START,
]


@dataclasses.dataclass
class Config:
    self_id: PeerID
    peers: PeerList
    runners: PeerList
    cluster_version: int = 0
    strategy: Strategy = DEFAULT_STRATEGY
    config_server: str = ""
    parent: Optional[PeerID] = None
    single_machine: bool = False

    @property
    def rank(self) -> int:
        r = self.peers.rank(self.self_id)
        if r is None:
            raise RuntimeError(f"{self.self_id} not in peer list {self.peers}")
        return r

    def cluster(self) -> Cluster:
        return Cluster(runners=self.runners, workers=self.peers)


def platform_device(env: Optional[Dict[str, str]] = None) -> Optional[str]:
    """The device KFT_PLATFORM asks for: "cpu", or None (the card) for ""
    and "gpu"; anything else raises.  The JAX package hands the same
    variable to jax.config as the platform."""
    plat = (os.environ if env is None else env).get(PLATFORM, "").strip().lower()
    if plat in ("", "gpu"):
        return None
    if plat == "cpu":
        return "cpu"
    raise ValueError(f"{PLATFORM}={plat!r}: the port runs on 'cpu' or 'gpu'")


def _parse_peers(s: str) -> PeerList:
    return PeerList(PeerID.parse(x) for x in s.split(",") if x)


def parse_config_from_env(env: Optional[Dict[str, str]] = None) -> Config:
    e = dict(os.environ if env is None else env)
    strategy = Strategy.parse(e.get(ALLREDUCE_STRATEGY, DEFAULT_STRATEGY.name))
    config_server = e.get(CONFIG_URLS) or e.get(CONFIG_SERVER, "")
    if SELF_SPEC not in e:
        me = PeerID("127.0.0.1", 10000)
        return Config(
            self_id=me,
            peers=PeerList([me]),
            runners=PeerList(),
            single_machine=True,
            strategy=strategy,
            config_server=config_server,
        )
    return Config(
        self_id=PeerID.parse(e[SELF_SPEC]),
        peers=_parse_peers(e.get(INIT_PEERS, e[SELF_SPEC])),
        runners=_parse_peers(e.get(INIT_RUNNERS, "")),
        cluster_version=int(e.get(INIT_CLUSTER_VERSION, "0")),
        strategy=strategy,
        config_server=config_server,
        parent=PeerID.parse(e[PARENT_ID]) if e.get(PARENT_ID) else None,
    )


def worker_env(
    self_id: PeerID,
    cluster: Cluster,
    version: int,
    strategy: Strategy,
    parent: Optional[PeerID] = None,
    config_server: str = "",
) -> Dict[str, str]:
    """Env block the launcher injects into a worker: the same keys and
    values as the JAX package's `worker_env` for the same cluster."""
    env = {
        SELF_SPEC: str(self_id),
        INIT_PEERS: ",".join(str(p) for p in cluster.workers),
        INIT_RUNNERS: ",".join(str(p) for p in cluster.runners),
        INIT_CLUSTER_VERSION: str(version),
        ALLREDUCE_STRATEGY: strategy.name,
    }
    if parent is not None:
        env[PARENT_ID] = str(parent)
    if config_server:
        env[CONFIG_SERVER] = config_server
        if "," in config_server:  # a replicated ensemble rides both variables
            env[CONFIG_URLS] = config_server
    # forward the tuning tier; never clobber the contract above
    # (KFT_CONFIG_SERVER shares the prefix)
    for k, v in os.environ.items():
        if k.startswith(CONFIG_PREFIX) and k not in env and k not in ALL_WORKER_ENVS:
            env[k] = v
    return env
