"""Cloud-platform cluster discovery (counterpart of kungfu_tpu.platforms).

Reference: srcs/go/platforms/modelarts — an adapter that derives the peer
list from a managed platform's environment instead of CLI flags.  The
adapters, the JAX package's two:

  * TPU pods (GKE/GCE): `TPU_WORKER_HOSTNAMES` + `TPU_WORKER_ID` (set by the
    TPU runtime / GKE operator) name every host and this worker's index.
  * Generic: `KFT_HOSTS` ("ip:slots,..." host list) + `KFT_SELF_HOST` — for
    any scheduler that can inject env vars.

`discover()` tries each adapter in order and returns (cluster, self_host),
or None so callers fall back to flags.
"""
from __future__ import annotations

import os
from typing import Callable, List, Optional, Tuple

from ..plan import Cluster, HostList

__all__ = ["discover", "from_tpu_pod_env", "from_generic_env", "ADAPTERS"]


def from_tpu_pod_env(env=None) -> Optional[Tuple[Cluster, str]]:
    """TPU pod discovery: one worker process per host, all hosts listed."""
    e = os.environ if env is None else env
    hostnames = e.get("TPU_WORKER_HOSTNAMES", "")
    if not hostnames:
        return None
    hosts = [h.strip() for h in hostnames.split(",") if h.strip()]
    worker_id = int(e.get("TPU_WORKER_ID", "0"))
    hl = HostList.parse(",".join(f"{h}:1" for h in hosts))
    cluster = Cluster.from_hostlist(hl, len(hosts))
    if worker_id >= len(hosts):
        # a silent fallback to hosts[0] would give two processes the same
        # self_host and both would claim host 0's worker slots
        raise ValueError(
            f"TPU_WORKER_ID={worker_id} out of range for "
            f"{len(hosts)} hosts in TPU_WORKER_HOSTNAMES"
        )
    return cluster, hosts[worker_id]


def from_generic_env(env=None) -> Optional[Tuple[Cluster, str]]:
    e = os.environ if env is None else env
    hosts = e.get("KFT_HOSTS", "")
    if not hosts:
        return None
    hl = HostList.parse(hosts)
    np = int(e.get("KFT_NP", str(hl.cap())))
    cluster = Cluster.from_hostlist(hl, np)
    self_host = e.get("KFT_SELF_HOST", hl[0].host)
    return cluster, self_host


ADAPTERS: List[Callable[[], Optional[Tuple[Cluster, str]]]] = [
    from_tpu_pod_env,
    from_generic_env,
]


def discover(env=None) -> Optional[Tuple[Cluster, str]]:
    for adapter in ADAPTERS:
        got = adapter(env)
        if got is not None:
            return got
    return None
