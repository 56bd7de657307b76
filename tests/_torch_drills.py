"""The chaos drills of the port (`kungfu_tpu_torch.chaos.__main__.run_drill`)
on ports of their own, for the CPU tests: the launcher runs with its first
worker port free (not 10000+) and its workers on a loopback alias of the
test's, so drills in parallel test processes never share a port."""
from __future__ import annotations

import sys
import textwrap

from _torch_ranks import MAX_WORKER_PORT, _free_port_range
from kungfu_tpu_torch.store import STORE_PORT_OFFSET

# the launcher with its first worker port at argv[1]
LAUNCHER = textwrap.dedent("""
    import functools, sys
    from kungfu_tpu_torch.plan import peer
    from kungfu_tpu_torch.run.__main__ import main

    base = int(sys.argv[1])
    peer.HostList.gen_peer_list = functools.partialmethod(
        peer.HostList.gen_peer_list, port_base=base, port_limit=base + 64)
    sys.exit(main(sys.argv[2:]))
""")


def ports(np_: int, host: str) -> dict:
    """run_drill's launcher and its flags for workers at free ports on
    `host` (a worker a restart regrows keeps its port)."""
    base = _free_port_range(np_, MAX_WORKER_PORT, (STORE_PORT_OFFSET,))
    return {"launcher": [sys.executable, "-c", LAUNCHER, str(base)],
            "launcher_args": ["-H", f"{host}:{np_}", "-self", host]}


def drill(plan: str, np_: int, host: str, **kw) -> dict:
    """`run_drill(plan, np_, ...)` on ports of its own (`ports`)."""
    from kungfu_tpu_torch.chaos.__main__ import run_drill

    kw.setdefault("timeout_s", 120)
    kw.setdefault("total_samples", 1536)
    return run_drill(plan, np_, extra_env={"OMP_NUM_THREADS": "1", **kw.pop("extra_env", {})},
                     **ports(np_, host), **kw)
