"""The launcher CLI: `python -m kungfu_tpu_torch.run -np 4 python train.py`.

The JAX package's CLI (kungfu_tpu/run/__main__.py), with its flags: -np,
-H, -self, -strategy, -k, -logdir, -q, -chips-per-host, -platform and
-devices-per-worker, and watch mode: -w runs `launcher.WatchRunner`, which
starts and stops this host's workers as the elastic config service's
document changes (-timeout bounds it: exit 124), against the service at
-config-server URL, or one embedded in this launcher
(-builtin-config-server, or -w without a URL) at -port, or with
-config-replicas N above 1 a supervised ensemble of N replicas
(`elastic.ensemble.ConfigEnsemble`) whose URL list reaches the workers as
KFT_CONFIG_URLS and the runner's failover client.  -heal (implies
-w) makes it the self-healing supervisor: a dead worker is removed from
the document and the survivors heal around it, -restart-budget N restarts
each worker up to N times, -heartbeat-timeout S kills a worker whose
heartbeat file froze (a hang), -suspicion-timeout S judges remote hosts;
the runner prints its heal events as a RUNNER_HEAL_EVENTS line.  Each worker gets the KungFu env
contract (`env.worker_env`) and picks its own card
(`distributed.placement`); -chips-per-host N instead gives each worker one
card slot of N through CUDA_VISIBLE_DEVICES, as the JAX CLI does with
TPU_VISIBLE_CHIPS.  -platform cpu puts the workers' Peer and Session on
the CPU (KFT_PLATFORM); -devices-per-worker takes 1 only (a worker is one
rank with one card).  `-strategy` reaches each worker's Session through
KFT_ALLREDUCE_STRATEGY.  Every other flag of the JAX CLI raises, naming
the ROADMAP item that will port it (A.8: fleet telemetry); none is
ignored.  Multi-host launches over ssh: `run/distribute.py`.
"""
from __future__ import annotations

import argparse
import json
import socket
import sys
import tempfile
from typing import Dict, Optional, Sequence

from ..elastic.config_client import ConfigClient
from ..elastic.config_server import ConfigServer
from ..elastic.ensemble import ConfigEnsemble
from ..plan import Cluster, HostList, Strategy
from .job import Job
from .launcher import WatchRunner, install_signal_trap, simple_run

# flag -> (argparse options, what it does in the JAX CLI, the ROADMAP item
# porting it[, the one value that is ported: the JAX default])
UNPORTED: Dict[str, tuple] = {
    "-telemetry": ({"action": "store_true"}, "fleet telemetry", "A.8"),
    "-telemetry-port": ({"type": int}, "the fleet telemetry port", "A.8"),
    "-slo-file": ({}, "the fleet SLO rules", "A.8"),
    "-slo-exit-code": ({"action": "store_true"}, "the SLO exit code", "A.8"),
}


def infer_self_ip(hostlist: HostList) -> str:
    """Our address in the host list."""
    candidates = {h.host for h in hostlist}
    if "127.0.0.1" in candidates or "localhost" in candidates:
        return "127.0.0.1" if "127.0.0.1" in candidates else "localhost"
    names = {socket.gethostname(), socket.getfqdn()}
    try:
        names.add(socket.gethostbyname(socket.gethostname()))
    except OSError:
        pass
    for c in candidates:
        if c in names:
            return c
    return sorted(candidates)[0]


def _split(argv: Sequence[str], ap: argparse.ArgumentParser):
    """(launcher flags, worker command): the command starts at the first
    argument that is neither a launcher flag nor its value, or after "--".
    argparse never sees the command, so its flags (python -c ...) are never
    taken for the launcher's (-chips-per-host, ...)."""
    takes_value = {opt: a.nargs != 0 for a in ap._actions for opt in a.option_strings}
    i = 0
    while i < len(argv) and argv[i] in takes_value:
        i += 2 if takes_value[argv[i]] else 1
    if argv[i:i + 1] == ["--"]:
        return list(argv[:i]), list(argv[i + 1:])
    return list(argv[:i]), list(argv[i:])


def main(argv: Optional[Sequence[str]] = None) -> int:
    argv = sys.argv[1:] if argv is None else list(argv)
    if argv and argv[0] == "-serve":
        raise NotImplementedError("-serve (the serving fleet) is not ported yet (ROADMAP A2)")
    ap = argparse.ArgumentParser("kungfu_tpu_torch.run",
                                 usage="%(prog)s [flags] [--] worker command ...",
                                 description="launch distributed kungfu_tpu_torch workers")
    ap.add_argument("-np", type=int, default=1, help="total number of workers")
    ap.add_argument("-H", dest="hosts", default="", help="host list ip:slots[:pub],...")
    ap.add_argument("-self", dest="self_host", default="", help="this host's address")
    ap.add_argument("-strategy", default="AUTO", help="allreduce strategy")
    ap.add_argument("-k", dest="keep", action="store_true", help="keep job on worker failure")
    ap.add_argument("-logdir", default="")
    ap.add_argument("-q", dest="quiet", action="store_true")
    ap.add_argument("-chips-per-host", dest="cards_per_host", type=int, default=0,
                    help="give each worker one of this many card slots (CUDA_VISIBLE_DEVICES)")
    ap.add_argument("-platform", default="",
                    help="the workers' device: cpu or gpu (default: the card)")
    ap.add_argument("-devices-per-worker", dest="devices_per_worker", type=int, default=1,
                    help="devices per worker: 1 (a worker is one rank with one card)")
    ap.add_argument("-w", dest="watch", action="store_true",
                    help="watch mode: follow the elastic config service's cluster document")
    ap.add_argument("-config-server", dest="config_server", default="",
                    help="URL of the elastic config service (watch mode)")
    ap.add_argument("-builtin-config-server", dest="builtin_cs", action="store_true",
                    help="embed a config server in this launcher")
    ap.add_argument("-port", type=int, default=None,
                    help="the embedded config server's port (default 9100)")
    ap.add_argument("-config-replicas", dest="config_replicas", type=int, default=1,
                    help="the embedded config service's replicas: above 1 a leader-leased "
                    "ensemble, dead replicas respawned, its URL list handed to the workers "
                    "as KFT_CONFIG_URLS")
    ap.add_argument("-timeout", type=float, default=0.0,
                    help="watch mode: stop the job after this many seconds (exit 124)")
    ap.add_argument("-heal", action="store_true",
                    help="self-heal in watch mode: shrink the cluster around dead workers "
                    "instead of stopping the job (implies -w)")
    ap.add_argument("-restart-budget", dest="restart_budget", type=int, default=0,
                    help="automatic restarts per worker after a heal (exponential backoff)")
    ap.add_argument("-heartbeat-timeout", dest="heartbeat_timeout", type=float, default=0.0,
                    help="seconds without a worker heartbeat before the healer kills it "
                    "(0 = off; catches hung, not crashed, workers)")
    ap.add_argument("-suspicion-timeout", dest="suspicion_timeout", type=float, default=0.0,
                    help="heal mode: seconds a remote host's runner heartbeat must stay "
                    "silent before its workers are shrunk out (0 = from -heartbeat-timeout)")
    for flag, (opts, *_) in UNPORTED.items():
        ap.add_argument(flag, dest="unported_" + flag[1:].replace("-", "_"), default=None,
                        help=argparse.SUPPRESS, **opts)
    flags, prog = _split(argv, ap)
    args = ap.parse_args(flags)
    for flag, (_, what, item, *ported) in UNPORTED.items():
        if getattr(args, "unported_" + flag[1:].replace("-", "_")) not in (None, False,
                                                                              *ported):
            raise NotImplementedError(f"{flag} ({what}) is not ported yet (ROADMAP {item})")
    if args.heal:
        args.watch = True  # healing is a watch-mode capability

    if not prog:
        ap.error("missing worker command")
    hosts = HostList.parse(args.hosts) if args.hosts else HostList.parse(f"127.0.0.1:{args.np}")
    cluster = Cluster.from_hostlist(hosts, args.np)
    self_host = args.self_host or infer_self_ip(hosts)
    embed = args.builtin_cs or (args.watch and not args.config_server)
    if args.timeout and not args.watch:
        ap.error("-timeout bounds watch mode: pass -w")
    if args.port is not None and not embed:
        ap.error("-port is the embedded config server's: pass -builtin-config-server or -w "
                 "without -config-server")
    if args.config_replicas < 1:
        ap.error("-config-replicas takes 1 or more")
    if args.config_replicas > 1 and args.port is not None:
        ap.error("-port is the single embedded config server's: an ensemble takes free ports")
    cs = None
    config_url = args.config_server
    if embed and args.config_replicas > 1:
        cs = ConfigEnsemble(replicas=args.config_replicas, init=cluster).start()
        config_url = cs.urls_spec
    elif embed:
        cs = ConfigServer(port=9100 if args.port is None else args.port, init=cluster).start()
        config_url = cs.url
    heartbeat_dir = ""
    if args.heal and args.heartbeat_timeout > 0:
        heartbeat_dir = tempfile.mkdtemp(prefix="kft-hb-")
    job = Job(prog=prog[0], args=prog[1:], strategy=Strategy.parse(args.strategy),
              cards_per_host=args.cards_per_host, config_server=config_url,
              platform=args.platform, devices_per_worker=args.devices_per_worker,
              heal=args.heal, heartbeat_dir=heartbeat_dir)
    install_signal_trap()
    try:
        if args.watch:
            runner = WatchRunner(job, self_host, ConfigClient(config_url), logdir=args.logdir,
                                 quiet=args.quiet, keep=args.keep, heal=args.heal,
                                 restart_budget=args.restart_budget,
                                 heartbeat_timeout_s=args.heartbeat_timeout,
                                 suspicion_s=args.suspicion_timeout)
            rc = runner.run(initial=cluster, timeout_s=args.timeout)
            if runner.heal_events:
                print("RUNNER_HEAL_EVENTS: " + json.dumps(runner.heal_events), flush=True)
            return rc
        return simple_run(job, cluster, self_host, logdir=args.logdir, quiet=args.quiet,
                          keep=args.keep)
    finally:
        if cs is not None:
            cs.stop()


if __name__ == "__main__":
    sys.exit(main())
