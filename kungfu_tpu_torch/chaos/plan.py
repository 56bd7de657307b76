"""Declarative fault-plan grammar for the chaos harness (counterpart of
kungfu_tpu.chaos.plan: the same grammar, defaults and refusals).

A plan is a semicolon-separated list of faults, each `kind@key=value:...`:

    KFT_FAULT_PLAN="crash@step=7:rank=2;hang@step=12:rank=1;flap@config_server=3s"

Kinds:

  crash@step=N:rank=R[:code=C]      worker R calls os._exit(C) when its
                                    monotonic step counter reaches N
                                    (default code 41)
  hang@step=N:rank=R[:secs=S]       worker R stops making progress at step N
                                    for S seconds (default: forever) — the
                                    heartbeat/stall machinery must notice
  slow@step=N:rank=R:ms=M[:steps=K] worker R sleeps M ms at the top of each
                                    step in [N, N+K) (K=0: until the end) —
                                    an artificially slow collective
  flap@config_server=D[:after=N]    the config server answers 503 for D
                                    seconds, starting at its (N+1)-th
                                    request (default N=5) — a control-plane
                                    outage window

Serving faults (parsed here; their injectors wait for the serving fleet,
ROADMAP A.2):

  crash_serve@tokens=N:rank=R[:code=C][:tier=prefill|decode]
                                    serving worker R calls os._exit(C) once
                                    its engine has generated >= N tokens
                                    total (default code 45) — a mid-stream
                                    rank kill with requests in flight; the
                                    router must re-queue them, never drop.
                                    With tier= the kill targets a
                                    disaggregated pool: the fault fires only
                                    on a worker of that tier (rank=-1 = the
                                    first such worker to cross the
                                    threshold), and prefill-tier workers
                                    count PREFILLED tokens instead of
                                    generated ones
  slow_serve@phase=P:ms=M[:rank=R][:tier=T][:secs=S][:after=N][:start_after=S2]
                                    delay one SERVING phase: sleep M ms just
                                    before each `P` in {prefill, decode,
                                    kv_ship} executes on matching workers
                                    (rank=-1/absent = all; tier filters a
                                    disaggregated pool).  after=N lets the
                                    first N matching calls through undelayed
                                    and start_after=S2 holds the delay for
                                    S2 seconds from the first matching call
                                    (warmup/compile traffic stays clean);
                                    with secs= the window closes S seconds
                                    after the first delayed call
  burst@tenant=T:rps=R[:secs=S][:start_after=S2]
                                    synthetic TRAFFIC shape, not a fault:
                                    the drill's closed-loop client fires
                                    tenant T's requests open-loop at R
                                    requests/sec for S seconds (default 3),
                                    optionally starting S2 seconds in.
                                    Executed by the serving drill harness
                                    itself (ROADMAP A.2) — it
                                    never arms a worker-side injector, so a
                                    burst plan composes with real faults in
                                    the same string

Checkpoint-integrity faults (the recovery ladder):

  corrupt_ckpt@step=N:rank=R[:ckpt_step=S]
                                    at training step >= N, worker R flips
                                    bytes in the arrays of finalized
                                    checkpoint step S (default: the latest
                                    manifested step) — post-finalize bit
                                    rot; re-arms until a target exists
  crash_in_save@step=S:rank=R[:code=C]
                                    worker R os._exit(C)s while finalizing
                                    checkpoint step S, BETWEEN the leaf
                                    writes (the step directory's rename)
                                    and the manifest rename (default
                                    code 43) — the torn-step shape

Network-level faults (applied from OUTSIDE the workers by the JAX
package's pod harness through netns routes / tc, never in-process; the
port parses them, and its pod harness waits for ROADMAP A.7):

  partition@step=N:hosts=A|B[:heal_after=S]
                                    once the fleet reaches step N, split the
                                    pod: hosts in group A (comma-separated)
                                    cannot reach hosts in group B and vice
                                    versa (bidirectional unreachable routes;
                                    the config server stays reachable from
                                    BOTH sides — the control plane rides a
                                    different network in real pods).  With
                                    heal_after the partition is removed S
                                    seconds later; the runtime must rejoin
                                    WITHOUT a membership shrink
  degrade_link@host=H:latency_ms=L[:loss_pct=P][:rate_mbit=M][:step=N][:duration=S]
                                    shape host H's DCN link: added latency,
                                    packet loss, and/or a bandwidth cap
                                    (netem where available, tbf rate-only
                                    fallback).  Applies at step N (default
                                    0 = from the start); with duration the
                                    degradation is removed S seconds later
  kill_host@step=N:host=H           SIGKILL host H's launcher AND all K of
                                    its workers at once — correlated whole-
                                    host loss; exactly one survivor-side
                                    shrink CAS must remove all K ranks
  kill_coordinator@step=N[:replica=R]
                                    SIGKILL one replica of the replicated
                                    config ensemble once the fleet reaches
                                    step N (replica=-1 / absent = whichever
                                    replica currently holds the leader
                                    lease).  The ensemble must fail over —
                                    a new epoch's leader elected, the dead
                                    replica respawned and snapshot-caught-
                                    up — with zero dropped client requests
                                    and zero lost conditional-PUTs
                                    (the replicated control plane,
                                    ROADMAP A.5c)

Durations accept a trailing "s" or "ms" ("3s", "250ms", bare numbers are
seconds).  Ranks refer to the worker's LAUNCH rank (its rank when the
process first joined), not its current rank — current ranks shift when the
cluster heals or resizes, and a drill's scripted victim must stay the same
process for the replay to be deterministic.  Every fault fires at most once
except `slow` (a window) and `corrupt_ckpt` (re-arms until it corrupts).
"""
from __future__ import annotations

import dataclasses
import os
from typing import List, Optional, Tuple

FAULT_PLAN_ENV = "KFT_FAULT_PLAN"

_KINDS = ("crash", "hang", "slow", "flap", "corrupt_ckpt", "crash_in_save",
          "crash_serve", "slow_serve", "burst", "partition", "degrade_link",
          "kill_host", "kill_coordinator")
SERVE_PHASES = ("prefill", "decode", "kv_ship")
NETWORK_KINDS = ("partition", "degrade_link", "kill_host", "kill_coordinator")
DEFAULT_CRASH_CODE = 41
DEFAULT_CRASH_IN_SAVE_CODE = 43
DEFAULT_CRASH_SERVE_CODE = 45
DEFAULT_FLAP_AFTER = 5


def _duration_s(value: str, what: str) -> float:
    v = value.strip()
    try:
        if v.endswith("ms"):
            return float(v[:-2]) / 1e3
        if v.endswith("s"):
            return float(v[:-1])
        return float(v)
    except ValueError:
        raise ValueError(f"invalid duration {value!r} for {what}") from None


@dataclasses.dataclass(frozen=True)
class Fault:
    kind: str                       # crash | hang | slow | flap
    step: int = -1                  # trigger step (crash/hang/slow)
    rank: int = -1                  # target rank (crash/hang/slow)
    code: int = DEFAULT_CRASH_CODE  # crash exit code
    secs: float = 0.0               # hang duration; 0 = forever
    ms: float = 0.0                 # slow: per-step delay
    steps: int = 0                  # slow: window length; 0 = until end
    duration_s: float = 0.0         # flap: outage window
    after: int = DEFAULT_FLAP_AFTER  # flap: requests served before outage
    ckpt_step: int = -1             # corrupt_ckpt: target step; -1 = latest
    tokens: int = -1                # crash_serve: generated-token trigger
    tier: str = ""                  # crash/slow_serve: pool filter (disagg)
    phase: str = ""                 # slow_serve: serving phase to delay
    start_after_s: float = 0.0      # slow_serve/burst: warmup grace (seconds)
    tenant: str = ""                # burst: tenant to fire traffic as
    rps: float = 0.0                # burst: open-loop request rate
    # network faults (pod harness; hosts/host name netns "hosts", not ranks)
    host: str = ""                  # degrade_link/kill_host target host
    replica: int = -1               # kill_coordinator: config replica; -1 = leader
    groups: Tuple[Tuple[str, ...], ...] = ()  # partition: the two host sides
    heal_after: float = 0.0         # partition: seconds until partition heals
    latency_ms: float = 0.0         # degrade_link: added one-way delay
    loss_pct: float = 0.0           # degrade_link: packet loss percent
    rate_mbit: float = 0.0          # degrade_link: bandwidth cap; 0 = none

    def matches(self, step: int, rank: int) -> bool:
        """True when a worker-side fault fires at (step, rank)."""
        if self.kind == "slow":
            hi = self.step + self.steps if self.steps else None
            in_window = step >= self.step and (hi is None or step < hi)
            return in_window and rank == self.rank
        if self.kind == "corrupt_ckpt":
            # re-arms: a finalized+manifested target may not exist yet at
            # step N under async saves — keep trying until one does
            return step >= self.step and rank == self.rank
        return step == self.step and rank == self.rank


def _parse_one(spec: str) -> Fault:
    kind, sep, rest = spec.partition("@")
    kind = kind.strip()
    if not sep or kind not in _KINDS:
        raise ValueError(
            f"invalid fault {spec!r}: expected kind@key=value with kind in {_KINDS}"
        )
    kv = {}
    for part in rest.split(":"):
        key, eq, value = part.partition("=")
        if not eq:
            raise ValueError(f"invalid fault arg {part!r} in {spec!r}")
        kv[key.strip()] = value.strip()

    if kind == "flap":
        if "config_server" not in kv:
            raise ValueError(f"flap fault needs config_server=<duration>: {spec!r}")
        return Fault(
            kind="flap",
            duration_s=_duration_s(kv.pop("config_server"), spec),
            after=int(kv.pop("after", DEFAULT_FLAP_AFTER)),
            **_reject_leftovers(kv, spec),
        )

    if kind == "crash_serve":
        if "tokens" not in kv or ("rank" not in kv and "tier" not in kv):
            raise ValueError(
                f"crash_serve fault needs tokens= and rank= (or tier=): {spec!r}"
            )
        code = int(kv.pop("code", DEFAULT_CRASH_SERVE_CODE))
        if code == 0:
            raise ValueError(f"crash_serve code must be non-zero: {spec!r}")
        tier = kv.pop("tier", "")
        if tier and tier not in ("prefill", "decode"):
            raise ValueError(f"crash_serve tier must be prefill|decode: {spec!r}")
        rank = int(kv.pop("rank", -1))
        if rank < 0 and not tier:
            raise ValueError(f"crash_serve rank=-1 needs a tier=: {spec!r}")
        return Fault(
            kind="crash_serve", tokens=int(kv.pop("tokens")),
            rank=rank, code=code, tier=tier,
            **_reject_leftovers(kv, spec),
        )

    if kind == "slow_serve":
        if "phase" not in kv or "ms" not in kv:
            raise ValueError(f"slow_serve fault needs phase= and ms=: {spec!r}")
        phase = kv.pop("phase")
        if phase not in SERVE_PHASES:
            raise ValueError(
                f"slow_serve phase must be one of {SERVE_PHASES}: {spec!r}")
        tier = kv.pop("tier", "")
        if tier and tier not in ("prefill", "decode"):
            raise ValueError(f"slow_serve tier must be prefill|decode: {spec!r}")
        return Fault(
            kind="slow_serve", phase=phase,
            ms=_duration_s(kv.pop("ms") + "ms", spec) * 1e3,
            rank=int(kv.pop("rank", -1)), tier=tier,
            secs=_duration_s(kv.pop("secs", "0"), spec),
            after=int(kv.pop("after", 0)),
            start_after_s=_duration_s(kv.pop("start_after", "0"), spec),
            **_reject_leftovers(kv, spec),
        )

    if kind == "burst":
        if "tenant" not in kv or "rps" not in kv:
            raise ValueError(f"burst fault needs tenant= and rps=: {spec!r}")
        rps = float(kv.pop("rps"))
        if rps <= 0:
            raise ValueError(f"burst rps must be > 0: {spec!r}")
        return Fault(
            kind="burst", tenant=kv.pop("tenant"), rps=rps,
            secs=_duration_s(kv.pop("secs", "3"), spec),
            start_after_s=_duration_s(kv.pop("start_after", "0"), spec),
            **_reject_leftovers(kv, spec),
        )

    if kind == "partition":
        if "hosts" not in kv:
            raise ValueError(f"partition fault needs hosts=A|B: {spec!r}")
        groups = _parse_groups(kv.pop("hosts"), spec)
        return Fault(
            kind="partition", step=int(kv.pop("step", 0)), groups=groups,
            heal_after=_duration_s(kv.pop("heal_after", "0"), spec),
            **_reject_leftovers(kv, spec),
        )

    if kind == "degrade_link":
        if "host" not in kv:
            raise ValueError(f"degrade_link fault needs host=: {spec!r}")
        f = dict(
            kind="degrade_link", host=kv.pop("host"),
            step=int(kv.pop("step", 0)),
            latency_ms=float(kv.pop("latency_ms", 0)),
            loss_pct=float(kv.pop("loss_pct", 0)),
            rate_mbit=float(kv.pop("rate_mbit", 0)),
            secs=_duration_s(kv.pop("duration", "0"), spec),
        )
        if not (f["latency_ms"] or f["loss_pct"] or f["rate_mbit"]):
            raise ValueError(
                f"degrade_link needs latency_ms=, loss_pct= or rate_mbit=: {spec!r}"
            )
        return Fault(**f, **_reject_leftovers(kv, spec))

    if kind == "kill_host":
        if "host" not in kv:
            raise ValueError(f"kill_host fault needs host=: {spec!r}")
        return Fault(
            kind="kill_host", step=int(kv.pop("step", 0)),
            host=kv.pop("host"), **_reject_leftovers(kv, spec),
        )

    if kind == "kill_coordinator":
        if "step" not in kv:
            raise ValueError(f"kill_coordinator fault needs step=: {spec!r}")
        return Fault(
            kind="kill_coordinator", step=int(kv.pop("step")),
            replica=int(kv.pop("replica", -1)),
            **_reject_leftovers(kv, spec),
        )

    if "step" not in kv or "rank" not in kv:
        raise ValueError(f"{kind} fault needs step= and rank=: {spec!r}")
    f = dict(kind=kind, step=int(kv.pop("step")), rank=int(kv.pop("rank")))
    if kind == "crash":
        f["code"] = int(kv.pop("code", DEFAULT_CRASH_CODE))
        if f["code"] == 0:
            raise ValueError(f"crash code must be non-zero: {spec!r}")
    elif kind == "crash_in_save":
        f["code"] = int(kv.pop("code", DEFAULT_CRASH_IN_SAVE_CODE))
        if f["code"] == 0:
            raise ValueError(f"crash_in_save code must be non-zero: {spec!r}")
    elif kind == "corrupt_ckpt":
        f["ckpt_step"] = int(kv.pop("ckpt_step", -1))
    elif kind == "hang":
        f["secs"] = _duration_s(kv.pop("secs", "0"), spec)
    elif kind == "slow":
        if "ms" not in kv:
            raise ValueError(f"slow fault needs ms=: {spec!r}")
        f["ms"] = _duration_s(kv.pop("ms") + "ms", spec) * 1e3
        f["steps"] = int(kv.pop("steps", 0))
    return Fault(**f, **_reject_leftovers(kv, spec))


def _parse_groups(value: str, spec: str) -> Tuple[Tuple[str, ...], ...]:
    """"h1,h2|h3,h4" -> (("h1","h2"), ("h3","h4")) — the two partition sides.
    Both sides must be non-empty and disjoint (a host cannot be partitioned
    from itself)."""
    sides = [tuple(h.strip() for h in side.split(",") if h.strip())
             for side in value.split("|")]
    if len(sides) != 2 or not all(sides):
        raise ValueError(
            f"partition hosts must be two |-separated non-empty groups: {spec!r}"
        )
    if set(sides[0]) & set(sides[1]):
        raise ValueError(f"partition groups overlap: {spec!r}")
    return tuple(sides)


def _reject_leftovers(kv: dict, spec: str) -> dict:
    if kv:
        raise ValueError(f"unknown fault args {sorted(kv)} in {spec!r}")
    return {}


@dataclasses.dataclass(frozen=True)
class FaultPlan:
    faults: Tuple[Fault, ...]

    def worker_faults(self) -> Tuple[Fault, ...]:
        """Faults fired from the step loop (ChaosInjector.on_step)."""
        return tuple(
            f for f in self.faults
            if f.kind in ("crash", "hang", "slow", "corrupt_ckpt")
        )

    def save_faults(self) -> Tuple[Fault, ...]:
        """Faults fired from inside the checkpoint write path."""
        return tuple(f for f in self.faults if f.kind == "crash_in_save")

    def serve_faults(self) -> Tuple[Fault, ...]:
        """Faults fired from the serving decode loop (on_serve_tokens)."""
        return tuple(f for f in self.faults if f.kind == "crash_serve")

    def serve_phase_faults(self) -> Tuple[Fault, ...]:
        """Per-phase serving delays (on_serve_phase)."""
        return tuple(f for f in self.faults if f.kind == "slow_serve")

    def burst_faults(self) -> Tuple[Fault, ...]:
        """Synthetic tenant-traffic shapes, executed by the DRILL harness
        (the serving drill), never by a worker-side injector."""
        return tuple(f for f in self.faults if f.kind == "burst")

    def flap_faults(self) -> Tuple[Fault, ...]:
        return tuple(f for f in self.faults if f.kind == "flap")

    def network_faults(self) -> Tuple[Fault, ...]:
        """Faults applied from OUTSIDE the workers by the pod harness
        (netns routes / tc shaping / whole-host kills), in step order."""
        return tuple(sorted(
            (f for f in self.faults if f.kind in NETWORK_KINDS),
            key=lambda f: f.step,
        ))

    def __bool__(self) -> bool:
        return bool(self.faults)


def parse_fault_plan(spec: str) -> FaultPlan:
    """Parse a KFT_FAULT_PLAN string; raises ValueError on malformed plans
    (a chaos drill with a typo'd plan must fail loudly, not run fault-free)."""
    faults: List[Fault] = []
    for part in (spec or "").split(";"):
        part = part.strip()
        if part:
            faults.append(_parse_one(part))
    return FaultPlan(faults=tuple(faults))


def plan_from_env(env: Optional[dict] = None) -> FaultPlan:
    e = os.environ if env is None else env
    return parse_fault_plan(e.get(FAULT_PLAN_ENV, ""))
