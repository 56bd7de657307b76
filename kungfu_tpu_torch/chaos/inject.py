"""Fault injectors: where the declarative plan meets the running system
(counterpart of kungfu_tpu.chaos.inject).

Three injection points:

  ChaosInjector.on_step   called at the top of every elastic training step
                          (elastic/trainer.py): crashes, hangs, slowdowns
                          and checkpoint corruption (`corrupt_ckpt`) fire
                          here, keyed on (step, launch rank), so
                          multi-process tests replay each failure mode
                          deterministically.
  maybe_crash_in_save     called by the checkpoint writer between the leaf
                          writes (the step directory's rename) and the
                          manifest rename: the `crash_in_save` fault kills
                          the primary exactly in the window that leaves a
                          torn (manifest-less) step.
  ServerChaos.should_503  called per request by the config server: a
                          control-plane outage window (the `flap` fault).

All are built from the same KFT_FAULT_PLAN env contract; a process with no
plan pays nothing (injector_from_env returns None, maybe_crash_in_save is a
cached no-op).  The serving hooks (`on_serve_tokens`, `on_serve_phase`)
raise until the serving fleet is ported (ROADMAP A.2).
"""
from __future__ import annotations

import os
import threading
import time
from typing import Callable, Optional, Set

from ..utils import get_logger
from .plan import Fault, FaultPlan, plan_from_env

log = get_logger("kungfu.chaos")


class ChaosInjector:
    """Worker-side fault trigger.  `exit_fn`/`sleep_fn` are injectable for
    unit tests (the real thing calls os._exit, which pytest can't survive)."""

    def __init__(
        self,
        plan: FaultPlan,
        exit_fn: Callable[[int], None] = os._exit,
        sleep_fn: Callable[[float], None] = time.sleep,
    ):
        self.plan = plan
        self._exit = exit_fn
        self._sleep = sleep_fn
        self._fired: Set[Fault] = set()  # one-shot kinds already triggered
        self._slow_announced: Set[Fault] = set()  # slow windows journaled

    def on_step(self, step: int, rank: int, ckpt_dir: str = "") -> None:
        """Fire any fault scheduled for this (step, rank).  Crash and hang
        are one-shot; slow applies per step across its window; corrupt_ckpt
        re-arms until it finds a finalized target in `ckpt_dir`."""
        for f in self.plan.worker_faults():
            if f in self._fired or not f.matches(step, rank):
                continue
            if f.kind == "corrupt_ckpt":
                target = _corrupt_checkpoint(ckpt_dir, f.ckpt_step)
                if target is not None:
                    self._fired.add(f)
                    log.warning("CHAOS: corrupted checkpoint step %d under %s "
                                "(train step %d rank %d)", target, ckpt_dir,
                                step, rank)
                    self._journal("chaos_corrupt_ckpt", step, rank,
                                  ckpt_step=target)
                continue
            if f.kind == "crash":
                self._fired.add(f)
                log.warning("CHAOS: crash at step %d rank %d (exit %d)", step, rank, f.code)
                self._journal("chaos_crash", step, rank, code=f.code)
                self._exit(f.code)
            elif f.kind == "hang":
                self._fired.add(f)
                self._journal("chaos_hang", step, rank, secs=f.secs)
                log.warning(
                    "CHAOS: hang at step %d rank %d (%s)",
                    step, rank, f"{f.secs:.1f}s" if f.secs else "forever",
                )
                if f.secs:
                    self._sleep(f.secs)
                else:
                    while True:  # heartbeat goes stale; the healer kills us
                        self._sleep(3600.0)
            elif f.kind == "slow":
                if f not in self._slow_announced:
                    # journaled once per window so a drill can measure
                    # slow-onset -> straggler_suspected detection latency
                    self._slow_announced.add(f)
                    log.warning("CHAOS: slow window entered at step %d rank %d"
                                " (%.0f ms/step)", step, rank, f.ms)
                    self._journal("chaos_slow", step, rank, ms=f.ms,
                                  steps=f.steps)
                self._sleep(f.ms / 1e3)

    def on_serve_tokens(self, total_tokens: int, rank: int, tier: str = "") -> None:
        """`crash_serve` fires from the serving decode loop, which is not
        ported yet (ROADMAP A.2)."""
        raise NotImplementedError("ChaosInjector.on_serve_tokens: the serving fleet is not "
                                  "ported yet (ROADMAP A.2)")

    def on_serve_phase(self, phase: str, rank: int, tier: str = "") -> None:
        """`slow_serve` delays serving phases, which are not ported yet
        (ROADMAP A.2)."""
        raise NotImplementedError("ChaosInjector.on_serve_phase: the serving fleet is not "
                                  "ported yet (ROADMAP A.2)")

    @staticmethod
    def _journal(event: str, step: int, rank: int, **fields) -> None:
        """Scripted faults stamp the journal (flushed per emit) so a drill's
        timeline shows the injection next to the heal it provoked."""
        from ..monitor.journal import journal_event

        journal_event(event, step=step, launch_rank=rank, **fields)


def injector_from_env() -> Optional[ChaosInjector]:
    """ChaosInjector for this process's KFT_FAULT_PLAN, or None (no plan).
    Covers both the training step faults (on_step) and the serving-loop
    faults (on_serve_tokens) — each loop calls only its own hook."""
    plan = plan_from_env()
    armed = (plan.worker_faults() + plan.serve_faults()
             + plan.serve_phase_faults())
    if not armed:
        return None
    log.info("fault plan armed: %s", ", ".join(f.kind for f in armed))
    return ChaosInjector(plan)


# -- checkpoint-integrity faults -------------------------------------------------------


def _corrupt_checkpoint(ckpt_dir: str, ckpt_step: int = -1) -> Optional[int]:
    """Flip 64 bytes mid-file in every array leaf file (`state/<i>.bin`) of
    a finalized checkpoint step (post-finalize bit rot, the corrupt_ckpt
    fault).  Returns the corrupted step, or None when no target exists yet
    (the fault re-arms).  ckpt_step=-1 targets the latest finalized step.

    "Finalized" means the step directory `<dir>/<step>` exists (its
    appearance is an atomic rename of the writer's temporary directory, so
    presence == leaves written); its integrity manifest may trail it and is
    not required here.  Every leaf is hit, so the damage surfaces as a
    checksum mismatch (or, for a leaf shorter than its record, a reader
    error) at the next verified restore.
    """
    if not ckpt_dir or not os.path.isdir(ckpt_dir):
        return None
    candidates = [int(name) for name in os.listdir(ckpt_dir)
                  if name.isdigit() and os.path.isdir(os.path.join(ckpt_dir, name, "state"))]
    if ckpt_step >= 0:
        if ckpt_step not in candidates:
            return None
        target = ckpt_step
    elif candidates:
        target = max(candidates)
    else:
        return None
    state_root = os.path.join(ckpt_dir, str(target), "state")
    victims = [os.path.join(state_root, f) for f in sorted(os.listdir(state_root))
               if f.endswith(".bin") and os.path.getsize(os.path.join(state_root, f)) > 0]
    if not victims:
        return None
    for victim in victims:
        size = os.path.getsize(victim)
        span = min(64, size)
        with open(victim, "r+b") as f:
            f.seek((size - span) // 2)
            data = f.read(span)
            f.seek(-len(data), 1)
            f.write(bytes(b ^ 0xFF for b in data))
    return target


# crash_in_save state: the checkpoint manager has no rank/injector plumbing,
# so the save-path hook resolves its own plan from env (cached) and the
# elastic loop registers the process's LAUNCH rank once at startup.
_launch_rank = 0
_save_faults: Optional[tuple] = None
_save_fired: Set[Fault] = set()
_crash_exit = os._exit  # injectable for unit tests


def set_launch_rank(rank: int) -> None:
    """Record this process's launch rank for save-path fault matching."""
    global _launch_rank
    _launch_rank = int(rank)


def maybe_crash_in_save(ckpt_step: int) -> None:
    """The crash_in_save hook: called by CheckpointManager's writer between
    the leaf writes of `ckpt_step` (its directory's rename) and the
    manifest rename.  Kills the process
    (os._exit) when the plan schedules it — leaving a finalized-looking but
    manifest-less (torn) step for the restore ladder to demote."""
    global _save_faults
    if _save_faults is None:
        _save_faults = plan_from_env().save_faults()
    for f in _save_faults:
        if f in _save_fired or f.step != int(ckpt_step) or f.rank != _launch_rank:
            continue
        _save_fired.add(f)
        log.warning("CHAOS: crash_in_save at checkpoint step %d (exit %d) — "
                    "arrays committed, manifest NOT renamed", ckpt_step, f.code)
        ChaosInjector._journal("chaos_crash_in_save", ckpt_step, _launch_rank,
                               code=f.code)
        _crash_exit(f.code)


def _reset_save_faults_for_tests() -> None:
    global _save_faults, _launch_rank
    _save_faults = None
    _launch_rank = 0
    _save_fired.clear()


class ServerChaos:
    """Config-server outage windows (`flap@config_server=3s[:after=N]`).

    Deterministic trigger: the (after+1)-th request the server receives opens
    the window; requests inside it are answered 503.  Each flap fault fires
    once.  Thread-safe — the config server handles requests concurrently.
    """

    def __init__(self, plan: FaultPlan, clock: Callable[[], float] = time.monotonic):
        self._flaps = list(plan.flap_faults())
        self._clock = clock
        self._lock = threading.Lock()
        self._requests = 0
        self._window_end = 0.0

    def should_503(self) -> bool:
        with self._lock:
            now = self._clock()
            if now < self._window_end:
                return True
            self._requests += 1
            for f in list(self._flaps):
                if self._requests > f.after:
                    self._flaps.remove(f)
                    self._window_end = now + f.duration_s
                    log.warning(
                        "CHAOS: config server flap for %.1fs (request %d)",
                        f.duration_s, self._requests,
                    )
                    return True
            return False


def server_chaos_from_env() -> Optional[ServerChaos]:
    plan = plan_from_env()
    if not plan.flap_faults():
        return None
    return ServerChaos(plan)
