"""The recovery ladder: tiered state sources the heal path climbs
(counterpart of kungfu_tpu.resilience.ladder).

On a suspected peer failure the elastic loop needs a (step, offset, state)
triple to feed the post-heal resync.  The ladder tries sources from the
fastest and freshest down, journaling every demotion with its reason
(`recovery_demotion`), so the operator can tell why a heal landed where it
did:

  rung "buddy" (in memory, peer-redundant: RPO <= snapshot_every steps):
      "live"      the state before the failed step is intact in place (a
                  failure before the optimizer's update leaves it so)
      "self"      this rank's own rolling RAM snapshot
      "peer:<r>"  the copy we shipped to our buddy, fetched back

  rung "disk" (durable, manifest-verified: RPO <= checkpoint_every steps):
      "step:<n>"  the newest disk step whose manifest verifies; torn,
                  corrupt and manifest-less steps are demoted, older steps
                  tried next

A climb that exhausts every rung returns None and the caller escalates
(the job has lost its state).  The chosen rung and source ride on the heal
event (`recovery_rung`, `recovery_source`) and its `state_source_s`.
``KFT_BUDDY=0`` removes the whole in-memory rung.
"""
from __future__ import annotations

import dataclasses
import time
from typing import Any, Callable, Dict, List, Optional, Tuple

from ..monitor.journal import journal_event
from ..utils import get_logger
from .buddy import BuddySnapshots, buddy_enabled

log = get_logger("kungfu.resilience")


@dataclasses.dataclass
class RecoveryOutcome:
    rung: str                 # "buddy" | "disk"
    source: str               # "live" | "self" | "peer:<r>" | "step:<n>"
    step: int
    offset: int
    params: Any
    opt: Any
    demotions: List[Dict[str, Any]]
    already_durable: bool     # disk sources need no best-effort re-save
    elapsed_s: float = 0.0


def _demote(demotions: List[Dict[str, Any]], candidate: str, reason: str) -> None:
    demotions.append({"candidate": candidate, "reason": reason})
    journal_event("recovery_demotion", candidate=candidate, reason=reason)
    log.warning("recovery ladder: demoting %s (%s)", candidate, reason)


def climb(
    live_fn: Callable[[], Tuple[Any, Any]],
    buddy: Optional[BuddySnapshots],
    ckpt,
    step: int,
    offset: int,
) -> Optional[RecoveryOutcome]:
    """Walk the ladder; returns the first viable state source or None.

    live_fn: () -> (params, opt) of the LIVE state; raises when the failed
      step already changed it in place (the optimizer stepped, or the
      error-feedback residuals hold g + e).
    buddy: the in-memory tier, or None when the job never armed it.
    ckpt: CheckpointManager (restore_latest_verified) or None.
    step/offset: the loop's current progress counters (valid iff "live").
    """
    t0 = time.perf_counter()
    demotions: List[Dict[str, Any]] = []

    def done(rung: str, source: str, s: int, off: int, params: Any, opt: Any,
             durable: bool) -> RecoveryOutcome:
        out = RecoveryOutcome(rung, source, s, off, params, opt,
                              demotions, durable,
                              elapsed_s=round(time.perf_counter() - t0, 4))
        log.info("recovery ladder: rung=%s source=%s step=%d (%d demotions, %.3fs)",
                 rung, source, s, len(demotions), out.elapsed_s)
        return out

    # -- rung: buddy (in-memory) ------------------------------------------------------
    if buddy is not None and buddy_enabled():
        try:
            params, opt = live_fn()
            return done("buddy", "live", step, offset, params, opt, False)
        except Exception as e:  # noqa: BLE001 - poisoned buffers are expected here
            _demote(demotions, "live", f"{type(e).__name__}: {str(e)[:120]}")
        snap = buddy.latest()
        if snap is not None:
            return done("buddy", "self", snap["step"], snap["offset"],
                        snap["state"]["params"], snap["state"]["opt"], False)
        _demote(demotions, "self", "no local snapshot")
        snap = buddy.fetch()
        if snap is not None:
            return done("buddy", f"peer:{buddy.buddy_rank}",
                        snap["step"], snap["offset"],
                        snap["state"]["params"], snap["state"]["opt"], False)
        _demote(demotions, f"peer:{buddy.buddy_rank}",
                "buddy fetch missed" if buddy.buddy_rank >= 0 else "no buddy (n=1)")
    elif buddy is not None:
        _demote(demotions, "buddy", "in-memory tier disabled (KFT_BUDDY=0)")

    # -- rung: disk (manifest-verified, newest -> oldest) -----------------------------
    if ckpt is not None:
        got = ckpt.restore_latest_verified(like=None)
        if got is not None:
            state, meta, s, disk_demotions = got
            demotions.extend(disk_demotions)
            return done("disk", f"step:{s}", int(meta.get("step", s)),
                        int(meta.get("trained_samples", 0)),
                        state["params"], state["opt"], True)
        _demote(demotions, "disk", "no verified checkpoint step")
    else:
        _demote(demotions, "disk", "no checkpoint manager")

    log.critical("recovery ladder exhausted: no viable state source "
                 "(%d demotions)", len(demotions))
    return None
