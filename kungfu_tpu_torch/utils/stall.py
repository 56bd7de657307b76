"""Stall detector: a watchdog around collective entry points
(counterpart of kungfu_tpu.utils.stall).

Reference: srcs/go/utils/stalldetector.go:14-46 + KUNGFU_CONFIG_ENABLE_STALL_
DETECTION wrapping every cgo op (libkungfu-comm/main.go:163-179).  A ticker
warns every `period` seconds until the wrapped operation completes; it
catches hung collectives (one process missing from the group, a ring
kernel waiting on a peer that never comes) which otherwise block silently.

Hard deadline (self-healing tier): warnings alone leave a hung worker
wedged forever — no supervisor can distinguish "slow" from "dead".  With
`KFT_STALL_DEADLINE_S` set (or deadline_s= passed), a stall that outlives
the deadline aborts the process (exit 87) so the watch-mode healer sees a
dead worker and can shrink the cluster around it (docs/fault_tolerance.md).
"""
from __future__ import annotations

import contextlib
import os
import sys
import threading
import time

from .log import get_logger

log = get_logger("kungfu.stall")

ENABLED_ENV = "KFT_CONFIG_ENABLE_STALL_DETECTION"
DEADLINE_ENV = "KFT_STALL_DEADLINE_S"
HEARTBEAT_FILE_ENV = "KFT_HEARTBEAT_FILE"
DEFAULT_PERIOD_S = 3.0
STALL_ABORT_EXIT_CODE = 87


def _touch_heartbeat() -> None:
    """Refresh the healer-facing liveness file (if this worker has one).

    The watchdog ticks while the main thread is blocked in a native op, so a
    worker stuck in a monitored collective stays "alive" to the launcher's
    hang detection — the peers blocked on a hung rank must not be killed
    along with it.  The hard deadline (KFT_STALL_DEADLINE_S) is what bounds
    a monitored op; the heartbeat timeout catches wedges OUTSIDE them.
    """
    path = os.environ.get(HEARTBEAT_FILE_ENV)
    if not path:
        return
    try:
        os.utime(path, None)
    except OSError:
        try:
            with open(path, "w"):
                pass
        except OSError:  # pragma: no cover - unwritable heartbeat dir
            pass


def enabled() -> bool:
    from .envflag import env_flag

    return env_flag(ENABLED_ENV)


def deadline_from_env() -> float:
    """Configured hard deadline in seconds; 0 = no deadline."""
    try:
        return float(os.environ.get(DEADLINE_ENV, "") or 0.0)
    except ValueError:
        return 0.0


def _abort(name: str, waited_s: float, deadline_s: float) -> None:  # pragma: no cover
    log.critical(
        "%s stalled for %.0f s, past the %.0f s deadline (%s); aborting so "
        "the supervisor can heal the cluster",
        name, waited_s, deadline_s, DEADLINE_ENV,
    )
    try:  # journal flushes per emit, so the record survives the os._exit
        from ..monitor.journal import journal_event

        journal_event("stall_abort", op=name, waited_s=round(waited_s, 1),
                      deadline_s=deadline_s)
    except Exception:  # noqa: BLE001 - the abort must never be blocked
        pass
    sys.stderr.flush()
    sys.stdout.flush()
    os._exit(STALL_ABORT_EXIT_CODE)


@contextlib.contextmanager
def stall_detector(name: str, period_s: float = DEFAULT_PERIOD_S, force: bool = False,
                   deadline_s: float = None, abort=None):
    """Warn '<name> stalled for N s' every period until the block exits.

    deadline_s=None reads KFT_STALL_DEADLINE_S; a positive deadline arms the
    watchdog even when periodic warnings are off, and fires `abort` (default:
    exit 87) if the block is still running when it expires.
    """
    if deadline_s is None:
        deadline_s = deadline_from_env()
    if not (force or enabled() or deadline_s > 0):
        yield
        return
    done = threading.Event()
    t0 = time.monotonic()
    abort_fn = abort if abort is not None else _abort

    def watch():
        while not done.wait(min(period_s, deadline_s) if deadline_s > 0 else period_s):
            waited = time.monotonic() - t0
            _touch_heartbeat()
            if deadline_s > 0 and waited >= deadline_s:
                abort_fn(name, waited, deadline_s)
                return  # a test abort_fn returns instead of exiting
            log.warning("%s stalled for %.0f s", name, waited)

    th = threading.Thread(target=watch, daemon=True, name=f"stall-{name}")
    th.start()
    try:
        yield
    finally:
        done.set()
