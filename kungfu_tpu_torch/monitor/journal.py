"""Structured event journal: append-only JSONL of lifecycle events
(counterpart of kungfu_tpu.monitor.journal; the two read and write the
same records).

The paper's adaptation story (heals, resizes, strategy switches, compression
bit-width changes) used to vanish into per-worker stdout; this journal makes
it a durable, mergeable record.  Every line is one event:

    {"event": "heal", "t_wall": 1722770000.123, "t_job": 41.52,
     "rank": 0, "cluster_version": 3, "old_size": 3, "new_size": 2,
     "mttr_s": 1.8, "phases": {...}}

Common stamps on every record:

  t_wall          wall-clock seconds (epoch) — cross-host merge key ONLY
  t_job           seconds since job start on the monotonic clock
                  (utils.trace.job_now — NTP-step immune)
  rank            emitting worker's rank at emission time ("launcher" for
                  runner-side events), from the journal context
  cluster_version cluster document version at emission time

Enablement: KFT_JOURNAL_FILE names one file, or KFT_JOURNAL_DIR names a
directory in which each process appends to its own `journal-<identity>.jsonl`
(identity = KFT_SELF_SPEC for workers — stable across rank shifts — else a
label set via set_journal_context, else the pid).  With neither env set,
journal_event is a no-op costing one dict lookup.

Size control: `KFT_JOURNAL_MAX_MB` caps each journal file — when an emit
pushes the file past the cap it rotates (`.2` dropped, `.1` -> `.2`,
live -> `.1`, all atomic renames, then a fresh live file), so a 64+-rank
fleet's journal volume (ROADMAP item 1's open stressor) is bounded at
~3x the cap per process instead of unbounded.  Readers walk rotated
segments oldest-first: `segment_paths` / `read_journal_segments`, and
`merge_journals` folds them in automatically.

Offline: read_journal / merge_journals for a dead job's files.  The
launcher's `-telemetry` flag and the `--merge` CLI arrive with ROADMAP
A.8.
"""
from __future__ import annotations

import json
import os
import threading
import time
from typing import Any, Dict, List, Optional, Sequence, Union

from ..utils import get_logger

log = get_logger("kungfu.journal")

JOURNAL_FILE_ENV = "KFT_JOURNAL_FILE"
JOURNAL_DIR_ENV = "KFT_JOURNAL_DIR"
JOURNAL_MAX_MB_ENV = "KFT_JOURNAL_MAX_MB"  # per-file cap; 0/unset = unbounded
JOURNAL_STRICT_ENV = "KFT_JOURNAL_STRICT"  # 1 = unknown kind / missing field raises
ROTATE_KEEP = 2  # rotated segments kept per journal (.1 newer, .2 older)

#: The registry every journal emit is checked against: event kind -> the
#: fields a consumer (drill assertion, docs/observability.md table,
#: monitor CLI) may rely on; the same table as the JAX package's, so a
#: record one package writes validates in the other.  At
#: runtime, validation only *raises* under KFT_JOURNAL_STRICT=1 or
#: KUNGFU_ANALYZE=1 (journal_event's never-raise contract holds in
#: production — an unregistered kind is journaled anyway and logged).
EVENT_KINDS: Dict[str, tuple] = {
    # training lifecycle (elastic/trainer.py, distributed.py)
    "heal": ("mttr_s",),
    "resize": ("old_size", "new_size", "version"),
    "resume": ("step", "ckpt_step"),
    "preemption": ("step",),
    "peer_failure_suspected": ("reason", "step"),
    "recovery_exhausted": ("reason",),
    "dirty_teardown": ("duration_s",),
    "checkpoint_resume_skipped": ("directory",),
    # checkpoint integrity (checkpoint.py, resilience/)
    "checkpoint_demoted": ("step", "reason"),
    "checkpoint_restored": ("step",),
    "checkpoint_save_failed": ("step", "error"),
    "recovery_demotion": ("candidate", "reason"),
    "buddy_colocated": ("rank", "buddy"),
    "buddy_ship_failed": ("buddy", "step"),
    # launcher / healer (run/launcher.py)
    "worker_failure": ("peer", "rc"),
    "worker_restart": ("peer",),
    "worker_slow": ("peer",),
    "stall_kill": ("peer",),
    "stall_abort": ("op", "waited_s"),
    "heal_shrink": ("old_size", "new_size"),
    "host_heal_shrink": ("host", "old_size", "new_size"),
    "host_suspected": ("host",),
    "host_suspect_cleared": ("host",),
    "partition_suspected": ("hosts", "suspects"),
    "partition_cleared": ("hosts",),
    "stale_flows_killed": ("host",),
    "reconvene": ("cluster_version", "size"),
    # adaptation (session.py, policy.py, monitor/interference.py)
    "strategy_switch": ("old", "new"),
    "compression_switch": ("old", "new"),
    "interference_vote": ("old", "new"),
    "policy_error": ("policy", "error"),
    "straggler_response": ("grade", "ranks"),
    # planner / tuner (planner/core.py, tuner/core.py)
    "plan_selected": ("plan", "algorithm", "source"),
    "plan_rejected": ("plan", "reason"),
    "replan": ("reason",),
    "tuner_selected": ("config", "source"),
    "tuner_rejected": ("config", "reason"),
    "tuner_measure_failed": ("config", "error"),
    # monitor detectors (monitor/straggler.py, monitor/slo.py)
    "straggler_suspected": ("rank",),
    "straggler_cleared": ("rank",),
    "input_starvation": ("rank",),
    "link_hotspot": ("link",),
    "anomaly_regression": ("metric", "ratio"),
    "anomaly_cleared": ("metric",),
    "slo_breach": ("rule", "metric"),
    "slo_cleared": ("rule", "metric"),
    # serving (serving/*)
    "rank_rejoined": ("rank", "recovery_rung"),
    "worker_unhealthy": ("peer",),
    "request_requeued": ("req_id",),
    "requeued_request_completed": ("req_id", "requeues"),
    "scale_up": ("old_size", "new_size"),
    "scale_down": ("old_size", "new_size"),
    "kv_shipped": ("req_id", "tokens"),
    "prefix_evicted": ("bytes",),
    "prefix_invalidated": ("reason",),
    "spec_disabled": ("accept_ema",),
    "slot_preempted": ("req_id", "slot"),
    "preempted_readmitted": ("req_id", "slot"),
    "tenant_rate_limited": ("tenant",),
    "overload_shed": ("req_id", "rung"),
    "overload_clamp": ("req_id", "tenant"),
    "overload_deadline_extended": ("req_id", "tenant"),
    "overload_rung_changed": ("from_rung", "to_rung"),
    # replicated control plane (elastic/config_server.py, elastic/ensemble.py)
    "leader_elected": ("leader_epoch", "replica"),
    "leader_lost": ("leader_epoch", "replica"),
    "replica_respawned": ("replica",),
    # chaos injection (chaos/inject.py)
    "chaos_crash": ("code",),
    "chaos_crash_serve": ("code",),
    "chaos_crash_in_save": ("code",),
    "chaos_hang": ("secs",),
    "chaos_slow": ("ms",),
    "chaos_slow_serve": ("phase",),
    "chaos_corrupt_ckpt": ("ckpt_step",),
    # program observatory (monitor/programs.py)
    "program_compiled": ("program", "digest", "compile_ms"),
    "recompile_storm": ("program", "recompiles", "window_s"),
    "sig_budget_exceeded": ("program", "budget", "signatures"),
    "hbm_footprint": ("program", "predicted_bytes", "measured_bytes", "rel_err"),
    # benchmark harness (benchmarks/runner.py)
    "bench_probe_failed": ("section",),
    "bench_probe_recovered": ("section",),
    "bench_requeued": ("section",),
    "bench_section_failed": ("section",),
}


def _strict() -> bool:
    return (os.environ.get(JOURNAL_STRICT_ENV, "") == "1"
            or os.environ.get("KUNGFU_ANALYZE", "") == "1")


def validate_event(event: str, fields: Dict[str, Any]) -> Optional[str]:
    """Registry check for one emit; returns a problem string or None."""
    spec = EVENT_KINDS.get(event)
    if spec is None:
        return (f"journal kind {event!r} is not registered in "
                "monitor.journal.EVENT_KINDS")
    missing = [f for f in spec if f not in fields]
    if missing:
        return (f"journal kind {event!r} missing required field(s) "
                f"{missing} (registry: {list(spec)})")
    return None


def _max_bytes_from_env() -> int:
    try:
        v = os.environ.get(JOURNAL_MAX_MB_ENV, "")
        return max(0, int(float(v) * 1024 * 1024)) if v else 0
    except ValueError:
        return 0

# late-bound identity stamps: Peer.start()/update_cluster refresh rank and
# cluster_version; the launcher labels itself "launcher"
_context: Dict[str, Any] = {"rank": None, "cluster_version": None, "identity": ""}


def set_journal_context(rank: Optional[Union[int, str]] = None,
                        cluster_version: Optional[int] = None,
                        identity: Optional[str] = None) -> None:
    """Update the stamps merged into every subsequent record."""
    if rank is not None:
        _context["rank"] = rank
    if cluster_version is not None:
        _context["cluster_version"] = cluster_version
    if identity is not None:
        _context["identity"] = identity


class Journal:
    """One append-only JSONL file; every emit is flushed (events must
    survive an os._exit two lines later).  With a size cap, the file
    rotates through `.1`/`.2` suffixes via atomic renames — an emit
    landing mid-rotation still goes to A journal, never to a closed fd."""

    def __init__(self, path: str, max_bytes: Optional[int] = None):
        self.path = path
        self.max_bytes = (_max_bytes_from_env() if max_bytes is None
                          else max(0, int(max_bytes)))
        self.rotations = 0
        self._lock = threading.Lock()
        d = os.path.dirname(path)
        if d:
            os.makedirs(d, exist_ok=True)
        self._f = open(path, "a", encoding="utf-8")

    def _rotate_locked(self) -> None:
        """Shift segments (oldest dropped by the `.1` -> `.2` replace) and
        reopen a fresh live file.  Rename failures abort the rotation but
        never the emit — a full disk loses history, not events."""
        try:
            self._f.close()
        except OSError:  # pragma: no cover
            pass
        try:
            for i in range(ROTATE_KEEP, 1, -1):
                older = f"{self.path}.{i - 1}"
                if os.path.exists(older):
                    os.replace(older, f"{self.path}.{i}")
            os.replace(self.path, f"{self.path}.1")
            self.rotations += 1
        except OSError as e:
            log.warning("journal rotation of %s failed: %s", self.path, e)
        self._f = open(self.path, "a", encoding="utf-8")

    def emit(self, event: str, **fields: Any) -> None:
        from ..utils.trace import current_context, job_now

        rec: Dict[str, Any] = {
            "event": event,
            "t_wall": round(time.time(), 6),
            "t_job": round(job_now(), 4),
            "rank": _context["rank"],
            "cluster_version": _context["cluster_version"],
        }
        # request correlation: an event emitted under an active distributed
        # trace context carries its trace_id, so `--merge` can join journal
        # and trace offline (request-scoped emitters may also pass trace_id
        # explicitly — explicit fields win below)
        ctx = current_context()
        if ctx is not None:
            rec["trace_id"] = ctx.trace_id
        rec.update(fields)  # explicit fields win over context stamps
        if "trace_id" in rec and not rec["trace_id"]:
            del rec["trace_id"]  # an untraced request stamps nothing
        line = json.dumps(rec, default=str)
        with self._lock:
            self._f.write(line + "\n")
            self._f.flush()
            if self.max_bytes and self._f.tell() >= self.max_bytes:
                self._rotate_locked()

    def close(self) -> None:
        with self._lock:
            try:
                self._f.close()
            except OSError:  # pragma: no cover
                pass


_global: Optional[Journal] = None
_resolved = False
_global_lock = threading.Lock()


def _identity() -> str:
    spec = os.environ.get("KFT_SELF_SPEC", "")
    if spec:
        return spec.replace(":", "-").replace("/", "-")
    if _context["identity"]:
        return str(_context["identity"])
    return f"pid{os.getpid()}"


def global_journal() -> Optional[Journal]:
    """The process journal, or None when journaling is not configured."""
    global _global, _resolved
    if _resolved:
        return _global
    with _global_lock:
        if _resolved:
            return _global
        path = os.environ.get(JOURNAL_FILE_ENV, "")
        if not path:
            d = os.environ.get(JOURNAL_DIR_ENV, "")
            if d:
                path = os.path.join(d, f"journal-{_identity()}.jsonl")
        if path:
            try:
                _global = Journal(path)
            except OSError as e:
                log.warning("journal disabled (cannot open %s): %s", path, e)
                _global = None
        _resolved = True
        return _global


def journal_event(event: str, **fields: Any) -> None:
    """Emit one lifecycle event; never raises in production (the record is
    journaled even when it fails the registry check), but under
    KFT_JOURNAL_STRICT=1 / KUNGFU_ANALYZE=1 a registry violation raises —
    the mode tests and the analysis CLI run in."""
    problem = validate_event(event, fields)
    if problem is not None:
        if _strict():
            raise ValueError(problem)
        log.debug("%s", problem)
    j = global_journal()
    if j is None:
        return
    try:
        j.emit(event, **fields)
    except (OSError, ValueError) as e:  # journaling must never kill training
        log.warning("journal emit failed: %s", e)


def _reset_for_tests() -> None:
    """Drop the cached journal so tests can re-resolve a fresh env."""
    global _global, _resolved
    with _global_lock:
        if _global is not None:
            _global.close()
        _global = None
        _resolved = False


# -- readers ---------------------------------------------------------------------------


def segment_paths(path: str) -> List[str]:
    """Every existing segment of one journal, OLDEST first (`.2`, `.1`,
    then the live file) — the order that keeps per-process event order
    intact across rotations."""
    out = [f"{path}.{i}" for i in range(ROTATE_KEEP, 0, -1)
           if os.path.exists(f"{path}.{i}")]
    if os.path.exists(path):
        out.append(path)
    return out


def read_journal_segments(path: str) -> List[Dict[str, Any]]:
    """read_journal across every rotated segment, oldest first."""
    out: List[Dict[str, Any]] = []
    for p in segment_paths(path):
        out.extend(read_journal(p))
    return out


def read_journal(path: str) -> List[Dict[str, Any]]:
    """Parse one JSONL journal; malformed lines (torn writes from a killed
    process) are skipped, not fatal."""
    out: List[Dict[str, Any]] = []
    with open(path, encoding="utf-8") as f:
        for line in f:
            line = line.strip()
            if not line:
                continue
            try:
                out.append(json.loads(line))
            except ValueError:
                continue
    return out


def filter_events(events: Sequence[Dict[str, Any]],
                  event: Optional[str] = None,
                  **field_eq: Any) -> List[Dict[str, Any]]:
    """Select journal events by name and exact field values — e.g.
    `filter_events(evts, "slot_preempted", tenant="bursty")`.  The
    drill-side workhorse for tenant-scoped assertions: tenancy events all
    stamp a `tenant` field, so per-tenant behaviour reads straight out of
    the merged journal."""
    out = []
    for e in events:
        if event is not None and e.get("event") != event:
            continue
        if any(e.get(k) != v for k, v in field_eq.items()):
            continue
        out.append(e)
    return out


def merge_journals(paths: Sequence[str]) -> List[Dict[str, Any]]:
    """Merge several processes' journals into one wall-clock-ordered list
    (wall time is the only cross-host merge key; per-host ordering is
    already correct within each file).  Each path's rotated segments
    (`.1`/`.2`) are folded in automatically, oldest first."""
    events: List[Dict[str, Any]] = []
    for p in paths:
        try:
            segs = segment_paths(p) or [p]
            for seg in segs:
                events.extend(read_journal(seg))
        except OSError as e:
            log.warning("skipping unreadable journal %s: %s", p, e)
    events.sort(key=lambda e: e.get("t_wall", 0.0))
    return events
