"""Tracing/profiling: span recorder + torch.profiler integration
(counterpart of kungfu_tpu.utils.trace).

Reference: include/kungfu/utils/trace.hpp (TRACE_SCOPE macros compiled in
behind KUNGFU_ENABLE_TRACE) and the Python event logger stamping times since
proc/job start (srcs/python/kungfu/_utils.py:33-50).

Every scope lands in a per-process ring buffer of `Span`s with
*job-relative monotonic* timestamps, exportable as Chrome-trace/Perfetto
JSON (`export_chrome_trace`); `KFT_TRACE_DUMP_DIR` makes each worker dump
its buffer at exit (and every `KFT_TRACE_FLUSH_S` seconds) so a dead
job's lanes can be merged offline.  The JAX package's monitor endpoint and
fleet aggregator, which serve and merge these buffers, and the
`trace_spans_dropped` counter arrive with ROADMAP A.8; until then the
buffer keeps its own count of dropped spans (`TraceBuffer.dropped`, also
in the export's "otherData").

Clock discipline: durations and timeline positions derive from
`time.monotonic()` only: an NTP step mid-job must never corrupt a span.
Wall-clock is stamped exactly once per process as *anchor metadata* (the
proc-start wall/mono pair below) so offline tooling can align timelines
from hosts whose monotonic clocks are unrelated.

`trace_scope(name)` is a no-op unless KFT_CONFIG_ENABLE_TRACE is set, in
which case it records a span (and logs enter/exit) and, with device=True,
also opens a `torch.profiler.record_function` range so the scope shows up
on the CUDA timeline of a torch.profiler capture.  `profile_to(dir)` wraps
a block in a full `torch.profiler.profile` capture written as a Chrome
trace.

Distributed trace context: a `TraceContext` is a (trace_id, span_id) pair
in the W3C traceparent shape (`00-<32 hex>-<16 hex>-01`,
`format_traceparent`/`parse_traceparent`).  A thread pushes a context with
`trace_context(ctx)`; every `trace_scope` under it allocates a child span
id and re-parents nested scopes, so one request's spans stitch into a
single tree by (trace_id, span_id, parent_id).  `child_span` records a
span under an explicit (possibly remote) parent for phases timed by hand.
"""
from __future__ import annotations

import contextlib
import dataclasses
import json
import os
import threading
import time
from collections import deque
from typing import Any, Dict, Iterator, List, Optional, Sequence, Union

from .log import get_logger

log = get_logger("kungfu.trace")

ENABLE_ENV = "KFT_CONFIG_ENABLE_TRACE"
BUFFER_CAPACITY_ENV = "KFT_TRACE_BUFFER"  # ring capacity, spans
DUMP_DIR_ENV = "KFT_TRACE_DUMP_DIR"  # dump the buffer here at process exit
FLUSH_EVERY_ENV = "KFT_TRACE_FLUSH_S"  # incremental flush period (0 = off)
DEFAULT_CAPACITY = 8192
DEFAULT_FLUSH_S = 10.0

# wall/monotonic anchor pair, stamped once at import (reference
# _utils.py:33-50: the launcher stamps KFT_JOB_START; each worker stamps its
# own proc start).  Durations use the monotonic clock ONLY; the wall stamp
# is anchor metadata for cross-host alignment.
_PROC_START_MONO = time.monotonic()
_PROC_START_WALL = time.time()


def _job_start_wall() -> float:
    v = os.environ.get("KFT_JOB_START")
    try:
        return float(v) if v else _PROC_START_WALL
    except ValueError:
        return _PROC_START_WALL


# job start projected onto this process's monotonic clock: the one place the
# wall clock is consulted; every later stamp is pure monotonic arithmetic,
# so an NTP step mid-job shifts nothing
_JOB_START_MONO = _PROC_START_MONO - (_PROC_START_WALL - _job_start_wall())


def job_now(mono: Optional[float] = None) -> float:
    """Seconds since job start, on the monotonic clock."""
    return (time.monotonic() if mono is None else mono) - _JOB_START_MONO


def enabled() -> bool:
    from .envflag import env_flag

    return env_flag(ENABLE_ENV)


# -- distributed trace context ---------------------------------------------------------

#: the header carrying the context across serving HTTP hops (W3C name)
TRACEPARENT_HEADER = "traceparent"
_HEX = frozenset("0123456789abcdef")


@dataclasses.dataclass(frozen=True)
class TraceContext:
    """One hop's position in a distributed trace: the trace and the span
    that any child spans recorded under this context parent to."""

    trace_id: str  # 32 lowercase hex chars
    span_id: str   # 16 lowercase hex chars ("" = trace-only context)


def new_trace_id() -> str:
    return os.urandom(16).hex()


def new_span_id() -> str:
    return os.urandom(8).hex()


def format_traceparent(ctx: TraceContext) -> str:
    """W3C-traceparent-style wire form: `00-<trace_id>-<span_id>-01`."""
    return f"00-{ctx.trace_id}-{ctx.span_id}-01"


def parse_traceparent(header: Optional[str]) -> Optional[TraceContext]:
    """TraceContext from a traceparent header, or None on any malformation
    (a bad header degrades to an untraced request, never an error)."""
    parts = (header or "").strip().lower().split("-")
    if len(parts) != 4:
        return None
    ver, trace_id, span_id, flags = parts
    if len(ver) != 2 or len(trace_id) != 32 or len(span_id) != 16:
        return None
    if not (set(ver) <= _HEX and set(trace_id) <= _HEX
            and set(span_id) <= _HEX and set(flags) <= _HEX):
        return None
    if trace_id == "0" * 32 or span_id == "0" * 16:
        return None
    return TraceContext(trace_id=trace_id, span_id=span_id)


_ctx_tls = threading.local()


def current_context() -> Optional[TraceContext]:
    """The thread's innermost active TraceContext, or None."""
    stack = getattr(_ctx_tls, "stack", None)
    return stack[-1] if stack else None


@contextlib.contextmanager
def trace_context(ctx: Optional[TraceContext]) -> Iterator[Optional[TraceContext]]:
    """Make `ctx` the thread's current context for the block (None = no-op,
    so callers can pass through an unparsed/absent header unconditionally)."""
    if ctx is None:
        yield None
        return
    stack = getattr(_ctx_tls, "stack", None)
    if stack is None:
        stack = _ctx_tls.stack = []
    stack.append(ctx)
    try:
        yield ctx
    finally:
        stack.pop()


@dataclasses.dataclass
class Span:
    """One recorded scope: job-relative start + duration, both monotonic."""

    name: str
    t_start: float  # seconds since job start
    dur: float  # seconds; 0.0 for instant events
    cat: str = ""
    tid: int = 0
    phase: str = "X"  # Chrome trace phase: "X" complete, "i" instant
    args: Optional[Dict[str, Any]] = None
    # distributed trace identity; empty on purely-local spans
    trace_id: str = ""
    span_id: str = ""
    parent_id: str = ""

    def to_chrome(self, pid: Union[int, str]) -> Dict[str, Any]:
        ev: Dict[str, Any] = {
            "name": self.name,
            "cat": self.cat or "kungfu",
            "ph": self.phase,
            "ts": round(self.t_start * 1e6, 1),  # Chrome trace wants us
            "pid": pid,
            "tid": self.tid,
        }
        if self.phase == "X":
            ev["dur"] = round(self.dur * 1e6, 1)
        else:
            ev["s"] = "t"  # thread-scoped instant
        args = dict(self.args) if self.args else {}
        if self.span_id:
            # trace identity rides in args so the Chrome export round-trips
            # through /trace scrapes and offline dumps unchanged
            args["span_id"] = self.span_id
            if self.trace_id:
                args["trace_id"] = self.trace_id
            if self.parent_id:
                args["parent_id"] = self.parent_id
        if args:
            ev["args"] = args
        return ev


class TraceBuffer:
    """Bounded thread-safe ring of Spans (oldest dropped first)."""

    def __init__(self, capacity: Optional[int] = None):
        if capacity is None:
            try:
                capacity = int(os.environ.get(BUFFER_CAPACITY_ENV, "") or DEFAULT_CAPACITY)
            except ValueError:
                capacity = DEFAULT_CAPACITY
        self.capacity = max(1, capacity)
        self._lock = threading.Lock()
        self._spans: deque = deque(maxlen=self.capacity)
        self._dropped = 0

    def add(self, span: Span) -> None:
        with self._lock:
            # a truncated trace must be tellable from a short one: the
            # count rides in the export so readers see that spans fell off
            # the ring before they were read
            if len(self._spans) == self.capacity:
                self._dropped += 1
            self._spans.append(span)

    def spans(self) -> List[Span]:
        with self._lock:
            return list(self._spans)

    def clear(self) -> None:
        with self._lock:
            self._spans.clear()
            self._dropped = 0

    def __len__(self) -> int:
        with self._lock:
            return len(self._spans)

    @property
    def dropped(self) -> int:
        with self._lock:
            return self._dropped


def export_chrome_trace(
    spans: Union[TraceBuffer, Sequence[Span]],
    pid: Optional[Union[int, str]] = None,
    process_name: str = "",
) -> Dict[str, Any]:
    """Chrome-trace/Perfetto JSON object for one process's spans.

    Open the written file in https://ui.perfetto.dev or chrome://tracing.
    The wall/monotonic anchor pair rides along under "otherData" so offline
    merges can align timelines across hosts.
    """
    dropped = None
    if isinstance(spans, TraceBuffer):
        dropped = spans.dropped
        spans = spans.spans()
    if pid is None:
        pid = os.getpid()
    events: List[Dict[str, Any]] = []
    if process_name:
        events.append({
            "name": "process_name", "ph": "M", "pid": pid, "tid": 0,
            "args": {"name": process_name},
        })
    events.extend(s.to_chrome(pid) for s in spans)
    other: Dict[str, Any] = {
        "proc_start_wall": _PROC_START_WALL,
        "job_start_wall": _job_start_wall(),
    }
    if dropped is not None:
        # assemblers use this to mark timelines whose spans fell off the
        # ring as truncated rather than presenting a misleading tree
        other["spans_dropped"] = dropped
    return {
        "traceEvents": events,
        "displayTimeUnit": "ms",
        "otherData": other,
    }


# -- global per-process buffer ---------------------------------------------------------

_global_buffer: Optional[TraceBuffer] = None
_global_lock = threading.Lock()


def _dump_identity() -> str:
    spec = os.environ.get("KFT_SELF_SPEC", "")
    if spec:
        return spec.replace(":", "-").replace("/", "-")
    return f"pid{os.getpid()}"


def flush_dump(reason: str = "manual") -> Optional[str]:
    """Write the span ring to KFT_TRACE_DUMP_DIR *now*, atomically.

    Crash durability: the exit-time dump never runs for a rank that dies by
    SIGKILL or `os._exit` (stall kill, chaos crash, OOM), so its lane used
    to vanish from post-mortem timelines.  The periodic flush thread (and
    the SIGTERM/preemption path) call this instead — tmp-file + rename, so
    a kill mid-write leaves the previous complete dump, never a torn one.
    Returns the written path, or None (not configured / empty / IO error —
    a flush must never take the process down)."""
    d = os.environ.get(DUMP_DIR_ENV)
    buf = _global_buffer
    if not d or buf is None or len(buf) == 0:
        return None
    try:
        os.makedirs(d, exist_ok=True)
        path = os.path.join(d, f"trace-{_dump_identity()}.json")
        tmp = f"{path}.tmp{os.getpid()}"
        with open(tmp, "w") as f:
            json.dump(export_chrome_trace(buf, process_name=_dump_identity()), f)
        os.replace(tmp, path)
        log.info("trace buffer flushed to %s (%d spans, %s)",
                 path, len(buf), reason)
        return path
    except OSError as e:
        log.warning("trace flush (%s) failed: %s", reason, e)
        return None


def _dump_at_exit() -> None:  # pragma: no cover - exercised in subprocess drills
    flush_dump("exit")


def _flush_interval_s() -> float:
    try:
        v = os.environ.get(FLUSH_EVERY_ENV, "")
        return max(0.0, float(v)) if v else DEFAULT_FLUSH_S
    except ValueError:
        return DEFAULT_FLUSH_S


_flush_thread: Optional[threading.Thread] = None


def _start_flush_thread() -> None:
    """Daemon flusher so a crashed rank's lane is at most one interval
    stale in the dump dir.  Started once, only when a dump dir is set."""
    global _flush_thread
    interval = _flush_interval_s()
    if interval <= 0 or _flush_thread is not None:
        return

    def loop() -> None:  # pragma: no cover - timing loop; flush_dump is tested
        while True:
            time.sleep(interval)
            flush_dump("periodic")

    _flush_thread = threading.Thread(target=loop, daemon=True,
                                     name="kft-trace-flush")
    _flush_thread.start()


def global_trace_buffer() -> TraceBuffer:
    """The process-wide span ring (what /trace serves and trace_scope fills)."""
    global _global_buffer
    if _global_buffer is None:
        with _global_lock:
            if _global_buffer is None:
                _global_buffer = TraceBuffer()
                if os.environ.get(DUMP_DIR_ENV):
                    import atexit

                    atexit.register(_dump_at_exit)
                    _start_flush_thread()
    return _global_buffer


def record_span(name: str, t0_mono: float, t1_mono: Optional[float] = None,
                cat: str = "", args: Optional[Dict[str, Any]] = None) -> None:
    """Record a span from explicit monotonic stamps (for phases timed by
    hand, e.g. the heal decomposition).  No-op when tracing is off.  Under
    an active TraceContext the span joins that trace as a child."""
    if not enabled():
        return
    t1 = time.monotonic() if t1_mono is None else t1_mono
    ctx = current_context()
    global_trace_buffer().add(Span(
        name=name, t_start=job_now(t0_mono), dur=max(0.0, t1 - t0_mono),
        cat=cat, tid=threading.get_ident() & 0x7FFFFFFF, args=args,
        trace_id=ctx.trace_id if ctx else "",
        span_id=new_span_id() if ctx else "",
        parent_id=ctx.span_id if ctx else "",
    ))


def child_span(name: str, t0_mono: float, t1_mono: Optional[float] = None,
               *, trace_id: str, parent_id: str = "", span_id: str = "",
               cat: str = "", args: Optional[Dict[str, Any]] = None) -> str:
    """Record one span under an explicit (possibly remote) parent — the
    cross-process hop primitive: the parent span id arrived over the wire
    (traceparent header / request body), not from this thread's context.
    Returns the recorded span's id ("" when tracing is off or no trace_id),
    so callers can hand it to the NEXT hop as its parent."""
    if not enabled() or not trace_id:
        return ""
    sid = span_id or new_span_id()
    t1 = time.monotonic() if t1_mono is None else t1_mono
    global_trace_buffer().add(Span(
        name=name, t_start=job_now(t0_mono), dur=max(0.0, t1 - t0_mono),
        cat=cat, tid=threading.get_ident() & 0x7FFFFFFF, args=args,
        trace_id=trace_id, span_id=sid, parent_id=parent_id,
    ))
    return sid


def log_event(name: str, **args: Any) -> None:
    """One-line event + an instant span in the buffer (t on the monotonic
    job clock; wall time appears only in the export's anchor metadata).
    Under an active TraceContext the instant joins that trace."""
    if not enabled():
        return
    t = job_now()
    log.info("[event] %s +%.3fs job +%.3fs proc", name, t,
             time.monotonic() - _PROC_START_MONO)
    ctx = current_context()
    global_trace_buffer().add(Span(
        name=name, t_start=t, dur=0.0, cat="event", phase="i",
        tid=threading.get_ident() & 0x7FFFFFFF, args=args or None,
        trace_id=ctx.trace_id if ctx else "",
        span_id=new_span_id() if ctx else "",
        parent_id=ctx.span_id if ctx else "",
    ))


@contextlib.contextmanager
def trace_scope(name: str, device: bool = False, cat: str = "",
                args: Optional[Dict[str, Any]] = None,
                track: bool = False) -> Iterator[None]:
    """Scoped span: recorded in the ring buffer + timing log; with
    device=True also a `torch.profiler.record_function` range on the
    profiler's timeline.  Nesting is free — Chrome
    trace viewers nest "X" events by ts/dur containment per thread.

    Under an active TraceContext the scope allocates a child span id and
    becomes the current context for its body, so nested scopes chain into
    the distributed span tree.  `track=True` allocates a span id even with
    no context — for batch-level spans (one decode step serving many
    requests) that need a stable dedup identity without belonging to a
    single trace.  `args` is held by reference and serialized at scrape
    time, so a scope body may fill in outcome fields (e.g. per-round
    acceptance) before it closes."""
    if not enabled():
        yield
        return
    ann = None
    if device:
        import torch.profiler

        ann = torch.profiler.record_function(name)
        ann.__enter__()
    parent = current_context()
    sid = new_span_id() if (parent is not None or track) else ""
    child = TraceContext(parent.trace_id, sid) if parent is not None else None
    t0 = time.monotonic()
    try:
        with trace_context(child):
            yield
    finally:
        t1 = time.monotonic()
        if ann is not None:
            ann.__exit__(None, None, None)
        global_trace_buffer().add(Span(
            name=name, t_start=job_now(t0), dur=t1 - t0, cat=cat,
            tid=threading.get_ident() & 0x7FFFFFFF, args=args,
            trace_id=parent.trace_id if parent else "",
            span_id=sid,
            parent_id=parent.span_id if parent else "",
        ))
        log.info("[trace] %s took %.3f ms", name, (t1 - t0) * 1e3)


@contextlib.contextmanager
def profile_to(logdir: str) -> Iterator[None]:
    """Full torch.profiler capture of the block (the CPU, and the card when
    there is one) into `logdir/trace-<pid>.json` (Chrome trace, Perfetto-
    viewable)."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(logdir, exist_ok=True)
    path = os.path.join(logdir, f"trace-{os.getpid()}.json")
    with profile(activities=activities) as prof:
        yield
    prof.export_chrome_trace(path)
    log.info("profile written to %s", path)
