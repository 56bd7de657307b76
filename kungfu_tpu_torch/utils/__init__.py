from .ema import EMA
from .log import get_logger
from .trace import (
    Span,
    TraceBuffer,
    export_chrome_trace,
    global_trace_buffer,
    job_now,
    log_event,
    profile_to,
    record_span,
    trace_scope,
)

__all__ = [
    "get_logger", "EMA",
    "trace_scope", "log_event", "profile_to", "record_span",
    "Span", "TraceBuffer", "export_chrome_trace", "global_trace_buffer",
    "job_now",
]
