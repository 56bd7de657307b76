"""Observability (counterpart of kungfu_tpu.monitor).

Ported so far: the structured event journal (journal.py).  The byte
counters, the Prometheus endpoint, the fleet aggregator and the detectors
arrive with ROADMAP A.8.
"""
from .journal import (  # noqa: F401
    Journal,
    global_journal,
    journal_event,
    merge_journals,
    read_journal,
    set_journal_context,
)
