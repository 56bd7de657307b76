"""The port's event journal, span tracer, EMA and env flags against the
JAX package's (monitor/journal.py, utils/trace.py, utils/ema.py,
utils/envflag.py; none of them imports JAX, and the port keeps its own
copies): journals written by either package read back through the other
into the same records, rotated segments included; the traceparent wire
form round-trips across the two; the Chrome export of the same spans is
the same object; a full ring counts what it dropped.
"""
from __future__ import annotations

import json
import os
import types

import pytest

from _torch_reference import jax_reference
from kungfu_tpu_torch.monitor import journal as tjournal
from kungfu_tpu_torch.utils import ema as tema
from kungfu_tpu_torch.utils import envflag as tenvflag
from kungfu_tpu_torch.utils import trace as ttrace


@pytest.fixture(scope="module")
def ref():
    with jax_reference():
        from kungfu_tpu.monitor import journal
        from kungfu_tpu.utils import ema, envflag, trace

        yield types.SimpleNamespace(journal=journal, trace=trace, ema=ema, envflag=envflag)


PORT = types.SimpleNamespace(journal=tjournal, trace=ttrace, ema=tema, envflag=tenvflag)


def _write(pkg, path, monkeypatch, max_mb=None):
    """A few lifecycle events through `journal_event`, one under a trace
    context; with `max_mb` the file rotates."""
    monkeypatch.setenv(pkg.journal.JOURNAL_FILE_ENV, str(path))
    if max_mb is not None:
        monkeypatch.setenv(pkg.journal.JOURNAL_MAX_MB_ENV, str(max_mb))
    pkg.journal._reset_for_tests()
    monkeypatch.setattr(pkg.journal, "_context", dict(pkg.journal._context))  # restored after
    pkg.journal.set_journal_context(rank=1, cluster_version=2)
    for i in range(40 if max_mb else 1):
        pkg.journal.journal_event("compression_switch", old="none", new="int8",
                                  noise_scale=1.5 + i, switches=i + 1)
    pkg.journal.journal_event("policy_error", kind="after_step", policy="P", step=3,
                              error="RuntimeError: boom")
    ctx = pkg.trace.TraceContext("ab" * 16, "cd" * 8)
    with pkg.trace.trace_context(ctx):
        pkg.journal.journal_event("straggler_response", grade="replan", ranks=[2], step=10)
        pkg.journal.journal_event("replan", reason="r", trace_id="")  # untraced: no stamp
    pkg.journal._reset_for_tests()


@pytest.mark.parametrize("writer", ["port", "jax"])
def test_journal_reads_back_in_either_package(ref, tmp_path, monkeypatch, writer):
    w, other = (PORT, ref) if writer == "port" else (ref, PORT)
    path = tmp_path / "journal.jsonl"
    _write(w, path, monkeypatch)
    mine, theirs = w.journal.read_journal(str(path)), other.journal.read_journal(str(path))
    assert mine == theirs and len(mine) == 4
    assert other.journal.merge_journals([str(path)]) == mine
    assert [r["event"] for r in mine] == ["compression_switch", "policy_error",
                                          "straggler_response", "replan"]
    assert mine[2]["trace_id"] == "ab" * 16 and "trace_id" not in mine[3]
    assert all(r["rank"] == 1 and r["cluster_version"] == 2 for r in mine)
    assert (other.journal.filter_events(mine, "policy_error", policy="P")
            == w.journal.filter_events(mine, "policy_error", policy="P") == [mine[1]])


@pytest.mark.parametrize("writer", ["port", "jax"])
def test_rotated_journal_reads_back_in_either_package(ref, tmp_path, monkeypatch, writer):
    w, other = (PORT, ref) if writer == "port" else (ref, PORT)
    path = tmp_path / "journal.jsonl"
    _write(w, path, monkeypatch, max_mb=0.002)  # ~2 KB a segment
    assert os.path.exists(f"{path}.1") and os.path.exists(f"{path}.2")
    assert (other.journal.segment_paths(str(path)) == w.journal.segment_paths(str(path))
            == [f"{path}.2", f"{path}.1", str(path)])
    mine = w.journal.read_journal_segments(str(path))
    assert other.journal.read_journal_segments(str(path)) == mine
    assert other.journal.merge_journals([str(path)]) == w.journal.merge_journals([str(path)])
    switches = [r["switches"] for r in mine if r["event"] == "compression_switch"]
    assert switches == sorted(switches) and switches[-1] == 40  # oldest segment dropped
    # a torn line (a killed writer) is skipped by both
    with open(path, "a") as f:
        f.write('{"event": "tor')
    assert other.journal.read_journal(str(path)) == w.journal.read_journal(str(path))


def test_event_registry_and_strict_mode(ref, tmp_path, monkeypatch):
    assert tjournal.EVENT_KINDS == ref.journal.EVENT_KINDS
    for event, fields in (("heal", {"mttr_s": 1.0}), ("heal", {}), ("nope", {}),
                          ("compression_switch", {"old": "a"})):
        assert tjournal.validate_event(event, fields) == ref.journal.validate_event(event, fields)
    monkeypatch.setenv(tjournal.JOURNAL_FILE_ENV, str(tmp_path / "j.jsonl"))
    tjournal._reset_for_tests()
    monkeypatch.delenv(tjournal.JOURNAL_STRICT_ENV, raising=False)
    monkeypatch.delenv("KUNGFU_ANALYZE", raising=False)
    tjournal.journal_event("not_registered", x=1)  # journaled anyway
    monkeypatch.setenv(tjournal.JOURNAL_STRICT_ENV, "1")
    with pytest.raises(ValueError, match="not registered"):
        tjournal.journal_event("not_registered", x=1)
    tjournal._reset_for_tests()
    assert [r["event"] for r in tjournal.read_journal(str(tmp_path / "j.jsonl"))] == [
        "not_registered"]
    monkeypatch.delenv(tjournal.JOURNAL_FILE_ENV)
    tjournal.journal_event("heal", mttr_s=0.5)  # not configured: a no-op
    assert tjournal.global_journal() is None
    tjournal._reset_for_tests()


def test_traceparent_round_trips(ref):
    for fmt, parse in ((PORT, PORT), (PORT, ref), (ref, PORT)):
        ctx = fmt.trace.TraceContext(fmt.trace.new_trace_id(), fmt.trace.new_span_id())
        header = fmt.trace.format_traceparent(ctx)
        back = parse.trace.parse_traceparent(header)
        assert (back.trace_id, back.span_id) == (ctx.trace_id, ctx.span_id)
        assert header == ref.trace.format_traceparent(
            ref.trace.TraceContext(ctx.trace_id, ctx.span_id))
    for bad in (None, "", "00-abc-def-01", "00-" + "0" * 32 + "-" + "1" * 16 + "-01",
                "00-" + "g" * 32 + "-" + "1" * 16 + "-01", "0-" + "a" * 32 + "-" + "1" * 16,
                " 00-" + "A" * 32 + "-" + "B" * 16 + "-01 "):
        got, want = ttrace.parse_traceparent(bad), ref.trace.parse_traceparent(bad)
        assert (got and (got.trace_id, got.span_id)) == (want and (want.trace_id, want.span_id))


def _spans(pkg):
    S = pkg.trace.Span
    return [S("step", 1.25, 0.5, cat="train", tid=7),
            S("ev", 2.0, 0.0, cat="event", phase="i", args={"k": 1}),
            S("hop", 3.0, 0.125, trace_id="ab" * 16, span_id="cd" * 8, parent_id="ef" * 8,
              args={"bytes": 4})]


def test_chrome_export_matches_jax(ref):
    got = ttrace.export_chrome_trace(_spans(PORT), pid=5, process_name="rank-0")
    want = ref.trace.export_chrome_trace(_spans(ref), pid=5, process_name="rank-0")
    assert got["traceEvents"] == want["traceEvents"]
    assert got.keys() == want.keys() and got["otherData"].keys() == want["otherData"].keys()
    assert got["displayTimeUnit"] == want["displayTimeUnit"]
    assert json.loads(json.dumps(got)) == got


@pytest.mark.parametrize("pkg", ["port", "jax"])
def test_full_ring_counts_dropped_spans(ref, pkg):
    T = (PORT if pkg == "port" else ref).trace
    buf = T.TraceBuffer(capacity=3)
    for i in range(5):
        buf.add(T.Span(f"s{i}", float(i), 0.0))
    assert len(buf) == 3 and buf.dropped == 2
    assert [s.name for s in buf.spans()] == ["s2", "s3", "s4"]
    out = T.export_chrome_trace(buf, pid=1)
    assert out["otherData"]["spans_dropped"] == 2
    buf.clear()
    assert len(buf) == 0 and buf.dropped == 0


def test_scopes_and_context_tree(tmp_path, monkeypatch):
    """Under a context, nested scopes chain into one span tree;
    record_span, child_span and log_event join it; with the switch off
    nothing is recorded; device=True opens a torch.profiler range."""
    monkeypatch.delenv(ttrace.ENABLE_ENV, raising=False)
    buf = ttrace.global_trace_buffer()
    buf.clear()
    with ttrace.trace_scope("off"):
        pass
    assert len(buf) == 0
    monkeypatch.setenv(ttrace.ENABLE_ENV, "1")
    root = ttrace.TraceContext(ttrace.new_trace_id(), ttrace.new_span_id())
    with ttrace.trace_context(root):
        with ttrace.trace_scope("outer", cat="t"):
            with ttrace.trace_scope("inner", device=True):
                ttrace.log_event("tick", n=1)
                inner = ttrace.current_context()
            ttrace.record_span("timed", ttrace.time.monotonic() - 0.01)
    sid = ttrace.child_span("remote", ttrace.time.monotonic(), trace_id=root.trace_id,
                            parent_id="12" * 8)
    spans = {s.name: s for s in buf.spans()}
    assert set(spans) == {"outer", "inner", "tick", "timed", "remote"}
    assert {s.trace_id for s in spans.values()} == {root.trace_id}
    assert spans["outer"].parent_id == root.span_id
    assert spans["inner"].parent_id == spans["outer"].span_id == spans["timed"].parent_id
    assert spans["tick"].parent_id == spans["inner"].span_id == inner.span_id
    assert spans["tick"].phase == "i" and spans["remote"].span_id == sid
    assert spans["timed"].dur >= 0.01 and spans["outer"].dur >= spans["inner"].dur
    assert ttrace.current_context() is None
    # the dump a crashed rank leaves behind
    monkeypatch.setenv(ttrace.DUMP_DIR_ENV, str(tmp_path))
    monkeypatch.setenv("KFT_SELF_SPEC", "127.0.0.1:10001")
    path = ttrace.flush_dump("test")
    assert path == str(tmp_path / "trace-127.0.0.1-10001.json")
    dumped = json.load(open(path))
    assert len(dumped["traceEvents"]) == 6  # the spans and the process name
    buf.clear()


def test_profile_to_writes_a_chrome_trace(tmp_path):
    import torch

    with ttrace.profile_to(str(tmp_path)):
        torch.ones(64).sum()
    (path,) = tmp_path.iterdir()
    assert path.name.startswith("trace-") and "traceEvents" in json.load(open(path))


def test_job_clock(ref, monkeypatch):
    a = ttrace.job_now()
    assert ttrace.job_now() >= a and ttrace.job_now(ttrace._PROC_START_MONO) == pytest.approx(
        ttrace._PROC_START_MONO - ttrace._JOB_START_MONO)
    monkeypatch.setenv("KFT_JOB_START", "123.5")
    assert ttrace._job_start_wall() == ref.trace._job_start_wall() == 123.5
    monkeypatch.setenv("KFT_JOB_START", "bad")
    assert ttrace._job_start_wall() == ttrace._PROC_START_WALL


def test_ema_and_env_flags_match_jax(ref, monkeypatch):
    for alpha in (0.6, 0.1, 1.0):
        got, want = tema.EMA(alpha), ref.ema.EMA(alpha)
        assert got.value == want.value == 0.0
        for x in (3.0, -1.0, 0.25, 8.0):
            assert got.update(x) == want.update(x)
        assert got.count == want.count == 4
    for bad in (0.0, 1.5):
        with pytest.raises(ValueError):
            tema.EMA(bad)
    for value in ("1", "true", "YES", "on", "0", "", "no", "2"):
        monkeypatch.setenv("KUNGFU_ANALYZE", value)
        assert tenvflag.env_flag("KUNGFU_ANALYZE") == ref.envflag.env_flag("KUNGFU_ANALYZE")
        assert tenvflag.analyze_enabled() == ref.envflag.analyze_enabled()
        assert tenvflag.analyze_enabled(False) is False
