"""``python -m kungfu_tpu_torch.chaos``: scripted failure drills
(counterpart of ``python -m kungfu_tpu.chaos``).

The default drill launches a small heal-armed watch-mode job on the CPU,
injects the fault plan, and holds the self-healing contract end to end:
the killed worker leaves the cluster document, the survivors heal to n-1
without a restart, training reaches --total-samples with a finite loss,
and each survivor's heal event (old and new size, mttr_s, recovery_rung)
is in its output.  ``--expect-rung buddy`` also holds that the heal
resynced from the in-memory tier.  Exit 0 on a healthy heal.

    python -m kungfu_tpu_torch.chaos                  # crash@step=7:rank=2, np=3
    python -m kungfu_tpu_torch.chaos --plan "hang@step=9:rank=1" --heartbeat-timeout 6

``--ckpt-drill {corrupt,crash_in_save}`` runs a checkpoint-integrity drill
instead (one process, two phases): phase 1 trains with the fault armed
(bit rot of a finalized step, or the primary killed between the leaf
writes and the manifest rename), phase 2 restarts against the same
directory and must demote the bad step (journaled) and resume from the
verified one before it.

The JAX package's other drills raise, naming the ROADMAP item that ports
what they drive: the coordinator drill the replicated control plane
(A.5c), the straggler drills the telemetry fleet's detector (A.8, its
network variant also the pod harness), the serve, trace and fairness
drills the serving fleet (A.2).
"""
from __future__ import annotations

import argparse
import glob
import json
import math
import os
import re
import subprocess
import sys
import tempfile
from typing import Optional, Sequence

from .plan import FAULT_PLAN_ENV, parse_fault_plan

LAUNCHER = (sys.executable, "-m", "kungfu_tpu_torch.run")
TRAINER = (sys.executable, "-m", "kungfu_tpu_torch.testing.fake_adaptive_trainer")

# drill flag -> (argparse options, the ROADMAP item that ports what it drives)
UNPORTED = {
    "--straggler-drill": ({"action": "store_true"}, "A.8"),
    "--straggler-ms": ({"type": float}, "A.8"),
    "--straggler-steps": ({"type": int}, "A.8"),
    "--network": ({"choices": ("auto", "on", "off")}, "A.8"),
    "--coordinator-drill": ({"action": "store_true"}, "A.5c"),
    "--replicas": ({"type": int}, "A.5c"),
    "--serve-drill": ({"action": "store_true"}, "A.2"),
    "--serve-requests": ({"type": int}, "A.2"),
    "--serve-p99-bound": ({"type": float}, "A.2"),
    "--tier": ({"choices": ("prefill", "decode")}, "A.2"),
    "--no-autoscale-drill": ({"action": "store_true"}, "A.2"),
    "--trace-drill": ({"action": "store_true"}, "A.2"),
    "--fairness-drill": ({"action": "store_true"}, "A.2"),
    "--burst-plan": ({}, "A.2"),
    "--json": ({}, "A.2"),
}


def _env(extra_env: Optional[dict] = None) -> dict:
    env = dict(os.environ)
    repo = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
    env["PYTHONPATH"] = repo + (os.pathsep + env["PYTHONPATH"] if env.get("PYTHONPATH") else "")
    env.update(extra_env or {})
    return env


def run_drill(plan: str, np: int, total_samples: int, timeout_s: float,
              heartbeat_timeout: float = 0.0, checkpoint_dir: str = "",
              checkpoint_every: int = 0, extra_env: Optional[dict] = None,
              launcher: Sequence[str] = LAUNCHER, launcher_args: Sequence[str] = (),
              restart_budget: int = 0) -> dict:
    """Run one heal drill under `launcher` (its flags `launcher_args`, e.g.
    -H and -self); returns a summary dict (keys below)."""
    parse_fault_plan(plan)  # a typo'd plan must fail loudly, not run fault-free
    env = _env(extra_env)
    env[FAULT_PLAN_ENV] = plan
    cmd = [*launcher, "-w", "-heal", "-np", str(np), "-platform", "cpu", "-port", "0",
           "-timeout", str(int(timeout_s)), *launcher_args]
    if heartbeat_timeout > 0:
        cmd += ["-heartbeat-timeout", str(heartbeat_timeout)]
    if restart_budget:
        cmd += ["-restart-budget", str(restart_budget)]
    cmd += ["--", *TRAINER, "--total-samples", str(total_samples), "--batch-size", "32"]
    if checkpoint_dir:
        cmd += ["--checkpoint-dir", checkpoint_dir]
    if checkpoint_every:
        cmd += ["--checkpoint-every", str(checkpoint_every)]
    r = subprocess.run(cmd, env=env, capture_output=True, text=True, timeout=timeout_s + 60)
    out = r.stdout + r.stderr
    results = re.findall(
        r"RESULT: fake-adaptive trained=(\d+) resizes=(\d+) final_size=(\d+) "
        r"mesh=\S+ loss=([-\d.naninf]+) heals=(\d+)", out)
    heal_events: list = []
    runner_events: list = []
    for line in out.splitlines():
        if "RUNNER_HEAL_EVENTS:" in line:
            runner_events = runner_events or json.loads(line.split("RUNNER_HEAL_EVENTS:", 1)[1])
        elif "HEAL_EVENTS:" in line:
            heal_events = heal_events or json.loads(line.split("HEAL_EVENTS:", 1)[1])
    return {
        "returncode": r.returncode,
        "output": out,
        "results": [{"trained": int(t), "resizes": int(z), "final_size": int(f),
                     "loss": float(l), "heals": int(h)} for t, z, f, l, h in results],
        "heal_events": heal_events,
        "runner_heal_events": runner_events,
    }


def _journal_events(journal_dir: str) -> list:
    from ..monitor.journal import read_journal_segments

    events = []
    for p in sorted(glob.glob(os.path.join(journal_dir, "journal-*.jsonl"))):
        events.extend(read_journal_segments(p))
    return events


def run_ckpt_drill(kind: str, timeout_s: float = 240.0) -> int:
    """Checkpoint-integrity drill: hurt a checkpoint, restart, and hold
    that the restore ladder demoted the bad step onto the verified one
    before it.

    One process, two phases against one directory (checkpoint_every=10,
    batch 32, 1024 samples: saves at steps 10, 20, 30 and the last):

      corrupt         phase 1 flips bytes in step 20's leaves once it is
                      finalized, then crashes at step 29, before the save
                      of step 30, so the corrupted step is the newest
      crash_in_save   phase 1 dies between step 20's leaf writes and its
                      manifest rename: a finalized-looking torn step

    Phase 2 restarts with no faults and must demote the bad step
    (`checkpoint_demoted` in the journal), resume from step 10 (`resume`),
    train to completion and exit 0.
    """
    total, every = 1024, 10
    if kind == "corrupt":
        # the fault re-arms until step 20 is finalized (the slow window
        # gives the asynchronous writer room), then the crash at 29 keeps
        # the corrupted step the newest
        plan = ("corrupt_ckpt@step=21:rank=0:ckpt_step=20;"
                "slow@step=21:rank=0:ms=100:steps=6;"
                "crash@step=29:rank=0")
        want_reasons = ("checksum mismatch", "restore failed")
    elif kind == "crash_in_save":
        plan = "crash_in_save@step=20:rank=0"
        want_reasons = ("manifest missing",)
    else:
        raise ValueError(f"unknown ckpt drill {kind!r}")

    def fail(msg: str, out: str = "") -> int:
        print(f"CKPT DRILL FAILED ({kind}): {msg}", file=sys.stderr)
        if out:
            print(f"--- output tail ---\n{out[-3000:]}", file=sys.stderr)
        return 1

    with tempfile.TemporaryDirectory(prefix="kft-ckpt-drill-") as tmp:
        ckpt_dir = os.path.join(tmp, "ckpt")
        jdir = os.path.join(tmp, "journal")
        cmd = [*TRAINER, "--total-samples", str(total), "--batch-size", "32",
               "--checkpoint-dir", ckpt_dir, "--checkpoint-every", str(every)]
        env = _env({"KFT_JOURNAL_DIR": jdir, "KFT_PLATFORM": "cpu"})
        env.pop(FAULT_PLAN_ENV, None)
        r1 = subprocess.run(cmd, env={**env, FAULT_PLAN_ENV: plan}, capture_output=True,
                            text=True, timeout=timeout_s)
        if r1.returncode == 0:
            return fail("phase 1 survived a fault plan that must kill it", r1.stdout + r1.stderr)
        r2 = subprocess.run(cmd, env=env, capture_output=True, text=True, timeout=timeout_s)
        out2 = r2.stdout + r2.stderr
        if r2.returncode != 0:
            return fail(f"phase 2 exited {r2.returncode}: a bad checkpoint must demote, not "
                        "crash the restart", out2)
        m = re.search(r"RESULT: fake-adaptive trained=(\d+)", r2.stdout)
        if not m or int(m.group(1)) < total:
            return fail("phase 2 did not train to completion", out2)
        events = _journal_events(jdir)
        if kind == "corrupt" and not any(e.get("event") == "chaos_corrupt_ckpt"
                                         for e in events):
            return fail("the corrupt_ckpt fault never fired (no chaos_corrupt_ckpt journal "
                        "event)", out2)
        demoted = [e for e in events if e.get("event") == "checkpoint_demoted"
                   and any(w in str(e.get("reason", "")) for w in want_reasons)]
        if not demoted:
            return fail(f"no checkpoint_demoted event with reason ~{want_reasons} in the "
                        "journal", out2)
        resumes = [e for e in events if e.get("event") == "resume"]
        if not resumes:
            return fail("no resume journal event (phase 2 started fresh?)", out2)
        bad_step = max(e["step"] for e in demoted)
        resumed_from = resumes[-1].get("ckpt_step")
        if resumed_from is None or resumed_from >= bad_step:
            return fail(f"resume landed on step {resumed_from}, not a step older than the "
                        f"demoted {bad_step}", out2)
        print(f"CKPT DRILL OK ({kind}): step {bad_step} demoted ({demoted[-1]['reason']}), "
              f"resumed from verified step {resumed_from}, retrained to {m.group(1)} samples")
    return 0


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="kungfu_tpu_torch.chaos")
    ap.add_argument("--plan", default="crash@step=7:rank=2")
    ap.add_argument("--np", type=int, default=3)
    ap.add_argument("--total-samples", type=int, default=1536)
    ap.add_argument("--timeout", type=float, default=240.0)
    ap.add_argument("--heartbeat-timeout", type=float, default=0.0,
                    help="arm the launcher's hang detection (needed for hang@ plans)")
    ap.add_argument("--checkpoint-dir", default="", help="durable checkpoint dir for the workers")
    ap.add_argument("--checkpoint-every", type=int, default=0)
    ap.add_argument("--buddy", choices=("on", "off"), default="on",
                    help="off sets KFT_BUDDY=0: no in-memory recovery tier, so heals take "
                    "the disk rung")
    ap.add_argument("--expect-rung", choices=("buddy", "disk", "any"), default="any",
                    help="hold the heal's recovery_rung")
    ap.add_argument("--ckpt-drill", choices=("corrupt", "crash_in_save"), default="",
                    help="run a checkpoint-integrity drill instead of the crash-and-heal one")
    for flag, (opts, item) in UNPORTED.items():
        ap.add_argument(flag, dest="unported_" + flag[2:].replace("-", "_"), default=None,
                        help=f"not ported yet (ROADMAP {item})", **opts)
    args = ap.parse_args(argv)
    for flag, (_, item) in UNPORTED.items():
        if getattr(args, "unported_" + flag[2:].replace("-", "_")) not in (None, False):
            raise NotImplementedError(f"chaos {flag}: what it drives is not ported yet "
                                      f"(ROADMAP {item})")

    if args.ckpt_drill:
        return run_ckpt_drill(args.ckpt_drill, timeout_s=args.timeout)

    summary = run_drill(args.plan, args.np, args.total_samples, args.timeout,
                        heartbeat_timeout=args.heartbeat_timeout,
                        checkpoint_dir=args.checkpoint_dir,
                        checkpoint_every=args.checkpoint_every,
                        extra_env={"KFT_BUDDY": "0"} if args.buddy == "off" else None)

    def fail(msg: str) -> int:
        print(f"CHAOS DRILL FAILED: {msg}\n--- output tail ---\n{summary['output'][-3000:]}",
              file=sys.stderr)
        return 1

    if summary["returncode"] != 0:
        return fail(f"launcher exited {summary['returncode']}")
    if not summary["results"]:
        return fail("no worker RESULT line")
    for res in summary["results"]:
        if res["trained"] < args.total_samples:
            return fail(f"trained {res['trained']} < {args.total_samples}")
        if not math.isfinite(res["loss"]):
            return fail(f"non-finite final loss {res['loss']}")
    # corrupt_ckpt hurts only the disk: it never provokes a heal on its own
    worker_faults = [f for f in parse_fault_plan(args.plan).worker_faults()
                     if f.kind in ("crash", "hang", "slow")]
    if worker_faults:
        if not summary["runner_heal_events"]:
            return fail("no RUNNER_HEAL_EVENTS from the healer")
        ev = summary["heal_events"]
        if not ev or "mttr_s" not in ev[0]:
            return fail("no worker heal event with mttr_s")
        if not all(r["final_size"] == args.np - 1 for r in summary["results"]):
            return fail(f"survivors not at n-1={args.np - 1}")
        if args.expect_rung != "any":
            rungs = {e.get("recovery_rung") for e in ev}
            if rungs != {args.expect_rung}:
                return fail(f"expected recovery_rung={args.expect_rung}, heal events show "
                            f"{sorted(rungs)}")
        print(f"CHAOS DRILL OK: healed {ev[0]['old_size']} -> {ev[0]['new_size']} workers, "
              f"rung={ev[0].get('recovery_rung')}/{ev[0].get('recovery_source')}, "
              f"mttr_s={ev[0]['mttr_s']}, final loss {summary['results'][0]['loss']:.4f}")
    else:
        if summary["runner_heal_events"]:
            return fail("a flap-only plan should not trigger heals")
        print("CHAOS DRILL OK: fault plan ridden out without a heal, final loss "
              f"{summary['results'][0]['loss']:.4f}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
