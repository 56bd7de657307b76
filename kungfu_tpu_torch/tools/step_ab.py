"""Profile a flagship training step from versions of the package in turn.

    python -m kungfu_tpu_torch.tools.step_ab --trees parent=_archive/parent,new=. \\
        [--order parent,new,new:nccl,new,parent] [--ranks 4] [--steps 2] \\
        [--profile-args "--fsdp 4 --batch 8"] [--workdir _archive/step_ab]
    python -m kungfu_tpu_torch.tools.step_ab --trees parent=_archive/parent,new=. \\
        --order parent,new,new,parent --profile-args \\
        "--sp 4 --seq-len 8192 --batch 2 --impl pallas_ring --bucket-mib 256"

Each tree is a directory holding a `kungfu_tpu_torch/` package: this
checkout (`.`), or another commit unpacked with `git archive` into a
directory that .gitignore lists.  This checkout's `tools/step_profile.py`
is copied into every other tree first, so every run is profiled alike.
Every tree builds its own kernels, all at once.  Then, in turn, each run
starts `--ranks` ranks of `tools/step_profile`
through the launcher with `--profile-args` (by default the FSDP step:
FSDPTrainer on the ring kernels; the sequence-parallel step with `--sp
4 ...`); `NAME:nccl` in `--order` is a run of that tree with `--nccl`
(FSDPTrainer(dma_collectives=False): torch.distributed a parameter, the
yardstick).  Each run's reading: the slowest rank's step time with and
without the profiler, tokens/s over all ranks, every rank's idle share
and device busy time (of the profiled steps), device time of B5-B8,
B11 (and the part of it no other kernel overlaps), EF and NCCL's
collectives, of the flash kernels, peak memory, and the kernels'
launches a step.
Prints a line a run and then `STEP_AB {json}`; each run's output is kept
in the work directory.  Compare versions only within one call to the
card, in the order old, new, new, old.
"""
from __future__ import annotations

import argparse
import json
import os
import re
import shutil
import subprocess
import sys
from typing import Dict, List, Optional, Sequence

HERE = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
PROFILER = os.path.join("kungfu_tpu_torch", "tools", "step_profile.py")
BUILD = [sys.executable, "-c", "from kungfu_tpu_torch.ops import _build; _build.build_all()"]


def readings(out: str) -> Dict:
    """The run's reading from every rank's last JSON line."""
    ranks = {}
    for line in out.splitlines():
        m = re.match(r"^\[(\d+)\] (\{.*\})$", line)
        if m and '"step_ms"' in m.group(2):
            ranks[int(m.group(1))] = json.loads(m.group(2))
    if not ranks:
        return {}
    rs = [ranks[r] for r in sorted(ranks)]
    step = max(r["step_ms_unprofiled"] for r in rs)
    return {
        "step_ms": step, "step_ms_profiled": max(r["step_ms"] for r in rs),
        "step_ms_ranks": [r["step_ms_unprofiled"] for r in rs],
        "tokens_per_s": rs[0]["tokens"] / (step / 1e3),
        "idle_share": [r["idle_share"] for r in rs],
        "device_busy_ms": [r["device_busy_ms"] for r in rs],
        "collectives_ms": [r.get("collectives_ms") for r in rs],
        "flash_ms": [r["categories_ms"].get("flash kernels (port)", 0.0) for r in rs],
        "ring_launches": [r.get("ring_launches") for r in rs],
        "peak_gib": [r["peak_gib"] for r in rs],
    }


def main(argv: Optional[Sequence[str]] = None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--trees", default="new=.", help="name=directory, comma-separated")
    ap.add_argument("--order", default="",
                    help="names in the order to run, NAME:nccl for a run with --nccl "
                    "(default: each once)")
    ap.add_argument("--ranks", type=int, default=4)
    ap.add_argument("--steps", type=int, default=2)
    ap.add_argument("--profile-args", default="--fsdp 4 --batch 8",
                    help="step_profile's arguments besides --steps (and --nccl)")
    ap.add_argument("--workdir", default=os.path.join(HERE, "_archive", "step_ab"))
    args = ap.parse_args(argv)
    os.makedirs(args.workdir, exist_ok=True)
    trees = dict(t.split("=", 1) for t in args.trees.split(","))
    for root in trees.values():
        if os.path.realpath(root) != os.path.realpath(HERE):
            shutil.copyfile(os.path.join(HERE, PROFILER), os.path.join(root, PROFILER))
    order: List[str] = args.order.split(",") if args.order else list(trees)
    runs = [(name.split(":")[0], name.endswith(":nccl")) for name in order]
    builds = [subprocess.Popen(BUILD, cwd=d) for d in trees.values()]
    if any(p.wait() for p in builds):
        print("step_ab: a build failed", file=sys.stderr)
        return 1
    out = []
    for i, (name, nccl) in enumerate(runs):
        cmd = [sys.executable, "-m", "kungfu_tpu_torch.run", "-np", str(args.ranks),
               sys.executable, "-m", "kungfu_tpu_torch.tools.step_profile",
               *args.profile_args.split(), "--steps", str(args.steps)]
        proc = subprocess.run(cmd + (["--nccl"] if nccl else []), cwd=trees[name],
                              capture_output=True, text=True, timeout=900)
        label = name + (" (NCCL)" if nccl else "")
        with open(os.path.join(args.workdir, f"{i:02d}_{name}{'_nccl' if nccl else ''}.log"),
                  "w") as f:
            f.write(proc.stdout + proc.stderr)
        got = readings(proc.stdout)
        out.append({"tree": name, "nccl": nccl, "rc": proc.returncode, "readings": got})
        print(f"[step_ab] {label}: rc {proc.returncode} {json.dumps(got)}", flush=True)
    print("STEP_AB " + json.dumps({"trees": trees, "args": args.profile_args, "runs": out}),
          flush=True)
    return 0 if all(r["rc"] == 0 for r in out) else 1


if __name__ == "__main__":
    sys.exit(main())
