"""Time versions of B9 and B10 (or of their product body) in turn on the card.

    python -m kungfu_tpu_torch.tools.fused_ab --trees parent=_archive/parent,new=. \\
        [--order parent,new,new,parent] [--ablate 1,2,4] [--product] [--ranks 4] \\
        [--iters 50] [--workdir _archive/ab]

Each tree is a directory holding a `kungfu_tpu_torch/` package: this
checkout (`.`), or another commit unpacked with `git archive` into a
directory that .gitignore lists.  `--ablate` adds copies of this checkout's
package, each built with `KFT_MM_ABLATE` set in its csrc/mm_sm90.cuh (1: no
loads, 2: no products, 4: no sends; their checks then fail and their times
stand), named abl1, abl2, abl4 and run once each after `--order`.  Every
tree builds its own kernels first, all at once.  Then, in turn, each run
starts `--ranks` ranks of `tools/fused_check --iters N` through the
launcher (B9 and B10 at the flagship FSDP step's MLP shapes, with the
unfused NCCL arm where every rank has a card), or with `--product` one
process of `tools/fused_time` (the product body alone).  Prints a line a
run and then `FUSED_AB {json}` with every reading; each run's output is
kept in the work directory.  Compare versions only within one call to the
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
BUILD = [sys.executable, "-c", "from kungfu_tpu_torch.ops import _build; _build.build_all()"]


def ablated(workdir: str, mask: int) -> str:
    """A copy of this checkout's package built with KFT_MM_ABLATE = mask."""
    root = os.path.join(workdir, f"abl{mask}")
    shutil.rmtree(root, ignore_errors=True)
    shutil.copytree(os.path.join(HERE, "kungfu_tpu_torch"), os.path.join(root, "kungfu_tpu_torch"),
                    ignore=shutil.ignore_patterns("_build", "__pycache__"))
    header = os.path.join(root, "kungfu_tpu_torch", "ops", "csrc", "mm_sm90.cuh")
    with open(header) as f:
        text, n = re.subn(r"^#define KFT_MM_ABLATE 0$", f"#define KFT_MM_ABLATE {mask}", f.read(),
                          flags=re.M)
    if n != 1:
        raise SystemExit(f"fused_ab: no KFT_MM_ABLATE in {header}")
    with open(header, "w") as f:
        f.write(text)
    return root


def readings(out: str, product: bool) -> Dict:
    """{case: readings} from a run's output: the slowest rank's time of each
    kernel (ms), the library arm's and the bound; or the product's cases."""
    tag = "FUSED_TIME " if product else "FUSED_CHECK "
    lines = [json.loads(line[line.find(tag) + len(tag):]) for line in out.splitlines()
             if tag in line]
    if product:
        return {k: {"kernel_ms": c["kernel_ms"] and min(c["kernel_ms"]),
                    "kernel_device_ms": c["kernel_device_ms"],
                    "library_ms": min(c["library_ms"]), "library_device_ms": c["library_device_ms"],
                    "bound_ms": c["bound_ms"], "ok": c.get("ok")}
                for r in lines for k, c in r["cases"].items()}
    res = {}
    for kind in ("b9", "b10"):
        t = [r["timing"][kind] for r in lines if kind in r.get("timing", {})]
        if t:
            lib = [x["library_ms"] for x in t if x["library_ms"] is not None]
            res[kind] = {"ms": max(x["ms"] for x in t), "ms_ranks": [x["ms"] for x in t],
                         "library_ms": max(lib) if lib else None, "bound_ms": t[0]["bound_ms"],
                         "bound_by": t[0]["bound_by"], "ok": all(r["ok_all"] for r in lines)}
            for key in ("host_ms", "device_ms", "library_device_ms"):
                got = [x[key] for x in t if x.get(key) is not None]
                res[kind][key] = max(got) if got else None
    return res


def main(argv: Optional[Sequence[str]] = None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--trees", default="new=.", help="name=directory, comma-separated")
    ap.add_argument("--order", default="", help="names in the order to run (default: each once)")
    ap.add_argument("--ablate", default="", help="KFT_MM_ABLATE masks of copies of this checkout")
    ap.add_argument("--product", action="store_true", help="the product body alone, one card")
    ap.add_argument("--ranks", type=int, default=4)
    ap.add_argument("--iters", type=int, default=50)
    ap.add_argument("--workdir", default=os.path.join(HERE, "_archive", "ab"))
    args = ap.parse_args(argv)
    os.makedirs(args.workdir, exist_ok=True)
    trees = dict(t.split("=", 1) for t in args.trees.split(","))
    order: List[str] = args.order.split(",") if args.order else list(trees)
    for mask in (int(m) for m in args.ablate.split(",") if m):
        trees[f"abl{mask}"] = ablated(args.workdir, mask)
        order.append(f"abl{mask}")
    builds = [subprocess.Popen(BUILD, cwd=d) for d in trees.values()]
    if any(p.wait() for p in builds):
        print("fused_ab: a build failed", file=sys.stderr)
        return 1
    if args.product:
        cmd = [sys.executable, "-m", "kungfu_tpu_torch.tools.fused_time", "--iters",
               str(args.iters)]
    else:
        cmd = [sys.executable, "-m", "kungfu_tpu_torch.run", "-np", str(args.ranks),
               sys.executable, "-m", "kungfu_tpu_torch.tools.fused_check", "--iters",
               str(args.iters)]
    runs = []
    for i, name in enumerate(order):
        proc = subprocess.run(cmd, cwd=trees[name], capture_output=True, text=True, timeout=900)
        with open(os.path.join(args.workdir, f"{i:02d}_{name}.log"), "w") as f:
            f.write(proc.stdout + proc.stderr)
        got = readings(proc.stdout, args.product)
        runs.append({"tree": name, "rc": proc.returncode, "readings": got})
        print(f"[fused_ab] {name}: rc {proc.returncode} " + "; ".join(
            f"{k} {json.dumps(v)}" for k, v in got.items()), flush=True)
    print("FUSED_AB " + json.dumps({"trees": trees, "runs": runs}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
