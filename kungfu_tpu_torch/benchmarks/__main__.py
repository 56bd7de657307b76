"""``python -m kungfu_tpu_torch.benchmarks`` (counterpart of
``python -m kungfu_tpu.benchmarks``).

    python -m kungfu_tpu_torch.run -np 4 python -m kungfu_tpu_torch.benchmarks \\
        --bench fused [--steps 8] [--warmup 2] [--out fused.json] [--device cpu]

Only `--bench fused` is ported; every other choice of the JAX command
raises NotImplementedError naming the ROADMAP item that will port it.
"""
from __future__ import annotations

import argparse
import sys

# the JAX command's other benchmarks and the ROADMAP items that port them
LATER = {"all_reduce": "A.8", "p2p": "A.8", "attention": "A.8", "compression": "A.8",
         "serving": "A.2", "planner": "A.8", "pallas": "A.8", "tuner": "A.8",
         "scaling": "A.8"}


def main(argv=None) -> int:
    p = argparse.ArgumentParser(prog="kungfu_tpu_torch.benchmarks")
    p.add_argument("--bench", default="fused", choices=["fused", *LATER])
    p.add_argument("--steps", type=int, default=8)
    p.add_argument("--warmup", type=int, default=2)
    p.add_argument("--out", default=None, help="rank 0 writes the JSON record here too")
    p.add_argument("--device", default=None, help="cuda (default) or cpu")
    args = p.parse_args(argv)
    if args.bench != "fused":
        raise NotImplementedError(
            f"--bench {args.bench} is not ported yet (ROADMAP {LATER[args.bench]}); "
            "--bench fused is")
    from .fused import bench_fused

    bench_fused(steps=args.steps, warmup=args.warmup, out=args.out, device=args.device)
    return 0


if __name__ == "__main__":
    sys.exit(main())
