"""``python -m kungfu_tpu_torch.testing.fake_adaptive_trainer``: replay the
elastic resize protocol with a tiny synthetic model (counterpart of
kungfu_tpu.testing.fake_adaptive_trainer).

Reference: tests/go/cmd/kungfu-fake-adaptive-trainer, the Go replay of the
SessionRunHook resize flow (propose -> consensus -> rebuild -> sync).  Run
under the launcher in watch mode::

    python -m kungfu_tpu_torch.run -w -np 2 -platform cpu -- \\
        python -m kungfu_tpu_torch.testing.fake_adaptive_trainer --schedule 2:8,3:8,2:8

Under `-heal` its RESULT line counts the heals, and a HEAL_EVENTS line
holds each heal's event (the chaos drills read both).

The model is a quadratic bowl (a parameter `w` chasing the batch mean)
under synchronous_sgd(SGD(0.1)); rank r's batches come from
numpy.random.RandomState(r + offset % 7), as in the JAX package, so both
replays train on the same numbers.
"""
from __future__ import annotations

import argparse
import json
import sys

import numpy as np
import torch


class Bowl(torch.nn.Module):
    """One parameter vector `w`, zero at init."""

    def __init__(self, dim: int):
        super().__init__()
        self.w = torch.nn.Parameter(torch.zeros(dim, dtype=torch.float32))


def bowl_loss(model: Bowl, batch) -> torch.Tensor:
    """mean((w - mean(x, axis=0))^2): enough to make the state sync
    observable without any model machinery."""
    x, = batch
    return torch.mean((model.w - x.mean(dim=0)) ** 2)


def make_data_fn(batch_size: int, dim: int):
    def make_data(rank: int, size: int, offset: int):  # noqa: ARG001 - the JAX signature
        rng = np.random.RandomState(rank + (offset % 7))
        while True:
            yield (torch.from_numpy(rng.randn(batch_size, dim).astype(np.float32)),)

    return make_data


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="kungfu_tpu_torch.testing.fake_adaptive_trainer")
    ap.add_argument("--schedule", default="", help="size:steps,... resize schedule")
    ap.add_argument("--total-samples", type=int, default=2048)
    ap.add_argument("--batch-size", type=int, default=32)
    ap.add_argument("--dim", type=int, default=64, help="fake parameter size")
    ap.add_argument("--check-every", type=int, default=2)
    ap.add_argument("--checkpoint-dir", default="", help="durable checkpoint dir")
    ap.add_argument("--checkpoint-every", type=int, default=10)
    ap.add_argument("--snapshot-every", type=int, default=0,
                    help="buddy/rolling RAM snapshot cadence (0 = check-every)")
    args = ap.parse_args(argv)

    from ..elastic.trainer import ElasticConfig, run_elastic
    from ..optimizers import synchronous_sgd

    def make_tx(axes=None, impl="pmean"):
        return synchronous_sgd(lambda ps: torch.optim.SGD(ps, lr=0.1), group=axes, impl=impl)

    out = run_elastic(
        lambda: bowl_loss, lambda: Bowl(args.dim), make_tx,
        make_data_fn(args.batch_size, args.dim),
        ElasticConfig(total_samples=args.total_samples, batch_size=args.batch_size,
                      schedule=args.schedule, check_every=args.check_every,
                      checkpoint_dir=args.checkpoint_dir,
                      checkpoint_every=args.checkpoint_every,
                      snapshot_every=args.snapshot_every),
    )
    mesh_desc = ",".join(f"{a}:{n}" for a, n in out["mesh"].items())
    print(
        f"RESULT: fake-adaptive trained={out['trained_samples']} "
        f"resizes={out['resizes']} final_size={out['final_size']} "
        f"mesh={mesh_desc} loss={out['loss']:.4f} heals={out['heals']} "
        f"seconds={out['seconds']:.3f}",
        flush=True,
    )
    if out["heal_events"]:
        print("HEAL_EVENTS: " + json.dumps(out["heal_events"]), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
