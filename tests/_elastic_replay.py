"""The fake adaptive trainer's resize replay, in either package, with its
result at full precision: `tests/test_torch_elastic.py` holds the port's
replay against the JAX package's through it, and `tests/test_torch_heal.py`
its heal replay (under `-heal`, with KFT_FAULT_PLAN and checkpoints).

    python tests/_elastic_replay.py launch jax|torch PORT_BASE <launcher flags> -- <worker>
    python tests/_elastic_replay.py worker jax|torch --schedule S --total-samples N ...

`launch` runs the package's launcher (`python -m <package>.run`) with its
first worker port at PORT_BASE instead of 10000. `worker` runs
`run_elastic` on the fake trainer's quadratic bowl with SGD(0.1), its
batches centred on 1 (`w` then moves away from 0, where an elementwise
rtol would measure cancellation and not rounding), and prints
`REPLAY: {json}` with the final loss and `w` as Python floats, the heals
and each heal's recovery rung and source.

Under jax 0.9 the JAX package does not import without the alias that
tests/_torch_reference.py explains; each role sets it first.
"""
from __future__ import annotations

import argparse
import functools
import json
import os
import sys

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def _alias():
    from jax.experimental.pallas import tpu as pltpu

    if not hasattr(pltpu, "TPUMemorySpace"):
        pltpu.TPUMemorySpace = pltpu.MemorySpace


def batches(rank: int, offset: int, rows: int, dim: int):
    rng = np.random.RandomState(rank + (offset % 7))
    while True:
        yield (rng.randn(rows, dim) + 1.0).astype(np.float32)


def launch(pkg: str, base: int, argv) -> int:
    if pkg == "jax":
        _alias()
        from kungfu_tpu.plan import peer
        from kungfu_tpu.run.__main__ import main
    else:
        from kungfu_tpu_torch.plan import peer
        from kungfu_tpu_torch.run.__main__ import main
    peer.HostList.gen_peer_list = functools.partialmethod(
        peer.HostList.gen_peer_list, port_base=base, port_limit=base + 64)
    return main(argv)


def _run_jax(args):
    _alias()
    import jax.numpy as jnp
    import optax

    from kungfu_tpu.elastic.trainer import ElasticConfig, run_elastic
    from kungfu_tpu.optimizers import synchronous_sgd

    def loss_fn(params, batch):
        x, = batch
        return jnp.mean((params["w"] - jnp.mean(x, axis=0)) ** 2)

    out = run_elastic(
        lambda: loss_fn, lambda: {"w": jnp.zeros((args.dim,), jnp.float32)},
        lambda axes="dp", impl="pmean": synchronous_sgd(optax.sgd(0.1), axis_name=axes,
                                                        impl=impl),
        lambda rank, size, offset: ((x,) for x in batches(rank, offset, args.batch_size,
                                                          args.dim)),
        ElasticConfig(**_config(args)))
    w = np.asarray(out["state"].params["w"].addressable_shards[0].data).reshape(-1)
    return out, w


def _run_torch(args):
    import torch

    from kungfu_tpu_torch.elastic.trainer import ElasticConfig, run_elastic
    from kungfu_tpu_torch.optimizers import synchronous_sgd
    from kungfu_tpu_torch.testing.fake_adaptive_trainer import Bowl, bowl_loss

    out = run_elastic(
        lambda: bowl_loss, lambda: Bowl(args.dim),
        lambda axes=None, impl="pmean": synchronous_sgd(
            lambda ps: torch.optim.SGD(ps, lr=0.1), group=axes, impl=impl),
        lambda rank, size, offset: ((torch.from_numpy(x),) for x in batches(
            rank, offset, args.batch_size, args.dim)),
        ElasticConfig(**_config(args)))
    return out, out["state"].params.w.detach().cpu().numpy()


def _config(args) -> dict:
    return dict(total_samples=args.total_samples, batch_size=args.batch_size,
                schedule=args.schedule, check_every=args.check_every,
                checkpoint_dir=args.checkpoint_dir, checkpoint_every=args.checkpoint_every,
                snapshot_every=args.snapshot_every)


def worker(pkg: str, argv) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--schedule", default="")
    ap.add_argument("--total-samples", type=int, default=2048)
    ap.add_argument("--batch-size", type=int, default=32)
    ap.add_argument("--dim", type=int, default=64)
    ap.add_argument("--check-every", type=int, default=2)
    ap.add_argument("--checkpoint-dir", default="")
    ap.add_argument("--checkpoint-every", type=int, default=50)
    ap.add_argument("--snapshot-every", type=int, default=0)
    args = ap.parse_args(argv)
    out, w = (_run_jax if pkg == "jax" else _run_torch)(args)
    print("REPLAY: " + json.dumps({
        "trained": int(out["trained_samples"]), "resizes": int(out["resizes"]),
        "final_size": int(out["final_size"]), "loss": float(out["loss"]),
        "heals": int(out["heals"]),
        "sources": [[e.get("recovery_rung"), e.get("recovery_source")]
                    for e in out["heal_events"]],
        "w": [float(v) for v in w]}), flush=True)
    return 0


if __name__ == "__main__":
    role, pkg = sys.argv[1], sys.argv[2]
    if role == "launch":
        sys.exit(launch(pkg, int(sys.argv[3]), sys.argv[4:]))
    sys.exit(worker(pkg, sys.argv[3:]))
