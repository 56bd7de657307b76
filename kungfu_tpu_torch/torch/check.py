"""``python -m kungfu_tpu_torch.torch.check``: self-check of the torch
interop (counterpart of kungfu_tpu/torch/check.py, the reference's
test_torch_ops.py as a runnable module): collective semantics (sum, max,
broadcast, gather) and a short synchronous-SGD run whose parameters must
end bit-identical on every worker.  Run under the launcher::

    python -m kungfu_tpu_torch.run -np 2 -platform cpu -- python -m kungfu_tpu_torch.torch.check
"""
from __future__ import annotations

import sys


def main(argv=None) -> int:
    import numpy as np
    import torch

    import kungfu_tpu_torch
    from . import (
        SynchronousSGDOptimizer,
        all_gather,
        all_reduce,
        broadcast,
        broadcast_parameters,
    )

    peer = kungfu_tpu_torch.init()
    r, n = peer.rank, peer.size
    dev = peer.current_session().device

    # collectives
    t = torch.full((4,), float(r + 1), device=dev)
    summed = all_reduce(t)
    want = sum(range(1, n + 1))
    assert torch.allclose(summed, torch.full((4,), float(want), device=dev)), summed

    m = all_reduce(t, op="max")
    assert torch.allclose(m, torch.full((4,), float(n), device=dev)), m

    b = broadcast(t, root=0)
    assert torch.allclose(b, torch.full((4,), 1.0, device=dev)), b

    g = all_gather(torch.tensor([float(r)], device=dev))
    assert g.shape == (n, 1) and torch.allclose(
        g.flatten(), torch.arange(n, dtype=torch.float32, device=dev)
    ), g

    # synchronous SGD: distinct seeds, identical final params
    torch.manual_seed(100 + r)
    model = torch.nn.Linear(8, 1).to(dev)
    broadcast_parameters(model.state_dict())
    opt = SynchronousSGDOptimizer(torch.optim.SGD(model.parameters(), lr=0.05))
    data_rng = np.random.RandomState(r)
    for _ in range(5):
        x = torch.from_numpy(data_rng.randn(16, 8).astype(np.float32)).to(dev)
        y = x.sum(dim=1, keepdim=True)
        loss = torch.nn.functional.mse_loss(model(x), y)
        opt.zero_grad()
        loss.backward()
        opt.step()

    flat = torch.cat([p.detach().flatten() for p in model.parameters()])
    gathered = all_gather(flat)
    for other in range(n):
        assert torch.equal(gathered[other], flat), (
            f"rank {r}: params diverged from rank {other}"
        )

    print(f"RESULT: torch-check rank={r} np={n} ok", flush=True)
    kungfu_tpu_torch.finalize()
    return 0


if __name__ == "__main__":
    sys.exit(main())
