"""Variable initialization sync: BroadcastGlobalVariables (counterpart of
kungfu_tpu.initializer).

Reference: srcs/python/kungfu/tensorflow/initializer/__init__.py:13-99
(BroadcastGlobalVariablesOp/Hook/Callback, broadcast_variables for tape
mode): after local init, rank 0's variables are broadcast so all workers
start identical.  One process per rank holds its own copy, as the JAX
package's multi-controller case does; `DataParallelTrainer.init` calls
`broadcast_params` on the model.
"""
from __future__ import annotations

from typing import Any, List

import torch
import torch.distributed as dist

# the integer type each element size's bits are compared in (gloo reduces
# none of the 16-bit integers)
_BITS = {1: torch.uint8, 2: torch.int16, 4: torch.int32, 8: torch.int64}
_WIDE = {1: torch.int32, 2: torch.int32, 4: torch.int32, 8: torch.int64}


def _tensors(params: Any) -> List[torch.Tensor]:
    if isinstance(params, torch.nn.Module):
        return list(params.parameters())
    if isinstance(params, torch.Tensor):
        return [params]
    if isinstance(params, dict):
        return [t for v in params.values() for t in _tensors(v)]
    return [t for v in params for t in _tensors(v)]


def _world(group) -> int:
    return dist.get_world_size(group) if dist.is_initialized() else 1


def broadcast_params(params: Any, group=None, root: int = 0) -> Any:
    """Every rank takes `root`'s values (its rank in `group`), in place;
    `params` is a module, a tensor, or a dict or sequence of them.
    Returns `params`."""
    if _world(group) > 1:
        src = dist.get_global_rank(group, root) if group is not None else root
        with torch.no_grad():
            for t in _tensors(params):
                dist.broadcast(t.data, src=src, group=group)
    return params


def sync_check(params: Any, group=None) -> bool:
    """True iff every rank holds the same bits in every tensor (the
    reference's consensus: the MIN and MAX over the ranks agree, here of
    the bits, so -0.0 against 0.0 or two NaNs of other payloads count as
    different)."""
    if _world(group) == 1:
        return True
    ok = True
    for t in _tensors(params):
        size = t.element_size()
        bits = t.detach().contiguous().view(_BITS[size]).to(_WIDE[size])
        lo, hi = bits.clone(), bits.clone()
        dist.all_reduce(lo, op=dist.ReduceOp.MIN, group=group)
        dist.all_reduce(hi, op=dist.ReduceOp.MAX, group=group)
        ok = ok and torch.equal(lo, hi)
    return ok
