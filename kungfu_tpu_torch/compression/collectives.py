"""Compressed collectives over a process group (counterpart of
kungfu_tpu.compression.collectives).

The quantized all-reduce is the JAX package's three-op schedule with
torch.distributed in place of the mesh collectives:

  RS leg   each rank blocks and quantizes the shard meant for every peer,
           `all_to_all_single` moves the codes and the per-block scales,
           and each rank dequantizes what it received and sums it in f32
  AG leg   the reduced f32 shard is quantized once and
           `all_gather_into_tensor` moves the codes and scales again

fp8 codes travel as their uint8 bytes (no backend sends float8).  The sum
over the peers is torch's `sum(dim=0)` where the JAX package has XLA's
reduce, so a value may differ in the last bits where the two orders
differ; codes and scales follow the same rules bit for bit.  A mean is
the sum times 1/n (XLA's rewrite of the division by n).

`hierarchical_all_reduce` needs (dcn, ici) groups and raises until they
exist (ROADMAP A4); `sparse_pair_exchange` and `compressed_pair_average`
arrive with the gossip slice (ROADMAP A.3b).
"""
from __future__ import annotations

from typing import Optional, Sequence, Tuple, Union

import torch
import torch.distributed as dist
import torch.nn.functional as F

from .config import CompressionConfig, resolve
from .quant import QTensor, dequantize, from_wire, quantize, to_wire

Config = Union[None, str, CompressionConfig]
_REDUCE_OPS = {"sum": dist.ReduceOp.SUM, "min": dist.ReduceOp.MIN,
               "max": dist.ReduceOp.MAX, "prod": dist.ReduceOp.PRODUCT}


def _world(group) -> int:
    return dist.get_world_size(group) if dist.is_initialized() else 1


def _plain_all_reduce(x: torch.Tensor, group, op: str) -> torch.Tensor:
    """The uncompressed all-reduce of the group's backend."""
    if op not in _REDUCE_OPS and op != "mean":
        raise ValueError(f"unknown reduce op {op!r}")
    n = _world(group)
    if n == 1:
        return x
    out = x.clone()
    dist.all_reduce(out, op=_REDUCE_OPS.get(op, dist.ReduceOp.SUM), group=group)
    return out.div_(n) if op == "mean" else out


def _leg_generators(generator: Optional[torch.Generator], group, cfg: CompressionConfig
                    ) -> Tuple[Optional[torch.Generator], Optional[torch.Generator]]:
    """Two generators per rank (RS leg, AG leg) for stochastic rounding,
    decorrelated across ranks; (None, None) when the config doesn't dither."""
    if not (cfg.is_quantized and cfg.stochastic):
        return None, None
    seed = 0 if generator is None else int(torch.randint(
        2**62, (), generator=generator, device=generator.device))
    rank = dist.get_rank(group) if dist.is_initialized() else 0
    device = generator.device if generator is not None else "cpu"
    return tuple(torch.Generator(device=device).manual_seed(
        (seed * 1_000_003 + rank * 2 + leg) % 2**63) for leg in range(2))


def all_reduce(x: torch.Tensor, group=None, config: Config = None, op: str = "sum",
               generator: Optional[torch.Generator] = None) -> torch.Tensor:
    """All-reduce with a compressed wire format.

    none -> the plain all-reduce; bf16 -> cast, sum, cast back; int8/fp8
    -> quantized reduce-scatter + all-gather.  Ops other than sum and mean
    take the uncompressed path: code spaces don't compose with them."""
    cfg = resolve(config)
    if cfg.is_sparse:
        raise ValueError(
            f"{cfg.scheme} is a sparsifier for pair exchange, not an "
            "allreduce wire format; use topk/randk with sparse_pair_exchange")
    if cfg.scheme == "none" or op not in ("sum", "mean"):
        return _plain_all_reduce(x, group, op)
    if cfg.scheme == "bf16":
        out = _plain_all_reduce(x.to(torch.bfloat16), group, "sum").to(x.dtype)
        return out * (1.0 / _world(group)) if op == "mean" else out
    return _quantized_rs_ag(x, group, cfg, op, generator)


def _quantized_rs_ag(x: torch.Tensor, group, cfg: CompressionConfig, op: str,
                     generator: Optional[torch.Generator]) -> torch.Tensor:
    n = _world(group)
    if n == 1:
        return x
    g_rs, g_ag = _leg_generators(generator, group, cfg)
    flat = x.float().reshape(-1)
    # pad so every peer's shard is a whole number of quantization blocks
    pad = (-flat.numel()) % (n * cfg.block)
    if pad:
        flat = F.pad(flat, (0, pad))
    shards = flat.view(n, -1)  # row d = the shard meant for peer d

    # RS leg: quantize per-destination shards, exchange codes and scales,
    # dequantize each peer's contribution and sum in f32
    qt = quantize(shards, cfg, g_rs)
    wire = to_wire(qt.data).contiguous()
    data, scale = torch.empty_like(wire), torch.empty_like(qt.scale)
    dist.all_to_all_single(data, wire, group=group)
    dist.all_to_all_single(scale, qt.scale.contiguous(), group=group)
    acc = dequantize(QTensor(from_wire(data, cfg), scale)).sum(dim=0)
    if op == "mean":
        acc = acc * (1.0 / n)

    # AG leg: quantize the reduced shard once, gather codes and scales
    qt2 = quantize(acc, cfg, g_ag)
    wire2 = to_wire(qt2.data).contiguous()
    # every rank's blocks, one after the other: (n * nblocks, block)
    data2 = wire2.new_empty((n * wire2.shape[0],) + tuple(wire2.shape[1:]))
    scale2 = qt2.scale.new_empty((n * qt2.scale.shape[0], 1))
    dist.all_gather_into_tensor(data2, wire2, group=group)
    dist.all_gather_into_tensor(scale2, qt2.scale.contiguous(), group=group)
    out = dequantize(QTensor(from_wire(data2, cfg), scale2)).reshape(-1)
    return out[:x.numel()].view(x.shape).to(x.dtype)


def cross_all_reduce(x: torch.Tensor, dcn_group=None, config: Config = None, op: str = "sum",
                     generator: Optional[torch.Generator] = None) -> torch.Tensor:
    """Compressed CrossAllReduce: the reduction over the slow (cross-host)
    group only, quantized on the wire."""
    return all_reduce(x, dcn_group, config, op=op, generator=generator)


def hierarchical_all_reduce(*args, **kwargs):
    """Two-level all-reduce with per-leg wire formats: needs (dcn, ici)
    process groups, which the port does not build yet."""
    raise NotImplementedError(
        "hierarchical_all_reduce needs (dcn, ici) process groups, not ported yet "
        "(ROADMAP A4)")


def group_all_reduce(xs: Sequence[torch.Tensor], group=None, config: Config = None,
                     op: str = "sum", generator: Optional[torch.Generator] = None):
    """Compressed all-reduce over a tensor list, one collective each."""
    return [all_reduce(x, group, config, op=op, generator=generator) for x in xs]
