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

`sparse_pair_exchange` and `compressed_pair_average` are the gossip
pull's directed pair averages with a dieted wire.  A pairing there is a
ring shift (rank i receives from rank i + s), so the exchange is
`ops.fused_matmul.ring_shift`: B11 on CUDA tensors, whose kernel moves
bytes, so the codes and their scales (or the values and their int32
indices) go as one `ring_shift_pair` call; on CPU tensors its plain
`batch_isend_irecv`.  `pair_wire` and `pair_mix` are the two ends of one
such exchange, for callers that pack several tensors' wires into one
shift (the gossip optimizer).

`hierarchical_all_reduce` is the two-level all-reduce over the groups of
a ("dcn", "ici") mesh (`plan.make_hierarchical_mesh`), a wire format a
leg.
"""
from __future__ import annotations

from typing import Optional, Sequence, Tuple, Union

import math

import torch
import torch.distributed as dist
import torch.nn.functional as F

from ..ops import collective as C
from ..plan.graph import validate_permutation
from .config import CompressionConfig, resolve
from .quant import (QTensor, add_dequantized, dequantize, from_wire, pad_to_block, quantize,
                    sparsify, to_wire)

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


def hierarchical_all_reduce(x: torch.Tensor, ici_group, dcn_group, ici_config: Config = None,
                            dcn_config: Config = None, op: str = "sum",
                            generator: Optional[torch.Generator] = None) -> torch.Tensor:
    """Two-level all-reduce with a wire format a leg: reduce-scatter within
    the host (ici), the compressed all-reduce of this rank's shard across
    hosts (dcn), all-gather within the host.  The canonical config is
    ici_config=None (the host's links are fast), dcn_config=int8 (the slow
    leg); both legs take any dense config.  A quantized ici leg moves
    codes both ways (all_to_all, then all_gather of the requantized
    shard); a full-precision one reduce-scatters by the ring (rank d
    ending with shard d, as psum_scatter) and all-gathers.  The mean is
    the sum times 1/world.  Ops other than sum and mean: the uncompressed
    one-shot over ici, then over dcn."""
    ici_cfg, dcn_cfg = resolve(ici_config), resolve(dcn_config)
    if op not in ("sum", "mean"):
        return C.all_reduce(C.all_reduce(x, ici_group, op), dcn_group, op)
    n = _world(ici_group)
    world = n * _world(dcn_group)
    flat = x.float().reshape(-1)
    # a shard must hold whole quantization blocks of both legs
    blk = math.lcm(ici_cfg.block if ici_cfg.is_quantized else 1,
                   dcn_cfg.block if dcn_cfg.is_quantized else 1)
    pad = (-flat.numel()) % (n * blk)
    if pad:
        flat = F.pad(flat, (0, pad))
    shards = flat.view(n, -1)
    g_rs, g_ag = _leg_generators(generator, ici_group, ici_cfg)
    if n == 1:
        scat = shards[0]
    elif ici_cfg.is_quantized:
        qt = quantize(shards, ici_cfg, g_rs)
        wire = to_wire(qt.data).contiguous()
        data, scale = torch.empty_like(wire), torch.empty_like(qt.scale)
        dist.all_to_all_single(data, wire, group=ici_group)
        dist.all_to_all_single(scale, qt.scale.contiguous(), group=ici_group)
        scat = dequantize(QTensor(from_wire(data, ici_cfg), scale)).sum(dim=0)
    else:
        scat = C._staged(lambda t: C.ring_reduce_scatter_chunks(list(t), ici_group), shards,
                         ici_group)

    # the cross-host leg: every local rank reduces its shard, compressed
    scat = all_reduce(scat, dcn_group, dcn_cfg, op="sum", generator=generator)
    if op == "mean":
        scat = scat * (1.0 / world)

    if n == 1:
        out = scat
    elif ici_cfg.is_quantized:
        qt2 = quantize(scat, ici_cfg, g_ag)
        codes = C.all_gather(to_wire(qt2.data).contiguous(), ici_group)
        scales = C.all_gather(qt2.scale.contiguous(), ici_group)
        out = dequantize(QTensor(from_wire(codes, ici_cfg), scales)).reshape(-1)
    else:
        out = C.all_gather(scat, ici_group).reshape(-1)
    return out[:x.numel()].view(x.shape).to(x.dtype)


def group_all_reduce(xs: Sequence[torch.Tensor], group=None, config: Config = None,
                     op: str = "sum", generator: Optional[torch.Generator] = None):
    """Compressed all-reduce over a tensor list, one collective each."""
    return [all_reduce(x, group, config, op=op, generator=generator) for x in xs]


Pairs = Sequence[Tuple[int, int]]


def pair_shift(perm: Pairs, n: int) -> int:
    """The `ring_shift` shift t (rank d receives from rank d - t) that the
    (src, dst) pairing `perm` over n ranks is.  Raises unless it is a
    permutation (`plan.graph.validate_permutation`) and a whole ring
    shift: B11 shifts every rank of a group by one amount."""
    validate_permutation(perm, n, what="pair exchange")
    shifts = {(dst - src) % n for src, dst in perm}
    if len(perm) != n or len(shifts) != 1:
        raise ValueError(f"pair exchange: {list(perm)} is not a shift of all {n} ranks")
    return shifts.pop()


def pair_wire(x: torch.Tensor, config: Config,
              generator: Optional[torch.Generator] = None) -> Tuple[torch.Tensor, ...]:
    """What a rank sends of x in a pair exchange under `config`: (x,) for
    none; the codes (fp8 as bytes) and the per-block f32 scales of x's
    flat f32 copy padded to the block for bf16/int8/fp8; the f32 values
    and int32 indices of its kept coordinates for topk/randk."""
    cfg = resolve(config)
    if cfg.is_sparse:
        return sparsify(x.float().reshape(-1), cfg, generator)
    if cfg.scheme == "none":
        return (x,)
    qt = quantize(pad_to_block(x.float().reshape(-1), cfg.block), cfg, generator)
    return to_wire(qt.data), qt.scale


def pair_mix(x: torch.Tensor, received: Sequence[torch.Tensor], config: Config) -> torch.Tensor:
    """x averaged with the partner's `received` wire (`pair_wire`), in the
    JAX package's arithmetic as XLA compiles it: (x + other) * 0.5 in x's
    dtype for none; for a quantized wire 0.5 * (x + codes * scale) in f32,
    the sum one fused multiply-add (`quant.add_dequantized`), cast back;
    for a sparse one each received coordinate idx becomes
    0.5 * (x[idx] + value) in f32 and every other keeps x's value."""
    cfg = resolve(config)
    if cfg.is_sparse:
        vals, idx = received
        flat = x.float().reshape(-1)
        idx = idx.long()
        mixed = flat.index_put((idx,), 0.5 * (flat[idx] + vals))
        return mixed.view(x.shape).to(x.dtype)
    if cfg.scheme == "none":
        return (x + received[0]) * 0.5
    data, scale = received
    flat = pad_to_block(x.float().reshape(-1), cfg.block)
    total = add_dequantized(flat, QTensor(from_wire(data, cfg), scale))
    return (0.5 * total[:x.numel()]).view(x.shape).to(x.dtype)


def shift_wire(wire: Sequence[torch.Tensor], group, shift: int) -> Tuple[torch.Tensor, ...]:
    """One or two tensors shifted around the ring as one call (B11 on a
    card; its kernel moves bytes, so the two may differ in dtype)."""
    from ..ops.fused_matmul import ring_shift, ring_shift_pair

    if len(wire) == 1:
        return (ring_shift(wire[0], group, shift),)
    return ring_shift_pair(wire[0], wire[1], group, shift)


def sparse_pair_exchange(x: torch.Tensor, group=None, perm: Pairs = (), config: Config = None,
                         generator: Optional[torch.Generator] = None) -> torch.Tensor:
    """Sparsified directed pair averaging (the gossip path's wire diet).

    Each rank sends only the top-k (or a random-k subset, from
    `generator`) of its tensor's coordinates along the pairing `perm`
    ((src, dst) ranks of the group, a ring shift); the receiver averages
    the exchanged coordinates and keeps the rest of its tensor:

        x_i[idx_j] <- (x_i[idx_j] + vals_j) / 2,   everything else untouched

    Wire bytes: k·n·8 (f32 value + int32 index) instead of n·4."""
    cfg = resolve(config)
    if not cfg.is_sparse:
        raise ValueError(f"sparse_pair_exchange needs topk/randk, got {cfg.scheme!r}")
    return compressed_pair_average(x, group, perm, cfg, generator)


def compressed_pair_average(x: torch.Tensor, group=None, perm: Pairs = (), config: Config = None,
                            generator: Optional[torch.Generator] = None) -> torch.Tensor:
    """Directed pair averaging with a selectable wire format: each rank
    averages x with the x of the rank that `perm` pairs it with.

    Dense schemes (bf16/int8/fp8) quantize the pulled tensor: the
    partner's x crosses the wire as codes and the average runs in f32.
    Sparse schemes exchange only k·n coordinates (`sparse_pair_exchange`).
    none is the plain dense exchange."""
    cfg = resolve(config)
    shift = pair_shift(perm, _world(group))
    return pair_mix(x, shift_wire(pair_wire(x, cfg, generator), group, shift), cfg)
