"""Error-feedback (EF) residual state for compressed gradient exchange
(counterpart of kungfu_tpu.compression.error_feedback).

EF-SGD: the compression error of step t is added back into step t+1's
gradient, so it accumulates in a residual instead of being lost —

    c_t   = g_t + e_t                (correct)
    wire  = compress(c_t)            (what the collective moves)
    e_t+1 = c_t - decompress(wire)   (residual_update)

The residual mirrors the gradients, one f32 tensor each (a list, a tuple
or a dict of tensors, as the gradients come); each replica keeps its own.
It tracks the error this peer introduces, `c - roundtrip(c)` per tensor
(`quant.residual`), whatever blocking the collective itself used on a
bucket of them.

`correct_` and `residual_update_` are the same two steps in place, as the
compressed S-SGD step (optimizers/sync.py) runs them: the residual's
memory holds c until the collective has read it, then the new residual,
so a step keeps one f32 copy of the gradients.  Under deterministic int8
and fp8 the new residuals of a step's CUDA gradients are one launch of a
hand-written kernel (csrc/ring.cu `ef_residual_kernel`, on the fused ring
kernels' codec) over a table of up to EF_TABLE tensors (`residual_group_`;
more tensors take more launches, `ef_plan`); a CPU tensor takes its plain
version, `quant.residual`.
"""
from __future__ import annotations

import ctypes
from typing import Any, List, NamedTuple, Optional, Sequence, Tuple

import torch

from ..compat import kernel_mode
from ..ops.flash import Kernel
from .config import CompressionConfig, resolve
from .quant import CODE_RECIP, residual

# The reference computes the residual with XLA ops (no Pallas kernel); on
# the card it is this one kernel over a table of the step's gradients.
EF_RESIDUAL = Kernel("ef_residual", "kungfu_tpu_torch/ops/csrc/ring.cu",
                     "kungfu_tpu/compression/error_feedback.py:55")  # residual_update
KERNELS = (EF_RESIDUAL,)
_SEG = 256  # values one warp of the kernel quantizes at a time
EF_TABLE = 250  # csrc/ring.cu kEfMax: tensors in one launch (16-byte entries in 4 KB)
EF_PIECE = 1 << 31  # values of one table entry at most: a larger tensor takes several


class EFState(NamedTuple):
    """Residuals: f32 zeros shaped like the gradients, in their structure."""

    residual: Any


def _map(fn, *trees):
    first = trees[0]
    if isinstance(first, dict):
        return {k: _map(fn, *(t[k] for t in trees)) for k in first}
    if isinstance(first, (list, tuple)):
        return type(first)(_map(fn, *xs) for xs in zip(*trees))
    return fn(*trees)


def init(tree: Any) -> EFState:
    return EFState(residual=_map(
        lambda g: torch.zeros(g.shape, dtype=torch.float32, device=g.device), tree))


def correct(updates: Any, state: EFState) -> Any:
    """g + e: the corrected gradient the compressor should see (f32)."""
    return _map(lambda g, r: g.float() + r, updates, state.residual)


def residual_update(corrected: Any, cfg: CompressionConfig,
                    generator: Optional[torch.Generator] = None) -> EFState:
    """e' = c - Q(c): the error this peer's local compression introduced."""
    cfg = resolve(cfg)
    if cfg.scheme == "none":
        return init(corrected)
    return EFState(residual=_map(lambda c: residual(c, cfg, generator), corrected))


def apply(updates: Any, state: EFState, cfg: CompressionConfig,
          generator: Optional[torch.Generator] = None) -> Tuple[Any, EFState]:
    """(corrected, next_state) in one call — the common composition."""
    corrected = correct(updates, state)
    return corrected, residual_update(corrected, cfg, generator)


def correct_(updates: Any, state: EFState) -> Any:
    """`correct` in place: each residual becomes g + e (f32, the same
    bits); returns the residuals, now the corrected gradients."""
    return _map(lambda g, r: r.add_(g), updates, state.residual)


def _leaves(tree: Any) -> List[torch.Tensor]:
    out: List[torch.Tensor] = []
    _map(out.append, tree)
    return out


def residual_update_(corrected: Any, cfg: CompressionConfig,
                     generator: Optional[torch.Generator] = None) -> EFState:
    """`residual_update` in place: each corrected f32 tensor becomes its
    residual c - Q(c); returns the state that holds them.  Under a
    deterministic int8 or fp8 config the tensors go through
    `residual_group_` together."""
    cfg = resolve(cfg)
    if cfg.scheme == "none":
        return EFState(residual=_map(lambda c: c.zero_(), corrected))
    if cfg.is_quantized and not cfg.stochastic:
        residual_group_(_leaves(corrected), cfg)
        return EFState(residual=corrected)
    return EFState(residual=_map(lambda c: c.copy_(residual(c, cfg, generator)), corrected))


def ef_plan(sizes: Sequence[int]) -> List[List[Tuple[int, int, int]]]:
    """The launches of the residual kernel over tensors of `sizes` values:
    each a table of at most EF_TABLE entries (tensor index, first value,
    values).  A tensor above EF_PIECE values takes several entries, each
    starting on a multiple of 256 values (so on a quantization block of
    the tensor); an empty tensor takes none.  Never refuses a list."""
    launches: List[List[Tuple[int, int, int]]] = [[]]
    for i, n in enumerate(sizes):
        for first in range(0, n, EF_PIECE):
            if len(launches[-1]) == EF_TABLE:
                launches.append([])
            launches[-1].append((i, first, min(EF_PIECE, n - first)))
    return [t for t in launches if t]


def residual_group_(cs: Sequence[torch.Tensor], cfg: CompressionConfig
                    ) -> List[torch.Tensor]:
    """c - roundtrip(c) in place on every tensor of cs (contiguous f32, one
    device), under a deterministic int8 or fp8 config: on a card one launch
    of the `ef_residual` kernel per table of `ef_plan` (a block of 8 to 256
    values that divides 256), bit-equal to a launch per tensor; on the CPU
    the plain version, tensor by tensor."""
    cfg = resolve(cfg)
    if cfg.scheme not in CODE_RECIP or cfg.stochastic:
        raise NotImplementedError(
            f"ef_residual: {cfg.describe()} has no kernel (deterministic int8/fp8 only)")
    cs = list(cs)
    for c in cs:
        if c.dtype != torch.float32 or not c.is_contiguous():
            raise ValueError(f"ef_residual: needs contiguous f32 tensors, got {c.dtype}"
                             f"{'' if c.is_contiguous() else ' (not contiguous)'}")
    devices = {c.device for c in cs}
    if len(devices) > 1:
        raise ValueError(f"ef_residual: the tensors lie on {sorted(map(str, devices))}, "
                         "not on one device")
    if not cs:
        return cs
    device = cs[0].device
    if kernel_mode(device) == "plain":
        for c in cs:
            c.copy_(residual(c, cfg))
        return cs
    if cfg.block % 8 or _SEG % cfg.block:
        raise NotImplementedError(
            f"ef_residual: block {cfg.block} has no kernel (blocks of 8 to 256 values "
            "that divide 256)")
    from ..ops import _build

    fn = _build.function("kft_ef_residual")
    scheme, recip = (0 if cfg.scheme == "int8" else 1), float(CODE_RECIP[cfg.scheme])
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream(device).cuda_stream
        for table in ef_plan([c.numel() for c in cs]):
            entries = (ctypes.c_longlong * (2 * len(table)))(
                *(v for i, first, n in table for v in (cs[i].data_ptr() + 4 * first, n)))
            err = fn(entries, len(table), scheme, cfg.block, recip, stream)
            if err != 0:
                raise RuntimeError(
                    f"{EF_RESIDUAL.name}: kernel launch failed with CUDA error {err}")
            EF_RESIDUAL.launches += 1
    return cs


def residual_(c: torch.Tensor, cfg: CompressionConfig) -> torch.Tensor:
    """c - roundtrip(c) in place on one contiguous f32 tensor: a group of
    one (`residual_group_`)."""
    return residual_group_([c], cfg)[0]
