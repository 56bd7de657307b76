"""Block-wise quantize/dequantize on tensors (counterpart of
kungfu_tpu.compression.quant).

A tensor is viewed as blocks of `block` consecutive elements; each block
carries one f32 scale = absmax / codemax, and its elements are stored as
int8 codes or fp8 e4m3 values (bf16 keeps the values and unit scales).
The arithmetic is the JAX package's as its compiled programs run it, so
codes and scales are bit-equal to theirs:

  scale   absmax * (1 / codemax) with the reciprocal rounded to f32 (XLA
          turns the division by the constant into this product), 1.0 for
          an all-zero block
  int8    round-half-to-even(v / scale), an IEEE division, clamped to +-127
  fp8     clamp(v / scale, +-448), then the cast to float8_e4m3fn (round to
          nearest even)
  dequant codes (as f32) * scale; where the sum x + codes * scale follows
          (a ring hop adding a received partial to its own chunk), XLA
          contracts the two into one fused multiply-add, and so does
          `add_dequantized`; likewise x - codes * scale in `residual`, the
          error-feedback residual.  `fma` emulates the fused operation
          exactly with f64 temporaries: it is the plain version the CPU
          runs; the card computes both in the CUDA kernels (csrc/ring.cu,
          compression.error_feedback.residual_)

Stochastic rounding (`int8-sr`) and `randk` draw from an explicit
`torch.Generator`; they cannot reproduce `jax.random`'s bits, so the tests
hold them by their properties (unbiased, within one scale step).
"""
from __future__ import annotations

from typing import NamedTuple, Optional, Tuple

import torch
import torch.nn.functional as F

from .config import CompressionConfig, FP8_E4M3_MAX, INT8_MAX

FP8_DTYPE = torch.float8_e4m3fn
# 1 / codemax rounded to f32, as the compiled reference multiplies by it
CODE_RECIP = {"int8": torch.tensor(1.0, dtype=torch.float32) / INT8_MAX,
          "fp8": torch.tensor(1.0, dtype=torch.float32) / FP8_E4M3_MAX}


class QTensor(NamedTuple):
    """Quantized view of a tensor blocked along its LAST axis.

    data:  (..., nblocks, block) codes — int8, fp8, or bf16 (scale-free).
    scale: (..., nblocks, 1) f32 per-block scales (ones for bf16).
    """

    data: torch.Tensor
    scale: torch.Tensor


def blocked_shape(n: int, block: int) -> Tuple[int, int]:
    """(nblocks, padded_len) for n elements at the given block size."""
    nblocks = -(-n // block)
    return nblocks, nblocks * block


def pad_to_block(flat: torch.Tensor, block: int) -> torch.Tensor:
    """Zero-pad a 1-D tensor to a whole number of blocks."""
    pad = (-flat.numel()) % block
    return F.pad(flat, (0, pad)) if pad else flat


def block_scale(absmax: torch.Tensor, cfg: CompressionConfig) -> torch.Tensor:
    """The f32 scale of blocks whose largest magnitude is `absmax`."""
    recip = CODE_RECIP[cfg.scheme].to(absmax.device)
    return torch.where(absmax > 0, absmax * recip, torch.ones_like(absmax))


def quantize(x: torch.Tensor, cfg: CompressionConfig,
             generator: Optional[torch.Generator] = None) -> QTensor:
    """Quantize (..., L) blockwise along the last axis; L % cfg.block == 0.

    The caller owns padding (see `pad_to_block`), as in the JAX package.
    `generator` feeds stochastic rounding (a fresh one seeded 0 if None)."""
    if x.shape[-1] % cfg.block:
        raise ValueError(
            f"last dim {x.shape[-1]} not a multiple of block {cfg.block}; "
            "pad with pad_to_block first")
    lead = tuple(x.shape[:-1])
    nblocks = x.shape[-1] // cfg.block
    xb = x.float().reshape(*lead, nblocks, cfg.block)
    if cfg.scheme == "bf16":
        return QTensor(data=xb.to(torch.bfloat16),
                       scale=torch.ones((*lead, nblocks, 1), dtype=torch.float32,
                                        device=x.device))
    if cfg.scheme not in ("int8", "fp8"):
        raise ValueError(f"scheme {cfg.scheme!r} is not a dense quantizer")
    scale = block_scale(xb.abs().amax(dim=-1, keepdim=True), cfg)
    y = xb / scale
    if cfg.scheme == "fp8":
        return QTensor(data=y.clamp(-FP8_E4M3_MAX, FP8_E4M3_MAX).to(FP8_DTYPE), scale=scale)
    if cfg.stochastic:
        if generator is None:
            generator = torch.Generator(device=x.device).manual_seed(0)
        # floor(y + U[0,1)) is the unbiased dithered rounding
        noise = torch.rand(y.shape, generator=generator, device=y.device, dtype=torch.float32)
        y = torch.floor(y + noise)
    else:
        y = torch.round(y)
    return QTensor(data=y.clamp(-INT8_MAX, INT8_MAX).to(torch.int8), scale=scale)


def to_wire(data: torch.Tensor) -> torch.Tensor:
    """Codes as a backend or a kernel moves them: fp8 as its uint8 bytes."""
    return data.view(torch.uint8) if data.dtype == FP8_DTYPE else data


def from_wire(data: torch.Tensor, cfg: CompressionConfig) -> torch.Tensor:
    """The inverse of `to_wire` for codes of `cfg`."""
    return data.view(FP8_DTYPE) if cfg.scheme == "fp8" else data


def dequantize(qt: QTensor) -> torch.Tensor:
    """QTensor -> f32 tensor of shape (..., nblocks * block)."""
    full = qt.data.float() * qt.scale
    return full.reshape(*full.shape[:-2], full.shape[-2] * full.shape[-1])


def fma(a: torch.Tensor, b: torch.Tensor, c: torch.Tensor) -> torch.Tensor:
    """a * b + c on f32 tensors with one rounding, as a fused multiply-add
    (CUDA's fmaf, XLA's contracted multiply and add) computes it.

    The product of two f32 values is exact in f64; the f64 sum is one
    rounding, and its error is recovered exactly (TwoSum).  Rounding that
    sum to f32 is right except where it lands exactly halfway between two
    f32 values: there the error says which way the exact value lies.
    Large tensors go in slices of 2^24 values, so the f64 temporaries stay
    small."""
    a, b, c = torch.broadcast_tensors(a, b, c)
    out = torch.empty(c.shape, dtype=torch.float32, device=c.device)
    fa, fb, fc, fo = (t.reshape(-1) for t in (a, b, c, out))
    step = 1 << 24
    for i in range(0, fo.numel(), step):
        s = slice(i, i + step)
        p = fa[s].double() * fb[s].double()
        cd = fc[s].double()
        r = p + cd
        bv = r - p
        err = (p - (r - bv)) + (cd - bv)
        f = r.float()
        fd = f.double()
        inf = torch.full_like(f, float("inf"))
        g = torch.nextafter(f, torch.where(r > fd, inf, -inf))  # f's neighbour on r's side
        tie = (r != fd) & (r == (fd + g.double()) * 0.5)
        fo[s] = torch.where(tie & (err != 0) & ((err > 0) == (g > f)), g, f)
    return out


def add_dequantized(x: torch.Tensor, qt: QTensor) -> torch.Tensor:
    """x + dequantize(qt) (x flat f32), each element one fused multiply-add."""
    codes = qt.data.float().reshape(-1)
    scale = qt.scale.expand(qt.data.shape).reshape(-1)
    return fma(codes, scale, x)


def residual(x: torch.Tensor, cfg: CompressionConfig,
             generator: Optional[torch.Generator] = None) -> torch.Tensor:
    """x - roundtrip(x) in f32: the error this config's compression puts
    on x.  For int8/fp8 each element is one fused multiply-add,
    x - code * scale, as the compiled reference computes it."""
    x = x.float()
    if not cfg.is_quantized:
        return x - roundtrip(x, cfg, generator)
    q = quantize(pad_to_block(x.reshape(-1), cfg.block), cfg, generator)
    n = x.numel()
    codes = q.data.float().reshape(-1)[:n]
    scale = q.scale.expand(q.data.shape).reshape(-1)[:n]
    return fma(-codes, scale, x.reshape(-1)).view(x.shape)


def roundtrip(x: torch.Tensor, cfg: CompressionConfig,
              generator: Optional[torch.Generator] = None) -> torch.Tensor:
    """dequant(quant(x)) with x's shape and dtype — the local lossy image
    of x under this config; error-feedback residuals are x - roundtrip(x)."""
    if cfg.scheme == "none":
        return x
    if cfg.is_sparse:
        flat = x.float().reshape(-1)
        vals, idx = sparsify(flat, cfg, generator)
        out = torch.zeros_like(flat).index_put_((idx.long(),), vals)
        return out.reshape(x.shape).to(x.dtype)
    flat = pad_to_block(x.float().reshape(-1), cfg.block)
    out = dequantize(quantize(flat, cfg, generator))
    return out[:x.numel()].reshape(x.shape).to(x.dtype)


def quantization_error(x: torch.Tensor, cfg: CompressionConfig,
                       generator: Optional[torch.Generator] = None) -> torch.Tensor:
    """Relative L2 quantization error ||x - Q(x)|| / (||x|| + eps), one scalar."""
    err = (x - roundtrip(x, cfg, generator)).float()
    num = torch.sqrt(torch.sum(err * err))
    den = torch.sqrt(torch.sum(torch.square(x.float()))) + 1e-12
    return num / den


def sparsify(flat: torch.Tensor, cfg: CompressionConfig,
             generator: Optional[torch.Generator] = None
             ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(values, int32 indices) of the kept coordinates of a 1-D tensor.

    topk keeps the largest-magnitude k·n coordinates, largest first;
    randk keeps a uniform random k·n subset (from `generator`)."""
    if not cfg.is_sparse:
        raise ValueError(f"scheme {cfg.scheme!r} is not a sparsifier")
    n = flat.numel()
    kn = max(1, int(round(cfg.k * n)))
    if cfg.scheme == "topk":
        idx = torch.topk(flat.abs(), kn).indices
    else:
        if generator is None:
            generator = torch.Generator(device=flat.device).manual_seed(0)
        idx = torch.randperm(n, generator=generator, device=flat.device)[:kn]
    return flat[idx], idx.to(torch.int32)
