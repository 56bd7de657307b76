"""Compressed collectives: quantized all-reduce + error feedback
(counterpart of kungfu_tpu.compression).

  config.py          CompressionConfig (frozen, hashable), named registry,
                     per-axis selection ({"ici": None, "dcn": INT8})
  quant.py           block-wise int8/fp8 quantize/dequantize (per-block f32
                     scales, optional stochastic rounding) on tensors
  collectives.py     the quantized RS->AG all-reduce over a process group
                     (f32 accumulators), cross_all_reduce, group_all_reduce,
                     and the gossip pull's pair exchanges
                     (compressed_pair_average, sparse_pair_exchange)
  error_feedback.py  EF residuals, so compression error feeds back into the
                     next step's gradients

Consumers: optimizers/sync.py (compression= on the gradient all-reduce),
ops/ring_collectives.fused_ring_all_reduce (the codec inside the ring
kernels, B7/B8) and optimizers/gossip.py (compression= on the pull).
"""
from .config import (
    AxisCompression,
    AxisConfig,
    CompressionConfig,
    BF16,
    FP8,
    INT8,
    INT8_SR,
    NONE,
    RANDK_1PCT,
    TOPK_1PCT,
    register,
    registered,
    resolve,
    resolve_for_axis,
    validate_axis_keys,
)
from .quant import (
    QTensor,
    dequantize,
    pad_to_block,
    quantization_error,
    quantize,
    roundtrip,
    sparsify,
)
from .collectives import (
    all_reduce,
    compressed_pair_average,
    cross_all_reduce,
    group_all_reduce,
    hierarchical_all_reduce,
    sparse_pair_exchange,
)
from . import error_feedback
from .error_feedback import EFState

__all__ = [
    "AxisCompression", "AxisConfig", "CompressionConfig",
    "NONE", "BF16", "INT8", "INT8_SR", "FP8", "TOPK_1PCT", "RANDK_1PCT",
    "register", "registered", "resolve", "resolve_for_axis",
    "validate_axis_keys",
    "QTensor", "quantize", "dequantize", "roundtrip", "pad_to_block",
    "quantization_error", "sparsify",
    "all_reduce", "cross_all_reduce", "hierarchical_all_reduce",
    "group_all_reduce", "sparse_pair_exchange", "compressed_pair_average",
    "error_feedback", "EFState",
]
