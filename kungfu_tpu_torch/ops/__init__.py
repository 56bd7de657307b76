"""Kernels of the port; each wrapper's plain PyTorch version sits beside it."""
from .flash import KERNELS, flash_attention, flash_attention_with_lse
from .fused_matmul import ring_shift

__all__ = ["KERNELS", "flash_attention", "flash_attention_with_lse", "ring_shift"]
