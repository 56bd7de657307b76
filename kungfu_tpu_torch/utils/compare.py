"""How a kernel is held against its plain version: normwise relative error.

A largest-entry-scaled max error lets a kernel that drops whole blocks of
work pass wherever the dropped terms are small next to the tensor's
largest entry (late attention rows, far keys).  The normwise relative
error ||got - want||_2 / ||want||_2 measures the error against the size of
what was computed; taken over blocks of rows it also sees a fault that
hits only a few blocks.
"""
from __future__ import annotations

from typing import Tuple

import torch
import torch.nn.functional as F

ROW_BLOCK = 64  # the kernels' row tile: a fault there shows in one block

# Limits on the worst row block's normwise relative error, kernel against
# plain version on the same inputs.  f32: the same f32 products summed in
# another order (readings on an H100 up to 7e-7).  fp16 and bf16: P and dS
# rounded to the operand type before their products in the kernels (the
# plain forward keeps P in f32) and the output rounded once more, 2^-11 and
# 2^-8 relative each (readings up to 3.2e-4 and 2.8e-3); the limits leave
# 3-15 times the readings.  A 64-wide key or query block dropped from a row
# block's sum reads 0.09 or more at L=2048 (tests/_flash_faults.py).
REL_LIMIT = {torch.float32: 1e-5, torch.float16: 2e-3, torch.bfloat16: 1e-2}
# The row log-sum-exp is f32 from the same f32 scores on both sides
# (readings about 1e-6); a dropped key block moves it by 0.03 or more.
LSE_ATOL = 1e-3


def rel_errs(got: torch.Tensor, want: torch.Tensor,
             block: int = ROW_BLOCK) -> Tuple[float, float]:
    """(whole, worst block) normwise relative errors of got against want,
    both [B, L, H, D]: ||got - want|| / ||want|| over the whole tensor, and
    its largest value over blocks of `block` rows (along L, the last block
    ragged) of one (batch, head)."""
    diff2 = (got.float() - want.float()).square().sum(-1)  # [B, L, H]
    ref2 = want.float().square().sum(-1)
    whole = (diff2.sum() / ref2.sum()).sqrt().item()
    pad = -diff2.shape[1] % block

    def by_block(x):
        x = F.pad(x, (0, 0, 0, pad))
        return x.reshape(x.shape[0], -1, block, x.shape[2]).sum(2)

    worst = (by_block(diff2) / by_block(ref2).clamp_min(1e-30)).sqrt().max().item()
    return whole, worst
