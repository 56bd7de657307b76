"""Bias-corrected exponential moving average (counterpart of
kungfu_tpu.utils.ema; reference include/kungfu/utils/ema.hpp)."""
from __future__ import annotations


class EMA:
    def __init__(self, alpha: float):
        if not (0.0 < alpha <= 1.0):
            raise ValueError("alpha in (0, 1]")
        self.alpha = alpha
        self._value = 0.0
        self._count = 0

    def update(self, x: float) -> float:
        self._count += 1
        self._value = (1 - self.alpha) * self._value + self.alpha * x
        return self.value

    @property
    def value(self) -> float:
        if self._count == 0:
            return 0.0
        # bias correction (ema.hpp, Adam-style)
        return self._value / (1 - (1 - self.alpha) ** self._count)

    @property
    def count(self) -> int:
        return self._count
