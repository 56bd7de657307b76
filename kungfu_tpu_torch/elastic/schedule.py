"""Step-based cluster-size schedules (counterpart of
kungfu_tpu.elastic.schedule).

Reference: the StepBasedSchedule op (srcs/cpp/src/tensorflow/ops/cpu/
elastic.cpp:16-82) and kungfu.tensorflow.ops.step_based_schedule
(ops/adapt.py:46-62): a piecewise-constant "size:steps,size:steps,..."
schedule that drives propose_new_size as training progresses.
"""
from __future__ import annotations

from typing import List, Optional, Tuple


class StepBasedSchedule:
    """Parse "2:40,4:40,1:20": 40 steps at size 2, then 40 at 4, then 20 at 1."""

    def __init__(self, spec: str):
        self.pieces: List[Tuple[int, int]] = []  # (size, steps)
        if spec:
            for part in spec.split(","):
                size, steps = part.split(":")
                size_i, steps_i = int(size), int(steps)
                if size_i <= 0 or steps_i <= 0:
                    raise ValueError(f"invalid schedule piece {part!r}")
                self.pieces.append((size_i, steps_i))

    @property
    def total_steps(self) -> int:
        return sum(s for _, s in self.pieces)

    def size_at(self, step: int) -> Optional[int]:
        """Desired cluster size at `step`; None when the schedule is exhausted."""
        acc = 0
        for size, steps in self.pieces:
            acc += steps
            if step < acc:
                return size
        return None

    def __bool__(self) -> bool:
        return bool(self.pieces)
