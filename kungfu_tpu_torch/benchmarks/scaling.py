"""The step decomposition of the scaling observatory (counterpart of
kungfu_tpu/benchmarks/scaling.py `step_attribution`; the rest of that
module, the scaling sweep and its SLO gate, waits for ROADMAP A.8)."""
from __future__ import annotations

from typing import Dict


def step_attribution(step_ms: float, compute_ms: float,
                     data_ms: float = 0.0) -> Dict[str, float]:
    """One measured step as fractions: compute, data wait and collective
    wait.  `efficiency` is compute / step, the share of the step an ideal
    (zero-communication) fleet would keep; the lost share is the wait for
    collectives.  Rounded as the JAX package rounds them."""
    step_ms = max(float(step_ms), 1e-9)
    compute_ms = min(max(float(compute_ms), 0.0), step_ms)
    data_ms = min(max(float(data_ms), 0.0), step_ms - compute_ms)
    wait_ms = max(0.0, step_ms - compute_ms - data_ms)
    return {
        "step_ms": round(step_ms, 3),
        "compute_ms": round(compute_ms, 3),
        "compute_frac": round(compute_ms / step_ms, 4),
        "data_frac": round(data_ms / step_ms, 4),
        "collective_wait_frac": round(wait_ms / step_ms, 4),
        "efficiency": round(compute_ms / step_ms, 4),
    }
