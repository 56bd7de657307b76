"""Named global training variables (counterpart of kungfu_tpu.variables).

Reference: srcs/python/kungfu/tensorflow/variables.py:34-122 — a registry of
named TF global variables (`kungfu_batch_size`, `kungfu_trained_samples`,
`kungfu_gradient_noise_scale`, ...) that hooks, policies, and monitor
optimizers read/write by name.  Here the registry is a process-local,
thread-safe table of host scalars: the monitored values live in the
monitor optimizers' state on the device (optimizers/monitor.py), and
`publish_monitor_state` copies them into this table at host-sync points
so policies and user code can read them by the same names.
"""
from __future__ import annotations

import threading
from typing import Callable, Dict, List, Optional

BATCH_SIZE = "kungfu_batch_size"
TRAINED_SAMPLES = "kungfu_trained_samples"
GRADIENT_NOISE_SCALE = "kungfu_gradient_noise_scale"
GRADIENT_VARIANCE = "kungfu_gradient_variance"
CLUSTER_SIZE = "kungfu_cluster_size"

STANDARD_NAMES = (
    BATCH_SIZE,
    TRAINED_SAMPLES,
    GRADIENT_NOISE_SCALE,
    GRADIENT_VARIANCE,
    CLUSTER_SIZE,
)


class Variables:
    """Thread-safe named scalar table with change listeners."""

    def __init__(self):
        self._lock = threading.Lock()
        self._values: Dict[str, float] = {}
        self._listeners: List[Callable[[str, float], None]] = []

    def set(self, name: str, value: float) -> None:
        with self._lock:
            self._values[name] = float(value)
            listeners = list(self._listeners)
        for fn in listeners:
            fn(name, float(value))

    def get(self, name: str, default: Optional[float] = None) -> Optional[float]:
        with self._lock:
            return self._values.get(name, default)

    def add(self, name: str, delta: float) -> float:
        with self._lock:
            v = self._values.get(name, 0.0) + float(delta)
            self._values[name] = v
            listeners = list(self._listeners)
        for fn in listeners:
            fn(name, v)
        return v

    def subscribe(self, fn: Callable[[str, float], None]) -> None:
        with self._lock:
            self._listeners.append(fn)

    def snapshot(self) -> Dict[str, float]:
        with self._lock:
            return dict(self._values)

    def reset(self) -> None:
        with self._lock:
            self._values.clear()
            self._listeners.clear()


_global = Variables()


def global_variables() -> Variables:
    return _global


def set_variable(name: str, value: float) -> None:
    _global.set(name, value)


def get_variable(name: str, default: Optional[float] = None) -> Optional[float]:
    return _global.get(name, default)


def publish_monitor_state(opt_state) -> Dict[str, float]:
    """Publish GNS/variance from an optimizer (the trainer's
    `TrainState.opt_state`, any wrapper chain) into the registry (the named
    global variables the reference surfaces, variables.py:96-118).  Reads
    the device scalars, so it waits for the step."""
    out: Dict[str, float] = {}
    from .optimizers.monitor import get_gradient_variance, get_noise_scale

    for name, getter in (
        (GRADIENT_NOISE_SCALE, get_noise_scale),
        (GRADIENT_VARIANCE, get_gradient_variance),
    ):
        try:
            val = float(getter(opt_state))
        except ValueError:
            continue
        _global.set(name, val)
        out[name] = val
    return out
