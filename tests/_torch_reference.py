"""Loads the JAX package as the reference for the PyTorch port's tests.

Under jax 0.9 `kungfu_tpu` does not import: it reads
`pltpu.TPUMemorySpace`, which that release renamed `pltpu.MemorySpace`.
`jax_reference()` sets the old name for as long as a test module needs
the reference, then removes it and every `kungfu_tpu` module it imported,
so the rest of the process finds the JAX package exactly as before.
"""
from __future__ import annotations

import contextlib
import sys


def _jax_modules():
    return {m for m in sys.modules if m == "kungfu_tpu" or m.startswith("kungfu_tpu.")}


@contextlib.contextmanager
def jax_reference():
    from jax.experimental.pallas import tpu as pltpu

    added = not hasattr(pltpu, "TPUMemorySpace")
    before = _jax_modules()
    if added:
        pltpu.TPUMemorySpace = pltpu.MemorySpace
    try:
        import kungfu_tpu

        yield kungfu_tpu
    finally:
        if added:
            del pltpu.TPUMemorySpace
            for name in _jax_modules() - before:
                del sys.modules[name]
