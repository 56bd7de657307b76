"""Device resolution and the kernel gate.

Counterpart of `kungfu_tpu.compat.pallas_mode`.  The JAX gate picks
"compiled" on a TPU, "interpret" on request and otherwise goes quietly
"off" to the XLA fallbacks.  Here the tensor's device decides and nothing
is quiet:

  cuda  "kernel": the hand-written CUDA kernel runs, or the wrapper raises
  cpu   "plain":  the kernel's plain PyTorch version runs (the tests' path)
  else  raises

Entry points default to the card.  Without one they raise instead of
moving to the CPU; the CPU runs only when the caller asks for it.
"""
from __future__ import annotations

from typing import Optional, Union

import torch

Device = Union[str, torch.device]


def resolve_device(device: Optional[Device] = None) -> torch.device:
    """The device an entry point runs on: "cuda" unless the caller names
    another.  Raises when CUDA is asked for (or defaulted to) and absent."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"unsupported device {dev}: use 'cuda' or 'cpu'")
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device available; pass device='cpu' to run the plain "
            "PyTorch versions of the kernels"
        )
    return dev


def kernel_mode(device: Device) -> str:
    """"kernel" for a CUDA device, "plain" for the CPU; raises otherwise."""
    dev = torch.device(device)
    if dev.type == "cuda":
        return "kernel"
    if dev.type == "cpu":
        return "plain"
    raise ValueError(f"no kernel or plain path for device {dev}")
