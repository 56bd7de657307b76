"""The launcher, `python -m kungfu_tpu_torch.run -np 4 <worker>` (counterpart
of kungfu_tpu.run): static mode only; watch, heal and elastic mode wait for
the elastic slice (ROADMAP A4)."""
from .job import ChipPool, Job, Proc
from .launcher import ProcRunner, simple_run

__all__ = ["ChipPool", "Job", "Proc", "ProcRunner", "simple_run"]
