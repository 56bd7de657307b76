"""The launcher, `python -m kungfu_tpu_torch.run -np 4 <worker>` (counterpart
of kungfu_tpu.run): static mode, watch mode (`-w`: the elastic config
service's document drives which workers run; `-heal`: the self-healing
supervisor) and `run/distribute.py` (parallel ssh and remote static
jobs)."""
from .job import ChipPool, Job, Proc
from .launcher import ProcRunner, WatchRunner, simple_run

__all__ = ["ChipPool", "Job", "Proc", "ProcRunner", "WatchRunner", "simple_run"]
