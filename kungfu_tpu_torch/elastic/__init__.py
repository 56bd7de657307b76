"""Elastic training (counterpart of kungfu_tpu.elastic): the config
service (one server or a replicated ensemble, `elastic.ensemble`), the
resize protocol and the schedules."""
from .config_client import ConfigClient, propose_new_size
from .config_server import ConfigServer
from .schedule import StepBasedSchedule


def __getattr__(name):
    # the training loop needs torch: loaded on first use, so that a config
    # replica (`python -m kungfu_tpu_torch.elastic.config_server`) starts
    # without it
    if name in ("ElasticConfig", "run_elastic"):
        from . import trainer

        return getattr(trainer, name)
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")


__all__ = [
    "ConfigClient", "ConfigServer", "propose_new_size",
    "StepBasedSchedule", "ElasticConfig", "run_elastic",
]
