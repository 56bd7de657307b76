"""Elastic training (counterpart of kungfu_tpu.elastic): the config
service, the resize protocol and the schedules.  The replicated config
ensemble waits for ROADMAP A.5c."""
from .config_client import ConfigClient, propose_new_size
from .config_server import ConfigServer
from .schedule import StepBasedSchedule
from .trainer import ElasticConfig, run_elastic

__all__ = [
    "ConfigClient", "ConfigServer", "propose_new_size",
    "StepBasedSchedule", "ElasticConfig", "run_elastic",
]
