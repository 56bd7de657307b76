"""Parallelism beyond data parallelism (counterpart of kungfu_tpu.parallel):
the rules table, ring and Ulysses sequence parallelism, the pipeline
schedules and PipelinedLM, and the experts of MoEMLP."""
from .ring_attention import full_attention, ring_attention
from .ulysses import ulysses_attention
from .sharding import DEFAULT_RULES, param_shardings, rules_for_mesh
from .pp import (
    pipeline_apply,
    pipeline_apply_grouped,
    pipeline_spmd,
    stack_group_params,
    stack_stage_params,
)
from .moe import MoEMLP

__all__ = [
    "ring_attention", "full_attention", "ulysses_attention",
    "DEFAULT_RULES", "rules_for_mesh", "param_shardings",
    "pipeline_apply", "pipeline_apply_grouped", "pipeline_spmd",
    "stack_stage_params", "stack_group_params", "PipelinedLM",
    "MoEMLP",
]


def __getattr__(name):
    # lazy: pp_transformer imports models.transformer, which imports this
    # package (ring_attention): an import here would be circular
    if name == "PipelinedLM":
        from .pp_transformer import PipelinedLM

        return PipelinedLM
    raise AttributeError(name)
