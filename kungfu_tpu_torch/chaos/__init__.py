"""Chaos harness: deterministic fault injection for the self-healing loop
(counterpart of kungfu_tpu.chaos).

The reference tests elasticity only with planned resizes; unplanned
failures (a worker crash, a hang, a config-server outage, a torn or
corrupt checkpoint) are injected here from a declarative plan
(`KFT_FAULT_PLAN`), so multi-process CPU tests replay every failure mode
deterministically:

    KFT_FAULT_PLAN="crash@step=7:rank=2" \
        python -m kungfu_tpu_torch.run -w -heal -np 3 -platform cpu -- \
        python -m kungfu_tpu_torch.testing.fake_adaptive_trainer --total-samples 2048

`python -m kungfu_tpu_torch.chaos` runs the scripted crash-and-heal drill
(`--ckpt-drill corrupt|crash_in_save` the checkpoint drills).
"""
from .plan import (
    FAULT_PLAN_ENV,
    Fault,
    FaultPlan,
    parse_fault_plan,
    plan_from_env,
)
from .inject import (
    ChaosInjector,
    ServerChaos,
    injector_from_env,
    maybe_crash_in_save,
    server_chaos_from_env,
    set_launch_rank,
)

__all__ = [
    "FAULT_PLAN_ENV",
    "Fault",
    "FaultPlan",
    "parse_fault_plan",
    "plan_from_env",
    "ChaosInjector",
    "ServerChaos",
    "injector_from_env",
    "maybe_crash_in_save",
    "server_chaos_from_env",
    "set_launch_rank",
]
