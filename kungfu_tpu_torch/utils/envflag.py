"""Shared truthy-env-flag parsing (counterpart of kungfu_tpu.utils.envflag)."""
import os


def env_flag(name: str) -> bool:
    return os.environ.get(name, "").lower() in ("1", "true", "yes", "on")


def analyze_enabled(analyze=None) -> bool:
    """Resolve an `analyze=` hook argument: None defers to KUNGFU_ANALYZE.

    The shared opt-in switch for the kf-lint hooks; one env var arms every
    hook at once.  The port's hooks (`analysis/`) arrive with ROADMAP A.8;
    until then the journal's strict mode is the one reader."""
    return env_flag("KUNGFU_ANALYZE") if analyze is None else bool(analyze)
