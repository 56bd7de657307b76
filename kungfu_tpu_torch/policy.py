"""Training policies: lifecycle hooks around the train loop (counterpart
of kungfu_tpu.policy).

Reference: srcs/python/kungfu/policy/{base_policy,policy_hook}.py — a
`BasePolicy` with before/after_{train,epoch,step} callbacks driven by a
SessionRunHook that maintains the trained-samples and batch-size global
variables.  Here `PolicyRunner` plays the hook's role inside
`DataParallelTrainer.fit(policies=...)` (or any custom loop), keeping the
same named variables up to date via :mod:`kungfu_tpu_torch.variables`.
"""
from __future__ import annotations

from typing import Any, Dict, Optional, Sequence

from . import variables as V
from .utils import get_logger

log = get_logger("kungfu.policy")


class BasePolicy:
    """Override any subset; all no-ops by default (base_policy.py)."""

    def before_train(self) -> None: ...

    def after_train(self) -> None: ...

    def before_epoch(self) -> None: ...

    def after_epoch(self) -> None: ...

    def before_step(self) -> None: ...

    def after_step(self, metrics: Optional[Dict[str, Any]] = None) -> None: ...


class CompressionPolicy(BasePolicy):
    """Host-side gradient-compression switcher driven by the GNS monitor.

    The in-program variant (optimizers.noise_adaptive_compression) compiles
    both wire formats into one step; this policy is the host-side analog
    for trainers that pre-build one compiled step per CompressionConfig and
    swap between them like strategy swaps (Session.set_strategy): it reads
    the monitored noise scale after each step and calls `switch(config)`
    when the regime changes.

    Hysteresis: compress at noise_scale >= threshold, decompress only below
    threshold * hysteresis — a band that stops the policy from thrashing
    compiled-step caches when the EMA hovers at the boundary.

    Args:
      switch: callable(config) invoked on every regime change — typically
        rebinds the trainer's active compiled step.
      threshold: GNS at/above which the compressed wire turns on.
      compressed: the config to switch to (default int8).
      uncompressed: the config below the band (default none).
      metric: key to read from the after_step metrics dict.
      getter: alternative zero-arg callable returning the metric (e.g.
        lambda: float(get_noise_scale(state.opt_state))) when the train
        loop doesn't put it in metrics.
    """

    def __init__(self, switch, threshold: float, compressed=None,
                 uncompressed=None, hysteresis: float = 0.5,
                 metric: str = "noise_scale", getter=None):
        from . import compression as Comp

        self.switch = switch
        self.threshold = float(threshold)
        self.hysteresis = float(hysteresis)
        self.metric = metric
        self.getter = getter
        self.compressed = Comp.resolve(compressed if compressed is not None else "int8")
        self.uncompressed = Comp.resolve(uncompressed)
        self.active = self.uncompressed
        self.switches = 0

    def _read(self, metrics) -> Optional[float]:
        if metrics and self.metric in metrics:
            try:
                return float(metrics[self.metric])
            except (TypeError, ValueError):
                return None
        if self.getter is not None:
            return float(self.getter())
        return None

    def after_step(self, metrics: Optional[Dict[str, Any]] = None) -> None:
        ns = self._read(metrics)
        if ns is None:
            return
        target = self.active
        if ns >= self.threshold:
            target = self.compressed
        elif ns < self.threshold * self.hysteresis:
            target = self.uncompressed
        if target is not self.active:
            from .monitor.journal import journal_event

            journal_event(
                "compression_switch",
                old=self.active.scheme, new=target.scheme,
                noise_scale=round(ns, 4), switches=self.switches + 1,
            )
            self.active = target
            self.switches += 1
            self.switch(target)


class StragglerPolicy(BasePolicy):
    """Graded slow-rank response driven by the straggler observatory.

    The detector (monitor.straggler, ROADMAP A.8) only *observes*; this policy
    feeds its signal back into adaptation, graded so the cheap response runs
    first and nothing escalates on a blip:

      grade 0  suspicion: the fleet detector journals `straggler_suspected`
               and exposes gauges — no training impact, this policy just
               tracks `flagged_ranks` (readable via `any_flagged`, e.g. as
               `ReplanPolicy(straggler_fn=policy.any_flagged)`).
      grade 1  sustained straggler (`sustain` consecutive polls): call the
               `replan` callback with reason "straggler" — typically
               `lambda reason: planner.replan(reason)` so the plan compiler
               routes collectives around the hot link/rank.  Journaled as
               `straggler_response`, cooldown-guarded.
      grade 2  input starvation: call `on_starvation(ranks)` on the
               transition (grow loader threads, re-shard the input, page
               the operator) — starvation is a host problem no collective
               re-plan can fix.

    The healer holds the *last* rung: `kungfu-run -heal` now distinguishes
    slow-but-alive from hung (journal `worker_slow` vs `stall_kill`,
    docs/fault_tolerance.md), so a rank this policy is still reasoning
    about is not summarily killed.

    Args:
      report_fn: zero-arg callable returning a /stragglers report dict —
        e.g. ``lambda: monitor.straggler.fetch_report(url)`` against the
        fleet aggregator, or a local `StragglerMonitor.report` bound method.
      replan: callable(reason) for the grade-1 response (optional).
      on_starvation: callable(ranks) for the grade-2 response (optional).
      poll_every: steps between report polls (a fleet HTTP fetch is not a
        per-step cost).
      sustain: consecutive flagged polls before grade 1 fires.
      cooldown_steps: minimum steps between grade-1 responses.
    """

    def __init__(self, report_fn, replan=None, on_starvation=None,
                 poll_every: int = 10, sustain: int = 3,
                 cooldown_steps: int = 100):
        self.report_fn = report_fn
        self.replan = replan
        self.on_starvation = on_starvation
        self.poll_every = max(1, int(poll_every))
        self.sustain = int(sustain)
        self.cooldown_steps = int(cooldown_steps)
        self.flagged_ranks: set = set()
        self.starved_ranks: set = set()
        self.responses = 0
        self._sustained: Dict[int, int] = {}
        self._since_response = self.cooldown_steps
        self._step = 0

    def any_flagged(self) -> bool:
        """Truthy when any rank is currently suspected — the ready-made
        `straggler_fn` for the planner's `ReplanPolicy` (ROADMAP A.8)."""
        return bool(self.flagged_ranks)

    def after_step(self, metrics: Optional[Dict[str, Any]] = None) -> None:
        self._step += 1
        self._since_response += 1
        if self._step % self.poll_every:
            return
        try:
            report = self.report_fn()
        except OSError as e:
            # an unreachable aggregator must not degrade training; anything
            # non-IO propagates so PolicyRunner journals a policy_error
            log.warning("straggler report fetch failed: %s", e)
            return
        if not isinstance(report, dict):
            return
        suspected = {int(r) for r in report.get("suspected") or ()}
        self.flagged_ranks = suspected
        for r in list(self._sustained):
            if r not in suspected:
                del self._sustained[r]
        for r in suspected:
            self._sustained[r] = self._sustained.get(r, 0) + 1
        sustained = sorted(r for r, c in self._sustained.items()
                           if c >= self.sustain)
        if (sustained and self.replan is not None
                and self._since_response >= self.cooldown_steps):
            self._since_response = 0
            self.responses += 1
            from .monitor.journal import journal_event

            journal_event("straggler_response", grade="replan",
                          ranks=sustained, step=self._step)
            log.warning("straggler response #%d: replan around rank(s) %s",
                        self.responses, sustained)
            self.replan("straggler")
        starved = {int(r) for r in report.get("input_starved") or ()}
        if starved - self.starved_ranks and self.on_starvation is not None:
            self.on_starvation(sorted(starved))
        self.starved_ranks = starved


class PolicyRunner:
    """Drives policies and the named progress variables (policy_hook.py:8-80).

    steps_per_epoch > 0 turns step boundaries into epoch callbacks, the way
    the reference derives epochs from trained-sample counts.

    A raising policy must never kill the train loop, but it must not vanish
    either: every hook runs through `_call`, which journals a
    `policy_error` event (hook kind, policy class, step, error) and
    continues with the remaining policies — so a crashing `ReplanPolicy`
    is visible in the fleet journal instead of silently disabling itself.
    """

    def __init__(self, policies: Sequence[BasePolicy], batch_size: int = 0,
                 steps_per_epoch: int = 0):
        self.policies = list(policies)
        self.batch_size = batch_size
        self.steps_per_epoch = steps_per_epoch
        self._step_in_epoch = 0
        self._in_epoch = False
        self.step = 0
        self.policy_errors = 0
        # batch_size=0 = unknown yet (fit discovers it from the first batch);
        # never clobber a user-set kungfu_batch_size with 0
        if batch_size:
            V.set_variable(V.BATCH_SIZE, batch_size)
        V.set_variable(V.TRAINED_SAMPLES, V.get_variable(V.TRAINED_SAMPLES, 0.0))

    def _call(self, kind: str, p: BasePolicy, fn, *args) -> None:
        try:
            fn(*args)
        except Exception as e:
            self.policy_errors += 1
            log.warning("policy %s.%s raised at step %d: %s",
                        type(p).__name__, kind, self.step, e)
            from .monitor.journal import journal_event

            journal_event(
                "policy_error", kind=kind, policy=type(p).__name__,
                step=self.step, error=f"{type(e).__name__}: {e}",
            )

    def begin(self) -> None:
        for p in self.policies:
            self._call("before_train", p, p.before_train)

    def before_step(self) -> None:
        if self.steps_per_epoch and not self._in_epoch:
            self._in_epoch = True
            self._step_in_epoch = 0
            for p in self.policies:
                self._call("before_epoch", p, p.before_epoch)
        for p in self.policies:
            self._call("before_step", p, p.before_step)

    def after_step(self, samples: int,
                   metrics: Optional[Dict[str, Any]] = None) -> None:
        if not self.batch_size and samples:
            self.batch_size = samples
            V.set_variable(V.BATCH_SIZE, samples)
        V.global_variables().add(V.TRAINED_SAMPLES, samples)
        self.step += 1
        for p in self.policies:
            self._call("after_step", p, p.after_step, metrics)
        if self.steps_per_epoch:
            self._step_in_epoch += 1
            if self._step_in_epoch >= self.steps_per_epoch:
                self._in_epoch = False
                for p in self.policies:
                    self._call("after_epoch", p, p.after_epoch)

    def end(self) -> None:
        if self.steps_per_epoch and self._in_epoch:
            self._in_epoch = False
            for p in self.policies:
                self._call("after_epoch", p, p.after_epoch)
        for p in self.policies:
            self._call("after_train", p, p.after_train)
