"""The port's policies, named variables and `fit` against the JAX package's.

One script (`_scenario`) drives each package's PolicyRunner (lifecycle,
epochs, a raising policy, the batch-size variable), CompressionPolicy
(its hysteresis band) and StragglerPolicy (grades, sustain, cooldown,
starvation, an unreachable report), and the recorded calls, the named
variables and the journal records (less their clocks) must be equal.
Then the cases of tests/unit/test_policy_variables.py (PolicyRunner,
Variables, fit integration) on the port, `fit` against the JAX trainer's
on one device, and `publish_monitor_state`.
"""
from __future__ import annotations

import types

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from _torch_reference import jax_reference
from kungfu_tpu_torch import policy as tpolicy
from kungfu_tpu_torch import variables as V
from kungfu_tpu_torch.monitor import journal as tjournal


@pytest.fixture(scope="module")
def ref():
    with jax_reference():
        import optax

        from kungfu_tpu import policy, variables
        from kungfu_tpu.monitor import journal
        from kungfu_tpu.optimizers import synchronous_sgd
        from kungfu_tpu.train import DataParallelTrainer

        yield types.SimpleNamespace(policy=policy, variables=variables, journal=journal,
                                    optax=optax, synchronous_sgd=synchronous_sgd,
                                    DataParallelTrainer=DataParallelTrainer)


@pytest.fixture(autouse=True)
def fresh_registry():
    V.global_variables().reset()
    yield
    V.global_variables().reset()


PORT = types.SimpleNamespace(policy=tpolicy, variables=V, journal=tjournal)


def _scenario(pkg, path, monkeypatch):
    """Every policy path, on one package; returns (calls, variables,
    journal records without their clocks)."""
    P, Vs, J = pkg.policy, pkg.variables, pkg.journal
    Vs.global_variables().reset()
    monkeypatch.setenv("KFT_JOURNAL_FILE", str(path))
    monkeypatch.setenv("KFT_JOURNAL_STRICT", "1")  # every record passes the registry
    J._reset_for_tests()
    monkeypatch.setattr(J, "_context", dict(J._context))  # the stamps, restored after
    J.set_journal_context(rank=3, cluster_version=7)
    calls = []

    class Recorder(P.BasePolicy):
        def __init__(self, tag):
            self.tag = tag

        def before_train(self):
            calls.append((self.tag, "bt"))

        def after_train(self):
            calls.append((self.tag, "at"))

        def before_epoch(self):
            calls.append((self.tag, "be"))

        def after_epoch(self):
            calls.append((self.tag, "ae"))

        def before_step(self):
            calls.append((self.tag, "bs"))

        def after_step(self, metrics=None):
            calls.append((self.tag, "as", dict(metrics or {})))

    class Raising(P.BasePolicy):
        def after_step(self, metrics=None):
            raise RuntimeError("boom")

    # the lifecycle over epochs, a policy raising in every after_step
    runner = P.PolicyRunner([Recorder("r"), Raising()], batch_size=8, steps_per_epoch=2)
    runner.begin()
    for i in range(5):
        runner.before_step()
        runner.after_step(8, {"loss": float(i)})
    runner.end()
    calls.append(("errors", runner.policy_errors))
    # a user-set batch size stays until data says otherwise
    Vs.set_variable(Vs.BATCH_SIZE, 256)
    runner = P.PolicyRunner([], batch_size=0)
    calls.append(("batch", Vs.get_variable(Vs.BATCH_SIZE)))
    runner.before_step()
    runner.after_step(64)
    calls.append(("batch", Vs.get_variable(Vs.BATCH_SIZE)))

    # compression: on at >= 1.0, off only below 0.5
    switched = []
    comp = P.CompressionPolicy(lambda cfg: switched.append(cfg.scheme), threshold=1.0)
    for ns in (0.5, 1.0, 0.7, 0.49, 3.0, None, 0.6, 0.2, 0.2):
        comp.after_step(None if ns is None else {"noise_scale": ns})
    box = [4.0]
    by_getter = P.CompressionPolicy(lambda cfg: switched.append("getter:" + cfg.scheme),
                                    threshold=2.0, compressed="fp8", getter=lambda: box[0])
    by_getter.after_step(None)
    box[0] = 0.1
    by_getter.after_step({"other": 1.0})
    calls.append(("compression", switched, comp.switches, comp.active.scheme,
                  by_getter.switches))

    # stragglers: polls every 2 steps; replan after 2 flagged polls, then
    # not again within the cooldown of 5 steps; starvation on its onset
    reports = iter([
        {"suspected": [2]}, {"suspected": [2, 1]}, OSError("down"),
        {"suspected": [2], "input_starved": [0]}, {"suspected": [2], "input_starved": [0]},
        {"suspected": [], "input_starved": [0, 3]}, "not a dict", {"suspected": [1]},
        {"suspected": [1]}, {"suspected": [1]},
    ])

    def report():
        r = next(reports)
        if isinstance(r, Exception):
            raise r
        return r

    strag = P.StragglerPolicy(report, replan=lambda why: calls.append(("replan", why)),
                              on_starvation=lambda ranks: calls.append(("starved", ranks)),
                              poll_every=2, sustain=2, cooldown_steps=5)
    for step in range(20):
        strag.after_step(None)
        calls.append(("flagged", step, sorted(strag.flagged_ranks), strag.any_flagged()))
    calls.append(("responses", strag.responses))
    variables = Vs.global_variables().snapshot()
    records = J.read_journal(str(path))
    J._reset_for_tests()
    for r in records:
        assert r.pop("t_wall") > 0 and r.pop("t_job") is not None
    return calls, variables, records


def test_policies_match_jax(ref, tmp_path, monkeypatch):
    got = _scenario(PORT, tmp_path / "port.jsonl", monkeypatch)
    want = _scenario(ref, tmp_path / "jax.jsonl", monkeypatch)
    assert got[0] == want[0]
    assert got[1] == want[1]
    assert got[2] == want[2]
    kinds = [r["event"] for r in got[2]]
    assert kinds.count("policy_error") == 5 and "compression_switch" in kinds
    assert "straggler_response" in kinds
    assert all(r["rank"] == 3 and r["cluster_version"] == 7 for r in got[2])
    assert got[1][V.TRAINED_SAMPLES] == 5 * 8 + 64


# -- tests/unit/test_policy_variables.py on the port -----------------------

class Recorder(tpolicy.BasePolicy):
    def __init__(self):
        self.events = []

    def before_train(self):
        self.events.append("bt")

    def after_train(self):
        self.events.append("at")

    def before_epoch(self):
        self.events.append("be")

    def after_epoch(self):
        self.events.append("ae")

    def before_step(self):
        self.events.append("bs")

    def after_step(self, metrics=None):
        self.events.append("as")


def test_lifecycle_with_epochs():
    p = Recorder()
    r = tpolicy.PolicyRunner([p], batch_size=8, steps_per_epoch=2)
    r.begin()
    for _ in range(4):
        r.before_step()
        r.after_step(8)
    r.end()
    assert p.events == ["bt", "be", "bs", "as", "bs", "as", "ae",
                        "be", "bs", "as", "bs", "as", "ae", "at"]
    assert V.get_variable(V.TRAINED_SAMPLES) == 32
    assert V.get_variable(V.BATCH_SIZE) == 8


def test_partial_epoch_closed_at_end():
    p = Recorder()
    r = tpolicy.PolicyRunner([p], batch_size=4, steps_per_epoch=10)
    r.begin()
    r.before_step()
    r.after_step(4)
    r.end()
    assert p.events == ["bt", "be", "bs", "as", "ae", "at"]


def test_variables_set_get_add_and_listeners():
    seen = []
    V.global_variables().subscribe(lambda n, v: seen.append((n, v)))
    V.set_variable("x", 2.0)
    assert V.get_variable("x") == 2.0
    assert V.global_variables().add("x", 0.5) == 2.5
    assert V.get_variable("missing", -1) == -1
    assert seen == [("x", 2.0), ("x", 2.5)]
    assert V.global_variables().snapshot() == {"x": 2.5}


def test_runner_does_not_clobber_user_batch_size():
    V.set_variable(V.BATCH_SIZE, 256)
    r = tpolicy.PolicyRunner([], batch_size=0)
    assert V.get_variable(V.BATCH_SIZE) == 256
    r.before_step()
    r.after_step(64)
    assert V.get_variable(V.BATCH_SIZE) == 64  # discovered from data


def test_fit_integration_matches_jax(ref):
    """fit(steps=3, policies=[Recorder]) with synchronous_sgd(sgd(0.1)) on
    one device, the JAX trainer on a one-device mesh: the same calls, the
    trained samples 3 x 2 x world, the parameters to 1e-6."""
    from jax.sharding import Mesh

    from kungfu_tpu_torch.optimizers import synchronous_sgd
    from kungfu_tpu_torch.train import DataParallelTrainer

    def gen(world):
        rng = np.random.RandomState(0)
        while True:
            yield (rng.randn(2 * world, 4).astype(np.float32),)

    def jax_loss(params, batch):
        x, = batch
        return jnp.mean((params["w"] - x.mean()) ** 2)

    jtrainer = ref.DataParallelTrainer(jax_loss, ref.synchronous_sgd(ref.optax.sgd(0.1)),
                                       mesh=Mesh(np.array(jax.devices()[:1]), ("dp",)))
    jstate = jtrainer.init({"w": jnp.zeros((4,))})
    jp = ref.policy.BasePolicy()
    ref.variables.global_variables().reset()
    jstate, _ = jtrainer.fit(jstate, gen(jtrainer.world), steps=3, policies=[jp])
    jsamples = ref.variables.get_variable(ref.variables.TRAINED_SAMPLES)

    class Model(torch.nn.Module):
        def __init__(self):
            super().__init__()
            self.w = torch.nn.Parameter(torch.zeros(4))

    def loss_fn(model, batch):
        x, = batch
        return torch.mean((model.w - x.mean()) ** 2)

    trainer = DataParallelTrainer(loss_fn, synchronous_sgd(lambda ps: torch.optim.SGD(ps, lr=0.1)),
                                  device="cpu")
    state = trainer.init(Model())
    p = Recorder()
    data = ((torch.from_numpy(x),) for (x,) in gen(trainer.world))
    state, metrics = trainer.fit(state, data, steps=3, policies=[p])
    assert p.events.count("bs") == 3 and p.events.count("as") == 3
    assert V.get_variable(V.TRAINED_SAMPLES) == 3 * 2 * trainer.world == jsamples
    assert state.step == 3 and metrics["samples_per_sec"] > 0
    np.testing.assert_allclose(state.params.w.detach().numpy(), np.asarray(jstate.params["w"]),
                               rtol=1e-6)


def test_publish_monitor_state():
    """The monitors' metrics reach the registry under the standard names;
    a chain without a monitor publishes nothing."""
    from kungfu_tpu_torch.optimizers import gradient_noise_scale, gradient_variance

    w = torch.nn.Parameter(torch.zeros(8))
    opt = gradient_noise_scale(gradient_variance(lambda ps: torch.optim.SGD(ps, lr=0.1)),
                               local_batch_size=4)([w])
    w.grad = torch.arange(8.0)
    opt.step()
    assert V.publish_monitor_state(opt) == {V.GRADIENT_NOISE_SCALE: 0.0,
                                            V.GRADIENT_VARIANCE: 0.0}  # one rank
    assert V.get_variable(V.GRADIENT_VARIANCE) == 0.0
    assert V.publish_monitor_state(torch.optim.SGD([w], lr=0.1)) == {}
    assert set(V.STANDARD_NAMES) >= {V.GRADIENT_NOISE_SCALE, V.GRADIENT_VARIANCE}
