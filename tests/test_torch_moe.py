"""Mixture of experts: the port's MoEMLP (dispatch by index) against the
JAX package's (the dense one-hot einsum), and MoE models under
MeshTrainer on dp x ep and dp meshes against the JAX MeshTrainer.

One process: `MoEMLP` on the same weights and input (f32, 2 x 24
tokens of width 16, 4 experts, d_ff 32) at capacity factors 1.25 and 0.5
(the latter drops tokens; so does the former on these inputs, fewer):
the output, the load-balancing loss and the dropped share, and the
gradients of sum(out * c) + 0.3 aux with respect to the input and every
parameter, to 1e-5 absolute (readings up to 1e-7).

Meshes (as in tests/test_torch_tp.py: numpy weights from a seed, 3 SGD
steps in f32 on 4 ranks, `lm_loss_with_aux` against the port's
`lm_loss_shard_with_aux`; losses, first-step gradients and the parameters
after the last step to 1e-5; every rank's gathered parameters the same
bits): dp=2 x ep=2 with 4 experts (2 a rank) and dp=4 with 2 experts, each
at a capacity factor that drops tokens, so that each rank's positions must
start after the tokens of the data-parallel ranks before it.  A rank
that counts its positions from 0 drops other tokens, which moves the
first loss by 1e-4 to 1e-3 here.
"""
from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_mesh_runs import (assert_tree_close, by_prefix, jax_run, numpy_weights,
                              port_results, replicas_identical, start_port)
from _torch_reference import jax_reference
from kungfu_tpu_torch import convert
from kungfu_tpu_torch.models import transformer as tt
from kungfu_tpu_torch.parallel.moe import MoEMLP

TOL = 1e-5
SMALL = dict(vocab_size=64, d_model=16, n_layers=2, n_heads=2, d_ff=32, max_len=24,
             n_experts=4)
COMMON = dict(vocab_size=96, d_model=32, n_layers=2, n_heads=4, d_ff=64, max_len=32)
RUNS = {
    "dp2-ep2-drop": (dict(dp=2, ep=2), dict(n_experts=4, capacity_factor=0.5)),
    "dp4-drop": (dict(dp=4), dict(n_experts=2, moe_every=1, capacity_factor=0.6)),
}
LR, STEPS = 0.1, 3


def _module_case(cf):
    rng = np.random.default_rng(5)
    E, D, F = SMALL["n_experts"], SMALL["d_model"], SMALL["d_ff"]
    params = {"router": 0.3 * rng.standard_normal((D, E)),
              "w_in": 0.2 * rng.standard_normal((E, D, F)),
              "w_out": 0.2 * rng.standard_normal((E, F, D))}
    params = {k: v.astype(np.float32) for k, v in params.items()}
    x = rng.standard_normal((2, SMALL["max_len"], D)).astype(np.float32)
    cot = rng.standard_normal(x.shape).astype(np.float32)
    return params, x, cot


@pytest.fixture(scope="module", params=[1.25, 0.5], ids=["cf1.25", "cf0.5"])
def module_pair(request):
    """(JAX (out, aux, dropped, grads), port's) for MoEMLP at one capacity factor."""
    cf = request.param
    params, x, cot = _module_case(cf)
    with jax_reference():
        from kungfu_tpu.models import transformer as jt
        from kungfu_tpu.parallel.moe import MoEMLP as JMoE

        mod = JMoE(jt.TransformerConfig(dtype=jnp.float32, capacity_factor=cf, **SMALL))

        def run(p, xx):
            out, st = mod.apply({"params": p}, xx, mutable=["intermediates"])
            sown = st["intermediates"]
            return out, sown["moe_aux_loss"][0], sown["moe_dropped"][0]

        def objective(p, xx):
            out, aux, _ = run(p, xx)
            return jnp.sum(out * cot) + 0.3 * aux

        out, aux, dropped = run(params, jnp.asarray(x))
        gp, gx = jax.grad(objective, argnums=(0, 1))(params, jnp.asarray(x))
        want = (np.asarray(out), float(aux), float(dropped),
                {**{k: np.asarray(v) for k, v in gp.items()}, "x": np.asarray(gx)})
    cfg = tt.TransformerConfig(dtype=torch.float32, capacity_factor=cf, **SMALL)
    port = MoEMLP(cfg, torch.device("cpu"))
    port.load_state_dict({k: torch.from_numpy(v) for k, v in params.items()})
    tx = torch.from_numpy(x).requires_grad_()
    tout = port(tx)
    ((tout * torch.from_numpy(cot)).sum() + 0.3 * port.aux_loss).backward()
    got = (tout.detach().numpy(), port.aux_loss.item(), port.dropped.item(),
           {**{k: p.grad.numpy() for k, p in port.named_parameters()}, "x": tx.grad.numpy()})
    return want, got


def test_moe_output_matches_jax(module_pair):
    want, got = module_pair
    np.testing.assert_allclose(got[0], want[0], rtol=0, atol=TOL)
    np.testing.assert_allclose(got[1], want[1], rtol=0, atol=TOL)
    np.testing.assert_allclose(got[2], want[2], rtol=0, atol=1e-7)
    assert got[2] > 0  # tokens were dropped


def test_moe_gradients_match_jax(module_pair):
    want, got = module_pair
    for k, g in want[3].items():
        np.testing.assert_allclose(got[3][k], g, rtol=0, atol=TOL, err_msg=k)


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("moe")
    tokens = np.random.default_rng(31).integers(0, COMMON["vocab_size"],
                                                (4, COMMON["max_len"])).astype(np.int32)
    out = {}
    with jax_reference():
        from kungfu_tpu.models import transformer as jt
        from kungfu_tpu.plan import make_mesh

        started = {}
        for seed, (name, (sizes, kw)) in enumerate(RUNS.items()):
            mesh = make_mesh(devices=jax.devices()[:4], **sizes)
            model = jt.TransformerLM(jt.TransformerConfig(dtype=jnp.float32, mesh=mesh,
                                                          **COMMON, **kw))
            params = numpy_weights(model, jnp.asarray(tokens), seed)
            tcfg = tt.TransformerConfig(dtype=torch.float32, **COMMON, **kw)
            whole = {k: v.numpy() for k, v in convert.params_from_flax(params, tcfg).items()}
            started[name] = (model, mesh, params,
                             start_port(tmp, name, whole, tokens, sizes, {**COMMON, **kw}, STEPS,
                                        LR, impl="pallas_ring"))
        for name, (model, mesh, params, procs) in started.items():
            ref = jax_run(model, jt.lm_loss_with_aux, mesh, params, jnp.asarray(tokens), STEPS,
                          LR)
            out[name] = (ref, port_results(tmp, name, procs))
    return out


def _port_tree(res, prefix, name):
    cfg = tt.TransformerConfig(dtype=torch.float32, **COMMON, **RUNS[name][1])
    return convert.params_to_flax({k: torch.from_numpy(v) for k, v in
                                   by_prefix(res, prefix).items()}, cfg)


@pytest.mark.parametrize("name", list(RUNS))
def test_mesh_losses_match_jax(runs, name):
    (losses, _, _), ranks = runs[name]
    np.testing.assert_allclose(ranks[0]["losses"], losses, rtol=0, atol=TOL)
    assert losses[-1] < losses[0]
    assert (ranks[0]["dropped"] > 0).all()  # every MoE layer dropped tokens at every step


@pytest.mark.parametrize("name", list(RUNS))
def test_mesh_first_step_gradients_match_jax(runs, name):
    (_, grads, _), ranks = runs[name]
    assert_tree_close(_port_tree(ranks[0], "grad", name), grads, TOL, "gradient")


@pytest.mark.parametrize("name", list(RUNS))
def test_mesh_parameters_after_three_steps_match_jax(runs, name):
    (_, _, params), ranks = runs[name]
    assert_tree_close(_port_tree(ranks[0], "param", name), params, TOL, "parameter")


@pytest.mark.parametrize("name", list(RUNS))
def test_mesh_every_rank_holds_the_same_model(runs, name):
    replicas_identical(runs[name][1])


def test_moe_blocks_and_shapes():
    """Every moe_every-th block is a MoE block, its experts split over ep."""
    from kungfu_tpu_torch.plan import mesh as pm

    shape = {"dp": 2, "ep": 2}
    mesh = pm.Mesh(shape, 3, dict.fromkeys(shape))
    cfg = tt.TransformerConfig(dtype=torch.float32, mesh=mesh, n_experts=4, **{
        **COMMON, "n_layers": 4})
    model = tt.TransformerLM(cfg, device="cpu")
    assert [hasattr(b, "moe") for b in model.blocks()] == [False, True, False, True]
    moe = model.block_1.moe
    assert tuple(moe.router.shape) == (32, 2) and tuple(moe.w_in.shape) == (2, 32, 64)
    with pytest.raises(ValueError, match="ep=2 must divide n_experts=3"):
        tt.TransformerConfig(mesh=mesh, n_experts=3, **COMMON)
