"""Pipeline parallelism: the port's schedule and PipelinedLM against the
JAX package's.

  schedule     `pipeline_apply_grouped` on a toy stage function
               (tanh(h W + b), width 8, microbatches of 2 rows) on gloo
               ranks against the JAX `pipeline_apply_grouped` on virtual
               CPU devices, for GPipe at pp=4 (M=4), circular at pp=4 R=2
               (M=4, the layer groups checkpointed) and circular at pp=2
               R=3 (M=5 > S): the outputs on every stage, and the
               gradients of sum(out * c) with respect to the input (on
               every stage: it is fed at stage 0 only) and each stage's
               parameters, to 1e-5 absolute (readings up to 1e-7)
  logits       `PipelinedLM` at pp=4 R=2 M=4 (8 layers, RoPE, GQA 4/2) on
               the JAX `TransformerLM`'s weights (`convert.stack_pipeline`,
               then each stage's groups) against that model's logits, to
               1e-4, as tests/unit/test_pp_transformer.py holds the JAX
               `PipelinedLM`
  MeshTrainer  dp=2 x pp=2, R=2, M=2, 4 layers, against the JAX
               MeshTrainer (as tests/test_torch_tp.py: numpy weights from
               a seed, 3 SGD steps in f32; losses, every first-step
               gradient, the embedding's included, and the parameters
               after the last step to 1e-5; every rank's gathered
               parameters the same bits).  The JAX `PipelinedLM`'s
               backward does not trace under the installed jax 0.9 (the
               transpose of its `lax.pcast` inside a shard_map with
               check_vma=False asks for a psum over pp of a value that
               carries no pp), so the JAX MeshTrainer trains the JAX
               `TransformerLM` on dp=2, the function `PipelinedLM`
               computes (tests/unit/test_pp_transformer.py), its trees
               restacked by `convert.stack_pipeline`; the port's first
               loss is also held to the JAX `PipelinedLM`'s forward on
               the stacked weights

An input whose gradient is not summed over pp leaves the embedding's
gradient on stage 0 alone (zero on the other stage, whose embedding then
falls behind); a head gradient summed over pp doubles it.
"""
from __future__ import annotations

import textwrap

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_mesh_runs import (assert_tree_close, by_prefix, jax_run, numpy_weights,
                              port_results, replicas_identical, start_port)
from _torch_ranks import start_ranks, wait_ranks
from _torch_reference import jax_reference
from kungfu_tpu_torch import convert
from kungfu_tpu_torch.models import transformer as tt
from kungfu_tpu_torch.parallel import PipelinedLM
from kungfu_tpu_torch.plan import mesh as pm

TOL = 1e-5
WIDTH, MB = 8, 2
# name -> (stages, repeats, microbatches, remat)
SCHEDULES = {"gpipe-pp4": (4, 1, 4, False), "circ-pp4-r2": (4, 2, 4, True),
             "circ-pp2-r3": (2, 3, 5, False)}
LM = dict(vocab_size=64, d_model=32, n_layers=8, n_heads=4, d_ff=64, max_len=32, rope=True,
          n_kv_heads=2)
LM_PIPE = (2, 4)  # repeats, microbatches at pp=4
MESH_LM = dict(vocab_size=64, d_model=32, n_layers=4, n_heads=4, d_ff=64, max_len=32)
MESH_PIPE = (2, 2)
LR, STEPS = 0.1, 3


def _schedule_case(S, R, M):
    rng = np.random.default_rng(S * 100 + R * 10 + M)
    return {"w": (rng.standard_normal((S, R, WIDTH, WIDTH)) / np.sqrt(WIDTH)).astype(np.float32),
            "b": (0.1 * rng.standard_normal((S, R, WIDTH))).astype(np.float32),
            "x": rng.standard_normal((M, MB, WIDTH)).astype(np.float32),
            "c": rng.standard_normal((M, MB, WIDTH)).astype(np.float32)}


WORKER = textwrap.dedent("""
    import sys
    import numpy as np
    import torch
    import torch.distributed as dist
    from kungfu_tpu_torch import convert, distributed
    from kungfu_tpu_torch.models import transformer as tt
    from kungfu_tpu_torch.parallel import PipelinedLM, pipeline_apply, pipeline_apply_grouped
    from kungfu_tpu_torch.plan import make_mesh

    path, cases, lm, pipe = sys.argv[1], *map(eval, sys.argv[2:])
    distributed.init_distributed(device="cpu")
    rank = dist.get_rank()
    mesh = make_mesh(pp=dist.get_world_size())
    out = {}
    for name, (S, R, M, remat) in cases.items():
        data = np.load(f"{path}.{name}.npz")
        p = {k: torch.from_numpy(data[k]).requires_grad_() for k in ("w", "b")}
        x = torch.from_numpy(data["x"]).requires_grad_()
        y = pipeline_apply_grouped(lambda q, h: torch.tanh(h @ q["w"] + q["b"]), p, x, mesh,
                                   repeats=R, remat=remat)
        (y * torch.from_numpy(data["c"])).sum().backward()
        out.update({f"{name}/out": y.detach().numpy(), f"{name}/x": x.grad.numpy(),
                    f"{name}/w": p["w"].grad[rank].numpy(), f"{name}/b": p["b"].grad[rank].numpy()})
        if R == 1:  # GPipe through pipeline_apply: the stage stacks [S, ...]
            with torch.no_grad():
                y1 = pipeline_apply(lambda q, h: torch.tanh(h @ q["w"] + q["b"]),
                                    {k: v[:, 0] for k, v in p.items()}, x, mesh)
            out[f"{name}/apply"] = y1.numpy()
    if lm is not None:
        data = np.load(f"{path}.lm.npz")
        whole = {k: torch.from_numpy(data[k]) for k in data.files if k != "tokens"}
        cfg = tt.TransformerConfig(dtype=torch.float32, mesh=mesh, **lm)
        model = PipelinedLM(cfg, repeats=pipe[0], microbatches=pipe[1], device="cpu")
        model.load_state_dict(convert.shard_state_dict(
            convert.stack_pipeline(whole, mesh.shape["pp"], pipe[0]), mesh))
        with torch.no_grad():
            out["lm/logits"] = model(torch.from_numpy(data["tokens"]).long()).numpy()
    np.savez(f"{path}.w{dist.get_world_size()}.{rank}.npz", **out)
    distributed.shutdown_distributed()
""")


@pytest.fixture(scope="module")
def schedules(tmp_path_factory):
    """{name: (JAX (out, grads), the port's per-rank npz)}, and the
    PipelinedLM logits: (JAX TransformerLM's, the port's per rank)."""
    tmp = tmp_path_factory.mktemp("pp")
    tokens = np.random.default_rng(41).integers(0, LM["vocab_size"],
                                                (8, LM["max_len"])).astype(np.int32)
    by_world = {}
    for name, case in SCHEDULES.items():
        np.savez(tmp / f"s.{name}.npz", **_schedule_case(*case[:3]))
        by_world.setdefault(case[0], {})[name] = case
    with jax_reference():
        from kungfu_tpu.models import transformer as jt
        from kungfu_tpu.parallel.pp import pipeline_apply_grouped
        from kungfu_tpu.plan import make_mesh

        jmodel = jt.TransformerLM(jt.TransformerConfig(dtype=jnp.float32, **LM))
        params = numpy_weights(jmodel, jnp.asarray(tokens), 7)
        tcfg = tt.TransformerConfig(dtype=torch.float32, **LM)
        np.savez(tmp / "s.lm.npz", tokens=tokens,
                 **{k: v.numpy() for k, v in convert.params_from_flax(params, tcfg).items()})
        procs = {S: start_ranks(WORKER, S, [tmp / "s", repr(cases),
                                            repr(LM if S == 4 else None), repr(LM_PIPE)])
                 for S, cases in by_world.items()}
        want = {}
        for name, (S, R, M, remat) in SCHEDULES.items():
            case = _schedule_case(S, R, M)
            mesh = make_mesh(devices=jax.devices()[:S], pp=S)

            def objective(p, x):
                y = pipeline_apply_grouped(lambda q, h: jnp.tanh(h @ q["w"] + q["b"]), p, x,
                                           mesh, repeats=R, remat=remat)
                return jnp.sum(y * case["c"]), y

            (_, y), (gp, gx) = jax.value_and_grad(objective, argnums=(0, 1), has_aux=True)(
                {"w": case["w"], "b": case["b"]}, case["x"])
            want[name] = {"out": np.asarray(y), "x": np.asarray(gx), "w": np.asarray(gp["w"]),
                          "b": np.asarray(gp["b"])}
        logits = np.asarray(jmodel.apply({"params": params}, jnp.asarray(tokens)))
    got = {}
    for S, ps in procs.items():
        wait_ranks(ps, timeout=300)
        got[S] = [np.load(tmp / f"s.w{S}.{r}.npz") for r in range(S)]
    return want, got, logits


@pytest.mark.parametrize("name", list(SCHEDULES))
def test_schedule_outputs_match_jax(schedules, name):
    want, got, _ = schedules
    for res in got[SCHEDULES[name][0]]:
        np.testing.assert_allclose(res[f"{name}/out"], want[name]["out"], rtol=0, atol=TOL)


def test_pipeline_apply_is_gpipe(schedules):
    _, got, _ = schedules
    for res in got[4]:
        np.testing.assert_array_equal(res["gpipe-pp4/apply"], res["gpipe-pp4/out"])


def test_stack_group_params():
    from kungfu_tpu_torch.parallel import stack_group_params, stack_stage_params

    groups = [[{"w": torch.full((2,), 10.0 * s + r)} for r in range(3)] for s in range(2)]
    stacked = stack_group_params(groups)
    assert tuple(stacked["w"].shape) == (2, 3, 2)
    assert stacked["w"][1, 2, 0].item() == 12.0
    assert tuple(stack_stage_params([g[0] for g in groups])["w"].shape) == (2, 2)


@pytest.mark.parametrize("name", list(SCHEDULES))
def test_schedule_gradients_match_jax(schedules, name):
    want, got, _ = schedules
    for stage, res in enumerate(got[SCHEDULES[name][0]]):
        np.testing.assert_allclose(res[f"{name}/x"], want[name]["x"], rtol=0, atol=TOL)
        for k in ("w", "b"):
            np.testing.assert_allclose(res[f"{name}/{k}"], want[name][k][stage], rtol=0, atol=TOL,
                                       err_msg=f"stage {stage} {k}")


def test_pipelined_lm_logits_match_transformer_lm(schedules):
    _, got, logits = schedules
    for res in got[4]:
        np.testing.assert_allclose(res["lm/logits"], logits, rtol=0, atol=1e-4)


@pytest.fixture(scope="module")
def mesh_run(tmp_path_factory):
    """(JAX (losses, grads, params) as stacked trees, the JAX PipelinedLM's
    first loss, the port's per-rank npz)."""
    tmp = tmp_path_factory.mktemp("pp_mesh")
    tokens = np.random.default_rng(43).integers(0, MESH_LM["vocab_size"],
                                                (4, MESH_LM["max_len"])).astype(np.int32)
    sizes = dict(dp=2, pp=2)
    S, R = sizes["pp"], MESH_PIPE[0]
    tcfg = tt.TransformerConfig(dtype=torch.float32, **MESH_LM)

    def stacked(tree):
        whole = convert.stack_pipeline(convert.params_from_flax(tree, tcfg), S, R)
        return convert.params_to_flax(whole, tcfg)

    with jax_reference():
        from kungfu_tpu.models import transformer as jt
        from kungfu_tpu.parallel.pp_transformer import PipelinedLM as JPipelinedLM
        from kungfu_tpu.plan import make_mesh

        dp_mesh = make_mesh(devices=jax.devices()[:2], dp=2)
        model = jt.TransformerLM(jt.TransformerConfig(dtype=jnp.float32, mesh=dp_mesh,
                                                      **MESH_LM))
        params = numpy_weights(model, jnp.asarray(tokens), 3)
        whole = convert.stack_pipeline(convert.params_from_flax(params, tcfg), S, R)
        procs = start_port(tmp, "dp2-pp2", {k: v.numpy() for k, v in whole.items()}, tokens,
                           sizes, MESH_LM, STEPS, LR, pipeline=list(MESH_PIPE),
                           impl="pallas_ring")
        pp_mesh = make_mesh(devices=jax.devices()[:4], **sizes)
        pipelined = JPipelinedLM(jt.TransformerConfig(dtype=jnp.float32, mesh=pp_mesh,
                                                      **MESH_LM), repeats=R,
                                 microbatches=MESH_PIPE[1])
        first = float(jt.lm_loss(pipelined.apply({"params": stacked(params)},
                                                 jnp.asarray(tokens)), jnp.asarray(tokens)))
        losses, grads, final = jax_run(model, lambda m, p, t: jt.lm_loss(
            m.apply({"params": p}, t), t), dp_mesh, params, jnp.asarray(tokens), STEPS, LR)
    return (losses, stacked(grads), stacked(final)), first, port_results(tmp, "dp2-pp2", procs)


def _port_tree(res, prefix):
    cfg = tt.TransformerConfig(dtype=torch.float32, **MESH_LM)
    return convert.params_to_flax({k: torch.from_numpy(v) for k, v in
                                   by_prefix(res, prefix).items()}, cfg)


def test_mesh_trainer_losses_match_jax(mesh_run):
    (losses, _, _), first, ranks = mesh_run
    np.testing.assert_allclose(ranks[0]["losses"], losses, rtol=0, atol=TOL)
    np.testing.assert_allclose(ranks[0]["losses"][0], first, rtol=0, atol=TOL)
    assert losses[-1] < losses[0]


def test_mesh_trainer_gradients_match_jax(mesh_run):
    """Every first-step gradient: the stacked blocks', the head's and the
    embedding's (fed at stage 0, summed over pp)."""
    (_, grads, _), _, ranks = mesh_run
    assert np.abs(grads["embed"]["embedding"]).max() > 1e-3
    assert_tree_close(_port_tree(ranks[0], "grad"), grads, TOL, "gradient")


def test_mesh_trainer_parameters_match_jax(mesh_run):
    (_, _, params), _, ranks = mesh_run
    assert_tree_close(_port_tree(ranks[0], "param"), params, TOL, "parameter")


def test_mesh_trainer_every_rank_holds_the_same_model(mesh_run):
    replicas_identical(mesh_run[2])


def test_pipelined_lm_refusals_and_layout():
    shape = {"dp": 2, "pp": 2}
    mesh = pm.Mesh(shape, 3, dict.fromkeys(shape))
    cfg = tt.TransformerConfig(dtype=torch.float32, mesh=mesh, **MESH_LM)
    model = PipelinedLM(cfg, repeats=2, microbatches=2, device="cpu")
    names = [n for n, _ in model.named_parameters()]
    assert "blocks.1.0.attn.q.weight" in names and "lm_head.weight" in names
    assert len(model.blocks) == 2 and len(model.blocks[0]) == 1
    import dataclasses

    for kw, err in ((dict(n_experts=2), ValueError), (dict(attention="ring"), ValueError),
                    (dict(tie_embeddings=True), ValueError), (dict(n_layers=6), ValueError)):
        with pytest.raises(err):
            PipelinedLM(dataclasses.replace(cfg, **kw), repeats=2, device="cpu")
    for extra in ({"tp": 2}, {"sp": 2}):
        shape2 = {"pp": 2, **extra}
        bad = pm.Mesh(shape2, 0, dict.fromkeys(shape2))
        with pytest.raises(NotImplementedError, match="A.6b"):
            PipelinedLM(dataclasses.replace(cfg, mesh=bad, attention="full"), device="cpu")
    with pytest.raises(ValueError, match="microbatches"):
        model(torch.zeros(3, 32, dtype=torch.long))
