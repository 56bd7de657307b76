"""The port's fused benchmark and step attribution against the JAX
package's.

`python -m kungfu_tpu_torch.benchmarks --bench fused --device cpu` runs on
4 gloo ranks (its `main`, each rank in a subprocess); its record must carry the
keys of the JAX record (`kungfu_tpu.benchmarks.fused.bench_fused`, run
here on the virtual CPU devices with its XLA fallbacks, 1 step: only the
keys are compared), plus `card` and each row's `unfused_via` (which
backend the unfused arm used).  Every number of a CPU run is the plain
versions' on the CPU and says nothing of the card.  `step_attribution`
must return what the JAX function returns.
"""
from __future__ import annotations

import json
import os

import pytest

from _torch_ranks import start_ranks, wait_ranks
from _torch_reference import jax_reference
from kungfu_tpu_torch.benchmarks import __main__ as bench_main
from kungfu_tpu_torch.benchmarks.scaling import step_attribution

EXTRA = {"record": {"card"}, "row": {"unfused_via"}}
CASES = [(10.0, 4.0), (10.0, 4.0, 1.5), (3.0, 7.0), (0.0, 0.0), (5.25, 5.25, 0.0),
         (1234.5678, 1000.0, 100.0)]


@pytest.fixture(scope="module")
def jax_side():
    old = os.environ.pop("KFT_PALLAS", None)  # the lax fallbacks: the keys are the same
    try:
        with jax_reference():
            from kungfu_tpu.benchmarks.fused import bench_fused
            from kungfu_tpu.benchmarks.scaling import step_attribution as jax_attr

            yield bench_fused(steps=1, warmup=0), jax_attr
    finally:
        if old is not None:
            os.environ["KFT_PALLAS"] = old


WORKER = ("import sys\n"
          "from kungfu_tpu_torch.benchmarks.__main__ import main\n"
          "sys.exit(main(sys.argv[1:]))\n")


@pytest.fixture(scope="module")
def port_record(tmp_path_factory):
    """The command's record from 4 gloo ranks (brought up from the KungFu
    env contract on free ports, as the launcher would on its own)."""
    out = tmp_path_factory.mktemp("bench") / "fused.json"
    wait_ranks(start_ranks(WORKER, 4, ["--bench", "fused", "--device", "cpu", "--steps", "2",
                                       "--warmup", "1", "--out", out]), timeout=300)
    return json.loads(out.read_text())


def test_record_has_the_jax_keys(jax_side, port_record):
    want = jax_side[0]
    assert set(port_record) == set(want) | EXTRA["record"]
    assert port_record["np"] == 4 and port_record["backend"] == "cpu"
    assert len(port_record["ops"]) == len(want["ops"])
    for got, ref in zip(port_record["ops"], want["ops"]):
        assert got["op"] == ref["op"]
        assert set(got) == set(ref) | EXTRA["row"]
        assert set(got["attribution"]) == set(ref["attribution"])
        assert set(got["attribution"]["fused"]) == set(ref["attribution"]["fused"])
    assert set(port_record["fsdp_step"]) == set(want["fsdp_step"]) | EXTRA["row"]


def test_record_names_what_ran(port_record):
    """No fallback exists: the CPU run reports the plain versions and the
    gloo arm, and every time is positive."""
    rows = port_record["ops"] + [port_record["fsdp_step"]]
    assert port_record["fused_fallback_engaged"] is False
    for row in rows:
        assert row["effective_impl"] == "plain" and row["fallback_engaged"] is False
        assert row["unfused_via"] == "gloo"
        assert row["np"] == 4
        assert min(v for k, v in row.items() if k.endswith("_p50")) > 0
    speedups = [r["speedup"] for r in port_record["ops"]]
    assert port_record["fused_speedup_vs_unfused"] == min(speedups)


@pytest.mark.parametrize("args", CASES)
def test_step_attribution_matches_jax(jax_side, args):
    assert step_attribution(*args) == jax_side[1](*args)


@pytest.mark.parametrize("bench", sorted(bench_main.LATER))
def test_other_benchmarks_name_their_roadmap_item(bench):
    with pytest.raises(NotImplementedError, match=f"ROADMAP {bench_main.LATER[bench]}"):
        bench_main.main(["--bench", bench])
