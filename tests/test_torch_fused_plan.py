"""The launch plans of the fused-codec reduce-scatter B7 and all-gather B8
(csrc/ring.cu), computed in plain Python by their wrapper
(`ops/ring_collectives.fused_rs_plan`, `fused_ag_plan`, `frs_counts`,
`fag_counts`): stages of whole 256-value segments that cover the chunk
exactly, whole stages a block and no block empty, records that fill a slot
exactly, and flag counts that fit their bits at the largest payload
chip_smoke.py's phase ring runs through them.  Also the plain versions the
card holds each kernel alone against (`ring_check.plain_fused_rs`,
`plain_fused_ag`) against the stacked plain fused all-reduce, and B8's
planted faults.  No kernel runs here; the card tests hold the kernels to
their plain versions bit for bit."""
from __future__ import annotations

import pytest
import torch

from kungfu_tpu_torch.compression import CompressionConfig, resolve
from kungfu_tpu_torch.compression.quant import dequantize, quantize
from kungfu_tpu_torch.ops import collective as C
from kungfu_tpu_torch.ops import ring_collectives as RC
from kungfu_tpu_torch.tools.ring_check import (fused_config, fused_grid, make_inputs,
                                               plain_fused_ag, plain_fused_rs,
                                               planted_ag_faults)

GQA_GRAD = 342_410_240  # the GQA flagship's gradient values (chip_smoke.py phase ring)
STEP_BUCKET = 67_108_864  # a 256 MiB bucket of f32 gradients (phase gqa's step)

PAYLOADS = [
    # (values, ranks, quantization block)
    (100, 3, 256),  # one stage, shorter than a segment's 1024-value tile
    (4099, 2, 256),
    (36827, 4, 32),  # ends mid-stage and mid-segment
    (1_000_003, 4, 256),
    (STEP_BUCKET, 4, 256),
    (GQA_GRAD, 4, 256),
    (GQA_GRAD, 2, 8),  # the most scales a value
]


def _stage_sizes(chunk: int, stages: int):
    return [min(RC.FRS_STAGE_VALUES, chunk - t * RC.FRS_STAGE_VALUES) for t in range(stages)]


@pytest.mark.parametrize("max_blocks", [1, 16, 132])
@pytest.mark.parametrize("size,n,block", PAYLOADS)
def test_stages_cover_the_chunk(size, n, block, max_blocks):
    chunk = C.fused_chunk_elems(size, n, CompressionConfig(scheme="int8", block=block))
    plan = RC.fused_rs_plan(chunk, block, max_blocks)
    sizes = _stage_sizes(chunk, plan.stages)
    assert sum(sizes) == chunk and all(0 < v <= RC.FRS_STAGE_VALUES for v in sizes)
    assert all(v % 256 == 0 for v in sizes)  # whole segments: no block of scales split
    assert RC.FRS_STAGE_VALUES % 1024 == 0
    # the records, each a stage's codes then its scales, fill the slot exactly
    records = [v + v // block * 4 for v in sizes]
    assert sum(records) == plan.slot == chunk + chunk // block * 4
    assert all(r % 16 == 0 for r in records) and plan.record % 16 == 0  # bulk copies
    assert all(t * plan.record + r <= plan.slot for t, r in enumerate(records))
    # whole stages a block (csrc/ring_common.cuh block_range), none empty
    assert 1 <= plan.blocks <= min(max_blocks, RC.FRS_GRID)
    ranges = [(min(plan.stages, b * plan.per_block), min(plan.stages, (b + 1) * plan.per_block))
              for b in range(plan.blocks)]
    assert ranges[0][0] == 0 and ranges[-1][1] == plan.stages
    assert all(lo < hi for lo, hi in ranges)
    assert all(a[1] == b[0] for a, b in zip(ranges, ranges[1:]))


@pytest.mark.parametrize("stages", [1, 2, 3, 8, 10, 11, 80, 1307])
def test_flag_counts_rise_to_every_stage(stages):
    counts = RC.frs_counts(stages)
    assert counts[-1] == stages
    assert all(a < b for a, b in zip(counts, counts[1:]))
    # a count every FRS_COUNT stages while FRS_COUNT_LAG stores are in flight
    assert all(c % RC.FRS_COUNT == 0 for c in counts[:-1])
    assert len(counts) == (stages - 1 - RC.FRS_COUNT_LAG) // RC.FRS_COUNT + 1 \
        if stages > RC.FRS_COUNT_LAG else len(counts) == 1


@pytest.mark.parametrize("n", [2, 4])
def test_flag_counts_fit_their_bits(n):
    """At the largest payload phase ring runs through B7, even on one block
    a hop's count stays below 2^STAGE_BITS (the flag holds (call <<
    STAGE_BITS) + count)."""
    chunk = C.fused_chunk_elems(GQA_GRAD, n, CompressionConfig(scheme="int8"))
    plan = RC.fused_rs_plan(chunk, 256, 1)
    assert plan.blocks == 1 and plan.per_block == plan.stages
    assert max(RC.frs_counts(plan.per_block)) < (1 << RC.STAGE_BITS) - 1


def test_grid_caps_the_blocks():
    """`ring_check --grid` caps B7's grid through `fused_grid` (FRS_GRID)."""
    chunk = C.fused_chunk_elems(GQA_GRAD, 4, CompressionConfig(scheme="int8"))
    for grid in (16, 32, 66, 132):
        with fused_grid(grid):
            plan = RC.fused_rs_plan(chunk, 256, 132)
        assert plan.blocks <= grid and plan.blocks * plan.per_block >= plan.stages
    assert RC.FRS_GRID == 132  # restored


@pytest.mark.parametrize("scheme", ["int8", "fp8"])
@pytest.mark.parametrize("n,size", [(2, 5000), (3, 4099), (4, 36827), (4, 100)])
def test_plain_b7_is_the_all_reduce_before_its_gather(scheme, n, size):
    """`ring_check.plain_fused_rs`, what the card holds B7 alone against:
    each rank's chunk, quantized once more as B8 does, is that chunk of the
    stacked plain fused all-reduce, bit for bit."""
    cfg = resolve(scheme)
    xs = make_inputs(n, size, torch.float32, 3, torch.device("cpu"))
    chunk = C.fused_chunk_elems(size, n, cfg)
    full = C._plain_fused_ring_all_reduce(xs, cfg)[0]
    for d in range(n):
        mine = plain_fused_rs(xs, cfg, d)
        assert mine.shape == (chunk,) and mine.dtype == torch.float32
        lo, hi = min(size, d * chunk), min(size, (d + 1) * chunk)
        assert torch.equal(dequantize(quantize(mine, cfg))[:hi - lo], full[lo:hi])


@pytest.mark.parametrize("max_blocks", [1, 3, 7, 16, 132])
@pytest.mark.parametrize("size,n,block", PAYLOADS + [(36827, 3, 8), (131075, 2, 32)])
def test_b8_stages_cover_the_chunk(size, n, block, max_blocks):
    """B8's plan: B7's stages and records (csrc/ring.cu `fstage`), whole
    stages a block, none empty, however the grid compares to the stages."""
    chunk = C.fused_chunk_elems(size, n, CompressionConfig(scheme="int8", block=block))
    plan = RC.fused_ag_plan(chunk, block, max_blocks)
    assert plan == RC.fused_rs_plan(chunk, block, max_blocks)._replace(
        blocks=plan.blocks, per_block=plan.per_block)
    sizes = _stage_sizes(chunk, plan.stages)
    assert sum(sizes) == chunk and all(0 < v <= RC.FRS_STAGE_VALUES for v in sizes)
    assert all(v % 1024 == 0 for v in sizes)  # 16 values a thread: whole 64-thread tiles
    # each stage's record, its codes then its scales, fills the slot exactly
    records = [v + v // block * 4 for v in sizes]
    assert sum(records) == plan.slot == chunk + chunk // block * 4
    assert all(t * plan.record + r <= plan.slot for t, r in enumerate(records))
    assert all(r % 16 == 0 for r in records) and plan.record % 16 == 0  # 16-byte stores
    assert 1 <= plan.blocks <= min(max_blocks, RC.FAG_GRID, plan.stages)
    ranges = [(min(plan.stages, b * plan.per_block), min(plan.stages, (b + 1) * plan.per_block))
              for b in range(plan.blocks)]
    assert ranges[0][0] == 0 and ranges[-1][1] == plan.stages
    assert all(lo < hi for lo, hi in ranges)
    assert all(a[1] == b[0] for a, b in zip(ranges, ranges[1:]))


@pytest.mark.parametrize("stages", [1, 2, 3, 4, 5, 8, 10, 16, 1307])
def test_b8_flag_counts_rise_to_every_stage(stages):
    """A count after every FAG_COUNT stages and after the last: the groups
    a worker's hop s > 0 loads at once are the stages between counts."""
    counts = RC.fag_counts(stages)
    assert counts[-1] == stages and all(a < b for a, b in zip(counts, counts[1:]))
    assert all(c % RC.FAG_COUNT == 0 for c in counts[:-1])
    assert len(counts) == -(-stages // RC.FAG_COUNT)


@pytest.mark.parametrize("n", [2, 4])
def test_b8_flag_counts_fit_their_bits(n):
    """At the largest payload phase ring runs, with blocks of 8 (the most
    scales a value) and on one block, B8's counts stay below
    2^STAGE_BITS - 1 (csrc/ring.cu `kft_ring_fag` checks it)."""
    cfg = CompressionConfig(scheme="int8", block=8)
    chunk = C.fused_chunk_elems(GQA_GRAD, n, cfg)
    plan = RC.fused_ag_plan(chunk, 8, 1)
    assert plan.blocks == 1 and plan.per_block == plan.stages
    assert max(RC.fag_counts(plan.per_block)) < (1 << RC.STAGE_BITS) - 1
    assert plan.slot == chunk + chunk // 8 * 4


def test_grid_caps_b8_too():
    """`ring_check --grid` caps B8's grid (FAG_GRID) with B7's."""
    chunk = C.fused_chunk_elems(STEP_BUCKET, 4, CompressionConfig(scheme="int8"))
    for grid in (1, 16, 32, 66, 132):
        with fused_grid(grid):
            plan = RC.fused_ag_plan(chunk, 256, 132)
        assert plan.blocks <= grid and plan.blocks * plan.per_block >= plan.stages
    assert RC.FAG_GRID == 132 and RC.FRS_GRID == 132  # restored


@pytest.mark.parametrize("name", ["int8", "fp8", "int8/8", "fp8/32"])
@pytest.mark.parametrize("op", ["sum", "mean"])
@pytest.mark.parametrize("n,size", [(2, 5000), (3, 4099), (4, 36827), (4, 100), (3, 20000)])
def test_plain_b8_is_the_all_reduce_gather(name, op, n, size):
    """`ring_check.plain_fused_ag` on every rank's chunk as B7 leaves it
    (times 1/n for the mean) is the stacked plain fused all-reduce, bit
    for bit, on every rank: B8 held alone is held to the all-reduce's
    all-gather leg."""
    cfg = fused_config(name)
    xs = make_inputs(n, size, torch.float32, 5, torch.device("cpu"))
    want = C._plain_fused_ring_all_reduce(xs, cfg, op)[0]
    mines = [plain_fused_rs(xs, cfg, r) for r in range(n)]
    if op == "mean":
        mines = [m * (1.0 / n) for m in mines]
    for d in range(n):
        got = plain_fused_ag(mines, cfg, d, size)
        assert got.shape == (size,) and got.dtype == torch.float32
        assert torch.equal(got, want)
    assert torch.equal(plain_fused_ag(mines, cfg, 0)[:size], want)  # every chunk, whole


@pytest.mark.parametrize("n,size,block", [(2, 5000, 256), (4, 36827, 8), (3, 100, 32)])
def test_b8_faults_are_rejected(n, size, block):
    """Each planted fault of B8's check differs from the plain result, in
    the chunk that arrived last: a stage's record left out, a scale wrong."""
    cfg = CompressionConfig(scheme="int8", block=block)
    xs = make_inputs(n, size, torch.float32, 9, torch.device("cpu"))
    chunk = C.fused_chunk_elems(size, n, cfg)
    mines = [plain_fused_rs(xs, cfg, r) for r in range(n)]
    for d in range(n):
        good = plain_fused_ag(mines, cfg, d, size)
        faults = planted_ag_faults(good, chunk, cfg, n, d)
        assert [f for f, _ in faults] == ["a stage's record left out", "a scale wrong"]
        for _, bad in faults:
            assert bad.shape == good.shape and not torch.equal(bad, good)


def test_gqa_step_buckets_fit_the_bucket_case():
    """The compressed GQA step's buckets at 256 MiB (`optimizers/sync.
    _pack_buckets` over the f32 error-corrected gradients of
    `step_profile.flagship_model(n_kv_heads=8)`, shapes only): six
    launches each of B7 and B8 a step, none above STEP_BUCKET values, the
    size `ring_check` times as the step's bucket."""
    from torch._subclasses.fake_tensor import FakeTensorMode

    from kungfu_tpu_torch.models import transformer as tt
    from kungfu_tpu_torch.optimizers.sync import _pack_buckets

    with FakeTensorMode():
        cfg = tt.TransformerConfig(**{**tt.FLAGSHIP_GPT, "dtype": torch.bfloat16,
                                      "attention": "flash", "n_kv_heads": 8})
        model = tt.TransformerLM(cfg, device="cpu")
        grads = [torch.empty(p.numel(), dtype=torch.float32) for p in model.parameters()]
    sizes = [sum(grads[i].numel() for i in b) for b in _pack_buckets(grads, 256 << 20)]
    assert sum(sizes) == GQA_GRAD
    assert sizes == [63_182_848, 65_024_000, 66_071_552, 65_022_976, 50_340_864, 32_768_000]
    assert max(sizes) <= STEP_BUCKET
