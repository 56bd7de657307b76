"""The launch plan of the fused-codec reduce-scatter B7 (csrc/ring.cu),
computed in plain Python by its wrapper (`ops/ring_collectives.
fused_rs_plan`, `frs_counts`): stages of whole 256-value segments that
cover the chunk exactly, whole stages a block and no block empty, records
that fill a slot exactly, and flag counts that fit their bits at the
largest payload chip_smoke.py's phase ring runs through B7.  No kernel runs
here; the card tests hold the kernel to its plain version bit for bit."""
from __future__ import annotations

import pytest
import torch

from kungfu_tpu_torch.compression import CompressionConfig, resolve
from kungfu_tpu_torch.compression.quant import dequantize, quantize
from kungfu_tpu_torch.ops import collective as C
from kungfu_tpu_torch.ops import ring_collectives as RC
from kungfu_tpu_torch.tools.ring_check import fused_grid, make_inputs, plain_fused_rs

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
