"""Planted faults for the flash kernel checks.

Each is what a kernel that skipped a block of its work would return, built
from the plain version's results on the same inputs; the kernel checks
(kungfu_tpu_torch.utils.compare) must reject every one.  Causal MHA, the
[B, L, H, D] layout, 64-row blocks as the kernels tile them.
"""
from __future__ import annotations

import torch

from kungfu_tpu_torch.ops import flash

BLOCK = 64
FAULTS = (
    "fwd skips key block 0 for rows >= L/2",
    "dq skips key block 0 for rows >= L/2",
    "dk of key block 0 misses query rows >= L/2",
    "dv of key block 0 misses query rows >= L/2",
    "dk query range ends one block short",
    "dv query range ends one block short",
)


def _key_block_terms(q, k, v, do, lse, delta, scale, rows, keys):
    """The o and dq terms that the keys `keys` add to the query rows `rows`."""
    qf, dof = q[:, rows].float(), do[:, rows].float()
    kf, vf = k[:, keys].float(), v[:, keys].float()
    s = torch.einsum("bqhd,bkhd->bhqk", qf, kf) * scale
    q_pos = torch.arange(q.shape[1], device=q.device)[rows]
    k_pos = torch.arange(k.shape[1], device=q.device)[keys]
    p = torch.where(q_pos[:, None] >= k_pos[None, :], torch.exp(s - lse[:, :, rows, None]), 0.0)
    ds = p * (torch.einsum("bqhd,bkhd->bhqk", dof, vf) - delta[:, :, rows, None])
    return (torch.einsum("bhqk,bkhd->bqhd", p, vf),
            torch.einsum("bhqk,bkhd->bqhd", ds, kf) * scale)


def _dkv_without_rows(q, k, v, do, lse, delta, scale, rows):
    """dk, dv from the plain backward with the query rows `rows` left out
    (their dO and delta zero: they then add nothing to any key)."""
    do, delta = do.clone(), delta.clone()
    do[:, rows] = 0
    delta[:, :, rows] = 0
    return flash._plain_bwd_blhd(q, k, v, do, lse, delta, scale, True, 128, 0)[1:]


def planted_faults(q, k, v, do, lse, delta, scale, o, dq, dk, dv):
    """{fault in FAULTS: (output name, faulty output)} from the plain
    results o, dq, dk, dv of causal attention on q, k, v with cotangent do."""
    L = q.shape[1]
    late, first = slice(L // 2, L), slice(0, BLOCK)
    o_part, dq_part = _key_block_terms(q, k, v, do, lse, delta, scale, late, first)
    o_bad, dq_bad = o.float().clone(), dq.float().clone()
    o_bad[:, late] -= o_part
    dq_bad[:, late] -= dq_part
    dk_late, dv_late = _dkv_without_rows(q, k, v, do, lse, delta, scale, late)
    dk_bad, dv_bad = dk.float().clone(), dv.float().clone()
    dk_bad[:, first], dv_bad[:, first] = dk_late[:, first], dv_late[:, first]
    dk_short, dv_short = _dkv_without_rows(q, k, v, do, lse, delta, scale,
                                           slice(L - BLOCK, L))
    outputs = (("o", o_bad), ("dq", dq_bad), ("dk", dk_bad), ("dv", dv_bad),
               ("dk", dk_short), ("dv", dv_short))
    return dict(zip(FAULTS, outputs))
