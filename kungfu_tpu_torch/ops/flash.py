"""Flash attention on hand-written CUDA kernels for Hopper.

Counterpart of kungfu_tpu/ops/flash.py.  Four kernels carry it on a card
at head dims up to 128, and a wide family of three above (sources in
csrc/, built by _build.py on first use):

  flash_fwd          csrc/flash_fwd.cu   replaces `_fwd_kernel`          (B1)
  flash_bwd_dq       csrc/flash_bwd.cu   replaces `_bwd_dq_kernel`       (B2)
  flash_bwd_dkv      csrc/flash_bwd.cu   replaces `_bwd_dkv_kernel`      (B3, MHA)
  flash_bwd_dkv_gqa  csrc/flash_bwd.cu   replaces `_bwd_dkv_gqa_kernel`  (B4, GQA)
  flash_wide_fwd     csrc/flash_wide.cu  B1 at head dims over 128
  flash_wide_dq      csrc/flash_wide.cu  B2 at head dims over 128
  flash_wide_dkv     csrc/flash_wide.cu  B3 and B4 at head dims over 128

`flash_bwd_dkv` launches B3 when k and v carry as many heads as q and B4
when they carry fewer (grouped-query attention).  B3 and B4 are one CUDA
kernel: a block loops over the query heads of its kv head, one for MHA,
and each launch counts for the TPU kernel it replaces.

Each wrapper below launches its kernel for CUDA tensors and runs its plain
PyTorch version for CPU tensors; it never moves a CUDA tensor to the plain
version.  The plain versions are ports of `_fwd_reference` and
`_bwd_blocked`: the tests hold them against the JAX package, and the card
holds the kernels against them.  Each kernel's `launches` count says how
often the wrapper launched it.

A wide launch counts for its kernel and for the row of the TPU kernel it
replaces (B1, B2, B3 or B4), so a path's B-row counts hold whatever its
head dim.

Head dims: the four kernels take 8 to 128 in steps of 8 in place
(`HEAD_DIMS`: rows of whole 16-byte chunks; a head narrower than the 64-
or 128-column tile is padded with zero columns in shared memory), and the
wide family every multiple of 8 above 128 (`wide_head`).  Any other head
dim goes through the same kernels on copies of the operands padded with
zero columns to the next multiple of 8 (`pad_head`), with the caller's
scale, and the outputs are cut back (`cut_head`): the zero columns add
exact zeros to every q.k sum and to rowsum(dO * O), so this is exact; the
copy is what an odd head costs.  In bf16 and fp16 the four run on wgmma
(the forward with TMA loads); f32 runs on float FMA loops.

The wide family has two bodies (csrc/flash_wide.cu); one shape goes to
exactly one.  In bf16 and fp16 at head dims up to 256 (`wide_wgmma`) the
forward and the backward run on wgmma.  The forward's block is two
warpgroups owning `WIDE_FWD_ROWS` query rows, each warpgroup 64 of them
with their O across the whole head dim in registers; K and V arrive by
TMA and both warpgroups read each tile, each with its own S and softmax.
The backward's block owns 64 output rows, each warpgroup a 128-column
slab of them in registers; S and dP are computed once a tile over the
whole head dim, one by each warpgroup, and shared through shared memory.
The dk/dv kernel splits each kv head's query-head group over `parts`
blocks where the kv heads alone give the card too few blocks
(`wide_dkv_parts`); the parts' f32 partials meet in scratch this module
allocates (`wide_dkv_scratch`) and the last block of a key tile sums them
in a fixed order.  f32 and head dims over 256 run on the first, slab
body, forward and backward: an output slab of `WIDE_SLAB` columns a
block, S and dP summed over 64-column chunks (WMMA through shared memory;
FMA in f32).

The public functions keep the JAX signatures and the [B, L, H, D] layout;
`interpret` has no counterpart here.
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch

from ..compat import kernel_mode

NEG_INF = -1e30
_PLAIN_BLOCK_K = 128  # key block of the wrappers' plain backward on the CPU
_DTYPE_CODES = {torch.float32: 0, torch.float16: 1, torch.bfloat16: 2}
HEAD_DIMS = tuple(range(8, 129, 8))  # what the four kernels take in place
WIDE_SLAB = 128  # output columns of a wide block (and the widest head of the four)
WIDE_MMA_MAX = 256  # the widest head the wide family's wgmma bodies take
WIDE_ROWS = 64  # rows of a wide block's output tile (and of a streamed tile)
WIDE_FWD_ROWS = 128  # query rows of a wgmma forward block: WIDE_ROWS a warpgroup
WIDE_THREADS = 256  # threads of a wgmma block: two warpgroups
WIDE_PARTIAL_SLOTS = 128  # f32 values of a thread's dK and dV slabs
H100_SMS = 132  # streaming multiprocessors of an H100 SXM


class Kernel:
    """A hand-written kernel: where it replaces a TPU kernel, and how many
    times its wrapper launched it."""

    def __init__(self, name: str, source: str, replaces: str):
        self.name = name
        self.source = source
        self.replaces = replaces
        self.launches = 0


FLASH_FWD = Kernel("flash_fwd", "kungfu_tpu_torch/ops/csrc/flash_fwd.cu",
                   "kungfu_tpu/ops/flash.py:98")  # _fwd_kernel
FLASH_BWD_DQ = Kernel("flash_bwd_dq", "kungfu_tpu_torch/ops/csrc/flash_bwd.cu",
                      "kungfu_tpu/ops/flash.py:272")  # _bwd_dq_kernel
FLASH_BWD_DKV = Kernel("flash_bwd_dkv", "kungfu_tpu_torch/ops/csrc/flash_bwd.cu",
                       "kungfu_tpu/ops/flash.py:429")  # _bwd_dkv_kernel
FLASH_BWD_DKV_GQA = Kernel("flash_bwd_dkv_gqa", "kungfu_tpu_torch/ops/csrc/flash_bwd.cu",
                           "kungfu_tpu/ops/flash.py:442")  # _bwd_dkv_gqa_kernel
KERNELS = (FLASH_FWD, FLASH_BWD_DQ, FLASH_BWD_DKV, FLASH_BWD_DKV_GQA)
_WIDE = "kungfu_tpu_torch/ops/csrc/flash_wide.cu"
FLASH_WIDE_FWD = Kernel("flash_wide_fwd", _WIDE, "kungfu_tpu/ops/flash.py:98")
FLASH_WIDE_DQ = Kernel("flash_wide_dq", _WIDE, "kungfu_tpu/ops/flash.py:272")
# B3's body, and B4's (`_bwd_dkv_gqa_kernel`, flash.py:442) when Hkv < H
FLASH_WIDE_DKV = Kernel("flash_wide_dkv", _WIDE, "kungfu_tpu/ops/flash.py:429")
WIDE_KERNELS = (FLASH_WIDE_FWD, FLASH_WIDE_DQ, FLASH_WIDE_DKV)


# ------------------------------------------------------ plain versions ----
# [B*H, L, D] layout, as in the JAX package.

def _to_bhld(x: torch.Tensor) -> torch.Tensor:
    b, l, h, d = x.shape
    return x.permute(0, 2, 1, 3).reshape(b * h, l, d)


def _from_bhld(x: torch.Tensor, b: int) -> torch.Tensor:
    bh, l, d = x.shape
    return x.reshape(b, bh // b, l, d).permute(0, 2, 1, 3)


def _expand_kv(x: torch.Tensor, h: int, hkv: int) -> torch.Tensor:
    """[B*Hkv, L, D] -> [B*H, L, D], each kv head repeated over its group."""
    if h == hkv:
        return x
    bhkv, l, d = x.shape
    return x.reshape(bhkv // hkv, hkv, l, d).repeat_interleave(
        h // hkv, dim=1).reshape(-1, l, d)


def _valid(q_pos, k_pos, seq_len: int, causal: bool, window: int):
    valid = (k_pos < seq_len)[None, :] & (q_pos < seq_len)[:, None]
    if causal:
        valid = valid & (q_pos[:, None] >= k_pos[None, :])
    if window > 0:
        valid = valid & (q_pos[:, None] - k_pos[None, :] < window)
    return valid


def _fwd_reference(q, k, v, scale: float, causal: bool, window: int = 0):
    """Plain forward, (o, lse) as the kernel returns them; scores in f32."""
    seq_len = q.shape[1]
    s = torch.einsum("bqd,bkd->bqk", q.float() * scale, k.float())
    pos = torch.arange(seq_len, device=q.device)
    s = torch.where(_valid(pos, pos, seq_len, causal, window)[None], s, NEG_INF)
    m = s.amax(dim=-1, keepdim=True)
    p = torch.exp(s - m)
    l = p.sum(dim=-1, keepdim=True)
    o = torch.einsum("bqk,bkd->bqd", p, v.float()) / l
    lse = (m + torch.log(l))[..., 0]
    return o.to(q.dtype), lse


def _bwd_blocked(q, k, v, g, lse, delta, scale: float, causal: bool,
                 block_k: int, window: int = 0):
    """Port of `_bwd_blocked`, [B*H, L, D]: the rematerializing backward,
    a loop over key blocks that never holds the whole [L, L] probability
    matrix.  Takes delta = rowsum(dO * O) - g_lse from the caller, as the
    kernels do.  Products take operands in the input dtype (P and dS
    rounded to it) and accumulate in f32."""
    seq_len = q.shape[1]
    gf = g.to(q.dtype)
    q_pos = torch.arange(seq_len, device=q.device)
    dq = torch.zeros(q.shape, dtype=torch.float32, device=q.device)
    dks, dvs = [], []
    for k0 in range(0, seq_len, block_k):
        k_blk, v_blk = k[:, k0:k0 + block_k], v[:, k0:k0 + block_k]
        k_pos = torch.arange(k0, k0 + k_blk.shape[1], device=q.device)
        s = torch.einsum("bqd,bkd->bqk", q.float(), k_blk.float()) * scale
        valid = _valid(q_pos, k_pos, seq_len, causal, window)[None]
        p = torch.where(valid, torch.exp(s - lse[:, :, None]), 0.0)
        dvs.append(torch.einsum("bqk,bqd->bkd", p.to(gf.dtype).float(), gf.float()))
        dp = torch.einsum("bqd,bkd->bqk", gf.float(), v_blk.float())
        ds = p * (dp - delta[:, :, None])
        dq += torch.einsum("bqk,bkd->bqd", ds.to(k.dtype).float(), k_blk.float())
        dks.append(torch.einsum("bqk,bqd->bkd", ds.to(q.dtype).float(), q.float()))
    return ((dq * scale).to(q.dtype), (torch.cat(dks, 1) * scale).to(k.dtype),
            torch.cat(dvs, 1).to(v.dtype))


def wide_head(d: int) -> bool:
    """Whether a head of d runs on the wide family (its kernel head dim is
    over WIDE_SLAB columns)."""
    return kernel_head_dim(d) > WIDE_SLAB


def wide_wgmma(d: int, dtype: torch.dtype) -> bool:
    """Whether a wide head of kernel head dim d in `dtype` takes the wgmma
    bodies, forward and backward (bf16 and fp16 up to WIDE_MMA_MAX
    columns), rather than the slab body (f32, and heads over
    WIDE_MMA_MAX); csrc/flash_wide.cu `mma_dim` makes the same choice."""
    return (dtype in (torch.bfloat16, torch.float16)
            and WIDE_SLAB < kernel_head_dim(d) <= WIDE_MMA_MAX)


def wide_dkv_parts(b: int, hkv: int, group: int, l: int) -> int:
    """How many blocks the wgmma dk/dv kernel splits each kv head's group
    of `group` query heads over: the least divisor of the group that gives
    an H100 three waves of blocks (b * hkv * ceil(l / 64) key tiles times
    parts; one block an SM), else the whole group (a head a block)."""
    tiles = b * hkv * -(-l // WIDE_ROWS)
    for parts in range(1, group + 1):
        if group % parts == 0 and tiles * parts >= 3 * H100_SMS:
            return parts
    return group


def wide_dkv_scratch(b: int, hkv: int, l: int, parts: int):
    """(partial sums, counters) shapes the wgmma dk/dv kernel needs at
    `parts` > 1: f32 [key tiles, parts, 128, 256] (each thread's dK and dV
    slabs in register order) and int32 [key tiles], zeroed; None at 1."""
    if parts == 1:
        return None
    tiles = b * hkv * -(-l // WIDE_ROWS)
    return (tiles, parts, WIDE_PARTIAL_SLOTS, WIDE_THREADS), (tiles,)


def _plain_fwd_blhd(q, k, v, scale, causal, window):
    """The plain forward on [B, L, H, D] tensors: (o, lse [B, H, L])."""
    b, l, h, _ = q.shape
    hkv = k.shape[2]
    o, lse = _fwd_reference(_to_bhld(q), _expand_kv(_to_bhld(k), h, hkv),
                            _expand_kv(_to_bhld(v), h, hkv), scale, causal, window)
    return _from_bhld(o, b), lse.reshape(b, h, l)


def _plain_bwd_blhd(q, k, v, g, lse, delta, scale, causal, block_k, window):
    """The blocked backward on [B, L, H, D] tensors; GQA through repeated
    kv heads and an f32 group sum, as the JAX package's XLA arm does."""
    b, l, h, d = q.shape
    hkv = k.shape[2]
    dq, dk, dv = _bwd_blocked(
        _to_bhld(q), _expand_kv(_to_bhld(k), h, hkv),
        _expand_kv(_to_bhld(v), h, hkv), _to_bhld(g), lse.reshape(b * h, l),
        delta.reshape(b * h, l), scale, causal, block_k, window)
    if h != hkv:
        def reduce(x, dtype):
            return x.float().reshape(b, hkv, h // hkv, l, d).sum(2).reshape(
                b * hkv, l, d).to(dtype)

        dk, dv = reduce(dk, k.dtype), reduce(dv, v.dtype)
    return _from_bhld(dq, b), _from_bhld(dk, b), _from_bhld(dv, b)


# ------------------------------------------------------- kernel wrappers --
# q, o, dq, do: [B, L, H, D]; k, v, dk, dv: [B, L, Hkv, D]; lse, delta:
# [B, H, L] f32.

def kernel_head_dim(d: int) -> int:
    """The head dim the kernels run a head of d on: d rounded up to a
    multiple of 8."""
    return -(-d // 8) * 8


def pad_head(x: torch.Tensor, dp: int) -> torch.Tensor:
    """x [..., D] with zero columns D..dp-1 appended (x itself at D = dp)."""
    d = x.shape[-1]
    return x if d == dp else torch.nn.functional.pad(x, (0, dp - d))


def cut_head(x: torch.Tensor, d: int) -> torch.Tensor:
    """The first d columns of x [..., dp], contiguous (x itself at d = dp)."""
    return x if x.shape[-1] == d else x[..., :d].contiguous()


def _check_cuda(name: str, tensors, f32_tensors=()) -> None:
    q = tensors[0]
    if q.dtype not in _DTYPE_CODES:
        raise ValueError(f"{name}: dtype {q.dtype} not supported (bf16, fp16 or f32)")
    if q.shape[0] * q.shape[2] > 65535:
        raise ValueError(f"{name}: B*H = {q.shape[0] * q.shape[2]} exceeds the grid")
    for t in tensors:
        if not t.is_cuda or t.device != q.device:
            raise ValueError(f"{name}: every operand must be on {q.device}")
        if t.dtype != q.dtype:
            raise ValueError(f"{name}: mixed dtypes {t.dtype} and {q.dtype}")
        if not t.is_contiguous():
            raise ValueError(f"{name}: operands must be contiguous [B, L, H, D]")
        if t.data_ptr() % 16 and kernel_head_dim(q.shape[-1]) == q.shape[-1]:
            # (an odd head reaches the kernels as padded copies)
            raise ValueError(f"{name}: operands must start 16-byte aligned")
    for t in f32_tensors:
        if t.device != q.device or t.dtype != torch.float32 or not t.is_contiguous():
            raise ValueError(f"{name}: lse/delta must be contiguous f32 on {q.device}")


def _launch(kernel: Kernel, device, *args, row: Optional[Kernel] = None) -> None:
    """Launch `kernel` on the current stream; a wide kernel also counts for
    `row`, the B-row kernel whose work it does at a wide head."""
    from . import _build

    fn = _build.function(f"kft_{kernel.name}")
    with torch.cuda.device(device):
        err = fn(*args, torch.cuda.current_stream(device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"{kernel.name}: kernel launch failed with CUDA error {err}")
    kernel.launches += 1
    if row is not None:
        row.launches += 1


def flash_fwd(q, k, v, scale: float, causal: bool, window: int = 0
              ) -> Tuple[torch.Tensor, torch.Tensor]:
    """B1: (o [B, L, H, D], lse [B, H, L] f32)."""
    if kernel_mode(q.device) == "plain":
        return _plain_fwd_blhd(q, k, v, scale, causal, window)
    b, l, h, d = q.shape
    hkv = k.shape[2]
    _check_cuda("flash_fwd", (q, k, v))
    dp = kernel_head_dim(d)
    if dp != d:
        o, lse = flash_fwd(*(pad_head(x, dp) for x in (q, k, v)), scale, causal, window)
        return cut_head(o, d), lse
    o = torch.empty_like(q)
    lse = torch.empty((b, h, l), dtype=torch.float32, device=q.device)
    args = (q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(), lse.data_ptr(),
            _DTYPE_CODES[q.dtype], b, h, hkv, l, d, float(scale), int(causal), int(window))
    if wide_head(d):
        _launch(FLASH_WIDE_FWD, q.device, *args, row=FLASH_FWD)
    else:
        _launch(FLASH_FWD, q.device, *args)
    return o, lse


def flash_bwd_dq(q, k, v, do, lse, delta, scale: float, causal: bool,
                 window: int = 0) -> torch.Tensor:
    """B2: dq [B, L, H, D]."""
    b, l, h, d = q.shape
    hkv = k.shape[2]
    if kernel_mode(q.device) == "plain":
        return _plain_bwd_blhd(q, k, v, do, lse, delta, scale, causal, _PLAIN_BLOCK_K,
                               window)[0]
    _check_cuda("flash_bwd_dq", (q, k, v, do), (lse, delta))
    dp = kernel_head_dim(d)
    if dp != d:
        return cut_head(flash_bwd_dq(*(pad_head(x, dp) for x in (q, k, v, do)), lse, delta,
                                     scale, causal, window), d)
    dq = torch.empty_like(q)
    args = (q.data_ptr(), k.data_ptr(), v.data_ptr(), do.data_ptr(), lse.data_ptr(),
            delta.data_ptr(), dq.data_ptr(), _DTYPE_CODES[q.dtype], b, h, hkv, l, d,
            float(scale), int(causal), int(window))
    if wide_head(d):
        _launch(FLASH_WIDE_DQ, q.device, *args, row=FLASH_BWD_DQ)
    else:
        _launch(FLASH_BWD_DQ, q.device, *args)
    return dq


def flash_bwd_dkv(q, k, v, do, lse, delta, scale: float, causal: bool,
                  window: int = 0) -> Tuple[torch.Tensor, torch.Tensor]:
    """B3 (MHA) or B4 (GQA, k and v with Hkv < H heads): (dk, dv)
    [B, L, Hkv, D]."""
    b, l, h, d = q.shape
    hkv = k.shape[2]
    if kernel_mode(q.device) == "plain":
        return _plain_bwd_blhd(q, k, v, do, lse, delta, scale, causal, _PLAIN_BLOCK_K,
                               window)[1:]
    _check_cuda("flash_bwd_dkv", (q, k, v, do), (lse, delta))
    dp = kernel_head_dim(d)
    if dp != d:
        dk, dv = flash_bwd_dkv(*(pad_head(x, dp) for x in (q, k, v, do)), lse, delta, scale,
                               causal, window)
        return cut_head(dk, d), cut_head(dv, d)
    dk = torch.empty_like(k)
    dv = torch.empty_like(v)
    ptrs = (q.data_ptr(), k.data_ptr(), v.data_ptr(), do.data_ptr(), lse.data_ptr(),
            delta.data_ptr(), dk.data_ptr(), dv.data_ptr())
    code = _DTYPE_CODES[q.dtype]
    tail = (l, d, float(scale), int(causal), int(window))
    row = FLASH_BWD_DKV if hkv == h else FLASH_BWD_DKV_GQA
    if wide_head(d):
        parts = wide_dkv_parts(b, hkv, h // hkv, l) if wide_wgmma(d, q.dtype) else 1
        shapes = wide_dkv_scratch(b, hkv, l, parts)
        scratch = (0, 0)
        if shapes is not None:
            partial = torch.empty(shapes[0], dtype=torch.float32, device=q.device)
            done = torch.zeros(shapes[1], dtype=torch.int32, device=q.device)
            scratch = (partial.data_ptr(), done.data_ptr())
        _launch(FLASH_WIDE_DKV, q.device, *ptrs, *scratch, parts, code, b, h, hkv, *tail,
                row=row)
    elif hkv == h:
        _launch(row, q.device, *ptrs, code, b, h, *tail)
    else:
        _launch(row, q.device, *ptrs, code, b, h, hkv, *tail)
    return dk, dv


# ------------------------------------------------------------- autograd ---

def _dispatch_bwd(q, k, v, o, lse, g, scale, causal, block_k, g_lse, window,
                  backward):
    """The kernels on a card unless the caller asked for backward="xla",
    which (like every CPU call) runs the plain blocked backward.  The JAX
    package's shape-based auto rule is a TPU measurement and is not
    carried over."""
    delta = (o.float() * g.float()).sum(dim=-1).transpose(1, 2)  # [B, H, L]
    if g_lse is not None:
        delta = delta - g_lse.float()
    delta = delta.contiguous()
    if backward == "xla" or kernel_mode(q.device) == "plain":
        return _plain_bwd_blhd(q, k, v, g, lse, delta, scale, causal, block_k,
                               window)
    do = g.to(q.dtype).contiguous()
    dq = flash_bwd_dq(q, k, v, do, lse, delta, scale, causal, window)
    dk, dv = flash_bwd_dkv(q, k, v, do, lse, delta, scale, causal, window)
    return dq, dk, dv


class _FlashAttention(torch.autograd.Function):
    """(o, lse) with the flash backward; the lse cotangent folds into delta."""

    @staticmethod
    def forward(ctx, q, k, v, scale, causal, block_k, window, backward):
        o, lse = flash_fwd(q, k, v, scale, causal, window)
        ctx.save_for_backward(q, k, v, o, lse)
        ctx.args = (scale, causal, block_k, window, backward)
        ctx.set_materialize_grads(False)
        return o, lse

    @staticmethod
    def backward(ctx, g_o, g_lse):
        q, k, v, o, lse = ctx.saved_tensors
        scale, causal, block_k, window, backward = ctx.args
        if g_o is None:
            g_o = torch.zeros_like(o)
        dq, dk, dv = _dispatch_bwd(q, k, v, o, lse, g_o, scale, causal, block_k,
                                   g_lse, window, backward)
        return dq, dk, dv, None, None, None, None, None


def _prepare(q, k, v, causal, scale, block_k, window, backward):
    b, l, h, d = q.shape
    hkv = k.shape[2]
    if h % hkv or v.shape[2] != hkv:
        raise ValueError(f"incompatible heads: q {tuple(q.shape)}, k {tuple(k.shape)}, "
                         f"v {tuple(v.shape)}")
    w = int(window) if window else 0
    if w < 0:
        raise ValueError("window must be non-negative (None/0 = unlimited)")
    if w and not causal:
        raise ValueError("sliding window requires causal attention")
    if backward not in (None, "pallas", "xla"):
        raise ValueError(f"backward must be 'pallas' or 'xla', got {backward!r}")
    scale = scale if scale is not None else 1.0 / (d ** 0.5)
    return scale, min(block_k, max(8, l)), w


def flash_attention_with_lse(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    causal: bool = True,
    scale: Optional[float] = None,
    block_q: int = 128,
    block_k: int = 128,
    window: Optional[int] = None,
    backward: Optional[str] = None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Fused attention also returning the row log-sum-exp.

    Returns (o [B, L, H, D] in q's dtype, lse [B, H, L] f32); both are
    differentiable.  k/v may carry Hkv < H heads (GQA).  `window` (causal
    only) limits each query to the last `window` positions.  `backward`:
    None or "pallas" take the CUDA kernels on a card, "xla" the plain
    blocked backward.  `block_q`/`block_k` are the TPU kernels' tile
    sizes: the CUDA kernels use their own 64-row tiles, and `block_k`
    sets the plain blocked backward's key block.
    """
    del block_q
    scale, bk, w = _prepare(q, k, v, causal, scale, block_k, window, backward)
    return _FlashAttention.apply(q, k, v, scale, causal, bk, w, backward)


def flash_attention(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    causal: bool = True,
    scale: Optional[float] = None,
    block_q: int = 128,
    block_k: int = 128,
    window: Optional[int] = None,
    backward: Optional[str] = None,
) -> torch.Tensor:
    """Fused attention, [B, L, H, D] -> [B, L, H, D] in q's dtype (see
    flash_attention_with_lse)."""
    return flash_attention_with_lse(q, k, v, causal, scale, block_q, block_k,
                                    window, backward)[0]
