"""Flagship decoder-only transformer LM, training path
(counterpart of kungfu_tpu.models.transformer).

Same configuration knobs, parameter names and mixed precision as the flax
model, so weights converted by `convert.params_from_flax` give the same
logits, loss and gradients:

  parameters    f32
  Dense         input, kernel and bias cast to cfg.dtype; output cfg.dtype
  Embed         returns cfg.dtype
  norms         computed and returned in f32 (LayerNorm has no bias)
  residuals     cfg.dtype
  head          f32 (tied or not)
  lm_loss       f32 mean over B * (L - 1) positions

Parameter names follow the flax tree with torch's layout (Dense.kernel
[in, out] becomes `weight` [out, in]; MLP "in" becomes `in_`).

attention="ring" or "ulysses" with a mesh (`plan.make_mesh(..., sp=n)`)
is sequence parallelism: each rank of an sp group holds one chunk of the
sequence (`trainer.MeshTrainer.shard_batch`), rotary or learned positions
start at its chunk's absolute offset, and attention is
`parallel.ring_attention` over the sp group (K/V rotating around the
ring) or `parallel.ulysses_attention` (the all_to_all to a head group over
the whole sequence, on the flash kernels).  Its loss is `lm_loss_shard`,
or `lm_loss_shard_chunked` with head="hidden": this rank's share of the
global mean.

head="hidden" returns ln_f's hidden states (f32) instead of logits, with
the same parameters as head="dense", and `lm_loss_chunked` streams the
head product and its log-softmax over vocab blocks (`ops.chunked_ce`): no
[B, L, V] logits.  Dropout (`dropout` > 0) applies after the embedding
and on each residual branch, as in the flax model, only under
`forward(tokens, train=True, generator=g)`, and draws its masks from the
explicit torch.Generator g (never from `nn.Module.training`, which is
True by default where the flax model defaults to train=False).  `remat`
checkpoints each block: remat_policy "none"/"full" recomputes the whole
block in the backward, "dots" keeps the outputs of its matrix products
(aten mm, addmm, bmm) and recomputes the rest, the counterpart of
jax.checkpoint_policies.dots_saveable; a block under dropout recomputes
the same masks from the generator state it started with.

Decode and generate and MoE wait for later slices and raise
NotImplementedError when configured.
"""
from __future__ import annotations

import dataclasses
import functools
from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn
from torch.utils.checkpoint import (CheckpointPolicy, checkpoint,
                                    create_selective_checkpoint_contexts)

from ..compat import kernel_mode, resolve_device
from ..ops.chunked_ce import chunked_lm_head_ll
from ..ops.flash import flash_attention
from ..parallel.ring_attention import full_attention, ring_attention
from ..parallel.ulysses import ulysses_attention
from ..plan.mesh import Mesh


# The flagship GPT: config 9 of the JAX package's benchmarks
# (kungfu_tpu/benchmarks/baseline_matrix.py config_gpt_mfu), LayerNorm,
# GELU and an untied head by default.
FLAGSHIP_GPT = dict(vocab_size=32000, d_model=1024, n_layers=24, n_heads=16, d_ff=4096,
                    max_len=2048, causal=True, rope=True)


@dataclasses.dataclass(frozen=True)
class TransformerConfig:
    vocab_size: int = 32000
    d_model: int = 512
    n_layers: int = 8
    n_heads: int = 8
    d_ff: int = 2048
    max_len: int = 2048
    dtype: torch.dtype = torch.bfloat16
    # "auto" = flash on a card, full on the CPU; "flash" | "full" | "ring" | "ulysses"
    attention: str = "auto"
    causal: bool = True
    # grouped-query attention: number of K/V heads (0 = n_heads)
    n_kv_heads: int = 0
    rope: bool = False
    rope_theta: float = 10000.0
    # sliding window: 0 = unlimited (requires causal; flash/full paths)
    window: int = 0
    # flash tile sizes (None = 128); see ops.flash.flash_attention_with_lse
    flash_block_q: Optional[int] = None
    flash_block_k: Optional[int] = None
    # flash backward arm: None/"pallas" = the CUDA kernels, "xla" = plain
    flash_backward: Optional[str] = None
    ffn: str = "gelu"  # "gelu" | "swiglu"
    norm: str = "layer"  # "layer" | "rms"
    norm_eps: float = 1e-6
    attention_bias: bool = False
    dropout: float = 0.0
    tie_embeddings: bool = False
    # checkpoint each block (torch.utils.checkpoint); policy "none"/"full"
    # recomputes it all, "dots" keeps the matrix products' outputs
    remat: bool = False
    remat_policy: str = "none"
    # "dense": forward returns [B, L, V] logits; "hidden": ln_f's hidden
    # states, for lm_loss_chunked (the same parameters either way)
    head: str = "dense"
    n_experts: int = 0
    # the rank mesh attention="ring"/"ulysses" splits the sequence over (its sp_axis)
    mesh: Optional[Mesh] = None
    sp_axis: str = "sp"
    decode: bool = False

    def __post_init__(self):
        if self.d_model % self.n_heads:
            raise ValueError("d_model must be a multiple of n_heads")
        if self.n_kv_heads and self.n_heads % self.n_kv_heads:
            raise ValueError("query heads must be a multiple of kv heads")
        if self.rope and (self.d_model // self.n_heads) % 2:
            raise ValueError("rope rotates feature pairs: head_dim must be even")
        if self.window:
            if self.window < 0 or not self.causal:
                raise ValueError("window must be positive and needs causal attention")
            if self.attention not in ("auto", "flash", "full"):
                raise ValueError("sliding window is supported on the flash/full paths")
        for name, value, allowed in (
            ("attention", self.attention, ("auto", "flash", "full", "ring", "ulysses")),
            ("ffn", self.ffn, ("gelu", "swiglu")),
            ("norm", self.norm, ("layer", "rms")),
            ("remat_policy", self.remat_policy, ("none", "full", "dots")),
            ("flash_backward", self.flash_backward, (None, "pallas", "xla")),
            ("head", self.head, ("dense", "hidden")),
        ):
            if value not in allowed:
                raise ValueError(f"{name}={value!r}, expected one of {allowed}")
        if not 0.0 <= self.dropout <= 1.0:
            raise ValueError(f"dropout={self.dropout} is not a rate in [0, 1]")
        later = [
            (self.decode, "decode"),
            (self.n_experts > 0, "MoE (n_experts)"),
        ]
        for configured, what in later:
            if configured:
                raise NotImplementedError(f"{what} is not ported yet (see ROADMAP.md)")

    @property
    def kv_heads(self) -> int:
        return self.n_kv_heads or self.n_heads

    @property
    def sequence_parallel(self) -> bool:
        """Ring or Ulysses attention over the mesh's sp axis: each rank
        holds one chunk of the sequence.  (attention="ring" or "ulysses"
        without a mesh that has the axis is full attention, as in the JAX
        package.)"""
        return (self.attention in ("ring", "ulysses") and self.mesh is not None
                and self.sp_axis in self.mesh.axis_names)

    def position_offset(self, chunk: int) -> int:
        """Absolute position of this rank's first row for a chunk of
        `chunk` positions (0 without sequence parallelism)."""
        return self.mesh.coord(self.sp_axis) * chunk if self.sequence_parallel else 0


def _attention_kind(cfg: TransformerConfig, device) -> str:
    """"auto" resolves through the kernel gate: flash where the kernels
    run (a card), full attention where they do not (the CPU)."""
    if cfg.attention != "auto":
        return cfg.attention
    return "flash" if kernel_mode(device) == "kernel" else "full"


def apply_rope(x: torch.Tensor, positions: torch.Tensor, theta: float) -> torch.Tensor:
    """Rotary embedding on [B, L, H, D] with positions [L] or [B, L]:
    rotates the halves (x[..., :D/2], x[..., D/2:]) in f32, casts back."""
    half = x.shape[-1] // 2
    freqs = 1.0 / (theta ** (torch.arange(half, dtype=torch.float32, device=x.device) / half))
    ang = positions.float()[..., None] * freqs
    cos = torch.cos(ang)[..., :, None, :]
    sin = torch.sin(ang)[..., :, None, :]
    xf = x.float()
    x1, x2 = xf[..., :half], xf[..., half:]
    return torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos], dim=-1).to(x.dtype)


class Dense(nn.Module):
    """flax Dense: input, weight and bias cast to `dtype` before the product."""

    def __init__(self, in_features: int, out_features: int, dtype: torch.dtype,
                 bias: bool, device: torch.device):
        super().__init__()
        self.dtype = dtype
        self.weight = nn.Parameter(torch.empty(out_features, in_features, device=device))
        self.bias = nn.Parameter(torch.zeros(out_features, device=device)) if bias else None

    def forward(self, x):
        b = None if self.bias is None else self.bias.to(self.dtype)
        return F.linear(x.to(self.dtype), self.weight.to(self.dtype), b)


class Norm(nn.Module):
    """flax LayerNorm (no bias, fast variance) or RMSNorm, computed in f32."""

    def __init__(self, cfg: TransformerConfig, device: torch.device):
        super().__init__()
        self.rms = cfg.norm == "rms"
        self.eps = cfg.norm_eps
        self.scale = nn.Parameter(torch.ones(cfg.d_model, device=device))

    def forward(self, x):
        xf = x.float()
        mu2 = (xf * xf).mean(dim=-1, keepdim=True)
        if self.rms:
            return xf * (torch.rsqrt(mu2 + self.eps) * self.scale)
        mu = xf.mean(dim=-1, keepdim=True)
        var = torch.clamp(mu2 - mu * mu, min=0.0)
        return (xf - mu) * (torch.rsqrt(var + self.eps) * self.scale)


class Attention(nn.Module):
    def __init__(self, cfg: TransformerConfig, device: torch.device):
        super().__init__()
        self.cfg = cfg
        hd = cfg.d_model // cfg.n_heads
        kv = cfg.kv_heads * hd
        ab = cfg.attention_bias
        self.q = Dense(cfg.d_model, cfg.d_model, cfg.dtype, ab, device)
        self.k = Dense(cfg.d_model, kv, cfg.dtype, ab, device)
        self.v = Dense(cfg.d_model, kv, cfg.dtype, ab, device)
        self.out = Dense(cfg.d_model, cfg.d_model, cfg.dtype, False, device)

    def forward(self, x):
        cfg = self.cfg
        B, L, _ = x.shape
        H, Hkv, D = cfg.n_heads, cfg.kv_heads, cfg.d_model // cfg.n_heads
        q = self.q(x).view(B, L, H, D)
        k = self.k(x).view(B, L, Hkv, D)
        v = self.v(x).view(B, L, Hkv, D)
        if cfg.rope:
            pos = cfg.position_offset(L) + torch.arange(L, device=x.device)
            q = apply_rope(q, pos, cfg.rope_theta)
            k = apply_rope(k, pos, cfg.rope_theta)
        if cfg.sequence_parallel and cfg.attention == "ulysses":
            o = ulysses_attention(q, k, v, group=cfg.mesh.group(cfg.sp_axis), causal=cfg.causal,
                                  attn_fn=functools.partial(
                                      flash_attention, block_q=cfg.flash_block_q or 128,
                                      block_k=cfg.flash_block_k or 128,
                                      backward=cfg.flash_backward))
        elif cfg.sequence_parallel:
            o = ring_attention(q, k, v, group=cfg.mesh.group(cfg.sp_axis), causal=cfg.causal)
        elif _attention_kind(cfg, x.device) == "flash":
            o = flash_attention(q, k, v, causal=cfg.causal, window=cfg.window or None,
                                block_q=cfg.flash_block_q or 128,
                                block_k=cfg.flash_block_k or 128,
                                backward=cfg.flash_backward)
        else:
            o = full_attention(q, k, v, causal=cfg.causal, window=cfg.window or None)
        return self.out(o.reshape(B, L, cfg.d_model))


class MLP(nn.Module):
    def __init__(self, cfg: TransformerConfig, device: torch.device):
        super().__init__()
        self.swiglu = cfg.ffn == "swiglu"
        self.in_ = Dense(cfg.d_model, cfg.d_ff, cfg.dtype, False, device)
        if self.swiglu:
            self.gate = Dense(cfg.d_model, cfg.d_ff, cfg.dtype, False, device)
        self.out = Dense(cfg.d_ff, cfg.d_model, cfg.dtype, False, device)

    def forward(self, x):
        h = self.in_(x)
        if self.swiglu:
            h = F.silu(self.gate(x)) * h
        else:
            h = F.gelu(h, approximate="tanh")  # flax nn.gelu's default
        return self.out(h)


def dropout(x: torch.Tensor, rate: float, generator: Optional[torch.Generator]) -> torch.Tensor:
    """flax nn.Dropout: each element kept with probability 1 - rate and
    scaled by 1 / (1 - rate), else zero (all zero at rate 1); the mask is
    drawn from `generator` (None: no dropout)."""
    if generator is None or rate == 0.0:
        return x
    if rate == 1.0:
        return torch.zeros_like(x)
    keep = torch.rand(x.shape, generator=generator, device=x.device) >= rate
    return torch.where(keep, x / (1.0 - rate), torch.zeros((), dtype=x.dtype, device=x.device))


class Block(nn.Module):
    def __init__(self, cfg: TransformerConfig, device: torch.device):
        super().__init__()
        self.rate = cfg.dropout
        self.ln1 = Norm(cfg, device)
        self.attn = Attention(cfg, device)
        self.ln2 = Norm(cfg, device)
        self.mlp = MLP(cfg, device)

    def forward(self, x, generator: Optional[torch.Generator] = None):
        """`generator`: dropout on both residual branches from it (None:
        no dropout)."""
        x = x + dropout(self.attn(self.ln1(x)), self.rate, generator)
        return x + dropout(self.mlp(self.ln2(x)), self.rate, generator)


_DOTS = (torch.ops.aten.mm.default, torch.ops.aten.addmm.default, torch.ops.aten.bmm.default)


def _dots_saveable(ctx, op, *args, **kwargs):
    """remat_policy="dots": keep what the matrix products return,
    recompute everything else."""
    return CheckpointPolicy.MUST_SAVE if op in _DOTS else CheckpointPolicy.PREFER_RECOMPUTE


def _block_from_state(block: Block, x: torch.Tensor, rng_state: Optional[torch.Tensor]):
    """The block under a checkpoint: its dropout generator made from
    `rng_state`, so that the recompute draws the masks the forward drew;
    returns (output, the generator's state after the block)."""
    if rng_state is None:
        return block(x), None
    gen = torch.Generator(device=x.device)
    gen.set_state(rng_state)
    return block(x, gen), gen.get_state()


class Embed(nn.Module):
    def __init__(self, cfg: TransformerConfig, device: torch.device):
        super().__init__()
        self.embedding = nn.Parameter(torch.empty(cfg.vocab_size, cfg.d_model, device=device))

    def forward(self, tokens, dtype):
        return F.embedding(tokens, self.embedding).to(dtype)


class _Head(nn.Module):
    """lm_head: f32 logits = f32 hidden @ weight^T, weight [vocab, d_model]."""

    def __init__(self, cfg: TransformerConfig, device: torch.device):
        super().__init__()
        self.weight = nn.Parameter(torch.empty(cfg.vocab_size, cfg.d_model, device=device))

    def forward(self, x):
        return F.linear(x.float(), self.weight)


class TransformerLM(nn.Module):
    """tokens [B, L] (int64) -> logits [B, L, vocab] (f32).

    Parameters are made on `device` ("cuda" unless the caller says "cpu")
    and drawn from `generator` (a fresh one seeded 0 on that device when
    None): normal(0, 0.02) for projections and embeddings, ones for norm
    scales, zeros for biases, as the flax initializers do."""

    def __init__(self, cfg: TransformerConfig, device=None,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.cfg = cfg
        dev = resolve_device(device)
        self.embed = Embed(cfg, dev)
        if not cfg.rope:
            self.pos_embed = nn.Parameter(torch.empty(cfg.max_len, cfg.d_model, device=dev))
        for i in range(cfg.n_layers):
            self.add_module(f"block_{i}", Block(cfg, dev))
        self.ln_f = Norm(cfg, dev)
        if not cfg.tie_embeddings:
            self.lm_head = _Head(cfg, dev)
        if generator is None:
            generator = torch.Generator(device=dev).manual_seed(0)
        self._init_weights(generator)

    @torch.no_grad()
    def _init_weights(self, generator: torch.Generator) -> None:
        for name, p in self.named_parameters():
            if name.endswith(".scale"):
                p.fill_(1.0)
            elif name.endswith(".bias"):
                p.zero_()
            else:
                p.normal_(0.0, 0.02, generator=generator)

    def blocks(self):
        return [getattr(self, f"block_{i}") for i in range(self.cfg.n_layers)]

    def head_weight(self) -> torch.Tensor:
        """The head's [vocab, d_model] weight: the embedding when tied."""
        return self.embed.embedding if self.cfg.tie_embeddings else self.lm_head.weight

    def forward(self, tokens: torch.Tensor, train: bool = False,
                generator: Optional[torch.Generator] = None) -> torch.Tensor:
        """Logits [B, L, vocab] f32 (head="hidden": ln_f's hidden states
        [B, L, d_model] f32).  Dropout runs only with train=True, drawing
        from `generator`, which it then requires."""
        cfg = self.cfg
        if not (train and cfg.dropout > 0):
            generator = None
        elif generator is None:
            raise ValueError("dropout under train=True draws from an explicit torch.Generator: "
                             "pass generator=")
        L = tokens.shape[1]
        x = self.embed(tokens, cfg.dtype)
        if not cfg.rope:
            off = cfg.position_offset(L)
            x = x + self.pos_embed[None, off:off + L].to(cfg.dtype)
        x = dropout(x, cfg.dropout, generator)
        context = {}
        if cfg.remat and cfg.remat_policy == "dots":
            context["context_fn"] = functools.partial(create_selective_checkpoint_contexts,
                                                      _dots_saveable)
        for block in self.blocks():
            if not cfg.remat:
                x = block(x, generator)
                continue
            state = None if generator is None else generator.get_state()
            x, state = checkpoint(_block_from_state, block, x, state, use_reentrant=False,
                                  **context)
            if generator is not None:
                generator.set_state(state)
        x = self.ln_f(x)
        if cfg.head == "hidden":
            return x
        if cfg.tie_embeddings:
            return F.linear(x.float(), self.embed.embedding.float())
        return self.lm_head(x)


def _token_ll(logits: torch.Tensor, targets: torch.Tensor):
    """Per-token log-likelihood (f32) and the log normalizer log Z."""
    lg = logits.float()
    log_z = torch.logsumexp(lg, dim=-1)
    ll = lg.gather(-1, targets[..., None])[..., 0] - log_z
    return ll, log_z


def lm_loss(logits: torch.Tensor, tokens: torch.Tensor, z_loss: float = 0.0) -> torch.Tensor:
    """Next-token cross entropy, mean over all positions; `z_loss` adds
    z_loss * mean(log Z^2)."""
    ll, log_z = _token_ll(logits[:, :-1], tokens[:, 1:])
    loss = -ll.mean()
    if z_loss:
        loss = loss + z_loss * (log_z ** 2).mean()
    return loss


def lm_loss_chunked(model: TransformerLM, tokens: torch.Tensor, block: Optional[int] = None,
                    z_loss: float = 0.0, train: bool = False,
                    generator: Optional[torch.Generator] = None) -> torch.Tensor:
    """`lm_loss` without [B, L, V] logits, for a model with head="hidden":
    its hidden states h[:, :-1] against targets tokens[:, 1:] through
    `ops.chunked_ce.chunked_lm_head_ll` over the (tied or untied) head
    weight; `block=None` resolves the vocab block there (KFT_CE_BLOCK, then
    the footprint default).  `train`/`generator` pass to the forward
    (dropout)."""
    if model.cfg.head != "hidden":
        raise ValueError('lm_loss_chunked needs TransformerConfig(head="hidden")')
    h = model(tokens, train=train, generator=generator)
    d = h.shape[-1]
    ll, log_z = chunked_lm_head_ll(h[:, :-1].reshape(-1, d), model.head_weight(),
                                   tokens[:, 1:].reshape(-1), block)
    loss = -ll.mean()
    if z_loss:
        loss = loss + z_loss * (log_z ** 2).mean()
    return loss


def lm_loss_shard(logits: torch.Tensor, targets: torch.Tensor, count: int) -> torch.Tensor:
    """This rank's share of `lm_loss` over a batch split across ranks:
    the sum of its next-token losses over `count`, the targets of the
    whole batch (B * (L - 1)).  `targets` [B_shard, L_chunk] holds each
    position's next token, -1 where the sequence ends.  The shares of all
    ranks sum to `lm_loss` of the whole batch, and their gradients to its
    gradient."""
    ll, _ = _token_ll(logits, targets.clamp_min(0))
    return -torch.where(targets >= 0, ll, 0.0).sum() / count


def lm_loss_shard_chunked(model: TransformerLM, tokens: torch.Tensor, targets: torch.Tensor,
                          count: int, block: Optional[int] = None, train: bool = False,
                          generator: Optional[torch.Generator] = None) -> torch.Tensor:
    """`lm_loss_shard` without logits, for a model with head="hidden":
    this shard's hidden states against its `targets` (-1 where a sequence
    ends) through `ops.chunked_ce.chunked_lm_head_ll`, summed and divided
    by `count`, the targets of the whole batch.  The shares of all ranks
    sum to `lm_loss_chunked` of the whole batch.  `train`/`generator` pass
    to the forward (dropout)."""
    if model.cfg.head != "hidden":
        raise ValueError('lm_loss_shard_chunked needs TransformerConfig(head="hidden")')
    h = model(tokens, train=train, generator=generator)
    ll, _ = chunked_lm_head_ll(h.reshape(-1, h.shape[-1]), model.head_weight(),
                               targets.clamp_min(0).reshape(-1), block)
    return -torch.where(targets.reshape(-1) >= 0, ll, 0.0).sum() / count
