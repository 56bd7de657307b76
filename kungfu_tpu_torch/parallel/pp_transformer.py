"""PipelinedLM: the flagship transformer over a pp (x dp) mesh
(counterpart of kungfu_tpu/parallel/pp_transformer.py).

The block stack runs through the circular or GPipe schedule of
`parallel/pp.py`; embedding and head are computed outside the pipe:

  embed + positions   on every stage, for the rank's rows (its dp shard);
                      stage 0 feeds them in, their gradient summed over pp
  n_layers blocks     cut into S R layer groups of Lg = n_layers / (S R);
                      stage s holds groups {r S + s : r < R}: its round-r
                      group is model layers (r S + s) Lg .. + Lg - 1, as
                      `blocks.<r>.<j>` (entry [s, r, j] of the JAX model's
                      `blocks` leaves, stacked [S, R, Lg, ...])
  final norm + head   on every stage, on the last stage's outputs: an f32
                      LayerNorm (mean, the mean squared deviation, eps
                      1e-6) and the f32 head, as the JAX `apply` computes
                      them; every stage's head gradient is the whole one

Each tick's hop is one B11 call (`ops.fused_matmul.ring_shift`) over the
pp group, its backward one more; with remat=True (the default) each
layer group is checkpointed.  On a card each stage runs its blocks on the
flash kernels: R M layer groups a step, each of Lg blocks (B1, B2, B3
once a block, B1 once more under remat).

As in the JAX package: dense blocks only (n_experts > 0 raises),
attention "auto", "flash" or "full" (ring and Ulysses attention raise),
no tied embeddings (the table is read at stage 0 and the head applied at
the last), n_layers a multiple of S R, microbatches >= S when repeats >
1, and the rank's rows a multiple of the microbatches.  A mesh that also
splits tp or sp raises NotImplementedError (ROADMAP A.6b).
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn

from ..compat import resolve_device
from ..models.transformer import Block, Embed, Norm, TransformerConfig, _Head
from .pp import pipeline_spmd


class PipelinedLM(nn.Module):
    """Pipeline-parallel TransformerLM: tokens [B_dp, L] -> logits
    [B_dp, L, vocab] f32 on every stage of the pp group.  Parameters are
    made as `TransformerLM` makes them (normal(0, 0.02), norm scales one)
    from `generator`, at this stage's shapes; `convert.shard_state_dict`
    cuts a whole model's weights to them."""

    vocab_group = None  # the logits are whole

    def __init__(self, cfg: TransformerConfig, stages: Optional[int] = None, repeats: int = 1,
                 microbatches: int = 4, remat: bool = True, pp_axis: str = "pp", device=None,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        mesh = cfg.mesh
        if mesh is None or pp_axis not in mesh.axis_names:
            raise ValueError(f"PipelinedLM needs a mesh with a {pp_axis!r} axis")
        if cfg.n_experts > 0:
            raise ValueError("PipelinedLM supports dense blocks only (no MoE)")
        if cfg.attention in ("ring", "ulysses"):
            raise ValueError(f"{cfg.attention} attention cannot run inside the pipeline; use "
                             "attention='auto'/'flash'/'full'")
        later = [a for a in ("tp", "sp") if mesh.shape.get(a, 1) > 1]
        if later:
            raise NotImplementedError(f"pp with {' and '.join(later)} is not ported yet "
                                      "(ROADMAP A.6b)")
        self.S = stages if stages is not None else mesh.shape[pp_axis]
        if self.S != mesh.shape[pp_axis]:
            raise ValueError(f"stages={self.S} must equal the mesh's {pp_axis} size "
                             f"({mesh.shape[pp_axis]})")
        self.R, self.M, self.remat, self.pp_axis = repeats, microbatches, remat, pp_axis
        if cfg.n_layers % (self.S * self.R):
            raise ValueError(f"n_layers={cfg.n_layers} must divide into S*R={self.S * self.R} "
                             "groups")
        if cfg.tie_embeddings:
            raise ValueError("tie_embeddings is not supported under pipeline parallelism: the "
                             "embedding lives on the first stage and the head on the last; use "
                             "an untied lm_head")
        self.cfg = cfg
        self.layers_per_group = cfg.n_layers // (self.S * self.R)
        # the blocks run inside the pipeline: no mesh of their own
        block_cfg = dataclasses.replace(cfg, mesh=None)
        dev = resolve_device(device)
        self.embed = Embed(block_cfg, dev)
        if not cfg.rope:
            self.pos_embed = nn.Parameter(torch.empty(cfg.max_len, cfg.d_model, device=dev))
        self.blocks = nn.ModuleList(
            nn.ModuleList(Block(block_cfg, dev) for _ in range(self.layers_per_group))
            for _ in range(self.R))
        self.ln_f = Norm(block_cfg, dev)
        self.lm_head = _Head(block_cfg, dev)
        if generator is None:
            generator = torch.Generator(device=dev).manual_seed(0)
        with torch.no_grad():
            for name, p in self.named_parameters():
                if name.endswith(".scale"):
                    p.fill_(1.0)
                elif name.endswith(".bias"):
                    p.zero_()
                else:
                    p.normal_(0.0, 0.02, generator=generator)

    @property
    def group(self):
        """The pp process group (None without a process group)."""
        return self.cfg.mesh.group(self.pp_axis)

    @staticmethod
    def _run_group(blocks: nn.ModuleList, h: torch.Tensor) -> torch.Tensor:
        for block in blocks:
            h = block(h)
        return h

    def forward(self, tokens: torch.Tensor) -> torch.Tensor:
        cfg = self.cfg
        B, L = tokens.shape
        if B % self.M or B < self.M:
            raise ValueError(f"this rank's batch {B} must be a (nonzero) multiple of "
                             f"microbatches={self.M}")
        x = self.embed(tokens, cfg.dtype)
        if not cfg.rope:
            x = x + self.pos_embed[None, :L].to(cfg.dtype)
        xs = x.reshape((self.M, B // self.M) + x.shape[1:])
        x = pipeline_spmd(self._run_group, list(self.blocks), xs, self.group, self.R,
                          self.remat).reshape(x.shape)
        xf = x.float()
        mean = xf.mean(dim=-1, keepdim=True)
        var = ((xf - mean) ** 2).mean(dim=-1, keepdim=True)
        xf = (xf - mean) / torch.sqrt(var + 1e-6) * self.ln_f.scale
        return F.linear(xf, self.lm_head.weight)
