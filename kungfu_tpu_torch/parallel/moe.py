"""Mixture of experts with expert parallelism (counterpart of
kungfu_tpu/parallel/moe.py).

`MoEMLP` is the JAX module's top-1 Switch routing, step for step: an f32
router, softmax, the argmax expert and its probability as the gate, each
token's position within its expert by a cumulative count in token order,
a capacity of max(1, int(capacity_factor * tokens / n_experts)) beyond
which tokens are dropped (their MoE output is zero), gelu experts
without bias, the gate-weighted combine, and the load-balancing loss
n_experts * sum_e f_e p_e (f_e the share of tokens routed to e, p_e the
mean router probability of e) with the share of tokens dropped.  The JAX
module sows the last two (`moe_aux_loss`, `moe_dropped`); here each
forward leaves them on the module (`aux_loss`, `dropped`), and
`moe_aux_loss(model)` sums the former over a model's MoE blocks.

Dispatch is by index: the kept tokens of each of this rank's experts are
gathered into [experts, C, d_model] (C the capacity, a size known
before the routing, so no step waits on the host), run through their
expert and added back at their rows.  The JAX module
dispatches and combines through a dense [T, E, C] one-hot einsum, which
its docstring chooses for the TPU's matrix units; at the flagship's width
that is 16384 x 4 x 5120 values a MoE layer, and selects the same rows.

Experts are split over the mesh's ep axis ("expert" -> ep): rank r holds
experts [r E / ep, (r + 1) E / ep) of the router's columns, w_in and
w_out.  Tokens are replicated over ep (the batch maps to dp only), so:

  - the router's logits of this rank's columns are gathered over ep
    (`mappings.gather_from`; the backward takes this rank's columns of a
    cotangent every rank has whole);
  - each rank runs its experts on the tokens routed to them, and the
    combine's partial outputs are summed over ep (`mappings.reduce_from`);
  - the input and the gate enter through `mappings.copy_to`, so that
    their gradients, each rank's part, are summed over ep.

Routing is over the whole batch, as the JAX module's is: the capacity
counts the tokens of every data-parallel rank, each rank's positions
start after the counts of the ranks before it (an exclusive prefix over
the data group, which only shows once a token is dropped), and f_e and
p_e are means over every token, summed over the data group
(`mappings.sum_both`: each rank adds its share of the loss, so the
backward sums too).  MoE under an sp axis is refused by the model
(ROADMAP A.6b): a rank's tokens are not then a run of the token order.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from ..ops import collective as C
from . import mappings
from .sharding import axis_size, grad_axes


class MoEMLP(nn.Module):
    """Top-1 Switch MoE feed-forward over `cfg.n_experts` experts, this
    rank's n_experts / ep of them (parameters: router [d_model, E / ep]
    f32, w_in [E / ep, d_model, d_ff], w_out [E / ep, d_ff, d_model], the
    JAX module's layouts)."""

    def __init__(self, cfg, device: torch.device):
        super().__init__()
        self.cfg = cfg
        mine = cfg.n_experts // axis_size(cfg.mesh, "ep")
        self.router = nn.Parameter(torch.empty(cfg.d_model, mine, device=device))
        self.w_in = nn.Parameter(torch.empty(mine, cfg.d_model, cfg.d_ff, device=device))
        self.w_out = nn.Parameter(torch.empty(mine, cfg.d_ff, cfg.d_model, device=device))
        self.aux_loss = None  # the last forward's load-balancing loss (f32 scalar)
        self.dropped = None  # and its share of tokens dropped

    def _groups(self):
        mesh = self.cfg.mesh
        if mesh is None:
            return None, None
        ep = mesh.group("ep") if axis_size(mesh, "ep") > 1 else None
        return ep, mesh.group(grad_axes(mesh))

    def forward(self, x):
        cfg = self.cfg
        B, L, Dm = x.shape
        E, T = cfg.n_experts, B * L
        ep_group, data_group = self._groups()
        n_data = mappings.group_size(data_group)
        total = T * n_data
        capacity = max(1, int(cfg.capacity_factor * total / E))
        dt = x.dtype

        x = mappings.copy_to(x, ep_group)
        flat = x.reshape(T, Dm)
        logits = mappings.gather_from(flat.float() @ self.router, ep_group, -1)  # [T, E]
        probs = torch.softmax(logits, dim=-1)
        expert = probs.argmax(dim=-1)  # [T]
        gate = probs.gather(-1, expert[:, None])[:, 0]

        with torch.no_grad():
            onehot = F.one_hot(expert, E).float()  # [T, E]
            counts = onehot.sum(dim=0)
            before = torch.zeros_like(counts)
            if n_data > 1:  # the tokens of the data-parallel ranks before this one
                every = C.all_gather(counts, data_group)
                before = every[:mappings.group_rank(data_group)].sum(dim=0)
            pos_in_expert = (torch.cumsum(onehot, dim=0) - 1.0 + before) * onehot
            keep = (pos_in_expert < capacity) & (onehot > 0)
            pos = (pos_in_expert * keep).sum(dim=-1).long()  # [T]
            kept = keep.any(dim=-1)
            # this rank's experts: the kept tokens' rows, expert by expert,
            # at their slot (position past the earlier ranks' tokens); the
            # others go to a spare slot past the last, dropped after
            mine = self.w_in.shape[0]
            e0 = mappings.group_rank(ep_group) * mine
            local = kept & (expert >= e0) & (expert < e0 + mine)
            slot = (expert - e0) * capacity + pos - before[expert].long()
            slot = torch.where(local, slot, mine * capacity)
            slots = torch.full((mine * capacity + 1,), T, dtype=torch.long, device=x.device)
            slots[slot] = torch.arange(T, device=x.device)
            slots = slots[:-1]  # row T of `rows` is zero: an empty slot

        rows = torch.cat([flat, flat.new_zeros(1, Dm)])[slots].view(mine, capacity, Dm)
        h = F.gelu(torch.bmm(rows, self.w_in.to(dt)), approximate="tanh")
        out_e = torch.bmm(h, self.w_out.to(dt)).reshape(mine * capacity, Dm)
        weight = torch.cat([mappings.copy_to(gate, ep_group), gate.new_zeros(1)])[slots]
        combined = flat.new_zeros(T + 1, Dm).index_add(0, slots,
                                                       out_e * weight.to(dt)[:, None])
        out = mappings.reduce_from(combined[:T], ep_group).view(B, L, Dm)

        # Switch load-balancing loss E * sum_e f_e * p_e over the whole batch
        frac_tokens = mappings.reduce_from(counts, data_group) / total
        frac_probs = mappings.sum_both(probs.sum(dim=0), data_group) / total
        self.aux_loss = E * torch.sum(frac_tokens * frac_probs)
        n_kept = mappings.reduce_from(kept.sum().float(), data_group)
        self.dropped = 1.0 - n_kept / total
        return out


def moe_aux_loss(model: nn.Module) -> torch.Tensor:
    """The sum of the load-balancing losses that `model`'s MoE blocks left
    in its last forward (an f32 zero without MoE blocks)."""
    aux = [m.aux_loss for m in model.modules() if isinstance(m, MoEMLP)]
    if not aux:
        p = next(model.parameters())
        return torch.zeros((), dtype=torch.float32, device=p.device)
    return torch.stack([a.float() for a in aux]).sum()
