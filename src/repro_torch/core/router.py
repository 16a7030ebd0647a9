"""Top-k MoE router (port of ``repro/core/router.py::route_topk``)."""
from __future__ import annotations

from typing import NamedTuple

import torch


class RouterOutput(NamedTuple):
    assign: torch.Tensor   # [T, k] int32 expert ids
    gates: torch.Tensor    # [T, k] f32 gate weights (sum to 1 across k)
    counts: torch.Tensor   # [Ep] int32 histogram of assignments
    aux_loss: torch.Tensor # load-balance auxiliary loss (0-d f32)


def route_topk(x: torch.Tensor, w_router: torch.Tensor, *, top_k: int,
               num_real_experts: int) -> RouterOutput:
    """x [T, d], w_router [d, Ep] -> top-k assignment with f32 logits.

    ``jax.lax.top_k`` keeps the lower expert id among equal logits;
    ``torch.topk`` promises no order on ties, so the top k come from a
    *stable* descending sort, which keeps equal logits in id order.
    Padded experts past ``num_real_experts`` are masked to -inf."""
    T = x.shape[0]
    Ep = w_router.shape[1]
    logits = x.float() @ w_router.float()
    mask = torch.arange(Ep, device=x.device) >= num_real_experts
    logits = logits.masked_fill(mask[None, :], float("-inf"))
    vals, idx = torch.sort(logits, dim=-1, descending=True, stable=True)
    top_vals, assign = vals[:, :top_k], idx[:, :top_k].to(torch.int32)
    gates = torch.softmax(top_vals, dim=-1)
    counts = torch.bincount(assign.reshape(-1).long(),
                            minlength=Ep)[:Ep].to(torch.int32)
    probs = torch.softmax(logits, dim=-1)
    f = counts.float() / max(T * top_k, 1)
    p = probs.mean(dim=0)
    aux = num_real_experts * torch.sum(f * p)
    return RouterOutput(assign, gates, counts, aux)
