"""Top-k MoE router and the paper's synthetic expert-popularity skew
(port of ``repro/core/router.py``: ``route_topk``, ``route_skewed``).

Synthetic skew (paper §5.1.2): the ``n_hot`` hot experts share probability
mass ``alpha``, the other real experts share ``1 - alpha`` evenly, padded
experts get none, and every unit draws its expert from that multinomial.
``jax.random.categorical``'s stream cannot be reproduced in torch, so the
draws come from a ``torch.Generator`` that the caller derives from a
``SkewKey``: the same key path gives the same assignment wherever the rank
runs (a virtual rank or a process of its own) on one device type.

A captured decode step cannot seed generators, so the serve engine draws
each step's skewed assignments before it replays the step
(``skew_draw``, the same draws on the same generators as
``route_skewed``) and the step routes on them (``route_assigned``).
Counts are a scatter-add into fixed bins (``expert_counts``), never
``bincount``, which sizes its output from the data's maximum on the host.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import NamedTuple, Tuple

import numpy as np
import torch


class RouterOutput(NamedTuple):
    assign: torch.Tensor   # [T, k] int32 expert ids
    gates: torch.Tensor    # [T, k] f32 gate weights (sum to 1 across k)
    counts: torch.Tensor   # [Ep] int32 histogram of assignments
    aux_loss: torch.Tensor # load-balance auxiliary loss (0-d f32)


def expert_counts(values: torch.Tensor, bins: int) -> torch.Tensor:
    """int32 histogram [bins] of ``values`` (any shape, each in
    [0, bins)): ``bincount(values, minlength=bins)`` as a scatter-add into
    zero bins, so the output's size never depends on the data."""
    flat = values.reshape(-1).long()
    ones = torch.ones(flat.shape, dtype=torch.int32, device=flat.device)
    return torch.zeros((bins,), dtype=torch.int32,
                       device=flat.device).scatter_add_(0, flat, ones)


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
    counts = expert_counts(assign, Ep)
    probs = torch.softmax(logits, dim=-1)
    f = counts.float() / max(T * top_k, 1)
    p = probs.mean(dim=0)
    aux = num_real_experts * torch.sum(f * p)
    return RouterOutput(assign, gates, counts, aux)


@dataclass(frozen=True)
class SkewKey:
    """A path of ints standing in for a ``jax.random`` key:
    ``fold_in`` appends to the path, and ``generator`` seeds a
    ``torch.Generator`` from a hash of the whole path (numpy's
    ``SeedSequence``), so sibling paths draw independent streams."""
    path: Tuple[int, ...]

    def fold_in(self, i: int) -> "SkewKey":
        return SkewKey(self.path + (int(i),))

    def generator(self, device) -> torch.Generator:
        seed = np.random.SeedSequence(
            [p % 2 ** 64 for p in self.path]).generate_state(2, np.uint32)
        return torch.Generator(device=device).manual_seed(
            (int(seed[0]) << 31) ^ int(seed[1]))


def skew_probs(num_experts: int, padded_experts: int, alpha: float,
               n_hot: int, device) -> torch.Tensor:
    """The synthetic skew's expert distribution [padded_experts] f32."""
    e = torch.arange(padded_experts, device=device)
    p_hot = alpha / n_hot
    p_cold = (1.0 - alpha) / max(num_experts - n_hot, 1)
    return torch.where(e < n_hot, p_hot,
                       torch.where(e < num_experts, p_cold, 0.0)).float()


def skew_draw(gen: torch.Generator, probs: torch.Tensor, T: int,
              top_k: int) -> torch.Tensor:
    """T tokens x top_k draws from ``probs`` on ``gen`` -> int32 [T, top_k]
    (with replacement, as ``jax.random.categorical``)."""
    return torch.multinomial(probs, T * top_k, replacement=True,
                             generator=gen).reshape(T, top_k).to(torch.int32)


def route_assigned(assign: torch.Tensor, padded_experts: int) -> RouterOutput:
    """The skew router's output for drawn assignments [T, top_k]: gates
    1/top_k, the aux loss 0."""
    T, top_k = assign.shape
    gates = torch.full((T, top_k), 1.0 / top_k, dtype=torch.float32,
                       device=assign.device)
    return RouterOutput(assign, gates, expert_counts(assign, padded_experts),
                        torch.zeros((), dtype=torch.float32,
                                    device=assign.device))


def route_skewed(gen: torch.Generator, T: int, *, top_k: int,
                 num_experts: int, padded_experts: int, alpha: float,
                 n_hot: int = 1) -> RouterOutput:
    """Paper §5.1.2 synthetic skew router: T tokens x top_k draws (with
    replacement, as ``jax.random.categorical``) on ``gen``'s device; gates
    are 1/top_k and the aux loss is 0."""
    probs = skew_probs(num_experts, padded_experts, alpha, n_hot, gen.device)
    return route_assigned(skew_draw(gen, probs, T, top_k), padded_experts)
