"""AdamW (port of ``repro/optim/adamw.py``).

JAX's arithmetic: a global-norm clip over every gradient leaf, f32
moments, bias corrections in f32 from the int32 step, and the decay on
every leaf; a parameter keeps its dtype (a bf16 leaf is updated in f32
and cast back; there are no master weights, as in JAX).  Unlike JAX's
functional update, the port updates the parameters and moments in place,
a slice of at most ``_SLICE`` elements at a time, so that its f32
temporaries stay small at full width (switch128's expert leaves are
1.81 G elements each: one f32 copy of such a leaf is 7.2 GB).
"""
from __future__ import annotations

from typing import Any, NamedTuple, Optional, Tuple

import torch

from repro_torch.tree import leaves, tree_map

_SLICE = 1 << 26          # elements a slice (256 MB of f32)


class AdamWState(NamedTuple):
    step: torch.Tensor    # 0-d int32
    m: Any
    v: Any


def adamw_init(params: Any) -> AdamWState:
    """Zero f32 moments shaped as ``params``, step 0, on the leaves'
    device."""
    def zeros(p):
        return torch.zeros(p.shape, dtype=torch.float32, device=p.device)
    dev = leaves(params)[0].device
    return AdamWState(torch.zeros((), dtype=torch.int32, device=dev),
                      tree_map(zeros, params), tree_map(zeros, params))


def _slices(t: torch.Tensor):
    flat = t.reshape(-1)
    for lo in range(0, flat.numel(), _SLICE):
        yield flat[lo:lo + _SLICE]


def _flat_view(t: torch.Tensor, what: str) -> torch.Tensor:
    if not t.is_contiguous():
        raise ValueError(f"adamw_update updates {what} in place: its "
                         f"leaves must be contiguous")
    return t


def global_norm(grads: Any) -> torch.Tensor:
    """sqrt of the sum of every gradient leaf's squares, in f32 (0-d)."""
    gl = leaves(grads)
    total = torch.zeros((), dtype=torch.float32, device=gl[0].device)
    for g in gl:
        for s in _slices(g):
            total = total + s.float().square().sum()
    return total.sqrt()


@torch.no_grad()
def adamw_update(grads: Any, state: AdamWState, params: Any, *,
                 lr: float = 3e-4, b1: float = 0.9, b2: float = 0.95,
                 eps: float = 1e-8, weight_decay: float = 0.1,
                 grad_clip: float = 1.0,
                 grad_norm: Optional[torch.Tensor] = None
                 ) -> Tuple[Any, AdamWState]:
    """One AdamW step on ``params`` from ``grads`` (same structure; any
    float dtype), in place: returns (params, AdamWState(step + 1, m, v))
    with the same leaves, updated.  ``grad_norm`` is the clip's global
    norm when ``grads`` hold only part of the model (a process of a
    grid: ``launch/grid.py``), else ``global_norm(grads)``.  No value is
    read on the host."""
    step = state.step + 1
    gnorm = global_norm(grads) if grad_norm is None else grad_norm
    scale = torch.clamp(grad_clip / torch.clamp(gnorm, min=1e-12), max=1.0)
    stepf = step.float()
    bc1 = 1 - torch.pow(torch.tensor(b1, dtype=torch.float32,
                                     device=stepf.device), stepf)
    bc2 = 1 - torch.pow(torch.tensor(b2, dtype=torch.float32,
                                     device=stepf.device), stepf)
    for g, m, v, p in zip(leaves(grads), leaves(state.m), leaves(state.v),
                          leaves(params)):
        for gs, ms, vs, ps in zip(_slices(g), _slices(_flat_view(m, "m")),
                                  _slices(_flat_view(v, "v")),
                                  _slices(_flat_view(p, "params"))):
            g32 = gs.float() * scale
            ms.mul_(b1).add_((1 - b1) * g32)
            vs.mul_(b2).add_((1 - b2) * g32 * g32)
            del g32
            delta = (ms / bc1).div_((vs / bc2).sqrt_().add_(eps))
            p32 = ps.float()
            delta.add_(weight_decay * p32)
            ps.copy_(p32.sub_(lr * delta))
    return params, AdamWState(step, state.m, state.v)
