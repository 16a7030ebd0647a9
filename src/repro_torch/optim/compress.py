"""Int8-compressed gradient all-reduce with error feedback (port of
``repro/optim/compress.py``).

Gradients are quantized to int8 (one scale a leaf, stochastic rounding)
before the data-parallel sum, and the quantization residual is carried
in an error-feedback buffer, so the scheme is unbiased over steps.  One
scale is shared by every rank (a ``pmax`` of the ranks' abs-max: a scale
per rank would bias the sum); the int8 payloads are summed as int32 and
dequantized.  ``compressed_psum`` runs over a communicator of
``core/dispatch.py`` (``LocalComm``, ``VirtualGroup``, ``DistComm``),
as a body that yields its ``pmax`` and ``psum``.  The rounding noise,
uniform in [-0.5, 0.5), is drawn from an explicit ``torch.Generator`` or
passed in (tests feed JAX's draws).
"""
from __future__ import annotations

from typing import Any, List, Sequence, Tuple

import torch

from repro_torch.core import dispatch as D
from repro_torch.tree import flatten, unflatten


def uniform_noise(shape, gen: torch.Generator, device=None) -> torch.Tensor:
    """Rounding noise uniform in [-0.5, 0.5), f32, drawn on ``gen``."""
    return torch.rand(shape, generator=gen, dtype=torch.float32,
                      device=device or gen.device) - 0.5


def quantize_int8(x: torch.Tensor, noise: torch.Tensor
                  ) -> Tuple[torch.Tensor, torch.Tensor]:
    """x -> (int8 q, f32 scale): scale = max(|x|.max(), 1e-12) / 127 and
    q = clip(round(x / scale + noise), -127, 127)."""
    scale = torch.clamp(x.abs().max().float(), min=1e-12) / 127.0
    q = torch.clamp(torch.round(x / scale + noise), -127, 127)
    return q.to(torch.int8), scale


def dequantize_int8(q: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    return q.float() * scale


def _compressed_body(grads: Any, err: Any, noise: Any, n: int):
    """One rank's ``compressed_psum``, a body generator of
    ``core/dispatch.py`` that yields its collectives."""
    g_leaves, structure = flatten(grads)
    outs, new_errs = [], []
    for g, e, z in zip(g_leaves, flatten(err)[0], flatten(noise)[0]):
        g32 = g.float() + e
        gmax = yield from D.pmax(g32.abs().max())
        scale = torch.clamp(gmax, min=1e-12) / 127.0
        q = torch.clamp(torch.round(g32 / scale + z), -127, 127).to(
            torch.int8)
        new_errs.append(g32 - q.float() * scale)
        summed = yield from D.psum(q.to(torch.int32))
        outs.append(summed.float() * scale / n)
    return unflatten(structure, outs), unflatten(structure, new_errs)


def compressed_psum(grads: Sequence[Any], err: Sequence[Any],
                    noise: Sequence[Any], comm
                    ) -> Tuple[List[Any], List[Any]]:
    """Per-leaf int8 all-reduce with a shared scale over ``comm``'s ranks.
    ``grads``, ``err`` and ``noise`` hold one tree a rank this process
    runs (``comm.ranks_here``, in order): the rank's gradients, its
    error-feedback buffers (f32) and its rounding noise (f32, the leaves'
    shapes).  Leaf by leaf: g32 = g + e; scale = max(pmax(|g32|.max()),
    1e-12) / 127; q = clip(round(g32 / scale + noise), -127, 127);
    e' = g32 - q scale; mean = psum(q as int32) scale / n.  Returns (each
    rank's mean gradient tree, each rank's new error tree)."""
    here = comm.ranks_here

    def body(me: int):
        r = here.index(me)
        return (yield from _compressed_body(grads[r], err[r], noise[r],
                                            comm.size))
    out = comm.run_ranks(body)
    return [o[0] for o in out], [o[1] for o in out]
