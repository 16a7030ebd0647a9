"""Slotted KV pool: ``model.init_cache`` reinterpreted as a slab of
per-request slots (port of ``repro/serve/slots.py``).

The pool is one cache tree of batch ``n_slots``; each row is a slot that
a request occupies from admission until it finishes, after which it is
recycled for a queued request.  Prefill runs against a batch-1 scratch
cache of the same per-layer shapes, and the finished prefix is copied
into the slot with ``write_slot``, in place.

Cache layouts differ per leaf (stacked layers put batch at axis 1,
leading dense layers at axis 0), so the batch axis AND the KV-length axis
of every leaf are discovered structurally, as the JAX package does with
``jax.eval_shape``: ``init_cache`` is built on the ``meta`` device (shapes
only, no memory) at two batch sizes (resp. two lengths) and the differing
axis is the one sought.  Axes are lists in ``paging.kv_leaves`` order.
Sliding-window leaves are clamped to the window, so their KV axis shows
only at lengths below it (``discover_seq_axes``' second probe).
"""
from __future__ import annotations

from typing import Any, Callable, List

import torch

from repro_torch.serve.paging import kv_leaves


def leaf_shapes(init_cache: Callable[..., Any], b: int, s_max: int) -> List:
    return [leaf.shape for leaf in
            kv_leaves(init_cache(b, s_max, device="meta"))]


def _differing(a, b) -> List[int]:
    return [i for i, (x, y) in enumerate(zip(a, b)) if x != y]


def _differing_axes(lo: List, hi: List, what: str) -> List[int]:
    """Per leaf, the one axis where two probes' shapes disagree."""
    axes = []
    for a, b in zip(lo, hi):
        diffs = _differing(a, b)
        if len(diffs) != 1:
            raise ValueError(f"cannot identify {what} axis for cache leaf "
                             f"{tuple(a)} vs {tuple(b)}")
        axes.append(diffs[0])
    return axes


def discover_batch_axes(init_cache: Callable[..., Any],
                        s_max: int) -> List[int]:
    """Per-leaf batch-axis indices of ``init_cache`` outputs."""
    return _differing_axes(leaf_shapes(init_cache, 2, s_max),
                           leaf_shapes(init_cache, 3, s_max), "batch")


def discover_seq_axes(init_cache: Callable[..., Any],
                      s_max: int) -> List[int]:
    """Per-leaf KV-length-axis indices of ``init_cache`` outputs: the axis
    that differs at lengths ``s_max`` and ``s_max + 1`` or, for a leaf
    clamped to a sliding window there, at lengths 1 and 2."""
    probes = [leaf_shapes(init_cache, 1, s) for s in (s_max, s_max + 1, 1, 2)]
    axes = []
    for hi_a, hi_b, lo_a, lo_b in zip(*probes):
        diffs = _differing(hi_a, hi_b) or _differing(lo_a, lo_b)
        if len(diffs) != 1:
            raise ValueError(f"cannot identify KV-length axis for cache "
                             f"leaf {tuple(lo_a)} vs {tuple(lo_b)}")
        axes.append(diffs[0])
    return axes


def min_kv_capacity(init_cache: Callable[..., Any], s_max: int,
                    seq_axes: List[int]) -> int:
    """Smallest per-layer KV length in the pool (sliding-window leaves
    clamp to the window, so prefill writes must fit the minimum)."""
    return min(shape[ax] for shape, ax in
               zip(leaf_shapes(init_cache, 1, s_max), seq_axes))


def write_slot(pool: Any, scratch: Any, slot, batch_axes: List[int]) -> Any:
    """Copy the batch-1 ``scratch`` cache into row ``slot`` (an int or a
    device tensor of one element, which a captured write reads) of every
    pool leaf, along that leaf's own batch axis (in place)."""
    for p, s, ax in zip(kv_leaves(pool), kv_leaves(scratch), batch_axes):
        row = torch.as_tensor(slot, device=p.device).reshape(1).long()
        p.index_copy_(ax, row, s.to(p.dtype))
    return pool
