"""Carry the JAX package's parameters and caches over to the port.

``to_torch`` maps a pytree of numpy arrays (``jax.device_get`` of params
or caches) to torch tensors under the same key paths.  The port keeps the
JAX layouts — stacked per-layer leaves, rank-major expert slot rows
``[G * epr, d, f]``, ``wq/wk/wv [d, H, hd]``, ``wo [H, hd, d]`` — so the
conversion copies leaves and never remaps them.  K/V caches (the JAX
``AttnCache`` named tuples) become the port's ``AttnCache``.  bfloat16
leaves (numpy's ``ml_dtypes`` extension type) travel as raw 16-bit words.
At expert-parallel degree G the expert leaves stay rank-major, padded
experts included (``VirtualGroup`` runs on them as they are), and so do
the replica-slot leaves ``w_rep_in`` / ``w_rep_out`` / ``w_rep_gate``
(``G * R`` rows, row ``g * R + r`` is slot r of rank g) of a model built
with ``num_replica_slots`` R; ``expert_shard`` cuts one rank's rows out
of both in one layer's dict, and ``shard_params`` in a whole stacked
parameter tree, for ``DistComm``.

Tensor-parallel MoE (E < G; JAX's ``tp_mode``) keeps JAX's plain
``[E, d, f]`` expert leaves sharded over d_ff; the port lays each rank's
slice out as rows of its own (``tp_rows``): ``[G * E, d, f / G]`` for
``w_in`` / ``w_gate`` and ``[G * E, f / G, d]`` for ``w_out``, row
``g * E + e`` rank g's contiguous slice of expert e, so that
``VirtualGroup`` and ``DistComm`` cut a rank's weights as they cut
expert rows and the kernel reads dense tensors.  ``tp_params`` applies it
to a converted tree.  Mamba leaves and the hybrid's ``groups`` /
``shared`` / ``tail`` tree keep JAX's layout, and ``MambaState`` caches
become the port's.  So do gemma2's ``post_norm1`` / ``post_norm2`` leaves
and its two-layer period (``blocks/sub0`` local, ``blocks/sub1``
global), whisper's encoder (``encoder/stack/blocks/sub0`` and
``encoder/final_norm``) and its stacked cross-attention leaves
(``cross/norm``, ``cross/attn/wq|wk|wv|wo``, a leading decoder-layer
axis), and its cache's ``cross`` K/V.

An optimizer state (JAX's ``AdamWState(step, m, v)``) becomes the
port's ``optim.adamw.AdamWState``: the int32 step a 0-d tensor, the f32
moments trees of the parameters' layout.  A JAX checkpoint needs no
conversion: ``checkpoint.Checkpointer`` reads its files in JAX's leaf
order into the port's trees.
"""
from __future__ import annotations

from typing import Any, Dict

import numpy as np
import torch

from repro_torch import resolve_device
from repro_torch.models.attention import AttnCache
from repro_torch.models.mamba2 import MambaState
from repro_torch.optim.adamw import AdamWState

_NAMED = {tuple(t._fields): t for t in (AttnCache, MambaState, AdamWState)}


def _leaf(a, device) -> torch.Tensor:
    a = np.asarray(a)
    if a.dtype.name == "bfloat16":
        t = torch.from_numpy(np.ascontiguousarray(a).view(np.uint16).copy())
        return t.view(torch.bfloat16).to(device)
    return torch.from_numpy(np.array(a, copy=True)).to(device)


def to_torch(tree: Any, device=None) -> Any:
    """Pytree of arrays -> the same tree of torch tensors on ``device``
    (the CUDA device unless the caller asks for another)."""
    return _convert(tree, resolve_device(device))


def _convert(tree: Any, device: torch.device) -> Any:
    if isinstance(tree, dict):
        return {k: _convert(v, device) for k, v in tree.items()}
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        kind = _NAMED.get(tuple(tree._fields), type(tree))
        return kind(*(_convert(v, device) for v in tree))
    if isinstance(tree, (list, tuple)):
        return type(tree)(_convert(v, device) for v in tree)
    return _leaf(tree, device)


def expert_shard(moe_params: Dict[str, Any], rank: int,
                 ep_degree: int, axis: int = 0) -> Dict[str, Any]:
    """One MoE block's parameters as rank ``rank`` of ``ep_degree`` holds
    them under ``DistComm``: its own rows ``[epr, ...]`` of each rank-major
    expert leaf (row ``g * epr + j`` is slot j of rank g, as
    ``init_moe_params`` lays them out), its ``[R, ...]`` of each replica
    leaf, and the replicated router.  The rows are on ``axis`` (1 for the
    stacked per-layer leaves ``[n, rows, ...]``); the cut is a view."""
    out = {}
    for name, w in moe_params.items():
        if name == "router":
            out[name] = w
            continue
        if w.shape[axis] % ep_degree:
            raise ValueError(f"{name}: {w.shape[axis]} rows do not split "
                             f"over {ep_degree} ranks")
        epr = w.shape[axis] // ep_degree
        out[name] = w.narrow(axis, rank * epr, epr)
    return out


def is_expert_path(path: str) -> bool:
    """Whether the leaf at ``path`` (``tree.paths``) is one that
    ``shard_params`` cuts: an MoE block's leaf other than its router,
    whose expert (or replica) rows lie on axis 1."""
    parts = path.split("/")
    return "moe" in parts[:-1] and parts[-1] != "router"


def shard_params(params: Any, rank: int, ep_degree: int) -> Any:
    """A whole parameter tree as rank ``rank`` of ``ep_degree`` holds it
    under ``DistComm``: every MoE block's expert and replica leaves cut to
    the rank's rows (``expert_shard`` on axis 1 of the stacked leaves,
    copied so that the whole tree can be freed), the rest shared."""
    if isinstance(params, dict):
        return {k: ({n: (w if n == "router" else w.clone(
                        memory_format=torch.contiguous_format))
                     for n, w in expert_shard(v, rank, ep_degree,
                                              axis=1).items()}
                    if k == "moe" else shard_params(v, rank, ep_degree))
                for k, v in params.items()}
    if isinstance(params, list):
        return [shard_params(v, rank, ep_degree) for v in params]
    return params


def tp_rows(w: torch.Tensor, G: int, name: str) -> torch.Tensor:
    """A tensor-parallel expert leaf ``[..., E, d, f]`` (``w_in``,
    ``w_gate``) or ``[..., E, f, d]`` (``w_out``) as G ranks' contiguous
    d_ff slices side by side: ``[..., G * E, ...]``, row ``g * E + e``
    holding columns (rows for ``w_out``) ``[g f / G, (g + 1) f / G)`` of
    expert e, as JAX's ``in_specs`` shard them over the EP axis."""
    ax = w.ndim - (2 if name == "w_out" else 1)
    f = w.shape[ax]
    if f % G:
        raise ValueError(f"{name}: d_ff {f} does not split over {G} ranks")
    fs = f // G
    return torch.cat([w.narrow(ax, g * fs, fs) for g in range(G)],
                     dim=w.ndim - 3)


def tp_params(params: Any, G: int) -> Any:
    """A converted parameter tree with every MoE block's expert leaves laid
    out for tensor-parallel MoE over G ranks (``tp_rows``; the router and
    the rest are shared)."""
    if isinstance(params, dict):
        return {k: ({n: (w if n == "router" else tp_rows(w, G, n))
                     for n, w in v.items()}
                    if k == "moe" else tp_params(v, G))
                for k, v in params.items()}
    if isinstance(params, list):
        return [tp_params(v, G) for v in params]
    return params
