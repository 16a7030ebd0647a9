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
"""
from __future__ import annotations

from typing import Any, Dict

import numpy as np
import torch

from repro_torch import resolve_device
from repro_torch.models.attention import AttnCache


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
        if tuple(tree._fields) == AttnCache._fields:
            return AttnCache(*(_convert(v, device) for v in tree))
        return type(tree)(*(_convert(v, device) for v in tree))
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
