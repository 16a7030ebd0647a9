"""Operation counting for the roofline terms: the port's counterpart of
``repro/launch/hlo_analysis.py``.

JAX's dry-run parses the compiled XLA HLO text and rebuilds each loop's
trip count.  A PyTorch step has no such text: it runs.  ``analyze``
runs a function under a ``TorchDispatchMode`` and counts every ATen op
it dispatches, on any device (the ``meta`` device of ``launch/dryrun.py``
computes nothing and allocates nothing, so a full-width step costs only
its dispatch).  Every loop iteration and every rank of a
``VirtualGroup`` executes, so the counts are what JAX's multipliers
rebuild; there is no trip-count machinery.

The keys and conventions are JAX's:

  * ``flops``: the matrix products, 2 x prod(result) x contracted (the
    formulas of ``torch.utils.flop_counter``: ``mm``, ``bmm``,
    ``addmm``, ``baddbmm``, convolutions, the attention ops), which
    count what JAX's ``_dot_flops`` counts; an einsum reaches ATen as
    ``bmm``.  With autograd the backward's products and a checkpoint's
    recomputed forward are counted too, as a compiled train step's are.
  * ``bytes_accessed``: a product counts its operands plus its result;
    a gather (``index``, ``index_select``, ``gather``, ``embedding``)
    2 x its result; a scatter (``index_put``, ``scatter``,
    ``index_copy``, ``index_add``, and ``copy_`` into a view, the
    counterpart of ``dynamic-update-slice``) 2 x its update; a
    collective its inputs plus its answers.
  * ``bytes_all``: every op that is not a view, an empty or a constant,
    its result plus its first 8 tensor operands (gathers and scatters
    as above): the unfused worst case.
  * ``collectives_per_kind``, ``collective_counts``,
    ``collective_bytes``: the collectives the MoE bodies yield
    (``core/dispatch.py``), counted once a group collective is answered
    (one count for a ``VirtualGroup`` of G ranks, as one SPMD op), with
    the bytes of every rank's answer, x 2 for an all-reduce (ring
    reduce-scatter plus all-gather).  ``all_gather`` counts as
    all-gather, ``all_to_all`` as all-to-all, ``psum`` and ``pmax`` as
    all-reduce, and ``fetch_rows`` (the foreign-weight fetch, which
    JAX's dense form runs as an all-to-all of outboxes) as all-to-all
    with the ``[K, ...]`` rows each rank receives.  ``LocalComm``'s
    identities are counted as XLA keeps its one-device collectives.

One difference from HLO: a view is free here, where XLA's
``dynamic-slice`` of a stacked layer counts 2 x its result, so
``bytes_accessed`` reads each layer's weights once, where the product
uses them.

    stats = analyze(step, params, batch)
    stats["flops"], stats["collectives_per_kind"]["all-to-all"]
"""
from __future__ import annotations

from typing import Any, Callable, Dict, List

import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_leaves
from torch.utils.flop_counter import flop_registry

from repro_torch.core import dispatch as D

COLLECTIVES = ("all-gather", "all-reduce", "reduce-scatter", "all-to-all",
               "collective-permute")
_KIND = {"all_gather": "all-gather", "all_to_all": "all-to-all",
         "psum": "all-reduce", "pmax": "all-reduce",
         "fetch_rows": "all-to-all"}

aten = torch.ops.aten
_GATHER = {aten.index, aten.index_select, aten.gather, aten.embedding,
           aten.take_along_dim}
# op -> position of the update among its arguments
_SCATTER = {aten.index_put: 2, aten.index_put_: 2, aten._index_put_impl_: 2,
            aten.scatter: 3, aten.scatter_: 3, aten.scatter_add: 3,
            aten.scatter_add_: 3, aten.scatter_reduce: 3,
            aten.scatter_reduce_: 3, aten.index_copy: 3,
            aten.index_copy_: 3, aten.index_add: 3, aten.index_add_: 3,
            aten.slice_scatter: 1, aten.select_scatter: 1,
            aten.masked_scatter: 2, aten.masked_scatter_: 2, aten.copy_: 1}
_FREE = {aten.empty, aten.empty_like, aten.empty_strided, aten.new_empty,
         aten.new_empty_strided, aten.empty_permuted, aten.scalar_tensor,
         aten.lift_fresh, aten.lift_fresh_copy, aten._unsafe_view,
         aten.detach, aten.alias, aten._local_scalar_dense,
         aten.is_contiguous, aten.sym_size, aten.sym_stride,
         aten.sym_numel, aten.sym_storage_offset}


def _nbytes(x) -> int:
    if isinstance(x, D.Fetched):
        x = x.rows
    if isinstance(x, torch.Tensor):
        return x.numel() * x.element_size()
    return 0


def _tensors(args) -> List[torch.Tensor]:
    return [a for a in tree_leaves(args) if isinstance(a, torch.Tensor)]


class OpCounter(TorchDispatchMode):
    """The counting mode: ``with OpCounter() as c: fn(...)``, then
    ``c.result()``.  While it is active it also watches the collectives
    of ``core/dispatch.py``."""

    def __init__(self):
        super().__init__()
        self.flops = 0.0
        self.bytes_dot = 0.0
        self.bytes_all = 0.0
        self.coll_bytes = {k: 0.0 for k in COLLECTIVES}
        self.coll_counts = {k: 0.0 for k in COLLECTIVES}
        self.ops = 0

    def __enter__(self):
        D.WATCHERS.append(self._collective)
        return super().__enter__()

    def __exit__(self, *exc):
        D.WATCHERS.remove(self._collective)
        return super().__exit__(*exc)

    def _collective(self, op: str, xs: List[Any], answers: List[Any]):
        kind = _KIND[op]
        out = float(sum(_nbytes(a) for a in answers))
        self.coll_bytes[kind] += out * (2.0 if kind == "all-reduce" else 1.0)
        self.coll_counts[kind] += 1
        self.bytes_dot += out + sum(_nbytes(x) for x in xs)

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        out = func(*args, **kwargs)
        self.ops += 1
        packet = func._overloadpacket
        if packet in flop_registry:
            self.flops += float(flop_registry[packet](*args, **kwargs,
                                                      out_val=out))
            nbytes = sum(_nbytes(t) for t in _tensors(out)) + sum(
                _nbytes(t) for t in _tensors((args, kwargs))[:8])
            self.bytes_dot += nbytes
            self.bytes_all += nbytes
        elif packet in _GATHER:
            nbytes = 2 * sum(_nbytes(t) for t in _tensors(out))
            self.bytes_dot += nbytes
            self.bytes_all += nbytes
        elif packet in _SCATTER:
            upd = (args[_SCATTER[packet]] if len(args) > _SCATTER[packet]
                   else None)
            nbytes = 2 * (_nbytes(upd) if isinstance(upd, torch.Tensor)
                          else sum(_nbytes(t) for t in _tensors(out)))
            self.bytes_dot += nbytes
            self.bytes_all += nbytes
        elif not func.is_view and packet not in _FREE:
            self.bytes_all += sum(_nbytes(t) for t in _tensors(out)) + sum(
                _nbytes(t) for t in _tensors((args, kwargs))[:8])
        return out

    def result(self) -> Dict[str, Any]:
        return {
            "flops": self.flops,
            "bytes_accessed": self.bytes_dot,
            "bytes_all": self.bytes_all,
            "collective_bytes": sum(self.coll_bytes.values()),
            "collectives_per_kind": dict(self.coll_bytes),
            "collective_counts": dict(self.coll_counts),
            "ops": self.ops,
        }


def analyze(fn: Callable, *args, **kw) -> Dict[str, Any]:
    """Run ``fn(*args, **kw)`` once under ``OpCounter`` and return its
    counts (module docstring): ``flops``, ``bytes_accessed``,
    ``bytes_all``, ``collective_bytes``, ``collectives_per_kind``,
    ``collective_counts`` (JAX's keys) and ``ops``, the ATen ops
    dispatched."""
    with OpCounter() as c:
        fn(*args, **kw)
    return c.result()
