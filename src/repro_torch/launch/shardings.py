"""Sharding rules: parameter / optimizer / cache / batch partition specs
per arch (port of ``repro/launch/shardings.py``).

The rules and their names are JAX's, run over the port's trees, whose
paths are JAX's (``tree.paths(..., fields=True)``):
  * EP   -- MoE expert slot rows over 'model'
  * TP   -- attention heads, dense-FFN hidden, SSM inner channels, vocab
            over 'model' (skipped per leaf when not divisible, e.g.
            whisper's 20 heads)
  * DP   -- batch over ('pod', 'data')
  * FSDP -- with ``ParallelConfig.fsdp``, params and optimizer state also
            over 'data' on a non-'model' dim
  * SP   -- long-context KV caches: sequence over 'data' when the batch
            cannot shard

A spec is a ``PartitionSpec``: a tuple with one entry a dimension, each
``None``, an axis name or a tuple of axis names, as JAX's.  The port runs
no sharded step: ``launch/dryrun`` reads the specs to size each device's
share of the arguments (``shard_shape``).
"""
from __future__ import annotations

from typing import Any, Dict, Tuple

from repro_torch import tree
from repro_torch.configs.base import ModelConfig, ParallelConfig
from repro_torch.launch.mesh import Mesh


class PartitionSpec:
    """One entry a dimension: None (replicated), an axis name, or a tuple
    of axis names (sharded over their product).  As JAX's, a tuple of
    one name is that name and an empty tuple is None.  It iterates, indexes
    and compares as the tuple of its entries, and is one leaf of a tree
    (``repro_torch.tree``), so a tree of specs has its tensors' structure."""
    __slots__ = ("entries",)

    def __init__(self, *entries):
        def norm(e):
            if isinstance(e, (tuple, list)):
                e = tuple(e)
                return None if not e else (e[0] if len(e) == 1 else e)
            return e
        self.entries = tuple(norm(e) for e in entries)

    def __iter__(self):
        return iter(self.entries)

    def __len__(self):
        return len(self.entries)

    def __getitem__(self, i):
        return self.entries[i]

    def __eq__(self, other):
        if isinstance(other, (tuple, PartitionSpec)):
            return self.entries == tuple(other)
        return NotImplemented

    def __hash__(self):
        return hash(self.entries)

    def __repr__(self):
        return f"PartitionSpec{self.entries!r}"


P = PartitionSpec


def shard_shape(shape, spec, sizes: Dict[str, int]) -> Tuple[int, ...]:
    """One device's block of a ``shape`` laid out by ``spec`` over a mesh
    of axis ``sizes`` (each dim divided by its axes' product, rounded
    up, as an uneven shard's largest block)."""
    out = []
    for i, n in enumerate(shape):
        entry = spec[i] if i < len(spec) else None
        axes = () if entry is None else (
            (entry,) if isinstance(entry, str) else tuple(entry))
        div = 1
        for a in axes:
            div *= sizes.get(a, 1)
        out.append(-(-n // div))
    return tuple(out)


def _tp(nd: int, *trailing) -> P:
    """A spec on the trailing dims, leading (stacking) dims replicated."""
    lead = nd - len(trailing)
    return P(*([None] * lead + list(trailing)))


def _div(n, by) -> bool:
    return by > 0 and n % by == 0


def param_spec(name: str, shape, cfg: ModelConfig, *, ep: int, fsdp: bool,
               data: int) -> P:
    """The spec of the parameter leaf at path ``name`` of ``shape``."""
    shape = tuple(shape)
    nd = len(shape)
    size = 1
    for n in shape:
        size *= n

    # ---------- base (TP/EP) rule ----------
    if "embed" in name or "lm_head" in name:
        # vocab sharding pays for big tables (and their gradients); small
        # tables replicate
        big_vocab = shape[-2] >= 100_000
        spec = (_tp(nd, "model", None) if _div(shape[-2], ep) and big_vocab
                else _tp(nd, None, None))
    elif "router" in name:
        spec = _tp(nd, None, None)
    elif "/moe/" in name and ("w_in" in name or "w_gate" in name
                              or "w_out" in name):
        if _div(shape[-3], ep):                  # EP: expert slot rows
            spec = _tp(nd, "model", None, None)
        elif "w_out" in name and _div(shape[-2], ep):
            spec = _tp(nd, None, "model", None)  # TP mode: d_ff-sliced
        elif "w_out" not in name and _div(shape[-1], ep):
            spec = _tp(nd, None, None, "model")
        else:
            spec = _tp(nd, None, None, None)
    elif name.endswith("wq") or name.endswith("wk") or name.endswith("wv"):
        spec = (_tp(nd, None, "model", None) if _div(shape[-2], ep)
                else _tp(nd, None, None, None))
    elif name.endswith("wo"):
        spec = (_tp(nd, "model", None, None) if _div(shape[-3], ep)
                else _tp(nd, None, None, None))
    elif "w_in" in name or "w_gate" in name:     # dense MLP column-parallel
        spec = (_tp(nd, None, "model") if _div(shape[-1], ep)
                else _tp(nd, None, None))
    elif "w_out" in name:                        # dense MLP row-parallel
        spec = (_tp(nd, "model", None) if _div(shape[-2], ep)
                else _tp(nd, None, None))
    elif name.endswith("wz") or name.endswith("wx"):
        spec = (_tp(nd, None, "model") if _div(shape[-1], ep)
                else _tp(nd, None, None))
    elif name.endswith("out_proj"):
        spec = (_tp(nd, "model", None) if _div(shape[-2], ep)
                else _tp(nd, None, None))
    elif name.endswith("conv_x"):
        spec = (_tp(nd, None, "model") if _div(shape[-1], ep)
                else _tp(nd, None, None))
    elif (name.endswith("A_log") or name.endswith("/D")
          or name.endswith("dt_bias")):
        spec = _tp(nd, "model") if _div(shape[-1], ep) else _tp(nd, None)
    elif name.endswith("norm_scale"):
        spec = _tp(nd, "model") if _div(shape[-1], ep) else _tp(nd, None)
    else:
        spec = P(*([None] * nd))

    # ---------- FSDP overlay: shard one replicated dim over 'data' ----------
    if fsdp and data > 1 and size >= (1 << 16):
        parts = list(spec) + [None] * (nd - len(spec))
        # never the leading dim of a stacked (>= 3-D) leaf: the layer stack
        start = 1 if nd >= 3 else 0
        for i in range(start, nd):
            if parts[i] is None and _div(shape[i], data):
                parts[i] = "data"
                break
        spec = P(*parts)
    return spec


def _map_with_path(fn, t: Any) -> Any:
    """``fn(path, leaf)`` over a tree's leaves, in the same structure."""
    leaves, structure = tree.flatten(t)
    names = tree.paths(t, fields=True)
    return tree.unflatten(structure, [fn(n, x) for n, x in zip(names, leaves)])


def param_shardings(param_shapes: Any, cfg: ModelConfig, pcfg: ParallelConfig,
                    mesh: Mesh) -> Any:
    sizes = mesh.sizes
    ep, data = sizes.get("model", 1), sizes.get("data", 1)
    return _map_with_path(
        lambda name, leaf: param_spec(name, leaf.shape, cfg, ep=ep,
                                      fsdp=pcfg.fsdp, data=data),
        param_shapes)


# ----------------------------------------------------------------------
# KV / SSM cache shardings
# ----------------------------------------------------------------------
def cache_spec(name: str, shape, cfg: ModelConfig, *, batch_axes, ep: int,
               shard_kv_seq: bool) -> P:
    shape = tuple(shape)
    nd = len(shape)
    bspec = batch_axes if batch_axes else None
    if name.endswith("/k") or name.endswith("/v"):
        # [(stack dims...), B, S, Hkv, hd]: heads over 'model' where they
        # divide it, else the sequence over 'model'
        if _div(shape[-2], ep):
            head_s, seq_s = "model", ("data" if shard_kv_seq else None)
        elif _div(shape[-3], ep):
            head_s, seq_s = None, "model"
        else:
            head_s, seq_s = None, None
        if bspec is not None:
            return _tp(nd, bspec, seq_s if seq_s == "model" else None,
                       head_s, None)
        if seq_s != "model" and shard_kv_seq and _div(shape[-3], 1):
            seq_s = "data"
        return _tp(nd, None, seq_s, head_s, None)
    if "ssm" in name:
        # [(stack), B, H, P, N]
        head_s = "model" if _div(shape[-3], ep) else None
        return _tp(nd, bspec, head_s, None, None)
    if "conv_x" in name:
        ch_s = "model" if _div(shape[-1], ep) else None
        return _tp(nd, bspec, None, ch_s)
    if "conv" in name:
        return _tp(nd, bspec, None, None)
    return P(*([None] * nd))


def batch_axes_for(global_batch: int, mesh: Mesh) -> Tuple[str, ...]:
    """The largest prefix of ('pod', 'data') whose product divides the
    batch."""
    sizes = mesh.sizes
    axes: Tuple[str, ...] = ()
    prod = 1
    for a in ("pod", "data"):
        if a in sizes and global_batch % (prod * sizes[a]) == 0:
            axes += (a,)
            prod *= sizes[a]
    return axes


def cache_shardings(cache_shapes: Any, cfg: ModelConfig, *, global_batch: int,
                    mesh: Mesh, shard_kv_seq: bool = False) -> Any:
    ep = mesh.sizes.get("model", 1)
    batch_axes = batch_axes_for(global_batch, mesh)
    return _map_with_path(
        lambda name, leaf: cache_spec(
            name, leaf.shape, cfg, batch_axes=batch_axes, ep=ep,
            shard_kv_seq=shard_kv_seq and not batch_axes),
        cache_shapes)


def batch_shardings(batch_shapes: Any, *, global_batch: int,
                    mesh: Mesh) -> Any:
    batch_axes = batch_axes_for(global_batch, mesh)
    bspec = batch_axes if batch_axes else None
    return tree.tree_map(
        lambda leaf: P(*([bspec] + [None] * (len(leaf.shape) - 1))),
        batch_shapes)


def replicated(t: Any, mesh: Mesh) -> Any:
    return tree.tree_map(lambda leaf: P(*([None] * len(leaf.shape))), t)
