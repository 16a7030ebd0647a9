"""The (data, model) grid of processes over ``torch.distributed``.

JAX trains on a ``(data, model)`` mesh (``repro/launch/train.py``): the
batch is sharded over ``data`` and each data row is its own
expert-parallel group over ``model``.  The port runs one process a grid
point.  Process rank ``r`` sits at ``(r // G, r % G)``, the order of
``make_host_mesh(D, G).devices``; each data row is one EP subgroup (the
MoE blocks' ``DistComm``) and each model column one data-parallel
subgroup (the gradient average), both built with ``dist.new_group`` by
every process in the same order.  The grid holds no devices: a process
runs on the device its launcher gives it (``init_grid``).

A process holds its EP rank's expert rows (``convert.shard_params``) and
a replica of every other leaf; it takes its data shard of the global
batch (``data_rows``: JAX's ``MeshShape.batch_axes`` rows, microbatch by
microbatch), computes the loss over it, and the train step averages
every gradient leaf, the loss and the diagnostics over its data-parallel
group (``average``) and takes AdamW's global norm over the whole model
(``global_norm``: the replicated leaves once, the expert leaves summed
over the EP group).  A checkpoint holds the global leaves, written once
by data row 0, each process its own rows (``save``), and restores onto
any grid whose global shapes agree (``shardings`` with
``Checkpointer.restore``).
"""
from __future__ import annotations

import os
from dataclasses import dataclass
from typing import Any, List, Optional, Tuple

import numpy as np
import torch

from repro_torch import tree as T
from repro_torch.checkpoint.checkpointer import RowShard
from repro_torch.convert import is_expert_path
from repro_torch.core.dispatch import DistComm
from repro_torch.optim.adamw import global_norm

_BUCKET = 1 << 25           # elements an all-reduce


def batch_shards(global_batch: int, data: int) -> int:
    """How many data shards the batch splits into: ``data`` when it
    divides the batch, else 1 (JAX's ``MeshShape.batch_axes`` replicates
    the batch over the data axis)."""
    return data if global_batch % data == 0 else 1


def data_rows(global_batch: int, data: int, index: int,
              microbatch: int = 0) -> np.ndarray:
    """The rows of the global batch that data shard ``index`` of
    ``data`` takes, in its local order: for each of the ``microbatch``
    microbatches (JAX's reshape to (n, B / n)), its shard's contiguous
    B / (n D) rows of that microbatch; all rows when the batch is
    replicated."""
    shards = batch_shards(global_batch, data)
    if shards == 1:
        return np.arange(global_batch)
    n = max(microbatch, 1)
    if global_batch % (n * shards):
        raise ValueError(f"batch {global_batch} does not split into {n} "
                         f"microbatches over {shards} data shards")
    per, ub = global_batch // (n * shards), global_batch // n
    return np.concatenate([i * ub + index * per + np.arange(per)
                           for i in range(n)])


@dataclass
class ProcessGrid:
    """This process's place on a ``data x model`` grid and its two
    subgroups (None where the subgroup is the whole world, and the
    data-parallel one at D = 1, where it is not used)."""
    data: int
    model: int
    rank: int
    ep_group: Any
    dp_group: Any
    backend: str

    @property
    def row(self) -> int:
        """The data index (the EP group this process belongs to)."""
        return self.rank // self.model

    @property
    def col(self) -> int:
        """The EP rank within the row (the data-parallel group)."""
        return self.rank % self.model

    def comm(self) -> DistComm:
        """The MoE blocks' communicator over this row: the dense fetch on
        NCCL (capturable), the hosted one on gloo."""
        return DistComm(self.ep_group,
                        fetch="dense" if self.backend == "nccl"
                        else "hosted")

    def local_batch(self, global_batch: int) -> int:
        return global_batch // batch_shards(global_batch, self.data)

    def shard_batch(self, batch, microbatch: int = 0):
        """This process's rows of a global batch (arrays or tensors)."""
        b = len(next(iter(batch.values())))
        rows = data_rows(b, self.data, self.row, microbatch)
        if len(rows) == b:
            return batch
        return {k: v[rows] if isinstance(v, np.ndarray)
                else v[torch.as_tensor(rows, device=v.device)]
                for k, v in batch.items()}

    # ------------------------------------------------------------------
    def _all_reduce(self, t: torch.Tensor, group) -> None:
        import torch.distributed as dist
        dist.all_reduce(t, group=group)

    def average(self, tensors: List[torch.Tensor]) -> List[torch.Tensor]:
        """Each tensor's mean over the data-parallel group, summed in its
        own dtype (as JAX's data-parallel reduction of the gradients is),
        in flat buckets of one dtype a collective; the tensors themselves
        at D = 1."""
        if self.data == 1:
            return tensors
        out: List[Optional[torch.Tensor]] = [None] * len(tensors)
        by_dtype = {}
        for k, t in enumerate(tensors):
            by_dtype.setdefault(t.dtype, []).append(k)
        for ks in by_dtype.values():
            i = 0
            while i < len(ks):
                j, n = i, 0
                while j < len(ks) and (j == i or n + tensors[ks[j]].numel()
                                       <= _BUCKET):
                    n += tensors[ks[j]].numel()
                    j += 1
                flat = torch.cat([tensors[k].reshape(-1) for k in ks[i:j]])
                self._all_reduce(flat, self.dp_group)
                flat.div_(self.data)
                lo = 0
                for k in ks[i:j]:
                    t = tensors[k]
                    out[k] = flat[lo:lo + t.numel()].reshape(t.shape)
                    lo += t.numel()
                i = j
        return out

    def global_norm(self, grads: Any) -> torch.Tensor:
        """AdamW's global gradient norm over the whole model (f32, 0-d):
        the replicated leaves' squares once, the expert leaves' summed
        over the EP group."""
        if self.model == 1:
            return global_norm(grads)           # the one-process order
        flat = T.leaves(grads)
        sq = torch.zeros((2,), dtype=torch.float32, device=flat[0].device)
        for g, p in zip(flat, T.paths(grads)):
            sq[int(is_expert_path(p))] += g.float().square().sum()
        expert = sq[1:].clone()
        self._all_reduce(expert, self.ep_group)
        return (sq[0] + expert[0]).sqrt()

    def shardings(self, like: Any) -> List[Optional[RowShard]]:
        """``Checkpointer.restore``'s ``shardings`` for a tree of this
        process's leaves: each expert leaf's rows of this EP rank."""
        return [RowShard(1, self.col, self.model) if is_expert_path(p)
                else None for p in T.paths(like)]

    def save(self, ckpt, step: int, tree_: Any, *,
             blocking: bool = False) -> None:
        """One checkpoint of the global leaves: the processes of row 0
        (every row holds the same state) each write their own expert rows
        into the one file of each expert leaf, and process 0 the other
        leaves (``Checkpointer.save_part``), so the files are a
        one-process save's.  The processes share the checkpoint's
        filesystem."""
        if self.row != 0:
            return
        if self.model == 1:
            ckpt.save(step, tree_, blocking=blocking)
            return
        import torch.distributed as dist
        ckpt.save_part(step, tree_, self.shardings(tree_), part=self.col,
                       parts=self.model, blocking=blocking,
                       sync=lambda: dist.barrier(group=self.ep_group))


def make_grid(data: int, model: int, *,
              ranks: Optional[List[int]] = None) -> Optional[ProcessGrid]:
    """The grid over the initialized default group, whose size must be
    ``data * model``, or over its processes ``ranks`` (grid rank i is
    process ``ranks[i]``; the others get None): every process of the
    world builds every row's and every column's group, in the same
    order."""
    import torch.distributed as dist
    if not dist.is_initialized():
        raise RuntimeError("a process grid needs an initialized "
                           "torch.distributed process group")
    world = dist.get_world_size()
    members = list(range(world)) if ranks is None else list(ranks)
    if len(members) != data * model:
        raise ValueError(f"{'WORLD_SIZE' if ranks is None else 'ranks:'} "
                         f"{len(members)} != data x model = {data} x "
                         f"{model}: one process runs one grid point")
    whole = len(members) == world
    # a subgroup that is the whole world is the default group (None); at
    # D = 1 the data-parallel groups are never used and not built
    rows = ([None] if data == 1 and whole else
            [dist.new_group([members[d * model + g] for g in range(model)])
             for d in range(data)])
    cols = ([None] * model if data == 1 or (model == 1 and whole) else
            [dist.new_group([members[d * model + g] for d in range(data)])
             for g in range(model)])
    me = dist.get_rank()
    if me not in members:
        return None
    r = members.index(me)
    return ProcessGrid(data, model, r, rows[r // model], cols[r % model],
                       str(dist.get_backend()))


def init_from_env(device) -> Tuple[bool, torch.device]:
    """Whether this process is one of a launcher's, and its device: the
    default group when one is initialized or the environment names one
    (``RANK`` / ``WORLD_SIZE``, initialized here: NCCL on
    ``cuda:LOCAL_RANK``, gloo when the caller asks for the CPU)."""
    import torch.distributed as dist
    device = torch.device(device)
    if not dist.is_initialized():
        if "WORLD_SIZE" not in os.environ or "RANK" not in os.environ:
            return False, device
        if device.type == "cuda":
            local = int(os.environ.get("LOCAL_RANK", 0))
            device = torch.device("cuda", local)
            torch.cuda.set_device(device)
            dist.init_process_group("nccl", device_id=device)
        else:
            dist.init_process_group("gloo")
    if device.type == "cuda" and str(dist.get_backend()) == "nccl":
        device = torch.device("cuda", torch.cuda.current_device())
    return True, device


def init_grid(device, *, data: int, model: int
              ) -> Tuple[Optional[ProcessGrid], torch.device]:
    """The launcher's processes (``init_from_env``) as a ``data x model``
    grid, and this process's device; None in one process.  ``data`` 0
    takes ``WORLD_SIZE // model``, as JAX's driver takes its devices
    over ``--model-par``."""
    import torch.distributed as dist
    launched, device = init_from_env(device)
    if not launched:
        return None, device
    data = data or max(dist.get_world_size() // max(model, 1), 1)
    return make_grid(data, model), device
