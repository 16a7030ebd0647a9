"""Schedule-driven token dispatch / combine (paper Alg. 1 steps 4 & 6)
and the communicators the per-rank body runs against.

Port of ``repro/core/dispatch.py``.  Runs once per EP rank; sender and
receiver derive every buffer layout from the replicated schedule ``S`` and
static conventions, so only token payloads move.

Ordering convention (both sides): the units of (source g, expert e) are
ordered by their within-expert rank r; the first S[g,e,0] go to
destination 0, the next S[g,e,1] to destination 1, and so on.  Within a
pair chunk units are ordered by (e, r); within a destination group rows
are ordered by (source g, r).

Buffers: send/recv ``[G, c_pair, d]`` for off-diagonal pairs only (the
self-pair bypasses the all-to-all and has no capacity bound), and the
grouped compute buffer ``[c_total, d]`` whose groups start at multiples of
``block_m``.  Overflowing units are dropped and counted.  Group order:
local (epr) | replica (R) | foreign (K).  The replica groups hold copies of
hot experts' weights chosen between serving windows
(``serve/rebalance.py``); which expert occupies each is a device int32
vector (``replica_ids_me``, -1 = empty), so a swap changes values only.

Collectives.  The per-rank body (``moe_layer._moe_forward_local``) is a
generator: each collective is a ``yield`` of a ``Collective`` request
(``yield from all_gather(x)``, ``all_to_all``, ``psum``, ``pmax``,
``fetch_rows``), and the communicator answers it.  Three communicators
run the same body: ``LocalComm`` (one rank: every collective is the
identity), ``DistComm`` (one rank per process over
``torch.distributed``) and ``VirtualGroup`` (G ranks in one process on
one device, advanced in lockstep: every rank runs up to its next
collective, the group checks that all asked for the same one and answers
it from all their tensors).  Lockstep keeps the order of kernel launches
fixed, so results and launch counts are the same on every run.

The foreign-weight fetch is a collective of its own, ``fetch_rows``
(paper §4.3; ``prefetch.fetch_foreign_weights``): each communicator
answers with this rank's ``[K, ...]`` foreign expert rows (zeros where
the id is -1) in the form its transport does best.  ``LocalComm``: the
dense form below with the identity all-to-all (at G = 1 nothing is
foreign: zeros).  ``VirtualGroup``: one gather from the
rank-major weight.  ``DistComm``: ``fetch="dense"``, the JAX form (each
source sends every destination a ``[K, ...]`` outbox, zero where it
hosts nothing, through an even all-to-all; static shapes, so NCCL can
capture it) or ``fetch="hosted"`` (each source sends only the rows it
hosts, through an uneven all-to-all whose split sizes are read from FIDS
on the host: eager only, and it raises inside a capture).  With
``hosts_per_expert == 1`` (every configuration the port builds) exactly
one source holds a row, so the forms are bit-equal.  On the card a
communicator issues the fetch on a side CUDA stream of its own, forked
from the current stream by an event, and answers with a ``Fetched``
whose ``done`` event the body joins before the grouped FFN
(``prefetch.join``): the fetch overlaps the dispatch that follows it,
the paper's dedicated stream.  Fork and join are events, so a captured
step holds them too.

Under autograd (training) every communicator's collectives carry
gradients.  ``VirtualGroup`` builds one graph over all its ranks.
``DistComm``'s graph is one a process, so each of its collectives is a
``torch.autograd.Function`` whose backward is the transposed collective,
with the convention that a value replicated over the group holds its
whole cotangent on every process and a per-rank value its own:
``all_to_all`` sends the cotangent back along the reverse exchange;
``all_gather`` of a replicated result takes the process's own slice of
it (``gather_all_experts``' per-rank use sums the ranks' cotangents
first); ``psum`` passes the cotangent through; the fetch sends the
fetched rows' cotangent back to their hosting rank, which adds it into
its expert rows.  Where the block enters a rank's own work from a
replicated tensor (the input tokens, the router), ``enter`` sums the
ranks' cotangents, so that such a tensor ends with its whole gradient on
every process; ``rank0_mean_grad`` gives a per-rank scalar (the aux
loss) as rank 0's value with the ranks' mean gradient, JAX's
``shard_map`` transpose of an output that is not mapped over the axis.
Without an input that requires grad no autograd node is built and the
raw calls run, as serving's captured steps need.

No step here reads a device value on the host: scatters that drop
out-of-range rows send them to one extra dump row that is sliced off
(never a boolean mask, whose result size only the host can know), and
counts are scatter-adds into fixed bins, so the decode step can be
captured as a CUDA graph.
"""
from __future__ import annotations

import contextlib
from typing import Callable, Dict, Generator, List, NamedTuple, Optional

import numpy as np
import torch

from repro_torch import resolve_device
from repro_torch.core.router import expert_counts
from repro_torch.core.topology import EPTopology, device_tables, local_slot_of


class Collective(NamedTuple):
    op: str               # "all_gather" | "all_to_all" | "psum" | "pmax"
                          # | "fetch_rows"
    x: torch.Tensor
    args: tuple = ()      # fetch_rows: (fids_all, me, topo, fetch_chunk)


class Fetched(NamedTuple):
    """A ``fetch_rows`` answer: ``rows`` [K, ...], and ``done``, the event
    recorded on the side stream after the fetch (None when it ran on the
    current stream: the CPU, ``LocalComm``)."""
    rows: torch.Tensor
    done: Optional[object] = None


Body = Generator[Collective, object, object]


def all_gather(x: torch.Tensor, per_rank_use: bool = False):
    """Every rank's ``x`` stacked in rank order: [G, ...].
    ``per_rank_use``: the result feeds each rank's own work (not a
    replicated value), so under autograd on ``DistComm`` its backward
    sums the ranks' cotangents before taking this rank's slice."""
    return (yield Collective("all_gather", x,
                             ("per_rank",) if per_rank_use else ()))


def all_to_all(x: torch.Tensor):
    """``x`` [G_dst, ...] -> [G_src, ...]: out[src] = x_of_src[me]."""
    return (yield Collective("all_to_all", x))


def psum(x: torch.Tensor):
    """The sum of every rank's ``x``."""
    return (yield Collective("psum", x))


def pmax(x: torch.Tensor):
    """The elementwise maximum of every rank's ``x``."""
    return (yield Collective("pmax", x))


# Watchers of the collectives the bodies yield (``launch/op_analysis``
# counts them): each is called as ``watcher(op, inputs, answers)`` once a
# collective is answered, with every rank's input and answer that this
# process holds (one rank's under ``run``, all G under ``VirtualGroup``).
WATCHERS: List[Callable[[str, List[torch.Tensor], List[object]], None]] = []


def _records(*xs: torch.Tensor) -> bool:
    """Whether autograd records an op on ``xs``."""
    return torch.is_grad_enabled() and any(
        isinstance(x, torch.Tensor) and x.requires_grad for x in xs)


def run(comm, body: Body):
    """Drive one rank's body against a communicator that answers each
    collective at once (``LocalComm``, ``DistComm``, or a test's stand-in
    with ``all_gather`` / ``all_to_all`` / ``psum`` / ``pmax`` /
    ``fetch_rows`` methods; ``fetch_rows(w_local, fids_all, me, topo,
    fetch_chunk)`` answers with a ``Fetched``)."""
    try:
        req = next(body)
        while True:
            ans = getattr(comm, req.op)(req.x, *req.args)
            for watch in WATCHERS:
                watch(req.op, [req.x], [ans])
            req = body.send(ans)
    except StopIteration as stop:
        return stop.value


def dense_outbox(w_local: torch.Tensor, fids_all: torch.Tensor, me: int,
                 topo: EPTopology) -> torch.Tensor:
    """This source's outbox of the dense fetch, [G_dst, K, ...]: for each
    destination's k-th foreign expert the hosting slot's row over
    ``hosts_per_expert``, zero where this rank hosts nothing (an index
    gather, not JAX's mask einsum over every local expert: the same
    values)."""
    slot_of = device_tables(topo, w_local.device).local_slot_of[me]
    slot = torch.where(fids_all >= 0,
                       slot_of[torch.clamp(fids_all, min=0).long()], -1)
    hosted = (slot >= 0).to(w_local.dtype) / topo.hosts_per_expert
    idx = torch.clamp(slot, min=0).long()                    # [G, K]
    return w_local[idx] * hosted.reshape(hosted.shape
                                         + (1,) * (w_local.ndim - 1))


def dense_fetch(w_local: torch.Tensor, fids_all: torch.Tensor, me: int,
                topo: EPTopology, all_to_all_fn, fetch_chunk: int = 0
                ) -> torch.Tensor:
    """The JAX fetch (``repro/core/prefetch.py:66-100``): every source's
    ``dense_outbox`` through an even all-to-all, summed over sources.
    With ``fetch_chunk`` > 0 and a longer last dimension, the last
    dimension goes through in chunks of ``fetch_chunk`` (the last one
    zero-padded to that width, then cut), which bounds the outbox; the
    values are the same."""
    def one(w):
        return all_to_all_fn(dense_outbox(w, fids_all, me, topo)).sum(dim=0)

    F_ = w_local.shape[-1]
    if not fetch_chunk or F_ <= fetch_chunk:
        return one(w_local)
    parts = []
    for lo in range(0, F_, fetch_chunk):
        w = w_local[..., lo:lo + fetch_chunk]
        pad = fetch_chunk - w.shape[-1]
        parts.append(one(torch.nn.functional.pad(w, (0, pad)) if pad
                         else w)[..., :fetch_chunk - pad])
    return torch.cat(parts, dim=-1)


class _SideStream:
    """The communicator's side CUDA stream for the fetch: ``fork()`` makes
    it wait on the current stream (the fetch's inputs are ready) and
    enters it; the block's end records ``done`` on it."""

    def __init__(self, device: torch.device):
        self.stream = (torch.cuda.Stream(device) if device.type == "cuda"
                       else None)

    @contextlib.contextmanager
    def fork(self, *inputs: torch.Tensor):
        if self.stream is None:
            yield None
            return
        cur = torch.cuda.current_stream(self.stream.device)
        self.stream.wait_stream(cur)
        for t in inputs:                  # made on the current stream
            t.record_stream(self.stream)
        done = torch.cuda.Event()
        with torch.cuda.stream(self.stream):
            yield done
            done.record(self.stream)


class LocalComm:
    """The single-rank communicator: rank 0 of a group of one, where every
    collective is the identity (up to the stacked source axis)."""
    rank = 0
    size = 1
    ranks_here = (0,)

    def all_gather(self, x: torch.Tensor, mode: str = "") -> torch.Tensor:
        return x[None]

    def all_to_all(self, x: torch.Tensor) -> torch.Tensor:
        return x

    def psum(self, x: torch.Tensor) -> torch.Tensor:
        return x

    def pmax(self, x: torch.Tensor) -> torch.Tensor:
        return x

    def fetch_rows(self, w_local, fids_all, me, topo, fetch_chunk=0):
        # one rank hosts every expert, so FIDS is all -1: zeros
        return Fetched(dense_fetch(w_local, fids_all, me, topo,
                                   self.all_to_all, fetch_chunk))

    def expert_rows(self, w: torch.Tensor, rank: int, epr: int):
        return w

    def enter(self, x: torch.Tensor) -> torch.Tensor:
        return x

    def rank0_mean_grad(self, values: List[torch.Tensor]) -> torch.Tensor:
        return values[0]

    def run_ranks(self, make_body: Callable[[int], Body]) -> List[object]:
        return [run(self, make_body(0))]


FETCH_FORMS = ("dense", "hosted")


class DistComm:
    """One expert-parallel rank per process over ``torch.distributed``
    (gloo or NCCL).  Expert weights come as this rank's own rows
    ``[epr, ...]`` (``convert.expert_shard``).  ``fetch`` picks the
    foreign fetch's form (module docstring): ``"dense"`` (capturable) or
    ``"hosted"`` (eager only); ``describe()`` reports it with the backend.
    ``fetch_bytes`` counts the bytes of expert rows this rank has sent to
    other ranks through the MoE blocks' fetch, ``swap_bytes`` those sent
    through the serve engine's replica swap (``placement.ReplicaSwap``,
    the same fetch into a lasting destination).  On the card the fetch
    runs on a side stream (``_SideStream``).  A backend that refuses what
    is asked of it raises: nothing is copied to the host to get round
    it."""

    def __init__(self, group=None, *, fetch: str = "dense"):
        import torch.distributed as dist
        if not dist.is_available() or not dist.is_initialized():
            raise RuntimeError("DistComm needs an initialized "
                               "torch.distributed process group")
        if fetch not in FETCH_FORMS:
            raise ValueError(f"unknown fetch form {fetch!r}; choose one of "
                             f"{FETCH_FORMS}")
        self._dist = dist
        self.group = group
        self.rank = dist.get_rank(group)
        self.size = dist.get_world_size(group)
        self.ranks_here = (self.rank,)
        self.backend = str(dist.get_backend(group))
        self.fetch = fetch
        self.fetch_bytes = 0
        self.swap_bytes = 0
        self._side: Optional[_SideStream] = None     # made at the first fetch

    def describe(self) -> Dict[str, object]:
        """What runs the collectives: the backend, the fetch form, and
        whether the backend's collectives can be captured (NCCL's can,
        gloo's cannot)."""
        return {"kind": "DistComm", "backend": self.backend,
                "world_size": self.size, "fetch": self.fetch,
                "capturable": self.capturable}

    @property
    def capturable(self) -> bool:
        return self.backend == "nccl" and self.fetch == "dense"

    def all_gather(self, x: torch.Tensor, mode: str = "") -> torch.Tensor:
        if _records(x):
            return _DistAllGather.apply(x, self, mode == "per_rank")
        return self._all_gather(x)

    def _all_gather(self, x: torch.Tensor) -> torch.Tensor:
        shape = tuple(x.shape)
        flat = x.contiguous().reshape(-1)
        out = flat.new_empty((self.size * flat.numel(),))
        self._dist.all_gather_into_tensor(out, flat, group=self.group)
        return out.reshape((self.size,) + shape)

    def all_to_all(self, x: torch.Tensor) -> torch.Tensor:
        """``x`` [G_dst, ...] -> [G_src, ...]: even splits, one slice of
        axis 0 to each rank (the axis must be the group's size)."""
        if x.shape[0] != self.size:
            raise ValueError(f"DistComm.all_to_all splits axis 0 evenly "
                             f"over {self.size} ranks, got {x.shape[0]}")
        if _records(x):
            return _DistAllToAll.apply(x, self)
        return self._all_to_all(x)

    def _all_to_all(self, x: torch.Tensor) -> torch.Tensor:
        x = x.contiguous()
        out = torch.empty_like(x)
        self._dist.all_to_all_single(out, x, group=self.group)
        return out

    def psum(self, x: torch.Tensor) -> torch.Tensor:
        if _records(x):
            return _DistPsum.apply(x, self)
        return self._psum(x)

    def _psum(self, x: torch.Tensor) -> torch.Tensor:
        out = x.clone()
        self._dist.all_reduce(out, group=self.group)
        return out

    def pmax(self, x: torch.Tensor) -> torch.Tensor:
        out = x.clone()
        self._dist.all_reduce(out, op=self._dist.ReduceOp.MAX,
                              group=self.group)
        return out

    def enter(self, x: torch.Tensor) -> torch.Tensor:
        """``x``, replicated over the group, as the input of this rank's
        own work: under autograd its backward sums the ranks'
        cotangents."""
        return _DistEnter.apply(x, self) if _records(x) else x

    def rank0_mean_grad(self, values: List[torch.Tensor]) -> torch.Tensor:
        """Rank 0's value of this rank's scalar ``values[0]`` (one
        collective), whose backward gives this rank the cotangent over
        the group's size."""
        return _DistRank0.apply(values[0], self)

    def rank0_value(self, value: float) -> float:
        """Rank 0's ``value`` on every rank (the serve engine's per-step
        clock reading; a CPU tensor on gloo, a device one on NCCL)."""
        dev = (torch.device("cuda", torch.cuda.current_device())
               if self.backend == "nccl" else torch.device("cpu"))
        t = torch.tensor([value], dtype=torch.float64, device=dev)
        src = 0 if self.group is None else self._dist.get_global_rank(
            self.group, 0)
        self._dist.broadcast(t, src=src, group=self.group)
        return float(t.cpu())

    def fetch_rows(self, w_local, fids_all, me, topo, fetch_chunk=0, *,
                   count: str = "fetch_bytes"):
        """``count``: the counter the bytes sent go to (``"fetch_bytes"``
        or ``"swap_bytes"``)."""
        if (self.fetch == "hosted" and w_local.is_cuda
                and torch.cuda.is_current_stream_capturing()):
            raise RuntimeError(
                "DistComm(fetch='hosted') reads FIDS on the host and cannot "
                "run inside a CUDA graph capture; use fetch='dense'")
        if self._side is None:
            self._side = _SideStream(w_local.device)
        with self._side.fork(fids_all) as done:
            if self.fetch == "dense":
                rows = dense_fetch(w_local, fids_all, me, topo,
                                   self.all_to_all, fetch_chunk)
                sent = (w_local[0].numel() * w_local.element_size()
                        * fids_all.shape[1] * (self.size - 1))
            else:
                plan = self._hosted_plan(w_local, fids_all, me, topo)
                rows = (_DistHostedFetch.apply(w_local, self, plan)
                        if _records(w_local)
                        else self._hosted_fetch(w_local, plan))
                sent = (len(plan[0]) * w_local[0].numel()
                        * w_local.element_size())
        setattr(self, count, getattr(self, count) + sent)
        return Fetched(rows, done)

    def _hosted_plan(self, w_local, fids_all, me, topo):
        """The hosted fetch's exchange, read from FIDS on the host: the
        slots this rank sends (in destination, then k order) and each
        destination's count, and the k of each row it receives (in
        source order) and each source's count."""
        if topo.hosts_per_expert != 1:
            raise ValueError("the hosted fetch needs hosts_per_expert == 1 "
                             f"(got {topo.hosts_per_expert}); use "
                             f"fetch='dense'")
        fids = fids_all.cpu().numpy()                        # host sync
        lso = local_slot_of(topo)                            # [G, Ep]
        G, K = fids.shape
        host = np.where(fids >= 0, topo.host_of[np.maximum(fids, 0), 0], -1)
        send_slots = [int(lso[me, fids[dst, k]]) for dst in range(G)
                      for k in range(K) if host[dst, k] == me]
        in_splits = [int((host[dst] == me).sum()) for dst in range(G)]
        recv_k = [k for src in range(G) for k in range(K)
                  if host[me, k] == src]
        out_splits = [int((host[me] == src).sum()) for src in range(G)]
        return (send_slots, in_splits, recv_k, out_splits, K,
                bool((host >= 0).any()))

    def _hosted_fetch(self, w_local, plan):
        """Each source sends each destination only the rows it hosts, in
        k order; the destination puts them at their k and zeros
        elsewhere (``plan``: ``_hosted_plan``)."""
        send_slots, in_splits, recv_k, out_splits, K, any_sent = plan
        out = w_local.new_zeros((K,) + tuple(w_local.shape[1:]))
        if not any_sent:                   # no rank sends: skip the call
            return out
        dev = w_local.device
        send = w_local[torch.tensor(send_slots, dtype=torch.long,
                                    device=dev)]
        recv = w_local.new_empty((len(recv_k),) + tuple(w_local.shape[1:]))
        self._dist.all_to_all_single(recv, send, output_split_sizes=out_splits,
                                     input_split_sizes=in_splits,
                                     group=self.group)
        out[torch.tensor(recv_k, dtype=torch.long, device=dev)] = recv
        return out

    def expert_rows(self, w: torch.Tensor, rank: int, epr: int):
        if w.shape[0] != epr:
            raise ValueError(f"DistComm takes each rank's own {epr} expert "
                             f"rows, got {w.shape[0]}")
        return w

    def run_ranks(self, make_body: Callable[[int], Body]) -> List[object]:
        return [run(self, make_body(self.rank))]


class _DistAllGather(torch.autograd.Function):
    """``DistComm.all_gather`` under autograd: the cotangent of a
    replicated result is whole on every process, so this rank's input
    takes its own slice; with ``per_rank`` the result fed each rank's
    own work, and the ranks' cotangents are summed first."""

    @staticmethod
    def forward(ctx, x, comm, per_rank):
        ctx.comm, ctx.per_rank = comm, per_rank
        return comm._all_gather(x)

    @staticmethod
    def backward(ctx, ct):
        comm = ctx.comm
        if ctx.per_rank:
            ct = comm._psum(ct)
        return ct[comm.rank].clone(), None, None


class _DistAllToAll(torch.autograd.Function):
    """``DistComm.all_to_all`` under autograd: the backward is the
    reverse exchange (an even all-to-all is its own transpose)."""

    @staticmethod
    def forward(ctx, x, comm):
        ctx.comm = comm
        return comm._all_to_all(x)

    @staticmethod
    def backward(ctx, ct):
        return ctx.comm._all_to_all(ct), None


class _DistPsum(torch.autograd.Function):
    """``DistComm.psum`` under autograd: each rank's partial gets the
    replicated sum's whole cotangent."""

    @staticmethod
    def forward(ctx, x, comm):
        return comm._psum(x)

    @staticmethod
    def backward(ctx, ct):
        return ct, None


class _DistEnter(torch.autograd.Function):
    """The identity into a rank's own work; its backward sums the
    ranks' cotangents of a replicated tensor."""

    @staticmethod
    def forward(ctx, x, comm):
        ctx.comm = comm
        return x.view_as(x)

    @staticmethod
    def backward(ctx, ct):
        return ctx.comm._psum(ct.contiguous()), None


class _DistRank0(torch.autograd.Function):
    """Rank 0's value of a per-rank scalar on every rank; each rank's
    own gets the cotangent over the group's size (the ranks' mean)."""

    @staticmethod
    def forward(ctx, x, comm):
        ctx.size = comm.size
        return comm._all_gather(x)[0]

    @staticmethod
    def backward(ctx, ct):
        return ct / ctx.size, None


class _DistHostedFetch(torch.autograd.Function):
    """The hosted fetch under autograd: the backward sends each
    received row's cotangent back to its hosting rank (the exchange
    reversed, split sizes swapped), which adds it into the rows it
    sent."""

    @staticmethod
    def forward(ctx, w_local, comm, plan):
        ctx.comm, ctx.plan, ctx.shape = comm, plan, tuple(w_local.shape)
        return comm._hosted_fetch(w_local, plan)

    @staticmethod
    def backward(ctx, ct):
        send_slots, in_splits, recv_k, out_splits, _, any_sent = ctx.plan
        grad = ct.new_zeros(ctx.shape)
        if not any_sent:
            return grad, None, None
        dev = ct.device
        back = ct[torch.tensor(recv_k, dtype=torch.long,
                               device=dev)].contiguous()
        sent = ct.new_empty((len(send_slots),) + ctx.shape[1:])
        ctx.comm._dist.all_to_all_single(
            sent, back, output_split_sizes=in_splits,
            input_split_sizes=out_splits, group=ctx.comm.group)
        grad.index_add_(0, torch.tensor(send_slots, dtype=torch.long,
                                        device=dev), sent)
        return grad, None, None


class _Rank0MeanGrad(torch.autograd.Function):
    """``VirtualGroup.rank0_mean_grad``: rank 0's value, each rank's
    scalar the cotangent over the group's size."""

    @staticmethod
    def forward(ctx, *values):
        ctx.n = len(values)
        return values[0].clone()

    @staticmethod
    def backward(ctx, ct):
        return (ct / ctx.n,) * ctx.n


def _adjacent_view(xs: List[torch.Tensor]) -> Optional[torch.Tensor]:
    """[G, ...] as a view when the G tensors are back-to-back slices of
    one storage (each rank's expert rows of a rank-major weight), else
    None.  Under autograd, with a tensor that requires grad, None too: a
    view strided out of rank 0's slice would send the gradient of every
    rank's rows to rank 0's alone (the caller stacks instead)."""
    x0 = xs[0]
    if torch.is_grad_enabled() and any(x.requires_grad for x in xs):
        return None
    n = x0.numel()
    for g, x in enumerate(xs):
        if (x.untyped_storage().data_ptr()
                != x0.untyped_storage().data_ptr()
                or x.shape != x0.shape or x.dtype != x0.dtype
                or not x.is_contiguous()
                or x.storage_offset() != x0.storage_offset() + g * n):
            return None
    return x0.as_strided((len(xs),) + tuple(x0.shape),
                         (n,) + tuple(x0.stride()), x0.storage_offset())


class VirtualGroup:
    """G expert-parallel ranks in one process, on one device, run in
    lockstep (module docstring).  Expert weights come as the rank-major
    tensors ``[G * epr, ...]``; each rank's rows are a view of them, and
    gathering them back is that tensor again, not a copy."""

    def __init__(self, size: int, device=None):
        if size < 1:
            raise ValueError("a VirtualGroup needs at least one rank")
        self.size = size
        self.ranks_here = tuple(range(size))
        dev = resolve_device(device)
        if dev.type == "cuda" and dev.index is None:
            dev = torch.device("cuda", torch.cuda.current_device())
        self.device = dev
        self._side = _SideStream(dev)

    def expert_rows(self, w: torch.Tensor, rank: int, epr: int):
        if w.shape[0] != self.size * epr:
            raise ValueError(f"VirtualGroup takes the rank-major rows of all "
                             f"{self.size} ranks, got {w.shape[0]}")
        return w[rank * epr:(rank + 1) * epr]

    def enter(self, x: torch.Tensor) -> torch.Tensor:
        return x            # one graph over every rank: nothing to sum

    def rank0_mean_grad(self, values: List[torch.Tensor]) -> torch.Tensor:
        return _Rank0MeanGrad.apply(*values) if _records(*values) \
            else values[0]

    def run_ranks(self, make_body: Callable[[int], Body]) -> List[object]:
        bodies = [make_body(g) for g in range(self.size)]
        answers: List[Optional[torch.Tensor]] = [None] * self.size
        while True:
            reqs, done = [], []
            for body, ans in zip(bodies, answers):
                try:
                    reqs.append(body.send(ans))
                except StopIteration as stop:
                    done.append(stop.value)
            if done:
                if len(done) != self.size:
                    raise RuntimeError("ranks of a VirtualGroup left the "
                                       "lockstep at different collectives")
                return done
            ops = {r.op for r in reqs}
            if len(ops) != 1:
                raise RuntimeError(f"ranks of a VirtualGroup asked for "
                                   f"different collectives: {sorted(ops)}")
            xs = [r.x for r in reqs]
            for x in xs:
                if x.device != self.device:
                    raise ValueError(f"VirtualGroup on {self.device} got a "
                                     f"tensor on {x.device}")
            answers = getattr(self, "_" + reqs[0].op)(
                xs, *(([r.args for r in reqs],) if reqs[0].args else ()))
            for watch in WATCHERS:
                watch(reqs[0].op, xs, answers)

    def _all_gather(self, xs, args=None):
        out = _adjacent_view(xs)
        if out is None:
            out = torch.stack(xs)
        return [out] * self.size

    def _all_to_all(self, xs):
        st = torch.stack(xs)                        # [G_src, G_dst, ...]
        return [st[:, dst] for dst in range(self.size)]

    def _psum(self, xs):
        total = xs[0]
        for x in xs[1:]:
            total = total + x                       # rank order
        return [total] * self.size

    def _pmax(self, xs):
        top = xs[0]
        for x in xs[1:]:
            top = torch.maximum(top, x)
        return [top] * self.size

    def _fetch_rows(self, xs, args):
        """Every destination's foreign rows in one gather from the
        rank-major weight (a view when the ranks' rows are adjacent):
        row ``expert_row[id]``, zeros for -1.  FIDS is replicated, so
        rank 0's copy serves all."""
        fids_all, _, topo, _ = args[0]
        if topo.hosts_per_expert != 1:
            raise ValueError("the VirtualGroup fetch gathers one hosting "
                             "row an expert: it needs hosts_per_expert == 1 "
                             f"(got {topo.hosts_per_expert})")
        w_all = _adjacent_view(xs)
        if w_all is None:
            w_all = torch.stack(xs)
        w_all = w_all.reshape((-1,) + tuple(xs[0].shape[1:]))
        # under autograd w_all is a stack made here on the current stream
        # and freed on return (the gather's backward keeps no reference):
        # the side stream's gather must keep its memory from reuse
        with self._side.fork(fids_all, w_all) as done:
            rows = device_tables(topo, self.device).expert_row[
                torch.clamp(fids_all, min=0).long()]         # [G, K]
            keep = (fids_all >= 0).to(w_all.dtype)
            out = w_all[rows] * keep.reshape(
                keep.shape + (1,) * (w_all.ndim - 1))       # [G_dst, K, ...]
        return [Fetched(out[g], done) for g in range(self.size)]


class DispatchLayout(NamedTuple):
    unit_dest: torch.Tensor        # [U] destination rank per unit
    unit_pair_pos: torch.Tensor    # [U] row within the (me -> dest) pair chunk
    unit_row_self: torch.Tensor    # [U] grouped-buffer row for self units
    row_target: torch.Tensor       # [G, c_pair] grouped-buffer row per recv row
    row_valid: torch.Tensor        # [G, c_pair] bool
    group_sizes: torch.Tensor      # [n_groups] real rows per group
    group_offsets: torch.Tensor    # [n_groups] block-aligned start row per group
    group_expert: torch.Tensor     # [n_groups] expert id per group (-1 = inactive)
    fids: torch.Tensor             # [K] foreign expert ids on this rank (-1 = none)
    send_drops: torch.Tensor
    dest_drops: torch.Tensor


def round_up_j(x: torch.Tensor, m: int) -> torch.Tensor:
    return ((x + m - 1) // m) * m


def _excl_cumsum(x: torch.Tensor, dim: int) -> torch.Tensor:
    return (torch.cumsum(x, dim=dim) - x).to(x.dtype)


def _scatter_drop(n: int, idx: torch.Tensor, vals: torch.Tensor, *,
                  fill: int, add: bool = False) -> torch.Tensor:
    """``full(n, fill).at[idx].set|add(vals, mode="drop")``: indices outside
    [0, n) go to a dump row ``n``, which is cut off."""
    out = torch.full((n + 1,), fill, dtype=vals.dtype, device=vals.device)
    to = torch.where((idx >= 0) & (idx < n), idx, n).long()
    if add:
        out.index_add_(0, to, vals)
    else:
        out[to] = vals
    return out[:n]


def replica_slot_map(replica_ids: torch.Tensor,
                     padded_experts: int) -> torch.Tensor:
    """replica_ids [..., R] int32 (-1 = empty slot) -> [..., Ep] expert ->
    slot map (-1 = no replica): a one-hot max, with no scatter and no host
    read, so one captured step serves every slot assignment.  The highest
    slot wins a (degenerate) duplicate."""
    R = replica_ids.shape[-1]
    dev = replica_ids.device
    tgt = torch.where(replica_ids >= 0, replica_ids, padded_experts)
    onehot = tgt[..., :, None] == torch.arange(padded_experts,
                                               dtype=torch.int32, device=dev)
    slots = torch.arange(R, dtype=torch.int32, device=dev)[:, None]
    return torch.where(onehot, slots, -1).amax(dim=-2)


def build_layout(S: torch.Tensor, assign: torch.Tensor, me: int,
                 topo: EPTopology, *, c_pair: int, c_total: int,
                 num_foreign_slots: int, block_m: int,
                 num_replica_slots: int = 0,
                 replica_ids_me: Optional[torch.Tensor] = None
                 ) -> DispatchLayout:
    """Derive the full dispatch layout from schedule S [G, Ep, G] and the
    local assignment ``assign`` [T, k] (values in [0, Ep]; the sentinel Ep
    marks padding units that are never scheduled); ``replica_ids_me`` [R]
    the experts in this rank's replica slots (-1 = empty)."""
    dev = assign.device
    i32 = torch.int32
    G, Ep = topo.num_ranks, topo.padded_experts
    epr = topo.experts_per_rank
    K = num_foreign_slots
    R = num_replica_slots
    with_replicas = bool(R) and replica_ids_me is not None
    n_groups = epr + R + K
    unit_expert = assign.reshape(-1).to(i32)               # [U], token-major
    ue = unit_expert.long()
    U = unit_expert.shape[0]
    is_pad_unit = unit_expert >= Ep
    S = S.to(i32)

    # ---- sender side (histograms carry an extra row for the sentinel) ----
    counts_local = expert_counts(ue, Ep + 1)
    sort_idx = torch.argsort(unit_expert, stable=True)
    start_of_expert = _excl_cumsum(counts_local, 0)
    r_sorted = (torch.arange(U, dtype=i32, device=dev)
                - start_of_expert[ue[sort_idx]])
    r = torch.empty(U, dtype=i32, device=dev)
    r[sort_idx] = r_sorted

    S_me = torch.cat([S[me], torch.zeros((1, G), dtype=i32, device=dev)])
    dcum = torch.cat([torch.zeros((Ep + 1, 1), dtype=i32, device=dev),
                      torch.cumsum(S_me, dim=1).to(i32)], dim=1)  # [Ep+1, G+1]
    dcum_u = dcum[ue]                                       # [U, G+1]
    unit_dest = (r[:, None] >= dcum_u[:, 1:]).sum(dim=1).to(i32)
    unit_dest = torch.clamp(unit_dest, max=G - 1)
    ud = unit_dest.long()
    scheduled = (r < dcum_u[:, G]) & ~is_pad_unit
    pair_e_off = _excl_cumsum(S_me, 0)                      # [Ep+1, G]
    unit_pair_pos = pair_e_off[ue, ud] + r - dcum[ue, ud]

    # ---- receiver-side group structure -----------------------------------
    recv_counts = S[:, :, me]                               # [G_src, Ep]
    tok_e = recv_counts.sum(dim=0).to(i32)                  # [Ep]
    tables = device_tables(topo, dev)
    my_local_slot = tables.local_slot_of[me]
    if with_replicas:
        rep_slot = replica_slot_map(replica_ids_me, Ep)
    else:
        rep_slot = torch.full((Ep,), -1, dtype=i32, device=dev)
    is_replica = (my_local_slot < 0) & (rep_slot >= 0)
    is_foreign_active = (tok_e > 0) & (my_local_slot < 0) & ~is_replica
    foreign_rank = (torch.cumsum(is_foreign_active.to(i32), 0) - 1).to(i32)
    ar_e = torch.arange(Ep, dtype=i32, device=dev)
    scatter_idx = torch.where(is_foreign_active,
                              torch.clamp(foreign_rank, max=K), K)
    fids = _scatter_drop(K + 1, scatter_idx, ar_e, fill=-1)[:K]
    # local slot j -> group j; replica slot r -> epr + r; k-th foreign ->
    # epr + R + k; n_groups: no group (dropped)
    grp_of_e = torch.where(
        my_local_slot >= 0, my_local_slot,
        torch.where(is_replica, epr + rep_slot,
                    torch.where(is_foreign_active & (foreign_rank < K),
                                epr + R + foreign_rank, n_groups))).to(i32)
    grp_c = torch.clamp(grp_of_e, max=n_groups)
    group_expert = _scatter_drop(n_groups + 1, grp_c, ar_e, fill=-1)
    group_expert[:epr] = tables.slot_map[me]
    if with_replicas:
        group_expert[epr:epr + R] = replica_ids_me
    group_expert = group_expert[:n_groups]
    group_sizes = _scatter_drop(n_groups + 1, grp_c, tok_e, fill=0,
                                add=True)[:n_groups]
    padded = round_up_j(group_sizes, block_m)
    group_offsets = _excl_cumsum(padded, 0)
    overflow_rows = torch.minimum(
        torch.clamp(group_offsets + padded - c_total, min=0), group_sizes)
    wgo = _excl_cumsum(recv_counts, 0)                      # [G_src, Ep]

    # ---- receiver side: map each recv row (g, c) -> grouped row ----------
    ecum = torch.cat([torch.zeros((G, 1), dtype=i32, device=dev),
                      torch.cumsum(recv_counts, dim=1).to(i32)], dim=1)
    c_idx = torch.arange(c_pair, dtype=i32, device=dev)
    e_row = torch.searchsorted(ecum[:, 1:].contiguous(),
                               c_idx.expand(G, c_pair).contiguous(),
                               right=True).to(i32)
    e_row = torch.clamp(e_row, max=Ep - 1)
    el = e_row.long()
    r_rel = c_idx[None, :] - torch.gather(ecum, 1, el)
    pair_total = ecum[:, Ep]
    row_valid = ((c_idx[None, :] < pair_total[:, None])
                 & (torch.arange(G, device=dev)[:, None] != me))
    grp_row = grp_of_e[el]                                  # [G, c_pair]
    row_target = (group_offsets[torch.clamp(grp_row, max=n_groups - 1).long()]
                  + torch.gather(wgo, 1, el) + r_rel)
    row_valid = row_valid & (grp_row < n_groups)
    row_target = torch.where(row_valid, row_target, c_total).to(i32)

    # ---- self units: grouped row computed sender-side ----------------------
    ue_c = torch.clamp(ue, max=Ep - 1)
    grp_u = grp_of_e[ue_c]
    unit_row_self = (group_offsets[torch.clamp(grp_u, max=n_groups - 1).long()]
                     + wgo[me][ue_c] + (r - dcum[ue, ud]))
    unit_row_self = torch.where((unit_dest == me) & scheduled
                                & (grp_u < n_groups),
                                unit_row_self, c_total).to(i32)

    send_valid = (unit_dest != me) & scheduled & (unit_pair_pos < c_pair)
    send_drops = ((unit_dest != me) & scheduled
                  & (unit_pair_pos >= c_pair)).sum()
    dest_drops = overflow_rows.sum() + (tok_e * (grp_of_e == n_groups)).sum()
    unit_pair_pos = torch.where(send_valid, unit_pair_pos, c_pair).to(i32)
    return DispatchLayout(
        unit_dest=unit_dest, unit_pair_pos=unit_pair_pos,
        unit_row_self=unit_row_self, row_target=row_target,
        row_valid=row_valid, group_sizes=group_sizes,
        group_offsets=group_offsets, group_expert=group_expert, fids=fids,
        send_drops=send_drops.to(i32), dest_drops=dest_drops.to(i32))


def dispatch(x_units: torch.Tensor, layout: DispatchLayout, *,
             num_ranks: int, c_pair: int, c_total: int):
    """Scatter local units [U, d] to the grouped buffers of their
    destinations; returns (a body generator's result) this rank's grouped
    buffer [c_total, d]."""
    G = num_ranks
    d = x_units.shape[-1]
    # column c_pair and row c_total are dump rows for the units and
    # receive rows that have no place (unit_pair_pos / row targets at or
    # past the bound); both are cut off
    send = torch.zeros((G, c_pair + 1, d), dtype=x_units.dtype,
                       device=x_units.device)
    send[layout.unit_dest.long(),
         torch.clamp(layout.unit_pair_pos, max=c_pair).long()] = x_units
    recv = (yield from all_to_all(send[:, :c_pair])).reshape(G * c_pair, d)
    grouped = torch.zeros((c_total + 1, d), dtype=x_units.dtype,
                          device=x_units.device)
    tgt = torch.clamp(layout.row_target.reshape(-1), max=c_total).long()
    grouped[tgt] = recv * layout.row_valid.reshape(-1, 1).to(recv.dtype)
    # self units go straight into the grouped buffer (no wire bytes)
    grouped[torch.clamp(layout.unit_row_self, max=c_total).long()] = x_units
    return grouped[:c_total]


def combine(out_grouped: torch.Tensor, layout: DispatchLayout, *,
            num_ranks: int, c_pair: int, gates: torch.Tensor, top_k: int):
    """Return processed rows to their source ranks and gate-combine
    (a body generator; its result is [T, d])."""
    G = num_ranks
    d = out_grouped.shape[-1]
    c_total = out_grouped.shape[0]
    padded_out = torch.cat([out_grouped, out_grouped.new_zeros((1, d))])
    back = padded_out[torch.clamp(layout.row_target, max=c_total).long()]
    back = back * layout.row_valid[..., None].to(back.dtype)
    ret = yield from all_to_all(back)                       # [G, c_pair, d]
    pad_ret = torch.cat([ret, ret.new_zeros((G, 1, d))], dim=1)
    y_remote = pad_ret[layout.unit_dest.long(),
                       torch.clamp(layout.unit_pair_pos, max=c_pair).long()]
    y_self = padded_out[torch.clamp(layout.unit_row_self, max=c_total).long()]
    is_self = (layout.unit_row_self < c_total)[:, None].to(y_self.dtype)
    y_units = y_self * is_self + y_remote * (1 - is_self)
    T = y_units.shape[0] // top_k
    return (y_units.reshape(T, top_k, d)
            * gates.reshape(T, top_k, 1).to(y_units.dtype)).sum(dim=1)
