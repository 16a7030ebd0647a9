"""The HarMoEny MoE block — paper Algorithm 1, once per EP rank.

Port of ``repro/core/moe_layer.py`` (``MoEBlockSpec``, ``moe_block`` and
``_moe_forward_local`` in expert-parallel mode).  Data flow per rank:
  1. token routing          -> route_topk (router.py)
  2. metadata exchange      -> all_gather of the [Ep] count histogram
  3. token scheduling       -> replicated deterministic schedule (scheduler.py)
  4. scatter tokens         -> static-capacity all_to_all (dispatch.py)
  5. expert processing      -> grouped FFN (the moe_gmm kernel) + the
                               foreign-weight fetch (prefetch.py), issued
                               right after step 3 (on the card on a side
                               stream) and joined just before the FFN
  6. gather tokens          -> reverse all_to_all + gate combine (dispatch.py)
The body is a generator that yields its collectives, so one body runs on
every communicator of ``dispatch.py``: one rank (``LocalComm``), G ranks
in one process (``VirtualGroup``) or one rank per process (``DistComm``).
x comes replicated over the EP group and each rank routes its token
slice: a contiguous slice of the flattened tokens, or with
``spec.seq_sharded`` (JAX's sequence-sharded island, which
``build_model`` sets where the length divides over G) positions
[g S / G, (g + 1) S / G) of every row.  With a ``SkewKey`` the router
is the paper's synthetic skew (``route_skewed``), each rank drawing on
the key folded with its rank, as the JAX block folds its key; a captured
decode step cannot draw, so it takes the same draws made before the step
(``skew_assign``, one ``[t_slice, k]`` slice a rank:
``serve/stepcore.py``).  Nothing here reads a device value on the host.

Serving-time expert placement (paper §4.2-4.3): with
``num_replica_slots`` R > 0 the block carries ``w_rep_*`` leaves of
``G * R`` rows (zeros at init; ``serve/rebalance.py`` copies hot experts'
rows into them in place), and ``replica_ids`` [G, R] (-1 = empty) names
their experts: replica holders count as local destinations in the
schedule, take their groups between the local and foreign ones, and fetch
nothing for them.  ``residency_ids`` [G, W] (``serve/residency.py``)
demotes statically placed experts outside a rank's working set to
foreign destinations in the harmoeny schedule.  Both tables are device
tensors, so changing them changes values only.

Tensor-parallel MoE (``spec.tp_mode``, which ``build_model`` sets when
E < G: mixtral's 8 experts on 16 ranks; ``tp_moe_block``): every rank
holds a contiguous d_ff slice of every expert, sees every token, runs
the grouped FFN (``moe_gmm``) on its slice over one block-aligned buffer
of all the units, and the partial outputs are summed over the ranks
(``psum``), as JAX's ``tp_moe_block``: no schedule, no fetch, no drops.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Callable, Dict, Optional, Tuple

import torch
import torch.nn.functional as F

from repro_torch.configs.base import MoEConfig, round_up
from repro_torch.core import dispatch as D
from repro_torch.core import prefetch
from repro_torch.core.grouped_ffn import grouped_ffn, grouped_ffn_ref
from repro_torch.core.qthreshold import q_threshold
from repro_torch.core.dispatch import replica_slot_map
from repro_torch.core.router import (SkewKey, expert_counts, route_assigned,
                                    route_skewed, route_topk)
from repro_torch.core.scheduler import schedule
from repro_torch.core.topology import EPTopology, device_tables, make_topology

# diagnostic keys every MoE block emits; scalars are [1]-shaped, vectors
# [1, N] (N = ranks / experts), as in the JAX package
SCALAR_DIAGS = ("aux_loss", "send_drops", "dest_drops", "sched_iters",
                "moved_units", "max_load_before", "max_load_after",
                "mean_load")
VECTOR_DIAGS = ("rank_load", "expert_load")


@dataclass(frozen=True)
class MoEBlockSpec:
    """Static plumbing for one MoE block."""
    moe: MoEConfig
    d_model: int
    ep_degree: int = 1
    tokens_local: int = 1        # tokens per step (per batch group)
    block_m: int = 128
    cf_pair: float = 2.0
    act: str = "silu"            # expert activation; gated experts carry w_gate
    fetch_chunk: int = 2048      # the dense fetch's last-dim chunk (JAX's)
    # tensor-parallel MoE: every rank holds a d_ff slice of every expert
    # (the block's expert rows are rank-major slices, ``tp_moe_block``)
    tp_mode: bool = False
    # sequence-sharded slices (JAX's): rank g routes positions
    # [g S / G, (g + 1) S / G) of every row, not a contiguous slice of
    # the flattened tokens; needs S % G == 0 (``moe_block``)
    seq_sharded: bool = False

    @property
    def topo(self) -> EPTopology:
        assert not self.tp_mode, "tensor-parallel MoE has no EP topology"
        return make_topology(self.ep_degree, self.moe.num_experts,
                             placement=self.moe.placement)

    @property
    def t_pad(self) -> int:
        return round_up(max(self.tokens_local, self.ep_degree), self.ep_degree)

    @property
    def t_slice(self) -> int:
        return self.t_pad // self.ep_degree

    @property
    def units_per_rank(self) -> int:
        return self.t_slice * self.moe.num_experts_per_tok

    @property
    def c_pair(self) -> int:
        per_dest = -(-self.units_per_rank // self.ep_degree)  # ceil
        return max(int(self.cf_pair * per_dest), 8)

    @property
    def n_groups(self) -> int:
        # compute-buffer group order: local | replica | foreign
        return (self.topo.experts_per_rank + self.moe.num_replica_slots
                + self.moe.num_foreign_slots)

    @property
    def c_total(self) -> int:
        cap = int(self.moe.capacity_factor * self.units_per_rank)
        return round_up(max(cap, self.block_m), self.block_m) \
            + self.n_groups * self.block_m

    @property
    def q(self) -> int:
        if self.moe.q_tokens:
            return self.moe.q_tokens
        return q_threshold(ep_degree=self.ep_degree, dense_fetch=True)


def _moe_forward_local(x_rep: torch.Tensor, params: Dict[str, torch.Tensor],
                       spec: MoEBlockSpec, n_valid: int, me: int,
                       skew_key: Optional[SkewKey] = None,
                       valid_rep: Optional[torch.Tensor] = None,
                       skew_assign: Optional[torch.Tensor] = None,
                       replica_ids: Optional[torch.Tensor] = None,
                       residency_ids: Optional[torch.Tensor] = None,
                       overlap: Optional[Callable[[], object]] = None,
                       kernels: bool = True):
    """Per-rank body of rank ``me``, a generator that yields its
    collectives (dispatch.py) and returns (y_rep, diagnostics, the
    result of ``overlap``).  x_rep: [t_pad, d] replicated over the EP
    group; ``params`` hold this rank's expert rows [epr, ...] (and replica
    rows [R, ...]) and the replicated router; ``skew_assign`` [t_slice, k]
    this rank's drawn skewed assignment; ``replica_ids`` [G, R] and
    ``residency_ids`` [G, W] the replicated placement tables (module
    docstring); ``overlap`` work independent of the block (the shared
    experts), run on the current stream while the fetch is in flight;
    ``kernels`` False runs the grouped FFN's reference
    (``grouped_ffn_ref``) in place of the kernel's entry."""
    topo, moe = spec.topo, spec.moe
    G, Ep = topo.num_ranks, topo.padded_experts
    epr = topo.experts_per_rank
    k = moe.num_experts_per_tok
    K = moe.num_foreign_slots
    R = moe.num_replica_slots                # moe_block passes the table
    dev = x_rep.device
    t_slice = x_rep.shape[0] // G
    x_slice = x_rep[me * t_slice:(me + 1) * t_slice]

    # --- step 1: routing (dead tokens get the sentinel expert Ep) ---------
    if skew_assign is not None:
        r_out = route_assigned(skew_assign, Ep)
    elif skew_key is not None and moe.router_skew > 0:
        r_out = route_skewed(skew_key.fold_in(me).generator(dev), t_slice,
                             top_k=k, num_experts=moe.num_experts,
                             padded_experts=Ep, alpha=moe.router_skew,
                             n_hot=moe.router_skew_experts)
    else:
        r_out = route_topk(x_slice, params["router"], top_k=k,
                           num_real_experts=moe.num_experts)
    valid_tok = me * t_slice + torch.arange(t_slice, device=dev) < n_valid
    if valid_rep is not None:
        valid_tok = valid_tok & valid_rep[me * t_slice:(me + 1) * t_slice]
    assign = torch.where(valid_tok[:, None], r_out.assign, Ep)
    counts = expert_counts(assign, Ep + 1)[:Ep]

    # --- step 2: metadata exchange ---------------------------------------
    m_all = yield from D.all_gather(counts)                  # [G, Ep]

    # --- step 3: replicated deterministic scheduling ------------------------
    # replica holders count as local destinations; experts swapped out of
    # a rank's working set stop counting as free ones
    extra_local = replica_slot_map(replica_ids, Ep) >= 0 if R else None
    non_local = (None if residency_ids is None
                 else prefetch.residency_non_local(residency_ids, topo))
    S, sdiag = schedule(m_all, topo, policy=moe.policy, q=spec.q,
                        c_pair=spec.c_pair, num_foreign_slots=K,
                        extra_local=extra_local, non_local=non_local)

    # --- step 5, first half: the foreign-weight fetch, issued as soon as
    # FIDS exist (on the card on the communicator's side stream) ----------
    names = ("w_in", "w_out", "w_gate")
    w_in, w_out, w_gate = (params.get(n) for n in names)
    replica = (tuple(params.get("w_rep_" + n[2:]) for n in names) if R
               else None)
    fetched = None
    if moe.policy != "even_split" and K > 0:
        fids_all = prefetch.all_foreign_ids(
            S, topo, K, replica_ids=replica_ids if R else None)
        fetched = []
        for w in (w_in, w_out, w_gate):
            fetched.append(None if w is None else (
                yield from prefetch.fetch_foreign_weights(
                    w, fids_all, me, topo, spec.fetch_chunk)))
    side_out = overlap() if overlap is not None else None

    # --- step 4: scatter, while the fetch is in flight ---------------------
    layout = D.build_layout(S, assign, me, topo, c_pair=spec.c_pair,
                            c_total=spec.c_total, num_foreign_slots=K,
                            block_m=spec.block_m,
                            num_replica_slots=moe.num_replica_slots,
                            replica_ids_me=replica_ids[me] if R else None)
    x_units = torch.repeat_interleave(x_slice, k, dim=0)   # token-major
    grouped = yield from D.dispatch(x_units, layout, num_ranks=G,
                                    c_pair=spec.c_pair, c_total=spec.c_total)

    # --- step 5: expert processing, joined with the fetch -----------------
    foreign = foreign_rows = None
    if moe.policy == "even_split":
        # full replication: every group row gathers its expert's weights
        rows = device_tables(topo, dev).expert_row
        ge = torch.clamp(layout.group_expert, 0, Ep - 1).long()
        full = []
        for w in (w_in, w_out, w_gate):
            if w is None:
                full.append(None)
                continue
            w_all = yield from prefetch.gather_all_experts(w)
            full.append(w_all[rows[ge]])
        w_in, w_out, w_gate = full
        replica = None          # the gather covers the replica groups too
    elif fetched is not None:
        foreign = tuple(None if f is None else prefetch.join(f)
                        for f in fetched)
        foreign_rows = layout.group_sizes[epr + R:].sum()
    sizes_padded = D.round_up_j(layout.group_sizes, spec.block_m)
    ffn = grouped_ffn if kernels else grouped_ffn_ref
    out_grouped = ffn(grouped, w_in, w_out, sizes_padded, w_gate=w_gate,
                      act=spec.act, block_m=spec.block_m, replica=replica,
                      foreign=foreign, foreign_rows=foreign_rows)

    # --- step 6: gather + combine ---------------------------------------------
    y_slice = yield from D.combine(out_grouped, layout, num_ranks=G,
                                   c_pair=spec.c_pair, gates=r_out.gates,
                                   top_k=k)
    y_rep = (yield from D.all_gather(y_slice)).reshape(-1, y_slice.shape[-1])

    t_g = S.sum(dim=(0, 1)).float()
    send_drops = yield from D.psum(layout.send_drops)
    dest_drops = yield from D.psum(layout.dest_drops)
    diag = {
        "aux_loss": r_out.aux_loss[None],
        "send_drops": send_drops[None].float(),
        "dest_drops": dest_drops[None].float(),
        "sched_iters": sdiag.iters[None].float(),
        "moved_units": sdiag.moved[None].float(),
        "max_load_before": sdiag.max_load_before[None].float(),
        "max_load_after": sdiag.max_load_after[None].float(),
        "mean_load": t_g.mean()[None],
        "rank_load": t_g[None, :],
        "expert_load": m_all.sum(dim=0).float()[None, :],
    }
    return y_rep, diag, side_out


def tp_layout(assign: torch.Tensor, E: int, block_m: int):
    """The tensor-parallel block's grouped buffer for expert ids ``assign``
    [T, k] (JAX's ``tp_moe_block``, op for op): per-expert ``sizes`` [E],
    their ``padded`` extents (multiples of ``block_m``), each unit's buffer
    ``row`` [T k] (its expert's group offset plus its rank among the
    expert's units in token order: a stable sort) and the buffer's rows
    ``m_pad = round_up(U, block_m) + E block_m``.  No host reads."""
    ue = assign.reshape(-1).long()
    U = ue.shape[0]
    sizes = expert_counts(ue, E)
    padded = D.round_up_j(sizes, block_m)
    offsets = torch.cumsum(padded, 0) - padded
    order = torch.sort(ue, stable=True).indices
    start = torch.cumsum(sizes, 0) - sizes
    r_sorted = torch.arange(U, device=ue.device) - start[ue[order]]
    rank_in_e = torch.empty_like(r_sorted).scatter_(0, order, r_sorted)
    return sizes, padded, offsets[ue] + rank_in_e, \
        round_up(U, block_m) + E * block_m


def tp_moe_block(x: torch.Tensor, params: Dict[str, torch.Tensor], *,
                 spec: MoEBlockSpec, comm,
                 skew_key: Optional[SkewKey] = None,
                 skew_assign: Optional[torch.Tensor] = None,
                 kernels: bool = True
                 ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """Tensor-parallel MoE (E < EP degree; JAX's ``tp_moe_block``).  Every
    rank routes all of x [B, S, d] alike (``route_topk``, or the skew
    router with ``padded_experts = E`` on ``skew_key`` unfolded by rank,
    or ``skew_assign`` [1, T, k] drawn beforehand), so the block-aligned
    grouped buffer of all U = T k units is built once: groups in expert
    order, each padded to ``block_m`` rows, units stable-sorted by expert.
    Each rank runs the grouped FFN on its own d_ff slice of every expert
    (``params``' expert rows are rank-major, row ``g * E + e`` holding
    rank g's slice of expert e: ``comm.expert_rows``), the partial
    outputs are summed over the ranks (``psum``) and combined with the
    gates.  Dead tokens are routed too, as in JAX: nothing is dropped.
    ``kernels`` False runs ``grouped_ffn_ref`` in place of the kernel's
    entry."""
    moe = spec.moe
    E, k, bm = moe.num_experts, moe.num_experts_per_tok, spec.block_m
    B, S_len, d = x.shape
    dev = x.device
    flat = x.reshape(B * S_len, d)
    T = flat.shape[0]
    if skew_assign is not None:
        r = route_assigned(skew_assign[0], E)
    elif skew_key is not None and moe.router_skew > 0:
        r = route_skewed(skew_key.generator(dev), T, top_k=k, num_experts=E,
                         padded_experts=E, alpha=moe.router_skew,
                         n_hot=moe.router_skew_experts)
    else:
        r = route_topk(flat, params["router"], top_k=k, num_real_experts=E)
    U = r.assign.numel()
    sizes, padded, row, m_pad = tp_layout(r.assign, E, bm)
    x_units = torch.repeat_interleave(flat, k, dim=0)
    # every rank's d_ff slice reads all of x_buf: under DistComm its
    # gradient sums the ranks'
    x_buf = comm.enter(flat.new_zeros((m_pad, d)).index_copy_(0, row,
                                                               x_units))

    def body(me: int):
        w = {n: comm.expert_rows(params[n], me, E)
             for n in ("w_in", "w_out", "w_gate") if n in params}
        ffn = grouped_ffn if kernels else grouped_ffn_ref
        y_part = ffn(x_buf, w["w_in"], w["w_out"], padded,
                     w_gate=w.get("w_gate"), act=spec.act, block_m=bm)
        return (yield from D.psum(y_part))           # row-parallel
    y_buf = comm.run_ranks(body)[0]
    y_units = y_buf[row]
    y = (y_units.reshape(T, k, d)
         * r.gates.reshape(T, k, 1).to(y_units.dtype)).sum(dim=1)
    zero = torch.zeros((1,), dtype=torch.float32, device=dev)
    diag = {"aux_loss": r.aux_loss[None].float(), "send_drops": zero,
            "dest_drops": zero, "sched_iters": zero, "moved_units": zero,
            "max_load_before": zero, "max_load_after": zero,
            "mean_load": zero,
            # compute-balanced by construction: every rank holds a d_ff
            # slice of every unit's expert
            "rank_load": torch.full((1, spec.ep_degree), U / spec.ep_degree,
                                    dtype=torch.float32, device=dev),
            "expert_load": sizes.float()[None, :]}
    return y.reshape(B, S_len, d).to(x.dtype), diag


def moe_block(x: torch.Tensor, params: Dict[str, torch.Tensor], *,
              spec: MoEBlockSpec, comm=None,
              skew_key: Optional[SkewKey] = None,
              valid_mask: Optional[torch.Tensor] = None,
              skew_assign: Optional[torch.Tensor] = None,
              replica_ids: Optional[torch.Tensor] = None,
              residency_ids: Optional[torch.Tensor] = None,
              shared: Optional[Callable[[], torch.Tensor]] = None,
              kernels: bool = True
              ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """x: [B, S, d] -> [B, S, d], diagnostics, over the EP group of
    ``comm`` (default: one rank).  ``params``' expert rows are rank-major
    ``[G * epr, ...]`` for ``LocalComm`` / ``VirtualGroup`` and this rank's
    own ``[epr, ...]`` for ``DistComm``.  ``skew_key`` switches routing to
    the synthetic skew when ``spec.moe.router_skew > 0``; ``skew_assign``
    [n, t_slice, k] int32 routes on assignments drawn beforehand instead,
    one row for each rank this process runs (``comm.ranks_here``: all G,
    or under ``DistComm`` this rank's own).  ``shared`` computes the
    shared experts' output [B, S, d] on the same input; it runs while the
    foreign fetch is in flight (after the block when autograd records)
    and is added last, ``y = moe_y + shared``.  ``valid_mask``
    [B, S] bool keeps dead tokens (inactive slots, chunk padding) out of
    routing and capacity; their outputs are garbage the caller discards.
    With ``spec.moe.num_replica_slots`` R > 0, ``params`` carry the
    ``w_rep_*`` leaves (``G * R`` rows rank-major, or this rank's R under
    ``DistComm``) and ``replica_ids`` [G, R] int32 (-1 = empty; default
    all empty) names their experts; ``residency_ids`` [G, W] int32 (-1
    pads) is the tiered-residency working set (None: everything
    resident).  y is replicated; the diagnostics are those of the first
    rank that this process runs (rank 0 unless ``DistComm``), as the JAX
    block reports rank 0's.  ``kernels`` False runs the grouped FFN's
    reference (``grouped_ffn_ref``) on any device, as JAX's block without
    ``use_pallas``: training's path, which autograd differentiates (the
    kernel has no backward and raises on an input that requires grad)."""
    comm = comm if comm is not None else D.LocalComm()
    if comm.size != spec.ep_degree:
        raise ValueError(f"communicator of {comm.size} ranks for a spec of "
                         f"EP degree {spec.ep_degree}")
    if spec.tp_mode:
        # capacity-free and compute-balanced: dead tokens cannot drop real
        # ones, so the mask (and the placement tables) are not needed
        y, diag = tp_moe_block(x, params, spec=spec, comm=comm,
                               skew_key=skew_key, skew_assign=skew_assign,
                               kernels=kernels)
        return (y if shared is None else y + shared()), diag
    B, S_len, d = x.shape
    G = spec.ep_degree
    if spec.seq_sharded and S_len % G:
        raise ValueError(f"a sequence-sharded MoE block needs the length "
                         f"{S_len} to divide over {G} ranks")
    # sequence-sharded: each rank's positions of every row back to back,
    # rank-major, so that rank g's slice of the flat tokens is its shard
    # (with one row the two orders are the same)
    seq = spec.seq_sharded and G > 1 and B > 1

    def to_slices(t):
        if not seq:
            return t.reshape((B * S_len,) + t.shape[2:])
        t = t.reshape((B, G, S_len // G) + t.shape[2:]).transpose(0, 1)
        return t.reshape((B * S_len,) + t.shape[3:])
    flat = to_slices(x)
    n_valid = flat.shape[0]
    t_pad = round_up(max(n_valid, G), G)
    x_rep = F.pad(flat, (0, 0, 0, t_pad - n_valid))
    v_rep = None
    if valid_mask is not None:          # pads are invalid
        v = to_slices(valid_mask.to(torch.bool))
        v_rep = torch.cat([v, v.new_zeros(t_pad - n_valid)])
    epr = spec.topo.experts_per_rank
    R = spec.moe.num_replica_slots
    if R:
        if "w_rep_in" not in params:
            raise ValueError("num_replica_slots > 0 needs the w_rep_* "
                             "parameter leaves (Model.init)")
        if replica_ids is None:
            replica_ids = torch.full((spec.ep_degree, R), -1,
                                     dtype=torch.int32, device=x.device)
    else:
        replica_ids = None

    def rows_of(name: str) -> int:
        return R if name.startswith("w_rep_") else epr

    here = comm.ranks_here
    # when autograd records, the shared experts run after the block: a
    # checkpointed layer's recompute then stops before their last product,
    # whose result backward does not read (XLA's remat drops it too)
    late = shared is not None and torch.is_grad_enabled() and x.requires_grad

    # under DistComm a replicated input's gradient sums every rank's
    x_rep = comm.enter(x_rep)
    router = comm.enter(params["router"])

    def body(me: int):
        prm = {n: (router if n == "router" else comm.expert_rows(
                   w, me, rows_of(n)))
               for n, w in params.items()
               if R or not n.startswith("w_rep_")}
        return _moe_forward_local(
            x_rep, prm, spec, n_valid, me, skew_key=skew_key,
            valid_rep=v_rep,
            skew_assign=(None if skew_assign is None
                         else skew_assign[here.index(me)]),
            replica_ids=replica_ids, residency_ids=residency_ids,
            overlap=shared if me == here[0] and not late else None,
            kernels=kernels)
    outs = comm.run_ranks(body)
    y, diag, side = outs[0]
    if D._records(diag["aux_loss"]):
        # JAX's block reports rank 0's aux loss, and its transpose gives
        # each rank's the cotangent over G: the ranks' mean gradient
        diag = dict(diag, aux_loss=comm.rank0_mean_grad(
            [o[1]["aux_loss"] for o in outs]))
    if late:
        side = shared()
    y = y[:n_valid]
    y = (y.reshape(G, B, S_len // G, d).transpose(0, 1) if seq
         else y).reshape(B, S_len, d)
    return (y if side is None else y + side), diag
