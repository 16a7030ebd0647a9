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
x comes replicated over the EP group and each rank routes its contiguous
token slice.  With a ``SkewKey`` the router is the paper's synthetic skew
(``route_skewed``), each rank drawing on the key folded with its rank, as
the JAX block folds its key; a captured decode step cannot draw, so it
takes the same draws made before the step (``skew_assign``, one
``[t_slice, k]`` slice a rank: ``serve/stepcore.py``).  Nothing here reads
a device value on the host.

Serving-time expert placement (paper §4.2-4.3): with
``num_replica_slots`` R > 0 the block carries ``w_rep_*`` leaves of
``G * R`` rows (zeros at init; ``serve/rebalance.py`` copies hot experts'
rows into them in place), and ``replica_ids`` [G, R] (-1 = empty) names
their experts: replica holders count as local destinations in the
schedule, take their groups between the local and foreign ones, and fetch
nothing for them.  ``residency_ids`` [G, W] (``serve/residency.py``)
demotes statically placed experts outside a rank's working set to
foreign destinations in the harmoeny schedule.  Both tables are device
tensors, so changing them changes values only.  Tensor-parallel MoE
(E < G) is not ported yet and is rejected.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Callable, Dict, Optional, Tuple

import torch
import torch.nn.functional as F

from repro_torch.configs.base import MoEConfig, round_up
from repro_torch.core import dispatch as D
from repro_torch.core import prefetch
from repro_torch.core.grouped_ffn import grouped_ffn
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

    def __post_init__(self):
        if self.moe.num_experts < self.ep_degree:
            raise NotImplementedError("tensor-parallel MoE (E < EP degree) "
                                      "is not ported yet")

    @property
    def topo(self) -> EPTopology:
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
                       overlap: Optional[Callable[[], object]] = None):
    """Per-rank body of rank ``me``, a generator that yields its
    collectives (dispatch.py) and returns (y_rep, diagnostics, the
    result of ``overlap``).  x_rep: [t_pad, d] replicated over the EP
    group; ``params`` hold this rank's expert rows [epr, ...] (and replica
    rows [R, ...]) and the replicated router; ``skew_assign`` [t_slice, k]
    this rank's drawn skewed assignment; ``replica_ids`` [G, R] and
    ``residency_ids`` [G, W] the replicated placement tables (module
    docstring); ``overlap`` work independent of the block (the shared
    experts), run on the current stream while the fetch is in flight."""
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
    out_grouped = grouped_ffn(grouped, w_in, w_out, sizes_padded,
                              w_gate=w_gate, act=spec.act,
                              block_m=spec.block_m, replica=replica,
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


def moe_block(x: torch.Tensor, params: Dict[str, torch.Tensor], *,
              spec: MoEBlockSpec, comm=None,
              skew_key: Optional[SkewKey] = None,
              valid_mask: Optional[torch.Tensor] = None,
              skew_assign: Optional[torch.Tensor] = None,
              replica_ids: Optional[torch.Tensor] = None,
              residency_ids: Optional[torch.Tensor] = None,
              shared: Optional[Callable[[], torch.Tensor]] = None
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
    foreign fetch is in flight and is added last, ``y = moe_y +
    shared``.  ``valid_mask``
    [B, S] bool keeps dead tokens (inactive slots, chunk padding) out of
    routing and capacity; their outputs are garbage the caller discards.
    With ``spec.moe.num_replica_slots`` R > 0, ``params`` carry the
    ``w_rep_*`` leaves (``G * R`` rows rank-major, or this rank's R under
    ``DistComm``) and ``replica_ids`` [G, R] int32 (-1 = empty; default
    all empty) names their experts; ``residency_ids`` [G, W] int32 (-1
    pads) is the tiered-residency working set (None: everything
    resident).  y is replicated; the diagnostics are those of the first
    rank that this process runs (rank 0 unless ``DistComm``), as the JAX
    block reports rank 0's."""
    comm = comm if comm is not None else D.LocalComm()
    if comm.size != spec.ep_degree:
        raise ValueError(f"communicator of {comm.size} ranks for a spec of "
                         f"EP degree {spec.ep_degree}")
    B, S_len, d = x.shape
    flat = x.reshape(B * S_len, d)
    n_valid = flat.shape[0]
    t_pad = round_up(max(n_valid, spec.ep_degree), spec.ep_degree)
    x_rep = F.pad(flat, (0, 0, 0, t_pad - n_valid))
    v_rep = None
    if valid_mask is not None:          # pads are invalid
        v = valid_mask.reshape(-1).to(torch.bool)
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

    def body(me: int):
        prm = {n: (w if n == "router" else comm.expert_rows(w, me,
                                                            rows_of(n)))
               for n, w in params.items()
               if R or not n.startswith("w_rep_")}
        return _moe_forward_local(
            x_rep, prm, spec, n_valid, me, skew_key=skew_key,
            valid_rep=v_rep,
            skew_assign=(None if skew_assign is None
                         else skew_assign[here.index(me)]),
            replica_ids=replica_ids, residency_ids=residency_ids,
            overlap=shared if me == here[0] else None)
    y, diag, side = comm.run_ranks(body)[0]
    y = y[:n_valid].reshape(B, S_len, d)
    return (y if side is None else y + side), diag
