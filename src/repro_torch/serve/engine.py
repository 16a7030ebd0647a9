"""Continuous-batching serving engine (port of ``repro/serve/engine.py``:
the unified, prefill and decode roles, slab or paged KV pool).

``ServeEngine`` composes three parts, as in the JAX package:
``AdmissionFront`` (arrival queue, free slots, prefill pipeline, preempted
recompute queue), ``StepCore`` (the prefill-chunk and decode steps) and
the sequence-state store (``statestore.make_state_store``: ``KVOwner``,
which owns the pool, the prefill scratch and, paged, the block allocator
and table).  Newcomers' prompts are consumed chunk by chunk through
``model.prefill_chunk`` on a ``[1, prefill_chunk]`` scratch, interleaved
with decode steps of the whole slot batch through ``model.decode_step``.

* **slab** (``EngineConfig.paged=False``, the default, as in JAX): the
  pool is one cache row per slot; a finished prefill is copied from the
  scratch into its slot's row, and a free slot is the only admission
  gate.  Decode attends each row's slab at
  its own position (plain ``decode_attention``, as the reference has no
  kernel there).
* **paged**: admission is gated on free blocks, each finished chunk is
  scattered into the request's blocks, chains grow as decode advances,
  blocks return the moment a request finishes, and when the allocator
  runs dry the youngest block holder is preempted and later recomputed
  (prompt plus committed tokens re-prefilled).  With ``prefix_sharing``
  the pool is a prefix cache, as in JAX: admission maps each request's
  longest radix-indexed token prefix into its chain with refcount bumps
  and prefills only the uncached tail (the cached prefix is gathered into
  the scratch first: the ``prefix_tail`` phase), shared blocks are
  copy-on-write (a full-prompt hit, and any decode write into a shared
  block, copies it first), and dead indexed blocks stay on an LRU list
  until allocation pressure evicts them.  With ``speculative_k = k > 0``
  every decode step is the ``[B, k + 1]`` verify step: up to k tokens a
  slot drafted on the host (``serve/speculative.py``) are scored in one
  forward, and the accepted prefix plus one token from the verify logits
  is committed (1 to k + 1 tokens a step; greedy streams equal plain
  decoding's, sampled ones draw on the JAX engine's host generator in
  its order).

The engine keeps the scheduling state and leaves every pool-specific
write to the store, so neither mode forks the step loop.  Decoding is
greedy, or with ``temperature > 0`` truncated sampling (``top_k``,
``top_p``): the decode step samples inside its captured graph, and a
prompt's first token is the host twin's draw over its last logits row
(``serve/sampling.py``), on the JAX engine's generator seed.  On the card
every prefill chunk runs the paged attention kernel over the slab
scratch, every paged decode step the same kernel through the block
table, and every MoE layer the grouped expert FFN, whatever
``fused_paged_attention`` and ``fused_moe_gmm`` say: those two fields
are accepted for the JAX engine's sake, and ``report()`` gives what ran
(True on the card, False on the CPU, where the plain versions run).

A sliding-window model (mixtral-8x7b) is served as JAX serves it: on the
slab every layer's cache is clamped to the window and decode wraps it; on
the paged pool, where the window binds over a slot's chain, each chain is
a fixed ring of round_up(window, kv_block_size) positions allocated whole
at admission (``kvstore``), and a chunk wider than the ring or the fused
paged kernel is refused with the JAX engine's messages
(``check_window_ring``).

Engine roles (``EngineConfig.role``; the split roles need the paged
pool), as in JAX:

* ``unified`` (the default): prefill and decode on one engine.
* ``prefill``: admission and chunked prefill only.  When a prefill
  finishes (its first token sampled) the request is exported as a
  ``kvstore.HandoffRecord`` (its K/V, committed tokens and timestamps),
  its blocks are released (indexed prefixes stay cached) and the record
  waits for ``pop_handoffs()``.
* ``decode``: takes work only through ``import_handoff(record)``, which
  scatters the record's K/V into its own pool (``KVOwner.import_kv``) and
  puts the request in the decode batch where the exporter left it; greedy
  streams equal a unified engine's.  A preempted request still recomputes
  here, through the engine's own prefill.

``serve/fleet.py`` drives several engines off one clock
(``step(now, wait_when_idle=False)``) and scores them by ``load_stats()``
and ``probe_prefix()``.

``report()`` has every section and key the JAX engine's has for the same
``EngineConfig``, plus ``engine.device``: for a dense decoder
(mistral-nemo-12b, phi4-mini-3.8b, stablelm-1.6b), which has neither
experts nor recurrent state, no MoE diagnostics, as in JAX.
A model built at expert-parallel degree G > 1 runs its MoE blocks over G
ranks (``VirtualGroup``); ``EngineConfig.moe_policy`` overrides the decode
steps' scheduling policy, and a model with synthetic router skew draws
its routing from the ``skew_seed`` key streams (``StepCore``).
``report()["load_balance"]`` holds the per-rank and per-expert loads.

Across processes (a model over ``dispatch.DistComm``, one EP rank a
process) every process runs the same engine on the same requests in
lockstep: the collectives inside the steps need every rank at the same
chunk and step.  Each process has its own clock, so at every engine step
rank 0's clock reading is broadcast and every rank admits on it; the
rest of the engine's decisions (chunks, preemption, EOS) follow from the
admissions and the replicated tokens.  The report is each process's;
rank 0's is the one to read, as the JAX block reports rank 0's
diagnostics, and ``report()["engine"]["comm"]`` names the communicator,
its fetch form and whether the entries were captured.  Replica slots and
tiered residency run across processes too: the rebalancer and the
residency manager are host numpy fed from the all-gathered loads, so
every rank takes the same decisions at the same step; the replica swap
fetches each slot's row from the rank that hosts it and each rank's host
tier holds and stages only its own rows (``placement``).  Under gloo the
swap is eager, so ``jit_entries["replica_swap"]`` reads 0 there, as every
entry does.  A fleet of such engines (``FleetRouter``) raises: the JAX
package has no lockstep fleet.

On the card the prefill chunk, the decode (or verify) step and the
store's scratch-to-pool write (``write_blocks`` paged, ``write_slot`` on
the slab), and with prefix sharing the store's prefix gather and block
copy (``gather_prefix``, ``copy_block``), are each captured once as a
CUDA graph, at ``warmup()`` or at first use, and replayed at every call
after (``StepCore``, ``KVOwner``).
A chunk costs one copy to the host and one stream sync, which reads its
first token and diagnostics.  ``report()["jit_entries"]`` counts the
captured entries and, after ``warmup()``, ``recompiled_after_warmup``
says whether any was captured again (the JAX engine's names: one entry
each across chunk positions, admissions, slot recycling, block growth,
preemption, re-prefill and EOS).

Serving-time expert placement (paper §4.2-4.3, MoE models at G > 1):

* ``replica_slots`` / ``rebalance_interval``: every
  ``rebalance_interval`` steps the ``ExpertRebalancer`` proposes the
  EMA-hottest experts, and, when the proposal changed, their weight rows
  are gathered into the model's replica slots in place
  (``placement.ReplicaSwap``, captured once: ``jit_entries
  ["replica_swap"]``), while the ``[G, R]`` replica table rides into the
  next chunks and steps in their static buffers.
* ``resident_experts`` / ``prefetch_policy``: the
  ``ExpertResidencyManager`` keeps a ``[G, W]`` working set of each
  rank's experts (``W = resident_experts / G``) from each decode step's
  per-layer loads; its decision is applied at the start of the next
  decode step, as in the JAX engine: the decision's rows are copied from
  the pinned host tier (``placement.HostTier``) to the card on a side
  stream, that step's decode waits on the copy's event, and the new table
  demotes the experts outside the working set in the harmoeny schedule.
  The stage copies a different number of rows each time, so it is never
  captured: ``jit_entries["residency_stage"]`` reads 0 (the key set stays
  the JAX engine's).  The device weights stay authoritative (a staged row
  is a bit-identical copy), so greedy streams are the same at every
  budget and policy.
"""
from __future__ import annotations

import time
from collections import Counter, deque
from dataclasses import dataclass
from typing import Any, Dict, List, Optional, Sequence

import numpy as np
import torch

from repro_torch import resolve_device
from repro_torch.configs.base import round_up
from repro_torch.core.dispatch import DistComm
from repro_torch.kernels.paged_attention.ops import largest_block_divisor
from repro_torch.models import attention as attention_dispatch
from repro_torch.serve.arrivals import WallClock
from repro_torch.serve.frontend import AdmissionFront
from repro_torch.serve.kvstore import HandoffRecord
from repro_torch.serve.metrics import ServeMetrics
from repro_torch.serve.paging import blocks_for_tokens
from repro_torch.serve.placement import HostTier, ReplicaSwap, expert_leaves
from repro_torch.serve.rebalance import ExpertRebalancer
from repro_torch.serve.request import Request, RequestState, RequestStatus
from repro_torch.serve.residency import (PREFETCH_POLICIES,
                                         ExpertResidencyManager,
                                         TierCostModel)
from repro_torch.serve.sampling import sample_np
from repro_torch.serve.speculative import (greedy_verify, make_proposer,
                                           rejection_verify)
from repro_torch.serve.statestore import make_state_store
from repro_torch.serve.stepcore import StepCore

ENGINE_ROLES = ("unified", "prefill", "decode")


@dataclass(frozen=True)
class EngineConfig:
    """Static serving shapes: every field of the JAX engine's, with its
    defaults and its validation: the split roles, ``prefix_sharing`` and
    ``speculative_k > 0`` need the paged pool, as in JAX."""
    max_slots: int = 4          # decode batch width (concurrent requests)
    max_seq_len: int = 128      # logical KV length (prompt + generation)
    prefill_chunk: int = 32     # prompt tokens consumed per prefill call
    chunks_per_step: int = 1    # prefill chunks interleaved per engine step
    eos_id: Optional[int] = None
    skew_seed: int = 0          # synthetic router-skew + sampling key stream
    # "unified" serves prefill + decode; "prefill" exports finished
    # prefills as HandoffRecords; "decode" imports them (paged only)
    role: str = "unified"
    # --- KV pool: one slab row per slot, or paged blocks ---
    paged: bool = False
    kv_block_size: int = 16     # tokens per physical KV block
    num_kv_blocks: int = 0      # usable blocks (0 = worst case for every slot)
    # the JAX engine's kernel switches; on the card the hand-written
    # kernels run whatever they say (report() gives what ran)
    fused_paged_attention: bool = False
    fused_moe_gmm: bool = False
    # --- prefix sharing (paged only) ---
    prefix_sharing: bool = False
    # --- speculative decoding (paged only) ---
    # k > 0: each decode step verifies up to k self-drafted tokens in one
    # static-shape [B, k + 1] forward (serve/speculative.py)
    speculative_k: int = 0
    speculative_policy: str = "ngram"   # draft proposer (make_proposer)
    # --- sampling (0 temperature = greedy) ---
    temperature: float = 0.0
    top_k: int = 0              # 0 = full vocab when temperature > 0
    top_p: float = 1.0          # nucleus truncation (1.0 = disabled)
    # decode scheduling policy override (None = the model config's policy):
    # harmoeny / round_robin / even_split / static_opt (core/scheduler.py)
    moe_policy: Optional[str] = None
    # between-window hot-expert replication (serve/rebalance.py): every
    # `rebalance_interval` engine steps the EMA-hottest experts' weights
    # are copied into the model's replica slots; the model must be built
    # with MoEConfig.num_replica_slots == replica_slots
    rebalance_interval: int = 0
    replica_slots: int = 0
    # tiered expert residency (serve/residency.py): `resident_experts`
    # working-set rows (pod total, split evenly over the EP ranks) stay
    # resident, the rest are staged in from the pinned host tier per
    # `prefetch_policy` (predictive / on_demand / none); 0 = off
    resident_experts: int = 0
    prefetch_policy: str = "predictive"

    def __post_init__(self):
        self.validate()

    def validate(self) -> "EngineConfig":
        if self.max_slots < 1 or self.max_seq_len < 1:
            raise ValueError("max_slots and max_seq_len must be >= 1")
        if self.prefill_chunk < 1 or self.chunks_per_step < 1:
            raise ValueError("prefill_chunk and chunks_per_step must be >= 1")
        if self.role not in ENGINE_ROLES:
            raise ValueError(f"unknown engine role {self.role!r}; choose "
                             f"one of {ENGINE_ROLES}")
        if self.role != "unified" and not self.paged:
            raise ValueError(
                "prefill/decode engine roles hand KV off through the paged "
                "block machinery; they require EngineConfig.paged=True")
        if self.paged and self.kv_block_size < 1:
            raise ValueError("kv_block_size must be >= 1")
        if self.num_kv_blocks < 0:
            raise ValueError("num_kv_blocks must be >= 0 (0 = slab-parity "
                             "worst case)")
        if self.prefix_sharing and not self.paged:
            raise ValueError("prefix_sharing requires the paged KV pool "
                             "(EngineConfig.paged=True)")
        if self.fused_paged_attention and not self.paged:
            raise ValueError("fused_paged_attention is the paged decode "
                             "kernel; it requires EngineConfig.paged=True")
        if self.speculative_k < 0:
            raise ValueError("speculative_k must be >= 0")
        if self.speculative_k > 0 and not self.paged:
            raise ValueError("speculative decoding verifies through the "
                             "paged KV pool (rollback rides the block "
                             "machinery); it requires EngineConfig."
                             "paged=True")
        if self.temperature < 0 or self.top_k < 0:
            raise ValueError("temperature and top_k must be >= 0")
        if not 0.0 < self.top_p <= 1.0:
            raise ValueError("top_p must be in (0, 1]")
        known = ("harmoeny", "round_robin", "even_split", "static_opt")
        if self.moe_policy is not None and self.moe_policy not in known:
            raise ValueError(f"unknown moe_policy {self.moe_policy!r}; "
                             f"choose one of {known}")
        if self.replica_slots < 0 or self.rebalance_interval < 0:
            raise ValueError("replica_slots and rebalance_interval must "
                             "be >= 0")
        if self.rebalance_interval > 0 and self.replica_slots == 0:
            raise ValueError("rebalance_interval > 0 needs replica_slots "
                             "> 0 (there is nowhere to place hot experts)")
        if self.resident_experts < 0:
            raise ValueError("resident_experts must be >= 0")
        if self.prefetch_policy not in PREFETCH_POLICIES:
            raise ValueError(
                f"unknown prefetch_policy {self.prefetch_policy!r}; choose "
                f"one of {PREFETCH_POLICIES}")
        return self


def paged_pool_len(max_seq_len: int, prefill_chunk: int,
                   prefix_sharing: bool, speculative_k: int = 0) -> int:
    """Chunk-padded logical pool length of the paged engine (the JAX
    function).  Prefix sharing pads one extra chunk: its prefill restarts
    (a block boundary, or ``prompt_len - 1`` on a full hit) are not
    chunk-aligned, so the final padded chunk can spill one chunk past the
    plain bound.  Speculative decoding pads ``speculative_k`` tokens: a
    verify step writes all k + 1 window positions, so a slot one token
    short of ``max_seq_len`` still writes k positions past it, which must
    land inside its own chain."""
    return round_up(max_seq_len, prefill_chunk) \
        + (prefill_chunk if prefix_sharing else 0) + speculative_k


def check_servable(cfg) -> None:
    """The JAX engine's refusal of the encoder-decoder and prefix-embedding
    models (whisper-large-v3, pixtral-12b), in its words: they run
    through ``model.prefill`` and ``decode_step`` only."""
    if cfg.is_encoder_decoder or cfg.num_prefix_embeddings:
        raise NotImplementedError(
            f"serve engine supports decoder-only transformer, SSM, "
            f"and hybrid families; got {cfg.name} ({cfg.family})")


def check_window_ring(cfg, ecfg) -> None:
    """A paged pool serves a window that binds over a slot's chain as a
    ring buffer: refuse a chunk wider than the ring, speculative verify,
    prefix sharing, the fused paged kernel and the split roles, with the
    JAX engine's messages."""
    w = cfg.sliding_window or 0
    bs, C = ecfg.kv_block_size, ecfg.prefill_chunk
    s_pad = paged_pool_len(ecfg.max_seq_len, C, ecfg.prefix_sharing,
                           ecfg.speculative_k)
    if not (ecfg.paged and 0 < w <= -(-s_pad // bs) * bs):
        return
    M = round_up(w, bs)
    blockers = []
    if C > M:
        blockers.append(f"prefill_chunk {C} > ring {M} tokens (a chunk "
                        f"must never self-overlap a ring slot; shrink "
                        f"prefill_chunk)")
    if ecfg.speculative_k > 0:
        blockers.append("speculative verify is multi-query; the ring "
                        "gather is single-query")
    if ecfg.prefix_sharing:
        blockers.append("prefix sharing keys blocks by content, but a ring "
                        "slot's content depends on absolute sequence length")
    if ecfg.fused_paged_attention:
        blockers.append("the fused paged kernel has no ring arithmetic")
    if ecfg.role != "unified":
        blockers.append("KV handoff replays absolute-position scatters, "
                        "not ring writes")
    if blockers:
        raise ValueError(f"{cfg.name} (sliding_window={w}) serves paged "
                         f"through the window ring buffer, which rejects: "
                         + "; ".join(blockers))


def engine_config_for(cfg, *, max_slots: int, prompt_len: int,
                      max_new_tokens: int, prefill_chunk: int = 0,
                      eos_id: Optional[int] = None, skew_seed: int = 0,
                      role: str = "unified", paged: bool = False,
                      kv_block_size: int = 16, num_kv_blocks: int = 0,
                      prefix_sharing: bool = False,
                      fused_paged_attention: bool = False,
                      fused_moe_gmm: bool = False, speculative_k: int = 0,
                      speculative_policy: str = "ngram",
                      temperature: float = 0.0, top_k: int = 0,
                      top_p: float = 1.0, moe_policy: Optional[str] = None,
                      rebalance_interval: int = 0, replica_slots: int = 0,
                      resident_experts: int = 0,
                      prefetch_policy: str = "predictive") -> EngineConfig:
    """Serving shapes from a workload (the JAX function's keywords and
    checks): the pool covers prompt + generation, the prefill chunk
    divides the padded prompt, and a sliding window bounds the padded
    prompt on the slab (its cache is clamped to the window) or the chunk
    on the paged pool (one chunk must fit the ring)."""
    chunk = prefill_chunk or min(max(prompt_len, 1), 32)
    window = cfg.sliding_window or 0
    pad = round_up(prompt_len, chunk)
    if window and not paged and pad > window:
        raise ValueError(
            f"padded prompt {pad} exceeds the sliding window {window}; "
            f"slab chunked prefill must fit the window-clamped KV cache "
            f"(the paged ring buffer lifts this — pass paged=True)")
    if window and paged and chunk > round_up(window, kv_block_size):
        raise ValueError(
            f"prefill_chunk {chunk} exceeds the sliding-window ring of "
            f"{round_up(window, kv_block_size)} tokens; one chunk must "
            f"never self-overlap a ring slot — shrink prefill_chunk")
    return EngineConfig(
        max_slots=max_slots, max_seq_len=max(prompt_len + max_new_tokens, pad),
        prefill_chunk=chunk, eos_id=eos_id, skew_seed=skew_seed, role=role,
        paged=paged, kv_block_size=kv_block_size,
        num_kv_blocks=num_kv_blocks, prefix_sharing=prefix_sharing,
        fused_paged_attention=fused_paged_attention,
        fused_moe_gmm=fused_moe_gmm, speculative_k=speculative_k,
        speculative_policy=speculative_policy, temperature=temperature,
        top_k=top_k, top_p=top_p, moe_policy=moe_policy,
        rebalance_interval=rebalance_interval, replica_slots=replica_slots,
        resident_experts=resident_experts, prefetch_policy=prefetch_policy)


class ServeEngine:
    def __init__(self, model, params, ecfg: EngineConfig, *, clock=None,
                 device=None):
        check_servable(model.cfg)
        dev = resolve_device(device)
        if model.device != dev:
            raise ValueError(f"model lives on {model.device}, engine asked "
                             f"to run on {dev}")
        ecfg.validate()
        cfg = model.cfg
        if (ecfg.moe_policy is not None or ecfg.replica_slots > 0) \
                and not cfg.is_moe:
            raise ValueError("moe_policy / replica_slots need an MoE model")
        if ecfg.fused_moe_gmm and not cfg.is_moe:
            raise ValueError("fused_moe_gmm is the grouped-GEMM expert "
                             "FFN kernel; it needs an MoE model")
        check_window_ring(cfg, ecfg)
        tp = cfg.is_moe and model.moe_spec.tp_mode
        if ecfg.replica_slots > 0 and tp:
            raise ValueError(
                "hot-expert replication needs expert-parallel MoE "
                "(num_experts >= the mesh model degree)")
        if ecfg.resident_experts > 0 and (not cfg.is_moe or tp):
            raise ValueError(
                "tiered expert residency needs expert-parallel MoE "
                "(num_experts >= the mesh model degree)")
        self.dist = model.comm if isinstance(model.comm, DistComm) else None
        self.model = model
        self.params = params
        self.ecfg = ecfg
        self.cfg = cfg
        self.device = dev
        self.clock = clock or WallClock()
        self.metrics = ServeMetrics()
        self.role = ecfg.role
        # the kernels run on the card whatever the fused_* fields say
        self._fused = dev.type == "cuda"
        B, C = ecfg.max_slots, ecfg.prefill_chunk
        # paged: prefill writes whole padded chunks, so chains cover the
        # chunk-rounded logical length, one chunk more with prefix sharing
        # and k positions more with speculation (paged_pool_len; the slab
        # scratch is max_seq_len)
        self.kv = make_state_store(model, ecfg, s_pad=paged_pool_len(
            ecfg.max_seq_len, C, ecfg.prefix_sharing, ecfg.speculative_k))
        self._spec = ecfg.speculative_k > 0
        self._sharing = ecfg.prefix_sharing
        self._proposer = (make_proposer(ecfg.speculative_policy)
                          if self._spec else None)
        self.core = StepCore(model, ecfg,
                             blocks_per_slot=self.kv.blocks_per_slot)
        self.front = AdmissionFront(B)
        # the JAX report's per-phase attention byte model: bytes one KV
        # token costs across the stack (K + V, every layer)
        kvb = {"float32": 4, "bfloat16": 2}.get(cfg.dtype, 4)
        self._kv_token_bytes = (2 * cfg.num_layers
                                * (cfg.num_kv_heads or cfg.num_heads)
                                * cfg.resolved_head_dim * kvb)
        self._slab_bs = largest_block_divisor(self.kv.s_pad)
        self.pos = np.zeros((B,), np.int32)      # per-slot sequence length
        self.tok = np.zeros((B,), np.int32)      # per-slot last token
        self.active = np.zeros((B,), bool)       # slot in the decode batch
        self._step_idx = 0
        self._chunk_idx = 0
        # allocator lifetime counters at window start (report() deltas)
        self._evict0 = 0
        self._cow0 = 0
        self._attn_dispatch: Optional[List[Dict[str, Any]]] = None
        self._warm_counts: Optional[Dict[str, int]] = None
        # the prefill-to-decode handoff (split roles)
        self._handoffs_out: deque = deque()      # exported, awaiting pickup
        self.handoffs_exported = 0
        self.handoffs_imported = 0
        self.handoff_bytes_out = 0
        self.handoff_bytes_in = 0
        attention_dispatch.reset_dispatch_log()
        self._init_placement(params)

    def _init_placement(self, params) -> None:
        """The replica slots' rebalancer and swap, and the residency
        manager and host tier, with the JAX engine's refusals."""
        ecfg, cfg = self.ecfg, self.cfg
        self._rebalancer: Optional[ExpertRebalancer] = None
        self._replica_ids: Optional[np.ndarray] = None
        self._rebalances = 0
        self._replica_swaps = 0
        if ecfg.replica_slots > 0:
            if cfg.moe.num_replica_slots != ecfg.replica_slots:
                raise ValueError(
                    f"EngineConfig.replica_slots={ecfg.replica_slots} but "
                    f"the model was built with MoEConfig.num_replica_slots="
                    f"{cfg.moe.num_replica_slots}; the slots must exist "
                    f"from init so swaps never change parameter shapes")
            topo = self.model.moe_spec.topo
            self._rebalancer = ExpertRebalancer(topo, ecfg.replica_slots)
            self._replica_ids = np.full(
                (topo.num_ranks, ecfg.replica_slots), -1, np.int32)
            self._swap = ReplicaSwap(
                params, topo.num_ranks * ecfg.replica_slots, self.device,
                comm=self.model.comm, topo=topo)
        self._residency: Optional[ExpertResidencyManager] = None
        self._residency_ids: Optional[np.ndarray] = None
        self._pending_stage = None        # decision applied next step start
        self._residency_stages = 0        # stages dispatched
        self._res_base: Optional[Dict[str, float]] = None
        self._host_tier: Optional[HostTier] = None
        self.stage_log: List[Dict[str, Any]] = []
        if ecfg.resident_experts > 0:
            leaves = expert_leaves(params)
            if not leaves:
                raise ValueError("tiered expert residency found no expert "
                                 "weight leaves in the parameter tree")
            expert_bytes = float(sum(
                w.numel() * w.element_size() // w.shape[w.ndim - 3]
                for w in leaves))
            self._residency = ExpertResidencyManager(
                self.model.moe_spec.topo, ecfg.resident_experts,
                policy=ecfg.prefetch_policy,
                cost=TierCostModel(expert_bytes=expert_bytes))
            self._residency_ids = self._residency._last_ids.copy()
            # across processes a rank's tier holds its own rows only
            epr = self.model.moe_spec.topo.experts_per_rank
            self._host_tier = HostTier(
                leaves, row0=0 if self.dist is None else self.dist.rank * epr)
            if self.device.type == "cuda":
                self._stage_stream = torch.cuda.Stream(self.device)

    # ------------------------------------------------------------------
    @property
    def _alloc(self):
        return self.kv.alloc

    def _sync(self) -> None:
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def _eos_id(self, req: Request) -> Optional[int]:
        return req.eos_id if req.eos_id is not None else self.ecfg.eos_id

    @property
    def queue(self):
        """The arrival queue (the fleet router reads its next arrival)."""
        return self.front.queue

    # ------------------------------------------------------------------
    def submit(self, req: Request) -> None:
        if self.role == "decode":
            raise ValueError(
                "decode-role engine takes work via import_handoff(), not "
                "submit(); route arrivals to a prefill or unified engine")
        L, C = req.prompt_len, self.ecfg.prefill_chunk
        if round_up(L, C) > self.kv.kv_capacity:
            raise ValueError(
                f"request {req.rid}: prompt of {L} (padded to "
                f"{round_up(L, C)}) exceeds the per-layer KV capacity "
                f"{self.kv.kv_capacity}")
        if L + req.max_new_tokens > self.ecfg.max_seq_len:
            raise ValueError(
                f"request {req.rid}: prompt {L} + max_new "
                f"{req.max_new_tokens} exceeds max_seq_len "
                f"{self.ecfg.max_seq_len}")
        self.front.queue.push(req)

    def has_work(self) -> bool:
        return bool(len(self.front.queue) or self._in_flight())

    def _in_flight(self) -> bool:
        """Admitted work whose timestamps live on the current clock:
        prefills, decodes, preempted requests and exported but unclaimed
        handoffs."""
        return self.front.in_flight(bool(self.active.any())) \
            or bool(self._handoffs_out)

    # ------------------------------------------------------------------
    # admission (block-aware in paged mode; preempted requests first)
    # ------------------------------------------------------------------
    def _place(self, st: RequestState, plan) -> None:
        front = self.front
        slot = front.free_slots.popleft()
        st.slot = slot
        st.status = RequestStatus.PREFILL
        st.admit_seq = front.admit_seq
        front.admit_seq += 1
        front.state_by_slot[slot] = st
        front.slot_history.append((st.req.rid, slot))
        self.kv.place(st.req.rid, plan)
        if self.ecfg.paged:
            start, shared, _, cow_last = plan
            if cow_last:
                # full-prompt hit: the last position's recompute writes into
                # the final shared block, so this chain gets a private copy
                ok = self._cow_block(st, len(shared) - 1)
                assert ok                 # the copy was gated too
            st.prefill_pos = start
            # nothing to gather when no cached prefix was mapped
            st.prefix_loaded = start == 0
            if st.n_preempted == 0:
                st.cached_prefix_tokens = start
            elif self._sharing:
                self.metrics.resume_cached_tokens += start
            if st.resumed and start >= st.prefill_len:
                # full-sequence hit on recompute: every committed position
                # is cached, and the pending last token decodes next step
                self._activate(st, st.prefill_len, st.output[-1])
                return
        front.pf_queue.append(st)

    def _activate(self, st: RequestState, pos: int, tok: int) -> None:
        """Move a finished prefill into the decode batch."""
        s = st.slot
        st.status = RequestStatus.DECODE
        self.pos[s] = pos
        self.tok[s] = tok
        self.active[s] = True
        self.kv.activate(st.req.rid, s)

    def _admit(self, now: float) -> None:
        self.front.admit(now, plan_fn=self.kv.plan,
                         can_admit_fn=self.kv.can_admit,
                         place_fn=self._place)

    # ------------------------------------------------------------------
    # preemption by recompute under allocator pressure (paged only)
    # ------------------------------------------------------------------
    def _youngest_holder(self) -> Optional[RequestState]:
        cands = [st for st in self.front.state_by_slot if st is not None]
        return max(cands, key=lambda st: st.admit_seq) if cands else None

    def _preempt(self, st: RequestState) -> None:
        front = self.front
        s = st.slot
        self.kv.release(st.req.rid, s)
        self.active[s] = False
        self.pos[s] = 0
        self.tok[s] = 0
        front.state_by_slot[s] = None
        front.free_slots.append(s)
        if front.pf is st:
            front.pf = None
        elif st in front.pf_queue:
            front.pf_queue.remove(st)
        st.slot = -1
        st.status = RequestStatus.QUEUED
        st.prefill_pos = 0
        st.prefix_loaded = False
        st.n_preempted += 1
        front.resume.append(st)
        self.metrics.preemptions += 1

    def _reclaim_until(self, st: RequestState, op):
        """Run allocator ``op`` (None while the pool is dry), preempting
        the youngest block holder between attempts.  The op's result, or
        None if ``st`` itself was preempted to make room."""
        while True:
            res = op()
            if res is not None:
                return res
            victim = self._youngest_holder()
            if victim is None:
                raise RuntimeError("KV allocator dry with no block holders")
            self._preempt(victim)
            if victim is st:
                return None

    def _cow_block(self, st: RequestState, j: int) -> bool:
        """Give ``st`` a private copy of logical block ``j`` before a write
        would change it (the allocator's ``cow``, then the captured block
        copy), preempting younger holders while the pool is dry.  False
        if ``st`` itself was preempted to make room."""
        res = self._reclaim_until(st, lambda: self._alloc.cow(st.req.rid, j))
        if res is None:
            return False
        old, new = res
        self.kv.copy(old, new)
        if st.slot >= 0 and self.active[st.slot]:
            self.kv.block_table[st.slot, j] = new
        return True

    def _grow_chain(self, st: RequestState) -> bool:
        """Extend ``st``'s chain by one block, preempting the youngest
        holder while the allocator is dry.  False if ``st`` itself was the
        youngest and got preempted."""
        return self._reclaim_until(
            st, lambda: self.kv.extend(st.req.rid, st.slot) or None) \
            is not None

    def _ensure_decode_blocks(self) -> None:
        """Before a decode step every active slot's chain must cover its
        write range ``[pos, pos + speculative_k]`` (a verify step writes
        all k + 1 window positions; plain decode is k = 0), and with
        prefix sharing every block in that range must be private to the
        chain (copy-on-write: a shared block is immutable, and a rejected
        draft's garbage must never land in another chain's prefix).  Grow
        oldest requests first."""
        if self.kv.ring_full_chain:
            # every KV leaf wraps the fixed ring: chains were allocated
            # whole at admission and never grow
            return
        bs = self.ecfg.kv_block_size
        span = self.ecfg.speculative_k
        order = sorted(np.nonzero(self.active)[0],
                       key=lambda s: self.front.state_by_slot[s].admit_seq)
        for s in order:
            if not self.active[s]:        # preempted earlier in this pass
                continue
            st = self.front.state_by_slot[s]
            last = int(self.pos[s]) + span    # deepest position written
            if self._sharing:
                preempted = False
                for j in range(int(self.pos[s]) // bs, last // bs + 1):
                    chain = self._alloc.chain(st.req.rid)
                    if j < len(chain) \
                            and self._alloc.refcount(chain[j]) > 1:
                        if not self._cow_block(st, j):
                            preempted = True  # st itself evicted for room
                            break
                if preempted:
                    continue
            while not self.kv.covers(st.req.rid, last):
                if not self._grow_chain(st):
                    break

    # ------------------------------------------------------------------
    def _prefill_work(self, now: float) -> bool:
        front = self.front
        did = False
        C = self.ecfg.prefill_chunk
        for _ in range(self.ecfg.chunks_per_step):
            if front.pf is None:
                if not front.pf_queue:
                    break
                front.pf = front.pf_queue.popleft()
                # a recurrent store resets its scratch here: chunked
                # prefill carries state across a request's chunks, which
                # a new request must not inherit
                self.kv.begin_prefill()
            st = front.pf
            seq = st.prefill_tokens
            start, L = st.prefill_pos, st.prefill_len
            n = min(C, L - start)
            chunk = np.zeros((1, C), np.int32)
            chunk[0, :n] = seq[start:start + n]
            t0 = time.perf_counter()
            if self._sharing and start > 0 and not st.prefix_loaded:
                # mid-prompt restart off a cached prefix: the uncached
                # tail's attention reads the prefix K/V from the scratch,
                # so gather it out of the shared blocks first
                self.kv.gather(st.req.rid, start)
                st.prefix_loaded = True
            self.core.prefill(self.params, chunk, self.kv.scratch, start,
                              n - 1, self._chunk_idx, self._replica_ids)
            self._chunk_idx += 1
            self.kv.after_chunk(st.req.rid, start, start + n)
            st.prefill_pos += n
            if st.prefill_done:
                self.kv.on_prefill_done(st.slot)
            # one copy and one sync: the chunk's writes are done too
            first, packed = self.core.prefill_result()
            if self._sharing:
                # every block fully covered by committed K/V joins the
                # prefix index (keyed on its token-id chain)
                self._alloc.commit_prefix(st.req.rid, seq[:st.prefill_pos])
            self.metrics.record_step(
                self.core.unpack(packed, "prefill_chunk"), 0,
                phase="prefill")
            # prefix_tail: the request restarted mid-sequence off a cache
            # hit, so its chunks attend a deeper window than a plain
            # prefill of the same tail
            self.metrics.record_phase(
                ("prefix_tail" if self._sharing
                 and (st.cached_prefix_tokens or 0) > 0 else "prefill"),
                n, time.perf_counter() - t0, self._prefill_kv_bytes(start + n))
            did = True
            if st.prefill_done:
                if st.resumed:
                    # recompute finished (paged only: the slab never
                    # preempts): the pending last token decodes next
                    self._activate(st, L, st.output[-1])
                    front.pf = None
                    continue
                if self.core.sample:
                    # the host twin draws the first token, as in JAX
                    first = sample_np(
                        self.core.prefill_logits(), self.core.samp_rng,
                        temperature=self.ecfg.temperature,
                        top_k=self.ecfg.top_k, top_p=self.ecfg.top_p)
                # stamp after the device sync: TTFT includes the prefill
                now = self.clock.now()
                st.first_token_time = now
                st.output.append(first)
                eos = self._eos_id(st.req)
                if (eos is not None and first == eos) \
                        or st.n_generated >= st.req.max_new_tokens:
                    self._finish(st, now)
                elif self.role == "prefill":
                    # the request leaves this engine here: the scratch
                    # still holds its whole committed K/V, so export it
                    # before the next chunk overwrites it
                    self._export_handoff(st)
                else:
                    self._activate(st, L, first)
                front.pf = None
        return did

    def _decode_work(self, now: float) -> bool:
        if self._spec:
            return self._speculative_decode_work(now)
        self._ensure_decode_blocks()
        if not self.active.any():
            return False
        self._apply_pending_stage()
        t0 = time.perf_counter()
        nxt, packed = self.core.decode(
            self.params, self.tok, self.kv.pool, self.pos,
            self.kv.decode_table(), self.active, self._step_idx,
            self._replica_ids, self._residency_ids)
        dt = time.perf_counter() - t0
        now = self.clock.now()       # post-sync: token times include compute
        n_active = int(self.active.sum())
        self._record_decode(packed, n_active)
        self.metrics.record_phase("decode", n_active, dt,
                                  self._attn_kv_bytes(1))
        for s in np.nonzero(self.active)[0]:
            st = self.front.state_by_slot[s]
            self.pos[s] += 1
            t = int(nxt[s])
            st.output.append(t)
            if self._sharing and self.pos[s] % self.ecfg.kv_block_size == 0:
                # this step's write just filled a block: index it so later
                # prompts extending this sequence can hit
                self._commit_output(st, int(self.pos[s]))
            eos = self._eos_id(st.req)
            if (eos is not None and t == eos) \
                    or st.n_generated >= st.req.max_new_tokens:
                self._finish(st, now)
            else:
                self.tok[s] = t
        return True

    def _record_decode(self, packed: np.ndarray, n_active: int) -> None:
        """A decode or verify step's diagnostics, expert loads and block
        occupancy into the metrics and the placement managers."""
        diags = self.core.unpack(packed, "decode")
        layer_loads = diags.pop("expert_load_layers", None)
        self.metrics.record_step(diags, n_active, phase="decode")
        self._observe_load(diags)
        self._observe_residency(layer_loads)
        occ = self.kv.occupancy()
        if occ is not None:
            self.metrics.record_kv(*occ)

    def _commit_output(self, st: RequestState, upto: int) -> None:
        """Index the full blocks of ``st``'s prompt and committed output up
        to position ``upto`` in the prefix cache."""
        full = np.concatenate([st.req.tokens, np.asarray(st.output,
                                                         np.int32)])
        self._alloc.commit_prefix(st.req.rid, full[:upto])

    def _speculative_decode_work(self, now: float) -> bool:
        """One speculative decode step: draft up to k tokens a slot on the
        host, verify them all in one static ``[B, k + 1]`` forward
        against the paged pool, and commit the accepted prefix plus one
        token from the verify logits.  Rejected positions' K/V writes are
        rolled back by masking: they sit past the committed length, each
        is rewritten with real K/V before ``pos`` reaches it, and the CoW
        guard of ``_ensure_decode_blocks`` keeps them out of shared
        blocks."""
        self._ensure_decode_blocks()
        if not self.active.any():
            return False
        self._apply_pending_stage()
        B, k = self.ecfg.max_slots, self.ecfg.speculative_k
        bs = self.ecfg.kv_block_size
        toks = np.zeros((B, k + 1), np.int32)
        draft_len = np.zeros((B,), np.int32)
        for s in np.nonzero(self.active)[0]:
            st = self.front.state_by_slot[s]
            toks[s, 0] = self.tok[s]
            # never draft past the generation budget: the step commits up
            # to draft_len + 1 tokens
            cap = min(k, st.req.max_new_tokens - st.n_generated - 1)
            if cap > 0:
                ctx = np.concatenate([st.req.tokens,
                                      np.asarray(st.output, np.int32)])
                d = self._proposer.propose(ctx, cap)
                toks[s, 1:1 + len(d)] = d
                draft_len[s] = len(d)
        t0 = time.perf_counter()
        logits, packed = self.core.decode(
            self.params, toks, self.kv.pool, self.pos,
            self.kv.decode_table(), self.active, self._step_idx,
            self._replica_ids, self._residency_ids)
        dt = time.perf_counter() - t0
        now = self.clock.now()   # post-sync: token times include compute
        n_active = int(self.active.sum())
        self._record_decode(packed, n_active)
        # the verify window reads each active row's chain up to pos + k + 1
        verify_bytes = self._attn_kv_bytes(k + 1)
        self.metrics.spec_steps += 1
        self.metrics.spec_slot_steps += n_active
        total_commit = 0
        e = self.ecfg
        for s in np.nonzero(self.active)[0]:
            st = self.front.state_by_slot[s]
            drafts = toks[s, 1:1 + int(draft_len[s])].tolist()
            if self.core.sample:
                n_acc, nxt = rejection_verify(
                    logits[s], drafts, self.core.samp_rng,
                    temperature=e.temperature, top_k=e.top_k, top_p=e.top_p)
            else:
                n_acc, nxt = greedy_verify(logits[s], drafts)
            self.metrics.spec_drafted += len(drafts)
            self.metrics.spec_accepted += n_acc
            old_pos = int(self.pos[s])
            eos = self._eos_id(st.req)
            finished = False
            n_commit = 0
            for t in drafts[:n_acc] + [nxt]:
                st.output.append(int(t))
                n_commit += 1
                if (eos is not None and t == eos) \
                        or st.n_generated >= st.req.max_new_tokens:
                    finished = True
                    break
            self.pos[s] += n_commit
            self.metrics.spec_committed += n_commit
            total_commit += n_commit
            if self._sharing and self.pos[s] // bs > old_pos // bs:
                # crossed a block boundary: index every newly full block
                self._commit_output(st, int(self.pos[s]))
            if finished:
                self._finish(st, now)
            else:
                self.tok[s] = st.output[-1]
        self.metrics.record_phase("verify", total_commit, dt, verify_bytes)
        return True

    def _attn_kv_bytes(self, span: int) -> int:
        """Analytic attention-read bytes of one decode step whose deepest
        read a row is ``pos + span`` (the JAX engine's model): the kernel
        reads each row's live block-rounded chain; the plain version, and
        the ring gather, every row's whole logical view."""
        bs = self.ecfg.kv_block_size
        if self.ecfg.paged:
            if self._fused and not self.kv.ring:
                lens = self.pos[self.active] + span
                toks = int(np.sum(-(-lens // bs) * bs))
            else:
                toks = self.ecfg.max_slots * self.kv.blocks_per_slot * bs
        else:
            toks = self.ecfg.max_slots * self.ecfg.max_seq_len
        return toks * self._kv_token_bytes

    def _prefill_kv_bytes(self, upto: int) -> int:
        """Analytic attention-read bytes of one prefill chunk whose
        deepest position is ``upto``: the kernel stops at the
        slab-block-rounded frontier on the paged pool (the JAX engine's
        model); the plain version, which a window binding over the
        scratch takes, reads the whole scratch."""
        w = self.cfg.sliding_window
        if self.ecfg.paged and self._fused and (w == 0
                                                or w >= self.kv.s_pad):
            toks = -(-upto // self._slab_bs) * self._slab_bs
        else:
            toks = self.kv.s_pad
        return toks * self._kv_token_bytes

    # ------------------------------------------------------------------
    # between-window hot-expert replication (serve/rebalance.py)
    # ------------------------------------------------------------------
    def _observe_load(self, diags) -> None:
        """Fold this decode step's global per-expert load ([Ep]
        ``expert_load``) into the rebalancer's EMA."""
        if self._rebalancer is None or "expert_load" not in diags:
            return
        self._rebalancer.observe(
            np.asarray(diags["expert_load"]).reshape(-1))

    def _rebalance_now(self) -> None:
        """Close a load window: re-derive the hot set from the EMA and, if
        it changed, gather the hot experts' rows into every non-host
        rank's replica slots (in place, one captured graph) and publish
        the new ``[G, R]`` table to the next chunks and steps."""
        dec = self._rebalancer.propose()
        self._rebalances += 1
        if not dec.changed:
            return
        self._swap(dec.weight_rows, dec.replica_ids)
        self._replica_ids = dec.replica_ids
        self._replica_swaps += 1

    # ------------------------------------------------------------------
    # tiered expert residency (serve/residency.py)
    # ------------------------------------------------------------------
    def _observe_residency(self, layer_loads) -> None:
        """Feed this step's per-layer expert loads ([n_moe_layers, Ep]) to
        the residency manager; its decision is applied at the start of
        the next decode step."""
        if self._residency is None or layer_loads is None:
            return
        self._pending_stage = self._residency.step(np.asarray(layer_loads))

    def _apply_pending_stage(self) -> None:
        """Apply the previous step's decision: stage its rows, then
        publish the new ``[G, W]`` table to this step."""
        dec = self._pending_stage
        if dec is None:
            return
        self._pending_stage = None
        if dec.stage_rows.size:
            self._dispatch_stage(dec.stage_rows)
        self._residency_ids = dec.residency_ids

    def _dispatch_stage(self, rows: np.ndarray) -> None:
        """Copy ``rows`` (stacked weight-row indices) from the host tier
        into the expert leaves: every row in one process, across processes
        the rows this rank hosts (no collective).  On the card the copies
        run on a side stream after the work already queued, and the
        current stream (the decode step that follows) waits on their end;
        the events around them time the copy (``stage_times``)."""
        rows = [int(r) for r in rows]
        n = len(self._host_tier.own(rows))
        entry = {"rows": n, "bytes": n * self._host_tier.row_bytes}
        if self.device.type == "cuda":
            cur = torch.cuda.current_stream(self.device)
            side = self._stage_stream
            side.wait_stream(cur)
            start, end = (torch.cuda.Event(enable_timing=True)
                          for _ in range(2))
            with torch.cuda.stream(side):
                start.record(side)
                self._host_tier.stage(rows)
                end.record(side)
            cur.wait_event(end)
            entry["events"] = (start, end)
        else:
            self._host_tier.stage(rows)
        self.stage_log.append(entry)
        self._residency_stages += 1

    def stage_times(self) -> List[Dict[str, float]]:
        """Each stage's rows and bytes (this process's share across
        processes) and, on the card, the copy's device ms (from the events
        around it on the side stream)."""
        if self.device.type == "cuda":
            self._sync()
        out = []
        for e in self.stage_log:
            rec = {"rows": e["rows"], "bytes": e["bytes"]}
            if "events" in e:
                rec["ms"] = e["events"][0].elapsed_time(e["events"][1])
            out.append(rec)
        return out

    def close(self) -> None:
        """Release the host tier once no copy from it is in flight."""
        if self._host_tier is not None:
            self._sync()
            self._host_tier.release()

    def _finish(self, st: RequestState, now: float) -> None:
        st.finish_time = now
        st.status = RequestStatus.FINISHED
        self.metrics.complete(st)
        s = st.slot
        self.active[s] = False
        self.pos[s] = 0
        self.tok[s] = 0
        self.front.state_by_slot[s] = None
        self.front.free_slots.append(s)
        self.kv.release(st.req.rid, s)

    # ------------------------------------------------------------------
    def warmup(self) -> None:
        """Run one prefill chunk, the store's write (with prefix sharing its
        gather and copy too) and one decode or verify step on dummy data,
        so the first request's TTFT does not include building the kernels,
        first-call set-up or, on the card, capturing the entries.  Writes
        land in the null block (paged) or in slot 0 and the scratch
        (slab), so the engine must be idle."""
        if self.has_work() or any(st is not None
                                  for st in self.front.state_by_slot):
            raise RuntimeError("warmup() must run on an idle engine")
        attention_dispatch.reset_dispatch_log()
        C = self.ecfg.prefill_chunk
        self.core.prefill(self.params, np.zeros((1, C), np.int32),
                          self.kv.scratch, 0, C - 1, 2 ** 31 - 1,
                          self._replica_ids)
        table = self.kv.warm()
        self.core.prefill_result()
        # speculative: the decode entry is the [B, k + 1] verify step
        warm_tok = (np.zeros((self.ecfg.max_slots,
                              self.ecfg.speculative_k + 1), np.int32)
                    if self._spec else self.tok)
        self.core.decode(self.params, warm_tok, self.kv.pool, self.pos,
                         table, self.active, 2 ** 31 - 1,
                         self._replica_ids, self._residency_ids)
        if self._rebalancer is not None:
            # capture the swap too: the slots are empty (ids all -1), so
            # the rows copied are dead, and real swaps replay the graph
            self._swap(np.zeros((self._replica_ids.size,), np.int32),
                       np.full_like(self._replica_ids, -1))
        self._sync()
        self._attn_dispatch = attention_dispatch.dispatch_log()
        self._warm_counts = self.jit_counts()

    def _agreed_now(self) -> float:
        """This tick's clock reading: the engine's own, or across
        processes rank 0's, which every rank admits on."""
        now = self.clock.now()
        if self.dist is not None:
            now = self.dist.rank0_value(now)
        return now

    def step(self, now: Optional[float] = None, *,
             wait_when_idle: bool = True) -> bool:
        """One scheduler tick: admit, prefill chunk(s), decode the batch.
        ``now`` lets a fleet router drive several replicas off one clock
        reading a tick (each ``clock.now()`` advances a ``VirtualClock``,
        so reads of their own would skew the replicas' time);
        ``wait_when_idle=False`` leaves the idle wait to the router, which
        knows every replica's next arrival.  Returns whether any prefill
        or decode work ran."""
        if now is None:
            now = self._agreed_now()
        self._admit(now)
        did = self._prefill_work(now)
        did = self._decode_work(now) or did
        self._step_idx += 1
        if self._rebalancer is not None \
                and self.ecfg.rebalance_interval > 0 \
                and self._step_idx % self.ecfg.rebalance_interval == 0 \
                and self._rebalancer.steps_observed > 0:
            self._rebalance_now()
        if not did and wait_when_idle:
            nxt = self.front.queue.next_arrival()
            if nxt is not None:
                self.clock.wait(min(max(nxt - now, 0.0), 0.01))
        return did

    def run(self, requests: Sequence[Request] = (), *,
            max_steps: int = 1_000_000) -> Dict[str, Any]:
        """Drive the engine until all work drains.  A fresh measurement
        window (nothing in flight, no metrics yet) rebases the clock to 0
        so arrival times count from this call."""
        if not self._in_flight() and self.metrics.empty:
            self.clock.reset()
        for r in requests:
            self.submit(r)
        steps = 0
        while self.has_work():
            self.step()
            steps += 1
            if steps > max_steps:
                raise RuntimeError(f"serve engine exceeded {max_steps} steps "
                                   f"with work remaining")
        return self.report()

    def reset_metrics(self) -> None:
        """Fresh metrics for a new measurement window (the JAX method):
        slot state, captured entries, the prefix cache and warmup status
        are kept, the allocator's and residency counters are re-based and
        the clock is re-zeroed.  The engine must have nothing in
        flight."""
        if self._in_flight():
            raise RuntimeError("cannot reset metrics while work is in flight")
        self.metrics = ServeMetrics()
        self.front.slot_history.clear()
        if self.ecfg.paged:
            self._evict0 = self._alloc.evictions
            self._cow0 = self._alloc.cow_copies
        if self._residency is not None:
            self._res_base = self._residency.counters()
        self.clock.reset()

    # ------------------------------------------------------------------
    # prefill-to-decode handoff (split roles; serve/kvstore.py)
    # ------------------------------------------------------------------
    def _export_handoff(self, st: RequestState) -> None:
        """Package a finished prefill as a ``HandoffRecord`` and release
        its slot and blocks.  The scratch still holds the request's whole
        committed K/V (a gathered cached prefix included); indexed prefix
        blocks stay on the cached-free list, so this engine's prefix cache
        keeps serving later arrivals."""
        C = self.ecfg.prefill_chunk
        pad = round_up(st.prefill_len, C)
        rec = HandoffRecord(
            rid=st.req.rid, prompt_tokens=st.req.tokens.copy(),
            output=list(st.output), pos=st.prefill_len, pad_len=pad,
            prefill_chunk=C, max_new_tokens=st.req.max_new_tokens,
            eos_id=st.req.eos_id, kv=self.kv.export_kv(pad),
            cached_prefix_tokens=int(st.cached_prefix_tokens or 0),
            arrival_time=st.req.arrival_time,
            admitted_time=st.admitted_time,
            first_token_time=st.first_token_time)
        self._handoffs_out.append(rec)
        self.handoffs_exported += 1
        self.handoff_bytes_out += rec.nbytes
        st.status = RequestStatus.HANDED_OFF
        s = st.slot
        self.front.state_by_slot[s] = None
        self.front.free_slots.append(s)
        self.kv.release(st.req.rid, s)

    def pop_handoffs(self) -> List[HandoffRecord]:
        """Drain the exported records (prefill role; the fleet router moves
        them to a decode-role engine)."""
        out = list(self._handoffs_out)
        self._handoffs_out.clear()
        return out

    def import_handoff(self, rec: HandoffRecord) -> bool:
        """Adopt a handed-off request: a slot and a block chain, the
        record's K/V scattered into this pool, and the request in the
        decode batch at the exporter's committed position.  False (the
        record untouched, to retry later) while no slot or too few blocks
        are free; raises when the record can never fit this engine."""
        if not self.ecfg.paged:
            raise RuntimeError("import_handoff needs the paged KV pool")
        C, bs = self.ecfg.prefill_chunk, self.ecfg.kv_block_size
        if rec.prefill_chunk != C:
            raise ValueError(
                f"handoff was prefilled with chunk {rec.prefill_chunk}, "
                f"this engine uses {C}; the import replays the exporter's "
                f"chunk-aligned scatters, so the two must match")
        L = len(rec.prompt_tokens)
        if L + rec.max_new_tokens > self.ecfg.max_seq_len:
            raise ValueError(
                f"handoff {rec.rid}: prompt {L} + max_new "
                f"{rec.max_new_tokens} exceeds max_seq_len "
                f"{self.ecfg.max_seq_len}")
        if rec.pad_len > self.kv.kv_capacity:
            raise ValueError(
                f"handoff {rec.rid}: padded prefill {rec.pad_len} exceeds "
                f"the per-layer KV capacity {self.kv.kv_capacity}")
        front = self.front
        if not front.free_slots:
            return False
        n_blocks = blocks_for_tokens(rec.pad_len, bs)
        if not self._alloc.can_allocate(n_blocks, []):
            return False
        req = Request(rid=rec.rid, tokens=rec.prompt_tokens,
                      max_new_tokens=rec.max_new_tokens,
                      arrival_time=rec.arrival_time, eos_id=rec.eos_id)
        st = RequestState(req=req, slot=-1,
                          admitted_time=rec.admitted_time,
                          first_token_time=rec.first_token_time,
                          output=list(rec.output), prefill_pos=rec.pos,
                          cached_prefix_tokens=rec.cached_prefix_tokens)
        slot = front.free_slots.popleft()
        st.slot = slot
        st.admit_seq = front.admit_seq
        front.admit_seq += 1
        front.state_by_slot[slot] = st
        front.slot_history.append((req.rid, slot))
        chain = self._alloc.alloc_chain(req.rid, n_blocks)
        assert chain is not None          # gated by can_allocate above
        self.kv.import_kv(rec.kv, rec.pad_len, self.kv.bt_row(req.rid))
        if self._sharing:
            # the imported K/V is bit-equal to a local prefill's, so its
            # full blocks are worth indexing here too
            self._alloc.commit_prefix(req.rid, st.prefill_tokens[:rec.pos])
        self.handoffs_imported += 1
        self.handoff_bytes_in += rec.nbytes
        self._activate(st, rec.pos, st.output[-1])
        return True

    # ------------------------------------------------------------------
    # fleet routing probes (serve/fleet.py)
    # ------------------------------------------------------------------
    def load_stats(self) -> Dict[str, Any]:
        """The scheduler state the fleet router scores replicas by: no
        device read, no allocator change."""
        if self.ecfg.paged:
            kv_tokens = self._alloc.blocks_in_use * self.ecfg.kv_block_size
            kv_util = (self._alloc.blocks_in_use
                       / max(self._alloc.usable_blocks, 1))
        else:
            kv_tokens = int(self.pos.sum())
            kv_util = float(self.active.sum()) / self.ecfg.max_slots
        return {
            "queued_tokens": self.front.queued_tokens(),
            "kv_tokens": int(kv_tokens),
            "kv_utilization": float(kv_util),
            "active_slots": int(self.active.sum()),
            "free_slots": len(self.front.free_slots),
            "pending_handoffs": len(self._handoffs_out),
        }

    def probe_prefix(self, tokens) -> int:
        """Longest cached-prefix match for ``tokens`` in this engine's
        prefix index, in tokens (0 without prefix sharing); a pure lookup
        that never perturbs the LRU order."""
        return self.kv.probe_prefix(tokens)

    def jit_counts(self) -> Dict[str, int]:
        """Every captured entry, by the JAX engine's names: the step
        core's, the store's write (and with prefix sharing its gather and
        copy), the replica swap and the residency stage (never captured:
        0)."""
        counts = {**self.core.jit_counts(), **self.kv.jit_counts()}
        if self._rebalancer is not None:
            counts["replica_swap"] = self._swap.captures
        if self._residency is not None:
            counts["residency_stage"] = 0
        return counts

    def report(self) -> Dict[str, Any]:
        """The JAX engine's report: the metrics' sections, ``engine``
        (plus ``device``, the port's own key), ``attention_dispatch``
        with ``attention_fallbacks``, ``jit_entries`` and, after
        ``warmup()``, ``recompiled_after_warmup``."""
        if self.ecfg.paged:
            self.metrics.evictions = self._alloc.evictions - self._evict0
            self.metrics.cow_copies = self._alloc.cow_copies - self._cow0
        if self._residency is not None:
            # window counters: lifetime minus the reset_metrics snapshot
            cur = self._residency.counters()
            base = self._res_base or {}
            win = {k: cur[k] - base.get(k, 0)
                   for k in cur if k != "hit_rate"}
            win["hit_rate"] = (win["hits"] / win["lookups"]
                               if win["lookups"] else None)
            self.metrics.residency = win
        rep = self.metrics.report()
        rep["state_pool"] = {**self.kv.stats(),
                             "preemptions": self.metrics.preemptions}
        rep["engine"] = {
            "max_slots": self.ecfg.max_slots,
            "max_seq_len": self.ecfg.max_seq_len,
            "prefill_chunk": self.ecfg.prefill_chunk,
            "kv_capacity": self.kv.kv_capacity,
            "steps": self._step_idx,
            "device": str(self.device),
            "paged": self.ecfg.paged,
            "role": self.role,
        }
        if self.dist is not None:
            rep["engine"]["comm"] = {
                **self.dist.describe(), "rank": self.dist.rank,
                "entries": ("captured" if any(self.core.jit_counts().values())
                            else "eager")}
        if self.ecfg.paged:
            rep["engine"]["kv_block_size"] = self.ecfg.kv_block_size
            rep["engine"]["num_kv_blocks"] = self._alloc.usable_blocks
            rep["engine"]["blocks_per_slot"] = self.kv.blocks_per_slot
            rep["engine"]["prefix_sharing"] = self.ecfg.prefix_sharing
            rep["engine"]["fused_paged_attention"] = self._fused
            rep["engine"]["speculative_k"] = self.ecfg.speculative_k
            if self._spec:
                rep["engine"]["speculative_policy"] = \
                    self.ecfg.speculative_policy
        if self.role != "unified" or self.handoffs_exported \
                or self.handoffs_imported:
            rep["engine"]["handoffs"] = {
                "exported": self.handoffs_exported,
                "imported": self.handoffs_imported,
                "bytes_out": self.handoff_bytes_out,
                "bytes_in": self.handoff_bytes_in,
                "pending": len(self._handoffs_out),
            }
        if self.cfg.is_moe:
            rep["engine"]["moe_policy"] = (self.ecfg.moe_policy
                                           or self.cfg.moe.policy)
            rep["engine"]["fused_moe_gmm"] = self._fused
            rep["engine"]["replica_slots"] = self.ecfg.replica_slots
            if self._rebalancer is not None:
                rep["engine"]["rebalance_interval"] = \
                    self.ecfg.rebalance_interval
                rep["engine"]["rebalances"] = self._rebalances
                rep["engine"]["replica_swaps"] = self._replica_swaps
                rep["engine"]["replica_ids"] = self._replica_ids.tolist()
                rep["engine"]["hot_experts"] = self._rebalancer.hot()
            rep["engine"]["resident_experts"] = self.ecfg.resident_experts
            if self._residency is not None:
                rep["engine"]["prefetch_policy"] = self.ecfg.prefetch_policy
                rep["engine"]["residency_stages"] = self._residency_stages
                rep["engine"]["residency_ids"] = \
                    self._residency_ids.tolist()
        snap = (self._attn_dispatch if self._attn_dispatch is not None
                else attention_dispatch.dispatch_log())
        if snap:
            # the last record a branch wins, as in JAX (every call of one
            # agrees, but on a local/global model the global layer's, last
            # in its period);
            # ``requested`` is the config's switch, as in JAX, and a
            # fallback is a record where it was on and the kernel did not run
            req = self.ecfg.fused_paged_attention
            # (a record of the plain branches a caller asked for, the
            # hybrid stack's, carries its own requested: False)
            rep["attention_dispatch"] = {
                d["branch"]: {"fused": d["fused"],
                              "requested": d.get("requested", req),
                              "reason": d["reason"]} for d in snap}
            rep["attention_fallbacks"] = dict(Counter(
                d["branch"] for d in snap
                if d.get("requested", req) and not d["fused"]))
        rep["jit_entries"] = self.jit_counts()
        if self._warm_counts is not None:
            rep["recompiled_after_warmup"] = \
                rep["jit_entries"] != self._warm_counts
        return rep
