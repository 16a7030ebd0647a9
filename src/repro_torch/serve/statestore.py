"""Sequence-state ownership: the protocol every serving state pool obeys
(port of ``repro/serve/statestore.py``: ``SequenceStateStore``,
``SlotStateStore`` and ``make_state_store``).

``ServeEngine`` addresses per-sequence state only through this
surface.  Two implementations: ``kvstore.KVOwner`` (token-indexed K/V,
slab rows or paged blocks) and ``SlotStateStore``, the slotted pool of
the SSM and hybrid families' fixed-size recurrent state.
"""
from __future__ import annotations

from typing import Any, Dict, Optional, Protocol, Tuple

import numpy as np

from repro_torch.serve.kvstore import KVOwner
from repro_torch.serve.paging import kv_leaves
from repro_torch.serve.slots import (discover_batch_axes, discover_seq_axes,
                                     min_kv_capacity)
from repro_torch.serve.stepcore import Entry, Staged

class SequenceStateStore(Protocol):
    """What ``ServeEngine`` asks of the component that owns per-sequence
    model state.  The engine keeps the scheduling state (slots, queues,
    positions) and leaves every write into the pool to the store.

    ``pool`` is the full-batch state every decode step reads and writes,
    ``scratch`` the batch-1 prefill state.  Fixed at construction:
    ``paged``, ``kv_capacity`` (longest admissible padded prompt) and
    ``alloc`` (the block allocator; None for slab stores)."""
    paged: bool
    pool: Any
    scratch: Any
    kv_capacity: int
    alloc: Any

    def begin_prefill(self) -> None:
        """A new request's prefill starts on the scratch (recurrent stores
        reset it to the zero state here)."""
        ...

    def plan(self, tokens, resumed: bool) -> Tuple[int, list, int, bool]:
        """Admission plan for a (re)prefill over ``tokens``: (start,
        shared prefix blocks, fresh blocks, copy the last shared block)."""
        ...

    def can_admit(self, plan) -> bool:
        """Whether the store can take ``plan``'s blocks right now."""
        ...

    def place(self, rid: int, plan) -> None:
        """Reserve an admitted request's storage."""
        ...

    def after_chunk(self, rid: int, start: int, valid_to: int) -> None:
        """The scratch holds a finished prefill chunk at ``start``."""
        ...

    def on_prefill_done(self, slot: int) -> None:
        """The scratch holds the whole prefill of the request in ``slot``."""
        ...

    def activate(self, rid: int, slot: int) -> None:
        """The request joins the decode batch in ``slot``."""
        ...

    def covers(self, rid: int, pos: int) -> bool:
        """Whether the request's storage holds a write at ``pos``."""
        ...

    def extend(self, rid: int, slot: int) -> bool:
        """Grow the request's storage by one block; False when dry."""
        ...

    def decode_table(self) -> Optional[np.ndarray]:
        """The block table a decode step reads (None without blocks)."""
        ...

    def occupancy(self) -> Optional[Tuple[int, int]]:
        """(blocks in use, usable blocks), or None without blocks."""
        ...

    def warm(self) -> Optional[np.ndarray]:
        """Exercise the scratch-to-pool write where no request reads it;
        the block table a warm-up decode step should read."""
        ...

    def release(self, rid: int, slot: int) -> None:
        """Free every store-side resource request ``rid`` in ``slot``
        holds (finish and preempt both land here)."""
        ...

    def stats(self) -> Dict[str, Any]:
        """The ``state_pool`` report section."""
        ...

    def jit_counts(self) -> Dict[str, int]:
        """The store's compiled entries (captured graphs), by name."""
        ...

    def export_kv(self, pad_len: int) -> list:
        """A finished prefill's state, positions ``[0, pad_len)``, as host
        tensors (the prefill role's handoff payload; paged only)."""
        ...

    def import_kv(self, kv: list, pad_len: int, bt_row: np.ndarray) -> None:
        """Write a handoff record's state into this pool through
        ``bt_row`` (the decode role's import; paged only)."""
        ...


class SlotStateStore(KVOwner):
    """Slotted, preemptible state pool for the SSM and hybrid families (the
    JAX class).  ``pool`` is ``model.init_cache(max_slots, max_seq_len)``:
    for a pure SSM stack fixed-size recurrent state a slot (no KV-length
    axis at all), for a hybrid stack the mamba leaves beside the shared
    attention's K/V slabs.  Prefill runs on the batch-1 ``scratch``,
    reset to the zero state at each ``begin_prefill`` (recurrent state
    carries across a request's chunks, which a new request must not
    inherit), and the finished state is committed with the slab's
    captured ``write_slot``, so slot recycling never recaptures.  It is
    ``KVOwner``'s slab mode otherwise: no blocks, a free slot the only
    admission gate.  Preemption drops the slot; resume re-prefills the
    prompt and the committed output, which rebuilds the state token for
    token (pad positions are kept out of the fold:
    ``mamba_block(valid_len=...)``)."""

    def __init__(self, model, ecfg):
        self.ecfg = ecfg
        self.paged = self.sharing = False
        self.device = model.device
        self.alloc = self.block_table = None
        self.blocks_per_slot = 0
        self.ring = self.ring_full_chain = False
        self.ring_mod = 0
        B = ecfg.max_slots
        self.s_pad = ecfg.max_seq_len
        self.seq_axes = discover_seq_axes(model.init_cache, ecfg.max_seq_len)
        self.batch_axes = discover_batch_axes(model.init_cache,
                                              ecfg.max_seq_len)
        # pure SSM state has no KV-length axis: prompts are bounded by
        # max_seq_len alone; hybrid attention leaves set the usual minimum
        self.kv_capacity = min_kv_capacity(
            model.init_cache, ecfg.max_seq_len, self.seq_axes,
            default=ecfg.max_seq_len)
        self.pool = model.init_cache(B, ecfg.max_seq_len)
        self.scratch = model.init_cache(1, ecfg.max_seq_len)
        self._in = Staged(1, self.device)                 # the slot
        self.write = Entry(lambda pool, scratch: self._write(pool, scratch),
                           self.device)
        self.import_scratch = self.import_entry = None
        self.scratch_resets = 0

    def begin_prefill(self) -> None:
        """Reset the scratch to the pristine zero state, in place (the
        captured entries read these tensors)."""
        for leaf in kv_leaves(self.scratch):
            leaf.zero_()
        self.scratch_resets += 1

    def bt_row(self, rid: int) -> np.ndarray:
        raise RuntimeError("SlotStateStore has no block table")

    def export_kv(self, pad_len: int) -> list:
        raise NotImplementedError(
            "recurrent-state handoff is not wired; split prefill/decode "
            "roles require the paged transformer KV store")

    def import_kv(self, kv: list, pad_len: int, bt_row: np.ndarray) -> None:
        raise NotImplementedError(
            "recurrent-state handoff is not wired; split prefill/decode "
            "roles require the paged transformer KV store")

    def stats(self) -> Dict[str, Any]:
        total = sum(t.numel() * t.element_size()
                    for t in kv_leaves(self.pool))
        return {"kind": "slot", "slots": self.ecfg.max_slots,
                "state_bytes_per_slot": total // max(self.ecfg.max_slots, 1),
                "pool_bytes": total,
                "scratch_resets": self.scratch_resets}


def make_state_store(model, ecfg, *, s_pad: int) -> SequenceStateStore:
    """The state store for ``model``: SSM and hybrid families carry
    recurrent per-sequence state, which has no KV-length axis to address
    through a block table, so they get the slotted pool (and refuse
    ``paged=True`` with the JAX message); everything else ``KVOwner`` in
    whichever of its two modes ``ecfg`` selects."""
    cfg = model.cfg
    if cfg.family in ("ssm", "hybrid"):
        if ecfg.paged:
            raise ValueError(
                f"{cfg.name} ({cfg.family}) carries fixed-size recurrent "
                f"state with no KV-length axis to page; serve it from the "
                f"slotted state pool (EngineConfig.paged=False)")
        return SlotStateStore(model, ecfg)
    return KVOwner(model, ecfg, s_pad=s_pad)
