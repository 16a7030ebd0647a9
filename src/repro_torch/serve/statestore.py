"""Sequence-state ownership: the protocol every serving state pool obeys
(port of ``repro/serve/statestore.py``'s ``SequenceStateStore`` and
``make_state_store``).

``ServeEngine`` addresses per-sequence state only through this
surface.  The port has one implementation,
``kvstore.KVOwner`` (token-indexed K/V, slab rows or paged blocks); the
JAX package's ``SlotStateStore`` for recurrent SSM state comes with the
SSM slice.
"""
from __future__ import annotations

from typing import Any, Dict, Optional, Protocol, Tuple

import numpy as np

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


def make_state_store(model, ecfg, *, s_pad: int) -> SequenceStateStore:
    """The state store for ``model``: ``KVOwner`` in whichever of its two
    modes ``ecfg`` selects.  SSM and hybrid families, whose recurrent
    state needs the slotted ``SlotStateStore``, are not ported yet."""
    from repro_torch.serve.kvstore import KVOwner
    cfg = model.cfg
    if cfg.family in ("ssm", "hybrid"):
        raise NotImplementedError(
            f"{cfg.name} ({cfg.family}): the slotted state store for "
            f"recurrent state is not ported yet (ROADMAP item 8, SSM and "
            f"hybrid)")
    return KVOwner(model, ecfg, s_pad=s_pad)
