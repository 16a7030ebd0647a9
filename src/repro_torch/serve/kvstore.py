"""KV ownership for the serving engine (port of ``repro/serve/kvstore.py``'s
``KVOwner``, slab and paged, with no prefix sharing and no handoff): the
token-indexed implementation of ``statestore.SequenceStateStore``.

``KVOwner`` owns where K/V lives and the batch-1 prefill scratch.  On the
slab (``EngineConfig.paged=False``, the default) the pool is
``init_cache(max_slots, max_seq_len)``, one row a slot, and a finished
prefill's scratch is copied into its slot's row (``slots.write_slot``).
Paged, the pool is a batch-1 cache of ``num_kv_blocks`` blocks with a
block allocator and table, and each finished chunk is scattered into the
request's blocks (``paging.write_chunk_blocks``).  Cache leaves' batch and
KV-length axes are discovered structurally (``serve/slots.py``), so
leading dense layers' leaves ``[B, S, Hkv, hd]`` sit beside stacked ones
``[n, B, S, Hkv, hd]``.  The engine keeps the scheduling state and
delegates every pool or allocator touch here.

The write is compiled once, as JAX jits ``write_blocks`` / ``write_slot``
(``stepcore.Entry``): it reads the block-table row, the chunk start and
the end of its real tokens, or the slot, from a static int32 device
buffer filled from pinned memory, and on the card it is captured as its
own CUDA graph at ``warm()`` (or its first use) and replayed after.

Sliding-window models are served paged as ring buffers, as in JAX: the
pool and scratch are built over the unclamped cache (chunked prefill
attends through the full-length scratch, where the window is a mask), and
each window-clamped leaf gets the ring modulus M = round_up(window,
block_size) (``ring_mods``, constants of the captured write): logical
position p lives at ring slot p % M of the slot's chain, in the prefill
scatter and in the decode write and gather.  When every KV leaf is
windowed the chain itself shrinks to M / block_size blocks, allocated
whole at admission (``ring_full_chain``).  On the slab a windowed leaf is
clamped to the window and decode wraps it (``attention.decode_slab``).
"""
from __future__ import annotations

from typing import Any, Dict, Optional, Tuple

import numpy as np

from repro_torch.configs.base import round_up
from repro_torch.serve.paging import (NULL_BLOCK, BlockAllocator,
                                      blocks_for_tokens, write_chunk_blocks)
from repro_torch.serve.slots import (leaf_shapes, discover_batch_axes,
                                     discover_seq_axes, min_kv_capacity,
                                     write_slot)
from repro_torch.serve.stepcore import Entry, Staged


class KVOwner:
    def __init__(self, model, ecfg, *, s_pad: int):
        self.ecfg = ecfg
        self.paged = ecfg.paged
        self.device = model.device
        B = ecfg.max_slots
        self.seq_axes = discover_seq_axes(model.init_cache, ecfg.max_seq_len)
        self.alloc = None
        self.block_table = None
        self.ring = self.ring_full_chain = False
        self.ring_mod = 0
        if self.paged:
            bs = ecfg.kv_block_size
            self.s_pad = s_pad
            self.blocks_per_slot = blocks_for_tokens(s_pad, bs)
            # ring discovery: a leaf is windowed iff clamping changes its
            # KV length at s_pad; with every leaf windowed the whole chain
            # shrinks to M
            window = model.cfg.sliding_window
            M = round_up(window, bs) if window else 0
            clamped = leaf_shapes(model.init_cache, 1, s_pad)
            full = leaf_shapes(lambda b, s, device: model.init_cache(
                b, s, device, clamp_window=False), 1, s_pad)
            self.ring_mods = [M if ax >= 0 and c[ax] != f[ax] else 0
                              for c, f, ax in zip(clamped, full,
                                                  self.seq_axes)]
            n_seq = sum(ax >= 0 for ax in self.seq_axes)
            n_ring = sum(m > 0 for m in self.ring_mods)
            self.ring = n_ring > 0
            self.ring_mod = M if self.ring else 0
            self.ring_full_chain = self.ring and n_ring == n_seq
            if self.ring_full_chain:
                self.blocks_per_slot = M // bs
            usable = ecfg.num_kv_blocks or B * self.blocks_per_slot
            if usable < self.blocks_per_slot:
                raise ValueError(
                    f"num_kv_blocks={usable} cannot hold even one "
                    f"worst-case request ({self.blocks_per_slot} blocks)")
            self.alloc = BlockAllocator(usable + 1, bs)   # +1: null block
            self.block_table = np.full((B, self.blocks_per_slot),
                                       NULL_BLOCK, np.int32)
            self.kv_capacity = s_pad
            self.pool = model.init_paged_cache(self.alloc.num_blocks, bs,
                                               s_pad, seq_axes=self.seq_axes,
                                               clamp_window=False)
            self.scratch = model.init_cache(1, s_pad, clamp_window=False)
        else:
            self.s_pad = ecfg.max_seq_len
            self.blocks_per_slot = 0
            self.batch_axes = discover_batch_axes(model.init_cache,
                                                  ecfg.max_seq_len)
            self.kv_capacity = min_kv_capacity(
                model.init_cache, ecfg.max_seq_len, self.seq_axes)
            self.pool = model.init_cache(B, ecfg.max_seq_len)
            self.scratch = model.init_cache(1, ecfg.max_seq_len)
        # paged: block-table row | chunk start | end of its real tokens;
        # slab: the slot
        self._in = Staged(self.blocks_per_slot + 2 if self.paged else 1,
                          self.device)
        self.write = Entry(lambda pool, scratch: self._write(pool, scratch),
                           self.device)

    # ------------------------------------------------------------------
    # SequenceStateStore protocol (serve/statestore.py)
    # ------------------------------------------------------------------
    def plan(self, tokens) -> int:
        """Fresh blocks a (re)prefill over ``tokens`` needs: paged, the
        chunk-padded prefill writes (no prefix sharing, so every block is
        fresh); none on the slab, where a free slot is the only
        resource."""
        if not self.paged:
            return 0
        if self.ring_full_chain:
            # every leaf wraps the same fixed ring: the chain is whole or
            # nothing, whatever the prompt's length
            return self.blocks_per_slot
        return blocks_for_tokens(round_up(len(tokens),
                                          self.ecfg.prefill_chunk),
                                 self.ecfg.kv_block_size)

    def can_admit(self, n_fresh: int) -> bool:
        return not self.paged or self.alloc.can_allocate(n_fresh)

    def place(self, rid: int, n_fresh: int) -> None:
        """Reserve admitted request ``rid``'s storage: its chain of
        ``n_fresh`` blocks (paged; the slab row is the slot itself)."""
        if self.paged:
            chain = self.alloc.alloc_chain(rid, n_fresh)
            assert chain is not None          # gated by can_admit

    def after_chunk(self, rid: int, start: int, valid_to: int) -> None:
        """The scratch holds a finished chunk at ``start`` whose real
        tokens end at ``valid_to``: paged, scatter it into ``rid``'s blocks
        (the slab commits once, at the end)."""
        if self.paged:
            self._stage_write(np.append(self.bt_row(rid), [start, valid_to]))

    def on_prefill_done(self, slot: int) -> None:
        """The scratch holds a whole prefill: on the slab, copy it into
        row ``slot`` (paged chains were written chunk by chunk)."""
        if not self.paged:
            self._stage_write(np.array([slot]))

    def activate(self, rid: int, slot: int) -> None:
        """``rid`` joins the decode batch in ``slot``: paged, its table
        row goes live.  Until then the row stays on the null block,
        because decode writes every row's (garbage, for inactive rows)
        K/V through the table, which must not reach mid-prefill blocks."""
        if self.paged:
            self.block_table[slot] = self.bt_row(rid)

    def covers(self, rid: int, pos: int) -> bool:
        """Whether ``rid``'s storage holds a write at position ``pos``
        (always on the slab, whose rows are ``max_seq_len`` long, and on a
        whole ring chain, which wraps)."""
        return (not self.paged or self.ring_full_chain
                or len(self.alloc.chain(rid))
                * self.ecfg.kv_block_size > pos)

    def extend(self, rid: int, slot: int) -> bool:
        """Grow ``rid``'s chain by one block; False while the allocator is
        dry (paged only: ``covers`` is always true on the slab)."""
        blk = self.alloc.extend(rid)
        if blk is None:
            return False
        self.block_table[slot, len(self.alloc.chain(rid)) - 1] = blk
        return True

    def decode_table(self) -> Optional[np.ndarray]:
        """The block table a decode step reads (None on the slab)."""
        return self.block_table.copy() if self.paged else None

    def occupancy(self) -> Optional[Tuple[int, int]]:
        """(blocks in use, usable blocks), or None on the slab."""
        if not self.paged:
            return None
        return self.alloc.blocks_in_use, self.alloc.usable_blocks

    def warm(self) -> Optional[np.ndarray]:
        """Run the scratch-to-pool write once where no request reads it
        (the null block; row 0 of an idle slab), which on the card
        captures it, and return the block
        table a warm-up decode step should read (all null; None on the
        slab)."""
        if not self.paged:
            self.on_prefill_done(0)
            return None
        self._stage_write(np.append(np.full((self.blocks_per_slot,),
                                            NULL_BLOCK, np.int32), [0, 0]))
        return np.full_like(self.block_table, NULL_BLOCK)

    def release(self, rid: int, slot: int) -> None:
        """Free ``rid``'s blocks and park its table row on the null block
        (a no-op on the slab: its row is overwritten whole at the slot's
        next commit)."""
        if self.paged:
            self.alloc.release(rid)
            self.block_table[slot, :] = NULL_BLOCK

    def bt_row(self, rid: int) -> np.ndarray:
        """A request's block-table row, built from its live chain (the
        engine-visible row may still be parked on the null block)."""
        row = np.full((self.blocks_per_slot,), NULL_BLOCK, np.int32)
        chain = self.alloc.chain(rid)
        row[:len(chain)] = chain
        return row

    def stats(self) -> Dict[str, Any]:
        if not self.paged:
            return {"kind": "slab", "slots": self.ecfg.max_slots}
        out = {"kind": "paged",
               "kv_block_size": self.ecfg.kv_block_size,
               "blocks_per_slot": self.blocks_per_slot,
               "usable_blocks": self.alloc.usable_blocks,
               "blocks_in_use": self.alloc.blocks_in_use,
               "window_ring": self.ring}
        if self.ring:
            out["ring_tokens"] = self.ring_mod
            out["ring_full_chain"] = self.ring_full_chain
        return out

    def jit_counts(self) -> Dict[str, int]:
        """The captured write, by the JAX engine's name."""
        return {("write_blocks" if self.paged else "write_slot"):
                self.write.captures}

    def _stage_write(self, values: np.ndarray) -> None:
        self._in.fill()[:] = values
        self._in.push()
        self.write(self.pool, self.scratch)

    def _write(self, pool, scratch) -> None:
        """The scratch-to-pool write on the static buffer: what the graph
        holds."""
        d = self._in.dev
        if self.paged:
            write_chunk_blocks(pool, scratch, d[:-2], d[-2],
                               chunk=self.ecfg.prefill_chunk,
                               block_size=self.ecfg.kv_block_size,
                               seq_axes=self.seq_axes,
                               ring_mods=self.ring_mods, valid_to=d[-1])
        else:
            write_slot(pool, scratch, d, self.batch_axes)
