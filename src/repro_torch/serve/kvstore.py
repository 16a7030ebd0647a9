"""KV ownership for the serving engine (port of ``repro/serve/kvstore.py``'s
``KVOwner``, slab and paged, with prefix sharing and without the handoff
of split roles): the token-indexed implementation of
``statestore.SequenceStateStore``.

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

With ``prefix_sharing`` the allocator keeps its radix prefix index and
copy-on-write refcounts (``paging.BlockAllocator(prefix_cache=True)``),
admission plans map each request's longest cached prefix into its chain
(``plan``), and two more entries are captured the same way: the prefix
gather into the scratch (``gather_prefix``: the chain row and the prefix
length in its static buffer) and the block copy of copy-on-write
(``copy_block``: source and destination), so one graph each serves every
prefix length and every block.

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

from typing import Any, Dict, List, Optional, Tuple

import numpy as np

from repro_torch.configs.base import round_up
from repro_torch.serve.paging import (NULL_BLOCK, BlockAllocator,
                                      blocks_for_tokens, copy_block,
                                      gather_prefix_blocks,
                                      write_chunk_blocks)
from repro_torch.serve.slots import (leaf_shapes, discover_batch_axes,
                                     discover_seq_axes, min_kv_capacity,
                                     write_slot)
from repro_torch.serve.stepcore import Entry, Staged


class KVOwner:
    def __init__(self, model, ecfg, *, s_pad: int):
        self.ecfg = ecfg
        self.paged = ecfg.paged
        self.sharing = ecfg.prefix_sharing
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
            self.alloc = BlockAllocator(usable + 1, bs,   # +1: null block
                                        prefix_cache=self.sharing)
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
        if self.sharing:
            # the gather: chain row | prefix length; the copy: src | dst
            self._gather_in = Staged(self.blocks_per_slot + 1, self.device)
            self._copy_in = Staged(2, self.device)
            self.gather_entry = Entry(
                lambda pool, scratch: self._gather(pool, scratch),
                self.device)
            self.copy_entry = Entry(lambda pool: self._copy(pool),
                                    self.device)

    # ------------------------------------------------------------------
    # SequenceStateStore protocol (serve/statestore.py)
    # ------------------------------------------------------------------
    def plan(self, tokens, resumed: bool
             ) -> Tuple[int, List[int], int, bool]:
        """Admission plan for a (re)prefill over ``tokens`` (the JAX
        store's ``share_plan``): ``(start, shared_blocks, n_fresh,
        cow_last)``.  ``shared_blocks`` is the longest indexed prefix at
        block granularity (empty without prefix sharing), and ``start`` the
        offset prefill resumes from, normally the end of that prefix.  On a
        full-sequence hit a fresh request still needs the last position's
        logits, so it restarts at ``len - 1``, whose write lands in the
        last shared block, which must be copied first (``cow_last``); a
        resumed request needs no logits, so a full hit skips its prefill.
        ``n_fresh`` counts the fresh blocks covering the chunk-padded
        prefill writes.  The slab needs no blocks: a free slot is its only
        resource."""
        if not self.paged:
            return 0, [], 0, False
        C, bs = self.ecfg.prefill_chunk, self.ecfg.kv_block_size
        L = len(tokens)
        if self.ring_full_chain:
            # every leaf wraps the same fixed ring: the chain is whole or
            # nothing, whatever the prompt's length (sharing is refused for
            # windowed models: a ring slot's contents depend on the
            # sequence's absolute length)
            return 0, [], self.blocks_per_slot, False
        shared = self.alloc.match_prefix(tokens) if self.sharing else []
        P = len(shared) * bs
        cow_last = False
        if P >= L:                         # full hit (only when L % bs == 0)
            start = L if resumed else L - 1
            cow_last = not resumed
        else:
            start = P
        cover = start + (round_up(L - start, C) if L > start else 0)
        n_fresh = max(blocks_for_tokens(cover, bs), len(shared)) \
            - len(shared)
        return start, shared, n_fresh, cow_last

    def can_admit(self, plan) -> bool:
        start, shared, n_fresh, cow_last = plan
        return not self.paged or self.alloc.can_allocate(
            n_fresh + int(cow_last), shared)

    def place(self, rid: int, plan) -> None:
        """Reserve admitted request ``rid``'s storage: its chain, the
        plan's shared prefix blocks followed by its fresh ones (paged; the
        slab row is the slot itself)."""
        if self.paged:
            _, shared, n_fresh, _ = plan
            chain = self.alloc.alloc_chain(rid, n_fresh, shared=shared)
            assert chain is not None          # gated by can_admit

    def probe_prefix(self, tokens) -> int:
        """Longest cached-prefix match in ``tokens``, in tokens (0 without
        prefix sharing): a pure lookup that leaves the LRU order as it
        is."""
        if not self.sharing:
            return 0
        return len(self.alloc.match_prefix(tokens, touch=False)) \
            * self.ecfg.kv_block_size

    def gather(self, rid: int, n_tokens: int) -> None:
        """Load ``rid``'s first ``n_tokens`` cached positions from its
        chain into the scratch (one captured gather)."""
        h = self._gather_in.fill()
        h[:-1] = self.bt_row(rid)
        h[-1] = n_tokens
        self._gather_in.push()
        self.gather_entry(self.pool, self.scratch)

    def copy(self, src: int, dst: int) -> None:
        """Copy block ``src`` onto block ``dst`` (one captured copy): the
        device half of ``BlockAllocator.cow``."""
        self._copy_in.fill()[:] = (src, dst)
        self._copy_in.push()
        self.copy_entry(self.pool)

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
        captures it, and with prefix sharing the gather (through an
        all-null row, masked to 0 tokens) and the copy (the null block
        onto itself); return the block table a warm-up decode step should
        read (all null; None on the slab)."""
        if not self.paged:
            self.on_prefill_done(0)
            return None
        null_row = np.full((self.blocks_per_slot,), NULL_BLOCK, np.int32)
        self._stage_write(np.append(null_row, [0, 0]))
        if self.sharing:
            self._gather_in.fill()[:] = np.append(null_row, [0])
            self._gather_in.push()
            self.gather_entry(self.pool, self.scratch)
            self.copy(NULL_BLOCK, NULL_BLOCK)
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
        """The captured write (and with prefix sharing the gather and the
        copy), by the JAX engine's names."""
        counts = {("write_blocks" if self.paged else "write_slot"):
                  self.write.captures}
        if self.sharing:
            counts["gather_prefix"] = self.gather_entry.captures
            counts["copy_block"] = self.copy_entry.captures
        return counts

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

    def _gather(self, pool, scratch) -> None:
        """The prefix gather on its static buffer: what the graph holds."""
        d = self._gather_in.dev
        gather_prefix_blocks(pool, scratch, d[:-1], d[-1], s_pad=self.s_pad,
                             block_size=self.ecfg.kv_block_size,
                             seq_axes=self.seq_axes)

    def _copy(self, pool) -> None:
        """The block copy on its static buffer: what the graph holds."""
        d = self._copy_in.dev
        copy_block(pool, d[0], d[1], block_size=self.ecfg.kv_block_size,
                   seq_axes=self.seq_axes)
