"""KV ownership for the serving engine (port of ``repro/serve/kvstore.py``'s
``KVOwner`` in its paged mode, with no prefix sharing and no handoff).

``KVOwner`` owns where K/V lives: the physical paged pool, the block
allocator and block table, and the batch-1 prefill scratch that chunked
prefill writes before each finished chunk is scattered into the slot's
blocks.  The engine keeps the scheduling state and delegates every pool
or allocator touch here.
"""
from __future__ import annotations

from typing import Any, Dict

import numpy as np
import torch

from repro_torch.configs.base import round_up
from repro_torch.serve.paging import (NULL_BLOCK, BlockAllocator,
                                      blocks_for_tokens, write_chunk_blocks)


class KVOwner:
    def __init__(self, model, ecfg, *, s_pad: int):
        self.ecfg = ecfg
        self.device = model.device
        B, bs = ecfg.max_slots, ecfg.kv_block_size
        self.s_pad = s_pad
        self.blocks_per_slot = blocks_for_tokens(s_pad, bs)
        usable = ecfg.num_kv_blocks or B * self.blocks_per_slot
        if usable < self.blocks_per_slot:
            raise ValueError(
                f"num_kv_blocks={usable} cannot hold even one worst-case "
                f"request ({self.blocks_per_slot} blocks)")
        self.alloc = BlockAllocator(usable + 1, bs)       # +1: null block
        self.block_table = np.full((B, self.blocks_per_slot), NULL_BLOCK,
                                   np.int32)
        self.kv_capacity = s_pad
        self.pool = model.init_paged_cache(self.alloc.num_blocks, bs)
        self.scratch = model.init_cache(1, s_pad)

    def write(self, bt_row: np.ndarray, start: int, valid_to: int) -> None:
        """Scatter the scratch chunk at ``start`` into ``bt_row``'s blocks."""
        write_chunk_blocks(
            self.pool, self.scratch,
            torch.as_tensor(bt_row, device=self.device), start,
            chunk=self.ecfg.prefill_chunk,
            block_size=self.ecfg.kv_block_size, valid_to=valid_to)

    def release(self, rid: int, slot: int) -> None:
        """Free ``rid``'s blocks and park its table row on the null block."""
        self.alloc.release(rid)
        self.block_table[slot, :] = NULL_BLOCK

    def plan(self, tokens) -> int:
        """Fresh blocks a (re)prefill over ``tokens`` needs at admission:
        the chunk-padded prefill writes land in real blocks."""
        return blocks_for_tokens(round_up(len(tokens),
                                          self.ecfg.prefill_chunk),
                                 self.ecfg.kv_block_size)

    def can_admit(self, n_fresh: int) -> bool:
        return self.alloc.can_allocate(n_fresh)

    def bt_row(self, rid: int) -> np.ndarray:
        """A request's block-table row, built from its live chain (the
        engine-visible row may still be parked on the null block)."""
        row = np.full((self.blocks_per_slot,), NULL_BLOCK, np.int32)
        chain = self.alloc.chain(rid)
        row[:len(chain)] = chain
        return row

    def stats(self) -> Dict[str, Any]:
        return {"kind": "paged",
                "kv_block_size": self.ecfg.kv_block_size,
                "blocks_per_slot": self.blocks_per_slot,
                "usable_blocks": self.alloc.usable_blocks,
                "blocks_in_use": self.alloc.blocks_in_use}
