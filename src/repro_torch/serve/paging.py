"""Paged KV pool: block allocator + block-table plumbing for the engine.

Port of ``repro/serve/paging.py`` without the prefix index (no sharing,
no copy-on-write).  Physical KV memory is a pool of fixed-size blocks;
every request owns a chain of blocks that grows with its sequence, and a
static ``[max_slots, max_blocks_per_slot]`` block table maps each slot's
logical blocks to physical ones.  Physical block 0 is the *null block*:
unallocated table entries point at it, so reads and writes through a
partly filled table stay in bounds — reads are masked by each row's
length, writes land in garbage nothing reads.

Layout discovery is shared with the slab pool (``serve/slots.py``): cache
leaves differ in where their KV-length axis sits (stacked layers
``[n_steps, batch, positions, Hkv, hd]``, leading dense layers ``[batch,
positions, Hkv, hd]``), so the pool and the chunk scatter work leaf by
leaf over the discovered axes.  Sliding-window leaves are paged as rings
(``write_chunk_blocks``' ``ring_mods``; the engine's store, ``kvstore``).
"""
from __future__ import annotations

import itertools
from collections import deque
from typing import (Any, Callable, Dict, Iterator, List, Optional,
                    Sequence, Tuple)

import torch

from repro_torch.models.attention import AttnCache

NULL_BLOCK = 0      # physical block id unallocated table entries point at


def blocks_for_tokens(n_tokens: int, block_size: int) -> int:
    """Blocks needed to hold ``n_tokens`` KV positions."""
    return -(-n_tokens // block_size)


class BlockAllocator:
    """Free-list allocator over ``num_blocks`` physical KV blocks.  Block 0
    is the null block and never handed out; each request (keyed by rid)
    owns an ordered chain — logical block j lives in ``chain[j]``.
    Invariant: ``free_blocks + blocks_in_use == usable_blocks``."""

    def __init__(self, num_blocks: int, block_size: int):
        if num_blocks < 2:
            raise ValueError("need at least one usable block past the "
                             "reserved null block")
        self.num_blocks = num_blocks
        self.block_size = block_size
        self._free: deque = deque(range(1, num_blocks))
        self._chains: Dict[int, List[int]] = {}

    @property
    def usable_blocks(self) -> int:
        return self.num_blocks - 1

    @property
    def free_blocks(self) -> int:
        return len(self._free)

    @property
    def blocks_in_use(self) -> int:
        return self.usable_blocks - self.free_blocks

    def chain(self, rid: int) -> Tuple[int, ...]:
        return tuple(self._chains.get(rid, ()))

    def can_allocate(self, n_blocks: int) -> bool:
        return n_blocks <= self.free_blocks

    def alloc_chain(self, rid: int, n_blocks: int) -> Optional[List[int]]:
        """Install a chain of ``n_blocks`` fresh blocks for ``rid``; None
        (and no allocation) if the free list cannot cover it."""
        if rid in self._chains:
            raise ValueError(f"rid {rid} already holds a chain")
        if not self.can_allocate(n_blocks):
            return None
        chain = [self._free.popleft() for _ in range(n_blocks)]
        self._chains[rid] = chain
        return list(chain)

    def extend(self, rid: int) -> Optional[int]:
        """Append one block to ``rid``'s chain; None if the pool is dry."""
        if not self._free:
            return None
        blk = self._free.popleft()
        self._chains.setdefault(rid, []).append(blk)
        return blk

    def release(self, rid: int) -> int:
        """Drop ``rid``'s chain, returning its blocks to the free list."""
        chain = self._chains.pop(rid, [])
        self._free.extend(chain)
        return len(chain)


def kv_leaves(cache: Any) -> Iterator[torch.Tensor]:
    """Every K/V tensor of a cache tree, in ``jax.tree.leaves`` order:
    dict keys sorted, lists in order, an ``AttnCache``'s k before v."""
    if isinstance(cache, dict):
        for k in sorted(cache):
            yield from kv_leaves(cache[k])
    elif isinstance(cache, list):
        for c in cache:
            yield from kv_leaves(c)
    elif isinstance(cache, AttnCache):
        yield cache.k
        yield cache.v
    else:
        raise TypeError(f"unexpected cache leaf {type(cache)}")


def map_kv_leaves(fn: Callable[[torch.Tensor, int], torch.Tensor],
                  cache: Any) -> Any:
    """The cache tree with each K/V tensor replaced by ``fn(leaf, i)``,
    ``i`` its index in ``kv_leaves`` order."""
    count = itertools.count()

    def walk(t):
        if isinstance(t, dict):
            return {k: walk(t[k]) for k in sorted(t)}
        if isinstance(t, list):
            return [walk(c) for c in t]
        if isinstance(t, AttnCache):
            k = fn(t.k, next(count))
            return AttnCache(k, fn(t.v, next(count)))
        raise TypeError(f"unexpected cache leaf {type(t)}")
    return walk(cache)


def assert_pageable(init_cache: Callable[..., Any], s_ref: int,
                    seq_axes: Sequence[int]) -> None:
    """Every cache leaf must expose a full-length KV axis at ``s_ref``:
    a leaf clamped below it cannot be addressed through a block table,
    and is refused with its shape."""
    leaves = kv_leaves(init_cache(1, s_ref, device="meta"))
    for leaf, ax in zip(leaves, seq_axes):
        if leaf.shape[ax] != s_ref:
            raise NotImplementedError(
                f"cache leaf {tuple(leaf.shape)} is not pageable: its "
                f"KV-length axis is clamped below s_max={s_ref}; page "
                f"window-clamped leaves via the unclamped cache + "
                f"ring_mods")


def make_paged_pool(init_cache: Callable[..., Any], s_ref: int,
                    seq_axes: Sequence[int], num_blocks: int,
                    block_size: int, *, device) -> Any:
    """Physical paged pool on ``device``: each cache leaf of
    ``init_cache(1, s_ref)`` with its KV-length axis resized to
    ``num_blocks * block_size`` positions, built structurally from the
    leaves' shapes (probed on the ``meta`` device), so that a window clamp
    inside ``init_cache`` can never silently truncate the pool."""
    assert_pageable(init_cache, s_ref, seq_axes)
    P = num_blocks * block_size

    def build(leaf, i):
        shape = list(leaf.shape)
        shape[seq_axes[i]] = P
        return torch.zeros(shape, dtype=leaf.dtype, device=device)
    return map_kv_leaves(build, init_cache(1, s_ref, device="meta"))


def write_chunk_blocks(pool: Any, scratch: Any, bt_row: torch.Tensor,
                       start, *, chunk: int, block_size: int,
                       seq_axes: Sequence[int],
                       ring_mods: Optional[Sequence[int]] = None,
                       valid_to=None) -> Any:
    """Scatter scratch positions ``[start, start + chunk)`` into the paged
    pool through one slot's block-table row (in place), each leaf along
    its own KV-length axis ``seq_axes[i]``.  ``start`` is an int or a 0-d
    device tensor (which a captured write reads).  The chain behind
    ``bt_row`` covers the chunk-rounded sequence, so the padding of a
    partial final chunk lands in the slot's own blocks, as garbage past
    its length that decode overwrites before it is read; entries still on
    the null block write into discarded space.

    ``ring_mods`` (one int a leaf, constants of a captured write) gives a
    sliding-window leaf its ring modulus M = round_up(window, block_size)
    (0 for a full-length leaf): logical position p lands at ring slot
    p % M of the chain.  ``valid_to`` (an int or a 0-d device tensor) is
    the end of the chunk's real tokens: on a ring leaf a pad position past
    it would wrap onto a slot still inside the window, so its write goes
    to the null block instead."""
    dev = bt_row.device
    log = (torch.as_tensor(start, device=dev).reshape(()).long()
           + torch.arange(chunk, device=dev))
    bt = bt_row.long()
    for i, (p, s, ax) in enumerate(zip(kv_leaves(pool), kv_leaves(scratch),
                                       seq_axes)):
        mod = ring_mods[i] if ring_mods is not None else 0
        lg = log % mod if mod else log
        phys = bt[lg // block_size] * block_size + lg % block_size
        if mod and valid_to is not None:
            pad = log >= torch.as_tensor(valid_to, device=dev).reshape(())
            phys = torch.where(pad, NULL_BLOCK * block_size
                               + lg % block_size, phys)
        src = s.index_select(ax, log).movedim(ax, 0)
        p.movedim(ax, 0)[phys] = src.to(p.dtype)
    return pool
