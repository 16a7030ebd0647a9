"""Paged KV pool: block allocator + block-table plumbing for the engine.

Port of ``repro/serve/paging.py`` without the prefix index (no sharing,
no copy-on-write).  Physical KV memory is a pool of fixed-size blocks;
every request owns a chain of blocks that grows with its sequence, and a
static ``[max_slots, max_blocks_per_slot]`` block table maps each slot's
logical blocks to physical ones.  Physical block 0 is the *null block*:
unallocated table entries point at it, so reads and writes through a
partly filled table stay in bounds — reads are masked by each row's
length, writes land in garbage nothing reads.
"""
from __future__ import annotations

from collections import deque
from typing import Any, Callable, Dict, Iterator, List, Optional, Tuple

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
    """Every K/V tensor of a cache tree, in a fixed order."""
    if isinstance(cache, dict):
        for k in sorted(cache):
            yield from kv_leaves(cache[k])
    elif isinstance(cache, AttnCache):
        yield cache.k
        yield cache.v
    else:
        raise TypeError(f"unexpected cache leaf {type(cache)}")


def make_paged_pool(init_cache: Callable[[int, int], Any], num_blocks: int,
                    block_size: int) -> Any:
    """Physical paged pool: the batch-1 cache with a KV axis of
    ``num_blocks * block_size`` positions."""
    return init_cache(1, num_blocks * block_size)


def write_chunk_blocks(pool: Any, scratch: Any, bt_row: torch.Tensor,
                       start: int, *, chunk: int, block_size: int,
                       valid_to: Optional[int] = None) -> Any:
    """Scatter scratch positions ``[start, start + chunk)`` into the paged
    pool through one slot's block-table row (in place).  Cache leaves are
    ``[n_steps, batch, positions, Hkv, hd]``.  Positions at or past
    ``valid_to`` (the padding of a partial final chunk) are written into
    the null block, whose contents nothing reads."""
    dev = bt_row.device
    log = start + torch.arange(chunk, device=dev)
    phys = bt_row.long()[log // block_size] * block_size + log % block_size
    if valid_to is not None:
        phys = torch.where(log < valid_to, phys,
                           NULL_BLOCK * block_size + log % block_size)
    for p, s in zip(kv_leaves(pool), kv_leaves(scratch)):
        p[:, 0, phys] = s[:, 0, start:start + chunk].to(p.dtype)
    return pool
