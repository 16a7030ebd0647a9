"""Paged KV pool: block allocator + block-table plumbing for the engine
(port of ``repro/serve/paging.py``).

Physical KV memory is a pool of fixed-size blocks; every request owns a
chain of blocks that grows with its sequence, and a static ``[max_slots,
max_blocks_per_slot]`` block table maps each slot's logical blocks to
physical ones.  Physical block 0 is the *null block*: unallocated table
entries point at it, so reads and writes through a partly filled table
stay in bounds — reads are masked by each row's length, writes land in
garbage nothing reads.

Prefix sharing (``prefix_cache=True``) turns the allocator copy-on-write:
every block carries a refcount (the chains it appears in), full blocks are
indexed in a radix tree keyed on their token-id chain, and a new chain
adopts the longest indexed prefix of its tokens with refcount bumps
instead of prefilling it again.  Indexed blocks whose refcount drops to 0
are retained on an LRU cached-free list, reusable by a later match and
evicted only when a fresh allocation finds the plain free list dry.  A
shared block is immutable; ``cow`` swaps a private copy into one chain
(``copy_block`` is the device half), and ``gather_prefix_blocks`` loads a
cached prefix into the prefill scratch so prefill resumes mid-prompt.

Layout discovery is shared with the slab pool (``serve/slots.py``): cache
leaves differ in where their KV-length axis sits (stacked layers
``[n_steps, batch, positions, Hkv, hd]``, leading dense layers ``[batch,
positions, Hkv, hd]``), so the pool, the chunk scatter, the prefix gather
and the block copy work leaf by leaf over the discovered axes.
Sliding-window leaves are paged as rings (``write_chunk_blocks``'
``ring_mods``; the engine's store, ``kvstore``).
"""
from __future__ import annotations

import itertools
from collections import OrderedDict, deque
from typing import (Any, Callable, Dict, Iterator, List, Optional,
                    Sequence, Tuple)

import torch

from repro_torch.models.attention import AttnCache

NULL_BLOCK = 0      # physical block id unallocated table entries point at


def blocks_for_tokens(n_tokens: int, block_size: int) -> int:
    """Blocks needed to hold ``n_tokens`` KV positions."""
    return -(-n_tokens // block_size)


class _PrefixNode:
    """One radix-index node: a full block keyed by (parent node, the
    ``block_size`` token ids it holds).  The chain of keys from the root is
    exactly the token prefix whose K/V the block stores."""
    __slots__ = ("nid", "key", "block", "children")

    def __init__(self, nid: int, key: Tuple[int, Tuple[int, ...]],
                 block: int):
        self.nid = nid
        self.key = key          # (parent_nid, token tuple)
        self.block = block
        self.children: set = set()


_ROOT = 0               # nid of the (implicit) radix root


class BlockAllocator:
    """Free-list allocator over ``num_blocks`` physical KV blocks.

    Block ids are dense ints; id 0 is reserved as the null block and never
    handed out.  Each request (keyed by rid) owns an ordered chain of
    blocks — logical block ``j`` of the request lives in physical block
    ``chain[j]``.

    With ``prefix_cache=True`` the allocator additionally keeps per-block
    refcounts, a radix prefix index over committed full blocks, and an LRU
    cached-free list of refcount-0 indexed blocks (see the module
    docstring).  Invariants (fuzzed against the JAX allocator by
    ``tests/test_torch_paging_prefix.py``):

    * conservation — ``free_blocks + blocks_in_use == usable_blocks``;
      every usable block is in exactly one of {free list, cached LRU,
      some chain(s)};
    * refcount consistency — a block appears in ``k`` chains iff its
      refcount is ``k`` (a block appears at most once per chain);
    * null immutability — ``NULL_BLOCK`` is never handed out, never in a
      chain, never indexed, never freed or evicted.
    """

    def __init__(self, num_blocks: int, block_size: int, *,
                 prefix_cache: bool = False):
        if num_blocks < 2:
            raise ValueError("need at least one usable block past the "
                             "reserved null block")
        self.num_blocks = num_blocks
        self.block_size = block_size
        self.prefix_cache = bool(prefix_cache)
        self._free: deque = deque(range(1, num_blocks))
        self._chains: Dict[int, List[int]] = {}
        self._ref: List[int] = [0] * num_blocks
        # refcount-0 blocks still holding indexed prefixes, LRU order
        # (oldest first = next eviction victim)
        self._cached: "OrderedDict[int, None]" = OrderedDict()
        # radix prefix index
        self._nodes: Dict[Tuple[int, Tuple[int, ...]], _PrefixNode] = {}
        self._by_nid: Dict[int, _PrefixNode] = {}
        self._by_block: Dict[int, _PrefixNode] = {}
        self._next_nid = _ROOT + 1
        # lifetime counters (the engine reports per-window deltas)
        self.evictions = 0
        self.cow_copies = 0

    @property
    def usable_blocks(self) -> int:
        return self.num_blocks - 1

    @property
    def free_blocks(self) -> int:
        """Immediately allocatable blocks: the plain free list plus the
        cached LRU (evictable on demand)."""
        return len(self._free) + len(self._cached)

    @property
    def blocks_in_use(self) -> int:
        return self.usable_blocks - self.free_blocks

    @property
    def cached_blocks(self) -> int:
        return len(self._cached)

    def chain(self, rid: int) -> Tuple[int, ...]:
        return tuple(self._chains.get(rid, ()))

    def refcount(self, blk: int) -> int:
        return self._ref[blk]

    # ------------------------------------------------------------------
    # free-list / LRU internals
    # ------------------------------------------------------------------
    def _take_free(self) -> Optional[int]:
        """One allocatable block: plain free list first, then evict the
        LRU cached prefix block (dropping its index subtree)."""
        if self._free:
            return self._free.popleft()
        if self._cached:
            blk, _ = self._cached.popitem(last=False)
            node = self._by_block.get(blk)
            if node is not None:
                # blocks orphaned by an earlier subtree drop have no node
                # left and don't count as a prefix evicted again
                self._drop_subtree(node)
                self.evictions += 1
            return blk
        return None

    def _drop_subtree(self, node: _PrefixNode) -> None:
        """Remove ``node`` and every descendant from the index.  Descendant
        *blocks* are untouched (they may sit in chains or the cached LRU);
        only their index entries go — with their ancestor evicted they
        could never be reached by a prefix walk again."""
        parent = self._by_nid.get(node.key[0])
        if parent is not None:
            parent.children.discard(node.nid)
        stack = [node]
        while stack:
            n = stack.pop()
            stack.extend(self._by_nid[c] for c in n.children
                         if c in self._by_nid)
            del self._nodes[n.key]
            del self._by_nid[n.nid]
            if self._by_block.get(n.block) is n:
                del self._by_block[n.block]

    def _retire(self, blk: int) -> None:
        """A block's refcount just hit 0: retain it on the cached LRU if it
        still backs an index node, else return it to the free list."""
        if self.prefix_cache and blk in self._by_block:
            self._cached[blk] = None          # MRU end
        else:
            self._free.append(blk)

    # ------------------------------------------------------------------
    # chain lifecycle
    # ------------------------------------------------------------------
    def can_allocate(self, n_fresh: int, shared: Sequence[int] = ()) -> bool:
        """Would ``alloc_chain(rid, n_fresh, shared=shared)`` (plus
        ``n_fresh - len-of-tail`` CoW copies the caller folds in) succeed?
        Shared blocks currently parked on the cached LRU leave the free
        pool when mapped, so they reduce what's left for fresh blocks."""
        avail = self.free_blocks - sum(1 for b in shared if self._ref[b] == 0)
        return n_fresh <= avail

    def alloc_chain(self, rid: int, n_blocks: int,
                    shared: Sequence[int] = ()) -> Optional[List[int]]:
        """Install a chain for ``rid``: the ``shared`` prefix blocks (each
        refcount-bumped, revived from the cached LRU if parked there)
        followed by ``n_blocks`` fresh ones.  None (and no allocation) if
        the free pool cannot cover the fresh tail."""
        if rid in self._chains:
            raise ValueError(f"rid {rid} already holds a chain")
        if not self.can_allocate(n_blocks, shared):
            return None
        chain: List[int] = []
        for blk in shared:
            if blk == NULL_BLOCK:
                raise ValueError("cannot map the null block into a chain")
            if self._ref[blk] == 0:
                del self._cached[blk]         # revived from the LRU
            self._ref[blk] += 1
            chain.append(blk)
        for _ in range(n_blocks):
            blk = self._take_free()
            assert blk is not None            # guarded by can_allocate
            self._ref[blk] = 1
            chain.append(blk)
        self._chains[rid] = chain
        return list(chain)

    def extend(self, rid: int) -> Optional[int]:
        """Append one block to ``rid``'s chain; None if the pool is dry."""
        blk = self._take_free()
        if blk is None:
            return None
        self._ref[blk] = 1
        self._chains.setdefault(rid, []).append(blk)
        return blk

    def release(self, rid: int) -> int:
        """Drop ``rid``'s chain: every block's refcount is decremented and
        refcount-0 blocks return to the free pool — indexed ones onto the
        cached LRU (tail blocks first, so deep prefix blocks are evicted
        before the roots they hang off).  Returns #blocks whose refcount
        hit 0 (shared blocks still held by other chains stay in use)."""
        chain = self._chains.pop(rid, [])
        freed = 0
        for blk in reversed(chain):
            self._ref[blk] -= 1
            if self._ref[blk] == 0:
                self._retire(blk)
                freed += 1
        return freed

    # ------------------------------------------------------------------
    # prefix index
    # ------------------------------------------------------------------
    def _block_key(self, parent: int, tokens, j: int) -> Tuple[int, tuple]:
        bs = self.block_size
        return (parent, tuple(int(t) for t in tokens[j * bs:(j + 1) * bs]))

    def match_prefix(self, tokens, touch: bool = True) -> List[int]:
        """Physical blocks of the longest indexed prefix of ``tokens``, at
        block granularity.  Pure lookup — no refcounts change (map the
        result via ``alloc_chain(shared=...)``); matched cached blocks are
        touched to the LRU's MRU end.  ``touch=False`` skips the LRU
        touch: a fleet router probing every replica's index for prefix
        affinity must not perturb the eviction order of replicas it does
        not pick."""
        if not self.prefix_cache:
            return []
        out: List[int] = []
        parent = _ROOT
        for j in range(len(tokens) // self.block_size):
            node = self._nodes.get(self._block_key(parent, tokens, j))
            if node is None:
                break
            out.append(node.block)
            parent = node.nid
        # LRU touch tail-to-root so a prefix root always outlives its
        # descendants (evicting a root drops the whole subtree's entries)
        if touch:
            for blk in reversed(out):
                if blk in self._cached:
                    self._cached.move_to_end(blk)
        return out

    def commit_prefix(self, rid: int, tokens) -> int:
        """Index ``rid``'s chain blocks that hold full committed blocks of
        ``tokens`` (K/V for ``tokens[:k * block_size]`` must already be
        written).  Idempotent; first writer wins — a block whose key is
        already indexed (content-equal K/V elsewhere) is left unindexed and
        simply returns to the free list when its chain dies.  Returns the
        number of newly indexed blocks."""
        if not self.prefix_cache:
            return 0
        chain = self._chains.get(rid, [])
        parent = _ROOT
        new = 0
        for j in range(min(len(tokens) // self.block_size, len(chain))):
            key = self._block_key(parent, tokens, j)
            node = self._nodes.get(key)
            if node is None:
                blk = chain[j]
                if blk in self._by_block:
                    # already indexed under a different prefix — one block
                    # backs at most one node; stop the walk here
                    break
                node = _PrefixNode(self._next_nid, key, blk)
                self._next_nid += 1
                self._nodes[key] = node
                self._by_nid[node.nid] = node
                self._by_block[blk] = node
                p = self._by_nid.get(key[0])
                if p is not None:
                    p.children.add(node.nid)
                new += 1
            parent = node.nid
        return new

    # ------------------------------------------------------------------
    # copy-on-write
    # ------------------------------------------------------------------
    def cow(self, rid: int, j: int) -> Optional[Tuple[int, int]]:
        """Swap a private copy in for logical block ``j`` of ``rid``'s
        chain: a fresh block replaces it in the chain (refcount 1) and the
        original's refcount drops.  Returns ``(old, new)`` so the caller
        can perform the device copy, or None if the pool is dry (nothing
        changed).  Valid on shared *and* private blocks — CoW of a private
        indexed block detaches it from the index's content."""
        chain = self._chains.get(rid)
        if chain is None or not 0 <= j < len(chain):
            raise ValueError(f"rid {rid} has no logical block {j}")
        new = self._take_free()
        if new is None:
            return None
        old = chain[j]
        self._ref[new] = 1
        chain[j] = new
        self._ref[old] -= 1
        if self._ref[old] == 0:
            self._retire(old)
        self.cow_copies += 1
        return old, new


def kv_leaves(cache: Any) -> Iterator[torch.Tensor]:
    """Every state tensor of a cache tree, in ``jax.tree.leaves`` order:
    dict keys sorted, lists in order, a named tuple's fields in order (an
    ``AttnCache``'s k before v; a ``MambaState``'s ssm, conv_x, conv_B,
    conv_C)."""
    if isinstance(cache, dict):
        for k in sorted(cache):
            yield from kv_leaves(cache[k])
    elif isinstance(cache, list):
        for c in cache:
            yield from kv_leaves(c)
    elif isinstance(cache, tuple) and hasattr(cache, "_fields"):
        yield from cache
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


def gather_prefix_blocks(pool: Any, scratch: Any, bt_row: torch.Tensor,
                         n_tokens, *, s_pad: int, block_size: int,
                         seq_axes: Sequence[int]) -> Any:
    """Load a cached prefix into the prefill scratch (in place): logical
    positions ``[0, n_tokens)`` of the chain behind ``bt_row`` are
    gathered from the paged pool; positions past ``n_tokens`` keep their
    scratch values.  The inverse of ``write_chunk_blocks``, used when
    prefix sharing lets prefill resume mid-prompt.  ``n_tokens`` is an
    int or a 0-d device tensor (which a captured gather reads); table
    entries past the chain point at the null block, and the
    ``log < n_tokens`` mask keeps that garbage out of the scratch."""
    dev = bt_row.device
    log = torch.arange(s_pad, device=dev)
    phys = bt_row.long()[log // block_size] * block_size + log % block_size
    keep = log < torch.as_tensor(n_tokens, device=dev).reshape(())
    for s, p, ax in zip(kv_leaves(scratch), kv_leaves(pool), seq_axes):
        sm = s.movedim(ax, 0)
        g = p.movedim(ax, 0)[phys].to(s.dtype)
        sm.copy_(torch.where(keep.view((s_pad,) + (1,) * (sm.ndim - 1)),
                             g, sm))
    return scratch


def copy_block(pool: Any, src, dst, *, block_size: int,
               seq_axes: Sequence[int]) -> Any:
    """Copy physical block ``src``'s KV positions onto block ``dst`` in
    every pool leaf (in place): the device half of copy-on-write, whose
    bookkeeping half is ``BlockAllocator.cow``.  ``src`` and ``dst`` are
    ints or 0-d device tensors, so one captured copy serves every
    block."""
    ar = None
    for p, ax in zip(kv_leaves(pool), seq_axes):
        if ar is None:
            ar = torch.arange(block_size, device=p.device)
            at_src = torch.as_tensor(src, device=p.device).long() \
                * block_size + ar
            at_dst = torch.as_tensor(dst, device=p.device).long() \
                * block_size + ar
        p.index_copy_(ax, at_dst, p.index_select(ax, at_src))
    return pool
