"""The port's prefix-caching block allocator and its two KV movements
against the JAX package's (``repro.serve.paging``).

* The random programs of ``tests/test_paging_properties.py`` (the same
  seeds, the same op mix of alloc / extend / share / commit / CoW /
  release, with eviction under allocation pressure) run on both
  allocators in lockstep: after every op the two hold the same chains,
  refcounts, plain free list, cached LRU order, radix index (by block)
  and ``evictions`` / ``cow_copies``, every return value agrees, and the
  port's allocator keeps the JAX docstring's invariants (conservation,
  refcount consistency, a null block that never moves).
* The three directed cases of that file, on both allocators.
* ``gather_prefix_blocks`` and ``copy_block`` are bit-equal to JAX's on
  the same pool and scratch (reduced qwen's paged cache)."""
import random

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

try:
    from hypothesis import given, settings, strategies as st
except ImportError:                                   # pragma: no cover
    from _hypothesis_shim import given, settings, strategies as st

from repro.configs.base import ParallelConfig as JPC
from repro.configs.qwen15_moe_a27b import CONFIG as JAX_QWEN
from repro.models.model import build_model as jax_build
from repro.serve import paging as JP
from repro.serve.slots import discover_seq_axes as jax_seq_axes
from repro_torch.configs.qwen15_moe_a27b import CONFIG as TORCH_QWEN
from repro_torch.models.model import build_model
from repro_torch.serve import paging as TP
from repro_torch.serve.slots import discover_seq_axes

from test_paging_properties import VOCAB, check_invariants


def state(a):
    """Everything an allocator decides with, in comparable form."""
    return {
        "chains": {r: tuple(c) for r, c in a._chains.items()},
        "ref": list(a._ref),
        "free": list(a._free),
        "cached": list(a._cached),
        "index": sorted((blk, n.key) for blk, n in a._by_block.items()),
        "nodes": len(a._nodes),
        "evictions": a.evictions,
        "cow_copies": a.cow_copies,
        "free_blocks": a.free_blocks,
        "blocks_in_use": a.blocks_in_use,
    }


def lockstep_program(seed: int, *, n_ops: int = 60):
    """``test_paging_properties.run_program``'s op stream for ``seed``
    driven into the JAX allocator and the port's side by side."""
    rng = random.Random(seed)
    num_blocks = rng.randint(4, 20)
    bs = rng.choice([1, 2, 4])
    ja = JP.BlockAllocator(num_blocks, bs, prefix_cache=True)
    ta = TP.BlockAllocator(num_blocks, bs, prefix_cache=True)
    tok_rng = np.random.default_rng(seed)
    live, toks = {}, {}
    next_rid = 0
    ops = []

    def both(name, *args, **kw):
        a = getattr(ja, name)(*args, **kw)
        b = getattr(ta, name)(*args, **kw)
        assert a == b, (name, args, a, b)
        return b

    for _ in range(n_ops):
        op = rng.choice(["alloc", "alloc", "extend", "commit", "commit",
                         "cow", "release"])
        ops.append(op)
        if op == "alloc":
            rid = next_rid
            next_rid += 1
            n_tok = rng.randint(0, (num_blocks + 1) * bs)
            seq = tok_rng.integers(0, VOCAB, (n_tok,)).astype(np.int32)
            shared = both("match_prefix", seq)
            n_fresh = rng.randint(0, 3)
            assert ja.can_allocate(n_fresh, shared) \
                == ta.can_allocate(n_fresh, shared)
            chain = both("alloc_chain", rid, n_fresh, shared=shared)
            if chain is not None:
                live[rid] = list(chain)
                toks[rid] = seq
        elif op == "extend" and live:
            rid = rng.choice(sorted(live))
            blk = both("extend", rid)
            if blk is not None:
                live[rid].append(blk)
                toks[rid] = np.concatenate(
                    [toks[rid],
                     tok_rng.integers(0, VOCAB, (bs,)).astype(np.int32)])
        elif op == "commit" and live:
            rid = rng.choice(sorted(live))
            k = rng.randint(0, len(toks[rid]))
            both("commit_prefix", rid, toks[rid][:k])
        elif op == "cow" and live:
            rid = rng.choice(sorted(live))
            if live[rid]:
                j = rng.randrange(len(live[rid]))
                res = both("cow", rid, j)
                if res is not None:
                    live[rid][j] = res[1]
        elif op == "release" and live:
            rid = rng.choice(sorted(live))
            both("release", rid)
            del live[rid]
            del toks[rid]
        assert state(ta) == state(ja), (seed, len(ops), op)
        check_invariants(ta, live)
    counters = (ta.evictions, ta.cow_copies)
    for rid in sorted(live):
        both("release", rid)
        del live[rid]
        assert state(ta) == state(ja)
        check_invariants(ta, live)
    assert ta.blocks_in_use == 0
    assert ta.free_blocks == ta.usable_blocks
    return ops, counters


@settings(max_examples=40, deadline=None, derandomize=True)
@given(st.integers(0, 2 ** 31 - 1))
def test_allocator_random_interleavings_equal_jax(seed):
    """The property test's own seeds, drawn as it draws them."""
    lockstep_program(seed)


@pytest.mark.parametrize("seed", list(range(12)) + [2 ** 31 - 1, 977, 4242])
def test_allocator_program_equals_jax(seed):
    """Fixed seeds, so that every run checks the same programs; each
    exercises eviction, CoW and sharing somewhere in the set."""
    ops, _ = lockstep_program(seed)
    assert {"alloc", "commit", "cow", "release"} <= set(ops)


def test_programs_exercise_eviction_and_cow():
    """Across the fixed seeds the lockstep programs evict cached prefixes
    and copy blocks, so the comparison above is not vacuous."""
    totals = np.sum([lockstep_program(seed)[1] for seed in range(12)],
                    axis=0)
    assert totals[0] > 0 and totals[1] > 0


# ----------------------------------------------------------------------
# the directed cases, on both allocators
# ----------------------------------------------------------------------
@pytest.mark.parametrize("mod", [JP, TP], ids=["jax", "port"])
def test_allocator_eviction_recycles_cached_prefixes(mod):
    a = mod.BlockAllocator(5, 2, prefix_cache=True)       # 4 usable
    seq = np.array([1, 1, 2, 2, 1, 2], np.int32)
    chain = a.alloc_chain(0, 3)
    a.commit_prefix(0, seq)
    a.release(0)
    assert a.cached_blocks == 3
    assert a.match_prefix(seq) == chain
    a.alloc_chain(1, 1)
    assert a.evictions == 0
    c = a.alloc_chain(2, 2)
    assert a.evictions == 2
    assert set(c) == set(chain[1:])                   # recycled tail blocks
    assert a.match_prefix(seq) == chain[:1]           # root still matches
    a.release(1)
    a.release(2)
    assert a.free_blocks == a.usable_blocks


@pytest.mark.parametrize("mod", [JP, TP], ids=["jax", "port"])
def test_allocator_cow_preserves_shared_chain(mod):
    a = mod.BlockAllocator(6, 2, prefix_cache=True)
    seq = np.array([0, 1, 0, 2], np.int32)
    c0 = a.alloc_chain(0, 2)
    a.commit_prefix(0, seq)
    shared = a.match_prefix(seq)
    assert shared == c0
    a.alloc_chain(1, 0, shared=shared)
    assert a.refcount(c0[0]) == 2
    old, new = a.cow(1, 1)
    assert old == c0[1] and new not in c0
    assert a.chain(0) == tuple(c0)
    assert a.chain(1) == (c0[0], new)
    assert a.refcount(old) == 1 and a.refcount(new) == 1
    assert a.match_prefix(seq) == c0
    assert a.cow_copies == 1


@pytest.mark.parametrize("mod", [JP, TP], ids=["jax", "port"])
def test_allocator_rejects_null_in_shared(mod):
    a = mod.BlockAllocator(4, 2, prefix_cache=True)
    with pytest.raises(ValueError, match="null block"):
        a.alloc_chain(0, 1, shared=[mod.NULL_BLOCK])


def test_directed_cases_leave_equal_states():
    """The directed cases' op sequences leave the two allocators in the
    same state after every op (and the flag off is the plain free list
    of either)."""
    for prefix in (True, False):
        ja = JP.BlockAllocator(7, 2, prefix_cache=prefix)
        ta = TP.BlockAllocator(7, 2, prefix_cache=prefix)
        seq = np.array([1, 1, 2, 2, 1, 2], np.int32)
        script = [("alloc_chain", (0, 3), {}), ("commit_prefix", (0, seq), {}),
                  ("release", (0,), {}), ("match_prefix", (seq,), {}),
                  ("alloc_chain", (1, 1), {}), ("alloc_chain", (2, 3), {}),
                  ("cow", (2, 0), {}), ("extend", (1,), {}),
                  ("release", (2,), {}), ("release", (1,), {})]
        for name, args, kw in script:
            assert getattr(ja, name)(*args, **kw) \
                == getattr(ta, name)(*args, **kw), name
            assert state(ta) == state(ja), name


# ----------------------------------------------------------------------
# the gather and the copy, bit for bit
# ----------------------------------------------------------------------
NB, BS, S_PAD = 9, 4, 24


@pytest.fixture(scope="module")
def pools():
    """Reduced qwen's paged pool and batch-1 scratch in both frameworks,
    filled with the same random values (leaves in ``jax.tree.leaves``
    order)."""
    jc, tc = JAX_QWEN.reduced(), TORCH_QWEN.reduced()
    jm = jax_build(jc, JPC(attn_chunk=8, loss_chunk=8), batch=1,
                   seq_len=S_PAD)
    tm = build_model(tc, batch=1, seq_len=S_PAD, device="cpu")
    j_axes = jax_seq_axes(jm.init_cache, S_PAD)
    t_axes = discover_seq_axes(tm.init_cache, S_PAD)
    rng = np.random.default_rng(0)

    def fill(jtree, ttree):
        jl, tdef = jax.tree.flatten(jtree)
        tl = list(TP.kv_leaves(ttree))
        assert [tuple(x.shape) for x in jl] == [tuple(x.shape) for x in tl]
        vals = [rng.standard_normal(x.shape).astype(np.float32) for x in jl]
        for t, v in zip(tl, vals):
            t.copy_(torch.from_numpy(v))
        return jax.tree.unflatten(tdef, [jnp.asarray(v) for v in vals])
    jpool = fill(jm.init_paged_cache(NB, BS, S_PAD, seq_axes=j_axes),
                 tpool := tm.init_paged_cache(NB, BS, S_PAD,
                                              seq_axes=t_axes))
    jscr = fill(jm.init_cache(1, S_PAD), tscr := tm.init_cache(1, S_PAD))
    return (jpool, jscr, j_axes), (tpool, tscr, t_axes)


def _equal(jtree, ttree):
    for a, b in zip(jax.tree.leaves(jtree), TP.kv_leaves(ttree)):
        np.testing.assert_array_equal(np.asarray(a), b.numpy())


@pytest.mark.parametrize("n_tokens", [0, 5, 12, 20, S_PAD])
def test_gather_prefix_blocks_equals_jax(pools, n_tokens):
    (jpool, jscr, j_axes), (tpool, tscr, t_axes) = pools
    row = np.array([3, 7, 1, 5, 0, 0], np.int32)
    want = JP.gather_prefix_blocks(jpool, jscr, jnp.asarray(row),
                                   jnp.int32(n_tokens), s_pad=S_PAD,
                                   block_size=BS, seq_axes=j_axes)
    scr = _clone(tscr)
    TP.gather_prefix_blocks(tpool, scr, torch.from_numpy(row),
                            torch.tensor(n_tokens, dtype=torch.int32),
                            s_pad=S_PAD, block_size=BS, seq_axes=t_axes)
    _equal(want, scr)
    if n_tokens == 0:
        _equal(jscr, scr)                 # nothing moves


@pytest.mark.parametrize("src,dst", [(3, 6), (6, 3), (0, 0), (8, 1)])
def test_copy_block_equals_jax(pools, src, dst):
    (jpool, _, j_axes), (tpool, _, t_axes) = pools
    want = JP.copy_block(jpool, jnp.int32(src), jnp.int32(dst),
                         block_size=BS, seq_axes=j_axes)
    pool = _clone(tpool)
    TP.copy_block(pool, torch.tensor(src, dtype=torch.int32),
                  torch.tensor(dst, dtype=torch.int32), block_size=BS,
                  seq_axes=t_axes)
    _equal(want, pool)


def _clone(tree):
    return TP.map_kv_leaves(lambda x, i: x.clone(), tree)
