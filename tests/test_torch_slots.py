"""The port's slot and pool plumbing (``serve/slots.py``, the leaf-by-leaf
``serve/paging.py``) against the JAX package's on the same cache layouts
and the same numpy arrays: per-leaf batch and KV-length axes, the pool's
KV capacity, the paged pool's shapes, ``write_slot`` and
``write_chunk_blocks`` bit for bit, each also with its slot or start in
a device buffer (the captured write's form) and in the host-int form it
replaced.  Reduced moonshot-v1-16b-a3b carries a
leading dense layer (leaf ``[B, S, Hkv, hd]`` beside stacked leaves
``[n, B, S, Hkv, hd]``), reduced switch128 a stack of dense/MoE periods.
The store factory refuses the recurrent families, whose slotted store is
not ported."""
import types

import jax
import numpy as np
import pytest
import torch

from repro.configs.base import ParallelConfig as JPC
from repro.configs.registry import get_config as jax_config
from repro.launch.mesh import make_host_mesh
from repro.models.model import MeshShape
from repro.models.model import build_model as jax_build
from repro.serve import paging as jpaging
from repro.serve import slots as jslots
from repro_torch.configs.registry import get_config
from repro_torch.convert import to_torch
from repro_torch.models.model import build_model
from repro_torch.serve import EngineConfig, paging, slots
from repro_torch.serve.statestore import make_state_store

ARCHS = ["moonshot-v1-16b-a3b", "switch128", "qwen15-moe-a27b"]
S_MAX = 24


@pytest.fixture(scope="module", params=ARCHS)
def pair(request):
    arch = request.param
    mesh = make_host_mesh(1, 1)
    ms = MeshShape(tuple(zip(mesh.axis_names, mesh.devices.shape)))
    jm = jax_build(jax_config(arch).reduced(), JPC(attn_chunk=8),
                   batch=3, seq_len=S_MAX, mesh_shape=ms, mesh=mesh)
    tm = build_model(get_config(arch).reduced(), batch=3, seq_len=S_MAX,
                     device="cpu")
    return arch, jm, tm


def _random_like(tree, seed):
    """The JAX cache tree with every leaf replaced by seeded numpy data."""
    rng = np.random.default_rng(seed)
    return jax.tree.map(lambda x: rng.standard_normal(x.shape).astype(
        np.float32), jax.device_get(tree))


def _port_leaves(tree):
    return [t.numpy() for t in paging.kv_leaves(tree)]


def test_axes_and_capacity_equal_jax(pair):
    arch, jm, tm = pair
    for fn in (jslots.discover_batch_axes, jslots.discover_seq_axes):
        port_fn = getattr(slots, fn.__name__)
        assert port_fn(tm.init_cache, S_MAX) == \
            jax.tree.leaves(fn(jm.init_cache, S_MAX)), fn.__name__
    jseq = jslots.discover_seq_axes(jm.init_cache, S_MAX)
    tseq = slots.discover_seq_axes(tm.init_cache, S_MAX)
    assert slots.min_kv_capacity(tm.init_cache, S_MAX, tseq) == \
        jslots.min_kv_capacity(jm.init_cache, S_MAX, jseq) == S_MAX
    shapes = [tuple(t.shape) for t in
              paging.kv_leaves(tm.init_cache(3, S_MAX, device="meta"))]
    assert shapes == [leaf.shape for leaf in
                      jax.tree.leaves(jm.init_cache(3, S_MAX))]
    if arch == "moonshot-v1-16b-a3b":        # the lead leaf's own layout
        assert slots.discover_batch_axes(tm.init_cache, S_MAX)[-1] == 0
        assert tseq[-1] == 1 and tseq[0] == 2


def test_paged_pool_shapes_equal_jax(pair):
    _, jm, tm = pair
    nb, bs = 13, 4
    jpool = jm.init_paged_cache(nb, bs, S_MAX)
    tpool = tm.init_paged_cache(nb, bs, S_MAX)
    assert [tuple(t.shape) for t in paging.kv_leaves(tpool)] == \
        [leaf.shape for leaf in jax.tree.leaves(jpool)]
    assert all(float(t.abs().sum()) == 0.0 for t in paging.kv_leaves(tpool))


@pytest.mark.parametrize("slot", [0, 2])
def test_write_slot_equals_jax_bit_for_bit(pair, slot):
    _, jm, tm = pair
    pool = _random_like(jm.init_cache(3, S_MAX), 1)
    scratch = _random_like(jm.init_cache(1, S_MAX), 2)
    axes = jslots.discover_batch_axes(jm.init_cache, S_MAX)
    want = jax.device_get(jslots.write_slot(pool, scratch, np.int32(slot),
                                            axes))
    tpool = to_torch(pool, device="cpu")
    out = slots.write_slot(tpool, to_torch(scratch, device="cpu"), slot,
                           slots.discover_batch_axes(tm.init_cache, S_MAX))
    assert out is tpool                            # in place
    got = _port_leaves(tpool)
    exp = [np.asarray(x) for x in jax.tree.leaves(want)]
    assert len(got) == len(exp)
    for g, e in zip(got, exp):
        np.testing.assert_array_equal(g, e)


@pytest.mark.parametrize("start,bt", [
    (0, [5, 2, 7, 0, 0, 0]),           # chunk over the first two blocks
    (8, [5, 2, 7, 11, 0, 0]),          # a later chunk
    (8, [5, 2, 7, 0, 0, 0])])          # its second block still on the null block
def test_write_chunk_blocks_equals_jax_bit_for_bit(pair, start, bt):
    _, jm, tm = pair
    nb, bs, C = 13, 4, 8
    jseq = jslots.discover_seq_axes(jm.init_cache, S_MAX)
    pool = _random_like(jm.init_paged_cache(nb, bs, S_MAX), 3)
    scratch = _random_like(jm.init_cache(1, S_MAX), 4)
    bt_row = np.asarray(bt, np.int32)
    want = jax.device_get(jpaging.write_chunk_blocks(
        pool, scratch, bt_row, np.int32(start), chunk=C, block_size=bs,
        seq_axes=jseq))
    tpool = to_torch(pool, device="cpu")
    paging.write_chunk_blocks(
        tpool, to_torch(scratch, device="cpu"), torch.from_numpy(bt_row),
        start, chunk=C, block_size=bs,
        seq_axes=slots.discover_seq_axes(tm.init_cache, S_MAX))
    for g, e in zip(_port_leaves(tpool), jax.tree.leaves(want)):
        np.testing.assert_array_equal(g, np.asarray(e))


def _write_slot_narrow(pool, scratch, slot, batch_axes):
    """``write_slot``'s host-int form before the captured write."""
    for p, s, ax in zip(paging.kv_leaves(pool), paging.kv_leaves(scratch),
                        batch_axes):
        p.narrow(ax, slot, 1).copy_(s)


def _write_chunk_blocks_sliced(pool, scratch, bt_row, start, *, chunk,
                               block_size, seq_axes):
    """``write_chunk_blocks``' host-int form before the captured write."""
    log = start + torch.arange(chunk)
    phys = bt_row.long()[log // block_size] * block_size + log % block_size
    for p, s, ax in zip(paging.kv_leaves(pool), paging.kv_leaves(scratch),
                        seq_axes):
        p.movedim(ax, 0)[phys] = s.movedim(ax, 0)[start:start + chunk]


@pytest.mark.parametrize("slot", [0, 2])
def test_write_slot_device_slot_equals_host_forms_and_jax(pair, slot):
    """The captured write's form (the slot in a device buffer) against the
    host int, the narrow form it replaced, and JAX's traced slot."""
    _, jm, tm = pair
    pool = _random_like(jm.init_cache(3, S_MAX), 5)
    scratch = _random_like(jm.init_cache(1, S_MAX), 6)
    want = [np.asarray(x) for x in jax.tree.leaves(jax.device_get(
        jslots.write_slot(pool, scratch, np.int32(slot),
                          jslots.discover_batch_axes(jm.init_cache,
                                                     S_MAX))))]
    axes = slots.discover_batch_axes(tm.init_cache, S_MAX)
    tscratch = to_torch(scratch, device="cpu")
    for form in ("narrow", "int", "device"):
        tpool = to_torch(pool, device="cpu")
        if form == "narrow":
            _write_slot_narrow(tpool, tscratch, slot, axes)
        else:
            at = slot if form == "int" else torch.tensor([slot],
                                                         dtype=torch.int32)
            slots.write_slot(tpool, tscratch, at, axes)
        for g, e in zip(_port_leaves(tpool), want):
            np.testing.assert_array_equal(g, e, err_msg=form)


@pytest.mark.parametrize("start,bt", [
    (0, [5, 2, 7, 0, 0, 0]), (8, [5, 2, 7, 11, 0, 0]),
    (16, [5, 2, 7, 11, 3, 9])])        # the last chunk of the chain
def test_write_chunk_blocks_device_start_equals_host_forms_and_jax(
        pair, start, bt):
    """The captured write's form (block-table row and start in one device
    buffer) against the host int, the sliced form it replaced, and JAX's
    traced start."""
    _, jm, tm = pair
    nb, bs, C = 13, 4, 8
    pool = _random_like(jm.init_paged_cache(nb, bs, S_MAX), 7)
    scratch = _random_like(jm.init_cache(1, S_MAX), 8)
    bt_row = np.asarray(bt, np.int32)
    want = [np.asarray(x) for x in jax.tree.leaves(jax.device_get(
        jpaging.write_chunk_blocks(
            pool, scratch, bt_row, np.int32(start), chunk=C, block_size=bs,
            seq_axes=jslots.discover_seq_axes(jm.init_cache, S_MAX))))]
    kw = dict(chunk=C, block_size=bs,
              seq_axes=slots.discover_seq_axes(tm.init_cache, S_MAX))
    tscratch = to_torch(scratch, device="cpu")
    staged = torch.from_numpy(np.append(bt_row, start).astype(np.int32))
    for form in ("sliced", "int", "device"):
        tpool = to_torch(pool, device="cpu")
        if form == "sliced":
            _write_chunk_blocks_sliced(tpool, tscratch,
                                       torch.from_numpy(bt_row), start, **kw)
        elif form == "int":
            paging.write_chunk_blocks(tpool, tscratch,
                                      torch.from_numpy(bt_row), start, **kw)
        else:
            paging.write_chunk_blocks(tpool, tscratch, staged[:-1],
                                      staged[-1], **kw)
        for g, e in zip(_port_leaves(tpool), want):
            np.testing.assert_array_equal(g, e, err_msg=form)


@pytest.mark.parametrize("family", ["ssm", "hybrid"])
def test_state_store_refuses_recurrent_families(family):
    model = types.SimpleNamespace(
        cfg=types.SimpleNamespace(name="m", family=family))
    with pytest.raises(NotImplementedError, match="ROADMAP item 8"):
        make_state_store(model, EngineConfig(), s_pad=32)
