"""The port's cache and batch sharding rules against the JAX package's, on
the CPU, at full width on the ``meta`` device.

JAX's ``cache_shardings`` and ``batch_shardings`` wrap each spec in a
``NamedSharding`` over a real mesh; these tests give them a stand-in mesh
of the production axes and read the bare ``PartitionSpec``s, so the specs
of the 16 x 16 and 2 x 16 x 16 meshes are compared on one CPU device.
Specs are compared as tuples and must be exactly equal:

- every cache leaf of every arch of the registry, for ``decode_32k`` and
  ``long_500k`` (with ``shard_kv_seq``), on both meshes, and the leaves'
  shapes and paths equal JAX's ``eval_shape(model.init_cache)``;
- the batch specs of every kind, on both meshes;
- ``shard_shape`` gives each device's block.
"""
import jax
import numpy as np
import pytest
import torch

from repro.configs import REGISTRY as JAX_REGISTRY
from repro.configs.base import ParallelConfig as JPC
from repro.launch import shardings as JSH
from repro.models.model import MeshShape
from repro.models.model import build_model as jax_build
from repro_torch import tree
from repro_torch.configs import SHAPE_BY_NAME, get_config
from repro_torch.launch import dryrun
from repro_torch.launch import shardings as SH
from repro_torch.launch.mesh import (make_host_mesh, make_production_mesh,
                                     mesh_axis_sizes)
from repro_torch.models.model import build_model

MESHES = {"single": False, "multi": True}


class _StandInMesh:
    """What JAX's rules read of a mesh: its axis names and device grid."""

    def __init__(self, mesh):
        self.axis_names = mesh.axis_names
        self.devices = np.empty(mesh.shape, dtype=object)


@pytest.fixture
def bare_specs(monkeypatch):
    monkeypatch.setattr(JSH, "NamedSharding", lambda mesh, spec: spec)


def _leaves_with_specs(jtree):
    return jax.tree.leaves(
        jtree, is_leaf=lambda x: isinstance(x, jax.sharding.PartitionSpec))


def test_production_meshes():
    single, multi = make_production_mesh(), make_production_mesh(
        multi_pod=True)
    assert mesh_axis_sizes(single) == (("data", 16), ("model", 16))
    assert mesh_axis_sizes(multi) == (("pod", 2), ("data", 16), ("model", 16))
    assert (single.size, multi.size) == (256, 512)
    assert make_host_mesh(1, 4).sizes == {"data": 1, "model": 4}


@pytest.mark.parametrize("mesh_name", sorted(MESHES))
@pytest.mark.parametrize("shape_name", ["decode_32k", "long_500k"])
@pytest.mark.parametrize("arch", sorted(JAX_REGISTRY))
def test_cache_specs_match_jax(arch, shape_name, mesh_name, bare_specs):
    mesh = make_production_mesh(multi_pod=MESHES[mesh_name])
    shape = SHAPE_BY_NAME[shape_name]
    B, S = shape.global_batch, shape.seq_len
    skv = dryrun.parallel_config(get_config(arch), shape).shard_kv_seq
    assert skv == (shape_name == "long_500k")
    ms = MeshShape(tuple(zip(mesh.axis_names, mesh.shape)))
    jm = jax_build(JAX_REGISTRY[arch], JPC(), batch=B, seq_len=S,
                   mesh_shape=ms)
    jc = jax.eval_shape(lambda: jm.init_cache(B, S))
    jflat = jax.tree_util.tree_flatten_with_path(jc)[0]
    want = [tuple(s) for s in _leaves_with_specs(JSH.cache_shardings(
        jc, JAX_REGISTRY[arch], global_batch=B, mesh=_StandInMesh(mesh),
        shard_kv_seq=skv))]

    tm = build_model(get_config(arch), batch=B, seq_len=S, device="meta",
                     ep_degree=mesh.sizes["model"])
    tc = tm.init_cache(B, S)
    assert tree.paths(tc, fields=True) == [JSH._path_str(p) for p, _ in jflat]
    assert [tuple(t.shape) for t in tree.leaves(tc)] == [
        tuple(x.shape) for _, x in jflat]
    got = tree.leaves(SH.cache_shardings(
        tc, get_config(arch), global_batch=B, mesh=mesh, shard_kv_seq=skv))
    assert [tuple(s) for s in got] == want


@pytest.mark.parametrize("mesh_name", sorted(MESHES))
@pytest.mark.parametrize("kind", ["train_4k", "prefill_32k", "decode_32k",
                                  "long_500k"])
def test_batch_specs_match_jax(kind, mesh_name, bare_specs):
    mesh = make_production_mesh(multi_pod=MESHES[mesh_name])
    shape = SHAPE_BY_NAME[kind]
    for arch in ("whisper-large-v3", "pixtral-12b", "stablelm-1.6b"):
        ms = MeshShape(tuple(zip(mesh.axis_names, mesh.shape)))
        jm = jax_build(JAX_REGISTRY[arch], JPC(), batch=shape.global_batch,
                       seq_len=shape.seq_len, mesh_shape=ms)
        jb = jm.input_specs(shape.kind)
        want = [tuple(s) for s in _leaves_with_specs(JSH.batch_shardings(
            jb, global_batch=shape.global_batch, mesh=_StandInMesh(mesh)))]
        tm = build_model(get_config(arch), batch=shape.global_batch,
                         seq_len=shape.seq_len, device="meta")
        tb = dryrun.make_inputs(tm, shape, "meta")
        assert sorted(tb) == sorted(jb)
        for k in tb:
            assert tuple(tb[k].shape) == tuple(jb[k].shape), (arch, k)
        got = tree.leaves(SH.batch_shardings(
            tb, global_batch=shape.global_batch, mesh=mesh))
        assert [tuple(s) for s in got] == want
        assert [tuple(s) for s in tree.leaves(
            SH.replicated(tb, mesh))] == [
            (None,) * tb[k].ndim for k in sorted(tb)]


def test_partition_spec_and_shard_shape():
    P = SH.PartitionSpec
    assert tuple(P(("data",), None)) == ("data", None)
    assert tuple(P((), "model")) == (None, "model")
    assert tuple(P(("pod", "data"), None)) == (("pod", "data"), None)
    sizes = {"pod": 2, "data": 16, "model": 16}
    assert SH.shard_shape((128, 32768, 8, 128),
                          P(("pod", "data"), None, "model", None),
                          sizes) == (4, 32768, 1, 128)
    assert SH.shard_shape((100, 7), P("data", None), sizes) == (7, 7)
    assert SH.shard_shape((4, 4), P(), sizes) == (4, 4)
    # a tree of specs keeps the tree's structure
    t = {"a": torch.empty((32, 4), device="meta"),
         "b": [torch.empty((8,), device="meta")]}
    specs = SH.batch_shardings(t, global_batch=32,
                               mesh=make_production_mesh())
    assert tuple(specs["a"]) == ("data", None)
    assert tuple(specs["b"][0]) == ("data",)
