"""The port's dry-run tooling against the JAX package's, on the CPU.

- The cell matrix: ``iter_cells(include_skipped=True)`` equals JAX's, 40
  cells, 33 runnable, the same skip reasons
  (``tests/test_models.py::test_cell_matrix_accounting``).
- Every arch of the registry at full width, on the ``meta`` device, at
  EP 1 and EP 16 (JAX's ``MeshShape((("data", 16), ("model", 16)))``):
  ``Model.param_shapes()`` has the paths, shapes and dtypes of JAX's
  ``jax.eval_shape(model.init)`` leaf for leaf, and ``param_count``
  equals JAX's ``dryrun.param_count``, exactly.  mixtral at EP 16 is
  tensor-parallel: its expert leaves hold the same values as JAX's in the
  port's rank-major layout (``convert.tp_rows``: ``[n, E, d, f]`` ->
  ``[n, G * E, d, f / G]``), so their shapes are compared through it.
- Every parameter leaf's ``PartitionSpec`` equals JAX's ``param_spec`` at
  ep 16 and data 16, with FSDP on and off (mixtral's tensor-parallel
  expert leaves: as many elements a device, 'model' on the rank-major
  rows where JAX puts it on d_ff).
- ``model_flops_estimate`` equals JAX's on all 40 cells.
- ``param_shapes()`` equals ``init(0)`` on the CPU in paths, shapes and
  dtypes (replica and tensor-parallel leaves included); the schedule on
  meta returns S ``[G, Ep, G]`` int32 and its diagnostics, and the three
  attention and expert kernels refuse meta tensors.
- ``lower_cell`` completes on meta for one cell of each kind (train,
  prefill, decode, long_500k) with JAX's keys.
"""
import dataclasses
import math
import os

import jax
import numpy as np
import pytest
import torch

from repro.configs import REGISTRY as JAX_REGISTRY
from repro.configs import iter_cells as jax_iter_cells
from repro.configs.base import ParallelConfig as JPC
from repro.launch import shardings as JSH
from repro.models.model import MeshShape
from repro.models.model import build_model as jax_build
from repro_torch import tree
from repro_torch.configs import (ASSIGNED, PAPER_MODELS, REGISTRY, SHAPES,
                                 ShapeConfig, get_config, iter_cells)
from repro_torch.configs.base import ParallelConfig
from repro_torch.kernels.flash_attention.ops import flash_attention
from repro_torch.kernels.moe_gmm.ops import moe_gmm
from repro_torch.kernels.paged_attention.ops import paged_attention
from repro_torch.kernels.schedule.ops import rebalance
from repro_torch.launch import dryrun
from repro_torch.launch import shardings as SH
from repro_torch.launch.mesh import make_host_mesh
from repro_torch.models.model import build_model

EPS = (1, 16)
_DT = {"bfloat16": torch.bfloat16, "float32": torch.float32}


@pytest.fixture(scope="module")
def jax_dryrun():
    """The JAX package's ``launch/dryrun`` module.  Importing it sets
    ``XLA_FLAGS`` to 512 host devices; JAX's backend is started first so
    that this process keeps its devices, and the variable is put back."""
    jax.devices()
    old = os.environ.get("XLA_FLAGS")
    try:
        from repro.launch import dryrun as jd
    finally:
        if old is None:
            os.environ.pop("XLA_FLAGS", None)
        else:
            os.environ["XLA_FLAGS"] = old
    return jd


_JAX_SHAPES = {}


def _jax_params(arch: str, ep: int):
    """(paths, leaves) of JAX's ``eval_shape(model.init)`` at EP ``ep``."""
    key = (arch, ep)
    if key not in _JAX_SHAPES:
        ms = MeshShape((("data", 16), ("model", ep)))
        m = jax_build(JAX_REGISTRY[arch], JPC(), batch=128, seq_len=4096,
                      mesh_shape=ms)
        shapes = jax.eval_shape(m.init, jax.random.PRNGKey(0))
        flat = jax.tree_util.tree_flatten_with_path(shapes)[0]
        _JAX_SHAPES[key] = ([JSH._path_str(p) for p, _ in flat],
                            [leaf for _, leaf in flat], shapes)
    return _JAX_SHAPES[key]


def _port_params(arch: str, ep: int):
    m = build_model(get_config(arch), batch=128, seq_len=4096,
                    device="meta", ep_degree=ep)
    ps = m.param_shapes()
    return m, ps, tree.paths(ps, fields=True), tree.leaves(ps)


def _tp_expert(arch: str, ep: int, name: str) -> bool:
    cfg = get_config(arch)
    return (cfg.is_moe and cfg.moe.num_experts < ep and "/moe/" in name
            and name.rsplit("/", 1)[-1] in ("w_in", "w_gate", "w_out"))


def _tp_shape(shape, ep: int, name: str):
    """JAX's tensor-parallel expert leaf ``[n, E, d, f]`` (``[n, E, f, d]``
    for ``w_out``) in the port's rank-major layout."""
    n, E, a, b = shape
    if name.endswith("w_out"):
        return (n, ep * E, a // ep, b)
    return (n, ep * E, a, b // ep)


# ----------------------------------------------------------------------
def test_cell_matrix_matches_jax():
    ours = [(a, s.name, s.seq_len, s.global_batch, s.kind, ok, why)
            for a, s, ok, why in iter_cells(include_skipped=True)]
    ref = [(a, s.name, s.seq_len, s.global_batch, s.kind, ok, why)
           for a, s, ok, why in jax_iter_cells(include_skipped=True)]
    assert ours == ref
    assert len(ours) == 40
    skipped = [(a, s) for a, s, *_, ok, _ in ours if not ok]
    assert all(s == "long_500k" for _, s in skipped)
    assert sorted(a for a, s, *_, ok, _ in ours
                  if s == "long_500k" and ok) == [
        "mamba2-2.7b", "mixtral-8x7b", "zamba2-7b"]
    assert len(ours) - len(skipped) == 33
    assert list(ASSIGNED) == [a for a, s, *_ in ours[::4]]
    assert list(PAPER_MODELS) == ["switch128", "qwen15-moe-a27b"]
    assert sorted(REGISTRY) == sorted(JAX_REGISTRY)
    assert [s.name for s in SHAPES] == ["train_4k", "prefill_32k",
                                        "decode_32k", "long_500k"]


@pytest.mark.parametrize("ep", EPS)
@pytest.mark.parametrize("arch", sorted(JAX_REGISTRY))
def test_param_shapes_match_jax_eval_shape(arch, ep, jax_dryrun):
    jpaths, jleaves, jtree = _jax_params(arch, ep)
    _, ps, paths, leaves = _port_params(arch, ep)
    assert paths == jpaths
    for name, t, j in zip(paths, leaves, jleaves):
        assert t.device.type == "meta"
        assert t.dtype == _DT[str(j.dtype)], name
        want = tuple(j.shape)
        if _tp_expert(arch, ep, name):
            want = _tp_shape(want, ep, name)
        assert tuple(t.shape) == want, name
    assert dryrun.param_count(ps) == jax_dryrun.param_count(jtree)


@pytest.mark.parametrize("fsdp", [False, True])
@pytest.mark.parametrize("arch", sorted(JAX_REGISTRY))
def test_param_specs_match_jax(arch, fsdp):
    """Every leaf's spec at ep 16 and data 16 (the production meshes'
    model and data axes), as tuples, exactly."""
    ep, data = 16, 16
    cfg = get_config(arch)
    jpaths, jleaves, _ = _jax_params(arch, ep)
    _, ps, paths, leaves = _port_params(arch, ep)
    sizes = {"data": data, "model": ep}
    for name, t, j in zip(paths, leaves, jleaves):
        want = tuple(JSH.param_spec(
            [jax.tree_util.DictKey(k) for k in name.split("/")], j,
            JAX_REGISTRY[arch], ep=ep, fsdp=fsdp, data=data))
        got = SH.param_spec(name, t.shape, cfg, ep=ep, fsdp=fsdp, data=data)
        assert isinstance(got, SH.PartitionSpec)
        if _tp_expert(arch, ep, name):
            # as many elements a device, 'model' on the rank-major rows
            assert math.prod(SH.shard_shape(t.shape, got, sizes)) == \
                math.prod(SH.shard_shape(tuple(j.shape), want, sizes)), name
            assert got[1] == "model" and "model" not in got[2:], name
            assert ("data" in got) == ("data" in want), name
        else:
            assert tuple(got) == want, name
    # the tree form gives the same specs
    flat = tree.leaves(SH.param_shardings(
        ps, cfg, ParallelConfig(fsdp=fsdp), make_host_mesh(data, ep)))
    assert [tuple(s) for s in flat] == [
        tuple(SH.param_spec(n, t.shape, cfg, ep=ep, fsdp=fsdp, data=data))
        for n, t in zip(paths, leaves)]


def test_model_flops_estimate_matches_jax(jax_dryrun):
    cells = list(iter_cells(include_skipped=True))
    assert len(cells) == 40
    for arch, shape, _, _ in cells:
        jshape = jax_dryrun.SHAPE_BY_NAME[shape.name]
        assert dryrun.model_flops_estimate(get_config(arch), shape) == \
            jax_dryrun.model_flops_estimate(JAX_REGISTRY[arch], jshape), \
            (arch, shape.name)
        assert dryrun._active_params(get_config(arch)) == \
            jax_dryrun._active_params(JAX_REGISTRY[arch])


@pytest.mark.parametrize("arch,ep,replicas", [
    ("qwen15-moe-a27b", 4, 1), ("mixtral-8x7b", 16, 0),
    ("zamba2-7b", 1, 0), ("whisper-large-v3", 1, 0)])
def test_param_shapes_equal_init_on_cpu(arch, ep, replicas):
    cfg = get_config(arch).reduced()
    if replicas:
        cfg = cfg.replace(moe=dataclasses.replace(
            cfg.moe, num_replica_slots=replicas))
    m = build_model(cfg, batch=2, seq_len=16, device="cpu", ep_degree=ep)
    ref = m.init(0)
    got = m.param_shapes()
    assert tree.paths(got) == tree.paths(ref)
    for g, r in zip(tree.leaves(got), tree.leaves(ref)):
        assert g.device.type == "meta" and r.device.type == "cpu"
        assert (g.shape, g.dtype) == (r.shape, r.dtype)
    names = tree.paths(ref)
    if replicas:
        assert any(n.endswith("moe/w_rep_in") for n in names)
    if cfg.is_moe and cfg.moe.num_experts < ep:        # tensor-parallel
        w_in = [t for n, t in zip(names, tree.leaves(ref))
                if n.endswith("moe/w_in")][0]
        assert w_in.shape[1] == ep * cfg.moe.num_experts


def test_schedule_on_meta_returns_its_shapes():
    G, Ep = 16, 64
    S0 = torch.empty((G, Ep, G), dtype=torch.int32, device="meta")
    is_local = torch.empty((G, Ep), dtype=torch.int32, device="meta")
    S, diag = rebalance(S0, is_local, q=1, c_pair=8, num_foreign_slots=4)
    assert S.device.type == "meta" and diag.device.type == "meta"
    assert (tuple(S.shape), S.dtype) == ((G, Ep, G), torch.int32)
    assert (tuple(diag.shape), diag.dtype) == ((4,), torch.int32)
    before = rebalance.launches
    # the CPU keeps the plain version, with values
    S0c = torch.zeros((2, 4, 2), dtype=torch.int32)
    S0c[0, 0, 0] = 5
    Sc, dc = rebalance(S0c, torch.tensor([[1, 1, 0, 0], [0, 0, 1, 1]],
                                         dtype=torch.int32),
                       q=1, c_pair=8, num_foreign_slots=2)
    assert int(Sc.sum()) == 5 and dc.shape == (4,)
    assert rebalance.launches == before


def test_kernels_refuse_meta():
    m = "meta"
    q = torch.empty((1, 8, 2, 64), dtype=torch.bfloat16, device=m)
    with pytest.raises(ValueError, match="not meta"):
        flash_attention(q, q, q, causal=True)
    pool = torch.empty((1, 64, 2, 64), dtype=torch.bfloat16, device=m)
    with pytest.raises(ValueError, match="not meta"):
        paged_attention(q[:, :1], pool, pool,
                        torch.empty((1, 4), dtype=torch.int32, device=m), 8,
                        block_size=16)
    x = torch.empty((128, 64), dtype=torch.bfloat16, device=m)
    w = torch.empty((2, 64, 64), dtype=torch.bfloat16, device=m)
    with pytest.raises(ValueError, match="not meta"):
        moe_gmm(x, w, w, torch.empty((1,), dtype=torch.int32, device=m))


@pytest.mark.parametrize("arch,shape", [
    ("stablelm-1.6b", ShapeConfig("train_4k", 1024, 256, "train")),
    ("gemma2-2b", ShapeConfig("prefill_32k", 8192, 32, "prefill")),
    ("stablelm-1.6b", "decode_32k"),
    ("mamba2-2.7b", "long_500k")])
def test_lower_cell_completes_on_meta(arch, shape):
    """One cell of each kind on the production mesh (the train and prefill
    cells cut in sequence to keep the test short): JAX's keys, per-device
    figures an even split of the whole step's."""
    r = dryrun.lower_cell(arch, shape, verbose=False)
    for k in ("arch", "shape", "multi_pod", "n_chips", "lower_s",
              "compile_s", "memory", "flops_raw", "bytes_raw", "flops",
              "bytes_accessed", "collectives", "model_flops",
              "param_count", "hlo_ops", "fits", "wall_s"):
        assert k in r, k
    assert r["n_chips"] == 256 and r["per_device"] == "even split"
    assert r["memory"]["temp_bytes"] is None
    assert r["memory"]["peak_bytes"] is None
    assert r["flops"] * 256 == pytest.approx(r["flops_raw"])
    assert r["flops_raw"] >= r["model_flops"] > 0
    assert 0 < r["memory"]["argument_bytes"] < 80e9 and r["fits"]
    assert r["param_count"] == dryrun.param_count(
        build_model(get_config(arch), batch=1, seq_len=1, device="meta")
        .param_shapes())
    assert set(r["collectives"]["per_kind"]) == {
        "all-gather", "all-reduce", "reduce-scatter", "all-to-all",
        "collective-permute"}


def test_argument_bytes_on_one_device_are_the_leaves():
    """On a 1 x 1 mesh every spec is one block, so the argument bytes are
    the parameters', caches' and batch's bytes (what the chip phase holds
    ``memory_allocated`` to)."""
    cfg = get_config("phi4-mini-3.8b")
    shape = ShapeConfig("decode_32k", 1024, 2, "decode")
    r = dryrun.lower_cell("phi4-mini-3.8b", shape, mesh=make_host_mesh(1, 1),
                          verbose=False)
    m = build_model(cfg, batch=2, seq_len=1024, device="meta")
    leaves = (tree.leaves(m.param_shapes())
              + tree.leaves(m.init_cache(2, 1024)))
    want = sum(t.numel() * t.element_size() for t in leaves) + 2 * 4 + 4
    assert r["memory"]["argument_bytes"] == want
    assert r["flops"] == r["flops_raw"] and r["n_chips"] == 1
    assert np.isclose(r["model_flops"], 2 * dryrun._active_params(cfg)[1] * 2)
