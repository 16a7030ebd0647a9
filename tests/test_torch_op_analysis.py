"""``launch/op_analysis`` (the port's operation counter) against the JAX
package's ``launch/hlo_analysis``, on the CPU.

- A loop of n products counts n times, as ``test_hlo_analysis.py``
  checks for a scan, against JAX's count of the same scan; a nested loop
  multiplies; a ``VirtualGroup(4)`` psum inside a loop counts once per
  iteration, with every rank's bytes x 2 (all-reduce); the byte
  conventions of a product, a gather and a scatter are JAX's.
- Reduced prefill, decode and train steps of one arch per family (moe,
  dense, ssm, hybrid, audio, vlm), one layer (one period of the
  hybrid), on the ``meta`` device with the plain branches, against
  JAX's ``analyze`` of the compiled reference path under
  ``make_host_mesh(1, 1)`` (JAX's own tests' mesh) with
  ``use_pallas=False`` (compiled in six subprocesses side by side), at
  the dry-run's ``ParallelConfig`` (remat "full" for training; the
  microbatches repeat the same step, so one is run) with attention and
  loss chunks below the sequence (XLA folds a one-trip loop's
  recomputation away).
  The FLOPs are **equal**, except where ROADMAP C records a gap with the
  op that makes it:
  * moe, every step: JAX builds the foreign-weight fetch's outbox as a
    mask einsum (``repro/core/prefetch.py:84``), a product of
    2 x G x K x epr x row elements a matrix; the port gathers the rows.
    Prefill and decode are equal once that product is added; a train
    step differs by its share of the step (held within the gap + 1e-3).
  * ssm and hybrid, train only: ``torch.utils.checkpoint`` recomputes a
    whole SSD chunk (its ``y_diag`` product included) where XLA's remat
    keeps only what backward reads, and XLA strength-reduces the
    transposes of the chunk's three-operand einsums (held within the
    gap + 1e-3).
"""
import json
import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import pytest
import torch

from repro.configs import get_config as jax_config
from repro.configs.base import ParallelConfig as JPC
from repro.launch import hlo_analysis
from repro.launch.mesh import make_host_mesh
from repro.launch.steps import make_decode_step as jax_decode
from repro.launch.steps import make_prefill_step as jax_prefill
from repro.launch.steps import make_train_step as jax_train
from repro.launch.steps import optimizer_shapes as jax_opt_shapes
from repro.models.model import MeshShape
from repro.models.model import build_model as jax_build
from repro_torch.configs import get_config
from repro_torch.configs.base import ParallelConfig, ShapeConfig
from repro_torch.core import dispatch as D
from repro_torch.launch import dryrun
from repro_torch.launch.op_analysis import COLLECTIVES, OpCounter, analyze
from repro_torch.models.model import build_model

FAMILIES = {"moe": "qwen15-moe-a27b", "dense": "stablelm-1.6b",
            "ssm": "mamba2-2.7b", "hybrid": "zamba2-7b",
            "audio": "whisper-large-v3", "vlm": "pixtral-12b"}
KINDS = ("prefill", "decode", "train")
B, S = 4, 56            # + pixtral's 8 patches: 64 positions, 8 chunks
CHUNK = 8
# one layer, or one period of the hybrid (a mamba layer and the shared
# attention block)
LAYERS = {a: 2 if a == "zamba2-7b" else 1 for a in FAMILIES.values()}


# ----------------------------------------------------------------------
def test_loop_of_products_counts_each_iteration():
    d, n = 128, 8
    w = torch.zeros((n, d, d))
    x = torch.zeros((4, d))

    def f(x):
        for i in range(n):
            x = x @ w[i]
        return x
    r = analyze(f, x)
    jr = hlo_analysis.analyze(jax.jit(
        lambda x: jax.lax.scan(lambda c, wi: (c @ wi, None), x,
                               jnp.zeros((n, d, d)))[0]
    ).lower(jnp.zeros((4, d))).compile().as_text())
    assert r["flops"] == n * 2 * 4 * d * d == jr["flops"]


def test_nested_loop_multiplies():
    x = torch.zeros((4, 64))
    w = torch.zeros((3, 5, 64, 64))

    def f(x):
        for i in range(3):
            for j in range(5):
                x = x @ w[i, j]
        return x
    assert analyze(f, x)["flops"] == 3 * 5 * 2 * 4 * 64 * 64


def test_virtual_group_psum_in_a_loop_counts_once_per_iteration():
    g = D.VirtualGroup(4, "cpu")
    w = torch.zeros((8, 64, 64))
    x = torch.zeros((4, 64))

    def f():
        def body(me):
            c = x
            for i in range(8):
                c = yield from D.psum(c @ w[i])
            return c
        return g.run_ranks(body)
    r = analyze(f)
    assert r["collective_counts"] == {**{k: 0.0 for k in COLLECTIVES},
                                      "all-reduce": 8.0}
    # every rank's answer, x 2 for the ring's reduce-scatter + all-gather
    assert r["collectives_per_kind"]["all-reduce"] == 8 * 4 * 4 * 64 * 4 * 2
    assert r["collective_bytes"] == r["collectives_per_kind"]["all-reduce"]
    assert r["flops"] == 4 * 8 * 2 * 4 * 64 * 64
    assert not D.WATCHERS                      # the watcher is removed


def test_byte_conventions():
    a, b = torch.zeros((8, 16)), torch.zeros((16, 4))
    r = analyze(torch.mm, a, b)
    assert r["bytes_accessed"] == (8 * 16 + 16 * 4 + 8 * 4) * 4
    table, idx = torch.zeros((100, 32)), torch.zeros((10,), dtype=torch.long)
    r = analyze(lambda: table[idx])
    assert r["bytes_accessed"] == 2 * 10 * 32 * 4 and r["flops"] == 0
    upd = torch.zeros((10, 32))
    r = analyze(lambda: table.index_copy_(0, idx, upd))
    assert r["bytes_accessed"] == 2 * 10 * 32 * 4
    r = analyze(lambda: (a + 1).transpose(0, 1))     # one op, one view
    assert r["bytes_accessed"] == 0 and r["bytes_all"] == 2 * 8 * 16 * 4


# ----------------------------------------------------------------------
def _pcfg_kw(kind):
    shape = ShapeConfig(kind, S, B, kind)
    p = dryrun.parallel_config(get_config("stablelm-1.6b"), shape)
    return dict(remat=p.remat, microbatch=0,
                moe_block_m=p.moe_block_m, loss_chunk=CHUNK,
                attn_chunk=CHUNK)


def _jax_flops(arch, kind):
    cfg = jax_config(arch).reduced().replace(num_layers=LAYERS[arch])
    mesh = make_host_mesh(1, 1)
    ms = MeshShape(tuple(zip(mesh.axis_names, mesh.devices.shape)))
    m = jax_build(cfg, JPC(use_pallas=False, **_pcfg_kw(kind)), batch=B,
                  seq_len=S, mesh_shape=ms, mesh=mesh)
    ps = jax.eval_shape(m.init, jax.random.PRNGKey(0))
    bs = m.input_specs(kind)
    with mesh:
        if kind == "train":
            lo = jax.jit(jax_train(m)).lower(ps, jax_opt_shapes(ps), bs)
        elif kind == "prefill":
            lo = jax.jit(jax_prefill(m, s_max=S + 64)).lower(ps, bs)
        else:
            cs = jax.eval_shape(lambda: m.init_cache(B, S))
            lo = jax.jit(jax_decode(m)).lower(
                ps, bs["tokens"], cs, jax.ShapeDtypeStruct((), jnp.int32))
        return hlo_analysis.analyze(lo.compile().as_text())["flops"]


def _fetch_einsum_flops(model, n_calls: int) -> float:
    """JAX's foreign-fetch mask einsum a MoE layer call
    (``repro/core/prefetch.py:84``): ``dkj,j...->dk...`` over each expert
    matrix, 2 x G x K x epr x row elements."""
    cfg, G = model.cfg, 1
    f, d = cfg.moe.d_ff_expert, cfg.d_model
    n_mats = 3 if cfg.act == "swiglu" else 2
    return n_calls * n_mats * 2 * G * cfg.moe.num_foreign_slots * \
        cfg.moe.num_experts * d * f


def _ssd_dead_flops(model, seq_len: int) -> float:
    """The products of JAX's SSD scan backward that feed no gradient, a
    mamba layer of a train step (``repro/models/mamba2.py:169``): its scan
    body is the same for every chunk, so it computes the first chunk's
    gradient for the initial state (zeros, a constant) and the last
    chunk's for ``S_c`` (the final state feeds no loss), 3 x 2 B H P N Q;
    and XLA makes the transposes of the two broadcast products
    (``exp(Lcum)``, ``rem``) contractions over P, 2 x 2 B Q H P a chunk,
    where autograd multiplies and sums."""
    cfg = model.cfg
    P, N = cfg.ssm.head_dim, cfg.ssm.state_dim
    H = cfg.ssm.expand * cfg.d_model // P
    Q = min(cfg.ssm.chunk_size, seq_len)
    n_chunks = -(-seq_len // Q)
    per_layer = 3 * 2 * B * H * P * N * Q + n_chunks * 2 * 2 * B * Q * H * P
    return cfg.num_layers * per_layer


@pytest.fixture(scope="module")
def jax_flops(tmp_path_factory):
    """JAX's FLOPs of every (family, kind), compiled in one subprocess a
    family, side by side (each compile takes seconds), each writing a JSON
    file."""
    out_dir = tmp_path_factory.mktemp("jax_flops")
    here = os.path.dirname(os.path.abspath(__file__))
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    procs = []
    for i, family in enumerate(sorted(FAMILIES)):
        cases = [(family, k) for k in KINDS]
        out, log = out_dir / f"flops{i}.json", out_dir / f"log{i}.txt"
        code = (f"import json, sys; sys.path.insert(0, {here!r}); "
                f"import test_torch_op_analysis as T; "
                f"json.dump({{f + '/' + k: T._jax_flops(T.FAMILIES[f], k) "
                f"for f, k in {cases!r}}}, open({str(out)!r}, 'w'))")
        with open(log, "w") as fh:
            procs.append((subprocess.Popen([sys.executable, "-c", code],
                                           stdout=fh, stderr=fh, env=env),
                          out, log))
    flops = {}
    for p, out, log in procs:
        rc = p.wait(timeout=600)
        assert rc == 0, log.read_text()[-4000:]
        flops.update(json.loads(out.read_text()))
    return flops


@pytest.mark.parametrize("kind", KINDS)
@pytest.mark.parametrize("family", sorted(FAMILIES))
def test_reduced_step_flops_match_jax(family, kind, jax_flops):
    arch = FAMILIES[family]
    cfg = get_config(arch).reduced().replace(num_layers=LAYERS[arch])
    model = build_model(cfg, ParallelConfig(**_pcfg_kw(kind)), batch=B,
                        seq_len=S, device="meta")
    shape = ShapeConfig(kind, S, B, kind)
    step, args, _ = dryrun.cell_step(model, shape, model.param_shapes(),
                                     dryrun.make_inputs(model, shape, "meta"))
    with OpCounter() as c:
        step(*args)
    port = c.result()["flops"]
    ref = jax_flops[f"{family}/{kind}"]
    # what JAX computes and the port does not, each as ROADMAP C records:
    # the fetch's mask einsum (in a train step forward, remat and the
    # weights' gradient) and the SSD scan's dead products
    if family == "moe":
        n_moe = cfg.num_layers - cfg.moe.first_dense_layers
        port += _fetch_einsum_flops(
            model, n_moe * (3 if kind == "train" else 1))
    elif family in ("ssm", "hybrid") and kind == "train":
        port += _ssd_dead_flops(model, S)
    assert port == ref


@pytest.mark.parametrize("family,kind", [("moe", "prefill"),
                                         ("moe", "decode"),
                                         ("dense", "decode")])
def test_meta_count_equals_a_real_run(family, kind):
    """The step on the CPU, on weights and inputs drawn from a seed, counts
    what the same step counts on the meta device: the dry-run's meta
    count is the count of a run (``chip_smoke.py`` phase 18 holds the
    card's plain run to it)."""
    arch = FAMILIES[family]
    cfg = get_config(arch).reduced().replace(num_layers=LAYERS[arch])
    shape = ShapeConfig(kind, S, B, kind)
    counts = {}
    for dev in ("meta", "cpu"):
        model = build_model(cfg, ParallelConfig(**_pcfg_kw(kind)), batch=B,
                            seq_len=S, device=dev)
        params = model.param_shapes() if dev == "meta" else model.init(0)
        step, args, _ = dryrun.cell_step(
            model, shape, params, dryrun.make_inputs(model, shape, dev))
        with OpCounter() as c:
            out = step(*args)
        counts[dev] = c.result()
        if dev == "cpu":
            assert all(bool(torch.isfinite(t).all()) for t in out[2:3]
                       if kind == "train")
    # (a few host-side ops differ in count between the devices: scalars
    # made on the host and moved; no product, gather or scatter does)
    for k in ("flops", "bytes_accessed", "collective_bytes",
              "collective_counts"):
        assert counts["cpu"][k] == counts["meta"][k], k
