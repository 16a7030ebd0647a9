"""Tensor-parallel MoE (E < EP degree) of the port against the JAX
package's ``tp_moe_block``: every case of
``tests/test_moe_block.py::test_tp_mode_matches_oracle`` (G = 1); the
grouped buffer's integer rows against the reference's ops; the block at
G = 4 with E = 2 on ``VirtualGroup(4)`` against JAX's on a (1, 4) mesh of
emulated host devices (learned routing, and the synthetic skew on JAX's
own draws), y in f32 within 2e-5 and every diagnostic equal; and the
engine: a reduced qwen15-moe-a27b with 2 experts served at G = 4 by both
engines on the same weights (slab and paged), greedy streams and the
load-balance report equal, and replica slots and residency refused with
JAX's messages word for word."""
import dataclasses
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.base import MoEConfig as JMoE
from repro.core.moe_layer import MoEBlockSpec as JSpec
from repro.core.moe_layer import init_moe_params, moe_block as jax_moe_block
from repro.launch.mesh import make_mesh
from repro_torch.configs.base import MoEConfig as TMoE
from repro_torch.configs.qwen15_moe_a27b import CONFIG as TORCH_QWEN
from repro_torch.convert import to_torch, tp_params, tp_rows
from repro_torch.core import moe_layer as TM
from repro_torch.core.dispatch import VirtualGroup
from repro_torch.core.moe_layer import SCALAR_DIAGS, VECTOR_DIAGS
from repro_torch.models.model import build_model
from repro_torch.serve import (EngineConfig, Request, ServeEngine,
                               VirtualClock, engine_config_for)

from _ep_helpers import FLATTEN_SRC, one_torch_thread, unflatten  # noqa: F401
from _serve_helpers import captured_run
from test_torch_prefix import run_jax_side_by_side

G = 4
TOL = dict(atol=2e-5, rtol=2e-5)
BLOCK_CASES = {"learned": (2, 0.0), "skew": (1, 0.9)}   # name: (top-k, skew)
B, S, D, F, E = 2, 8, 16, 32, 2
SLOTS, L, GEN, C = 3, 12, 6, 4


def _dense_oracle(x, params, k):
    """JAX test's oracle: every token through its top-k experts."""
    from repro.core.router import route_topk
    flat = np.asarray(x).reshape(-1, x.shape[-1])
    r = route_topk(jnp.asarray(flat), params["router"], top_k=k,
                   num_real_experts=E)
    y = np.zeros_like(flat)
    for t in range(flat.shape[0]):
        for j in range(k):
            e = int(r.assign[t, j])
            h = flat[t] @ np.asarray(params["w_in"][e])
            h = np.asarray(jax.nn.silu(flat[t] @ params["w_gate"][e])) * h
            y[t] += float(r.gates[t, j]) * (h @ np.asarray(params["w_out"][e]))
    return y.reshape(x.shape)


def test_tp_mode_matches_oracle():
    """tests/test_moe_block.py's case (G = 1, tp_mode forced): the port's
    block equals JAX's and the dense oracle."""
    B1, S1, d, f, E1, k = 2, 8, 16, 32, 2, 1
    spec = JSpec(moe=JMoE(num_experts=E1, num_experts_per_tok=k,
                          d_ff_expert=f),
                 d_model=d, ep_axis="model", batch_axes=(), ep_degree=1,
                 tokens_local=B1 * S1, block_m=8, act="silu", tp_mode=True)
    mesh = make_mesh((1, 1), ("data", "model"))
    params = init_moe_params(jax.random.PRNGKey(0), spec)
    x = np.random.default_rng(1).standard_normal((B1, S1, d)) \
        .astype(np.float32)
    with mesh:
        jy, jd = jax.jit(lambda x, p: jax_moe_block(
            x, p, spec=spec, mesh=mesh))(jnp.asarray(x), params)
    tspec = TM.MoEBlockSpec(moe=TMoE(num_experts=E1, num_experts_per_tok=k,
                                     d_ff_expert=f),
                            d_model=d, ep_degree=1, tokens_local=B1 * S1,
                            block_m=8, act="silu", tp_mode=True)
    y, diag = TM.moe_block(torch.from_numpy(x),
                           to_torch(jax.device_get(params), device="cpu"),
                           spec=tspec)
    np.testing.assert_allclose(y.numpy(), np.asarray(jy), **TOL)
    np.testing.assert_allclose(y.numpy(), _dense_oracle(x, params, k),
                               atol=2e-4)
    _assert_diags(diag, {k2: np.asarray(v) for k2, v in jd.items()})


def _assert_diags(diag, jd):
    assert set(diag) == set(SCALAR_DIAGS) | set(VECTOR_DIAGS) == set(jd)
    for key, want in jd.items():
        if key == "aux_loss":
            np.testing.assert_allclose(diag[key].numpy(), want, atol=1e-6)
        else:
            np.testing.assert_array_equal(diag[key].numpy(), want,
                                          err_msg=key)


def _jax_rows(assign, E_, bm):
    """The reference's grouped-buffer ops, line for line
    (``repro/core/moe_layer.py::tp_moe_block``)."""
    ue = jnp.asarray(assign).reshape(-1)
    U = ue.shape[0]
    sizes = jnp.zeros((E_,), jnp.int32).at[ue].add(1)
    padded = (sizes + bm - 1) // bm * bm
    offsets = jnp.concatenate([jnp.zeros((1,), jnp.int32),
                               jnp.cumsum(padded)[:-1]])
    order = jnp.argsort(ue, stable=True)
    start = jnp.concatenate([jnp.zeros((1,), jnp.int32),
                             jnp.cumsum(sizes)[:-1]])
    r_sorted = jnp.arange(U, dtype=jnp.int32) - start[ue[order]]
    rank_in_e = jnp.zeros((U,), jnp.int32).at[order].set(r_sorted)
    return sizes, padded, offsets[ue] + rank_in_e, \
        -(-U // bm) * bm + E_ * bm


@pytest.mark.parametrize("T,k,E_,bm", [(16, 1, 2, 8), (37, 2, 3, 8),
                                       (5, 2, 8, 128), (64, 4, 5, 16)])
def test_tp_layout_rows_equal_jax(T, k, E_, bm):
    assign = np.random.default_rng(T).integers(0, E_, (T, k)) \
        .astype(np.int32)
    got = TM.tp_layout(torch.from_numpy(assign), E_, bm)
    want = _jax_rows(assign, E_, bm)
    for g, w, name in zip(got[:3], want[:3], ("sizes", "padded", "row")):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w),
                                      err_msg=name)
    assert got[3] == want[3]


def test_tp_rows_are_contiguous_d_ff_slices():
    w = torch.arange(2 * 3 * 4 * 8, dtype=torch.float32).reshape(2, 3, 4, 8)
    for name, ax in (("w_in", 3), ("w_out", 2)):
        r = tp_rows(w, 4, name)
        assert r.shape[1] == 12 and r.is_contiguous()
        for g in range(4):
            want = w.narrow(ax, g * (w.shape[ax] // 4), w.shape[ax] // 4)
            torch.testing.assert_close(r[:, g * 3:(g + 1) * 3], want)
    with pytest.raises(ValueError, match="does not split"):
        tp_rows(w, 3, "w_in")


# ----------------------------------------------------------------------
# G = 4: the block and the engine against JAX subprocesses
# ----------------------------------------------------------------------
BLOCK_BODY = FLATTEN_SRC + '''
import jax, jax.numpy as jnp
from repro.configs.base import MoEConfig
from repro.core import router as R
from repro.core.moe_layer import MoEBlockSpec, init_moe_params, moe_block
from repro.launch.mesh import make_host_mesh
mesh = make_host_mesh(1, G)
out = {}
for name, (k, skew) in CASES.items():
    moe = MoEConfig(num_experts=E, num_experts_per_tok=k, d_ff_expert=F,
                    router_skew=skew)
    spec = MoEBlockSpec(moe=moe, d_model=D, ep_axis="model", batch_axes=(),
                        ep_degree=G, tokens_local=B * S, block_m=8,
                        act="silu", tp_mode=True)
    params = init_moe_params(jax.random.PRNGKey(0), spec)
    x = np.random.default_rng(1).standard_normal((B, S, D)).astype(np.float32)
    key = jax.random.PRNGKey(7)
    with mesh:
        if skew:
            y, diag = jax.jit(lambda x, p, kk: moe_block(
                x, p, spec=spec, mesh=mesh, skew_key=kk))(x, params, key)
            out[name + "/assign"] = np.asarray(R.route_skewed(
                key, B * S, top_k=k, num_experts=E, padded_experts=E,
                alpha=skew, n_hot=moe.router_skew_experts).assign)
        else:
            y, diag = jax.jit(lambda x, p: moe_block(
                x, p, spec=spec, mesh=mesh))(x, params)
    out.update(flatten(jax.device_get(params), name + "/params/"))
    out.update(flatten(jax.device_get(diag), name + "/diag/"))
    out[name + "/x"] = x
    out[name + "/y"] = np.asarray(y)
np.savez(OUT, **out)
'''

ENGINE_BODY = FLATTEN_SRC + '''
import dataclasses, json
import jax
from repro.configs.base import ParallelConfig
from repro.configs.qwen15_moe_a27b import CONFIG
from repro.launch.mesh import make_host_mesh
from repro.models.model import MeshShape, build_model
from repro.serve import (EngineConfig, Request, ServeEngine, VirtualClock,
                         engine_config_for)
cfg = CONFIG.reduced()
cfg = dataclasses.replace(cfg, moe=dataclasses.replace(cfg.moe,
                                                       num_experts=2))
mesh = make_host_mesh(1, G)
ms = MeshShape(tuple(zip(mesh.axis_names, mesh.devices.shape)))
model = build_model(cfg, ParallelConfig(attn_chunk=8, loss_chunk=8),
                    batch=KW["max_slots"], seq_len=KW["prompt_len"],
                    mesh_shape=ms, mesh=mesh)
with mesh:
    params = model.init(jax.random.PRNGKey(0))
out = flatten(jax.device_get(params), "params/")
res = {"tp_mode": bool(model.moe_spec.tp_mode), "refusals": {}}
for field in ("replica_slots", "resident_experts"):
    try:
        ServeEngine(model, params, EngineConfig(**{field: 2}), mesh=mesh)
    except ValueError as e:
        res["refusals"][field] = str(e)
for paged in (False, True):
    rng = np.random.default_rng(3)
    reqs = [Request(rid=i, tokens=rng.integers(
                0, 512, (int(rng.integers(3, KW["prompt_len"] + 1)),)
            ).astype(np.int32), max_new_tokens=KW["max_new_tokens"],
            arrival_time=0.3 * i) for i in range(5)]
    eng = ServeEngine(model, params, engine_config_for(
        cfg, paged=paged, **KW), mesh=mesh, clock=VirtualClock(0.1))
    streams = {}
    orig = eng._finish
    def capture(st, now, orig=orig):
        streams[st.req.rid] = [int(t) for t in st.output]
        orig(st, now)
    eng._finish = capture
    with mesh:
        rep = eng.run(reqs)
    res[str(paged)] = {"streams": streams,
                       "load_balance": rep["load_balance"],
                       "moe": rep["moe"], "decode_steps": rep["decode_steps"],
                       "prefill_chunks": rep["prefill_chunks"]}
out["res"] = np.array(json.dumps(res, default=int))
np.savez(OUT, **out)
'''
KW = dict(max_slots=SLOTS, prompt_len=L, max_new_tokens=GEN, prefill_chunk=C,
          kv_block_size=4)


@pytest.fixture(scope="module")
def jax_g4(tmp_path_factory):
    head = (f"G = {G}\nB, S, D, F, E = {B}, {S}, {D}, {F}, {E}\n"
            f"CASES = {BLOCK_CASES!r}\nKW = {KW!r}\n")
    flat = run_jax_side_by_side([head + BLOCK_BODY, head + ENGINE_BODY],
                                tmp_path_factory.mktemp("tp"), devices=G)
    return flat


@pytest.mark.parametrize("case", list(BLOCK_CASES))
def test_tp_block_g4_matches_jax(jax_g4, case):
    k, skew = BLOCK_CASES[case]
    tspec = TM.MoEBlockSpec(
        moe=TMoE(num_experts=E, num_experts_per_tok=k, d_ff_expert=F,
                 router_skew=skew),
        d_model=D, ep_degree=G, tokens_local=B * S, block_m=8, act="silu",
        tp_mode=True)
    params = tp_params({"moe": to_torch(unflatten(jax_g4, f"{case}/params"),
                                        device="cpu")}, G)["moe"]
    assert params["w_in"].shape == (G * E, D, F // G)
    assign = None
    if skew:
        assign = torch.from_numpy(jax_g4[f"{case}/assign"])[None]
    y, diag = TM.moe_block(torch.from_numpy(jax_g4[f"{case}/x"]), params,
                           spec=tspec, comm=VirtualGroup(G, "cpu"),
                           skew_assign=assign)
    np.testing.assert_allclose(y.numpy(), jax_g4[f"{case}/y"], **TOL)
    jd = {k2[len(case) + 6:]: v for k2, v in jax_g4.items()
          if k2.startswith(case + "/diag/")}
    _assert_diags(diag, jd)
    np.testing.assert_array_equal(diag["rank_load"].numpy(),
                                  np.full((1, G), B * S * k / G))


def _port_cfg():
    cfg = TORCH_QWEN.reduced()
    return dataclasses.replace(cfg, moe=dataclasses.replace(cfg.moe,
                                                            num_experts=2))


def _trace():
    rng = np.random.default_rng(3)
    return [Request(rid=i, tokens=rng.integers(
                0, 512, (int(rng.integers(3, L + 1)),)).astype(np.int32),
                max_new_tokens=GEN, arrival_time=0.3 * i) for i in range(5)]


@pytest.mark.parametrize("paged", [False, True], ids=["slab", "paged"])
def test_tp_engine_g4_matches_jax_engine(jax_g4, paged):
    res = json.loads(str(jax_g4["res"]))
    assert res["tp_mode"]
    cfg = _port_cfg()
    model = build_model(cfg, batch=SLOTS, seq_len=L, device="cpu",
                        ep_degree=G)
    assert model.moe_spec.tp_mode and model.moe_spec_decode.tp_mode
    params = tp_params(to_torch(unflatten(jax_g4, "params"), device="cpu"), G)
    eng = ServeEngine(model, params, engine_config_for(cfg, paged=paged,
                                                       **KW),
                      clock=VirtualClock(0.1), device="cpu")
    out, rep = captured_run(eng, _trace())
    want = res[str(paged)]
    assert {str(k): v for k, v in out.items()} == want["streams"]
    assert rep["decode_steps"] == want["decode_steps"]
    assert rep["prefill_chunks"] == want["prefill_chunks"]
    assert rep["load_balance"] == want["load_balance"]
    assert rep["moe"].keys() == want["moe"].keys()
    assert rep["jit_entries"]["decode"] == 0        # eager on the CPU


def test_tp_engine_refuses_placement_with_jax_messages(jax_g4):
    res = json.loads(str(jax_g4["res"]))
    cfg = _port_cfg()
    model = build_model(cfg, batch=SLOTS, seq_len=L, device="cpu",
                        ep_degree=G)
    params = model.init(0)
    for field, msg in res["refusals"].items():
        with pytest.raises(ValueError) as err:
            ServeEngine(model, params, EngineConfig(**{field: 2}),
                        device="cpu")
        assert str(err.value) == msg, field
    assert set(res["refusals"]) == {"replica_slots", "resident_experts"}
