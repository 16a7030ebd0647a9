"""The port's ``ServeEngine`` at EP degree 4 (a reduced qwen15-moe-a27b in
f32 on four virtual ranks, learned routing, q = 1 so that HarMoEny moves
units at decode scale) against the JAX ``ServeEngine`` on a (1, 4) mesh
of emulated host devices, on the same trace and converted weights under a
``VirtualClock``: greedy streams, admission order and preemptions
identical, ``report()["load_balance"]`` equal.  HarMoEny comes from the
model config; round-robin through ``EngineConfig.moe_policy``."""
import dataclasses
import json

import numpy as np
import pytest

from repro_torch.configs.qwen15_moe_a27b import CONFIG as TORCH_QWEN
from repro_torch.convert import to_torch
from repro_torch.models.model import build_model
from repro_torch.serve import Request, ServeEngine, VirtualClock, \
    engine_config_for

from _ep_helpers import (FLATTEN_SRC, one_torch_thread,  # noqa: F401
                         run_jax, unflatten)
from _serve_helpers import captured_run

G, SLOTS, L, GEN, C = 4, 3, 12, 6, 4
KW = dict(max_slots=SLOTS, prompt_len=L, max_new_tokens=GEN, prefill_chunk=C,
          kv_block_size=4, num_kv_blocks=0)
POLICIES = ("harmoeny", "round_robin")

JAX_BODY = FLATTEN_SRC + '''
import dataclasses, json
import jax
from repro.configs.base import ParallelConfig
from repro.configs.qwen15_moe_a27b import CONFIG
from repro.launch.mesh import make_host_mesh
from repro.models.model import MeshShape, build_model
from repro.serve import Request, ServeEngine, VirtualClock, engine_config_for
cfg = CONFIG.reduced()
cfg = dataclasses.replace(cfg, moe=dataclasses.replace(cfg.moe, q_tokens=1))
mesh = make_host_mesh(1, G)
ms = MeshShape(tuple(zip(mesh.axis_names, mesh.devices.shape)))
model = build_model(cfg, ParallelConfig(attn_chunk=8, loss_chunk=8),
                    batch=KW["max_slots"], seq_len=KW["prompt_len"],
                    mesh_shape=ms, mesh=mesh)
with mesh:
    params = model.init(jax.random.PRNGKey(0))
out = flatten(jax.device_get(params), "params/")
for policy in POLICIES:
    rng = np.random.default_rng(3)
    reqs = [Request(rid=i, tokens=rng.integers(
                0, 512, (int(rng.integers(3, KW["prompt_len"] + 1)),)
            ).astype(np.int32), max_new_tokens=KW["max_new_tokens"],
            arrival_time=0.3 * i) for i in range(6)]
    eng = ServeEngine(model, params, engine_config_for(
        cfg, paged=True, moe_policy=policy, **KW), mesh=mesh,
        clock=VirtualClock(0.1))
    streams = {}
    orig = eng._finish
    def capture(st, now, orig=orig):
        streams[st.req.rid] = [int(t) for t in st.output]
        orig(st, now)
    eng._finish = capture
    with mesh:
        rep = eng.run(reqs)
    res = {"streams": streams, "slot_history": eng.slot_history,
           "preemptions": rep["preemptions"],
           "load_balance": rep["load_balance"], "moe": rep["moe"],
           "moe_policy": rep["engine"]["moe_policy"],
           "decode_steps": rep["decode_steps"]}
    out[policy] = np.array(json.dumps(res, default=int))
np.savez(OUT, **out)
'''


def _trace():
    rng = np.random.default_rng(3)
    return [Request(rid=i, tokens=rng.integers(
                0, 512, (int(rng.integers(3, L + 1)),)).astype(np.int32),
                max_new_tokens=GEN, arrival_time=0.3 * i) for i in range(6)]


def port_cfg():
    cfg = TORCH_QWEN.reduced()
    return dataclasses.replace(cfg, moe=dataclasses.replace(cfg.moe,
                                                            q_tokens=1))


@pytest.fixture(scope="module")
def jax_engine(tmp_path_factory):
    body = (f"import numpy as np\nG = {G}\nKW = {KW!r}\n"
            f"POLICIES = {POLICIES!r}\n" + JAX_BODY)
    flat = run_jax(body, tmp_path_factory.mktemp("eng") / "engine.npz",
                   timeout=600)
    params = to_torch(unflatten(flat, "params"), device="cpu")
    return params, {p: json.loads(str(flat[p])) for p in POLICIES}


def run_port(params, policy, *, ep_degree=G, cfg=None):
    cfg = cfg or port_cfg()
    model = build_model(cfg, batch=SLOTS, seq_len=L, device="cpu",
                        ep_degree=ep_degree)
    eng = ServeEngine(model, params, engine_config_for(
        cfg, paged=True, moe_policy=policy, **KW), clock=VirtualClock(0.1),
        device="cpu")
    out, rep = captured_run(eng, _trace())
    return eng, out, rep


@pytest.mark.parametrize("policy", POLICIES)
def test_engine_g4_matches_jax_engine(jax_engine, policy):
    params, jax_res = jax_engine
    want = jax_res[policy]
    eng, out, rep = run_port(params, policy)
    assert rep["n_requests"] == 6
    assert {str(k): v for k, v in out.items()} == want["streams"]
    assert [list(h) for h in eng.front.slot_history] == want["slot_history"]
    assert rep["preemptions"] == want["preemptions"]
    assert rep["decode_steps"] == want["decode_steps"]
    assert rep["engine"]["moe_policy"] == want["moe_policy"] == policy
    assert rep["load_balance"] == want["load_balance"]
    assert rep["moe"].keys() == want["moe"].keys()
    lb = rep["load_balance"]["decode"]
    assert lb["send_drops_total"] == lb["dest_drops_total"] == 0
    assert len(lb["rank_load_mean"]) == G
    if policy == "harmoeny":
        assert rep["moe"]["decode/moved_units"] > 0
