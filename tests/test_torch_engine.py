"""The PyTorch port's serve engine against the JAX ``ServeEngine`` (paged,
fused flags off) on the same request trace and converted weights under a
``VirtualClock``: greedy streams token-identical, same admission and
preemption order, same timestamps.  Plus the port's import hygiene and
its CUDA-by-default entry points."""
import os
import subprocess
import sys

import jax
import numpy as np
import pytest
import torch

from repro.configs.base import ParallelConfig as JPC
from repro.configs.qwen15_moe_a27b import CONFIG as JAX_QWEN
from repro.launch.mesh import make_host_mesh
from repro.models.model import MeshShape
from repro.models.model import build_model as jax_build
from repro.serve import Request as JRequest
from repro.serve import ServeEngine as JEngine
from repro.serve import VirtualClock as JClock
from repro.serve import engine_config_for as jax_ecfg
from repro_torch.configs.qwen15_moe_a27b import CONFIG as TORCH_QWEN
from repro_torch.convert import to_torch
from repro_torch.models.model import build_model
from repro_torch.serve import (EngineConfig, Request, ServeEngine,
                               VirtualClock, engine_config_for)

from _serve_helpers import captured_run

SRC = os.path.join(os.path.dirname(__file__), "..", "src")
SLOTS, L, GEN, C = 3, 12, 6, 4


def _trace(make):
    rng = np.random.default_rng(3)
    return [make(rid=i, tokens=rng.integers(
                0, 512, (int(rng.integers(3, L + 1)),)).astype(np.int32),
                 max_new_tokens=GEN, arrival_time=0.3 * i)
            for i in range(6)]


@pytest.fixture(scope="module")
def weights():
    jc = JAX_QWEN.reduced()
    mesh = make_host_mesh(1, 1)
    ms = MeshShape(tuple(zip(mesh.axis_names, mesh.devices.shape)))
    jm = jax_build(jc, JPC(attn_chunk=8, loss_chunk=8), batch=SLOTS,
                   seq_len=L, mesh_shape=ms, mesh=mesh)
    with mesh:
        jp = jm.init(jax.random.PRNGKey(0))
    return mesh, jm, jp, to_torch(jax.device_get(jp), device="cpu")


@pytest.mark.parametrize("num_kv_blocks", [0, 7])   # 7 forces preemption
def test_engine_streams_match_jax_engine(weights, num_kv_blocks):
    mesh, jm, jp, tp = weights
    kw = dict(max_slots=SLOTS, prompt_len=L, max_new_tokens=GEN,
              prefill_chunk=C, kv_block_size=4, num_kv_blocks=num_kv_blocks)
    je = JEngine(jm, jp, jax_ecfg(jm.cfg, paged=True, **kw), mesh=mesh,
                 clock=JClock(0.1))
    with mesh:
        out_j, rep_j = captured_run(je, _trace(JRequest))
    tm = build_model(TORCH_QWEN.reduced(), batch=SLOTS, seq_len=L,
                     device="cpu")
    te = ServeEngine(tm, tp, engine_config_for(tm.cfg, paged=True, **kw),
                     clock=VirtualClock(0.1), device="cpu")
    out_t, rep_t = captured_run(te, _trace(Request))
    assert rep_t["n_requests"] == rep_j["n_requests"] == 6
    assert out_t == out_j                              # token-identical
    assert te.front.slot_history == je.slot_history    # admission order
    assert rep_t["preemptions"] == rep_j["preemptions"]
    if num_kv_blocks:
        assert rep_t["preemptions"] > 0
    for a, b in zip(rep_t["requests"], rep_j["requests"]):
        for key in ("rid", "ttft", "tpot", "e2e", "queue_delay"):
            assert a[key] == pytest.approx(b[key]), key
    for key in ("decode_steps", "prefill_chunks", "max_occupancy"):
        assert rep_t[key] == rep_j[key], key
    assert rep_t["moe"].keys() == rep_j["moe"].keys()
    assert te._alloc.blocks_in_use == 0                # all reclaimed
    cpu = {"fused": False, "requested": False,
           "reason": "the plain version runs on the CPU"}
    assert rep_t["attention_dispatch"] == {"prefill_continue": cpu,
                                           "decode": cpu}
    assert rep_t["attention_fallbacks"] == {}


def test_fused_attention_flag_is_the_requested_key(weights):
    """``fused_paged_attention`` is what the JAX log calls ``requested``:
    on the CPU, where the plain versions run, every record of a branch it
    asked a kernel of is a fallback, and the streams are the flag-off
    ones."""
    tp = weights[3]
    kw = dict(max_slots=SLOTS, prompt_len=L, max_new_tokens=GEN,
              prefill_chunk=C, kv_block_size=4, paged=True)
    outs, reps = {}, {}
    for on in (False, True):
        tm = build_model(TORCH_QWEN.reduced(), batch=SLOTS, seq_len=L,
                         device="cpu")
        te = ServeEngine(tm, tp, engine_config_for(
            tm.cfg, fused_paged_attention=on, **kw),
            clock=VirtualClock(0.1), device="cpu")
        outs[on], reps[on] = captured_run(te, _trace(Request))
    assert outs[True] == outs[False]
    assert reps[False]["attention_fallbacks"] == {}
    dispatch = reps[True]["attention_dispatch"]
    assert {b: d["requested"] for b, d in dispatch.items()} \
        == {"prefill_continue": True, "decode": True}
    assert not any(d["fused"] for d in dispatch.values())
    fallbacks = reps[True]["attention_fallbacks"]
    assert set(fallbacks) == {"prefill_continue", "decode"}
    assert min(fallbacks.values()) > 0


def test_port_imports_no_jax_and_no_reference_package():
    code = (
        "import pkgutil, sys, importlib, repro_torch\n"
        "for m in pkgutil.walk_packages(repro_torch.__path__, 'repro_torch.'):\n"
        "    importlib.import_module(m.name)\n"
        "bad = [m for m in sys.modules if m == 'jax' or m.startswith('jax.')\n"
        "       or m == 'repro' or m.startswith('repro.')]\n"
        "assert not bad, bad\n"
        "print(len([m for m in sys.modules if m.startswith('repro_torch')]))\n")
    env = dict(os.environ, PYTHONPATH=os.path.abspath(SRC))
    res = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, env=env, timeout=120)
    assert res.returncode == 0, res.stderr
    assert int(res.stdout.strip()) > 20


def test_entry_points_default_to_cuda():
    if torch.cuda.is_available():
        pytest.skip("a GPU is present: the CUDA default does not raise")
    cfg = TORCH_QWEN.reduced()
    with pytest.raises(RuntimeError, match="CUDA"):
        build_model(cfg, batch=1, seq_len=8)
    model = build_model(cfg, batch=1, seq_len=8, device="cpu")
    with pytest.raises(RuntimeError, match="CUDA"):
        ServeEngine(model, {}, EngineConfig())
    with pytest.raises(RuntimeError, match="CUDA"):
        to_torch({"w": np.zeros((2, 2), np.float32)})
    from repro_torch.core.dispatch import VirtualGroup
    with pytest.raises(RuntimeError, match="CUDA"):
        VirtualGroup(4)
    with pytest.raises(RuntimeError, match="CUDA"):
        build_model(cfg, batch=1, seq_len=8, ep_degree=4)


def test_engine_config_defaults_equal_jax():
    """The port's ``EngineConfig`` defaults to the slab pool, as the JAX
    engine does, and every field it has defaults to the JAX value."""
    import dataclasses
    from repro.serve import EngineConfig as JEngineConfig
    assert EngineConfig().paged is False
    ours, theirs = EngineConfig(), JEngineConfig()
    for f in dataclasses.fields(EngineConfig):
        assert getattr(ours, f.name) == getattr(theirs, f.name), f.name
    cfg = TORCH_QWEN.reduced()
    assert engine_config_for(cfg, max_slots=2, prompt_len=8,
                             max_new_tokens=4).paged is False


@pytest.mark.parametrize("field,value", [
    ("role", "prefill"), ("prefix_sharing", True),
    ("speculative_k", 2), ("temperature", 0.7), ("replica_slots", 1),
    ("rebalance_interval", 2), ("resident_experts", 4),
    ("moe_policy", "fastest"), ("temperature", -1.0), ("top_p", 0.0)])
def test_unported_engine_fields_raise(field, value):
    """Every field is ported and validates as the JAX engine's:
    ``moe_policy``'s unknown policy is a ValueError; an interval without
    replica slots, a negative temperature, a top_p of 0, or a split role,
    prefix sharing or speculation on the slab is the JAX ValueError, word
    for word, and a legal value is kept (the split roles, sharing and
    speculation on the paged pool)."""
    if field in ("replica_slots", "rebalance_interval", "resident_experts",
                 "temperature", "top_p", "prefix_sharing",
                 "speculative_k", "role"):
        from repro.serve import EngineConfig as JEngineConfig
        try:
            JEngineConfig(**{field: value})
        except ValueError as jerr:
            if field in ("prefix_sharing", "speculative_k", "role"):
                with pytest.raises(ValueError) as err:
                    EngineConfig(**{field: value})
                assert str(err.value) == str(jerr)
                for cls in (EngineConfig, JEngineConfig):
                    assert getattr(cls(**{field: value}, paged=True),
                                   field) == value
            else:
                with pytest.raises(ValueError, match=field):
                    EngineConfig(**{field: value})
        else:
            assert getattr(EngineConfig(**{field: value}), field) == value
        return
    with pytest.raises(ValueError, match=field):
        EngineConfig(**{field: value})
    for policy in ("harmoeny", "round_robin", "even_split", "static_opt"):
        assert EngineConfig(moe_policy=policy).moe_policy == policy
