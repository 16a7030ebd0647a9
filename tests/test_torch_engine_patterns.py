"""The port's ``ServeEngine`` against the JAX ``ServeEngine`` (fused flags
off) across layer patterns and both KV pools: reduced qwen15-moe-a27b
(every layer MoE), moonshot-v1-16b-a3b (a leading dense layer) and
switch128 (dense/MoE periods, GELU MLPs, gateless top-1 experts), on the
slab (the default of both engines) and paged, plus one paged case per
model whose ``num_kv_blocks`` forces preemption (qwen's two paged cases
are ``tests/test_torch_engine.py``'s).  Same request trace as
``tests/test_torch_engine.py``, converted weights, a ``VirtualClock``:
greedy streams, admission order, preemptions, per-request timestamps,
step counts, attention dispatch and pool kind must be equal."""
import jax
import pytest

from repro.configs.base import ParallelConfig as JPC
from repro.configs.registry import get_config as jax_config
from repro.launch.mesh import make_host_mesh
from repro.models.model import MeshShape
from repro.models.model import build_model as jax_build
from repro.serve import Request as JRequest
from repro.serve import ServeEngine as JEngine
from repro.serve import VirtualClock as JClock
from repro.serve import engine_config_for as jax_ecfg
from repro_torch.configs.registry import get_config
from repro_torch.convert import to_torch
from repro_torch.models.model import build_model
from repro_torch.serve import (Request, ServeEngine, VirtualClock,
                               engine_config_for)

from _serve_helpers import captured_run
from test_torch_engine import C, GEN, L, SLOTS, _trace

# (arch, pool, num_kv_blocks): 7 blocks of 4 tokens force preemption
CASES = [("qwen15-moe-a27b", "slab", 0)] + [
    (arch, pool, n) for arch in ("moonshot-v1-16b-a3b", "switch128")
    for pool, n in (("slab", 0), ("paged", 0), ("paged", 7))]


@pytest.fixture(scope="module")
def weights(request):
    arch = request.param
    mesh = make_host_mesh(1, 1)
    ms = MeshShape(tuple(zip(mesh.axis_names, mesh.devices.shape)))
    jm = jax_build(jax_config(arch).reduced(), JPC(attn_chunk=8, loss_chunk=8),
                   batch=SLOTS, seq_len=L, mesh_shape=ms, mesh=mesh)
    with mesh:
        jp = jm.init(jax.random.PRNGKey(0))
    return arch, mesh, jm, jp, to_torch(jax.device_get(jp), device="cpu")


@pytest.mark.parametrize("weights,pool,num_kv_blocks", CASES,
                         indirect=["weights"])
def test_engine_matches_jax_engine(weights, pool, num_kv_blocks):
    arch, mesh, jm, jp, tp = weights
    kw = dict(max_slots=SLOTS, prompt_len=L, max_new_tokens=GEN,
              prefill_chunk=C, kv_block_size=4, num_kv_blocks=num_kv_blocks,
              paged=pool == "paged")
    je = JEngine(jm, jp, jax_ecfg(jm.cfg, **kw), mesh=mesh,
                 clock=JClock(0.1))
    with mesh:
        out_j, rep_j = captured_run(je, _trace(JRequest))
    tm = build_model(get_config(arch).reduced(), batch=SLOTS, seq_len=L,
                     device="cpu")
    te = ServeEngine(tm, tp, engine_config_for(tm.cfg, **kw),
                     clock=VirtualClock(0.1), device="cpu")
    out_t, rep_t = captured_run(te, _trace(Request))
    assert rep_t["n_requests"] == rep_j["n_requests"] == 6
    assert out_t == out_j                              # token-identical
    assert te.front.slot_history == je.slot_history    # admission order
    assert rep_t["preemptions"] == rep_j["preemptions"]
    assert (rep_t["preemptions"] > 0) == (num_kv_blocks > 0)
    for a, b in zip(rep_t["requests"], rep_j["requests"]):
        for key in ("rid", "ttft", "tpot", "e2e", "queue_delay"):
            assert a[key] == pytest.approx(b[key]), key
    for key in ("decode_steps", "prefill_chunks", "max_occupancy"):
        assert rep_t[key] == rep_j[key], key
    for key in ("fused", "requested"):          # the JAX log's keys
        assert {b: d[key] for b, d in rep_t["attention_dispatch"].items()} \
            == {b: d[key] for b, d in rep_j["attention_dispatch"].items()}
    assert rep_t["attention_fallbacks"] == rep_j["attention_fallbacks"]
    decode = "decode" if pool == "paged" else "decode_slab"
    assert set(rep_t["attention_dispatch"]) == {"prefill_continue", decode}
    assert rep_t["state_pool"]["kind"] == rep_j["state_pool"]["kind"] == pool
    assert rep_t["engine"]["paged"] == rep_j["engine"]["paged"]
    for key in ("num_kv_blocks", "blocks_per_slot", "kv_capacity"):
        assert rep_t["engine"].get(key) == rep_j["engine"].get(key), key
    if pool == "paged":
        assert te._alloc.blocks_in_use == 0            # all reclaimed
