"""Reduced mixtral-8x7b served by the port against the JAX ``ServeEngine``.

The reduced config (4 q and 4 kv heads of 32, 8 experts top-2, which puts
2 experts on each of 4 EP ranks) keeps mixtral's sliding window, cut to
64.  Cells: the window at 64 and
replaced by 0 on both sides, on the slab (prompts that fit the clamped
cache, decode that wraps it) and paged (prompts past the window: the
ring), at G = 1 with learned routing and on ``VirtualGroup(4)`` against
a (1, 4) mesh under the paper's 0.9 skew with q = 1, the JAX engine's
skew draws replayed by call index.  Three JAX subprocesses on four
emulated host devices (G = 1; G = 4 at each window) serve the cells side
by side and record their weights, streams and draws; the port serves the same trace on the
converted weights.  Greedy
streams, admission order, preemptions, step counts,
``report()["load_balance"]``, the state pool and the attention dispatch
must be equal.  Also: the registry's copy of the config and
``convert.expert_shard``'s 2 experts a rank."""
import dataclasses
import json
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import pytest
import torch

from repro.configs.mixtral_8x7b import CONFIG as JAX_MIXTRAL
from repro_torch.configs.registry import REGISTRY, get_config
from repro_torch.convert import expert_shard, to_torch
from repro_torch.models.model import build_model
from repro_torch.serve import Request, ServeEngine, VirtualClock, \
    engine_config_for

from _ep_helpers import (FLATTEN_SRC, SAMPLING_RECORD_SRC,  # noqa: F401
                         one_torch_thread, replay_on, run_jax, unflatten)
from _serve_helpers import captured_run

POOLS = {"slab": dict(max_slots=3, prompt_len=64, max_new_tokens=10,
                      prefill_chunk=16),
         "paged": dict(max_slots=3, prompt_len=80, max_new_tokens=6,
                       prefill_chunk=16, kv_block_size=16, paged=True)}
CELLS = [(g, w, pool) for g in (1, 4) for w in (64, 0) for pool in POOLS]

JAX_BODY = FLATTEN_SRC + SAMPLING_RECORD_SRC + '''
import dataclasses, json
import jax
from repro.configs.base import ParallelConfig
from repro.configs.mixtral_8x7b import CONFIG
from repro.launch.mesh import make_host_mesh
from repro.models.model import MeshShape, build_model
from repro.serve import Request, ServeEngine, VirtualClock, engine_config_for
out = {}
if True:
    base = CONFIG.reduced()
    if G > 1:
        base = dataclasses.replace(base, moe=dataclasses.replace(
            base.moe, q_tokens=1, router_skew=0.9))
    mesh = make_host_mesh(1, G)
    ms = MeshShape(tuple(zip(mesh.axis_names, mesh.devices.shape)))
    params = None
    for window in WINDOWS:
        cfg = base.replace(sliding_window=window)
        model = build_model(cfg, ParallelConfig(attn_chunk=8, loss_chunk=8),
                            batch=3, seq_len=80, mesh_shape=ms, mesh=mesh)
        if params is None:
            with mesh:
                params = model.init(jax.random.PRNGKey(0))
            out.update(flatten(jax.device_get(params), f"g{G}/params/"))
        draws = make_skew_draws(cfg, model, G) if G > 1 else None
        for pool, kw in POOLS.items():
            rng = np.random.default_rng(3)
            reqs = [Request(rid=i, tokens=rng.integers(
                        0, 512, (int(rng.integers(20, kw["prompt_len"] + 1)),)
                    ).astype(np.int32), max_new_tokens=kw["max_new_tokens"],
                    arrival_time=0.3 * i) for i in range(5)]
            eng = ServeEngine(model, params, engine_config_for(cfg, **kw),
                              mesh=mesh, clock=VirtualClock(0.1))
            rec = record_sampling(eng, 1, draws)
            with mesh:
                rep = eng.run(reqs)
            rec.update(report=rep, slot_history=eng.slot_history)
            out[f"g{G}_w{window}_{pool}"] = np.array(json.dumps(rec,
                                                                default=int))
np.savez(OUT, **out)
'''


@pytest.fixture(scope="module")
def jax_cells(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("mixtral")

    def one(job):
        G, windows = job
        body = (f"import numpy as np\nPOOLS = {POOLS!r}\nG = {G}\n"
                f"WINDOWS = {windows!r}\n" + JAX_BODY)
        return run_jax(body, tmp / f"mixtral{G}_{windows[0]}.npz",
                       timeout=600)
    flat = {}
    with ThreadPoolExecutor(3) as pool:
        for part in pool.map(one, [(1, (64, 0)), (4, (64,)), (4, (0,))]):
            flat.update(part)
    params = {G: to_torch(unflatten(flat, f"g{G}/params"), device="cpu")
              for G in (1, 4)}
    recs = {c: json.loads(str(flat[f"g{c[0]}_w{c[1]}_{c[2]}"]))
            for c in CELLS}
    return params, recs


def _cfg(G, window):
    cfg = get_config("mixtral-8x7b").reduced().replace(sliding_window=window)
    if G > 1:
        cfg = dataclasses.replace(cfg, moe=dataclasses.replace(
            cfg.moe, q_tokens=1, router_skew=0.9))
    return cfg


def _trace(kw):
    rng = np.random.default_rng(3)
    return [Request(rid=i, tokens=rng.integers(
                0, 512, (int(rng.integers(20, kw["prompt_len"] + 1)),)
            ).astype(np.int32), max_new_tokens=kw["max_new_tokens"],
            arrival_time=0.3 * i) for i in range(5)]


@pytest.mark.parametrize("G,window,pool", CELLS,
                         ids=[f"g{g}-w{w}-{p}" for g, w, p in CELLS])
def test_mixtral_engine_matches_jax_engine(jax_cells, G, window, pool):
    params, recs = jax_cells
    rec = recs[(G, window, pool)]
    jrep = rec["report"]
    cfg = _cfg(G, window)
    kw = POOLS[pool]
    model = build_model(cfg, batch=3, seq_len=80, device="cpu",
                        ep_degree=G)
    eng = ServeEngine(model, params[G], engine_config_for(cfg, **kw),
                      clock=VirtualClock(0.1), device="cpu")
    if G > 1:
        replay_on(eng, rec)
        assert rec["draws"]["decode"]
    out, rep = captured_run(eng, _trace(kw))
    assert rep["n_requests"] == jrep["n_requests"] == 5
    assert {str(k): v for k, v in out.items()} == rec["streams"]
    assert [list(h) for h in eng.front.slot_history] == rec["slot_history"]
    for key in ("preemptions", "decode_steps", "prefill_chunks",
                "max_occupancy"):
        assert rep[key] == jrep[key], key
    assert rep["load_balance"] == jrep["load_balance"]
    assert rep["state_pool"] == jrep["state_pool"]
    assert rep["engine"]["kv_capacity"] == jrep["engine"]["kv_capacity"]
    assert {b: d["fused"] for b, d in rep["attention_dispatch"].items()} \
        == {b: d["fused"] for b, d in jrep["attention_dispatch"].items()}
    ring = window > 0 and pool == "paged"
    assert rep["state_pool"].get("window_ring", False) == ring
    if ring:
        assert rep["state_pool"]["ring_full_chain"]
        assert set(rep["attention_dispatch"]) == {"prefill_continue",
                                                  "decode_ring"}
    if G > 1:
        lb = rep["load_balance"]["decode"]
        assert lb["send_drops_total"] == lb["dest_drops_total"] == 0
        assert rep["moe"]["decode/moved_units"] > 0


def test_registry_config_is_jax_config():
    cfg = REGISTRY["mixtral-8x7b"]
    for f in dataclasses.fields(cfg):
        if f.name not in ("moe", "ssm"):
            assert getattr(cfg, f.name) == getattr(JAX_MIXTRAL, f.name), \
                f.name
    assert dataclasses.asdict(cfg.moe) == dataclasses.asdict(JAX_MIXTRAL.moe)
    red = cfg.reduced()
    assert red.sliding_window == min(cfg.sliding_window, 64) == 64
    assert red.sliding_window == JAX_MIXTRAL.reduced().sliding_window
    assert (red.num_heads, red.num_kv_heads, red.moe.num_experts,
            red.moe.num_experts_per_tok) == (4, 4, 8, 2)


def test_expert_shard_gives_two_experts_a_rank(jax_cells):
    """The converted G = 4 weights (untied ``lm_head``, 8 stacked experts
    a layer) cut into 4 ranks of 2 experts, each rank's rows those of the
    rank-major leaf."""
    params, _ = jax_cells
    p = params[4]
    assert "lm_head" in p
    moe = p["stack"]["blocks"]["sub0"]["moe"]
    assert moe["w_in"].shape[1] == 8
    for g in range(4):
        cut = expert_shard(moe, g, 4, axis=1)
        assert torch.equal(cut["router"], moe["router"])
        for name in ("w_in", "w_out", "w_gate"):
            assert cut[name].shape[1] == 2
            assert torch.equal(cut[name], moe[name][:, 2 * g:2 * g + 2])
