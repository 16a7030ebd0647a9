"""The port's truncated sampling against the JAX package's.

``sample_tokens`` takes the Gumbel draw that ``jax.random.categorical``
adds as a tensor; fed JAX's own draw for the key, it must give JAX's
tokens exactly, on random and on tie-heavy logits, over a grid of
temperature, ``top_k`` and ``top_p``.  ``sample_np`` (the host twin that
draws a prompt's first token) and ``truncated_probs_np`` are numpy
copies and must give the reference's tokens and candidate sets.  Then the
engines: a JAX ``ServeEngine`` and the port's, on converted weights, the
port replaying the JAX engine's per-step noise (and, at G = 4 under skew,
its skew draws), give equal sampled streams on the slab, paged and across
four virtual EP ranks; ``top_k = 1`` gives the greedy stream."""
import dataclasses
import json

import jax
import jax.numpy as jnp
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
from repro.serve import sampling as JS
from repro_torch.configs.qwen15_moe_a27b import CONFIG as TORCH_QWEN
from repro_torch.convert import to_torch
from repro_torch.models.model import build_model
from repro_torch.serve import Request, ServeEngine, VirtualClock, \
    engine_config_for
from repro_torch.serve import sampling as TS

from _ep_helpers import (FLATTEN_SRC, SAMPLING_RECORD_SRC,  # noqa: F401
                         one_torch_thread, replay_on, run_jax, unflatten)
from _serve_helpers import captured_run

exec(SAMPLING_RECORD_SRC)

SLOTS, L, GEN, C = 3, 12, 6, 4
B, V = 16, 48


def _logits(kind, seed=0):
    rng = np.random.default_rng(seed)
    if kind == "random":
        return rng.normal(size=(B, V)).astype(np.float32)
    # tie-heavy: four distinct values, exact ties across each row
    return (rng.integers(0, 4, size=(B, V)) * 0.5).astype(np.float32)


@pytest.mark.parametrize("top_p", [1.0, 0.9, 0.5])
@pytest.mark.parametrize("top_k", [0, 1, 5, V + 3])
@pytest.mark.parametrize("kind", ["random", "ties"])
def test_sample_tokens_equals_jax_on_its_noise(kind, top_k, top_p):
    lg = _logits(kind)
    for temperature in (0.5, 1.0, 1.7):
        kw = dict(temperature=temperature, top_k=top_k, top_p=top_p)
        for seed in range(3):
            key = jax.random.PRNGKey(seed)
            want = np.asarray(JS.sample_tokens(jnp.asarray(lg), key, **kw))
            noise = np.asarray(jax.random.gumbel(
                key, (B, TS.noise_width(V, top_k)), jnp.float32))
            got = TS.sample_tokens(torch.from_numpy(lg),
                                   torch.from_numpy(noise.copy()), **kw)
            np.testing.assert_array_equal(got.numpy(), want,
                                          err_msg=f"{kw} seed {seed}")
    # greedy: no noise, or temperature 0, is jnp.argmax (lowest index)
    want = np.asarray(JS.sample_tokens(jnp.asarray(lg), None))
    assert np.array_equal(TS.sample_tokens(torch.from_numpy(lg)).numpy(),
                          want)
    assert np.array_equal(TS.sample_tokens(
        torch.from_numpy(lg), torch.zeros((B, V)), temperature=0.0).numpy(),
        want)


@pytest.mark.parametrize("kind", ["random", "ties"])
def test_sample_np_equals_jax_for_the_same_rng(kind):
    lg = _logits(kind, seed=1)
    for kw in (dict(temperature=0.0), dict(temperature=0.8),
               dict(temperature=1.0, top_k=5),
               dict(temperature=1.3, top_p=0.6),
               dict(temperature=0.7, top_k=9, top_p=0.8),
               dict(temperature=1.0, top_k=V + 3, top_p=0.5)):
        r_j, r_t = np.random.default_rng(7), np.random.default_rng(7)
        for row in lg:
            assert TS.sample_np(row, r_t, **kw) == JS.sample_np(row, r_j,
                                                                **kw), kw


# the tie cases of tests/test_sampling_twins.py
TIE_CASES = [
    (np.array([0., 1.] * 4), dict(temperature=1.0, top_k=2)),
    (np.array([0., 1.] * 4), dict(temperature=1.0, top_k=3)),
    (np.array([0., 1.] * 4), dict(temperature=1.0, top_k=4)),
    (np.where(np.arange(32) % 2 == 0, 1.0, 0.0),
     dict(temperature=1.0, top_p=0.3)),
    (np.array([0., 1.] * 8), dict(temperature=1.0, top_k=6, top_p=0.5)),
    (np.random.default_rng(3).normal(size=24),
     dict(temperature=0.7, top_k=5)),
    (np.random.default_rng(3).normal(size=24),
     dict(temperature=1.3, top_p=0.8)),
    (np.random.default_rng(3).normal(size=24),
     dict(temperature=1.0, top_k=8, top_p=0.6)),
]


@pytest.mark.parametrize("case", range(len(TIE_CASES)))
def test_kept_candidates_equal_the_reference_on_tie_cases(case):
    """The host twin keeps the reference's candidates, and the device
    sampler can emit exactly those: its draw over many noise rows lands
    only on them and on each of them."""
    logits, kw = TIE_CASES[case]
    keep_t, p_t = TS.truncated_probs_np(logits, **kw)
    keep_j, p_j = JS.truncated_probs_np(logits, **kw)
    np.testing.assert_array_equal(keep_t, keep_j)
    np.testing.assert_array_equal(p_t, p_j)
    n = 2048
    lg = torch.tensor(logits, dtype=torch.float32).expand(n, -1)
    noise = TS.gumbel_(torch.empty((n, TS.noise_width(
        len(logits), kw.get("top_k", 0)))), torch.Generator().manual_seed(0))
    support = set(TS.sample_tokens(lg, noise, **kw).tolist())
    assert support == set(keep_j.tolist())


def test_gumbel_noise_is_finite_and_standard():
    g = torch.Generator().manual_seed(0)
    x = TS.gumbel_(torch.empty((200_000,)), g)
    assert torch.isfinite(x).all()
    # a standard Gumbel's mean is the Euler-Mascheroni constant
    assert abs(float(x.mean()) - 0.5772) < 0.01
    assert abs(float(x.var()) - np.pi ** 2 / 6) < 0.03


# ----------------------------------------------------------------------
# the engines at G = 1 (JAX in this process) and G = 4 (a subprocess)
# ----------------------------------------------------------------------
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


CELLS = {
    "slab": dict(temperature=0.8, top_k=5, top_p=0.9),
    "paged": dict(paged=True, temperature=1.0, top_p=0.8),
    "paged_preempt": dict(paged=True, num_kv_blocks=7, temperature=0.7,
                          top_k=9),
    "top_k_1": dict(paged=True, temperature=0.9, top_k=1),
}


@pytest.mark.parametrize("cell", list(CELLS))
def test_sampled_engine_streams_equal_jax(weights, cell):
    mesh, jm, jp, tp = weights
    kw = dict(max_slots=SLOTS, prompt_len=L, max_new_tokens=GEN,
              prefill_chunk=C, kv_block_size=4, skew_seed=5, **CELLS[cell])
    tcfg = TORCH_QWEN.reduced()
    width = TS.noise_width(tcfg.padded_vocab, kw.get("top_k", 0))
    je = JEngine(jm, jp, jax_ecfg(jm.cfg, **kw), mesh=mesh,
                 clock=JClock(0.1))
    rec = record_sampling(je, width)
    with mesh:
        rep_j = je.run(_trace(JRequest))
    tm = build_model(tcfg, batch=SLOTS, seq_len=L, device="cpu")
    te = ServeEngine(tm, tp, engine_config_for(tcfg, **kw),
                     clock=VirtualClock(0.1), device="cpu")
    replay_on(te, rec)
    out_t, rep_t = captured_run(te, _trace(Request))
    assert rep_t["n_requests"] == rep_j["n_requests"] == 6
    assert out_t == {int(k): v for k, v in rec["streams"].items()}
    assert rep_t["preemptions"] == rep_j["preemptions"]
    if cell == "paged_preempt":
        assert rep_t["preemptions"] > 0
    greedy = ServeEngine(tm, tp, engine_config_for(
        tcfg, **{**kw, "temperature": 0.0}), clock=VirtualClock(0.1),
        device="cpu")
    out_g, _ = captured_run(greedy, _trace(Request))
    # top_k = 1 is greedy; otherwise the draws must leave the argmax
    assert (out_t == out_g) == (cell == "top_k_1")


G = 4
EP_KW = dict(max_slots=SLOTS, prompt_len=L, max_new_tokens=GEN,
             prefill_chunk=C, kv_block_size=4, paged=True, skew_seed=2,
             temperature=0.8, top_k=7, top_p=0.9)

EP_BODY = FLATTEN_SRC + SAMPLING_RECORD_SRC + '''
import dataclasses, json
import jax
from repro.configs.base import ParallelConfig
from repro.configs.qwen15_moe_a27b import CONFIG
from repro.launch.mesh import make_host_mesh
from repro.models.model import MeshShape, build_model
from repro.serve import Request, ServeEngine, VirtualClock, engine_config_for
cfg = CONFIG.reduced()
cfg = dataclasses.replace(cfg, moe=dataclasses.replace(
    cfg.moe, q_tokens=1, router_skew=0.9))
mesh = make_host_mesh(1, G)
ms = MeshShape(tuple(zip(mesh.axis_names, mesh.devices.shape)))
model = build_model(cfg, ParallelConfig(attn_chunk=8, loss_chunk=8),
                    batch=KW["max_slots"], seq_len=KW["prompt_len"],
                    mesh_shape=ms, mesh=mesh)
with mesh:
    params = model.init(jax.random.PRNGKey(0))
out = flatten(jax.device_get(params), "params/")
rng = np.random.default_rng(3)
reqs = [Request(rid=i, tokens=rng.integers(
            0, 512, (int(rng.integers(3, KW["prompt_len"] + 1)),)
        ).astype(np.int32), max_new_tokens=KW["max_new_tokens"],
        arrival_time=0.3 * i) for i in range(6)]
eng = ServeEngine(model, params, engine_config_for(cfg, **KW), mesh=mesh,
                  clock=VirtualClock(0.1))
rec = record_sampling(eng, WIDTH, make_skew_draws(cfg, model, G))
with mesh:
    rep = eng.run(reqs)
rec["load_balance"] = rep["load_balance"]
out["rec"] = np.array(json.dumps(rec, default=int))
np.savez(OUT, **out)
'''


def test_sampled_engine_streams_equal_jax_at_ep4_under_skew(tmp_path):
    """Four virtual EP ranks, HarMoEny under 0.9 skew, sampled: the skew
    draws and the noise split from one key a step as in JAX, and both are
    replayed, so streams and load balance equal the JAX engine's on a
    (1, 4) mesh."""
    tcfg = TORCH_QWEN.reduced()
    width = TS.noise_width(tcfg.padded_vocab, EP_KW["top_k"])
    body = (f"import numpy as np\nG = {G}\nKW = {EP_KW!r}\n"
            f"WIDTH = {width}\n" + EP_BODY)
    flat = run_jax(body, tmp_path / "ep.npz")
    rec = json.loads(str(flat["rec"]))
    assert rec["draws"]["decode"] and rec["noise"]
    tcfg = dataclasses.replace(tcfg, moe=dataclasses.replace(
        tcfg.moe, q_tokens=1, router_skew=0.9))
    model = build_model(tcfg, batch=SLOTS, seq_len=L, device="cpu",
                        ep_degree=G)
    params = to_torch(unflatten(flat, "params"), device="cpu")
    eng = ServeEngine(model, params, engine_config_for(tcfg, **EP_KW),
                      clock=VirtualClock(0.1), device="cpu")
    replay_on(eng, rec)
    out, rep = captured_run(eng, _trace(Request))
    assert out == {int(k): v for k, v in rec["streams"].items()}
    for phase, sec in rec["load_balance"].items():
        for key, want in sec.items():
            np.testing.assert_allclose(rep["load_balance"][phase][key],
                                       want, err_msg=f"{phase} {key}")
