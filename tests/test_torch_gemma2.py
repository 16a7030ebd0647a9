"""gemma2-2b in the port against the JAX package, on the CPU, on weights
converted from JAX and inputs drawn from a seed (reduced: 4 layers, two
periods of a local layer with a 64-position window and a global layer,
softcaps 50 and 30, post-norms, the gated GELU, f32).

- The gated GELU, a local and a global layer with their post-norms
  (``transformer._apply_one_layer``), the embedding scale (f32 and bf16,
  bit-equal), and one local and one global ``attention_block`` with the
  softcap on the slab: a whole prompt past the window, then a decode step.
- ``model.prefill`` and two ``decode_step``s (``test_arch_smoke_decode``'s
  calls), prefill/decode consistency (``test_prefill_decode_consistency``
  for gemma2-2b), and ``prefill_chunk`` on the unclamped scratch across
  the window, each within 2e-5 of JAX's.
- ``ServeEngine`` greedy streams equal the JAX engine's on the slab (the
  local leaves clamped to the window, decode wrapping them) and on the
  paged pool with prompts past the window: the local leaves wrap rings of
  64 positions, the global leaves keep full chains (``ring_full_chain``
  False), plus a preempting pool.
- The window ring's blockers, word for word, and the CLI at ``--arch
  gemma2-2b`` on the paged pool against the JAX CLI's engine."""
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jax_config
from repro.configs.base import ParallelConfig as JPC
from repro.launch import serve as JCLI
from repro.launch.mesh import make_host_mesh
from repro.models import attention as JA
from repro.models import layers as JL
from repro.models import transformer as JT
from repro.models.model import MeshShape
from repro.models.model import build_model as jax_build
from repro.serve import Request as JRequest
from repro.serve import ServeEngine as JEngine
from repro.serve import VirtualClock as JClock
from repro.serve import engine_config_for as jax_ecfg
from repro.serve import poisson_requests as jax_requests
from repro_torch.configs.registry import get_config
from repro_torch.convert import to_torch
from repro_torch.launch import serve as TCLI
from repro_torch.models import attention as TA
from repro_torch.models import layers as TL
from repro_torch.models import transformer as TT
from repro_torch.models.model import build_model
from repro_torch.serve import (EngineConfig, Request, ServeEngine,
                               VirtualClock, engine_config_for)

from _ep_helpers import one_torch_thread  # noqa: F401 (autouse)
from _serve_helpers import captured_run

TOL = 2e-5
ARCH = "gemma2-2b"


def _cfgs():
    return (jax_config(ARCH).reduced().replace(dtype="float32"),
            get_config(ARCH).reduced().replace(dtype="float32"))


def _mesh():
    mesh = make_host_mesh(1, 1)
    return mesh, MeshShape(tuple(zip(mesh.axis_names, mesh.devices.shape)))


def _close(port, ref, tol=TOL):
    np.testing.assert_allclose(port.detach().numpy(), np.asarray(ref),
                               atol=tol, rtol=tol)


@pytest.fixture(scope="module")
def pair():
    jcfg, tcfg = _cfgs()
    mesh, ms = _mesh()
    jm = jax_build(jcfg, JPC(attn_chunk=8, loss_chunk=8), batch=2,
                   seq_len=16, mesh_shape=ms, mesh=mesh)
    with mesh:
        jp = jm.init(jax.random.PRNGKey(0))
    tm = build_model(tcfg, batch=2, seq_len=16, device="cpu")
    return mesh, jm, jp, tm, to_torch(jax.device_get(jp), device="cpu")


def test_config_and_layout_match_jax(pair):
    mesh, jm, jp, tm, tp = pair
    jcfg, tcfg = _cfgs()
    assert (tcfg.sliding_window, tcfg.global_attn_every, tcfg.post_norm,
            tcfg.act, tcfg.attn_logit_softcap, tcfg.final_logit_softcap) \
        == (64, 2, True, "gelu", 50.0, 30.0)
    assert TT.layer_pattern(tcfg) == (["attn_local", "attn_global"], 2, 0)
    assert JT.layer_pattern(jcfg) == TT.layer_pattern(tcfg)
    sub = tp["stack"]["blocks"]
    assert set(sub) == {"sub0", "sub1"}
    assert {"post_norm1", "post_norm2"} <= set(sub["sub0"])
    assert set(sub["sub1"]["mlp"]) == {"w_in", "w_gate", "w_out"}
    # the port's own init has JAX's leaves and shapes
    mine = tm.init(0)
    flat = lambda t: {k: tuple(v.shape) for k, v in _flat(t).items()}
    assert flat(mine) == flat(tp)
    # the slab caches: local leaves clamped to the window, global not
    c = tm.init_cache(2, 96)["stack"]["blocks"]
    assert c["sub0"].k.shape[2] == 64 and c["sub1"].k.shape[2] == 96
    jc = jm.init_cache(2, 96)["stack"]["blocks"]
    assert jc["sub0"].k.shape == c["sub0"].k.shape
    assert jc["sub1"].k.shape == c["sub1"].k.shape


def _flat(tree, path=""):
    if isinstance(tree, dict):
        out = {}
        for k, v in tree.items():
            out.update(_flat(v, f"{path}/{k}"))
        return out
    return {path: tree}


def test_gated_gelu_and_embedding_scale_match_jax():
    rng = np.random.default_rng(0)
    d, f = 64, 96
    x = rng.standard_normal((3, 5, d)).astype(np.float32)
    p = {k: (rng.standard_normal(s) * 0.2).astype(np.float32)
         for k, s in (("w_in", (d, f)), ("w_gate", (d, f)),
                      ("w_out", (f, d)))}
    ref = JL.mlp(jnp.asarray(x), {k: jnp.asarray(v) for k, v in p.items()},
                 "gelu")
    got = TL.mlp(torch.from_numpy(x),
                 {k: torch.from_numpy(v) for k, v in p.items()}, "gelu")
    _close(got, ref)
    for dtype, d_model in (("float32", 128), ("bfloat16", 2304),
                           ("bfloat16", 128)):
        cfg = get_config(ARCH).reduced().replace(d_model=d_model,
                                                 dtype=dtype)
        tm = build_model(cfg, batch=1, seq_len=8, device="cpu")
        emb = (rng.standard_normal((16, d_model)) * 0.02).astype(np.float32)
        toks = rng.integers(0, 16, (2, 5))
        je = jnp.asarray(emb).astype(jnp.dtype(dtype))
        ref = je[toks] * jnp.asarray(d_model ** 0.5, je.dtype)
        te = torch.from_numpy(emb).to(getattr(torch, dtype))
        got = tm._embed_tokens({"embed": te}, torch.from_numpy(toks))
        assert got.dtype == te.dtype
        np.testing.assert_array_equal(got.float().numpy(),
                                      np.asarray(ref.astype(jnp.float32)))


@pytest.mark.parametrize("kind", ["attn_local", "attn_global"])
def test_layer_with_post_norms_matches_jax(pair, kind):
    """One layer of each kind (attention with the softcap, post-norm on
    each sub-layer, the gated GELU) over an 80-token prompt on a slab of
    96: the local layer's window binds."""
    mesh, jm, jp, tm, tp = pair
    jcfg, tcfg = _cfgs()
    j = 0 if kind == "attn_local" else 1
    jlayer = jax.tree.map(lambda a: a[1], jp["stack"]["blocks"][f"sub{j}"])
    tlayer = TT.layer_slice(tp["stack"]["blocks"][f"sub{j}"], 1)
    # non-zero post-norm scales, so that a missing norm shows
    rng = np.random.default_rng(7)
    for name in ("post_norm1", "post_norm2"):
        s = (rng.standard_normal(tcfg.d_model) * 0.3).astype(np.float32)
        jlayer[name] = {"scale": jnp.asarray(s)}
        tlayer[name] = {"scale": torch.from_numpy(s)}
    x = rng.standard_normal((2, 80, tcfg.d_model)).astype(np.float32)
    s_max = 64 if kind == "attn_local" else 96
    jc = JA.AttnCache(jnp.zeros((2, s_max, 4, 32)), jnp.zeros((2, s_max, 4,
                                                               32)))
    tc = TA.AttnCache(torch.zeros(2, s_max, 4, 32), torch.zeros(2, s_max, 4,
                                                                32))
    ref, jc2, _ = JT._apply_one_layer(
        jnp.asarray(x), jlayer, kind, jcfg, JPC(attn_chunk=8), mode="prefill",
        q_offset=0, cache=jc, cache_len=jnp.int32(80), moe_spec=None,
        mesh=None, skew_key=None)
    got, _ = TT._apply_one_layer(
        torch.from_numpy(x), tlayer, kind, tcfg, cache=tc,
        cache_len=torch.tensor(80, dtype=torch.int32), q_offset=0,
        moe_spec=None, comm=None, skew_key=None, continue_prefill=False,
        valid_mask=None, block_table=None, block_size=0, strict=False)
    _close(got, ref)
    _close(tc.k, jc2.k)


@pytest.mark.parametrize("is_global", [False, True])
def test_attention_block_local_and_global_with_softcap(pair, is_global):
    """The softcapped block on a local layer (window 64 binding over an
    80-token prompt: the cache keeps the window's tail at its ring slots)
    and a global one, then a decode step on each."""
    mesh, jm, jp, tm, tp = pair
    jcfg, tcfg = _cfgs()
    rng = np.random.default_rng(11)
    jw = jax.tree.map(lambda a: a[0], jp["stack"]["blocks"]["sub1"]["attn"])
    tw = TT.layer_slice(tp["stack"]["blocks"]["sub1"]["attn"], 0)
    s_max = 96 if is_global else 64
    x = rng.standard_normal((2, 80, tcfg.d_model)).astype(np.float32)
    jc = JA.AttnCache(jnp.zeros((2, s_max, 4, 32)),
                      jnp.zeros((2, s_max, 4, 32)))
    tc = TA.AttnCache(torch.zeros(2, s_max, 4, 32),
                      torch.zeros(2, s_max, 4, 32))
    kw = dict(is_global=is_global)
    ref, jc = JA.attention_block(jnp.asarray(x), jw, jcfg, cache=jc,
                                 cache_len=jnp.int32(80), attn_chunk=8, **kw)
    TA.reset_dispatch_log()
    got, _ = TA.attention_block(torch.from_numpy(x), tw, tcfg, q_offset=0,
                                cache=tc, cache_len=torch.tensor(80), **kw)
    _close(got, ref)
    _close(tc.k, jc.k)
    assert TA.dispatch_log()[-1]["branch"] == "prefill_cache"
    assert "softcap=50.0" in TA.dispatch_log()[-1]["reason"]
    assert f"window={0 if is_global else 64}" in TA.dispatch_log()[-1][
        "reason"]
    xd = rng.standard_normal((2, 1, tcfg.d_model)).astype(np.float32)
    ref, jc = JA.attention_block(jnp.asarray(xd), jw, jcfg, cache=jc,
                                 q_offset=jnp.int32(80),
                                 cache_len=jnp.int32(81), **kw)
    got, _ = TA.attention_block(torch.from_numpy(xd), tw, tcfg,
                                q_offset=torch.tensor(80), cache=tc,
                                cache_len=torch.tensor(81), **kw)
    _close(got, ref)
    _close(tc.v, jc.v)


# ----------------------------------------------------------------------
# the model
# ----------------------------------------------------------------------
def test_reduced_prefill_and_decode_match_jax(pair):
    """``test_arch_smoke_decode``'s calls in f32: prefill of B 2 x S 16 on a
    slab of S + 8, then two greedy decode steps."""
    mesh, jm, jp, tm, tp = pair
    B, S = 2, 16
    toks = np.random.default_rng(1).integers(
        0, tm.cfg.vocab_size, (B, S)).astype(np.int32)
    with mesh:
        jl, jc, jpos, _ = jax.jit(lambda p, b: jm.prefill(
            p, b, s_max=S + 8))(jp, {"tokens": toks})
    tl, tc, tpos, diags = tm.prefill(tp, {"tokens": torch.from_numpy(toks)},
                                     s_max=S + 8)
    assert diags == {}
    _close(tl, jl)
    jt = jnp.argmax(jl, -1)[:, None].astype(jnp.int32)
    tt = tl.argmax(-1)[:, None].to(torch.int32)
    step = jax.jit(jm.decode_step)
    for _ in range(2):
        np.testing.assert_array_equal(tt.numpy(), np.asarray(jt))
        with mesh:
            jl, jc, jpos, _ = step(jp, jt, jc, jpos)
        tl, tc, tpos, _ = tm.decode_step(tp, tt, tc, tpos)
        _close(tl, jl)
        jt = jnp.argmax(jl, -1)[:, None].astype(jnp.int32)
        tt = tl.argmax(-1)[:, None].to(torch.int32)
    np.testing.assert_array_equal(tt.numpy(), np.asarray(jt))


def test_prefill_decode_consistency(pair):
    """``test_prefill_decode_consistency[gemma2-2b]`` on the port, and the
    decode step within 2e-5 of JAX's."""
    mesh, jm, jp, tm, tp = pair
    B, S = 1, 12
    toks = np.random.default_rng(2).integers(
        0, tm.cfg.vocab_size, (B, S + 1)).astype(np.int32)
    t = torch.from_numpy(toks)
    full, _, _, _ = tm.prefill(tp, {"tokens": t}, s_max=S + 8)
    _, caches, pos, _ = tm.prefill(tp, {"tokens": t[:, :S]}, s_max=S + 8)
    step, _, _, _ = tm.decode_step(tp, t[:, S:S + 1], caches, pos)
    np.testing.assert_allclose(step.numpy(), full.numpy(), rtol=2e-3,
                               atol=2e-3)
    with mesh:
        _, jc, jpos, _ = jax.jit(lambda p, b: jm.prefill(
            p, b, s_max=S + 8))(jp, {"tokens": toks[:, :S]})
        jstep, _, _, _ = jax.jit(jm.decode_step)(jp, toks[:, S:S + 1], jc,
                                                 jpos)
    _close(step, jstep)


def test_prefill_chunks_across_the_window_match_jax(pair):
    """Chunks of 16 on the unclamped 112-position scratch (the paged
    engine's) up to position 104: past 64 the local layers' window binds
    (plain ``chunked_attention``, as in JAX), while the global layers take
    the paged kernel's branch (its plain version here); then the K cache
    the chunks wrote, local and global."""
    mesh, jm, jp, tm, tp = pair
    V, C, S_max = tm.cfg.vocab_size, 16, 112
    rng = np.random.default_rng(4)
    jcache = jm.init_cache(1, S_max, clamp_window=False)
    tcache = tm.init_cache(1, S_max, clamp_window=False)
    fn = jax.jit(lambda p, t, c, pos, last: jm.prefill_chunk(
        p, t, c, pos, last), static_argnums=(4,))
    TA.reset_dispatch_log()
    for start in range(0, 96, C):
        last = C - 1 if start < 80 else 8
        toks = rng.integers(0, V, (1, C)).astype(np.int32)
        with mesh:
            jl, jcache, _, _ = fn(jp, toks, jcache, jnp.int32(start), last)
        tl, tcache, _, _ = tm.prefill_chunk(tp, torch.from_numpy(toks),
                                            tcache, start, last)
        _close(tl, jl)
    log = TA.dispatch_log()
    assert [r["branch"] for r in log] == ["prefill_continue"] * len(log)
    # the global layers' chunks take the kernel's branch; the local layers'
    # are plain once the window binds over the 112-position scratch
    assert sum(r["reason"].startswith("binding sliding window 64")
               for r in log) == len(log) // 2
    for j in ("sub0", "sub1"):
        kj = np.asarray(jcache["stack"]["blocks"][j].k)[:, :, :89]
        kt = tcache["stack"]["blocks"][j].k.numpy()[:, :, :89]
        np.testing.assert_allclose(kt, kj, atol=TOL)


# ----------------------------------------------------------------------
# the engine: slab, paged with mixed ring and full-chain leaves
# ----------------------------------------------------------------------
def _trace(make, lens, new_tokens, vocab=512, seed=3):
    rng = np.random.default_rng(seed)
    return [make(rid=i, tokens=rng.integers(0, vocab, (int(L),)).astype(
        np.int32), max_new_tokens=new_tokens, arrival_time=0.3 * i)
        for i, L in enumerate(lens)]


CASES = {
    # prompts within the window (the slab's chunks must fit its clamped
    # local leaves); 40 new tokens carry decode past 64, wrapping them
    "slab": dict(kw=dict(max_slots=3, prompt_len=60, max_new_tokens=40,
                         prefill_chunk=16), lens=(23, 60, 41, 9),
                 new_tokens=40),
    # prompts past the window: local leaves wrap rings of 64, global
    # leaves keep full chains
    "paged": dict(kw=dict(max_slots=3, prompt_len=100, max_new_tokens=8,
                          prefill_chunk=16, paged=True, kv_block_size=8),
                  lens=(70, 100, 83, 66), new_tokens=8),
    # 24 blocks of 8 for 3 slots whose chains grow while they decode:
    # preemption
    "paged_preempt": dict(kw=dict(max_slots=3, prompt_len=100,
                                  max_new_tokens=24, prefill_chunk=16,
                                  paged=True, kv_block_size=8,
                                  num_kv_blocks=24),
                          lens=(70, 83, 66, 75), new_tokens=24),
}


@pytest.mark.parametrize("case", list(CASES))
def test_engine_matches_jax_engine(pair, case):
    mesh, jm, jp, tm, tp = pair
    c = CASES[case]
    je = JEngine(jm, jp, jax_ecfg(jm.cfg, **c["kw"]), mesh=mesh,
                 clock=JClock(0.1))
    with mesh:
        out_j, rep_j = captured_run(
            je, _trace(JRequest, c["lens"], c["new_tokens"]))
    te = ServeEngine(tm, tp, engine_config_for(tm.cfg, **c["kw"]),
                     clock=VirtualClock(0.1), device="cpu")
    out_t, rep_t = captured_run(
        te, _trace(Request, c["lens"], c["new_tokens"]))
    assert out_t == out_j
    assert all(len(o) == c["new_tokens"] for o in out_t.values())
    assert te.front.slot_history == je.slot_history
    for key in ("n_requests", "decode_steps", "prefill_chunks",
                "preemptions", "total_new_tokens", "max_occupancy"):
        assert rep_t.get(key) == rep_j.get(key), key
    if case == "paged_preempt":
        assert rep_t["preemptions"] > 0
    kv = te.kv
    if c["kw"].get("paged"):
        # per leaf: the 2 local leaves (k, v) wrap rings of 64, the 2
        # global ones keep full chains over the 112-position pool
        assert kv.ring and not kv.ring_full_chain
        assert sorted(kv.ring_mods) == [0, 0, 64, 64]
        assert kv.blocks_per_slot == kv.s_pad // 8 > 64 // 8
        assert te._alloc.blocks_in_use == 0
        disp = rep_t["attention_dispatch"]
        assert set(disp) >= {"decode", "decode_ring", "prefill_continue"}
    else:
        assert not kv.ring


def test_window_ring_blockers_match_jax(pair):
    """A paged pool over which the window binds refuses a chunk wider
    than the ring, speculative verify, prefix sharing, the fused paged
    kernel and the split roles, in the JAX engine's words."""
    mesh, jm, jp, tm, tp = pair
    kw = dict(max_slots=2, max_seq_len=120, prefill_chunk=80, paged=True,
              kv_block_size=8, speculative_k=2, prefix_sharing=True,
              fused_paged_attention=True)
    msgs = []
    for make, engine, model, params, extra in (
            (None, JEngine, jm, jp, dict(mesh=mesh)),
            (EngineConfig, ServeEngine, tm, tp, dict(device="cpu"))):
        from repro.serve import EngineConfig as JEngineConfig
        ecfg = (make or JEngineConfig)(**kw)
        with pytest.raises(ValueError) as err:
            engine(model, params, ecfg, **extra)
        msgs.append(str(err.value))
    assert msgs[0] == msgs[1]
    assert "prefill_chunk 80 > ring 64" in msgs[1]
    assert "fused paged kernel" in msgs[1]


def test_cli_serves_gemma2_like_jax(pair, monkeypatch, capsys):
    """``--arch gemma2-2b --reduced --paged`` with prompts past the window:
    the port's CLI on JAX's weights gives the JAX CLI engine's streams."""
    argv = ["--arch", ARCH, "--reduced", "--batch", "2", "--prompt-len",
            "80", "--gen", "5", "--seed", "1", "--paged", "--kv-block-size",
            "8", "--prefill-chunk", "16", "--requests", "3"]
    got = {}
    monkeypatch.setattr(JCLI, "serve", lambda a: got.setdefault("a", a))
    monkeypatch.setattr(sys, "argv", ["serve"] + argv)
    JCLI.main()
    ja = got["a"]
    cfg, je = JCLI.build_serving_engine(ja)
    reqs = jax_requests(ja.requests, rate=ja.rate, vocab_size=cfg.vocab_size,
                        prompt_len=ja.prompt_len, max_new_tokens=ja.gen,
                        seed=ja.seed)
    with je.mesh if hasattr(je, "mesh") and je.mesh is not None \
            else make_host_mesh(1, 1):
        out_j, _ = captured_run(je, reqs)
    streams = {}
    run = TCLI._serve_run

    def recording(engine, requests):
        rep, s, launches = run(engine, requests)
        streams.update(s)
        return rep, s, launches
    monkeypatch.setattr(TCLI, "_serve_run", recording)
    rep = TCLI.serve(TCLI.build_parser().parse_args(argv), device="cpu",
                     params=to_torch(jax.device_get(je.params), device="cpu"))
    out = capsys.readouterr().out
    assert streams == out_j
    assert rep["n_requests"] == 3
    assert f"[serve] arch={ARCH}" in out
    assert "fused_attention=False" in out
