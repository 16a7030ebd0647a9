"""Sliding-window attention in the port against the JAX package.

* The windowed attention functions, f32 at 2e-5 on seeded numpy inputs:
  ``chunked_attention``, ``full_attention_ref``, ``decode_attention`` and
  ``paged_ring_decode_attention`` (lengths below, at and far past the
  window), and ``attention_block``'s whole-prompt ring roll and slab ring
  decode.
* The strict contract (``tests/test_paged_attention_kernel.py``'s): a
  branch without a kernel raises ``FusedPathUnavailable`` when the kernels
  are required, and runs its plain form otherwise.
* Every case of ``tests/test_serve_window_ring.py`` on a tiny MoE model
  with a window of 8 (the port builds no dense family): the paged ring
  engages; greedy streams equal the one-shot windowed oracle's and the JAX
  engine's on the same converted weights; preemption and resume are
  token-exact; ring chains never grow; each blocker is refused naming the
  blocker, with the JAX engine's message; a chunk wider than the ring and
  the slab beyond the window are refused.
* The captured ring paths: the ``TorchDispatchMode`` guard over the ring
  decode step, the prefill chunk under a binding window and the ring
  write, and position independence of the captured ring decode step.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.base import ModelConfig as JModelConfig
from repro.configs.base import MoEConfig as JMoEConfig
from repro.configs.base import ParallelConfig as JPC
from repro.launch.mesh import make_host_mesh
from repro.models import attention as JA
from repro.models.model import MeshShape
from repro.models.model import build_model as jax_build
from repro.serve import Request as JRequest
from repro.serve import ServeEngine as JEngine
from repro.serve import VirtualClock as JClock
from repro.serve import engine_config_for as jax_ecfg
from repro_torch.configs.base import ModelConfig, MoEConfig, ParallelConfig
from repro_torch.convert import to_torch
from repro_torch.kernels.schedule import ops as schedule_ops
from repro_torch.launch.steps import make_decode_step, make_prefill_step
from repro_torch.models import attention as TA
from repro_torch.models.model import build_model
from repro_torch.serve import Request, ServeEngine, VirtualClock
from repro_torch.serve import engine_config_for

from _ep_helpers import one_torch_thread  # noqa: F401 (autouse)
from _serve_helpers import captured_run
from test_torch_capture import HostSyncGuard, _guarded_decode_steps
from test_torch_prefill_capture import OpRecorder

TOL = dict(atol=2e-5, rtol=2e-5)
# the ring tests' model: a window of 8 over every layer, MoE (the port
# builds no dense family), GQA rep 2, on both sides; a capacity factor
# that drops no token, so that the engine's chunks and the one-shot
# oracle's whole prompt route alike
SWA_KW = dict(name="tinyswa-moe", family="moe", num_layers=2, d_model=32,
              num_heads=4, num_kv_heads=2, d_ff=64, vocab_size=512,
              head_dim=32, sliding_window=8, dtype="float32")
SWA = ModelConfig(**SWA_KW, moe=MoEConfig(
    num_experts=4, num_experts_per_tok=2, d_ff_expert=32,
    capacity_factor=4.0, num_foreign_slots=2))
JSWA = JModelConfig(**SWA_KW, moe=JMoEConfig(
    num_experts=4, num_experts_per_tok=2, d_ff_expert=32,
    capacity_factor=4.0, num_foreign_slots=2))
L_MAX, GEN, CHUNK, BS = 14, 6, 4, 4


def _t(a):
    return torch.from_numpy(np.asarray(a))


def _qkv(seed, B, Sq, Sk, H, Hkv, hd):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((B, Sq, H, hd)).astype(np.float32),
            rng.standard_normal((B, Sk, Hkv, hd)).astype(np.float32),
            rng.standard_normal((B, Sk, Hkv, hd)).astype(np.float32))


# ----------------------------------------------------------------------
# the windowed functions
# ----------------------------------------------------------------------
# (window, q_offset, Sq, Sk, H, Hkv, chunk): no window, a window that
# binds inside one chunk and across chunks, a ragged last chunk, GQA
ATTN_CASES = [(0, 0, 12, 12, 4, 4, 8), (5, 0, 12, 12, 4, 2, 4),
              (8, 6, 10, 16, 4, 1, 4), (3, 20, 7, 27, 2, 2, 8),
              (64, 0, 9, 9, 4, 2, 4)]


@pytest.mark.parametrize("window,q_offset,Sq,Sk,H,Hkv,chunk", ATTN_CASES)
def test_chunked_attention_window_matches_jax(window, q_offset, Sq, Sk, H,
                                              Hkv, chunk):
    q, k, v = _qkv(1, 2, Sq, Sk, H, Hkv, 32)
    want = JA.chunked_attention(q, k, v, causal=True, window=window,
                                chunk=chunk, q_offset=q_offset)
    got = TA.chunked_attention(_t(q), _t(k), _t(v), causal=True,
                               window=window, chunk=chunk, q_offset=q_offset)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
    # a 0-d device offset (what a captured chunk passes) gives the same
    off = TA.chunked_attention(_t(q), _t(k), _t(v), causal=True,
                               window=window, chunk=chunk,
                               q_offset=torch.tensor(q_offset))
    assert torch.equal(off, got)


@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("window,q_offset,Sq,Sk,H,Hkv,chunk", ATTN_CASES)
def test_full_attention_ref_matches_jax(window, q_offset, Sq, Sk, H, Hkv,
                                        chunk, causal):
    q, k, v = _qkv(2, 2, Sq, Sk, H, Hkv, 32)
    want = JA.full_attention_ref(q, k, v, causal=causal, window=window,
                                 q_offset=q_offset)
    got = TA.full_attention_ref(_t(q), _t(k), _t(v), causal=causal,
                                window=window, q_offset=q_offset)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
    if causal:               # the oracle agrees with the chunked form
        np.testing.assert_allclose(
            got.numpy(), TA.chunked_attention(
                _t(q), _t(k), _t(v), causal=True, window=window,
                chunk=chunk, q_offset=q_offset).numpy(), **TOL)


@pytest.mark.parametrize("window", [0, 4, 16])
@pytest.mark.parametrize("per_row", [False, True], ids=["scalar", "rows"])
def test_decode_attention_window_matches_jax(window, per_row):
    B, S_max, H, Hkv = 3, 20, 4, 2
    q, k, v = _qkv(3, B, 1, S_max, H, Hkv, 32)
    cl = np.array([3, 11, 20], np.int32) if per_row else np.int32(13)
    want = JA.decode_attention(q, k, v, jnp.asarray(cl), window=window)
    got = TA.decode_attention(_t(q), _t(k), _t(v), torch.as_tensor(cl),
                              window=window)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


@pytest.mark.parametrize("window,bs", [(8, 4), (6, 4), (12, 8)])
def test_paged_ring_decode_attention_matches_jax(window, bs):
    """Lengths below, at and far past the window, and an idle row of
    length 1, through shuffled chains of M / bs blocks."""
    M = -(-window // bs) * bs
    nb, H, Hkv, hd = 24, 4, 2, 32
    lengths = np.array([1, window - 3, window, window + 1, 5 * M + 3],
                       np.int32)
    B = len(lengths)
    rng = np.random.default_rng(4)
    q = rng.standard_normal((B, 1, H, hd)).astype(np.float32)
    kp = rng.standard_normal((1, nb * bs, Hkv, hd)).astype(np.float32)
    vp = rng.standard_normal((1, nb * bs, Hkv, hd)).astype(np.float32)
    table = np.stack([rng.permutation(np.arange(1, nb))[:M // bs]
                      for _ in range(B)]).astype(np.int32)
    want = JA.paged_ring_decode_attention(q, kp, vp, table, lengths,
                                          window=window, block_size=bs)
    got = TA.paged_ring_decode_attention(_t(q), _t(kp), _t(vp), _t(table),
                                         _t(lengths), window=window,
                                         block_size=bs)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


def _attn_params(seed, cfg):
    rng = np.random.default_rng(seed)
    d, H, Hkv, hd = (cfg.d_model, cfg.num_heads, cfg.num_kv_heads,
                     cfg.resolved_head_dim)
    s = (2.0 / d) ** 0.5
    return {"wq": rng.standard_normal((d, H, hd)).astype(np.float32) * s,
            "wk": rng.standard_normal((d, Hkv, hd)).astype(np.float32) * s,
            "wv": rng.standard_normal((d, Hkv, hd)).astype(np.float32) * s,
            "wo": rng.standard_normal((H, hd, d)).astype(np.float32) * s}


@pytest.mark.parametrize("S", [5, 8, 13], ids=["short", "at", "past"])
def test_prefill_cache_ring_roll_and_slab_ring_decode_match_jax(S):
    """A whole prompt on a slab clamped to the window (the tail rolled to
    its ring slots past the window), then decode steps that wrap it."""
    cfg, jcfg, W = SWA, JSWA, SWA.sliding_window
    p = _attn_params(5, cfg)
    rng = np.random.default_rng(6)
    B, d = 2, cfg.d_model
    hkv, hd = cfg.num_kv_heads, cfg.resolved_head_dim
    x = rng.standard_normal((B, S, d)).astype(np.float32)
    zeros = np.zeros((B, W, hkv, hd), np.float32)
    jc = JA.AttnCache(jnp.asarray(zeros), jnp.asarray(zeros))
    tc = TA.AttnCache(_t(zeros).clone(), _t(zeros).clone())
    jy, jc = JA.attention_block(x, p, jcfg, q_offset=0, cache=jc,
                                cache_len=jnp.int32(S), attn_chunk=4)
    ty, tc = TA.attention_block(_t(x), {k: _t(v) for k, v in p.items()},
                                cfg, q_offset=0, cache=tc, cache_len=S)
    np.testing.assert_allclose(ty.numpy(), np.asarray(jy), **TOL)
    np.testing.assert_allclose(tc.k.numpy(), np.asarray(jc.k), **TOL)
    for step in range(W + 3):                 # past one full wrap
        pos = np.array([S + step, S + step], np.int32)
        xs = rng.standard_normal((B, 1, d)).astype(np.float32)
        jy, jc = JA.attention_block(xs, p, jcfg, q_offset=jnp.asarray(pos),
                                    cache=jc, cache_len=jnp.asarray(pos + 1))
        ty, tc = TA.attention_block(_t(xs), {k: _t(v) for k, v in p.items()},
                                    cfg, q_offset=_t(pos), cache=tc,
                                    cache_len=_t(pos + 1))
        np.testing.assert_allclose(ty.numpy(), np.asarray(jy), **TOL)
        np.testing.assert_allclose(tc.v.numpy(), np.asarray(jc.v), **TOL)


# ----------------------------------------------------------------------
# the strict contract
# ----------------------------------------------------------------------
def test_strict_raises_on_inapplicable_fused_path():
    """A branch without a kernel (the chunk under a window that binds over
    the slab) raises ``FusedPathUnavailable`` when the kernels are
    required (JAX's ``pallas_strict``); non-strict it runs its plain
    form, and the log records why (JAX's reason)."""
    cfg = SWA.replace(sliding_window=8)        # binds: window < S_max = 24
    B, S, S_max = 2, 10, 24
    p = {k: _t(v) for k, v in _attn_params(17, cfg).items()}
    x = _t(np.random.default_rng(18).standard_normal(
        (B, S, cfg.d_model)).astype(np.float32))
    slab = torch.zeros((B, S_max, cfg.num_kv_heads, cfg.resolved_head_dim))
    with pytest.raises(TA.FusedPathUnavailable, match="prefill_continue"):
        TA.attention_block(x, p, cfg, q_offset=0,
                           cache=TA.AttnCache(slab.clone(), slab.clone()),
                           continue_prefill=True, strict=True)
    TA.reset_dispatch_log()
    y, _ = TA.attention_block(x, p, cfg, q_offset=0,
                              cache=TA.AttnCache(slab.clone(), slab.clone()),
                              continue_prefill=True)
    assert y.shape == (B, S, cfg.d_model)
    assert TA.dispatch_log() == [{
        "branch": "prefill_continue", "fused": False,
        "reason": "binding sliding window 8 < slab 24"}]
    # a branch that has a kernel never raises: on the CPU its plain
    # version stands in for the kernel
    TA.attention_block(x, p, cfg.replace(sliding_window=0), q_offset=0,
                       cache=TA.AttnCache(slab.clone(), slab.clone()),
                       continue_prefill=True, strict=True)
    TA.reset_dispatch_log()
    # the model's entries take it as their fused switch (the engine's
    # fused_paged_attention, which the ring blockers keep off a windowed
    # pool); unset, the same chunk runs its plain form
    model = build_model(SWA, ParallelConfig(), batch=1, seq_len=16,
                        device="cpu")
    params = model.init(0)
    with pytest.raises(TA.FusedPathUnavailable, match="prefill_continue"):
        model.prefill_chunk(params, torch.ones((1, 4), dtype=torch.long),
                            model.init_cache(1, 16, clamp_window=False), 0,
                            fused_attention=True)
    model.prefill_chunk(params, torch.ones((1, 4), dtype=torch.long),
                        model.init_cache(1, 16, clamp_window=False), 0)
    with pytest.raises(TA.FusedPathUnavailable, match="decode_ring"):
        pool = model.init_paged_cache(4, 4, 8, clamp_window=False)
        model.decode_step(params, torch.ones((1, 1), dtype=torch.long),
                          pool, torch.tensor([3]),
                          block_table=torch.tensor([[1, 2]]), block_size=4,
                          fused_attention=True)
    TA.reset_dispatch_log()


# ----------------------------------------------------------------------
# the engine's ring (tests/test_serve_window_ring.py's cases)
# ----------------------------------------------------------------------
@pytest.fixture(scope="module")
def swa():
    """The JAX model and weights, and the port's model on them."""
    mesh = make_host_mesh(1, 1)
    ms = MeshShape(tuple(zip(mesh.axis_names, mesh.devices.shape)))
    jm = jax_build(JSWA, JPC(attn_chunk=8, loss_chunk=8), batch=1,
                   seq_len=L_MAX, mesh_shape=ms, mesh=mesh)
    with mesh:
        jp = jm.init(jax.random.PRNGKey(0))
    tm = build_model(SWA, batch=1, seq_len=L_MAX, device="cpu")
    return tm, to_torch(jax.device_get(jp), device="cpu"), (mesh, jm, jp)


def _kw(**kw):
    return dict(max_slots=2, prompt_len=L_MAX, max_new_tokens=GEN,
                prefill_chunk=CHUNK, paged=True, kv_block_size=BS, **kw)


def _engine(model, params, **kw):
    return ServeEngine(model, params, engine_config_for(SWA, **_kw(**kw)),
                       clock=VirtualClock(0.5), device="cpu")


def _jax_streams(jax_side, requests, **kw):
    mesh, jm, jp = jax_side
    je = JEngine(jm, jp, jax_ecfg(JSWA, **_kw(**kw)), mesh=mesh,
                 clock=JClock(0.5))
    with mesh:
        out, rep = captured_run(je, [JRequest(rid=r.rid, tokens=r.tokens,
                                              max_new_tokens=r.max_new_tokens)
                                     for r in requests])
    return out, rep


def _oracle(model, params, prompt, s_max, gen=GEN):
    """One-shot prefill + lockstep decode on the window-clamped slab
    (``launch.steps``)."""
    tok, caches, pos, _ = make_prefill_step(model, s_max=s_max)(
        params, {"tokens": torch.from_numpy(np.asarray(prompt)[None])})
    out = [int(tok[0, 0])]
    step = make_decode_step(model)
    for _ in range(gen - 1):
        tok, caches, pos, _ = step(params, tok, caches, pos)
        out.append(int(tok[0, 0]))
    return out


def test_ring_engages(swa):
    model, params, _ = swa
    eng = _engine(model, params)
    stats = eng.kv.stats()
    assert stats["window_ring"] and stats["ring_full_chain"]
    assert stats["ring_tokens"] == 8           # round_up(window=8, bs=4)
    assert eng.kv.blocks_per_slot == 2         # M // bs: fixed per slot
    assert eng.kv.ring_mods == [8] * len(eng.kv.seq_axes)


def test_ring_matches_windowed_oracle(swa):
    """Prompt lengths straddling the window (14 > 8 > 7), none a multiple
    of chunk or block size: every greedy stream equals the one-shot
    windowed oracle's and the JAX engine's, and the two engines report
    the same state pool and dispatch."""
    model, params, jax_side = swa
    eng = _engine(model, params)
    rng = np.random.default_rng(5)
    reqs = [Request(rid=i, tokens=rng.integers(0, SWA.vocab_size, (n,))
                    .astype(np.int32), max_new_tokens=GEN)
            for i, n in enumerate((14, 11, 9, 7))]
    outputs, rep = captured_run(eng, reqs)
    for r in reqs:
        assert outputs[r.rid] == _oracle(model, params, r.tokens,
                                         eng.ecfg.max_seq_len), \
            f"rid {r.rid} (prompt len {len(r.tokens)})"
    jout, jrep = _jax_streams(jax_side, reqs)
    assert outputs == jout
    assert rep["state_pool"] == jrep["state_pool"]
    assert {b: d["fused"] for b, d in rep["attention_dispatch"].items()} \
        == {b: d["fused"] for b, d in jrep["attention_dispatch"].items()} \
        == {"prefill_continue": False, "decode_ring": False}
    assert {b: d["reason"] for b, d in rep["attention_dispatch"].items()} \
        == {b: d["reason"] for b, d in jrep["attention_dispatch"].items()}


def test_ring_preemption_resume_token_exact(swa):
    """Preempt a ring request mid-decode (its whole fixed chain is
    released), resume, and the stream is unchanged — re-prefill rebuilds
    the ring contents for prompt + committed output exactly — and equals
    the JAX engine's."""
    model, params, jax_side = swa
    rng = np.random.default_rng(9)
    prompt = rng.integers(0, SWA.vocab_size, (13,)).astype(np.int32)
    req = Request(rid=0, tokens=prompt, max_new_tokens=GEN)
    base, _ = captured_run(_engine(model, params), [req])
    assert base == _jax_streams(jax_side, [req])[0]

    eng2 = _engine(model, params)
    outputs = {}
    orig = eng2._finish

    def cap(st, now):
        outputs[st.req.rid] = list(st.output)
        orig(st, now)

    eng2._finish = cap
    eng2.submit(Request(rid=0, tokens=prompt, max_new_tokens=GEN))
    preempted = False
    while eng2.has_work():
        eng2.step()
        if not preempted and eng2.active.any():
            s = int(np.nonzero(eng2.active)[0][0])
            st = eng2.front.state_by_slot[s]
            if st is not None and len(st.output) >= 3:
                eng2._preempt(st)
                preempted = True
    assert preempted
    assert outputs[0] == base[0]
    assert eng2.report()["state_pool"]["preemptions"] == 1


def test_ring_chains_never_grow(swa):
    """With ring_full_chain every slot's chain is allocated whole at
    admission; the block allocator sees no extends during decode."""
    model, params, _ = swa
    eng = _engine(model, params)
    orig_extend = eng._alloc.extend
    calls = []
    eng._alloc.extend = lambda rid: calls.append(rid) or orig_extend(rid)
    rng = np.random.default_rng(2)
    prompt = rng.integers(0, SWA.vocab_size, (14,)).astype(np.int32)
    captured_run(eng, [Request(rid=0, tokens=prompt, max_new_tokens=GEN)])
    assert calls == []


@pytest.mark.parametrize("kw,frag", [
    (dict(speculative_k=2), "single-query"),
    (dict(prefix_sharing=True), "absolute sequence length"),
    (dict(fused_paged_attention=True), "no ring arithmetic"),
    (dict(role="prefill"), "handoff"),
], ids=["speculative", "sharing", "fused", "role"])
def test_ring_blockers_rejected(swa, kw, frag):
    """The JAX engine refuses each blocker at construction.
    ``fused_paged_attention``, ``speculative_k`` and ``prefix_sharing``
    reach the port's engine, which refuses each with JAX's message word
    for word; ``role`` is not ported (item 7), so the port's
    ``EngineConfig`` refuses it, naming the field."""
    model, params, (mesh, jm, jp) = swa
    with pytest.raises(ValueError, match=frag) as jerr:
        JEngine(jm, jp, jax_ecfg(JSWA, **_kw(**kw)), mesh=mesh,
                clock=JClock(0.5))
    if "role" not in kw:
        with pytest.raises(ValueError, match=frag) as err:
            _engine(model, params, **kw)
        assert str(err.value) == str(jerr.value)
    else:
        with pytest.raises(NotImplementedError, match=next(iter(kw))):
            engine_config_for(SWA, **_kw(**kw))


def test_chunk_wider_than_ring_rejected(swa):
    for ecfg_for, cfg in ((engine_config_for, SWA), (jax_ecfg, JSWA)):
        with pytest.raises(ValueError, match="chunk"):
            ecfg_for(cfg, max_slots=2, prompt_len=L_MAX, max_new_tokens=GEN,
                     prefill_chunk=16, paged=True, kv_block_size=BS)


def test_slab_still_rejects_beyond_window(swa):
    """The slab pool's clamped cache cannot hold a prompt beyond the
    window; the error points at the paged ring, as JAX's does."""
    for ecfg_for, cfg in ((engine_config_for, SWA), (jax_ecfg, JSWA)):
        with pytest.raises(ValueError, match="paged"):
            ecfg_for(cfg, max_slots=2, prompt_len=L_MAX, max_new_tokens=GEN,
                     prefill_chunk=CHUNK)


def test_slab_ring_matches_jax_engine(swa):
    """The slab pool clamped to the window: prompts that fit it, decode
    that wraps it, equal to the JAX engine's streams and the oracle's."""
    model, params, (mesh, jm, jp) = swa
    kw = dict(max_slots=2, prompt_len=8, max_new_tokens=10, prefill_chunk=4)
    rng = np.random.default_rng(7)
    reqs = [Request(rid=i, tokens=rng.integers(0, SWA.vocab_size, (n,))
                    .astype(np.int32), max_new_tokens=10)
            for i, n in enumerate((8, 5, 3))]
    eng = ServeEngine(model, params, engine_config_for(SWA, **kw),
                      clock=VirtualClock(0.5), device="cpu")
    out, rep = captured_run(eng, reqs)
    je = JEngine(jm, jp, jax_ecfg(JSWA, **kw), mesh=mesh, clock=JClock(0.5))
    with mesh:
        jout, jrep = captured_run(je, [JRequest(rid=r.rid, tokens=r.tokens,
                                                max_new_tokens=10)
                                       for r in reqs])
    assert out == jout
    assert rep["engine"]["kv_capacity"] == jrep["engine"]["kv_capacity"] == 8
    for r in reqs:
        assert out[r.rid] == _oracle(model, params, r.tokens,
                                     eng.ecfg.max_seq_len, gen=10)


# ----------------------------------------------------------------------
# the captured ring paths
# ----------------------------------------------------------------------
def _ring_engine():
    from test_torch_capture import _engine as capture_engine
    return capture_engine(SWA, paged=True)


def test_ring_decode_step_never_syncs_the_host(monkeypatch):
    eng = _ring_engine()
    assert eng.kv.ring_full_chain
    guard = _guarded_decode_steps(eng, monkeypatch)
    assert guard.ops > 100
    assert guard.hits == []


@pytest.mark.parametrize("paged", [False, True], ids=["slab", "paged"])
def test_ring_prefill_chunk_and_write_never_sync_the_host(paged,
                                                          monkeypatch):
    """The chunk under the binding window (paged: the unclamped scratch)
    or on the clamped slab, and the ring write with its null-block
    diversion of pad positions."""
    from test_torch_capture import _engine as capture_engine
    eng = capture_engine(SWA, paged=paged, prompt_len=8, max_new_tokens=4)
    guard = HostSyncGuard()
    plain = schedule_ops.rebalance_plain

    def exempt_plain(*args, **kwargs):
        guard.paused += 1
        try:
            return plain(*args, **kwargs)
        finally:
            guard.paused -= 1
    monkeypatch.setattr(schedule_ops, "rebalance_plain", exempt_plain)
    calls = {"prefill": 0, "write": 0}

    def guarded(owner, name, key):
        fn = getattr(owner, name)

        def run(*args):
            calls[key] += 1
            with guard:
                return fn(*args)
        monkeypatch.setattr(owner, name, run)
    eng.warmup()
    guarded(eng.core, "_prefill_step", "prefill")
    guarded(eng.kv, "_write", "write")
    eng.submit(Request(rid=0, tokens=np.arange(1, 7), max_new_tokens=4))
    while not eng.active.any():
        eng.step()
    assert calls == {"prefill": 2, "write": 2 if paged else 1}
    assert eng.kv.ring == paged
    assert guard.ops > 100
    assert guard.hits == []


def test_ring_decode_step_is_position_independent(monkeypatch):
    """One ``StepCore`` runs its ring decode step from its buffers at
    positions below, at and past the window and across wraps: the same
    ops with the same host arguments each time (what a graph replays),
    and tokens and logits bit-equal to ``model.decode_step`` called with
    fresh tensors on a copy of the pool."""
    from torch.utils._pytree import tree_map
    eng = _ring_engine()
    eng.warmup()
    core, model, params = eng.core, eng.model, eng.params
    step = core._step
    seen = {}

    def recording_step(*args):
        rec = OpRecorder()
        with rec:
            out = step(*args)
        seen["trace"] = rec.trace
        return out
    monkeypatch.setattr(core, "_step", recording_step)
    B = eng.ecfg.max_slots
    rng = np.random.default_rng(21)
    bps = eng.kv.blocks_per_slot
    table = np.arange(1, 1 + B * bps, dtype=np.int32).reshape(B, bps)
    active = np.array([True] * (B - 1) + [False])
    traces = []
    for pos in ([1, 7, 0], [8, 9, 0], [15, 23, 0], [40, 33, 0]):
        pos = np.array(pos, np.int32)
        tok = rng.integers(1, 500, (B,)).astype(np.int32)
        pool = tree_map(torch.clone, eng.kv.pool)
        nxt, _ = core.decode(params, tok, eng.kv.pool, pos, table, active, 0)
        traces.append(seen["trace"])
        logits, *_ = model.decode_step(
            params, torch.from_numpy(tok)[:, None], pool,
            torch.from_numpy(pos), active_mask=torch.from_numpy(active),
            block_table=torch.from_numpy(table),
            block_size=eng.ecfg.kv_block_size)
        assert torch.equal(core.logits, logits)
        np.testing.assert_array_equal(nxt, logits.argmax(-1).numpy())
    for t in traces[1:]:
        diff = [(a, b) for a, b in zip(traces[0], t) if a != b]
        assert len(t) == len(traces[0]) and not diff, diff[:2]
    assert len(traces[0]) > 100
