"""The dense decoder family in the port against the JAX package, on the
CPU, on weights converted from JAX and inputs drawn from a seed.

- ``layernorm`` / ``norm`` / ``init_norm`` against ``repro.models.layers``:
  within 2e-5 in f32 and bit-equal in bf16 (the same ops, rounded in the
  same order).
- Reduced mistral-nemo-12b, phi4-mini-3.8b (tied embeddings) and
  stablelm-1.6b (LayerNorm) in f32: ``prefill`` logits and two greedy
  ``decode_step``s, ``test_models.py::test_arch_smoke_decode``'s calls,
  within 2e-5 and with the same tokens; stablelm's prefill/decode
  consistency (``test_prefill_decode_consistency``).
- Hand-built configs that ``reduced()`` cannot give: GQA rep 3 (6 q / 2 kv
  heads) and ``H * hd != d_model`` (d 96, 4 heads of 32): chunked
  ``prefill_chunk`` on the slab scratch and paged ``decode_step`` against
  JAX's, then the engine on both pools against the JAX engine.
- The engine on the JAX engine tests' ``TINY`` dense model: chunked
  prefill and slotted decode equal the one-shot driver on both pools
  (``test_serve_engine.py::test_engine_matches_one_shot_driver``), and
  the slab, paged, preempting, prefix-sharing and speculative engines
  equal the JAX engine's: streams, slot histories, preemptions, step
  counts, the prefix and speculative counters, and the report's key
  paths (no MoE sections; ``engine.device`` is the port's own).

The CLI on reduced phi4-mini-3.8b is a cell of
``tests/test_torch_serve_cli.py``."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jax_config
from repro.configs.base import ModelConfig as JaxModelConfig
from repro.configs.base import ParallelConfig as JPC
from repro.launch.mesh import make_host_mesh
from repro.models import layers as JL
from repro.models.model import MeshShape
from repro.models.model import build_model as jax_build
from repro.serve import Request as JRequest
from repro.serve import ServeEngine as JEngine
from repro.serve import VirtualClock as JClock
from repro.serve import engine_config_for as jax_ecfg
from repro_torch.configs.base import ModelConfig
from repro_torch.configs.registry import get_config
from repro_torch.convert import to_torch
from repro_torch.models import layers as TL
from repro_torch.models.model import build_model
from repro_torch.serve import (Request, ServeEngine, VirtualClock,
                               engine_config_for)

from _ep_helpers import one_torch_thread  # noqa: F401 (autouse)
from _serve_helpers import captured_run

TOL = 2e-5
ARCHS = ["mistral-nemo-12b", "phi4-mini-3.8b", "stablelm-1.6b"]
TINY = dict(name="tiny", family="dense", num_layers=2, d_model=32,
            num_heads=2, num_kv_heads=2, d_ff=64, vocab_size=64,
            head_dim=16, dtype="float32")
# the shapes ``reduced()`` cannot give (it keeps H * hd == d and rep 1)
HAND = {"gqa_rep3": dict(TINY, name="tiny-gqa3", d_model=96, num_heads=6,
                         num_kv_heads=2, d_ff=128),
        "heads_not_d": dict(TINY, name="tiny-hd", d_model=96, num_heads=4,
                            num_kv_heads=2, head_dim=32, d_ff=128,
                            norm="layernorm")}


def _mesh():
    mesh = make_host_mesh(1, 1)
    return mesh, MeshShape(tuple(zip(mesh.axis_names, mesh.devices.shape)))


def _pair(jcfg, tcfg, batch, seq_len):
    """The JAX model and weights, and the port's model on them."""
    mesh, ms = _mesh()
    jm = jax_build(jcfg, JPC(attn_chunk=8, loss_chunk=8), batch=batch,
                   seq_len=seq_len, mesh_shape=ms, mesh=mesh)
    with mesh:
        jp = jm.init(jax.random.PRNGKey(0))
    tm = build_model(tcfg, batch=batch, seq_len=seq_len, device="cpu")
    return mesh, jm, jp, tm, to_torch(jax.device_get(jp), device="cpu")


def _close(port, ref, tol=TOL):
    np.testing.assert_allclose(port.numpy(), np.asarray(ref), atol=tol,
                               rtol=tol)


# ----------------------------------------------------------------------
# LayerNorm
# ----------------------------------------------------------------------
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("kind", ["layernorm", "rmsnorm"])
def test_norm_matches_jax(kind, dtype):
    rng = np.random.default_rng(0)
    d = 96
    x = (rng.standard_normal((3, 5, d)) * 2 + 0.7).astype(np.float32)
    p = {k: v + rng.standard_normal(d).astype(np.float32) * 0.1
         for k, v in jax.device_get(JL.init_norm(d, kind)).items()}
    tp = TL.init_norm((d,), kind, "cpu")
    assert tp.keys() == p.keys()
    for k, v in jax.device_get(JL.init_norm(d, kind)).items():
        assert tp[k].dtype == torch.float32
        np.testing.assert_array_equal(tp[k].numpy(), v)
    jx = jnp.asarray(x).astype(jnp.dtype(dtype))
    tx = torch.from_numpy(x).to(getattr(torch, dtype))
    ref = JL.norm(jx, {k: jnp.asarray(v) for k, v in p.items()}, kind)
    got = TL.norm(tx, {k: torch.from_numpy(v) for k, v in p.items()}, kind)
    assert got.dtype == tx.dtype
    if dtype == "float32":
        _close(got, ref)
    else:
        np.testing.assert_array_equal(got.float().numpy(),
                                      np.asarray(ref.astype(jnp.float32)))
    if kind == "layernorm":
        direct = TL.layernorm(tx, torch.from_numpy(p["scale"]),
                              torch.from_numpy(p["bias"]))
        assert torch.equal(direct, got)


# ----------------------------------------------------------------------
# the three reduced archs
# ----------------------------------------------------------------------
@pytest.mark.parametrize("arch", ARCHS)
def test_reduced_arch_prefill_and_decode_match_jax(arch):
    """``test_arch_smoke_decode``'s calls in f32: prefill of B 2 x S 16 on a
    slab of S + 8, then two greedy decode steps."""
    jcfg = jax_config(arch).reduced().replace(dtype="float32")
    tcfg = get_config(arch).reduced().replace(dtype="float32")
    assert (tcfg.norm, tcfg.tie_embeddings) == (jcfg.norm,
                                                 jcfg.tie_embeddings)
    B, S = 2, 16
    mesh, jm, jp, tm, tp = _pair(jcfg, tcfg, B, S)
    assert ("lm_head" in tp) == (not tcfg.tie_embeddings)
    if tcfg.norm == "layernorm":
        assert set(tp["final_norm"]) == {"scale", "bias"}
        assert set(tp["stack"]["blocks"]["sub0"]["norm1"]) == {"scale",
                                                                 "bias"}
    toks = np.random.default_rng(1).integers(
        0, tcfg.vocab_size, (B, S)).astype(np.int32)
    with mesh:
        jl, jc, jpos, _ = jax.jit(lambda p, b: jm.prefill(
            p, b, s_max=S + 8))(jp, {"tokens": toks})
    tl, tc, tpos, diags = tm.prefill(tp, {"tokens": torch.from_numpy(toks)},
                                     s_max=S + 8)
    assert diags == {}                       # no MoE diagnostics
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
        assert bool(torch.isfinite(tl).all())
        jt = jnp.argmax(jl, -1)[:, None].astype(jnp.int32)
        tt = tl.argmax(-1)[:, None].to(torch.int32)
    np.testing.assert_array_equal(tt.numpy(), np.asarray(jt))


def test_stablelm_prefill_decode_consistency():
    """``test_prefill_decode_consistency`` on the port: prefill(S + 1)'s
    logits equal prefill(S) then decode of token S + 1 (JAX's tolerance),
    and the decode step's logits equal JAX's (2e-5)."""
    arch = "stablelm-1.6b"
    jcfg = jax_config(arch).reduced().replace(dtype="float32")
    tcfg = get_config(arch).reduced().replace(dtype="float32")
    B, S = 1, 12
    mesh, jm, jp, tm, tp = _pair(jcfg, tcfg, B, S + 1)
    toks = np.random.default_rng(2).integers(
        0, tcfg.vocab_size, (B, S + 1)).astype(np.int32)
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


# ----------------------------------------------------------------------
# hand-built shapes: GQA rep 3, H * hd != d_model
# ----------------------------------------------------------------------
@pytest.fixture(scope="module", params=list(HAND))
def hand(request):
    kw = HAND[request.param]
    jcfg, tcfg = JaxModelConfig(**kw), ModelConfig(**kw)
    assert (tcfg.num_heads // tcfg.num_kv_heads == 3
            or tcfg.num_heads * tcfg.resolved_head_dim != tcfg.d_model)
    return (request.param,) + _pair(jcfg, tcfg, 3, 24)


def test_hand_config_chunks_and_paged_decode_match_jax(hand):
    """Chunked prefill on the slab scratch (a padded last chunk included)
    and paged decode steps over scattered block chains: logits within
    2e-5 of JAX's, and the K cache the chunks wrote."""
    name, mesh, jm, jp, tm, tp = hand
    V = tm.cfg.vocab_size
    C, S_max = 8, 24
    rng = np.random.default_rng(4)
    jcache, tcache = jm.init_cache(1, S_max), tm.init_cache(1, S_max)
    fn = jax.jit(lambda p, t, c, pos, last: jm.prefill_chunk(p, t, c, pos,
                                                             last),
                 static_argnums=(4,))
    for start, last in ((0, C - 1), (C, C - 1), (2 * C, 4)):
        toks = rng.integers(0, V, (1, C)).astype(np.int32)
        with mesh:
            jl, jcache, _, _ = fn(jp, toks, jcache, jnp.int32(start), last)
        tl, tcache, _, _ = tm.prefill_chunk(tp, torch.from_numpy(toks),
                                            tcache, start, last)
        _close(tl, jl)
    kj = np.asarray(jcache["stack"]["blocks"]["sub0"].k)
    kt = tcache["stack"]["blocks"]["sub0"].k.numpy()
    np.testing.assert_allclose(kt[:, :, :2 * C + 5], kj[:, :, :2 * C + 5],
                               atol=TOL)
    B, bs = 3, 4
    bt = np.asarray([[3, 7, 1, 0], [2, 5, 0, 0], [9, 4, 11, 6]], np.int32)
    jpool, tpool = jm.init_paged_cache(12, bs), tm.init_paged_cache(12, bs)
    pos = np.asarray([0, 3, 6], np.int32)
    active = np.asarray([True, True, False])
    step = jax.jit(lambda p, t, c, pos, a, bt: jm.decode_step(
        p, t, c, pos, active_mask=a, block_table=bt, block_size=bs))
    for _ in range(5):
        tok = rng.integers(0, V, (B, 1)).astype(np.int32)
        with mesh:
            jl, jpool, _, _ = step(jp, tok, jpool, pos, active, bt)
        tl, tpool, _, _ = tm.decode_step(
            tp, torch.from_numpy(tok), tpool, torch.from_numpy(pos),
            active_mask=torch.from_numpy(active),
            block_table=torch.from_numpy(bt), block_size=bs)
        _close(tl[torch.from_numpy(active)], np.asarray(jl)[active])
        pos = pos + 1


@pytest.mark.parametrize("pool", ["slab", "paged"])
def test_hand_config_engine_matches_jax_engine(hand, pool):
    name, mesh, jm, jp, tm, tp = hand
    _engines_agree(mesh, jm, jp, tm, tp, _trace, dict(
        max_slots=3, prompt_len=12, max_new_tokens=6, prefill_chunk=4,
        kv_block_size=4, paged=pool == "paged"))


# ----------------------------------------------------------------------
# the engine on TINY
# ----------------------------------------------------------------------
def _trace(make, vocab=64):
    rng = np.random.default_rng(3)
    return [make(rid=i, tokens=rng.integers(
                0, vocab, (int(rng.integers(3, 13)),)).astype(np.int32),
                 max_new_tokens=6, arrival_time=0.3 * i) for i in range(6)]


def _prefix_trace(make, vocab=64):
    """A shared 8-token prefix (two blocks of 4) under most prompts."""
    rng = np.random.default_rng(5)
    shared = rng.integers(0, vocab, (8,)).astype(np.int32)
    out = []
    for i in range(6):
        tail = rng.integers(0, vocab, (int(rng.integers(1, 5)),))
        toks = (np.concatenate([shared, tail]) if i % 3 else
                rng.integers(0, vocab, (10,)))
        out.append(make(rid=i, tokens=toks.astype(np.int32),
                        max_new_tokens=6, arrival_time=0.3 * i))
    return out


def _motif_trace(make, vocab=64):
    """Prompts tiled from short motifs, where the n-gram drafts land."""
    rng = np.random.default_rng(6)
    out = []
    for i in range(4):
        motif = rng.integers(0, vocab, (3,)).astype(np.int32)
        out.append(make(rid=i, tokens=np.tile(motif, 4)[:11],
                        max_new_tokens=8, arrival_time=0.2 * i))
    return out


def _key_paths(tree, path=()):
    out = set()
    if isinstance(tree, dict):
        for k, v in tree.items():
            out.add(path + (k,))
            out |= _key_paths(v, path + (k,))
    return out


def _engines_agree(mesh, jm, jp, tm, tp, trace, kw):
    """The JAX engine and the port's on ``trace`` under ``kw``: streams,
    admissions, preemptions, counters and key paths equal; returns the
    port's report."""
    je = JEngine(jm, jp, jax_ecfg(jm.cfg, **kw), mesh=mesh,
                 clock=JClock(0.1))
    with mesh:
        out_j, rep_j = captured_run(je, trace(JRequest))
    te = ServeEngine(tm, tp, engine_config_for(tm.cfg, **kw),
                     clock=VirtualClock(0.1), device="cpu")
    out_t, rep_t = captured_run(te, trace(Request))
    assert out_t == out_j
    assert te.front.slot_history == je.slot_history
    for key in ("n_requests", "decode_steps", "prefill_chunks",
                "preemptions", "total_new_tokens", "max_occupancy",
                "prefix_hit_rate", "speculative"):
        assert rep_t.get(key) == rep_j.get(key), key
    for a, b in zip(rep_t["requests"], rep_j["requests"]):
        for key in ("rid", "ttft", "tpot", "e2e", "cached_prefix_tokens"):
            assert a.get(key) == pytest.approx(b.get(key)), key
    assert _key_paths(rep_t) - _key_paths(rep_j) == {("engine", "device")}
    assert _key_paths(rep_j) <= _key_paths(rep_t)
    assert "moe" not in rep_t and "load_balance" not in rep_t
    assert rep_t["jit_entries"].keys() == rep_j["jit_entries"].keys()
    if kw.get("paged"):
        assert te._alloc.blocks_in_use == 0
    return rep_t


@pytest.fixture(scope="module")
def tiny():
    return _pair(JaxModelConfig(**TINY), ModelConfig(**TINY), 3, 16)


@pytest.mark.parametrize("paged", [False, True])
def test_engine_matches_one_shot_driver(tiny, paged):
    """``test_serve_engine.py::test_engine_matches_one_shot_driver``:
    chunked prefill (10 = 4 + 4 + 2) and slotted decode give the one-shot
    driver's tokens, on the slab and the paged pool; the one-shot driver
    is the port's ``prefill`` + ``decode_step``, and JAX's gives the same
    tokens."""
    mesh, jm, jp, tm, tp = tiny
    L, gen = 10, 6
    prompt = np.random.default_rng(3).integers(
        0, 64, (L,)).astype(np.int32)
    te = ServeEngine(tm, tp, engine_config_for(
        tm.cfg, max_slots=1, prompt_len=L, max_new_tokens=gen,
        prefill_chunk=4, paged=paged, kv_block_size=4),
        clock=VirtualClock(0.5), device="cpu")
    outputs, rep = captured_run(
        te, [Request(rid=0, tokens=prompt, max_new_tokens=gen)])
    s_max = te.ecfg.max_seq_len
    logits, caches, pos, _ = tm.prefill(
        tp, {"tokens": torch.from_numpy(prompt[None])}, s_max=s_max)
    ref = [int(logits.argmax(-1)[0])]
    with mesh:
        jl, jc, jpos, _ = jm.prefill(jp, {"tokens": jnp.asarray(prompt[None])},
                                     s_max=s_max)
    jref = [int(jnp.argmax(jl, -1)[0])]
    for _ in range(gen - 1):
        tok = torch.tensor([[ref[-1]]], dtype=torch.int32)
        logits, caches, pos, _ = tm.decode_step(tp, tok, caches, pos)
        ref.append(int(logits.argmax(-1)[0]))
        with mesh:
            jl, jc, jpos, _ = jm.decode_step(
                jp, jnp.asarray([[jref[-1]]], jnp.int32), jc, jpos)
        jref.append(int(jnp.argmax(jl, -1)[0]))
    assert outputs[0] == ref == jref
    assert rep["n_requests"] == 1 and rep["total_new_tokens"] == gen
    assert rep["jit_entries"].keys() == {"prefill_chunk", "decode",
                                         "write_blocks" if paged
                                         else "write_slot"}


CASES = {
    "slab": (_trace, dict()),
    "paged": (_trace, dict(paged=True)),
    # 7 blocks of 4 tokens for 3 slots: the allocator runs dry
    "paged_preempt": (_trace, dict(paged=True, num_kv_blocks=7)),
    "prefix": (_prefix_trace, dict(paged=True, prefix_sharing=True)),
    "speculative": (_motif_trace, dict(paged=True, speculative_k=3)),
}


@pytest.mark.parametrize("case", list(CASES))
def test_tiny_engine_matches_jax_engine(tiny, case):
    mesh, jm, jp, tm, tp = tiny
    trace, extra = CASES[case]
    rep = _engines_agree(mesh, jm, jp, tm, tp, trace, dict(
        max_slots=3, prompt_len=12, max_new_tokens=8, prefill_chunk=4,
        kv_block_size=4, **extra))
    if case == "paged_preempt":
        assert rep["preemptions"] > 0
    if case == "prefix":
        assert rep["prefix_hit_rate"] > 0
    if case == "speculative":
        assert rep["speculative"]["accepted"] > 0
