"""whisper-large-v3 and pixtral-12b in the port against the JAX package,
on the CPU, on weights converted from JAX and inputs drawn from a seed
(reduced, f32: whisper 2 encoder layers over 32 frames and 4 decoder
layers, LayerNorm, absolute sinusoidal positions, no RoPE; pixtral 8
prefix patch embeddings before the tokens).

- ``sinusoidal_positions``, JAX's ``d // 2 - 1`` divisor; the cache-less
  ``attention_block`` (full attention, ``kv_source``).
- whisper: the encoder (full attention, plain in both), each decoder
  layer's cross K/V, ``prefill`` and two greedy ``decode_step``s
  (``test_models.py::test_arch_smoke_decode``'s calls) within 2e-5 of
  JAX's, the cross K/V read from the cache at decode; positions past the
  build-time table (``seq_len + 65`` rows), clamped as JAX's slice (a
  scalar offset) and gather (per-row offsets) clamp them.
- pixtral: ``prefill`` with the patches and two ``decode_step``s, on
  ``test_arch_smoke_decode``'s slab of S + 8 positions, which the prefix
  fills, so that each decode write past it lands on its last position
  (JAX's clamped ``dynamic_update_slice``).
- The serve engine's refusal of both, in JAX's words, and the CLI's,
  which names ``--arch`` and draws no weights; ``prefill_chunk`` and the
  paged pool refuse whisper."""
import dataclasses
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
from repro.models.model import MeshShape, _cross_kv
from repro.models.model import build_model as jax_build
from repro.serve import EngineConfig as JEngineConfig
from repro.serve import ServeEngine as JEngine
from repro_torch.configs.registry import get_config
from repro_torch.convert import to_torch
from repro_torch.launch import serve as TCLI
from repro_torch.models import attention as TA
from repro_torch.models import layers as TL
from repro_torch.models import model as TM
from repro_torch.models.model import build_model
from repro_torch.serve import EngineConfig, ServeEngine

from _ep_helpers import one_torch_thread  # noqa: F401 (autouse)

TOL = 2e-5
ARCHS = ["whisper-large-v3", "pixtral-12b"]


def _close(port, ref, tol=TOL):
    np.testing.assert_allclose(port.detach().numpy(), np.asarray(ref),
                               atol=tol, rtol=tol)


def _pair(arch, batch, seq_len):
    jcfg = jax_config(arch).reduced().replace(dtype="float32")
    tcfg = get_config(arch).reduced().replace(dtype="float32")
    mesh = make_host_mesh(1, 1)
    ms = MeshShape(tuple(zip(mesh.axis_names, mesh.devices.shape)))
    jm = jax_build(jcfg, JPC(attn_chunk=8, loss_chunk=8), batch=batch,
                   seq_len=seq_len, mesh_shape=ms, mesh=mesh)
    with mesh:
        jp = jm.init(jax.random.PRNGKey(0))
    tm = build_model(tcfg, batch=batch, seq_len=seq_len, device="cpu")
    tp = to_torch(jax.device_get(jp), device="cpu")
    return mesh, jm, jp, tm, tp


def _batch(cfg, B, S, seed):
    rng = np.random.default_rng(seed)
    batch = {"tokens": rng.integers(0, cfg.vocab_size, (B, S)).astype(
        np.int32)}
    if cfg.is_encoder_decoder:
        batch["frames"] = rng.standard_normal(
            (B, cfg.encoder_seq_len, cfg.d_model)).astype(np.float32)
    if cfg.num_prefix_embeddings:
        batch["patches"] = rng.standard_normal(
            (B, cfg.num_prefix_embeddings, cfg.d_model)).astype(np.float32)
    return batch


def _torch_batch(batch):
    return {k: torch.from_numpy(v) for k, v in batch.items()}


@pytest.mark.parametrize("S,d", [(32, 128), (81, 128), (97, 64), (12, 10)])
def test_sinusoidal_positions_match_jax(S, d):
    got = TL.sinusoidal_positions(S, d)
    assert got.dtype == torch.float32 and got.shape == (S, d)
    _close(got, JL.sinusoidal_positions(S, d))


def test_whisper_layout_and_encoder_match_jax():
    """The parameter tree (encoder stack and final norm, the stacked
    ``cross`` leaves) equals JAX's leaf for leaf, the port's own init gives
    the same shapes; the encoder and each layer's cross K/V are JAX's."""
    mesh, jm, jp, tm, tp = _pair("whisper-large-v3", 2, 16)
    cfg = tm.cfg
    assert set(tp) == {"embed", "final_norm", "stack", "encoder", "cross"}
    assert set(tp["cross"]) == {"norm", "attn"}
    assert tp["cross"]["attn"]["wk"].shape[0] == cfg.num_layers

    def shapes(t, path=""):
        if isinstance(t, dict):
            return {k2: v2 for k, v in t.items()
                    for k2, v2 in shapes(v, f"{path}/{k}").items()}
        return {path: tuple(t.shape)}
    assert shapes(tm.init(0)) == shapes(tp)
    frames = _batch(cfg, 2, 4, seed=0)["frames"]
    enc_cfg = dataclasses.replace(jm.cfg, num_layers=cfg.encoder_layers,
                                  is_encoder_decoder=False)
    h = jnp.asarray(frames) + JL.sinusoidal_positions(
        frames.shape[1], cfg.d_model)[None]
    h, _, _ = JT.run_stack(h, jp["encoder"]["stack"], enc_cfg,
                           JPC(attn_chunk=8), mode="encode", moe_spec=None,
                           mesh=None, causal=False)
    ref = JL.norm(h, jp["encoder"]["final_norm"], cfg.norm)
    got = tm.encode(tp, torch.from_numpy(frames))
    _close(got, ref)
    jkv = _cross_kv(jp, ref, jm.cfg)
    tkv = TM._cross_kv(tp, got)
    _close(tkv.k, jkv.k)
    _close(tkv.v, jkv.v)


@pytest.mark.parametrize("kv", ["self", "kv_source"])
def test_attention_block_without_cache_matches_jax(kv):
    """The cache-less branch on whisper's attention: full (non-causal)
    self-attention, the encoder's, and attention over ``kv_source`` (keys
    from another sequence, no RoPE); plain in both, JAX's reason logged."""
    mesh, jm, jp, tm, tp = _pair("whisper-large-v3", 2, 8)
    rng = np.random.default_rng(5)
    x = rng.standard_normal((2, 7, tm.cfg.d_model)).astype(np.float32)
    src = rng.standard_normal((2, 11, tm.cfg.d_model)).astype(np.float32)
    jw = jax.tree.map(lambda a: a[0], jp["cross"]["attn"])
    tw = {k: v[0] for k, v in tp["cross"]["attn"].items()}
    kw = (dict(causal=False) if kv == "self" else
          dict(causal=False, kv_source=src))
    ref, _ = JA.attention_block(
        jnp.asarray(x), jw, jm.cfg, attn_chunk=4,
        **{k: jnp.asarray(v) if k == "kv_source" else v
           for k, v in kw.items()})
    TA.reset_dispatch_log()
    got, cache = TA.attention_block(
        torch.from_numpy(x), tw, tm.cfg, q_offset=0, cache=None,
        **{k: torch.from_numpy(v) if k == "kv_source" else v
           for k, v in kw.items()})
    assert cache is None
    _close(got, ref)
    rec = TA.dispatch_log()[-1]
    assert (rec["branch"], rec["fused"]) == ("prefill", False)
    assert "causal=False" in rec["reason"]


@pytest.mark.parametrize("arch", ARCHS)
def test_prefill_and_decode_match_jax(arch):
    """``test_arch_smoke_decode``'s calls in f32: prefill of B 2 x S 16 on a
    slab of S + 8, then two greedy decode steps; logits within 2e-5 and
    equal tokens.  Whisper's decode reads the cross K/V from the cache."""
    B, S = 2, 16
    mesh, jm, jp, tm, tp = _pair(arch, B, S)
    batch = _batch(tm.cfg, B, S, seed=1)
    with mesh:
        jl, jc, jpos, _ = jax.jit(lambda p, b: jm.prefill(
            p, b, s_max=S + 8))(jp, batch)
    tl, tc, tpos, diags = tm.prefill(tp, _torch_batch(batch), s_max=S + 8)
    assert diags == {}
    _close(tl, jl)
    assert int(tpos) == int(jpos) == S + tm.cfg.num_prefix_embeddings
    if arch == "whisper-large-v3":
        _close(tc["cross"].k, jc["cross"].k)
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
    key = "blocks"
    _close(tc["stack"][key]["sub0"].k, jc["stack"][key]["sub0"].k)


@pytest.mark.parametrize("per_row", [False, True], ids=["scalar", "per_row"])
def test_whisper_positions_past_the_table_clamp_as_jax(per_row):
    """A model built at seq_len 4 has a position table of 69 rows: a
    66-token prompt, then decode steps at positions 66-71, the last three
    past the table.  JAX clamps (a scalar offset's slice starts at most at
    row 68; per-row gather indices stop at row 68) and so does the port."""
    B, S = 2, 66
    mesh, jm, jp, tm, tp = _pair("whisper-large-v3", B, 4)
    batch = _batch(tm.cfg, B, S, seed=2)
    with mesh:
        jl, jc, jpos, _ = jax.jit(lambda p, b: jm.prefill(
            p, b, s_max=S + 8))(jp, batch)
    tl, tc, tpos, _ = tm.prefill(tp, _torch_batch(batch), s_max=S + 8)
    _close(tl, jl)
    if per_row:
        jpos = jnp.full((B,), S, jnp.int32)
        tpos = torch.full((B,), S, dtype=torch.int32)
    step = jax.jit(jm.decode_step)
    tok = np.asarray(jnp.argmax(jl, -1)[:, None]).astype(np.int32)
    for _ in range(6):
        with mesh:
            jl, jc, jpos, _ = step(jp, tok, jc, jpos)
        tl, tc, tpos, _ = tm.decode_step(tp, torch.from_numpy(tok), tc, tpos)
        _close(tl, jl)
        tok = np.asarray(jnp.argmax(jl, -1)[:, None]).astype(np.int32)
    assert int(tpos.reshape(-1)[0]) == S + 6 > 69
    # the clamp is what JAX does: the positions past the table reuse its
    # last row
    emb = tm._embed_tokens(tp, torch.zeros((1, 1), dtype=torch.long),
                           torch.tensor(71))
    last = tm._embed_tokens(tp, torch.zeros((1, 1), dtype=torch.long),
                            torch.tensor(68))
    assert torch.equal(emb, last)


def test_pixtral_decode_past_a_full_slab_clamps_as_jax():
    """pixtral's prefix fills the S + 8 slab of ``test_arch_smoke_decode``
    (8 patches + 16 tokens = 24): a decode step's write at position 24
    lands on position 23, as JAX's ``dynamic_update_slice`` clamps it."""
    B, S = 2, 16
    mesh, jm, jp, tm, tp = _pair("pixtral-12b", B, S)
    batch = _batch(tm.cfg, B, S, seed=3)
    _, tc, tpos, _ = tm.prefill(tp, _torch_batch(batch), s_max=S + 8)
    k0 = tc["stack"]["blocks"]["sub0"].k.clone()
    tok = torch.zeros((B, 1), dtype=torch.int32)
    tm.decode_step(tp, tok, tc, tpos)
    k1 = tc["stack"]["blocks"]["sub0"].k
    assert torch.equal(k1[:, :, :23], k0[:, :, :23])
    assert not torch.equal(k1[:, :, 23], k0[:, :, 23])


@pytest.mark.parametrize("arch", ARCHS)
def test_engine_and_cli_refuse_as_jax(arch, monkeypatch):
    B, S = 2, 8
    mesh, jm, jp, tm, tp = _pair(arch, B, S)
    with pytest.raises(NotImplementedError) as jerr:
        JEngine(jm, jp, JEngineConfig(max_slots=2, max_seq_len=32),
                mesh=mesh)
    with pytest.raises(NotImplementedError) as err:
        ServeEngine(tm, tp, EngineConfig(max_slots=2, max_seq_len=32),
                    device="cpu")
    assert str(err.value) == str(jerr.value)
    argv = ["--arch", arch, "--reduced", "--batch", "2", "--prompt-len",
            "8", "--gen", "2"]
    monkeypatch.setattr(sys, "argv", ["serve"] + argv)
    with pytest.raises(NotImplementedError) as jcli:
        JCLI.main()
    monkeypatch.setattr(TM.Model, "init", lambda *a, **k: pytest.fail(
        "the CLI drew weights before refusing"))
    with pytest.raises(NotImplementedError) as cli:
        TCLI.serve(TCLI.build_parser().parse_args(argv), device="cpu")
    assert str(cli.value) == f"--arch {arch}: {jcli.value}"
    if arch == "whisper-large-v3":
        caches = tm.init_cache(B, 16)
        with pytest.raises(NotImplementedError, match="whole prompts"):
            tm.prefill_chunk(tp, torch.zeros((B, 4), dtype=torch.int32),
                             caches, 0)
        with pytest.raises(NotImplementedError,
                           match="plain decoder stacks only"):
            tm.decode_step(tp, torch.zeros((B, 1), dtype=torch.int32),
                           caches, torch.zeros(B, dtype=torch.int32),
                           block_table=torch.zeros((B, 2),
                                                   dtype=torch.int32),
                           block_size=8)
