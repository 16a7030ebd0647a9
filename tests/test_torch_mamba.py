"""The port's Mamba2 block (``repro_torch.models.mamba2``) against the JAX
package's on the same numpy-seeded inputs and JAX's own weights: every
case of ``tests/test_mamba.py`` (the chunked SSD scan against the
recurrence, a resumed scan, prefill then decode against one pass), each
held to JAX's outputs in f32 within 2e-5; the causal conv and the block
with ``valid_len`` (pad positions kept out of the state); and a scan whose
upper-triangle exponents overflow f32, which must stay finite."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jax_config
from repro.models import mamba2 as JM
from repro_torch.configs import get_config
from repro_torch.convert import to_torch
from repro_torch.models import mamba2 as TM

TOL = dict(atol=2e-5, rtol=2e-5)


def _inputs(seed, B, L, H, P, N, dt_scale=1.0, a_scale=1.0):
    rng = np.random.default_rng(seed)
    xh = rng.standard_normal((B, L, H, P)).astype(np.float32)
    dt = np.log1p(np.exp(rng.standard_normal((B, L, H)))).astype(np.float32)
    A = (-np.exp(rng.standard_normal((H,))) * a_scale).astype(np.float32)
    Bs = rng.standard_normal((B, L, N)).astype(np.float32)
    Cs = rng.standard_normal((B, L, N)).astype(np.float32)
    return xh, (dt * dt_scale).astype(np.float32), A, Bs, Cs


def _both(fn_t, fn_j, arrays, **kw):
    t = fn_t(*map(torch.from_numpy, arrays), **kw)
    j = fn_j(*map(jnp.asarray, arrays), **kw)
    return t, j


@pytest.mark.parametrize("L", [7, 16, 37])
@pytest.mark.parametrize("chunk", [4, 8, 16])
def test_ssd_chunked_matches_jax_and_recurrence(L, chunk):
    arrays = _inputs(L * 100 + chunk, 2, L, 3, 4, 8)
    (y, s), (jy, js) = _both(TM.ssd_chunked, JM.ssd_chunked, arrays,
                             chunk=chunk)
    np.testing.assert_allclose(y.numpy(), np.asarray(jy), **TOL)
    np.testing.assert_allclose(s.numpy(), np.asarray(js), **TOL)
    (ry, rs), (jry, jrs) = _both(TM.ssd_recurrent_ref, JM.ssd_recurrent_ref,
                                 arrays)
    np.testing.assert_allclose(ry.numpy(), np.asarray(jry), **TOL)
    np.testing.assert_allclose(rs.numpy(), np.asarray(jrs), **TOL)
    np.testing.assert_allclose(y.numpy(), ry.numpy(), atol=1e-4, rtol=1e-4)
    np.testing.assert_allclose(s.numpy(), rs.numpy(), atol=1e-4, rtol=1e-4)


def test_ssd_initial_state_resume():
    """Splitting a sequence in two with a carried state == one pass, and
    each half equals JAX's."""
    xh, dt, A, Bs, Cs = map(torch.from_numpy, _inputs(0, 1, 32, 2, 4, 8))
    y_full, s_full = TM.ssd_chunked(xh, dt, A, Bs, Cs, chunk=8)
    y1, s1 = TM.ssd_chunked(xh[:, :16], dt[:, :16], A, Bs[:, :16],
                            Cs[:, :16], chunk=8)
    y2, s2 = TM.ssd_chunked(xh[:, 16:], dt[:, 16:], A, Bs[:, 16:],
                            Cs[:, 16:], chunk=8, init_ssm=s1)
    np.testing.assert_allclose(torch.cat([y1, y2], 1).numpy(),
                               y_full.numpy(), atol=1e-4, rtol=1e-4)
    np.testing.assert_allclose(s2.numpy(), s_full.numpy(), atol=1e-4,
                               rtol=1e-4)
    j = [jnp.asarray(t.numpy()) for t in (xh, dt, A, Bs, Cs)]
    _, js1 = JM.ssd_chunked(*(t[:, :16] if t.ndim > 1 else t for t in j),
                            chunk=8)
    jy2, js2 = JM.ssd_chunked(*(t[:, 16:] if t.ndim > 1 else t for t in j),
                              chunk=8, init_ssm=js1)
    np.testing.assert_allclose(y2.numpy(), np.asarray(jy2), **TOL)
    np.testing.assert_allclose(s2.numpy(), np.asarray(js2), **TOL)


def test_ssd_chunked_finite_where_the_upper_triangle_overflows():
    """Steep decays (dt * A ~ -200 a step) make exp(Lcum_q - Lcum_s) above
    the diagonal overflow f32; the reference masks it away after the
    product, the port before the exponential: finite and equal."""
    arrays = _inputs(5, 2, 16, 3, 4, 8, dt_scale=8.0, a_scale=30.0)
    (y, s), (jy, js) = _both(TM.ssd_chunked, JM.ssd_chunked, arrays,
                             chunk=16)
    assert torch.isfinite(y).all() and torch.isfinite(s).all()
    np.testing.assert_allclose(y.numpy(), np.asarray(jy), **TOL)
    np.testing.assert_allclose(s.numpy(), np.asarray(js), **TOL)


@pytest.fixture(scope="module")
def block():
    jcfg = jax_config("mamba2-2.7b").reduced().replace(dtype="float32")
    cfg = get_config("mamba2-2.7b").reduced().replace(dtype="float32")
    jp = JM.init_mamba(jax.random.PRNGKey(0), jcfg, jnp.float32)
    return cfg, jcfg, jp, to_torch(jax.device_get(jp), device="cpu")


def _state(B, cfg, jcfg, seed):
    """A random (non-zero) state, the same on both sides."""
    rng = np.random.default_rng(seed)
    js = JM.init_state(B, jcfg)
    js = JM.MambaState(*(jnp.asarray(rng.standard_normal(t.shape)
                                     .astype(np.float32) * 0.3) for t in js))
    return js, to_torch(jax.device_get(js), device="cpu")


def test_mamba_block_prefill_then_decode_matches_full(block):
    """Block-level: prefill S tokens + decode 1 == the full S + 1 forward,
    and each call equals JAX's."""
    cfg, jcfg, jp, tp = block
    B, S = 1, 13
    x = (np.random.default_rng(1).standard_normal((B, S + 1, cfg.d_model))
         * 0.3).astype(np.float32)
    xt, xj = torch.from_numpy(x), jnp.asarray(x)
    z0 = TM.init_state(B, cfg)
    y_full, _ = TM.mamba_block(xt, tp, cfg, state=z0)
    y1, st = TM.mamba_block(xt[:, :S], tp, cfg, state=TM.init_state(B, cfg))
    y2, st2 = TM.mamba_block(xt[:, S:], tp, cfg, state=st)
    np.testing.assert_allclose(y2.numpy(), y_full[:, S:].numpy(), atol=1e-4,
                               rtol=1e-3)
    jy_full, _ = JM.mamba_block(xj, jp, jcfg, state=JM.init_state(B, jcfg))
    jy1, jst = JM.mamba_block(xj[:, :S], jp, jcfg,
                              state=JM.init_state(B, jcfg))
    jy2, jst2 = JM.mamba_block(xj[:, S:], jp, jcfg, state=jst)
    for t, j in ((y_full, jy_full), (y1, jy1), (y2, jy2)):
        np.testing.assert_allclose(t.numpy(), np.asarray(j), **TOL)
    for t, j in zip(st2, jst2):
        np.testing.assert_allclose(t.numpy(), np.asarray(j), **TOL)


@pytest.mark.parametrize("vlen", [[5, 9], [1, 2], [9, 9], 3])
def test_mamba_block_valid_len_matches_jax(block, vlen):
    """A padded chunk of 9 positions on a carried state, rows with their
    own real lengths (or one for all): outputs at real positions and the
    new state equal JAX's, and the state equals the one of the real
    tokens alone."""
    cfg, jcfg, jp, tp = block
    B, L = 2, 9
    x = (np.random.default_rng(2).standard_normal((B, L, cfg.d_model))
         * 0.3).astype(np.float32)
    js, ts = _state(B, cfg, jcfg, seed=3)
    vl = np.asarray(vlen, np.int32)
    y, st = TM.mamba_block(torch.from_numpy(x), tp, cfg, state=ts,
                           valid_len=torch.from_numpy(vl))
    jy, jst = JM.mamba_block(jnp.asarray(x), jp, jcfg, state=js,
                             valid_len=jnp.asarray(vl))
    lens = np.broadcast_to(vl, (B,))
    for b in range(B):
        np.testing.assert_allclose(y[b, :lens[b]].numpy(),
                                   np.asarray(jy)[b, :lens[b]], **TOL)
    for t, j in zip(st, jst):
        np.testing.assert_allclose(t.numpy(), np.asarray(j), **TOL)
    for b in range(B):
        _, alone = TM.mamba_block(
            torch.from_numpy(x[b:b + 1, :lens[b]]), tp, cfg,
            state=TM.MambaState(*(t[b:b + 1] for t in ts)))
        for t, a in zip(st, alone):
            np.testing.assert_allclose(t[b:b + 1].numpy(), a.numpy(),
                                       atol=1e-5, rtol=1e-5)


@pytest.mark.parametrize("vlen", [None, 0, 2, 6])
def test_causal_conv_matches_jax(vlen):
    rng = np.random.default_rng(4)
    x = rng.standard_normal((2, 6, 5)).astype(np.float32)
    w = rng.standard_normal((4, 5)).astype(np.float32)
    b = rng.standard_normal((5,)).astype(np.float32)
    st = rng.standard_normal((2, 3, 5)).astype(np.float32)
    vl = None if vlen is None else np.int32(vlen)
    y, ns = TM._causal_conv(torch.from_numpy(x), torch.from_numpy(w),
                            torch.from_numpy(b), torch.from_numpy(st),
                            None if vl is None else torch.tensor(vl))
    jy, jns = JM._causal_conv(jnp.asarray(x), jnp.asarray(w), jnp.asarray(b),
                              jnp.asarray(st),
                              None if vl is None else jnp.asarray(vl))
    np.testing.assert_allclose(y.numpy(), np.asarray(jy), **TOL)
    np.testing.assert_array_equal(ns.numpy(), np.asarray(jns))


def test_init_shapes_and_dtypes_are_jax(block):
    """The port's own init builds JAX's leaves: names, shapes, dtypes."""
    cfg, jcfg, jp, _ = block
    from repro_torch.models.model import build_model
    params = build_model(cfg, batch=1, seq_len=8, device="cpu").init(0)
    mine = params["stack"]["blocks"]["sub0"]["mamba"]
    assert set(mine) == set(jp)
    for k, v in jp.items():
        assert tuple(mine[k].shape[1:]) == tuple(v.shape), k
        assert str(mine[k].dtype).split(".")[-1] == str(v.dtype), k
    np.testing.assert_allclose(mine["A_log"][0].numpy(),
                               np.asarray(jp["A_log"]))
