"""The port's chunked cross-entropy, AdamW, int8 compression and data
pipeline against the JAX package's (mirrors ``tests/test_losses_optim.py``).

Tolerances: the cross-entropy's value and gradients within 1e-5
(relative; f32, the chunks' sums ordered as JAX's); AdamW within 1e-6
over three steps (f32 elementwise arithmetic); the int8 quantizer on
JAX's own rounding noise exactly (q) and to the float (scale);
``compressed_psum`` on ``VirtualGroup(4)`` against JAX's on a 4-device
mesh within 1e-6; the data pipeline's batches exactly.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.data import pipeline as jax_pipeline
from repro.models.losses import chunked_softmax_xent as jax_xent
from repro.optim.adamw import adamw_init as jax_adamw_init
from repro.optim.adamw import adamw_update as jax_adamw_update
from repro.optim.compress import quantize_int8 as jax_quantize
from repro_torch import tree
from repro_torch.convert import to_torch
from repro_torch.core.dispatch import LocalComm, VirtualGroup
from repro_torch.data import pipeline
from repro_torch.models.losses import chunked_softmax_xent, logits_head
from repro_torch.optim.adamw import AdamWState, adamw_init, adamw_update
from repro_torch.optim.compress import (compressed_psum, dequantize_int8,
                                        quantize_int8, uniform_noise)

from _ep_helpers import one_torch_thread, run_jax  # noqa: F401

XENT_TOL = 1e-5
ADAM_TOL = 1e-6


def _xent_case(seed, S, chunk, softcap=0.0, ignore=False):
    B, d, V, Vp = 2, 8, 50, 64
    rng = np.random.default_rng(seed)
    h = rng.normal(size=(B, S, d)).astype(np.float32)
    w = (rng.normal(size=(Vp, d)) * 0.1).astype(np.float32)
    labels = rng.integers(0, V, (B, S)).astype(np.int32)
    if ignore:
        labels[:, ::3] = -1
    return h, w, labels, V


@pytest.mark.parametrize("seed,S,chunk,softcap,ignore", [
    (0, 5, 4, 0.0, False), (1, 16, 8, 0.0, False), (2, 33, 8, 0.0, True),
    (3, 33, 64, 30.0, False), (4, 8, 4, 30.0, True), (5, 17, 16, 5.0, True)])
def test_chunked_xent_value_and_grads_match_jax(seed, S, chunk, softcap,
                                                ignore):
    """Ragged last chunks, the softcap, ignored labels and the padded
    vocabulary: the value and the gradients of hidden and w_vocab."""
    h, w, labels, V = _xent_case(seed, S, chunk, softcap, ignore)
    fn = lambda h_, w_: jax_xent(h_, w_, labels, real_vocab=V, chunk=chunk,
                                 softcap=softcap)
    jv, (jgh, jgw) = jax.value_and_grad(fn, argnums=(0, 1))(h, w)
    th = torch.from_numpy(h).requires_grad_(True)
    tw = torch.from_numpy(w).requires_grad_(True)
    tv = chunked_softmax_xent(th, tw, torch.from_numpy(labels), real_vocab=V,
                              chunk=chunk, softcap=softcap)
    tv.backward()
    np.testing.assert_allclose(float(tv.detach()), float(jv), rtol=XENT_TOL)
    for got, want in ((th.grad, jgh), (tw.grad, jgw)):
        np.testing.assert_allclose(got.numpy(), np.asarray(want),
                                   atol=XENT_TOL * float(np.abs(want).max()),
                                   rtol=XENT_TOL)


def test_chunked_xent_matches_full_softmax():
    """The plain definition: log-sum-exp minus the label logit, averaged."""
    h, w, labels, V = _xent_case(7, 33, 8)
    got = chunked_softmax_xent(torch.from_numpy(h), torch.from_numpy(w),
                               torch.from_numpy(labels), real_vocab=V, chunk=8)
    logits = torch.from_numpy(h) @ torch.from_numpy(w).T
    logits[..., V:] = -1e30
    want = torch.nn.functional.cross_entropy(
        logits.reshape(-1, logits.shape[-1]),
        torch.from_numpy(labels).long().reshape(-1))
    np.testing.assert_allclose(float(got), float(want), rtol=XENT_TOL)


def test_chunked_xent_all_ignored_is_zero():
    h, w, labels, V = _xent_case(8, 8, 4)
    labels[:] = -1
    got = chunked_softmax_xent(torch.from_numpy(h), torch.from_numpy(w),
                               torch.from_numpy(labels), real_vocab=V, chunk=4)
    assert float(got) == 0.0


def test_chunked_xent_checkpoints_each_chunk(monkeypatch):
    """Under grad each chunk goes through ``torch.utils.checkpoint``; under
    ``no_grad`` none does."""
    from repro_torch.models import losses
    calls = []
    orig = losses.checkpoint

    def spy(*a, **k):
        calls.append(1)
        return orig(*a, **k)
    monkeypatch.setattr(losses, "checkpoint", spy)
    h, w, labels, V = _xent_case(9, 33, 8)
    th = torch.from_numpy(h).requires_grad_(True)
    chunked_softmax_xent(th, torch.from_numpy(w), torch.from_numpy(labels),
                         real_vocab=V, chunk=8).backward()
    assert len(calls) == 5
    with torch.no_grad():
        chunked_softmax_xent(th, torch.from_numpy(w),
                             torch.from_numpy(labels), real_vocab=V, chunk=8)
    assert len(calls) == 5


def test_logits_head_masks_padded_vocab():
    logits = logits_head(torch.ones(2, 4), torch.ones(8, 4), real_vocab=5)
    assert (logits[:, 5:] < -1e20).all() and (logits[:, :5] == 4).all()


def _tree(seed):
    rng = np.random.default_rng(seed)
    return {"w": rng.normal(size=(5, 3)).astype(np.float32),
            "b": {"c": rng.normal(size=(7,)).astype(np.float32),
                  "h": (rng.normal(size=(4, 2)) * 3).astype(np.float32)}}


@pytest.mark.parametrize("bf16", [False, True])
def test_adamw_matches_jax(bf16):
    """Three steps with the global-norm clip active, against JAX's; with a
    bfloat16 leaf updated in f32 and cast back."""
    p = _tree(0)
    jp = jax.tree.map(jnp.asarray, p)
    if bf16:
        jp["b"]["h"] = jp["b"]["h"].astype(jnp.bfloat16)
    tp = to_torch(jax.device_get(jp), device="cpu")
    js, ts = jax_adamw_init(jp), adamw_init(tp)
    for step in range(3):
        g = jax.tree.map(lambda x: x * 4.0, _tree(10 + step))  # norm > 1
        jp, js = jax_adamw_update(g, js, jp, lr=1e-2)
        tp, ts = adamw_update(to_torch(g, device="cpu"), ts, tp, lr=1e-2)
    assert int(ts.step) == int(js.step) == 3 and ts.step.dtype == torch.int32
    for a, b in zip(tree.leaves(tp), jax.tree.leaves(jp)):
        assert a.dtype == (torch.bfloat16 if b.dtype == jnp.bfloat16
                           else torch.float32)
        np.testing.assert_allclose(a.float().numpy(),
                                   np.asarray(b, np.float32),
                                   atol=ADAM_TOL if not bf16 else 1e-2,
                                   rtol=ADAM_TOL)
    for a, b in zip(tree.leaves((ts.m, ts.v)), jax.tree.leaves((js.m, js.v))):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), atol=ADAM_TOL,
                                   rtol=1e-5)


def test_adamw_matches_numpy_reference():
    params = {"w": torch.tensor([1.0, -2.0, 3.0])}
    grads = {"w": torch.tensor([0.1, 0.2, -0.1])}
    state = adamw_init(params)
    lr, b1, b2, eps, wd = 1e-2, 0.9, 0.95, 1e-8, 0.1
    p_np, m, v = np.array([1.0, -2.0, 3.0]), np.zeros(3), np.zeros(3)
    p, s = params, state
    for t in range(1, 4):
        p, s = adamw_update(grads, s, p, lr=lr, b1=b1, b2=b2, eps=eps,
                            weight_decay=wd, grad_clip=1e9)
        g = np.array([0.1, 0.2, -0.1])
        m = b1 * m + (1 - b1) * g
        v = b2 * v + (1 - b2) * g * g
        mh, vh = m / (1 - b1 ** t), v / (1 - b2 ** t)
        p_np = p_np - lr * (mh / (np.sqrt(vh) + eps) + wd * p_np)
        np.testing.assert_allclose(p["w"].numpy(), p_np, rtol=1e-5)


def test_adamw_grad_clip_and_slices(monkeypatch):
    """The clip scales a norm-200 gradient to 1; a leaf longer than a slice
    is updated a slice at a time with the same result."""
    from repro_torch.optim import adamw
    params = {"w": torch.ones((4,))}
    p1, _ = adamw_update({"w": torch.full((4,), 100.0)}, adamw_init(params),
                         params, lr=1.0, weight_decay=0.0, grad_clip=1.0)
    assert (p1["w"] - 1.0).abs().max() <= 1.01
    g = {"w": torch.randn(1000, generator=torch.Generator().manual_seed(0))}
    whole = {"w": torch.ones(1000)}
    adamw_update(g, adamw_init(whole), whole)
    monkeypatch.setattr(adamw, "_SLICE", 64)
    sliced = {"w": torch.ones(1000)}
    adamw_update(g, adamw_init(sliced), sliced)
    assert torch.equal(whole["w"], sliced["w"])


def test_adamw_state_is_jax_shaped():
    s = adamw_init({"a": torch.zeros(3, dtype=torch.bfloat16)})
    assert isinstance(s, AdamWState) and s._fields == ("step", "m", "v")
    assert s.m["a"].dtype == torch.float32 and s.step.ndim == 0


@pytest.mark.parametrize("seed", [0, 1, 2, 3])
def test_quantize_int8_on_jax_noise(seed):
    """JAX's stochastic rounding noise fed to the port: the same int8 codes
    and scale; the round trip within one quantization step."""
    key = jax.random.PRNGKey(seed)
    x = np.array(jax.random.normal(key, (256,)) * 10)
    kq = jax.random.fold_in(key, 1)
    jq, js = jax_quantize(x, kq)
    noise = jax.random.uniform(kq, x.shape, jnp.float32, -0.5, 0.5)
    tq, ts = quantize_int8(torch.from_numpy(x),
                           torch.from_numpy(np.array(noise)))
    assert tq.dtype == torch.int8
    np.testing.assert_array_equal(tq.numpy(), np.asarray(jq))
    np.testing.assert_allclose(float(ts), float(js), rtol=1e-7)
    err = (dequantize_int8(tq, ts) - torch.from_numpy(x)).abs()
    assert float(err.max()) <= float(ts) * 1.01


def test_uniform_noise_range():
    z = uniform_noise((4096,), torch.Generator().manual_seed(0))
    assert z.dtype == torch.float32 and -0.5 <= float(z.min()) \
        and float(z.max()) < 0.5


COMPRESS_BODY = '''
import numpy as np
import jax, jax.numpy as jnp
from functools import partial
from jax.experimental.shard_map import shard_map
from jax.sharding import PartitionSpec as P
from repro.launch.mesh import make_mesh
from repro.optim.compress import compressed_psum
mesh = make_mesh((4,), ("data",))
rng = np.random.default_rng(0)
g = {"a": rng.normal(size=(4, 6)).astype(np.float32),
     "b": {"c": (rng.normal(size=(4, 3, 2)) * 5).astype(np.float32)}}
e = {"a": (rng.normal(size=(4, 6)) * 0.01).astype(np.float32),
     "b": {"c": np.zeros((4, 3, 2), np.float32)}}
key = jax.random.PRNGKey(3)

@partial(shard_map, mesh=mesh, in_specs=(P("data"), P("data"), P()),
         out_specs=(P("data"), P("data")), check_rep=False)
def run(g, e, key):
    g = jax.tree.map(lambda x: x[0], g)
    e = jax.tree.map(lambda x: x[0], e)
    m, ne = compressed_psum(g, e, key, axis_name="data")
    return (jax.tree.map(lambda x: x[None], m),
            jax.tree.map(lambda x: x[None], ne))
m, ne = jax.jit(run)(g, e, key)
noise = {"a": jax.random.uniform(jax.random.fold_in(key, 0), (6,),
                                 jnp.float32, -0.5, 0.5),
         "b/c": jax.random.uniform(jax.random.fold_in(key, 1), (3, 2),
                                   jnp.float32, -0.5, 0.5)}
np.savez(OUT, g_a=g["a"], g_c=g["b"]["c"], e_a=e["a"], e_c=e["b"]["c"],
         m_a=np.asarray(m["a"]), m_c=np.asarray(m["b"]["c"]),
         ne_a=np.asarray(ne["a"]), ne_c=np.asarray(ne["b"]["c"]),
         z_a=np.asarray(noise["a"]), z_c=np.asarray(noise["b/c"]))
'''


def test_compressed_psum_on_virtual_group_matches_jax(tmp_path):
    """Four ranks' gradients and error buffers through the shared-scale
    int8 sum on ``VirtualGroup(4)``, on JAX's per-leaf noise, against
    JAX's ``compressed_psum`` under ``shard_map`` on 4 devices."""
    r = run_jax(COMPRESS_BODY, tmp_path / "c.npz")
    per = lambda a, c, g: {"a": torch.from_numpy(r[a][g]),
                           "b": {"c": torch.from_numpy(r[c][g])}}
    grads = [per("g_a", "g_c", g) for g in range(4)]
    errs = [per("e_a", "e_c", g) for g in range(4)]
    noise = [{"a": torch.from_numpy(r["z_a"]),
              "b": {"c": torch.from_numpy(r["z_c"])}}] * 4
    means, new_errs = compressed_psum(grads, errs, noise,
                                      VirtualGroup(4, "cpu"))
    for g in range(4):
        np.testing.assert_allclose(means[g]["a"].numpy(), r["m_a"][g],
                                   atol=1e-6)
        np.testing.assert_allclose(means[g]["b"]["c"].numpy(), r["m_c"][g],
                                   atol=1e-6)
        np.testing.assert_allclose(new_errs[g]["a"].numpy(), r["ne_a"][g],
                                   atol=1e-6)
        np.testing.assert_allclose(new_errs[g]["b"]["c"].numpy(),
                                   r["ne_c"][g], atol=1e-6)
    # the mean is near the true mean (within the shared quantization step)
    true = sum(x["b"]["c"] for x in grads) / 4
    assert float((means[0]["b"]["c"] - true).abs().max()) < 0.2


def test_compressed_psum_single_rank_is_quantize():
    g = {"a": torch.randn(8, generator=torch.Generator().manual_seed(1))}
    z = {"a": torch.zeros(8)}
    (m,), (e,) = compressed_psum([g], [z], [z], LocalComm())
    q, s = quantize_int8(g["a"], z["a"])
    assert torch.equal(m["a"], dequantize_int8(q, s))
    assert torch.allclose(e["a"], g["a"] - m["a"])


@pytest.mark.parametrize("kind", ["random", "constant", "zipf"])
@pytest.mark.parametrize("seed", [0, 5])
def test_synthetic_batches_equal_jax(kind, seed):
    ours = pipeline.synthetic_batches(kind, batch=3, seq_len=17, vocab=300,
                                      seed=seed)
    theirs = jax_pipeline.synthetic_batches(kind, batch=3, seq_len=17,
                                            vocab=300, seed=seed)
    for _ in range(4):
        a, b = next(ours), next(theirs)
        assert sorted(a) == sorted(b) == ["labels", "tokens"]
        for k in a:
            assert a[k].dtype == b[k].dtype
            np.testing.assert_array_equal(a[k], b[k])


def test_tokenizer_and_prefetch_loader():
    tok, jtok = pipeline.ByteTokenizer(), jax_pipeline.ByteTokenizer()
    ids = tok.encode("héllo, world")
    np.testing.assert_array_equal(ids, jtok.encode("héllo, world"))
    assert tok.decode(ids) == "héllo, world" and tok.vocab_size == 258
    loader = pipeline.PrefetchLoader(iter(range(10)), depth=2)
    assert list(loader) == list(range(10))
    loader.close()
