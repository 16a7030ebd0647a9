"""The PyTorch port's whole-prompt prefill and slab decode on reduced
moonshot-v1-16b-a3b (one leading dense layer, then MoE layers) against
the JAX package on the same converted weights: ``prefill`` logits and
every cache leaf, slab ``decode_step`` logits with a scalar and a [B]
position, greedy tokens through ``launch/steps``, and the prefill/decode
consistency pattern of ``tests/test_models.py``.  The JAX side runs both
with ``use_pallas=False`` and with its Pallas kernels in interpret mode.
Tolerance 1e-4, as the port's other model tests: summation order differs
over the 4 layers' products and softmaxes."""
import dataclasses

import jax
import numpy as np
import pytest
import torch

from repro.configs.base import ParallelConfig as JPC
from repro.configs.moonshot_v1_16b_a3b import CONFIG as JAX_MOON
from repro.launch.mesh import make_host_mesh
from repro.launch.steps import make_decode_step as jax_decode_step
from repro.launch.steps import make_prefill_step as jax_prefill_step
from repro.models.model import MeshShape
from repro.models.model import build_model as jax_build
from repro_torch.configs.registry import get_config
from repro_torch.convert import to_torch
from repro_torch.launch.steps import make_decode_step, make_prefill_step
from repro_torch.models import attention as A
from repro_torch.models.model import build_model

TOL = 1e-4
B, S, S_MAX = 2, 16, 24


@pytest.fixture(scope="module")
def models():
    jc = JAX_MOON.reduced()
    mesh = make_host_mesh(1, 1)
    ms = MeshShape(tuple(zip(mesh.axis_names, mesh.devices.shape)))

    def jax_model(use_pallas):
        return jax_build(jc, JPC(attn_chunk=8, loss_chunk=8,
                                 use_pallas=use_pallas),
                         batch=B, seq_len=S, mesh_shape=ms, mesh=mesh)
    jms = {False: jax_model(False), True: jax_model(True)}
    with mesh:
        jp = jms[False].init(jax.random.PRNGKey(0))
    tm = build_model(get_config("moonshot-v1-16b-a3b").reduced(), batch=B,
                     seq_len=S, device="cpu")
    toks = np.random.default_rng(0).integers(
        0, jc.vocab_size, (B, S)).astype(np.int32)
    return mesh, jms, jp, tm, to_torch(jax.device_get(jp), device="cpu"), toks


def _leaves(tree):
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from _leaves(tree[k])
    elif isinstance(tree, (list, tuple)):
        for v in tree:
            yield from _leaves(v)
    else:
        yield tree


def _jax_prefill(models, use_pallas):
    mesh, jms, jp, _, _, toks = models
    with mesh:
        return jax.jit(lambda p, b: jms[use_pallas].prefill(
            p, b, s_max=S_MAX))(jp, {"tokens": toks})


def test_converted_params_keep_lead_list(models):
    _, _, jp, tm, tp, _ = models
    own = tm.init(0)
    assert isinstance(tp["stack"]["lead"], list)
    assert len(tp["stack"]["lead"]) == len(own["stack"]["lead"]) == 1
    flat_j = jax.tree_util.tree_flatten_with_path(jp)[0]
    assert len(flat_j) == sum(1 for _ in _leaves(own))
    for path, leaf in flat_j:
        node_c, node_o = tp, own
        for p in path:
            key = p.idx if hasattr(p, "idx") else p.key
            node_c, node_o = node_c[key], node_o[key]
        assert tuple(node_c.shape) == leaf.shape == tuple(node_o.shape)
        assert node_c.dtype == node_o.dtype


@pytest.mark.parametrize("use_pallas", [False, True])
def test_prefill_logits_and_caches_match_jax(models, use_pallas):
    _, _, _, tm, tp, toks = models
    jl, jcache, jpos, jd = _jax_prefill(models, use_pallas)
    A.reset_dispatch_log()
    tl, tcache, tpos, td = tm.prefill(tp, {"tokens": torch.from_numpy(toks)},
                                      s_max=S_MAX)
    assert [r["branch"] for r in A.dispatch_log()] == ["prefill_cache"] * 4
    assert int(tpos) == int(jpos) == S
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), atol=TOL,
                               rtol=TOL)
    jleaves = list(_leaves(jax.device_get(jcache)))
    tleaves = list(_leaves(tcache))
    assert len(jleaves) == len(tleaves) == 4     # lead + stacked, k and v
    assert tcache["stack"]["lead"][0].k.shape == (B, S_MAX, 4, 32)
    for j, t in zip(jleaves, tleaves):
        assert t.shape == j.shape
        np.testing.assert_allclose(t.numpy(), np.asarray(j), atol=TOL)
    for key in jd:
        np.testing.assert_allclose(td[key].numpy(), np.asarray(jd[key]),
                                   atol=TOL, err_msg=key)


@pytest.mark.parametrize("vector_pos", [False, True])
def test_slab_decode_logits_match_jax(models, vector_pos):
    mesh, jms, jp, tm, tp, toks = models
    _, jcache, jpos, _ = _jax_prefill(models, False)
    _, tcache, tpos, _ = tm.prefill(tp, {"tokens": torch.from_numpy(toks)},
                                    s_max=S_MAX)
    if vector_pos:            # rows at different lengths: row 1 rewinds 5
        jpos = np.asarray([S, S - 5], np.int32)
        tpos = torch.from_numpy(jpos)
    fn = jax.jit(jms[False].decode_step)
    rng = np.random.default_rng(1)
    A.reset_dispatch_log()
    for _ in range(3):
        tok = rng.integers(0, 512, (B, 1)).astype(np.int32)
        with mesh:
            jl, jcache, jpos, jd = fn(jp, tok, jcache, jpos)
        tl, tcache, tpos, td = tm.decode_step(tp, torch.from_numpy(tok),
                                              tcache, tpos)
        np.testing.assert_allclose(tl.numpy(), np.asarray(jl), atol=TOL,
                                   rtol=TOL)
        np.testing.assert_array_equal(np.asarray(tpos), np.asarray(jpos))
        for key in ("expert_load", "mean_load", "aux_loss"):
            np.testing.assert_allclose(td[key].numpy(), np.asarray(jd[key]),
                                       atol=TOL, err_msg=key)
    assert {r["branch"] for r in A.dispatch_log()} == {"decode_slab"}
    assert not any(r["fused"] for r in A.dispatch_log())
    for j, t in zip(_leaves(jax.device_get(jcache)), _leaves(tcache)):
        np.testing.assert_allclose(t.numpy(), np.asarray(j), atol=TOL)


def test_greedy_tokens_through_steps_match_jax(models):
    mesh, jms, jp, tm, tp, toks = models
    n = 8
    jpre = jax.jit(jax_prefill_step(jms[False], s_max=S_MAX))
    jdec = jax.jit(jax_decode_step(jms[False]))
    with mesh:
        tok, cache, pos, _ = jpre(jp, {"tokens": toks})
        jtoks = [np.asarray(tok)]
        for _ in range(n - 1):
            tok, cache, pos, _ = jdec(jp, tok, cache, pos)
            jtoks.append(np.asarray(tok))
    pre, dec = make_prefill_step(tm, s_max=S_MAX), make_decode_step(tm)
    tok, cache, pos, _ = pre(tp, {"tokens": torch.from_numpy(toks)})
    ttoks = [tok.numpy()]
    for _ in range(n - 1):
        tok, cache, pos, _ = dec(tp, tok, cache, pos)
        ttoks.append(tok.numpy())
    assert ttoks[0].shape == (B, 1) and ttoks[0].dtype == np.int32
    np.testing.assert_array_equal(np.concatenate(ttoks, 1),
                                  np.concatenate(jtoks, 1))


def test_prefill_decode_consistency(models):
    """prefill(S+1).logits == (prefill(S) then decode(token S+1)).logits."""
    _, _, _, tm, tp, toks = models
    tm1 = build_model(tm.cfg, batch=B, seq_len=S + 1, device="cpu")
    extra = np.random.default_rng(2).integers(0, 512, (B, 1)).astype(np.int32)
    full_toks = torch.from_numpy(np.concatenate([toks, extra], 1))
    full, _, _, _ = tm1.prefill(tp, {"tokens": full_toks}, s_max=S + 8)
    _, caches, pos, _ = tm1.prefill(tp, {"tokens": full_toks[:, :S]},
                                    s_max=S + 8)
    step, _, _, _ = tm1.decode_step(tp, full_toks[:, S:], caches, pos)
    np.testing.assert_allclose(step.numpy(), full.numpy(), atol=TOL,
                               rtol=TOL)


@pytest.mark.parametrize("change", [
    # local/global layers, softcaps and post-norms are ported (gemma2-2b,
    # tests/test_torch_gemma2.py) and so is the relu_mlp MLP
    # (tests/test_torch_head_dims.py); what the port still refuses: a
    # family it does not know, and a family that contradicts the MoE
    # sub-config
    {"family": "retrieval"}, {"family": "dense"}])
def test_build_model_rejects_unported_patterns(change):
    cfg = get_config("moonshot-v1-16b-a3b").reduced()
    if "moe" in change:
        cfg = cfg.replace(moe=dataclasses.replace(cfg.moe, **change["moe"]))
    else:
        cfg = cfg.replace(**change)
    with pytest.raises(NotImplementedError):
        build_model(cfg, batch=1, seq_len=8, device="cpu")

