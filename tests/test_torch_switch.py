"""switch128 in the PyTorch port against the JAX package: the GELU MLP of
its dense layers, its gateless top-1 MoE block (``act="gelu"``, which
drives ``moe_gmm``'s plain form), and reduced switch128's per-step logits
through ``prefill_chunk`` and ``decode_step`` on the slab and on the paged
pool, on the same converted weights.  Tolerance 2e-5 (f32, as
``tests/test_kernels.py::_tol``); greedy tokens must be equal."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.base import MoEConfig as JMoE
from repro.configs.base import ParallelConfig as JPC
from repro.configs.switch128 import CONFIG as JAX_SWITCH
from repro.core.moe_layer import MoEBlockSpec as JSpec
from repro.core.moe_layer import init_moe_params, moe_block as jax_moe_block
from repro.launch.mesh import make_host_mesh, make_mesh
from repro.models.layers import init_mlp as jax_init_mlp
from repro.models.layers import mlp as jax_mlp
from repro.models.model import MeshShape
from repro.models.model import build_model as jax_build
from repro_torch.configs.base import MoEConfig as TMoE
from repro_torch.configs.registry import get_config
from repro_torch.convert import to_torch
from repro_torch.core.moe_layer import MoEBlockSpec as TSpec
from repro_torch.core.moe_layer import moe_block as torch_moe_block
from repro_torch.models import attention as A
from repro_torch.models.layers import mlp
from repro_torch.models.model import build_model
from repro_torch.models.transformer import layer_pattern

TOL = 2e-5
B, L = 3, 24


def _close(got, want, **kw):
    np.testing.assert_allclose(got, np.asarray(want), atol=TOL, rtol=TOL,
                               **kw)


def test_config_is_the_jax_config():
    cfg = get_config("switch128")
    for f in ("name", "family", "num_layers", "d_model", "num_heads",
              "num_kv_heads", "d_ff", "vocab_size", "head_dim", "act",
              "norm", "tie_embeddings", "rope_theta", "dtype", "source"):
        assert getattr(cfg, f) == getattr(JAX_SWITCH, f), f
    for f in ("num_experts", "num_experts_per_tok", "d_ff_expert",
              "moe_layer_period", "moe_layer_offset", "policy",
              "capacity_factor", "num_foreign_slots", "first_dense_layers",
              "num_shared_experts"):
        assert getattr(cfg.moe, f) == getattr(JAX_SWITCH.moe, f), f
    assert layer_pattern(cfg) == (["dense", "moe"], 6, 0)
    assert layer_pattern(cfg.reduced()) == (["dense", "moe"], 2, 0)


@pytest.mark.parametrize("act", ["gelu_mlp", "swiglu"])
def test_mlp_matches_jax(act):
    d, f = 32, 64
    p = jax_init_mlp(jax.random.PRNGKey(1), d, f, act, jnp.float32)
    x = np.random.default_rng(0).normal(size=(2, 5, d)).astype(np.float32)
    want = jax_mlp(jnp.asarray(x), p, act)
    got = mlp(torch.from_numpy(x), to_torch(jax.device_get(p), "cpu"), act)
    _close(got.numpy(), want)
    assert ("w_gate" in p) == (act == "swiglu")


@pytest.mark.parametrize("use_pallas", [False, True])
def test_gateless_moe_block_matches_jax(use_pallas):
    """Top-1 of 8 experts with GELU experts and no gate matrix: the JAX
    reference's grouped FFN (or its Pallas kernel in interpret mode)
    against the port's ``moe_gmm`` plain version."""
    Bt, S, d, f, E = 2, 16, 16, 32, 8
    kw = dict(num_experts=E, num_experts_per_tok=1, d_ff_expert=f,
              policy="harmoeny", num_foreign_slots=2)
    js = JSpec(moe=JMoE(**kw), d_model=d, ep_axis="model", batch_axes=(),
               ep_degree=1, tokens_local=Bt * S, block_m=8, act="gelu",
               use_pallas=use_pallas, interpret=True)
    ts = TSpec(moe=TMoE(**kw), d_model=d, ep_degree=1, tokens_local=Bt * S,
               block_m=8, act="gelu")
    mesh = make_mesh((1, 1), ("data", "model"))
    params = init_moe_params(jax.random.PRNGKey(0), js)
    assert "w_gate" not in params
    x = np.random.default_rng(1).normal(size=(Bt, S, d)).astype(np.float32)
    vmask = np.ones((Bt, S), bool)
    vmask[1, 12:] = False
    with mesh:
        y_j, diag_j = jax.jit(lambda x, p, v: jax_moe_block(
            x, p, spec=js, mesh=mesh, valid_mask=v))(x, params, vmask)
    tp = {n: torch.from_numpy(np.array(v)) for n, v in params.items()}
    y_t, diag_t = torch_moe_block(torch.from_numpy(x), tp, spec=ts,
                                  valid_mask=torch.from_numpy(vmask))
    _close(y_t.numpy()[vmask], np.asarray(y_j)[vmask])
    for key in ("expert_load", "mean_load", "aux_loss", "send_drops"):
        _close(diag_t[key].numpy(), diag_j[key], err_msg=key)


@pytest.fixture(scope="module")
def models():
    jc = JAX_SWITCH.reduced()
    mesh = make_host_mesh(1, 1)
    ms = MeshShape(tuple(zip(mesh.axis_names, mesh.devices.shape)))
    jm = jax_build(jc, JPC(attn_chunk=8, loss_chunk=8), batch=B, seq_len=L,
                   mesh_shape=ms, mesh=mesh)
    with mesh:
        jp = jm.init(jax.random.PRNGKey(0))
    tm = build_model(get_config("switch128").reduced(), batch=B, seq_len=L,
                     device="cpu")
    return mesh, jm, jp, tm, to_torch(jax.device_get(jp), device="cpu")


def _paths(tree, prefix=()):
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from _paths(v, prefix + (k,))
    elif isinstance(tree, list):
        for i, v in enumerate(tree):
            yield from _paths(v, prefix + (i,))
    else:
        yield prefix, tree


def test_converted_params_keep_jax_layout(models):
    """Dense sub-layers carry ``mlp`` {w_in, w_out} with no gate, MoE
    sub-layers gateless experts, the embedding is tied: the port's own
    init has the JAX tree, and conversion copies it with no remapping."""
    _, _, jp, tm, tp = models
    own = dict(_paths(tm.init(0)))
    conv = dict(_paths(tp))
    flat_j = jax.tree_util.tree_flatten_with_path(jp)[0]
    assert len(flat_j) == len(own) == len(conv)
    for path, leaf in flat_j:
        key = tuple(p.key for p in path)
        assert tuple(own[key].shape) == tuple(conv[key].shape) == leaf.shape
        assert own[key].dtype == conv[key].dtype
    assert set(tp["stack"]["blocks"]["sub0"]["mlp"]) == {"w_in", "w_out"}
    assert set(tp["stack"]["blocks"]["sub1"]["moe"]) == {"router", "w_in",
                                                         "w_out"}
    assert "lm_head" not in tp


def test_prefill_chunk_logits_match_jax(models):
    mesh, jm, jp, tm, tp = models
    C, S_max = 8, 24
    rng = np.random.default_rng(0)
    jcache, tcache = jm.init_cache(1, S_max), tm.init_cache(1, S_max)
    fn = jax.jit(lambda p, t, c, pos, last: jm.prefill_chunk(p, t, c, pos,
                                                             last),
                 static_argnums=(4,))
    A.reset_dispatch_log()
    for start, last in ((0, C - 1), (C, C - 1), (2 * C, 4)):   # padded tail
        toks = rng.integers(0, 512, (1, C)).astype(np.int32)
        with mesh:
            jl, jcache, _, jd = fn(jp, toks, jcache, jnp.int32(start), last)
        tl, tcache, _, td = tm.prefill_chunk(tp, torch.from_numpy(toks),
                                             tcache, start, last)
        _close(tl.numpy(), jl)
        assert int(tl.argmax()) == int(jnp.argmax(jl))
        for key in jd:
            _close(td[key].numpy(), jd[key], err_msg=key)
    assert {r["branch"] for r in A.dispatch_log()} == {"prefill_continue"}
    for sub in ("sub0", "sub1"):
        kj = np.asarray(jcache["stack"]["blocks"][sub].k)
        kt = tcache["stack"]["blocks"][sub].k.numpy()
        _close(kt[:, :, :2 * C + 5], kj[:, :, :2 * C + 5])


def _greedy_run(step_j, step_t, n):
    """n decode steps of both models, each fed its own greedy tokens; the
    logits within TOL and the tokens equal at every step."""
    tok_j = tok_t = np.random.default_rng(1).integers(
        0, 512, (B, 1)).astype(np.int32)
    toks = []
    for _ in range(n):
        jl = step_j(tok_j)
        tl = step_t(torch.from_numpy(tok_t))
        _close(tl.numpy(), jl)
        tok_j = np.asarray(jnp.argmax(jl, -1))[:, None].astype(np.int32)
        tok_t = tl.argmax(-1)[:, None].numpy().astype(np.int32)
        np.testing.assert_array_equal(tok_t, tok_j)
        toks.append(tok_t)
    return toks


def test_slab_decode_logits_and_tokens_match_jax(models):
    mesh, jm, jp, tm, tp = models
    S, S_max = 12, 24
    prompts = np.random.default_rng(2).integers(0, 512, (B, S)).astype(
        np.int32)
    with mesh:
        _, jcache, _, _ = jax.jit(lambda p, b: jm.prefill(
            p, b, s_max=S_max))(jp, {"tokens": prompts})
    _, tcache, _, _ = tm.prefill(tp, {"tokens": torch.from_numpy(prompts)},
                                 s_max=S_max)
    state = {"pos": np.asarray([S, S - 3, S - 7], np.int32),
             "jc": jcache, "tc": tcache}
    fn = jax.jit(jm.decode_step)

    def step_j(tok):
        with mesh:
            jl, state["jc"], _, _ = fn(jp, tok, state["jc"], state["pos"])
        return jl

    def step_t(tok):
        tl, state["tc"], _, _ = tm.decode_step(
            tp, tok, state["tc"], torch.from_numpy(state["pos"]))
        state["pos"] = state["pos"] + 1
        return tl
    A.reset_dispatch_log()
    _greedy_run(step_j, step_t, 4)
    assert {r["branch"] for r in A.dispatch_log()} == {"decode_slab"}


def test_paged_decode_logits_and_tokens_match_jax(models):
    mesh, jm, jp, tm, tp = models
    bs = 4
    bt = np.asarray([[3, 7, 1, 0], [2, 5, 0, 0], [9, 4, 11, 6]], np.int32)
    state = {"pos": np.asarray([0, 3, 6], np.int32),
             "jc": jm.init_paged_cache(12, bs), "tc": tm.init_paged_cache(12, bs)}
    fn = jax.jit(lambda p, t, c, pos, bt: jm.decode_step(
        p, t, c, pos, block_table=bt, block_size=bs))

    def step_j(tok):
        with mesh:
            jl, state["jc"], _, _ = fn(jp, tok, state["jc"], state["pos"], bt)
        return jl

    def step_t(tok):
        tl, state["tc"], _, _ = tm.decode_step(
            tp, tok, state["tc"], torch.from_numpy(state["pos"]),
            block_table=torch.from_numpy(bt), block_size=bs)
        state["pos"] = state["pos"] + 1
        return tl
    A.reset_dispatch_log()
    _greedy_run(step_j, step_t, 5)
    assert {r["branch"] for r in A.dispatch_log()} == {"decode"}
