"""The port's training path against the JAX package's, on the CPU.

One JAX subprocess a group of archs (side by side) runs
``jax.value_and_grad(model.train_loss)`` on each reduced arch of the
registry (f32, B 2, S 16, ``attn_chunk = loss_chunk = 8``, weights from
``PRNGKey(0)``), one on a (1, 4) mesh takes ``jax.grad`` through the MoE
block under the 0.9 skew, and one runs three ``make_train_step`` steps
with ``microbatch=2`` and ``remat="full"``; the port runs the same on the
same (converted) weights and batches.  Tolerances: each loss within 2e-5;
each gradient leaf within 2e-5 x max(1, its largest JAX magnitude) (the
MoE block's 1e-5 x that); the three steps' losses within 2e-5, their
AdamW moments as the gradients, and all but a thousandth of their
parameters' entries within 1e-5 (AdamW normalizes each entry by its own
RMS, so an entry whose gradient sits at rounding level can move by up to
the learning rate a step; every entry within three steps' worth).  JAX's SSM gradients (mamba2, zamba2) are compared on
the leaves where they are finite: JAX's chunked scan exponentiates the
whole block before it selects, and the unselected ``inf`` meets a zero
cotangent (NaN); the port masks the exponent first, and its every leaf
is finite (held against ``torch.autograd.gradcheck`` in f64 too).
"""
import numpy as np
import pytest
import torch

from repro_torch import tree
from repro_torch.configs.base import ParallelConfig
from repro_torch.configs.registry import REGISTRY, get_config
from repro_torch.core import dispatch as TD
from repro_torch.core.moe_layer import MoEBlockSpec, moe_block
from repro_torch.launch.steps import loss_and_grads, make_train_step
from repro_torch.models.model import build_model
from repro_torch.optim.adamw import adamw_init

from _ep_helpers import (FLATTEN_SRC, one_torch_thread,  # noqa: F401
                         sub_tree, unflatten)
from test_torch_prefix import run_jax_side_by_side

B, S = 2, 16
LOSS_TOL = 2e-5
GRAD_TOL = 2e-5
ARCHS = sorted(REGISTRY)
GRAD_ARCHS = ["qwen15-moe-a27b", "switch128", "stablelm-1.6b", "gemma2-2b",
              "whisper-large-v3", "pixtral-12b", "mamba2-2.7b", "zamba2-7b"]
SSM = ("mamba2-2.7b", "zamba2-7b")
# four subprocesses of about equal JAX compile time
GROUPS = [["moonshot-v1-16b-a3b", "mistral-nemo-12b", "phi4-mini-3.8b"],
          ["qwen15-moe-a27b", "switch128", "pixtral-12b"],
          ["mamba2-2.7b", "zamba2-7b", "stablelm-1.6b"],
          ["gemma2-2b", "whisper-large-v3", "mixtral-8x7b"]]

SWEEP_BODY = '''
import jax, jax.numpy as jnp
from repro.configs import get_config
from repro.configs.base import ParallelConfig
from repro.launch.mesh import make_host_mesh
from repro.models.model import MeshShape, build_model
jax.config.update("jax_compilation_cache_dir", CACHE)
mesh = make_host_mesh(1, 1)
ms = MeshShape(tuple(zip(mesh.axis_names, mesh.devices.shape)))
out = {}
for arch in ARCHS:
    cfg = get_config(arch).reduced()
    rng = np.random.default_rng(sum(map(ord, arch)))
    toks = rng.integers(0, cfg.vocab_size, (B, S + 1)).astype(np.int32)
    batch = {"tokens": toks[:, :-1], "labels": toks[:, 1:]}
    if cfg.is_encoder_decoder:
        batch["frames"] = rng.normal(
            size=(B, cfg.encoder_seq_len, cfg.d_model)).astype(np.float32)
    if cfg.num_prefix_embeddings:
        batch["patches"] = rng.normal(
            size=(B, cfg.num_prefix_embeddings, cfg.d_model)).astype(
                np.float32)
    model = build_model(cfg, ParallelConfig(attn_chunk=8, loss_chunk=8),
                        batch=B, seq_len=S, mesh_shape=ms, mesh=mesh)
    with mesh:
        params = model.init(jax.random.PRNGKey(0))
        if arch in GRAD_ARCHS:
            (loss, diags), grads = jax.jit(jax.value_and_grad(
                model.train_loss, has_aux=True))(params, batch)
        else:
            loss, diags = jax.jit(model.train_loss)(params, batch)
            grads = params
    out[arch + "|loss"] = np.asarray(loss)
    for k, v in batch.items():
        out[f"{arch}|batch/{k}"] = v
    for k, v in diags.items():
        out[f"{arch}|diag/{k}"] = np.asarray(v)
    for i, (p, g) in enumerate(zip(jax.tree.leaves(params),
                                   jax.tree.leaves(grads))):
        out[f"{arch}|p{i}"] = np.asarray(p)
        out[f"{arch}|g{i}"] = np.asarray(g)
np.savez(OUT, **out)
'''

MOE_BODY = FLATTEN_SRC + '''
import jax, jax.numpy as jnp
from repro.configs.base import MoEConfig
from repro.launch.mesh import make_mesh
from repro.core.moe_layer import MoEBlockSpec, moe_block, init_moe_params
from repro.core import router as R
mesh = make_mesh((1, 4), ("data", "model"))
key = jax.random.PRNGKey(7)
out = {}
for policy in ("harmoeny", "round_robin"):
    moe = MoEConfig(num_experts=8, num_experts_per_tok=1, d_ff_expert=32,
                    policy=policy, capacity_factor=1.25, q_tokens=2,
                    num_foreign_slots=4, router_skew=0.9,
                    router_skew_experts=1)
    spec = MoEBlockSpec(moe=moe, d_model=16, ep_axis="model",
                        batch_axes=("data",), ep_degree=4,
                        tokens_local=2 * 64, block_m=8, act="silu")
    params = init_moe_params(jax.random.PRNGKey(0), spec)
    rng = np.random.default_rng(1)
    x = rng.normal(size=(2, 64, 16)).astype(np.float32)
    ct = rng.normal(size=(2, 64, 16)).astype(np.float32)

    def f(x, p):
        y, diag = moe_block(x, p, spec=spec, mesh=mesh, skew_key=key)
        return jnp.sum(y * ct), diag
    with mesh:
        (_, diag), (gx, gp) = jax.jit(jax.value_and_grad(
            f, argnums=(0, 1), has_aux=True))(x, params)
    t = 2 * 64 // 4
    assign = np.stack([np.asarray(R.route_skewed(
        jax.random.fold_in(key, g), t, top_k=1, num_experts=8,
        padded_experts=spec.topo.padded_experts, alpha=0.9,
        n_hot=1).assign) for g in range(4)])
    rec = {"x": x, "ct": ct, "gx": np.asarray(gx), "assign": assign}
    rec.update(flatten(jax.device_get(params), "params/"))
    rec.update(flatten(jax.device_get(gp), "grads/"))
    rec.update(flatten(jax.device_get(diag), "diag/"))
    out.update({policy + "|" + k: v for k, v in rec.items()})
np.savez(OUT, **out)
'''

STEP_BODY = '''
import jax, jax.numpy as jnp
from repro.configs import get_config
from repro.configs.base import ParallelConfig
from repro.data.pipeline import synthetic_batches
from repro.launch.mesh import make_host_mesh
from repro.launch.steps import make_train_step
from repro.models.model import MeshShape, build_model
from repro.optim.adamw import adamw_init
jax.config.update("jax_compilation_cache_dir", CACHE)
mesh = make_host_mesh(1, 1)
ms = MeshShape(tuple(zip(mesh.axis_names, mesh.devices.shape)))
cfg = get_config("qwen15-moe-a27b").reduced()
model = build_model(cfg, ParallelConfig(microbatch=2, remat="full",
                                        attn_chunk=8, loss_chunk=8),
                    batch=4, seq_len=S, mesh_shape=ms, mesh=mesh)
out = {}
with mesh:
    params = model.init(jax.random.PRNGKey(0))
    for i, p in enumerate(jax.tree.leaves(params)):
        out[f"p0_{i}"] = np.asarray(p)
    opt = adamw_init(params)
    step = jax.jit(make_train_step(model, lr=1e-3))
    data = synthetic_batches("random", batch=4, seq_len=S,
                             vocab=cfg.vocab_size, seed=0)
    for s in range(3):
        batch = next(data)
        params, opt, loss, diags = step(params, opt, batch)
        out[f"loss{s}"] = np.asarray(loss)
        for k, v in diags.items():
            out[f"diag{s}/{k}"] = np.asarray(v)
for i, p in enumerate(jax.tree.leaves(params)):
    out[f"p3_{i}"] = np.asarray(p)
for i, p in enumerate(jax.tree.leaves((opt.m, opt.v))):
    out[f"mv_{i}"] = np.asarray(p)
out["step"] = np.asarray(opt.step)
np.savez(OUT, **out)
'''


@pytest.fixture(scope="module")
def jax_runs(tmp_path_factory):
    """Every JAX side of this file, six subprocesses side by side (four
    emulated devices each: the MoE block's mesh takes four, the others
    one)."""
    tmp = tmp_path_factory.mktemp("train")
    head = lambda i: f"B, S = {B}, {S}\nCACHE = {str(tmp / f'xla{i}')!r}\n"
    bodies = [head(i) + f"ARCHS = {g!r}\nGRAD_ARCHS = {GRAD_ARCHS!r}\n"
              + SWEEP_BODY for i, g in enumerate(GROUPS)]
    bodies += [head(len(GROUPS)) + STEP_BODY, MOE_BODY]
    return run_jax_side_by_side(bodies, tmp, devices=4)


def _port(arch, rec):
    """The port's model on ``arch``'s JAX weights and batch (leaves in
    JAX's order over the port's own tree)."""
    cfg = get_config(arch).reduced()
    model = build_model(cfg, ParallelConfig(attn_chunk=8, loss_chunk=8),
                        batch=B, seq_len=S, device="cpu")
    structure = tree.flatten(model.init(0))
    n = len(structure[0])
    jl = [rec[f"{arch}|p{i}"] for i in range(n)]
    assert f"{arch}|p{n}" not in rec
    for own, j in zip(structure[0], jl):
        assert tuple(own.shape) == j.shape
    params = tree.unflatten(structure[1],
                            [torch.from_numpy(np.array(a)) for a in jl])
    batch = {k[len(arch) + 7:]: torch.from_numpy(v) for k, v in rec.items()
             if k.startswith(arch + "|batch/")}
    return model, params, batch, n


@pytest.mark.parametrize("arch", ARCHS)
def test_train_loss_matches_jax(jax_runs, arch):
    model, params, batch, _ = _port(arch, jax_runs)
    with torch.no_grad():
        loss, diags = model.train_loss(params, batch)
    np.testing.assert_allclose(float(loss), float(jax_runs[arch + "|loss"]),
                               atol=LOSS_TOL, rtol=0)
    jd = {k.split("/", 1)[1]: v for k, v in jax_runs.items()
          if k.startswith(arch + "|diag/")}
    assert sorted(diags) == sorted(jd)
    for k, v in jd.items():
        np.testing.assert_allclose(diags[k].numpy(), v, atol=1e-4,
                                   err_msg=k)


@pytest.mark.parametrize("arch", GRAD_ARCHS)
def test_gradients_match_jax(jax_runs, arch):
    model, params, batch, n = _port(arch, jax_runs)
    _, _, grads = loss_and_grads(model, params, batch)
    finite_jax = 0
    for i, g in enumerate(grads):
        assert torch.isfinite(g).all(), f"leaf {i}"
        want = jax_runs[f"{arch}|g{i}"]
        if not np.isfinite(want).all():
            assert arch in SSM, f"leaf {i}: JAX's gradient is not finite"
            continue
        finite_jax += 1
        np.testing.assert_allclose(
            g.numpy(), want, rtol=0,
            atol=GRAD_TOL * max(1.0, float(np.abs(want).max())),
            err_msg=f"{arch} leaf {i}")
    assert finite_jax >= (1 if arch in SSM else n)


def test_jax_mamba2_gradients_hold_non_finite_leaves(jax_runs):
    """Fault 3, a deliberate difference (ROADMAP C): on this batch JAX's
    mamba2 gradient is non-finite in most leaves, the port's nowhere
    (``test_gradients_match_jax``)."""
    _, _, _, n = _port("mamba2-2.7b", jax_runs)
    bad = sum(not np.isfinite(jax_runs[f"mamba2-2.7b|g{i}"]).all()
              for i in range(n))
    assert bad == 18 and n == 19, (bad, n)


def test_mamba_gradcheck_f64():
    """The port's SSD scan and mamba block against finite differences, on
    f64 inputs (the scan itself runs in f32, so the differences are taken
    at f32's precision), on a tiny case whose chunks' upper triangles
    overflow if the exponent is taken before the mask."""
    import dataclasses
    from repro_torch.models import mamba2 as M
    g = torch.Generator().manual_seed(0)
    f64 = dict(generator=g, dtype=torch.float64)
    Bb, L, H, P, N = 1, 6, 2, 3, 4
    xh = torch.randn(Bb, L, H, P, **f64)
    dt = torch.rand(Bb, L, H, **f64) * 40 + 1
    A = -torch.rand(H, **f64) * 20 - 1
    Bs, Cs = torch.randn(Bb, L, N, **f64), torch.randn(Bb, L, N, **f64)

    def ssd(xh, dt, A, Bs, Cs):
        y, st = M.ssd_chunked(xh, dt, A, Bs, Cs, chunk=4)
        return y.double().sum() + st.double().sum()
    args = tuple(t.requires_grad_(True) for t in (xh, dt, A, Bs, Cs))
    assert all(torch.isfinite(t).all()
               for t in torch.autograd.grad(ssd(*args), args))
    assert torch.autograd.gradcheck(ssd, args, eps=1e-3, atol=2e-2,
                                    rtol=2e-2)
    base = get_config("mamba2-2.7b").reduced()
    cfg = base.replace(d_model=8, num_layers=1, ssm=dataclasses.replace(
        base.ssm, state_dim=4, head_dim=4, chunk_size=4))
    p = build_model(cfg, batch=1, seq_len=8, device="cpu").init(0)
    p = p["stack"]["blocks"]["sub0"]["mamba"]
    names = sorted(p)
    leaves = [p[k][0].double().requires_grad_(True) for k in names]
    x = torch.randn(1, 8, cfg.d_model, **f64).requires_grad_(True)

    def block(x, *ls):
        return M.mamba_block(x, dict(zip(names, ls)), cfg)[0].sum()
    assert torch.autograd.gradcheck(block, (x, *leaves), eps=1e-3,
                                    atol=2e-2, rtol=2e-2)


@pytest.mark.parametrize("policy", ["harmoeny", "round_robin"])
def test_moe_block_gradients_virtual_group_match_jax(jax_runs, policy):
    """``VirtualGroup(4)``'s MoE block on JAX's skewed routes: the input's
    and every expert leaf's gradient against ``jax.grad`` on a (1, 4)
    mesh; under harmoeny the hot expert's units run on other ranks as
    foreign rows, whose gradient flows back to its host's rows; every
    rank's expert rows get a gradient."""
    from repro_torch.configs.base import MoEConfig
    rec = {k[len(policy) + 1:]: v for k, v in jax_runs.items()
           if k.startswith(policy + "|")}
    moe = MoEConfig(num_experts=8, num_experts_per_tok=1, d_ff_expert=32,
                    policy=policy, capacity_factor=1.25, q_tokens=2,
                    num_foreign_slots=4, router_skew=0.9,
                    router_skew_experts=1)
    spec = MoEBlockSpec(moe=moe, d_model=16, ep_degree=4,
                        tokens_local=2 * 64, block_m=8, act="silu")
    params = {k: torch.from_numpy(v).requires_grad_(True)
              for k, v in unflatten(rec, "params").items()}
    x = torch.from_numpy(rec["x"]).requires_grad_(True)
    y, diag = moe_block(x, params, spec=spec, comm=TD.VirtualGroup(4, "cpu"),
                        skew_assign=torch.from_numpy(rec["assign"]),
                        kernels=False)
    if policy == "harmoeny":
        assert float(diag["moved_units"][0]) > 0
    (y * torch.from_numpy(rec["ct"])).sum().backward()
    tol = lambda a: 1e-5 * max(1.0, float(np.abs(a).max()))
    np.testing.assert_allclose(x.grad.numpy(), rec["gx"], rtol=0,
                               atol=tol(rec["gx"]))
    jg = unflatten(rec, "grads")
    for name in ("w_in", "w_out", "w_gate"):
        got = params[name].grad
        np.testing.assert_allclose(got.numpy(), jg[name], rtol=0,
                                   atol=tol(jg[name]), err_msg=name)
        epr = got.shape[0] // 4
        for g in range(4):
            assert float(got[g * epr:(g + 1) * epr].abs().max()) > 0, \
                (name, g)


def test_virtual_group_gathers_carry_every_ranks_gradient():
    """Fault 2's repair: under autograd the all-gather and the foreign
    fetch of ``VirtualGroup`` send each rank's rows their own gradient
    (a view strided out of rank 0's slice sent all of it to rank 0's);
    without grad the copy-free view stays."""
    from repro_torch.core.topology import make_topology
    vg = TD.VirtualGroup(4, "cpu")
    w = torch.randn(8, 3, requires_grad=True)
    xs = [w[2 * g:2 * g + 2] for g in range(4)]
    out = vg._all_gather(xs)[0]
    (out * torch.arange(1.0, 25.0).reshape(4, 2, 3)).sum().backward()
    assert torch.equal(w.grad, torch.arange(1.0, 25.0).reshape(8, 3))
    with torch.no_grad():
        view = vg._all_gather([w.detach()[2 * g:2 * g + 2]
                               for g in range(4)])[0]
    assert view.data_ptr() == w.data_ptr()
    topo = make_topology(4, 8)
    w.grad = None
    fids = torch.tensor([[int(topo.slot_map[(g + 1) % 4][0]), -1]
                         for g in range(4)], dtype=torch.int32)
    fetched = vg._fetch_rows(xs, [(fids, g, topo, 0) for g in range(4)])
    sum(f.rows.sum() for f in fetched).backward()
    hit = w.grad.abs().sum(dim=1) > 0
    assert [bool(hit[2 * g:2 * g + 2].any()) for g in range(4)] == [True] * 4


def test_train_step_microbatch_remat_matches_jax(jax_runs):
    """Three ``make_train_step`` steps of reduced qwen15-moe-a27b with two
    microbatches and full remat (f32 gradient sums, AdamW at lr 1e-3)
    against JAX's jitted step on the same batches."""
    from repro_torch.data.pipeline import synthetic_batches
    cfg = get_config("qwen15-moe-a27b").reduced()
    model = build_model(cfg, ParallelConfig(microbatch=2, remat="full",
                                            attn_chunk=8, loss_chunk=8),
                        batch=4, seq_len=S, device="cpu")
    # the train spec routes one microbatch's tokens a step, as in JAX
    assert model.moe_spec.tokens_local == 2 * S
    structure = tree.flatten(model.init(0))
    params = tree.unflatten(structure[1], [
        torch.from_numpy(np.array(jax_runs[f"p0_{i}"]))
        for i in range(len(structure[0]))])
    opt = adamw_init(params)
    step = make_train_step(model, lr=1e-3)
    data = synthetic_batches("random", batch=4, seq_len=S,
                             vocab=cfg.vocab_size, seed=0)
    for s in range(3):
        params, opt, loss, diags = step(params, opt, next(data))
        np.testing.assert_allclose(float(loss), float(jax_runs[f"loss{s}"]),
                                   atol=LOSS_TOL, rtol=0)
        for k in diags:
            np.testing.assert_allclose(diags[k].numpy(),
                                       jax_runs[f"diag{s}/{k}"], atol=1e-4,
                                       err_msg=k)
    assert int(opt.step) == int(jax_runs["step"]) == 3
    mv = tree.leaves((opt.m, opt.v))
    for i, m in enumerate(mv):
        want = jax_runs[f"mv_{i}"]
        np.testing.assert_allclose(m.numpy(), want, rtol=0,
                                   atol=GRAD_TOL * max(1.0, float(
                                       np.abs(want).max())))
    # AdamW divides each entry by its own running RMS: an entry whose
    # gradient at some step sits at its leaf's rounding level (the 2e-5
    # x max tolerance above) moves by up to lr a step on either side; so
    # all but a thousandth of the entries are held to 1e-5, and every one
    # to three steps' lr
    n_off = n_all = 0
    for i, p in enumerate(tree.leaves(params)):
        diff = np.abs(p.numpy() - jax_runs[f"p3_{i}"])
        n_off += int((diff > 1e-5).sum())
        n_all += diff.size
        assert diff.max() <= 3 * 1e-3, f"leaf {i}"
    assert n_off <= n_all // 1000, (n_off, n_all)


def test_remat_and_microbatch_do_not_change_gradients():
    """Remat recomputes, it does not change: the gradients with and
    without it are equal, and two microbatches' f32 mean equals one
    batch's gradient up to rounding (the MoE blocks see the same tokens
    per step only when no capacity binds: a dense arch)."""
    cfg = get_config("stablelm-1.6b").reduced()
    rng = np.random.default_rng(0)
    toks = rng.integers(0, cfg.vocab_size, (4, S + 1)).astype(np.int32)
    batch = {"tokens": toks[:, :-1], "labels": toks[:, 1:]}
    out = {}
    for remat, mb in (("none", 0), ("full", 0), ("none", 2)):
        model = build_model(cfg, ParallelConfig(remat=remat, microbatch=mb,
                                                attn_chunk=8, loss_chunk=8),
                            batch=4, seq_len=S, device="cpu")
        params = model.init(0)
        seen = {}
        step = make_train_step(model, on_grads=lambda g, d: seen.update(
            g=[t.clone() for t in tree.leaves(g)]))
        _, _, loss, _ = step(params, adamw_init(params), batch)
        out[(remat, mb)] = (float(loss), seen["g"])
    (l0, g0), (l1, g1), (l2, g2) = out.values()
    assert l0 == l1 and all(torch.equal(a, b) for a, b in zip(g0, g1))
    assert abs(l0 - l2) < 1e-4
    for a, b in zip(g0, g2):
        torch.testing.assert_close(a, b, atol=1e-5, rtol=1e-4)


def test_remat_checkpoints_each_period(monkeypatch):
    from repro_torch.models import transformer as T
    calls = []
    orig = T.checkpoint
    monkeypatch.setattr(T, "checkpoint", lambda *a, **k: (
        calls.append(1), orig(*a, **k))[1])
    cfg = get_config("switch128").reduced()
    model = build_model(cfg, ParallelConfig(remat="full", attn_chunk=8,
                                            loss_chunk=8),
                        batch=B, seq_len=S, device="cpu")
    toks = np.ones((B, S), np.int32)
    loss_and_grads(model, model.init(0), {"tokens": toks, "labels": toks})
    assert len(calls) == T.layer_pattern(cfg)[1]


@pytest.mark.parametrize("name", ["moe_gmm", "flash_attention",
                                  "paged_attention"])
def test_kernel_wrappers_refuse_grad_on_cpu(name):
    """No wrapper quietly gives way under autograd: an input that requires
    grad raises, on the CPU as on the card
    (``tests/test_torch_cuda_kernels.py``); under ``no_grad`` it runs."""
    from test_torch_cuda_kernels import kernel_grad_calls
    call = kernel_grad_calls("cpu")[name]
    with pytest.raises(RuntimeError, match="no backward"):
        call()
    with torch.no_grad():
        call()


def test_moe_block_kernels_flag_runs_the_reference(monkeypatch):
    """``kernels=False`` takes ``grouped_ffn_ref`` (differentiable, any
    device); the default takes the kernel's entry; both agree."""
    from repro_torch.core import moe_layer
    cfg = get_config("qwen15-moe-a27b").reduced()
    model = build_model(cfg, batch=B, seq_len=S, device="cpu")
    p = tree.tree_map(lambda t: t[0], model.init(0)["stack"]["blocks"]
                      ["sub0"]["moe"])
    x = torch.randn(B, S, cfg.d_model)
    used = []
    for name in ("grouped_ffn", "grouped_ffn_ref"):
        orig = getattr(moe_layer, name)
        monkeypatch.setattr(moe_layer, name, lambda *a, _o=orig, _n=name,
                            **k: (used.append(_n), _o(*a, **k))[1])
    with torch.no_grad():
        y_k, _ = moe_block(x, p, spec=model.moe_spec, kernels=True)
        y_r, _ = moe_block(x, p, spec=model.moe_spec, kernels=False)
    assert used == ["grouped_ffn", "grouped_ffn_ref"]
    torch.testing.assert_close(y_k, y_r, atol=1e-6, rtol=1e-6)
