"""The paper's synthetic skew (§5.1.2) at EP degree 4: the port's block
on the assignment that JAX's ``route_skewed`` drew for each rank
(``fold_in(key, rank)``) equals the JAX block on a (1, 4) mesh, and
HarMoEny drops nothing where round-robin drops; ``route_skewed``'s own
statistics; ``static_opt_placement`` equal to the JAX package's."""
import numpy as np
import pytest
import torch

from repro.core.topology import static_opt_placement as jax_static_opt
from repro_torch.configs.base import MoEConfig
from repro_torch.convert import to_torch
from repro_torch.core import dispatch as TD
from repro_torch.core import moe_layer as TM
from repro_torch.core.moe_layer import MoEBlockSpec
from repro_torch.core.router import RouterOutput, SkewKey, route_skewed
from repro_torch.core.topology import static_opt_placement

from _ep_helpers import (FLATTEN_SRC, assert_block_matches,  # noqa: F401
                         one_torch_thread, run_captured, run_jax, sub_tree)

G = 4
B, S, D_MODEL, F, E, K_TOP = 2, 64, 16, 32, 8, 1


def skew_fields(policy):
    return dict(num_experts=E, num_experts_per_tok=K_TOP, d_ff_expert=F,
                policy=policy, capacity_factor=1.25, q_tokens=2,
                num_foreign_slots=4, router_skew=0.9, router_skew_experts=1)


JAX_BODY = FLATTEN_SRC + '''
import jax, jax.numpy as jnp
from repro.configs.base import MoEConfig
from repro.launch.mesh import make_mesh
from repro.core.moe_layer import MoEBlockSpec, moe_block, init_moe_params
from repro.core import router as R, scheduler as SCH, dispatch as JD
from repro.core import prefetch as JP
mesh = make_mesh((1, G), ("data", "model"))
key = jax.random.PRNGKey(7)
out = {}
for policy, fields in CASES.items():
    moe = MoEConfig(**fields)
    spec = MoEBlockSpec(moe=moe, d_model=D, ep_axis="model",
                        batch_axes=("data",), ep_degree=G,
                        tokens_local=B * S, block_m=8, act="silu")
    params = init_moe_params(jax.random.PRNGKey(0), spec)
    x = np.random.default_rng(1).normal(size=(B, S, D)).astype(np.float32)
    vmask = np.ones((B, S), bool)
    with mesh:
        y, diag = jax.jit(lambda x, p, v, k: moe_block(
            x, p, spec=spec, mesh=mesh, skew_key=k, valid_mask=v))(
                x, params, vmask, key)
    topo = spec.topo
    Ep, k, K = topo.padded_experts, moe.num_experts_per_tok, moe.num_foreign_slots
    t = B * S // G
    assigns = [np.asarray(R.route_skewed(
        jax.random.fold_in(key, g), t, top_k=k, num_experts=moe.num_experts,
        padded_experts=Ep, alpha=moe.router_skew,
        n_hot=moe.router_skew_experts).assign) for g in range(G)]
    m_all = jnp.asarray(np.stack([np.bincount(a.reshape(-1), minlength=Ep)
                                  for a in assigns]).astype(np.int32))
    S_j, _ = SCH.schedule(m_all, topo, policy=moe.policy, q=spec.q,
                          c_pair=spec.c_pair, num_foreign_slots=K)
    lays = [JD.build_layout(S_j, jnp.asarray(assigns[g]), jnp.int32(g), topo,
                            c_pair=spec.c_pair, c_total=spec.c_total,
                            num_foreign_slots=K, block_m=spec.block_m)
            for g in range(G)]
    rec = {"x": x, "vmask": vmask, "y": np.asarray(y), "S": np.asarray(S_j),
           "fids": np.asarray(JP.all_foreign_ids(S_j, topo, K)),
           "assign": np.stack(assigns)}
    rec.update(flatten(jax.device_get(params), "params/"))
    rec.update(flatten(jax.device_get(diag), "diag/"))
    for f in lays[0]._fields:
        rec["layout/" + f] = np.stack([np.asarray(getattr(l, f)) for l in lays])
    out.update({policy + "|" + key_: val for key_, val in rec.items()})
np.savez(OUT, **out)
'''


@pytest.fixture(scope="module")
def jax_skew(tmp_path_factory):
    cases = {p: skew_fields(p) for p in ("harmoeny", "round_robin")}
    body = (f"import numpy as np\nG, B, S, D = {G}, {B}, {S}, {D_MODEL}\n"
            f"CASES = {cases!r}\n" + JAX_BODY)
    flat = run_jax(body, tmp_path_factory.mktemp("skew") / "skew.npz")
    out = {}
    for key, val in flat.items():
        name, rest = key.split("|", 1)
        out.setdefault(name, {})[rest] = val
    return out


@pytest.mark.parametrize("policy", ["harmoeny", "round_robin"])
def test_skewed_block_matches_jax_mesh(jax_skew, monkeypatch, policy):
    rec = jax_skew[policy]
    spec = MoEBlockSpec(moe=MoEConfig(**skew_fields(policy)), d_model=D_MODEL,
                        ep_degree=G, tokens_local=B * S, block_m=8)
    drawn = iter(rec["assign"])             # rank order: lockstep calls 0..G-1

    def jax_draws(gen, T, *, top_k, num_experts, padded_experts, alpha,
                  n_hot=1):
        assign = torch.from_numpy(next(drawn))
        assert assign.shape == (T, top_k)
        counts = torch.bincount(assign.reshape(-1).long(),
                                minlength=padded_experts).to(torch.int32)
        return RouterOutput(assign, torch.full((T, top_k), 1.0 / top_k),
                            counts, torch.zeros(()))
    monkeypatch.setattr(TM, "route_skewed", jax_draws)
    params = to_torch(sub_tree(rec, "params"), device="cpu")
    y, diag, got = run_captured(monkeypatch, spec, params, rec["x"],
                                 rec["vmask"], TD.VirtualGroup(G, "cpu"),
                                 skew_key=SkewKey((7,)))
    with pytest.raises(StopIteration):      # one draw per rank, no more
        next(drawn)
    # run_captured undid the patch; the block ran on JAX's draws
    assert_block_matches(rec, y, diag, got, spec)
    drops = float(diag["send_drops"].sum() + diag["dest_drops"].sum())
    if policy == "harmoeny":
        assert drops == 0
        assert float(diag["max_load_after"]) < 0.5 * float(
            diag["max_load_before"])
    else:
        assert drops > 0


def test_route_skewed_statistics():
    E_real, Ep, k, T = 10, 12, 2, 10_000      # 20k draws
    gen = SkewKey((3, 1)).generator("cpu")
    out = route_skewed(gen, T, top_k=k, num_experts=E_real,
                       padded_experts=Ep, alpha=0.9, n_hot=2)
    assert out.assign.shape == (T, k) and out.assign.dtype == torch.int32
    assert torch.equal(out.gates, torch.full((T, k), 0.5))
    assert float(out.aux_loss) == 0.0
    counts = out.counts.numpy()
    assert counts.shape == (Ep,) and counts.sum() == T * k
    np.testing.assert_array_equal(
        counts, np.bincount(out.assign.numpy().reshape(-1), minlength=Ep))
    assert counts[E_real:].sum() == 0          # padded experts never drawn
    hot = counts[:2].sum() / (T * k)
    assert abs(hot - 0.9) < 0.02, hot
    cold = counts[2:E_real] / (T * k)
    assert np.all(np.abs(cold - 0.1 / 8) < 0.01), cold


def test_skew_key_streams():
    """The same key path draws the same assignment; folding in another
    rank or step draws another."""
    def draw(key):
        return route_skewed(key.generator("cpu"), 64, top_k=2, num_experts=8,
                            padded_experts=8, alpha=0.5).assign
    base = SkewKey((0, 1)).fold_in(5)
    assert torch.equal(draw(base.fold_in(2)), draw(SkewKey((0, 1, 5, 2))))
    assert not torch.equal(draw(base.fold_in(2)), draw(base.fold_in(3)))
    assert not torch.equal(draw(base), draw(SkewKey((0, 1)).fold_in(6)))


@pytest.mark.parametrize("E,G_", [(8, 4), (10, 4), (60, 4), (16, 8), (7, 2)])
def test_static_opt_placement_equals_jax(E, G_):
    rng = np.random.default_rng(E * G_)
    for trial in range(3):
        profile = rng.integers(0, 100, size=E)
        if trial == 2:
            profile[:] = 5                          # all tied
        want = jax_static_opt(profile, G_)
        got = static_opt_placement(profile, G_)
        np.testing.assert_array_equal(got, want)
        assert sorted(got.tolist()) == list(range(len(got)))
