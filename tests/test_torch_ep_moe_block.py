"""The port's HarMoEny MoE block at EP degree 4 (``VirtualGroup``: four
ranks in lockstep in one process) against the JAX ``moe_block`` on a
(1, 4) mesh of emulated host devices, for all four scheduling policies,
with E = 8 and E = 10 (two padded experts): ``y`` within 2e-5; the
schedule S, every rank's ``DispatchLayout`` integers, FIDS, the drop
counts and every integer-valued diagnostic exactly equal (the aux loss,
a float, within 1e-6).  The JAX side recomputes S, the layouts and FIDS
from its own functions on the same inputs; the port's are captured from
inside its block."""
import dataclasses

import numpy as np
import pytest
import torch

from repro_torch.configs.base import MoEConfig
from repro_torch.convert import expert_shard, to_torch
from repro_torch.core import dispatch as TD
from repro_torch.core import moe_layer as TM
from repro_torch.core import prefetch as TP
from repro_torch.core.moe_layer import MoEBlockSpec
from repro_torch.core.topology import static_opt_placement

from _ep_helpers import (FLATTEN_SRC, assert_block_matches,  # noqa: F401
                         one_torch_thread, run_captured, run_jax, sub_tree)

G = 4
B, S, D_MODEL, F, K_TOP = 2, 16, 16, 32, 2
POLICIES = ("harmoeny", "round_robin", "even_split", "static_opt")
EXPERTS = (8, 10)


def case_config(policy: str, E: int):
    """(moe config fields, input seed) of one case; identical on both
    sides.  even_split gets a foreign group for every non-local expert
    (as the model's decode spec gives it); static_opt a profiled
    placement."""
    Ep = -(-E // G) * G
    K = Ep - Ep // G if policy == "even_split" else 2
    placement = None
    if policy == "static_opt":
        profile = np.random.default_rng(E).integers(0, 50, size=E)
        placement = tuple(int(v) for v in static_opt_placement(profile, G))
    return dict(num_experts=E, num_experts_per_tok=K_TOP, d_ff_expert=F,
                policy=policy, capacity_factor=2.0, q_tokens=1,
                num_foreign_slots=K, placement=placement), 10 * E + len(policy)


JAX_BODY = FLATTEN_SRC + '''
import jax, jax.numpy as jnp
from repro.configs.base import MoEConfig
from repro.launch.mesh import make_mesh
from repro.core.moe_layer import MoEBlockSpec, moe_block, init_moe_params
from repro.core import router as R, scheduler as SCH, dispatch as JD
from repro.core import prefetch as JP
mesh = make_mesh((1, G), ("data", "model"))
out = {}
for name, (fields, seed) in CASES.items():
    moe = MoEConfig(**fields)
    spec = MoEBlockSpec(moe=moe, d_model=D, ep_axis="model",
                        batch_axes=("data",), ep_degree=G,
                        tokens_local=B * S, block_m=8, act="silu")
    params = init_moe_params(jax.random.PRNGKey(seed), spec)
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(B, S, D)).astype(np.float32)
    vmask = np.ones((B, S), bool)
    vmask[1, 11:] = False
    with mesh:
        y, diag = jax.jit(lambda x, p, v: moe_block(
            x, p, spec=spec, mesh=mesh, valid_mask=v))(x, params, vmask)
    # the replicated control plane, recomputed outside the block
    topo = spec.topo
    Ep, k, K = topo.padded_experts, moe.num_experts_per_tok, moe.num_foreign_slots
    flat, v = x.reshape(-1, D), vmask.reshape(-1)
    t = flat.shape[0] // G
    assigns, counts = [], []
    for g in range(G):
        r = R.route_topk(jnp.asarray(flat[g * t:(g + 1) * t]),
                         params["router"], top_k=k,
                         num_real_experts=moe.num_experts)
        a = np.where(v[g * t:(g + 1) * t, None], np.asarray(r.assign), Ep)
        assigns.append(a)
        counts.append(np.bincount(a.reshape(-1), minlength=Ep + 1)[:Ep])
    m_all = jnp.asarray(np.stack(counts).astype(np.int32))
    S_j, _ = SCH.schedule(m_all, topo, policy=moe.policy, q=spec.q,
                          c_pair=spec.c_pair, num_foreign_slots=K)
    lays = [JD.build_layout(S_j, jnp.asarray(assigns[g].astype(np.int32)),
                            jnp.int32(g), topo, c_pair=spec.c_pair,
                            c_total=spec.c_total, num_foreign_slots=K,
                            block_m=spec.block_m) for g in range(G)]
    rec = {"x": x, "vmask": vmask, "y": np.asarray(y), "S": np.asarray(S_j),
           "fids": np.asarray(JP.all_foreign_ids(S_j, topo, K))}
    rec.update(flatten(jax.device_get(params), "params/"))
    rec.update(flatten(jax.device_get(diag), "diag/"))
    for f in lays[0]._fields:
        rec["layout/" + f] = np.stack([np.asarray(getattr(l, f)) for l in lays])
    out.update({name + "|" + key: val for key, val in rec.items()})
np.savez(OUT, **out)
'''


@pytest.fixture(scope="module")
def jax_cases(tmp_path_factory):
    cases = {f"{p}-{E}": case_config(p, E) for p in POLICIES for E in EXPERTS}
    body = (f"import numpy as np\nG, B, S, D = {G}, {B}, {S}, {D_MODEL}\n"
            f"CASES = {cases!r}\n" + JAX_BODY)
    flat = run_jax(body, tmp_path_factory.mktemp("ep") / "moe.npz")
    out = {}
    for key, val in flat.items():
        name, rest = key.split("|", 1)
        out.setdefault(name, {})[rest] = val
    return out


def _spec(policy, E):
    fields, _ = case_config(policy, E)
    return MoEBlockSpec(moe=MoEConfig(**fields), d_model=D_MODEL,
                        ep_degree=G, tokens_local=B * S, block_m=8)


@pytest.mark.parametrize("E", EXPERTS)
@pytest.mark.parametrize("policy", POLICIES)
def test_moe_block_g4_matches_jax_mesh(jax_cases, monkeypatch, policy, E):
    rec = jax_cases[f"{policy}-{E}"]
    spec = _spec(policy, E)
    params = to_torch(sub_tree(rec, "params"), device="cpu")
    y, diag, got = run_captured(monkeypatch, spec, params, rec["x"],
                                 rec["vmask"], TD.VirtualGroup(G, "cpu"))
    assert_block_matches(rec, y, diag, got, spec)
    if policy == "harmoeny":
        assert float(diag["send_drops"] + diag["dest_drops"]) == 0
        assert float(diag["moved_units"].sum()) > 0     # Alg. 2 moved units
        # the foreign groups carried rows on some rank
        epr = spec.topo.experts_per_rank
        assert sum(int(l.group_sizes[epr:].sum()) for l in got["layout"]) > 0


def test_padded_experts_convert_rank_major(jax_cases):
    """E = 10 on 4 ranks: 12 slot rows, row g * 3 + j holds the expert in
    slot j of rank g (the padded experts 10 and 11 included), and each
    rank's shard is its three rows."""
    rec = jax_cases["harmoeny-10"]
    params = to_torch(sub_tree(rec, "params"), device="cpu")
    spec = _spec("harmoeny", 10)
    topo = spec.topo
    assert params["w_in"].shape[0] == G * topo.experts_per_rank == 12
    assert params["router"].shape[1] == topo.padded_experts == 12
    assert sorted(topo.slot_map.reshape(-1).tolist()) == list(range(12))
    for g in range(G):
        shard = expert_shard(params, g, G)
        assert shard["router"] is params["router"]
        for name in ("w_in", "w_out", "w_gate"):
            np.testing.assert_array_equal(
                shard[name].numpy(),
                rec[f"params/{name}"][g * 3:(g + 1) * 3])


def test_virtual_group_gathers_expert_rows_as_a_view():
    """The even_split all-gather of each rank's expert rows hands back the
    rank-major weight itself, not a copy."""
    w = torch.randn(8, 3, 5)
    vg = TD.VirtualGroup(4, "cpu")

    def body(me):
        return (yield from TP.gather_all_experts(vg.expert_rows(w, me, 2)))
    outs = vg.run_ranks(body)
    for o in outs:
        assert o.data_ptr() == w.data_ptr() and o.shape == w.shape
        assert torch.equal(o, w)


def test_virtual_group_collectives():
    """all_gather stacks in rank order, all_to_all sets out[dst][src] =
    in[src][dst], psum sums; ranks asking for different collectives, or
    leaving at different points, raise."""
    vg = TD.VirtualGroup(3, "cpu")
    xs = [torch.arange(6.).reshape(3, 2) + 10 * g for g in range(3)]

    def body(me):
        gathered = yield from TD.all_gather(xs[me][0])
        swapped = yield from TD.all_to_all(xs[me])
        total = yield from TD.psum(xs[me])
        return gathered, swapped, total
    for me, (gathered, swapped, total) in enumerate(vg.run_ranks(body)):
        assert torch.equal(gathered, torch.stack([x[0] for x in xs]))
        for src in range(3):
            assert torch.equal(swapped[src], xs[src][me])
        assert torch.equal(total, xs[0] + xs[1] + xs[2])

    def mismatched(me):
        if me == 1:
            yield from TD.psum(xs[me])
        else:
            yield from TD.all_gather(xs[me])
    with pytest.raises(RuntimeError, match="different collectives"):
        vg.run_ranks(mismatched)

    def early_exit(me):
        if me:
            yield from TD.psum(xs[me])
        return me
    with pytest.raises(RuntimeError, match="lockstep"):
        vg.run_ranks(early_exit)
    with pytest.raises(ValueError, match="got a tensor on meta"):
        TD.VirtualGroup(2, "cpu").run_ranks(
            lambda me: TD.psum(torch.zeros(1, device="meta")))


def test_moe_block_rejects_a_group_of_another_size():
    spec = dataclasses.replace(_spec("harmoeny", 8), ep_degree=2)
    with pytest.raises(ValueError, match="EP degree 2"):
        TM.moe_block(torch.zeros(1, 4, D_MODEL), {}, spec=spec,
                     comm=TD.VirtualGroup(4, "cpu"))
