"""HarMoEny MoE control and data plane of the PyTorch port against the JAX
package: tie-breaking top-k routing, schedules and dispatch layouts
integer for integer, the G = 1 MoE block (outputs and diagnostics), and
the foreign-weight fetch."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.base import MoEConfig as JMoE
from repro.core import dispatch as JD
from repro.core import prefetch as JP
from repro.core import scheduler as JS
from repro.core.moe_layer import MoEBlockSpec as JSpec
from repro.core.moe_layer import init_moe_params, moe_block as jax_moe_block
from repro.core.router import route_topk as jax_route_topk
from repro.core.topology import make_topology as jax_topology
from repro.launch.mesh import make_mesh
from repro_torch.configs.base import MoEConfig as TMoE
from repro_torch.core import dispatch as TD
from repro_torch.core import prefetch as TP
from repro_torch.core import scheduler as TS
from repro_torch.core.moe_layer import MoEBlockSpec as TSpec
from repro_torch.core.moe_layer import SCALAR_DIAGS, VECTOR_DIAGS
from repro_torch.core.moe_layer import moe_block as torch_moe_block
from repro_torch.core.router import route_topk
from repro_torch.core.topology import make_topology


def test_route_topk_breaks_ties_toward_lower_expert():
    rng = np.random.default_rng(0)
    # logits quantized to a few levels: many exact ties per row
    x = rng.integers(-2, 3, size=(64, 8)).astype(np.float32)
    w = np.eye(8, 12, dtype=np.float32)            # 12 experts, 2 padded
    j = jax_route_topk(jnp.asarray(x), jnp.asarray(w), top_k=4,
                       num_real_experts=10)
    t = route_topk(torch.from_numpy(x), torch.from_numpy(w), top_k=4,
                   num_real_experts=10)
    np.testing.assert_array_equal(t.assign.numpy(), np.asarray(j.assign))
    np.testing.assert_array_equal(t.counts.numpy(), np.asarray(j.counts))
    np.testing.assert_allclose(t.gates.numpy(), np.asarray(j.gates),
                               atol=1e-6)
    np.testing.assert_allclose(float(t.aux_loss), float(j.aux_loss),
                               rtol=1e-6)


@pytest.mark.parametrize("policy", ["harmoeny", "round_robin", "even_split",
                                    "static_opt"])
@pytest.mark.parametrize("G,E", [(1, 60), (4, 16), (8, 4)])
def test_schedule_equals_jax(policy, G, E):
    rng = np.random.default_rng(G * 100 + E)
    jt, tt = jax_topology(G, E), make_topology(G, E)
    np.testing.assert_array_equal(tt.slot_map, jt.slot_map)
    np.testing.assert_array_equal(tt.host_of, jt.host_of)
    K = 2
    moved = 0
    for trial in range(4):
        # skewed counts: one hot expert takes most units
        counts = rng.integers(0, 6, size=(G, jt.padded_experts))
        counts[:, trial % jt.padded_experts] += rng.integers(
            10, 60, size=G)
        counts = counts.astype(np.int32)
        kw = dict(policy=policy, q=2, c_pair=24, num_foreign_slots=K)
        S_j, d_j = JS.schedule(jnp.asarray(counts), jt, **kw)
        S_t, d_t = TS.schedule(torch.from_numpy(counts), tt, **kw)
        np.testing.assert_array_equal(S_t.numpy(), np.asarray(S_j))
        for a, b in zip(d_t, d_j):
            assert int(a) == int(b), (d_t, d_j)
        np.testing.assert_array_equal(S_t.numpy().sum(axis=2), counts)
        moved += int(d_t.moved)
    if policy == "harmoeny" and G > 1:
        assert moved > 0                 # the Alg. 2 loop really ran


@pytest.mark.parametrize("G,me", [(1, 0), (4, 0), (4, 3)])
def test_build_layout_equals_jax(G, me):
    E, k, T, bm, K = 8, 2, 12, 8, 2
    jt, tt = jax_topology(G, E), make_topology(G, E)
    rng = np.random.default_rng(G + me)
    assign = rng.integers(0, E, size=(T, k)).astype(np.int32)
    assign[-2:] = E                                # padding units (sentinel)
    counts_all = rng.integers(0, 5, size=(G, E)).astype(np.int32)
    counts_all[me] = np.bincount(assign.reshape(-1), minlength=E + 1)[:E]
    S_j, _ = JS.schedule(jnp.asarray(counts_all), jt, policy="harmoeny",
                         q=1, c_pair=6, num_foreign_slots=K)
    kw = dict(c_pair=6, c_total=96, num_foreign_slots=K, block_m=bm)
    lj = JD.build_layout(S_j, jnp.asarray(assign), jnp.int32(me), jt, **kw)
    lt = TD.build_layout(torch.from_numpy(np.array(S_j)),
                         torch.from_numpy(assign), me, tt, **kw)
    for name in lj._fields:
        np.testing.assert_array_equal(
            getattr(lt, name).numpy(), np.asarray(getattr(lj, name)),
            err_msg=name)


def _oracle_spec(policy, *, B, S, d, f, E, k):
    kw = dict(num_experts=E, num_experts_per_tok=k, d_ff_expert=f,
              policy=policy, capacity_factor=2.0,
              num_foreign_slots=E if policy == "even_split" else 2)
    return (JSpec(moe=JMoE(**kw), d_model=d, ep_axis="model", batch_axes=(),
                  ep_degree=1, tokens_local=B * S, block_m=8, act="silu"),
            TSpec(moe=TMoE(**kw), d_model=d, ep_degree=1, tokens_local=B * S,
                  block_m=8, act="silu"))


@pytest.mark.parametrize("policy", ["harmoeny", "round_robin", "even_split"])
def test_moe_block_g1_matches_jax(policy):
    B, S, d, f, E, k = 2, 16, 16, 32, 4, 2
    js, ts = _oracle_spec(policy, B=B, S=S, d=d, f=f, E=E, k=k)
    mesh = make_mesh((1, 1), ("data", "model"))
    params = init_moe_params(jax.random.PRNGKey(0), js)
    x = np.random.default_rng(1).normal(size=(B, S, d)).astype(np.float32)
    vmask = np.ones((B, S), bool)
    vmask[1, 11:] = False                      # dead tokens (chunk padding)
    with mesh:
        y_j, diag_j = jax.jit(lambda x, p, v: jax_moe_block(
            x, p, spec=js, mesh=mesh, valid_mask=v))(x, params, vmask)
    tp = {n: torch.from_numpy(np.array(v)) for n, v in params.items()}
    y_t, diag_t = torch_moe_block(torch.from_numpy(x), tp, spec=ts,
                                  valid_mask=torch.from_numpy(vmask))
    np.testing.assert_allclose(y_t.numpy(), np.asarray(y_j), atol=2e-5,
                               rtol=2e-5)
    assert set(diag_t) == set(SCALAR_DIAGS) | set(VECTOR_DIAGS) == set(diag_j)
    for key in diag_j:
        np.testing.assert_allclose(diag_t[key].numpy(),
                                   np.asarray(diag_j[key]), atol=1e-6,
                                   err_msg=key)
    assert float(diag_t["send_drops"].sum() + diag_t["dest_drops"].sum()) == 0
    assert ts.c_total == js.c_total and ts.c_pair == js.c_pair


def test_qwen_decode_spec_shapes():
    """The dispatch buffer the card's kernel sees at qwen15-moe-a27b's
    decode (4 slots) and prefill-chunk (32 tokens) shapes."""
    from repro_torch.configs.qwen15_moe_a27b import CONFIG
    spec = TSpec(moe=CONFIG.moe, d_model=CONFIG.d_model, tokens_local=4)
    assert (spec.n_groups, spec.c_total) == (64, 8320)
    spec = TSpec(moe=CONFIG.moe, d_model=CONFIG.d_model, tokens_local=32)
    assert spec.c_total == 8448


def test_all_foreign_ids_equal_jax():
    G, E, K = 4, 8, 2
    jt, tt = jax_topology(G, E), make_topology(G, E)
    counts = np.random.default_rng(5).integers(0, 9, (G, E)).astype(np.int32)
    counts[:, 1] += 40
    S_j, _ = JS.schedule(jnp.asarray(counts), jt, policy="harmoeny", q=1,
                         c_pair=16, num_foreign_slots=K)
    f_j = JP.all_foreign_ids(S_j, jt, K)
    f_t = TP.all_foreign_ids(torch.from_numpy(np.array(S_j)), tt, K)
    np.testing.assert_array_equal(f_t.numpy(), np.asarray(f_j))
    assert (np.asarray(f_j) >= 0).any()            # some expert did move


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_fetch_foreign_weights_g1_matches_jax(dtype):
    """One rank: the gathered rows equal the JAX einsum fetch, -1 ids give
    zeros."""
    E, d, f = 6, 8, 12
    jt, tt = jax_topology(1, E), make_topology(1, E)
    w = np.random.default_rng(6).normal(size=(E, d, f)).astype(np.float32)
    fids = np.asarray([[3, -1, 0, 5]], np.int32)
    jd = {"float32": jnp.float32, "bfloat16": jnp.bfloat16}[dtype]
    td = {"float32": torch.float32, "bfloat16": torch.bfloat16}[dtype]
    mesh = make_mesh((1,), ("model",))
    from repro.core.compat import shard_map
    P = jax.sharding.PartitionSpec
    fn = shard_map(lambda w_, f_: JP.fetch_foreign_weights(
        w_, f_, jax.lax.axis_index("model"), jt, axis_name="model"),
        mesh=mesh, in_specs=(P("model"), P()), out_specs=P(),
        check_vma=False)
    ref = fn(jnp.asarray(w).astype(jd), jnp.asarray(fids))
    out = TP.join(TD.run(TD.LocalComm(), TP.fetch_foreign_weights(
        torch.from_numpy(w).to(td), torch.from_numpy(fids), 0, tt)))
    np.testing.assert_array_equal(out.float().numpy(),
                                  np.asarray(ref, np.float32))
    assert not out[1].any()


class _CaptureComm:
    """Rank ``rank`` of a G-rank group whose all-to-all hands back the
    outbox untouched (stacked on a source axis of one), so a test can
    assemble the real all-to-all across ranks; its fetch is the dense
    form (``DistComm(fetch="dense")``'s) on that all-to-all."""

    def __init__(self, rank, size):
        self.rank, self.size = rank, size

    def all_to_all(self, x):
        return x[None]

    def fetch_rows(self, w_local, fids_all, me, topo, fetch_chunk=0):
        return TD.Fetched(TD.dense_fetch(w_local, fids_all, me, topo,
                                         self.all_to_all, fetch_chunk))


@pytest.mark.parametrize("G,E", [(4, 8), (4, 2)])
def test_fetch_foreign_weights_multirank_oracle(G, E):
    """Across G emulated ranks (hosts_per_expert 1 and 2): each
    destination receives its foreign experts' weights (the mean over their
    hosts, which hold identical copies) and zeros for -1."""
    tt = make_topology(G, E)
    d, f, K = 4, 6, 2
    w_global = np.random.default_rng(7).normal(
        size=(tt.padded_experts, d, f)).astype(np.float32)
    fids = np.random.default_rng(8).integers(
        -1, tt.padded_experts, size=(G, K)).astype(np.int32)
    fids_t = torch.from_numpy(fids)
    outboxes = []
    for g in range(G):
        w_local = torch.from_numpy(w_global[tt.slot_map[g]])
        outboxes.append(TD.run(_CaptureComm(g, G), TP.fetch_foreign_weights(
            w_local, fids_t, g, tt)).rows)                # [G_dst, K, d, f]
    for me in range(G):
        got = sum(ob[me] for ob in outboxes).numpy()
        for kk in range(K):
            want = (w_global[fids[me, kk]] if fids[me, kk] >= 0
                    else np.zeros((d, f), np.float32))
            np.testing.assert_allclose(got[kk], want, atol=1e-6)
