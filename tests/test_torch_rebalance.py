"""Hot-expert replica slots (paper §4.2) in the port against the JAX
package, on the CPU.

The pieces, on the same seeded inputs (integers exactly equal):
``replica_slot_map``; ``initial_assign`` and ``schedule`` with the
per-call ``extra_local`` and ``non_local`` masks; ``build_layout`` with
replica groups between the local and the foreign ones;
``all_foreign_ids`` skipping replica holders; the ``ExpertRebalancer``'s
decisions; and ``moe_gmm``'s plain version with three weight sources
against the JAX tile-scan reference on the concatenated weights.

The engine: a reduced qwen15-moe-a27b in f32 at EP degree 4 (q = 1, the
paper's 0.9 skew) with ``replica_slots=1, rebalance_interval=3``, served
by the port on ``VirtualGroup(4)`` and by the JAX ``ServeEngine`` on a
(1, 4) mesh of emulated host devices under a ``VirtualClock``, on the
converted weights and the JAX engine's skew draws: greedy streams, the
replica table after every rebalance, swaps, hot experts and
``load_balance`` are equal, a swap fires, ``jit_entries`` has the JAX
engine's keys, and the streams equal those served without replicas."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import dispatch as JD
from repro.core import prefetch as JP
from repro.core import scheduler as JS
from repro.core.grouped_ffn import grouped_ffn_ref
from repro.core.topology import make_topology as jax_make_topology
from repro.serve.engine import EngineConfig as JaxEngineConfig
from repro.serve.rebalance import ExpertRebalancer as JaxRebalancer
from repro_torch.configs.qwen15_moe_a27b import CONFIG as TORCH_QWEN
from repro_torch.core import dispatch as TD
from repro_torch.core import prefetch as TP
from repro_torch.core import scheduler as TS
from repro_torch.core.grouped_ffn import grouped_ffn
from repro_torch.core.topology import make_topology
from repro_torch.models.model import build_model
from repro_torch.serve import EngineConfig, ServeEngine, engine_config_for
from repro_torch.serve.rebalance import ExpertRebalancer

from _ep_helpers import (one_torch_thread,  # noqa: F401 (autouse)
                         placement_jax, placement_port)

G, R = 4, 1
KW = dict(max_slots=3, prompt_len=12, max_new_tokens=6, prefill_chunk=4,
          kv_block_size=4, paged=True)
CELL = dict(replica_slots=R, rebalance_interval=3)


def _t(a):
    return torch.from_numpy(np.array(a))


def _eq(port, ref, what=""):
    np.testing.assert_array_equal(np.asarray(port), np.asarray(ref),
                                  err_msg=what)


def _tables(seed, G, E, R):
    """Seeded routing counts (one expert hot), a replica table with
    empty slots and an expert on its own host, and a residency-style
    demotion of some statically local experts."""
    rng = np.random.default_rng(seed)
    topo = make_topology(G, E)
    Ep = topo.padded_experts
    p = np.full(E, 0.3 / (E - 1))
    p[rng.integers(E)] += 0.7
    counts = np.zeros((G, Ep), np.int32)
    for g in range(G):
        counts[g, :E] = rng.multinomial(int(rng.integers(8, 40)), p / p.sum())
    rep = rng.integers(-1, E, size=(G, R)).astype(np.int32)
    local = np.zeros((G, Ep), bool)
    for g in range(G):
        local[g, topo.slot_map[g]] = True
    non_local = local & (rng.random((G, Ep)) < 0.3)
    return topo, counts, rep, non_local


CASES = [(seed, G_, E, R_) for seed, (G_, E, R_) in enumerate(
    [(4, 8, 1), (4, 8, 2), (4, 16, 3), (8, 16, 2), (2, 6, 2), (4, 60, 2)])]


@pytest.mark.parametrize("seed,G_,E,R_", CASES)
def test_replica_slot_map_equals_jax(seed, G_, E, R_):
    _, _, rep, _ = _tables(seed, G_, E, R_)
    rep[0, :] = 3                      # a duplicate: the highest slot wins
    for ids in (rep, rep[1]):
        got = TD.replica_slot_map(_t(ids), E)
        assert got.dtype == torch.int32
        _eq(got, JD.replica_slot_map(jnp.asarray(ids), E))


@pytest.mark.parametrize("policy", ["harmoeny", "round_robin", "even_split"])
@pytest.mark.parametrize("seed,G_,E,R_", CASES[:4])
def test_schedule_with_placement_masks_equals_jax(policy, seed, G_, E, R_):
    """``initial_assign(extra_local=)`` and ``schedule(extra_local=,
    non_local=)``: S and the four diagnostics exactly equal; the baselines
    ignore both masks."""
    topo, counts, rep, non_local = _tables(seed, G_, E, R_)
    jt = jax_make_topology(G_, E)
    extra = JD.replica_slot_map(jnp.asarray(rep), topo.padded_experts) >= 0
    extra_t = TD.replica_slot_map(_t(rep), topo.padded_experts) >= 0
    _eq(TS.initial_assign(_t(counts), topo, extra_local=extra_t),
        JS.initial_assign(jnp.asarray(counts), jt, extra_local=extra))
    kw = dict(policy=policy, q=1, c_pair=8, num_foreign_slots=2)
    S_t, d_t = TS.schedule(_t(counts), topo, extra_local=extra_t,
                           non_local=_t(non_local), **kw)
    S_j, d_j = JS.schedule(jnp.asarray(counts), jt, extra_local=extra,
                           non_local=jnp.asarray(non_local), **kw)
    _eq(S_t, S_j, "S")
    for a, b in zip(d_t, d_j):
        _eq(a, b, "diag")
    assert (S_t.sum(dim=2) == _t(counts)).all()
    if policy != "harmoeny":
        S_plain, _ = TS.schedule(_t(counts), topo, **kw)
        _eq(S_t, S_plain)


@pytest.mark.parametrize("seed,G_,E,R_", CASES[:4])
def test_build_layout_with_replica_groups_equals_jax(seed, G_, E, R_):
    """Every rank's layout, group order local | replica | foreign, on the
    schedule the replica table shaped; and ``all_foreign_ids`` fetches no
    expert a destination holds in a replica slot."""
    topo, counts, rep, _ = _tables(seed, G_, E, R_)
    jt = jax_make_topology(G_, E)
    Ep, epr, K = topo.padded_experts, topo.experts_per_rank, 2
    extra = JD.replica_slot_map(jnp.asarray(rep), Ep) >= 0
    S_j, _ = JS.schedule(jnp.asarray(counts), jt, policy="harmoeny", q=1,
                         c_pair=8, num_foreign_slots=K, extra_local=extra)
    S_t = _t(np.asarray(S_j))
    _eq(TP.all_foreign_ids(S_t, topo, K, replica_ids=_t(rep)),
        JP.all_foreign_ids(S_j, jt, K, replica_ids=jnp.asarray(rep)), "fids")
    rng = np.random.default_rng(seed + 100)
    kw = dict(c_pair=8, c_total=8 * (epr + R_ + K) + 64,
              num_foreign_slots=K, block_m=8, num_replica_slots=R_)
    jax_layout = jax.jit(lambda S, a, me, ids: JD.build_layout(
        S, a, me, jt, replica_ids_me=ids, **kw))
    for me in range(G_):
        assign = rng.integers(0, Ep + 1, size=(12, 2)).astype(np.int32)
        lt = TD.build_layout(S_t, _t(assign), me, topo,
                             replica_ids_me=_t(rep[me]), **kw)
        lj = jax_layout(S_j, jnp.asarray(assign), jnp.int32(me),
                        jnp.asarray(rep[me]))
        for f in lt._fields:
            _eq(getattr(lt, f), getattr(lj, f), f"rank {me} {f}")
        assert lt.group_expert.shape == (epr + R_ + K,)


@pytest.mark.parametrize("gated", [True, False])
def test_moe_gmm_plain_three_sources_equal_concatenated_weights(gated):
    """Local | replica | foreign groups passed as three sources compute
    what the JAX tile-scan reference computes on the concatenated rows
    (f32, 2e-5)."""
    bm, d, f, M = 8, 32, 64, 96
    sizes = [8, 0, 16, 3, 9, 0, 5, 7]     # 3 local, 2 replica, 3 foreign
    padded = [-(-s // bm) * bm for s in sizes]
    rng = np.random.default_rng(4)
    x = np.zeros((M, d), np.float32)
    off = 0
    for s, p in zip(sizes, padded):
        x[off:off + s] = rng.normal(size=(s, d)) * 0.5
        off += p
    n = len(sizes)
    w_in, w_gate = (rng.normal(size=(n, d, f)).astype(np.float32) * 0.1
                    for _ in range(2))
    w_out = rng.normal(size=(n, f, d)).astype(np.float32) * 0.1
    act = "silu" if gated else "gelu"
    ref = grouped_ffn_ref(jnp.asarray(x), jnp.asarray(w_in),
                          jnp.asarray(w_out), jnp.asarray(padded, jnp.int32),
                          w_gate=jnp.asarray(w_gate) if gated else None,
                          act=act, block_m=bm)
    t = [_t(a) for a in (w_in, w_out, w_gate)]
    if not gated:
        t[2] = None

    def part(a, b):
        return tuple(None if w is None else w[a:b] for w in t)
    out = grouped_ffn(_t(x), t[0][:3], t[1][:3], _t(np.int32(padded)),
                      w_gate=None if t[2] is None else t[2][:3], act=act,
                      block_m=bm, replica=part(3, 5), foreign=part(5, 8))
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), atol=2e-5,
                               rtol=2e-5)


@pytest.mark.parametrize("seed", range(4))
def test_rebalancer_decisions_equal_jax(seed):
    """The same load streams through the port's and JAX's rebalancers:
    identical hot sets, proposals, weight rows and EMAs, the global and
    the per-layer ones."""
    rng = np.random.default_rng(seed)
    G_, E, R_ = [(4, 8, 1), (4, 8, 2), (4, 16, 3), (8, 64, 2)][seed]
    ours = ExpertRebalancer(make_topology(G_, E), R_, ema_alpha=0.3)
    ref = JaxRebalancer(jax_make_topology(G_, E), R_, ema_alpha=0.3)
    for step in range(30):
        load = rng.poisson(3.0, size=E).astype(np.float64)
        load[(step // 10) % E] += rng.integers(0, 80)   # a drifting hotspot
        layer = int(rng.integers(0, 3)) if step % 2 else None
        ours.observe(load, layer=layer)
        ref.observe(load, layer=layer)
        assert ours.hot() == ref.hot()
        if step % 3 == 2:
            a, b = ours.propose(), ref.propose()
            _eq(a.replica_ids, b.replica_ids)
            _eq(a.weight_rows, b.weight_rows)
            assert (a.hot_experts, a.changed) == (b.hot_experts, b.changed)
    _eq(ours.ema, ref.ema)
    assert ours.layer_ema.keys() == ref.layer_ema.keys()
    for k in ours.layer_ema:
        _eq(ours.layer_ema[k], ref.layer_ema[k])


# ----------------------------------------------------------------------
# the engine against the JAX engine
# ----------------------------------------------------------------------
@pytest.fixture(scope="module")
def jax_replicas(tmp_path_factory):
    return placement_jax(tmp_path_factory, G=G, R=R, KW=KW,
                         CELLS={"replicas": CELL})


def test_engine_replicas_match_jax_engine(jax_replicas):
    params, recs = jax_replicas
    want = recs["replicas"]
    got, eng, left = placement_port(params, G=G, R=R, KW=KW, ekw=CELL,
                                    draws=want["draws"])
    assert left == {"prefill_chunk": [], "decode": []}   # same calls
    rep, jrep = got["report"], want["report"]
    assert rep["n_requests"] == 6
    assert got["streams"] == want["streams"]
    assert got["replica_ids"] == want["replica_ids"]
    for key in ("replica_slots", "rebalance_interval", "rebalances",
                "replica_swaps", "replica_ids", "hot_experts"):
        assert rep["engine"][key] == jrep["engine"][key], key
    assert rep["engine"]["replica_swaps"] >= 1
    assert any(ids != [[-1] * R] * G for ids in got["replica_ids"])
    assert rep["load_balance"] == jrep["load_balance"]
    lb = rep["load_balance"]["decode"]
    assert lb["send_drops_total"] == lb["dest_drops_total"] == 0
    assert rep["jit_entries"].keys() == jrep["jit_entries"].keys()
    assert "replica_swap" in rep["jit_entries"]


def test_replica_streams_equal_streams_without_replicas(jax_replicas):
    """Replicas move work between ranks, never the math: the same trace
    served without the mechanism gives the same greedy streams."""
    params, recs = jax_replicas
    draws = recs["replicas"]["draws"]
    with_rep, _, _ = placement_port(params, G=G, R=R, KW=KW, ekw=CELL,
                                    draws=draws)
    without, _, _ = placement_port(params, G=G, R=0, KW=KW, ekw={},
                                   draws=draws)
    assert with_rep["streams"] == without["streams"]
    assert without["report"]["engine"]["replica_slots"] == 0
    assert "replica_swap" not in without["report"]["jit_entries"]


@pytest.mark.parametrize("fields", [
    dict(replica_slots=2, rebalance_interval=8), dict(replica_slots=1),
    dict(rebalance_interval=4), dict(replica_slots=-1),
    dict(rebalance_interval=-2, replica_slots=1)])
def test_engine_config_replica_fields_validate_as_jax(fields):
    """The port's ``EngineConfig`` takes the replica fields and refuses
    exactly what the JAX one refuses."""
    try:
        JaxEngineConfig(**fields)
    except ValueError:
        with pytest.raises(ValueError):
            EngineConfig(**fields)
    else:
        cfg = EngineConfig(**fields)
        for k, v in fields.items():
            assert getattr(cfg, k) == v


def test_engine_refuses_a_replica_slot_mismatch():
    """The model must be built with the slots (shapes are static), as the
    JAX engine requires."""
    cfg = TORCH_QWEN.reduced()
    model = build_model(cfg, batch=2, seq_len=8, device="cpu", ep_degree=G)
    params = model.init(0)
    assert not any(k.startswith("w_rep_")
                   for k in params["stack"]["blocks"]["sub0"]["moe"])
    ecfg = engine_config_for(cfg, max_slots=2, prompt_len=8,
                             max_new_tokens=4, prefill_chunk=4,
                             replica_slots=1, rebalance_interval=2)
    with pytest.raises(ValueError, match="num_replica_slots"):
        ServeEngine(model, params, ecfg, device="cpu")
    rep_cfg = dataclasses.replace(cfg, moe=dataclasses.replace(
        cfg.moe, num_replica_slots=2))
    rep_params = build_model(rep_cfg, batch=2, seq_len=8, device="cpu",
                             ep_degree=G).init(0)
    moe = rep_params["stack"]["blocks"]["sub0"]["moe"]
    for name in ("in", "out", "gate"):
        w, w_rep = moe[f"w_{name}"], moe[f"w_rep_{name}"]
        assert w_rep.shape == (w.shape[0], G * 2) + w.shape[2:]
        assert not w_rep.any()                 # empty slots start at zero
