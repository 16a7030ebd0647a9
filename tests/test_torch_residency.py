"""Tiered expert residency (paper §4.3) in the port against the JAX
package, on the CPU.

The pieces: ``residency_non_local`` and ``stage_expert_rows`` equal their
JAX functions on seeded inputs; the port's ``ResidencyCache`` and
``ExpertResidencyManager`` run side by side with JAX's on the same
random op interleavings and per-layer load streams (the programs of
``tests/test_residency_properties.py``) and decide identically; the host
tier holds every expert row and a stage writes rows back in place.

The engine: a reduced qwen15-moe-a27b in f32 at EP degree 4 (8 experts,
2 a rank; q = 1, the paper's 0.9 skew) on the slab pool, with residency
off, fully resident (8) and tight (4: W = 1) under each prefetch policy,
served by the port on ``VirtualGroup(4)`` and by the JAX ``ServeEngine``
on a (1, 4) mesh of emulated host devices under a ``VirtualClock``, on
the converted weights and the JAX engine's skew draws: greedy streams,
every ``[G, W]`` table, every stage's rows, the ``residency`` and
``load_balance`` sections are equal; the streams equal each other and
residency off; the tight budgets stage, ``none`` never does."""
import random

import jax.numpy as jnp
import numpy as np
import pytest
import torch

try:
    from hypothesis import given, settings, strategies as st
except ImportError:                                   # pragma: no cover
    from _hypothesis_shim import given, settings, strategies as st

from repro.core import prefetch as JP
from repro.core.topology import make_topology as jax_make_topology
from repro.serve import residency as JR
from repro.serve.engine import EngineConfig as JaxEngineConfig
from repro_torch.configs.qwen15_moe_a27b import CONFIG as TORCH_QWEN
from repro_torch.core import prefetch as TP
from repro_torch.core.topology import make_topology
from repro_torch.models.model import build_model
from repro_torch.serve import EngineConfig, ServeEngine, engine_config_for
from repro_torch.serve import residency as TR
from repro_torch.serve.metrics import ServeMetrics
from repro_torch.serve.placement import HostTier, expert_leaves

from _ep_helpers import (one_torch_thread,  # noqa: F401 (autouse)
                         placement_jax, placement_port)

G = 4
KW = dict(max_slots=3, prompt_len=12, max_new_tokens=6, prefill_chunk=4)
CELLS = {"full": dict(resident_experts=8),
         "predictive": dict(resident_experts=4),
         "on_demand": dict(resident_experts=4, prefetch_policy="on_demand"),
         "none": dict(resident_experts=4, prefetch_policy="none")}


def _eq(port, ref, what=""):
    np.testing.assert_array_equal(np.asarray(port), np.asarray(ref),
                                  err_msg=what)


@pytest.mark.parametrize("G_,E,W,seed", [(4, 8, 1, 0), (4, 16, 2, 1),
                                         (2, 12, 5, 2), (8, 64, 3, 3)])
def test_residency_non_local_equals_jax(G_, E, W, seed):
    rng = np.random.default_rng(seed)
    topo = make_topology(G_, E)
    ids = np.full((G_, W), -1, np.int32)
    for g in range(G_):
        n = int(rng.integers(0, W + 1))        # -1 pads past the residents
        ids[g, :n] = rng.choice(topo.slot_map[g], size=n, replace=False)
    got = TP.residency_non_local(torch.from_numpy(ids), topo)
    assert got.dtype == torch.bool
    _eq(got, JP.residency_non_local(jnp.asarray(ids),
                                    jax_make_topology(G_, E)))


@pytest.mark.parametrize("shape,rows", [
    ((2, 6, 4, 8), [3, 0, 3]), ((6, 4, 8), [5]), ((3, 5, 8, 4), [1, 4])])
def test_stage_expert_rows_equals_jax(shape, rows):
    """In place, row axis third from last, duplicate rows allowed (they
    carry identical values: rows of one host copy)."""
    rng = np.random.default_rng(len(rows))
    w = rng.normal(size=shape).astype(np.float32)
    host = rng.normal(size=shape).astype(np.float32)
    vals = np.take(host, rows, axis=len(shape) - 3)
    wt = torch.from_numpy(w.copy())
    out = TP.stage_expert_rows(wt, rows, torch.from_numpy(vals))
    assert out is wt
    _eq(wt, JP.stage_expert_rows(jnp.asarray(w), jnp.asarray(rows),
                                 jnp.asarray(vals)))


def run_cache_programs(seed: int, n_ops: int = 80) -> None:
    """One random interleaving of lookup / stage / evict / pin / unpin on
    the port's cache and JAX's: the same answers and state every op."""
    rng = random.Random(seed)
    shard = list(range(rng.randint(2, 10)))
    cap = rng.randint(1, len(shard))
    ours, ref = TR.ResidencyCache(cap, shard), JR.ResidencyCache(cap, shard)
    for _ in range(n_ops):
        op = rng.choice(["lookup", "lookup", "stage", "stage", "evict",
                         "pin", "unpin"])
        e = rng.choice(shard)
        if op == "pin":
            sub = rng.sample(shard, rng.randint(0, len(shard)))
            args = (sub,)
        elif op == "unpin":
            args = ()
        else:
            args = (e,)
        assert getattr(ours, op)(*args) == getattr(ref, op)(*args), op
        assert ours.resident == ref.resident
        assert ours.pinned == ref.pinned
        assert (ours.hits, ours.misses, ours.lookups, ours.evictions,
                ours.stages) == (ref.hits, ref.misses, ref.lookups,
                                 ref.evictions, ref.stages)
    for cls in (TR.ResidencyCache, JR.ResidencyCache):
        with pytest.raises(KeyError):
            cls(cap, shard).lookup(max(shard) + 1)


@settings(max_examples=40, deadline=None, derandomize=True)
@given(st.integers(0, 2 ** 31 - 1))
def test_cache_random_interleavings_equal_jax(seed):
    run_cache_programs(seed)


def run_manager_programs(seed: int, n_steps: int = 12) -> None:
    """One random per-layer load stream through the port's manager and
    JAX's: identical decisions and counters every step."""
    rng = random.Random(seed)
    G_ = rng.choice([1, 2, 4])
    E = G_ * rng.randint(1, 4)
    epr = make_topology(G_, E).experts_per_rank
    W = rng.randint(1, epr)
    policy = rng.choice(list(TR.PREFETCH_POLICIES))
    cost = dict(expert_bytes=float(rng.choice([0, 4096])))
    ours = TR.ExpertResidencyManager(
        make_topology(G_, E), W * G_, policy=policy,
        cost=TR.TierCostModel(**cost))
    ref = JR.ExpertResidencyManager(
        jax_make_topology(G_, E), W * G_, policy=policy,
        cost=JR.TierCostModel(**cost))
    _eq(ours._last_ids, ref._last_ids)
    load_rng = np.random.default_rng(seed)
    n_layers = rng.randint(1, 3)
    for _ in range(n_steps):
        loads = load_rng.integers(0, 3, (n_layers, ours.topo.padded_experts))
        a, b = ours.step(loads.astype(np.float64)), \
            ref.step(loads.astype(np.float64))
        _eq(a.residency_ids, b.residency_ids)
        _eq(a.stage_rows, b.stage_rows)
        assert (a.changed, a.hits, a.misses, a.prefetches, a.stall_units,
                a.bytes_staged) == (b.changed, b.hits, b.misses,
                                    b.prefetches, b.stall_units,
                                    b.bytes_staged)
    assert ours.counters() == ref.counters()


@settings(max_examples=40, deadline=None, derandomize=True)
@given(st.integers(0, 2 ** 31 - 1))
def test_manager_random_streams_equal_jax(seed):
    run_manager_programs(seed)


def test_manager_validation_and_cost_model_equal_jax():
    """The same budgets and policies refused, and the modeled link rate
    kept at the reference's 16e9 B/s, so ``stall_units`` equal JAX's."""
    assert TR.PREFETCH_POLICIES == JR.PREFETCH_POLICIES
    assert TR.TierCostModel() == TR.TierCostModel(0.0, 16e9)
    for kw in (dict(expert_bytes=0.0), dict(expert_bytes=4e8)):
        ours, ref = TR.TierCostModel(**kw), JR.TierCostModel(**kw)
        assert ours.pcie_bw == ref.pcie_bw == 16e9
        assert ours.stall_units(3) == ref.stall_units(3)
    for args, kw in (((0,), {}), ((3,), {}), ((10,), {}),
                     ((2,), dict(policy="psychic"))):
        for mod, mk in ((TR, make_topology), (JR, jax_make_topology)):
            with pytest.raises(ValueError):
                mod.ExpertResidencyManager(mk(2, 8), *args, **kw)


def test_host_tier_holds_every_row_and_stages_in_place():
    """The tier's row r is row r of every expert leaf; a stage writes the
    named rows back into the leaves, and only those."""
    cfg = TORCH_QWEN.reduced()
    params = build_model(cfg, batch=2, seq_len=8, device="cpu",
                         ep_degree=G).init(0)
    leaves = expert_leaves(params)
    assert len(leaves) == 3                    # w_in, w_out, w_gate
    tier = HostTier(leaves)
    assert tier.n_rows == 8 and tier.nbytes == sum(
        w.numel() * w.element_size() for w in leaves)
    before = [w.clone() for w in leaves]
    for w in leaves:
        w.zero_()
    tier.stage([5, 2])
    for w, b in zip(leaves, before):
        for r in range(8):
            want = b[:, r] if r in (5, 2) else torch.zeros_like(b[:, r])
            assert torch.equal(w[:, r], want), r
    tier.release()
    assert tier.rows == []


# ----------------------------------------------------------------------
# the engine against the JAX engine
# ----------------------------------------------------------------------
@pytest.fixture(scope="module")
def jax_residency(tmp_path_factory):
    return placement_jax(tmp_path_factory, G=G, R=0, KW=KW, CELLS=CELLS)


@pytest.fixture(scope="module")
def port_off(jax_residency):
    params, recs = jax_residency
    rec, _, _ = placement_port(params, G=G, R=0, KW=KW, ekw={},
                               draws=recs["full"]["draws"])
    return rec


@pytest.mark.parametrize("cell", list(CELLS))
def test_engine_residency_matches_jax_engine(jax_residency, port_off, cell):
    params, recs = jax_residency
    want = recs[cell]
    got, eng, left = placement_port(params, G=G, R=0, KW=KW,
                                    ekw=CELLS[cell], draws=want["draws"])
    assert left == {"prefill_chunk": [], "decode": []}   # same calls
    rep, jrep = got["report"], want["report"]
    assert rep["n_requests"] == 6
    assert got["streams"] == want["streams"] == port_off["streams"]
    assert got["residency_ids"] == want["residency_ids"]
    assert got["stage_rows"] == want["stage_rows"]
    assert rep["residency"] == jrep["residency"]
    assert rep["load_balance"] == jrep["load_balance"]
    for key in ("resident_experts", "prefetch_policy", "residency_stages",
                "residency_ids"):
        assert rep["engine"][key] == jrep["engine"][key], key
    assert rep["jit_entries"].keys() == jrep["jit_entries"].keys()
    assert rep["jit_entries"]["residency_stage"] == 0     # never captured
    lb = rep["load_balance"]["decode"]
    assert lb["send_drops_total"] == lb["dest_drops_total"] == 0
    res = rep["residency"]
    assert res["hits"] + res["misses"] == res["lookups"] > 0
    stages = eng.stage_times()
    assert [s["rows"] for s in stages] == [len(r) for r in got["stage_rows"]]
    if cell == "full":
        assert res["hit_rate"] == 1.0 and not got["stage_rows"]
    elif cell == "none":
        assert res["swaps"] == 0 and res["bytes_staged"] == 0
        assert not got["stage_rows"]
        assert len({str(t) for t in got["residency_ids"]}) == 1   # frozen
    else:
        assert rep["engine"]["residency_stages"] >= 1
        # the rows copied: each decision's distinct rows (the model
        # counts every stage, a row staged twice in a step twice)
        assert 0 < sum(s["bytes"] for s in stages) <= res["bytes_staged"]


def test_engine_residency_off_has_no_section(port_off):
    rep = port_off["report"]
    assert "residency" not in rep
    assert rep["engine"]["resident_experts"] == 0
    assert "residency_stage" not in rep["jit_entries"]
    m = ServeMetrics()
    m.residency = {"hits": 1, "lookups": 1, "hit_rate": 1.0}
    assert m.report()["residency"]["hit_rate"] == 1.0


@pytest.mark.parametrize("fields", [
    dict(resident_experts=8, prefetch_policy="on_demand"),
    dict(resident_experts=-1), dict(prefetch_policy="psychic"),
    dict(resident_experts=4, prefetch_policy="none")])
def test_engine_config_residency_fields_validate_as_jax(fields):
    try:
        JaxEngineConfig(**fields)
    except ValueError:
        with pytest.raises(ValueError):
            EngineConfig(**fields)
    else:
        cfg = EngineConfig(**fields)
        for k, v in fields.items():
            assert getattr(cfg, k) == v


@pytest.mark.parametrize("bad", [3, 12])
def test_engine_refuses_a_bad_residency_budget(bad):
    """A budget that does not split over the EP degree, or exceeds the
    expert rows, is refused when the engine is built, as in JAX."""
    cfg = TORCH_QWEN.reduced()
    model = build_model(cfg, batch=2, seq_len=8, device="cpu", ep_degree=G)
    ecfg = engine_config_for(cfg, max_slots=2, prompt_len=8,
                             max_new_tokens=4, prefill_chunk=4,
                             resident_experts=bad)
    with pytest.raises(ValueError, match="resident_experts"):
        ServeEngine(model, model.init(0), ecfg, device="cpu")
