"""The serve engine's decode step as one CUDA graph.

On the CPU: a ``TorchDispatchMode`` guard runs the engine's decode step
(``StepCore._step``, what the graph holds) and fails on any op that syncs
the host or copies host data in (``bincount``, ``_local_scalar_dense``,
``nonzero``, ``masked_select``, ``lift_fresh``, indexing with a boolean
mask), on reduced qwen15-moe-a27b at G = 1 and on four virtual ranks
under each policy (synthetic skew), reduced moonshot-v1-16b-a3b and
reduced switch128, on the slab and paged.  The plain version of the
schedule kernel is the one exempt region: it stands in for the one-CTA
kernel (``kernels/schedule``) and reads its input on the host by nature.
Beside it: the dump-row scatters and scatter-add counts are bit-equal to
the boolean-mask and ``bincount`` forms they replace, the skew pre-draws
equal ``route_skewed``'s per-layer draws, and ``report()`` carries
``jit_entries``.

Marked ``cuda`` (skip without a GPU): one capture of each entry (the
prefill chunk, the decode step, the store's write) across admissions,
slot recycling, block growth, preemption and EOS on both pools; captured
greedy streams equal to eager ones on reduced f32 models, also at two
chunks an engine step and under preemption with resumed re-prefills; and
the card's streams equal to the CPU's.  The prefill chunk's own CPU
checks are in ``test_torch_prefill_capture.py``.

The serving-time expert placement (replica slots, tiered residency) at
G = 4: after swaps and stages the decode step still reads its tables
from the static buffer under the guard, and a table read as Python ints
fails it; on the card, swaps (one captured gather) and stages (copies on
a side stream) between replays equal the eager run, and the card's
streams with both mechanisms equal the CPU's."""
import contextlib
import dataclasses
import os
import shutil

import numpy as np
import pytest
import torch
from torch.utils._python_dispatch import TorchDispatchMode

from repro_torch.configs.registry import get_config
from repro_torch.core import dispatch as D
from repro_torch.core.router import expert_counts, route_skewed
from repro_torch.core.scheduler import schedule
from repro_torch.core.topology import make_topology, static_opt_placement
from repro_torch.kernels.schedule import ops as schedule_ops
from repro_torch.models.model import build_model
from repro_torch.serve import (Request, ServeEngine, VirtualClock,
                               engine_config_for, stepcore)

from _ep_helpers import one_torch_thread  # noqa: F401 (autouse)
from _serve_helpers import captured_run

aten = torch.ops.aten
SLOTS, L, GEN, C, G = 3, 12, 6, 4, 4
SYNCING = {aten.bincount.default, aten._local_scalar_dense.default,
           aten.nonzero.default, aten.masked_select.default,
           aten.lift_fresh.default}
INDEXING = {aten.index.Tensor, aten.index_put_.default,
            aten.index_put.default, aten._index_put_impl_.default}


class HostSyncGuard(TorchDispatchMode):
    """Records every op that would sync the host or copy host data in;
    ``exempt`` counts calls inside the exempt region."""

    def __init__(self):
        super().__init__()
        self.hits, self.ops, self.paused, self.exempt = [], 0, 0, 0
        self.active = False

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        self.ops += 1
        bad = func in SYNCING or (func in INDEXING and any(
            isinstance(i, torch.Tensor) and i.dtype == torch.bool
            for i in args[1]))
        if bad and not self.paused:
            self.hits.append(str(func))
        return func(*args, **kwargs)


def _guarded_decode_steps(eng, monkeypatch, n_steps=2):
    """Serve until the batch decodes, then ``n_steps`` decode steps whose
    ``StepCore._step`` runs under the guard."""
    guard = HostSyncGuard()
    plain = schedule_ops.rebalance_plain

    def exempt_plain(*args, **kwargs):
        guard.paused += 1
        guard.exempt += guard.active
        try:
            return plain(*args, **kwargs)
        finally:
            guard.paused -= 1
    monkeypatch.setattr(schedule_ops, "rebalance_plain", exempt_plain)
    step = eng.core._step

    def guarded(params, pool):
        guard.active = True
        try:
            with guard:
                return step(params, pool)
        finally:
            guard.active = False
    rng = np.random.default_rng(5)
    for i in range(SLOTS):
        eng.submit(Request(rid=i, tokens=rng.integers(
            1, 500, (int(rng.integers(3, L + 1)),)), max_new_tokens=GEN))
    while not eng.active.any():
        eng.step()
    monkeypatch.setattr(eng.core, "_step", guarded)
    for _ in range(n_steps):
        assert eng._decode_work(eng.clock.now())
    return guard


def _reduced(arch, **moe):
    cfg = get_config(arch).reduced()
    if moe:
        cfg = dataclasses.replace(cfg, moe=dataclasses.replace(cfg.moe,
                                                               **moe))
    return cfg


def _engine(cfg, *, paged, ep_degree=1, policy=None, device="cpu",
            **ecfg):
    model = build_model(cfg, batch=SLOTS, seq_len=L, device=device,
                        ep_degree=ep_degree)
    params = build_model(cfg, batch=SLOTS, seq_len=L, device="cpu",
                         ep_degree=ep_degree).init(0)
    params = _tree_to(params, device)
    kw = dict(max_slots=SLOTS, prompt_len=L, max_new_tokens=GEN,
              prefill_chunk=C, kv_block_size=4, paged=paged,
              moe_policy=policy, skew_seed=3)
    cps = ecfg.pop("chunks_per_step", 1)
    kw.update(ecfg)
    ecfg = dataclasses.replace(engine_config_for(cfg, **kw),
                               chunks_per_step=cps)
    return ServeEngine(model, params, ecfg, clock=VirtualClock(0.1),
                       device=device)


def _tree_to(tree, dev):
    if isinstance(tree, dict):
        return {k: _tree_to(v, dev) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_tree_to(v, dev) for v in tree]
    return tree.to(dev)


def _static_opt_cfg():
    """Reduced qwen under skew with the static_opt placement of a profile
    whose expert 0 is hot."""
    profile = np.array([90, 2, 3, 1, 2, 1, 0, 1])
    placement = tuple(int(p) for p in static_opt_placement(profile, G))
    return _reduced("qwen15-moe-a27b", q_tokens=1, router_skew=0.9,
                    placement=placement)


# (arch, ep_degree, policy): G = 1 under the config's policy; G = 4 under
# each policy with the paper's synthetic skew (0.9 on one expert, q = 1)
GUARD_CASES = ([("qwen15-moe-a27b", 1, None)]
               + [("qwen15-moe-a27b", G, p) for p in
                  ("harmoeny", "round_robin", "even_split", "static_opt")]
               + [("moonshot-v1-16b-a3b", 1, None), ("switch128", 1, None)])


@pytest.mark.parametrize("paged", [False, True], ids=["slab", "paged"])
@pytest.mark.parametrize("arch,ep,policy", GUARD_CASES)
def test_decode_step_never_syncs_the_host(arch, ep, policy, paged,
                                          monkeypatch):
    if policy == "static_opt":
        cfg = _static_opt_cfg()
    elif ep > 1:
        cfg = _reduced(arch, q_tokens=1, router_skew=0.9)
    else:
        cfg = _reduced(arch)
    eng = _engine(cfg, paged=paged, ep_degree=ep, policy=policy)
    guard = _guarded_decode_steps(eng, monkeypatch)
    assert guard.ops > 100                   # the step ran under the guard
    assert guard.hits == []
    harmoeny = (policy or cfg.moe.policy) == "harmoeny"
    assert (guard.exempt > 0) == harmoeny    # only the schedule's plain form
    assert eng.core.skew == (ep > 1)


# ----------------------------------------------------------------------
# the capture-safe forms against the forms they replace
# ----------------------------------------------------------------------
def _scatter_drop_masked(n, idx, vals, *, fill, add=False):
    """The boolean-mask form ``_scatter_drop`` had before."""
    out = torch.full((n,), fill, dtype=vals.dtype, device=vals.device)
    keep = (idx >= 0) & (idx < n)
    if add:
        return out.index_add_(0, idx[keep].long(), vals[keep])
    out[idx[keep].long()] = vals[keep]
    return out


@pytest.mark.parametrize("add", [False, True])
@pytest.mark.parametrize("dtype", [torch.int32, torch.float32])
def test_scatter_drop_equals_the_masked_form(add, dtype):
    rng = np.random.default_rng(1)
    for n in (1, 5, 17):
        for size in (0, 3, 40):
            idx = torch.from_numpy(rng.integers(-3, n + 4, size).astype(
                np.int32))
            vals = torch.from_numpy(rng.normal(size=size) * 100).to(dtype)
            want = _scatter_drop_masked(n, idx, vals, fill=-1, add=add)
            got = D._scatter_drop(n, idx, vals, fill=-1, add=add)
            assert got.dtype == want.dtype and got.shape == (n,)
            assert torch.equal(got, want)


def test_expert_counts_equal_bincount():
    rng = np.random.default_rng(2)
    for bins in (1, 8, 61, 129):
        for shape in ((0,), (7,), (16, 4), (3, 5, 2)):
            v = torch.from_numpy(rng.integers(0, bins, shape))
            got = expert_counts(v.to(torch.int32), bins)
            want = torch.bincount(v.reshape(-1), minlength=bins).to(
                torch.int32)
            assert got.dtype == torch.int32 and torch.equal(got, want)


def _dispatch_masked(x_units, layout, *, num_ranks, c_pair, c_total):
    """The boolean-mask form ``dispatch`` had before (one rank, where the
    all-to-all is the identity)."""
    d = x_units.shape[-1]
    send = torch.zeros((num_ranks, c_pair, d), dtype=x_units.dtype)
    ok = layout.unit_pair_pos < c_pair
    send[layout.unit_dest[ok].long(), layout.unit_pair_pos[ok].long()] = \
        x_units[ok]
    recv = send.reshape(num_ranks * c_pair, d)
    grouped = torch.zeros((c_total, d), dtype=x_units.dtype)
    tgt = layout.row_target.reshape(-1)
    ok = tgt < c_total
    grouped[tgt[ok].long()] = (recv * layout.row_valid.reshape(-1, 1).to(
        recv.dtype))[ok]
    ok = layout.unit_row_self < c_total
    grouped[layout.unit_row_self[ok].long()] = x_units[ok]
    return grouped


class _Identity:
    """All-to-all answered with its input, as one rank's stand-in."""

    def all_to_all(self, x):
        return x


@pytest.mark.parametrize("c_pair,c_total", [(64, 96), (2, 24)])
def test_dispatch_dump_rows_equal_the_masked_form(c_pair, c_total):
    """Dispatch's grouped buffer, with and without drops (a small pair
    capacity and a small buffer push units and rows past their bounds)."""
    Gd, E, k, T = 4, 8, 2, 12
    topo = make_topology(Gd, E)
    rng = np.random.default_rng(4)
    assigns = [torch.from_numpy(rng.integers(0, E, (T, k)).astype(np.int32))
               for _ in range(Gd)]
    m_all = torch.stack([expert_counts(a, E) for a in assigns])
    S, _ = schedule(m_all, topo, policy="harmoeny", q=1, c_pair=c_pair,
                    num_foreign_slots=2)
    for me in range(Gd):
        layout = D.build_layout(S, assigns[me], me, topo, c_pair=c_pair,
                                c_total=c_total, num_foreign_slots=2,
                                block_m=8)
        x = torch.from_numpy(rng.normal(size=(T * k, 16)).astype(np.float32))
        got = D.run(_Identity(), D.dispatch(x, layout, num_ranks=Gd,
                                            c_pair=c_pair, c_total=c_total))
        want = _dispatch_masked(x, layout, num_ranks=Gd, c_pair=c_pair,
                                c_total=c_total)
        assert got.is_contiguous() and torch.equal(got, want)


def test_skew_predraws_equal_route_skewed_draws():
    """The captured step's pre-drawn assignments are the draws the eager
    block makes on the same key path, and the step routes the same."""
    cfg = _reduced("qwen15-moe-a27b", q_tokens=1, router_skew=0.9)
    eng = _engine(cfg, paged=True, ep_degree=G)
    core, moe = eng.core, cfg.moe
    step = 7
    core._predraw(step)
    ep = eng.model.moe_spec_decode.topo.padded_experts
    t_slice = max(SLOTS, G) // G
    assert core._skew.shape == (cfg.num_layers, G, t_slice,
                                moe.num_experts_per_tok)
    for m, layer in enumerate(core._moe_keys):
        for g in range(G):
            gen = core.dec_key.fold_in(step).fold_in(layer).fold_in(
                g).generator("cpu")
            want = route_skewed(gen, t_slice, top_k=moe.num_experts_per_tok,
                                num_experts=moe.num_experts,
                                padded_experts=ep, alpha=moe.router_skew,
                                n_hot=moe.router_skew_experts).assign
            assert torch.equal(core._skew[m, g], want)
    # one decode step on the same inputs: skew key vs pre-drawn buffer
    model, params = eng.model, eng.params
    rng = np.random.default_rng(0)
    tok = torch.from_numpy(rng.integers(1, 500, (SLOTS, 1)).astype(np.int32))
    pos = torch.tensor([3, 5, 0], dtype=torch.int32)
    active = torch.tensor([True, True, False])
    outs = []
    for kw in (dict(skew_key=core.next_key(core.dec_key, step)),
               dict(skew_assign=core._skew)):
        cache = model.init_cache(SLOTS, L)
        logits, _, _, diags = model.decode_step(
            params, tok, cache, pos, active_mask=active, **kw)
        outs.append((logits, diags))
    assert torch.equal(outs[0][0], outs[1][0])
    assert outs[0][1].keys() == outs[1][1].keys()
    for key in outs[0][1]:
        assert torch.equal(outs[0][1][key], outs[1][1][key]), key


@pytest.mark.parametrize("warm", [False, True])
def test_report_carries_jit_entries(warm):
    """On the CPU the entries run eagerly: the JAX engine's three entry
    names, no capture, and no kernel launch counted (the wrappers run
    their plain versions)."""
    eng = _engine(_reduced("qwen15-moe-a27b"), paged=True)
    launches = [fn.launches for fn in stepcore.kernel_wrappers()]
    if warm:
        eng.warmup()
    rng = np.random.default_rng(6)
    _, rep = captured_run(eng, [Request(rid=i, tokens=rng.integers(
        1, 500, (6,)), max_new_tokens=3) for i in range(2)])
    assert rep["jit_entries"] == {"prefill_chunk": 0, "decode": 0,
                                  "write_blocks": 0}
    if warm:
        assert rep["recompiled_after_warmup"] is False
    else:
        assert "recompiled_after_warmup" not in rep
    assert rep["decode_steps"] > 0
    assert [fn.launches for fn in stepcore.kernel_wrappers()] == launches


def test_eager_context_is_scoped():
    assert stepcore._eager is False
    with stepcore.eager():
        assert stepcore._eager is True
        with stepcore.eager():
            assert stepcore._eager is True
        assert stepcore._eager is True
    assert stepcore._eager is False


# ----------------------------------------------------------------------
# on the card
# ----------------------------------------------------------------------
@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the graph is captured on the card")
    if shutil.which("nvcc") is None and not \
            os.path.exists("/usr/local/cuda/bin/nvcc"):
        pytest.skip("needs nvcc to build the kernels")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def _mixed_trace(n=8, seed=9):
    rng = np.random.default_rng(seed)
    return [Request(rid=i, tokens=rng.integers(1, 500, (int(rng.integers(
        3, L + 1)),)), max_new_tokens=GEN, arrival_time=0.2 * i)
        for i in range(n)]


def _chunk_trace(n=8, seed=9):
    """Prompts of 3-12 tokens whose last chunk ends at each of the 4
    positions of a chunk, some of them partial, starting at 0, 4 and 8."""
    rng = np.random.default_rng(seed)
    lens = (3, 4, 5, 7, 8, 10, 11, 12)[:n]
    return [Request(rid=i, tokens=rng.integers(1, 500, (n_tok,)),
                    max_new_tokens=GEN, arrival_time=0.2 * i)
            for i, n_tok in enumerate(lens)]


def _entries(paged, n):
    """The engine's ``jit_entries`` with every entry at ``n``."""
    write = "write_blocks" if paged else "write_slot"
    return {"prefill_chunk": n, "decode": n, write: n}


@pytest.mark.cuda
@pytest.mark.parametrize("paged", [False, True], ids=["slab", "paged"])
def test_one_capture_across_the_engine_lifecycle(cuda, paged):
    """Admissions, slot recycling, block growth, preemption (paged, 7
    blocks) with resumed re-prefills, and EOS: each entry is captured
    once, at warmup."""
    cfg = _reduced("qwen15-moe-a27b")
    extra = dict(num_kv_blocks=7) if paged else {}
    first = _engine(cfg, paged=paged, device="cuda", **extra)
    first.warmup()
    out, rep = captured_run(first, _mixed_trace())
    # an EOS id that some request emits mid-stream
    eos = next(t for toks in out.values() for t in toks[1:-1])
    eng = _engine(cfg, paged=paged, device="cuda", eos_id=int(eos), **extra)
    eng.warmup()
    assert eng.report()["jit_entries"] == _entries(paged, 1)
    out2, rep2 = captured_run(eng, _mixed_trace())
    assert rep2["jit_entries"] == _entries(paged, 1)
    assert rep2["recompiled_after_warmup"] is False
    assert rep2["n_requests"] == 8
    assert any(len(t) < GEN for t in out2.values())          # EOS
    if paged:
        assert rep2["preemptions"] > 0 and rep["preemptions"] > 0


def _streams(cfg, *, paged, ep_degree, eager, **ecfg):
    eng = _engine(cfg, paged=paged, ep_degree=ep_degree, device="cuda",
                  **ecfg)
    if eager:
        with stepcore.eager():
            eng.warmup()
            out, rep = captured_run(eng, _chunk_trace())
        assert rep["jit_entries"] == _entries(paged, 0)
    else:
        eng.warmup()
        out, rep = captured_run(eng, _chunk_trace())
        assert rep["jit_entries"] == _entries(paged, 1)
        assert rep["recompiled_after_warmup"] is False
    return out, rep


def _equal_runs(cfg, *, paged, ep, **ecfg):
    out_e, rep_e = _streams(cfg, paged=paged, ep_degree=ep, eager=True,
                            **ecfg)
    out_c, rep_c = _streams(cfg, paged=paged, ep_degree=ep, eager=False,
                            **ecfg)
    assert out_c == out_e
    for phase in ("decode", "prefill"):
        for key in ("moved_units", "sched_iters", "send_drops",
                    "dest_drops"):
            assert rep_c["moe"][f"{phase}/{key}"] == \
                rep_e["moe"][f"{phase}/{key}"], (phase, key)
    assert rep_c["prefill_chunks"] == rep_e["prefill_chunks"]
    return rep_c


@pytest.mark.cuda
@pytest.mark.parametrize("arch,ep", [
    ("qwen15-moe-a27b", 1), ("qwen15-moe-a27b", G),
    ("moonshot-v1-16b-a3b", 1), ("switch128", 1)])
@pytest.mark.parametrize("paged", [False, True], ids=["slab", "paged"])
def test_captured_streams_equal_eager_streams(cuda, arch, ep, paged):
    """Reduced f32 models on the card: the captured entries' greedy
    streams and MoE diagnostics equal the eager entries', token for token,
    over prompts whose last chunk ends at every chunk position (G = 4
    with q = 1, so units move and foreign groups carry rows)."""
    cfg = _reduced(arch, q_tokens=1) if ep > 1 else _reduced(arch)
    rep = _equal_runs(cfg, paged=paged, ep=ep)
    if ep > 1:
        assert rep["moe"]["decode/moved_units"] > 0


@pytest.mark.cuda
@pytest.mark.parametrize("ep,paged,extra", [
    (1, False, dict(chunks_per_step=2)),
    (1, True, dict(chunks_per_step=2)),
    (1, True, dict(num_kv_blocks=7)),
    (G, True, dict(num_kv_blocks=7)),
    (G, False, dict(chunks_per_step=2))],
    ids=["g1-slab-2chunks", "g1-paged-2chunks", "g1-paged-preempt",
         "g4-paged-preempt", "g4-slab-2chunks"])
def test_captured_prefill_streams_under_chunk_pairs_and_preemption(
        cuda, ep, paged, extra):
    """Two chunks an engine step (the prefill graph replayed back to back,
    each from its own staging copy) and preemption with resumed
    re-prefills through the same graph: captured streams equal eager."""
    cfg = (_reduced("qwen15-moe-a27b", q_tokens=1) if ep > 1
           else _reduced("qwen15-moe-a27b"))
    rep = _equal_runs(cfg, paged=paged, ep=ep, **extra)
    if "num_kv_blocks" in extra:
        assert rep["preemptions"] > 0


@pytest.mark.cuda
@pytest.mark.parametrize("arch,ep", [
    ("qwen15-moe-a27b", 1), ("qwen15-moe-a27b", G),
    ("moonshot-v1-16b-a3b", 1), ("switch128", 1)])
@pytest.mark.parametrize("paged", [False, True], ids=["slab", "paged"])
def test_card_streams_equal_cpu_streams(cuda, arch, ep, paged):
    """Reduced f32 models: the card's captured entries give the CPU's
    plain-version greedy streams."""
    cfg = _reduced(arch, q_tokens=1) if ep > 1 else _reduced(arch)
    outs = {}
    for dev in ("cpu", "cuda"):
        eng = _engine(cfg, paged=paged, ep_degree=ep, device=dev)
        eng.warmup()
        outs[dev], rep = captured_run(eng, _chunk_trace())
    assert rep["jit_entries"] == _entries(paged, 1)
    assert outs["cuda"] == outs["cpu"]


# ----------------------------------------------------------------------
# the serving-time expert placement's tables in the captured steps
# ----------------------------------------------------------------------
PLACEMENT = {"replicas": dict(replica_slots=1, rebalance_interval=2),
             "residency": dict(resident_experts=4),
             "both": dict(replica_slots=1, rebalance_interval=2,
                          resident_experts=4)}


def _placement_engine(cell, *, paged, device="cpu", skew=0.9):
    """Reduced qwen at G = 4 under harmoeny (q = 1) with the replica slots
    and / or tiered residency (W = 1 of 2) of ``cell``."""
    fields = PLACEMENT[cell]
    cfg = _reduced("qwen15-moe-a27b", q_tokens=1, router_skew=skew,
                   num_replica_slots=fields.get("replica_slots", 0))
    return _engine(cfg, paged=paged, ep_degree=G, policy="harmoeny",
                   device=device, **fields)


def _placement_guarded_steps(eng, monkeypatch, n_steps=3):
    """Serve until a swap and / or a stage has happened, then guard
    ``n_steps`` decode steps (their swaps and stages run before and
    between them, outside the step)."""
    guard = HostSyncGuard()
    plain = schedule_ops.rebalance_plain

    def exempt_plain(*args, **kwargs):
        guard.paused += 1
        try:
            return plain(*args, **kwargs)
        finally:
            guard.paused -= 1
    monkeypatch.setattr(schedule_ops, "rebalance_plain", exempt_plain)
    rng = np.random.default_rng(5)
    for i in range(6):
        eng.submit(Request(rid=i, tokens=rng.integers(
            1, 500, (int(rng.integers(3, L + 1)),)), max_new_tokens=GEN))

    def placed():
        return ((eng._rebalancer is None or eng._replica_swaps > 0)
                and (eng._residency is None or eng._residency_stages > 0))
    for _ in range(40):
        if placed() and eng.active.any():
            break
        eng.step()
    assert placed() and eng.active.any()
    step = eng.core._step

    def guarded(params, pool):
        with guard:
            return step(params, pool)
    monkeypatch.setattr(eng.core, "_step", guarded)
    for _ in range(n_steps):
        if not eng.active.any():
            break
        eng.step()
    return guard


@pytest.mark.parametrize("paged", [False, True], ids=["slab", "paged"])
@pytest.mark.parametrize("cell", list(PLACEMENT))
def test_decode_step_with_placement_tables_never_syncs_the_host(
        cell, paged, monkeypatch):
    """After a replica swap and / or a residency stage, the decode step
    reads the ``[G, R]`` and ``[G, W]`` tables from its static buffer:
    no host sync, no host copy."""
    eng = _placement_engine(cell, paged=paged)
    eng.warmup()
    guard = _placement_guarded_steps(eng, monkeypatch)
    assert guard.ops > 100
    assert guard.hits == []
    if eng._rebalancer is not None:
        assert (eng._replica_ids >= 0).any()


@pytest.mark.parametrize("cell,target", [("replicas", "replica_slot_map"),
                                         ("residency",
                                          "residency_non_local")])
def test_a_host_int_in_a_placement_table_fails_the_guard(cell, target,
                                                         monkeypatch):
    """The guard sees a table read as Python ints (``int()`` of each
    entry, then a tensor made of them), which a graph would freeze."""
    from repro_torch.core import moe_layer
    from repro_torch.core import prefetch
    owner = moe_layer if target == "replica_slot_map" else prefetch
    real = getattr(owner, target)

    def host_read(ids, *args):
        vals = [[int(v) for v in row] for row in ids.reshape(
            -1, ids.shape[-1])]
        return real(torch.tensor(vals, dtype=torch.int32).reshape(
            ids.shape), *args)
    eng = _placement_engine(cell, paged=True)
    eng.warmup()
    monkeypatch.setattr(owner, target, host_read)
    guard = _placement_guarded_steps(eng, monkeypatch)
    assert "aten._local_scalar_dense.default" in guard.hits


@pytest.mark.cuda
@pytest.mark.parametrize("paged", [False, True], ids=["slab", "paged"])
def test_swaps_and_stages_between_replays_equal_eager_steps(cuda, paged):
    """Replica swaps (one captured gather, replayed) and residency stages
    (host-to-device copies on a side stream) between the replays of the
    captured chunk and step: the streams, tables and counters equal the
    same run with every entry eager."""
    runs = {}
    for eager in (True, False):
        eng = _placement_engine("both", paged=paged, device="cuda")
        with (stepcore.eager() if eager else contextlib.nullcontext()):
            eng.warmup()
            out, rep = captured_run(eng, _chunk_trace())
        runs[eager] = out, rep
        eng.close()
    (out_e, rep_e), (out_c, rep_c) = runs[True], runs[False]
    assert out_c == out_e
    for key in ("replica_swaps", "replica_ids", "hot_experts",
                "residency_stages", "residency_ids"):
        assert rep_c["engine"][key] == rep_e["engine"][key], key
    assert rep_c["engine"]["replica_swaps"] >= 1
    assert rep_c["engine"]["residency_stages"] >= 1
    assert rep_c["residency"] == rep_e["residency"]
    assert rep_c["load_balance"] == rep_e["load_balance"]
    want = {**_entries(paged, 1), "replica_swap": 1, "residency_stage": 0}
    assert rep_c["jit_entries"] == want
    assert rep_c["recompiled_after_warmup"] is False
    assert rep_e["jit_entries"] == {k: 0 for k in want}


@pytest.mark.cuda
def test_placement_card_streams_equal_cpu_streams(cuda):
    """Learned routing (the two devices' generators draw different skew):
    the card's captured entries with swaps and stages give the CPU's
    plain-version streams and tables."""
    outs = {}
    for dev in ("cpu", "cuda"):
        eng = _placement_engine("both", paged=True, device=dev, skew=0.0)
        eng.warmup()
        out, rep = captured_run(eng, _chunk_trace())
        outs[dev] = (out, rep["engine"]["replica_ids"],
                     rep["engine"]["residency_ids"], rep["residency"])
        eng.close()
    assert outs["cuda"] == outs["cpu"]


# ----------------------------------------------------------------------
# truncated sampling inside the captured decode step
# ----------------------------------------------------------------------
SAMPLED = dict(temperature=0.8, top_k=5, top_p=0.9)


def _host_noise(eng):
    """Every decode step's noise drawn on the host from the step's key,
    so that two engines on two devices sample on the same values."""
    from repro_torch.serve.sampling import gumbel_
    core = eng.core

    def draw(idx):
        key = core.dec_key.fold_in(idx)
        if core.skew:
            key = key.fold_in(1)
        buf = torch.empty(core._noise.shape, dtype=torch.float32)
        core._noise.copy_(gumbel_(buf, key.generator("cpu")))
    core._draw_noise = draw


@pytest.mark.parametrize("paged", [False, True], ids=["slab", "paged"])
@pytest.mark.parametrize("ep", [1, G])
def test_sampled_decode_step_never_syncs_the_host(ep, paged, monkeypatch):
    """With temperature, top-k and top-p on, the decode step (sort,
    nucleus mask, Gumbel argmax over the static noise buffer) still reads
    no device value on the host, at G = 1 and under skew at G = 4."""
    cfg = (_reduced("qwen15-moe-a27b", q_tokens=1, router_skew=0.9)
           if ep > 1 else _reduced("qwen15-moe-a27b"))
    eng = _engine(cfg, paged=paged, ep_degree=ep, **SAMPLED)
    assert eng.core.sample and eng.core._noise.shape[1] == SAMPLED["top_k"]
    guard = _guarded_decode_steps(eng, monkeypatch)
    assert guard.ops > 100
    assert guard.hits == []
    assert eng.core.predraw_calls["noise"] >= 2


@pytest.mark.cuda
@pytest.mark.parametrize("paged", [False, True], ids=["slab", "paged"])
def test_sampled_card_streams_equal_cpu_streams(cuda, paged):
    """Reduced f32 qwen, sampled: the card's captured decode step and host
    first tokens give the CPU's streams on the same noise, with each
    entry captured once."""
    cfg = _reduced("qwen15-moe-a27b")
    outs = {}
    for dev in ("cpu", "cuda"):
        eng = _engine(cfg, paged=paged, device=dev, **SAMPLED)
        _host_noise(eng)
        eng.warmup()
        outs[dev], rep = captured_run(eng, _chunk_trace())
    assert rep["jit_entries"] == _entries(paged, 1)
    assert rep["recompiled_after_warmup"] is False
    assert outs["cuda"] == outs["cpu"]
    greedy = _engine(cfg, paged=paged, device="cpu")
    assert captured_run(greedy, _chunk_trace())[0] != outs["cpu"]
