"""The serve engine's prefill chunk and the KV store's writes as CUDA
graphs, checked on the CPU.

A captured entry replays whatever it recorded, so a host value that the
step read (``int()`` of a device tensor) or was passed (a Python int
position) would freeze into the graph.  Here:

* the ``TorchDispatchMode`` guard of ``test_torch_capture.py`` runs the
  engine's prefill chunk (``StepCore._prefill_step``) and the store's
  write (``KVOwner._write``) over the decode guard's configurations, on
  the slab and paged, at one chunk an engine step and at two: no host
  sync and no host copy;
* position independence: one ``StepCore`` runs its chunk from its
  buffers at several (start, last, chunk) triples, a partial last chunk
  and a restart at 0 among them.  The ops it dispatches, with every
  non-tensor argument, are the same at every triple (what a graph would
  replay), and its logits, scratch K/V, first token and diagnostics are
  bit-equal to ``model.prefill_chunk`` called with host ints;
* the placement tables (replica ``[G, R]``, residency ``[G, W]``) are
  values: the chunk and the decode step dispatch the same ops with the
  same host arguments under every table, and agree with the model's
  entries called with the tables as fresh tensors;
* the prefill chunk's skew pre-draws equal ``route_skewed``'s draws;
* ``report()["jit_entries"]`` has the JAX engine's keys on both pools.
"""
import dataclasses

import jax
import numpy as np
import pytest
import torch
from torch.utils._pytree import tree_flatten, tree_map
from torch.utils._python_dispatch import TorchDispatchMode

from repro.configs.base import ParallelConfig as JPC
from repro.configs.qwen15_moe_a27b import CONFIG as JAX_QWEN
from repro.launch.mesh import make_host_mesh
from repro.models.model import MeshShape
from repro.models.model import build_model as jax_build
from repro.serve import Request as JRequest
from repro.serve import ServeEngine as JEngine
from repro.serve import VirtualClock as JClock
from repro.serve import engine_config_for as jax_ecfg
from repro_torch.configs.base import round_up
from repro_torch.core.router import route_skewed
from repro_torch.kernels.schedule import ops as schedule_ops
from repro_torch.serve import Request
from repro_torch.serve.paging import kv_leaves

from _ep_helpers import one_torch_thread  # noqa: F401 (autouse)
from _serve_helpers import captured_run
from test_torch_capture import (GUARD_CASES, G, HostSyncGuard, _engine,
                                _placement_engine, _reduced,
                                _static_opt_cfg)

C = 4


def _guard_cfg(arch, ep, policy):
    """The decode guard's configuration, with the prefill chunk (which
    schedules under the config's policy, as in JAX) on ``policy`` too."""
    if policy == "static_opt":
        cfg = _static_opt_cfg()
        return dataclasses.replace(cfg, moe=dataclasses.replace(
            cfg.moe, policy=policy))
    if ep > 1:
        return _reduced(arch, q_tokens=1, router_skew=0.9, policy=policy)
    return _reduced(arch)


@pytest.mark.parametrize("cps", [1, 2], ids=["1chunk", "2chunks"])
@pytest.mark.parametrize("paged", [False, True], ids=["slab", "paged"])
@pytest.mark.parametrize("arch,ep,policy", GUARD_CASES)
def test_prefill_chunk_never_syncs_the_host(arch, ep, policy, paged, cps,
                                            monkeypatch):
    """One chunk an engine step, or two back to back (``chunks_per_step``
    2: both chunks and the write in one step)."""
    cfg = _guard_cfg(arch, ep, policy)
    eng = _engine(cfg, paged=paged, ep_degree=ep, policy=policy,
                  chunks_per_step=cps)
    guard = HostSyncGuard()
    plain = schedule_ops.rebalance_plain

    def exempt_plain(*args, **kwargs):
        guard.paused += 1
        guard.exempt += 1
        try:
            return plain(*args, **kwargs)
        finally:
            guard.paused -= 1
    monkeypatch.setattr(schedule_ops, "rebalance_plain", exempt_plain)
    calls = {"prefill": 0, "write": 0}

    def guarded(owner, name, key):
        fn = getattr(owner, name)

        def run(*args):
            calls[key] += 1
            with guard:
                return fn(*args)
        monkeypatch.setattr(owner, name, run)
    eng.warmup()            # the eager first call a capture follows
    guarded(eng.core, "_prefill_step", "prefill")
    guarded(eng.kv, "_write", "write")
    # 6 tokens: a whole chunk, then a partial one that completes the
    # prefill (a write on either pool)
    eng.submit(Request(rid=0, tokens=np.arange(1, 7), max_new_tokens=4))
    steps = 0
    while not eng.active.any():
        eng.step()
        steps += 1
    assert steps == 2 // cps
    assert calls == {"prefill": 2, "write": 2 if paged else 1}
    assert guard.ops > 100                   # the chunks ran under the guard
    assert guard.hits == []
    assert (guard.exempt > 0) == (cfg.moe.policy == "harmoeny")


# ----------------------------------------------------------------------
# position independence
# ----------------------------------------------------------------------
class OpRecorder(TorchDispatchMode):
    """Every dispatched op with its non-tensor arguments (tensors by shape
    and dtype): what a graph captured from this call would replay."""

    def __init__(self):
        super().__init__()
        self.trace = []

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        leaves, _ = tree_flatten((args, kwargs))
        self.trace.append((str(func), tuple(
            (tuple(x.shape), x.dtype) if isinstance(x, torch.Tensor)
            else repr(x) for x in leaves)))
        return func(*args, **kwargs)


# (start, last, chunk index): successive chunks of one prompt, a partial
# last chunk, then a restart at 0 (a request's first chunk, or a resumed
# re-prefill) with a later chunk index
TRIPLES = [(0, C - 1, 0), (C, C - 1, 1), (2 * C, 1, 2), (0, 2, 5),
           (C, 0, 9)]


@pytest.mark.parametrize("arch,ep", [("qwen15-moe-a27b", 1),
                                     ("qwen15-moe-a27b", G),
                                     ("moonshot-v1-16b-a3b", 1),
                                     ("switch128", 1)])
def test_prefill_step_is_position_independent(arch, ep, monkeypatch):
    cfg = (_reduced(arch, q_tokens=1, router_skew=0.9) if ep > 1
           else _reduced(arch))
    eng = _engine(cfg, paged=False, ep_degree=ep)
    eng.warmup()            # the eager first call a capture follows
    core, model, params = eng.core, eng.model, eng.params
    seen = {}
    step = core._prefill_step
    orig_chunk = model.prefill_chunk

    def recording_step(*args):
        rec = OpRecorder()
        with rec:
            out = step(*args)
        seen["trace"] = rec.trace
        return out

    def keep_logits(*args, **kwargs):
        out = orig_chunk(*args, **kwargs)
        seen["logits"] = out[0]
        return out
    monkeypatch.setattr(core, "_prefill_step", recording_step)
    monkeypatch.setattr(model, "prefill_chunk", keep_logits)
    ref = model.init_cache(1, eng.ecfg.max_seq_len)
    for a, b in zip(kv_leaves(eng.kv.scratch), kv_leaves(ref)):
        b.copy_(a)
    rng = np.random.default_rng(11)
    traces = []
    for start, last, idx in TRIPLES:
        toks = rng.integers(1, 500, (1, C)).astype(np.int32)
        core.prefill(params, toks, eng.kv.scratch, start, last, idx)
        first, packed = core.prefill_result()
        traces.append(seen["trace"])
        want, _, pos, diags = orig_chunk(
            params, torch.from_numpy(toks), ref, start, last,
            skew_key=core.next_key(core.pf_key, idx))
        assert pos == start + C
        assert torch.equal(seen["logits"], want)
        assert first == int(torch.argmax(want[0]))
        got = core.unpack(packed)
        assert got.keys() == diags.keys()
        for key, v in diags.items():
            np.testing.assert_array_equal(got[key], v.float().numpy(),
                                          err_msg=key)
        for a, b in zip(kv_leaves(eng.kv.scratch), kv_leaves(ref)):
            assert torch.equal(a, b)
    for t in traces[1:]:
        diff = [(a, b) for a, b in zip(traces[0], t) if a != b]
        assert len(t) == len(traces[0]) and not diff, \
            f"the chunk's ops or their host arguments depend on its " \
            f"position: {diff[:2]}"
    assert len(traces[0]) > 100


def test_prefill_skew_predraws_equal_route_skewed_draws():
    """The captured chunk's pre-drawn assignments are the draws the eager
    block makes on ``pf_key / chunk / layer / rank``, over the chunk's
    per-rank slice, and the chunk routes the same on either."""
    cfg = _reduced("qwen15-moe-a27b", q_tokens=1, router_skew=0.9)
    chunk = 8                            # two tokens a rank
    eng = _engine(cfg, paged=False, ep_degree=G, prefill_chunk=chunk)
    core, moe = eng.core, cfg.moe
    idx = 5
    core._predraw(idx, "prefill_chunk")
    t_slice = round_up(max(chunk, G), G) // G
    ep = eng.model.moe_spec.topo.padded_experts
    assert core._pf_skew.shape == (cfg.num_layers, G, t_slice,
                                   moe.num_experts_per_tok)
    for m, layer in enumerate(core._moe_keys):
        for g in range(G):
            gen = core.pf_key.fold_in(idx).fold_in(layer).fold_in(
                g).generator("cpu")
            want = route_skewed(gen, t_slice, top_k=moe.num_experts_per_tok,
                                num_experts=moe.num_experts,
                                padded_experts=ep, alpha=moe.router_skew,
                                n_hot=moe.router_skew_experts).assign
            assert torch.equal(core._pf_skew[m, g], want)
    model, params = eng.model, eng.params
    toks = torch.from_numpy(np.random.default_rng(0).integers(
        1, 500, (1, chunk)).astype(np.int32))
    outs = []
    for kw in (dict(skew_key=core.next_key(core.pf_key, idx)),
               dict(skew_assign=core._pf_skew)):
        cache = model.init_cache(1, eng.ecfg.max_seq_len)
        logits, _, _, diags = model.prefill_chunk(params, toks, cache,
                                                  chunk, 5, **kw)
        outs.append((logits, diags))
    assert torch.equal(outs[0][0], outs[1][0])
    assert outs[0][1].keys() == outs[1][1].keys()
    for key in outs[0][1]:
        assert torch.equal(outs[0][1][key], outs[1][1][key]), key


# ----------------------------------------------------------------------
# the serving-time placement tables: values, not part of the graph
# ----------------------------------------------------------------------
# (replica table [G, R], residency table [G, W]) pairs of a reduced qwen
# at G = 4 (8 experts, rank g holds g and g + 4)
TABLES = [([[-1], [0], [0], [0]], [[0], [1], [2], [3]]),
          ([[4], [-1], [4], [6]], [[4], [5], [2], [7]]),
          ([[-1], [-1], [-1], [-1]], [[0], [5], [6], [3]])]


@pytest.mark.parametrize("entry", ["prefill_chunk", "decode"])
def test_steps_read_the_placement_tables_as_values(entry, monkeypatch):
    """One ``StepCore`` runs its entry from its buffers with several
    replica (and, at decode, residency) tables: the same ops with the same
    host arguments at every table (what a graph would replay, so a swap
    or a stage needs no new capture), and the same first token and
    diagnostics as the model's entry called with the tables as fresh
    tensors."""
    eng = _placement_engine("both", paged=True)
    eng.warmup()
    core, model, params = eng.core, eng.model, eng.params
    name = "_prefill_step" if entry == "prefill_chunk" else "_step"
    step = getattr(core, name)
    seen = {}

    def recording_step(*args):
        rec = OpRecorder()
        with rec:
            out = step(*args)
        seen["trace"] = rec.trace
        return out
    monkeypatch.setattr(core, name, recording_step)
    rng = np.random.default_rng(12)
    B = eng.ecfg.max_slots
    pos = np.array([5, 9, 2], np.int32)
    active = np.array([True, True, False])
    table = eng.kv.decode_table()
    traces = []
    for i, (rep, res) in enumerate(TABLES):
        rep_t, res_t = (torch.tensor(t, dtype=torch.int32)
                        for t in (rep, res))
        if entry == "prefill_chunk":
            toks = rng.integers(1, 500, (1, C)).astype(np.int32)
            cache = tree_map(torch.clone, eng.kv.scratch)
            core.prefill(params, toks, eng.kv.scratch, C, C - 2, i,
                         np.array(rep))
            first, packed = core.prefill_result()
            got = core.unpack(packed, entry)
            logits, _, _, want = model.prefill_chunk(
                params, torch.from_numpy(toks), cache, C, C - 2,
                skew_assign=core._pf_skew, moe_replica_ids=rep_t)
        else:
            tok = rng.integers(1, 500, (B,)).astype(np.int32)
            nxt, packed = core.decode(params, tok, eng.kv.pool, pos, table,
                                      active, i, np.array(rep),
                                      np.array(res))
            first = int(nxt[0])
            got = core.unpack(packed, entry)
            logits, _, _, want = model.decode_step(
                params, torch.from_numpy(tok)[:, None], eng.kv.pool,
                torch.from_numpy(pos), active_mask=torch.from_numpy(active),
                block_table=torch.from_numpy(table),
                block_size=eng.ecfg.kv_block_size, skew_assign=core._skew,
                moe_replica_ids=rep_t, moe_residency_ids=res_t,
                moe_layer_diags=True)
        traces.append(seen["trace"])
        assert first == int(torch.argmax(logits[0]))
        assert got.keys() == want.keys()
        for key, v in want.items():
            np.testing.assert_array_equal(got[key], v.float().numpy(),
                                          err_msg=key)
    assert ("expert_load_layers" in got) == (entry == "decode")
    for t in traces[1:]:
        diff = [(a, b) for a, b in zip(traces[0], t) if a != b]
        assert len(t) == len(traces[0]) and not diff, \
            f"the step's ops or their host arguments depend on the " \
            f"placement tables: {diff[:2]}"


# ----------------------------------------------------------------------
# the report's entries against the JAX engine's
# ----------------------------------------------------------------------
@pytest.fixture(scope="module")
def jax_qwen():
    jc = JAX_QWEN.reduced()
    mesh = make_host_mesh(1, 1)
    ms = MeshShape(tuple(zip(mesh.axis_names, mesh.devices.shape)))
    jm = jax_build(jc, JPC(attn_chunk=8, loss_chunk=8), batch=3, seq_len=12,
                   mesh_shape=ms, mesh=mesh)
    with mesh:
        jp = jm.init(jax.random.PRNGKey(0))
    return mesh, jm, jp


@pytest.mark.parametrize("paged", [False, True], ids=["slab", "paged"])
def test_jit_entries_have_the_jax_engines_keys(jax_qwen, paged):
    mesh, jm, jp = jax_qwen
    kw = dict(max_slots=3, prompt_len=12, max_new_tokens=3, prefill_chunk=C,
              kv_block_size=4, paged=paged)
    je = JEngine(jm, jp, jax_ecfg(jm.cfg, **kw), mesh=mesh,
                 clock=JClock(0.1))
    rng = np.random.default_rng(2)
    prompts = [rng.integers(1, 500, (n,)).astype(np.int32) for n in (6, 9)]
    with mesh:
        je.warmup()
        _, rep_j = captured_run(je, [JRequest(rid=i, tokens=p,
                                              max_new_tokens=3)
                                     for i, p in enumerate(prompts)])
    eng = _engine(_reduced("qwen15-moe-a27b"), paged=paged)
    eng.warmup()
    _, rep_t = captured_run(eng, [Request(rid=i, tokens=p, max_new_tokens=3)
                                  for i, p in enumerate(prompts)])
    write = "write_blocks" if paged else "write_slot"
    assert set(rep_j["jit_entries"]) == {"prefill_chunk", "decode", write}
    assert rep_t["jit_entries"].keys() == rep_j["jit_entries"].keys()
    assert set(rep_t["jit_entries"].values()) == {0}      # eager on the CPU
    assert rep_t["recompiled_after_warmup"] is False
    assert rep_j["recompiled_after_warmup"] is False
