"""The SSM, hybrid and tensor-parallel MoE entries as CUDA graphs, checked
on the CPU, and on the card where one is present (``cuda``-marked).

A captured entry replays what it recorded, so the mamba layers' valid
length, the hybrid's attention positions and the tensor-parallel block's
grouped buffer must stay on the device.  Here, on the CPU:

* the ``TorchDispatchMode`` guard of ``test_torch_capture.py`` runs the
  decode step, the prefill chunk and the slot write of reduced
  mamba2-2.7b and zamba2-7b, and of a reduced qwen15-moe-a27b with 2
  experts at G = 4 (tensor-parallel, under the synthetic skew, whose
  draws ride in the step's buffer): no host sync and no host copy;
* position independence: one ``StepCore`` runs its decode step from its
  buffers at several position vectors and active masks, and its prefill
  chunk at several (start, last) pairs; the ops it dispatches, with every
  non-tensor argument, are the same each time, and its logits and state
  are bit-equal to the model's entries called with fresh tensors and
  host ints.

On the card: ``moe_gmm`` at one tensor-parallel rank's slice of
mixtral-8x7b (d 4096, f 896 of 14,336, 8 experts) against its plain
version, and a captured SSM decode step replayed at several positions
against the eager step."""
import dataclasses

import numpy as np
import pytest
import torch
from torch.utils._pytree import tree_flatten
from torch.utils._python_dispatch import TorchDispatchMode

from repro_torch.serve import Request
from repro_torch.serve.paging import kv_leaves

from _ep_helpers import one_torch_thread  # noqa: F401 (autouse)
from test_torch_capture import (C, G, L, SLOTS, HostSyncGuard,
                                _guarded_decode_steps, _engine, _reduced,
                                cuda)  # noqa: F401 (fixture)

ARCHS = ["mamba2-2.7b", "zamba2-7b"]


def _tp_cfg():
    return _reduced("qwen15-moe-a27b", num_experts=2, router_skew=0.9)


def _cfg_and_ep(case):
    return (_tp_cfg(), G) if case == "tp" else (_reduced(case), 1)


@pytest.mark.parametrize("case", ARCHS + ["tp"])
def test_decode_step_never_syncs_the_host(case, monkeypatch):
    cfg, ep = _cfg_and_ep(case)
    eng = _engine(cfg, paged=False, ep_degree=ep)
    if case == "tp":
        assert eng.model.moe_spec.tp_mode and eng.core.skew
        assert eng.core._skew.shape[1:3] == (1, SLOTS)   # all tokens, 1 row
    guard = _guarded_decode_steps(eng, monkeypatch)
    assert guard.ops > 100
    assert guard.hits == []
    assert guard.exempt == 0                     # no schedule in the path


@pytest.mark.parametrize("case", ARCHS + ["tp"])
def test_prefill_chunk_and_write_never_sync_the_host(case, monkeypatch):
    cfg, ep = _cfg_and_ep(case)
    eng = _engine(cfg, paged=False, ep_degree=ep)
    guard = HostSyncGuard()
    calls = {"prefill": 0, "write": 0}

    def guarded(owner, name, key):
        fn = getattr(owner, name)

        def run(*args):
            calls[key] += 1
            with guard:
                return fn(*args)
        monkeypatch.setattr(owner, name, run)
    eng.warmup()
    guarded(eng.core, "_prefill_step", "prefill")
    guarded(eng.kv, "_write", "write")
    eng.submit(Request(rid=0, tokens=np.arange(1, 7), max_new_tokens=4))
    while not eng.active.any():
        eng.step()
    assert calls == {"prefill": 2, "write": 1}
    assert guard.ops > 100 and guard.hits == []


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


def _clone(tree):
    if isinstance(tree, dict):
        return {k: _clone(v) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_clone(v) for v in tree]
    if isinstance(tree, tuple):
        return type(tree)(*(t.clone() for t in tree))
    return tree.clone()


def _recorded(monkeypatch, owner, name, seen):
    fn = getattr(owner, name)

    def run(*args):
        rec = OpRecorder()
        with rec:
            out = fn(*args)
        seen.append(rec.trace)
        return out
    monkeypatch.setattr(owner, name, run)


def _assert_same_traces(traces):
    for t in traces[1:]:
        diff = [(a, b) for a, b in zip(traces[0], t) if a != b]
        assert len(t) == len(traces[0]) and not diff, \
            f"the step's ops or their host arguments depend on its " \
            f"position: {diff[:2]}"
    assert len(traces[0]) > 50


# per-slot positions and active masks: fresh slots, mid-sequence, a slot
# vacated, positions far apart
DECODE_CASES = [([5, 9, 12], [1, 1, 1]), ([6, 3, 13], [1, 0, 1]),
                ([14, 4, 7], [0, 1, 1]), ([2, 15, 8], [1, 1, 0])]


@pytest.mark.parametrize("arch", ARCHS)
def test_decode_step_is_position_independent(arch, monkeypatch):
    eng = _engine(_reduced(arch), paged=False)
    eng.warmup()
    core, model, params = eng.core, eng.model, eng.params
    rng = np.random.default_rng(7)
    for leaf in kv_leaves(eng.kv.pool):       # a live-looking pool
        leaf.copy_(torch.from_numpy(rng.standard_normal(
            tuple(leaf.shape)).astype(np.float32) * 0.3))
    ref = _clone(eng.kv.pool)
    traces = []
    _recorded(monkeypatch, core, "_step", traces)
    for idx, (pos, act) in enumerate(DECODE_CASES):
        tok = rng.integers(1, 500, (SLOTS,)).astype(np.int32)
        pos, act = np.asarray(pos, np.int32), np.asarray(act, bool)
        nxt, _ = core.decode(params, tok, eng.kv.pool, pos, None, act, idx)
        want, *_ = model.decode_step(
            params, torch.from_numpy(tok)[:, None], ref,
            torch.from_numpy(pos), active_mask=torch.from_numpy(act))
        assert torch.equal(core.logits, want)
        np.testing.assert_array_equal(nxt, want.argmax(-1).numpy())
        for a, b in zip(kv_leaves(eng.kv.pool), kv_leaves(ref)):
            assert torch.equal(a, b)
    _assert_same_traces(traces)


# (start, last, chunk index): a prompt's chunks, a partial last chunk,
# then a restart at 0 (a new request after begin_prefill's reset)
TRIPLES = [(0, C - 1, 0), (C, C - 1, 1), (2 * C, 1, 2), (0, 2, 5)]


@pytest.mark.parametrize("arch", ARCHS)
def test_prefill_step_is_position_independent(arch, monkeypatch):
    eng = _engine(_reduced(arch), paged=False)
    eng.warmup()
    core, model, params = eng.core, eng.model, eng.params
    traces = []
    _recorded(monkeypatch, core, "_prefill_step", traces)
    eng.kv.begin_prefill()
    ref = _clone(eng.kv.scratch)
    rng = np.random.default_rng(11)
    for start, last, idx in TRIPLES:
        if start == 0:
            eng.kv.begin_prefill()
            for leaf in kv_leaves(ref):
                leaf.zero_()
        toks = rng.integers(1, 500, (1, C)).astype(np.int32)
        core.prefill(params, toks, eng.kv.scratch, start, last, idx)
        first, _ = core.prefill_result()
        want, _, pos, _ = model.prefill_chunk(
            params, torch.from_numpy(toks), ref, start, last)
        assert pos == start + C
        assert first == int(torch.argmax(want[0]))
        for a, b in zip(kv_leaves(eng.kv.scratch), kv_leaves(ref)):
            assert torch.equal(a, b)
    _assert_same_traces(traces)


# ----------------------------------------------------------------------
# on the card
# ----------------------------------------------------------------------
@pytest.mark.cuda
@pytest.mark.parametrize("tokens", [4, 256], ids=["decode", "chunk"])
def test_moe_gmm_kernel_matches_plain_at_a_tp_slice(cuda, tokens):
    """One tensor-parallel rank of 16 on mixtral-8x7b: every expert's
    d_ff slice of 896, the block-aligned buffer of all the units (top-2 of
    8, a seeded draw), bf16."""
    from repro_torch.core.moe_layer import tp_layout
    from repro_torch.kernels.moe_gmm import ops
    g = torch.Generator(device=cuda).manual_seed(3)
    d, f, E, k, bm = 4096, 896, 8, 2, 128
    assign = torch.randint(0, E, (tokens, k), generator=g, device=cuda)
    sizes, padded, row, m_pad = tp_layout(assign, E, bm)
    x = torch.zeros((m_pad, d), dtype=torch.bfloat16, device=cuda)
    x[row] = (torch.randn((tokens * k, d), generator=g, device=cuda)
              * 0.5).to(torch.bfloat16)

    def w(n, a, b):
        return (torch.randn((n, a, b), generator=g, device=cuda)
                * (2.0 / a) ** 0.5).to(torch.bfloat16)
    w_in, w_gate, w_out = w(E, d, f), w(E, d, f), w(E, f, d)
    n0 = ops.moe_gmm.launches
    got = ops.fused_expert_ffn(x, w_in, w_out, padded, w_gate=w_gate,
                               act="silu", block_m=bm)
    tg = ops.tile_group_map(padded.to(torch.int32), m_pad // bm, bm)
    ref = ops.moe_gmm_plain(x, w_in, w_out, tg, w_gate=w_gate, act="silu",
                            block_m=bm)
    torch.cuda.synchronize()
    assert ops.moe_gmm.launches == n0 + 1
    np.testing.assert_allclose(got.float().cpu().numpy(),
                               ref.float().cpu().numpy(), atol=2e-2,
                               rtol=2e-2)


@pytest.mark.cuda
@pytest.mark.parametrize("arch", ARCHS)
def test_captured_ssm_decode_step_is_position_independent(cuda, arch):
    """The decode step captured once at warmup, replayed at several
    position vectors and active masks on a live-looking pool: each
    replay's logits and state equal the eager step's on a copy of the
    pool (f32, the same kernels: none on this path)."""
    eng = _engine(_reduced(arch), paged=False, device="cuda")
    eng.warmup()
    assert eng.report()["jit_entries"] == {"prefill_chunk": 1, "decode": 1,
                                           "write_slot": 1}
    core, model, params = eng.core, eng.model, eng.params
    g = torch.Generator(device=cuda).manual_seed(7)
    for leaf in kv_leaves(eng.kv.pool):
        leaf.copy_(torch.randn(leaf.shape, generator=g, device=cuda) * 0.3)
    ref = _clone(eng.kv.pool)
    rng = np.random.default_rng(7)
    for idx, (pos, act) in enumerate(DECODE_CASES):
        tok = rng.integers(1, 500, (SLOTS,)).astype(np.int32)
        pos, act = np.asarray(pos, np.int32), np.asarray(act, bool)
        nxt, _ = core.decode(params, tok, eng.kv.pool, pos, None, act, idx)
        want, *_ = model.decode_step(
            params, torch.from_numpy(tok)[:, None].to(cuda), ref,
            torch.from_numpy(pos).to(cuda),
            active_mask=torch.from_numpy(act).to(cuda))
        torch.testing.assert_close(core.logits, want, atol=2e-5, rtol=2e-5)
        np.testing.assert_array_equal(nxt, want.argmax(-1).cpu().numpy())
        for a, b in zip(kv_leaves(eng.kv.pool), kv_leaves(ref)):
            torch.testing.assert_close(a, b, atol=2e-5, rtol=2e-5)
    assert core.decode_entry.captures == 1
