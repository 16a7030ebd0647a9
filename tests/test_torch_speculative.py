"""The port's speculative decoding against the JAX package's.

* Units (``serve/speculative.py``): the n-gram proposer, ``greedy_verify``
  and ``rejection_verify`` give JAX's outputs on the same numpy inputs
  (the rejection sampler on the same generator seed), and the JAX test's
  cases hold on the port's: longest match first, then the most recent
  occurrence; no match and truncation; an unknown policy; exact-match
  acceptance; the committed token's distribution equals the truncated
  base sampler's.
* Engine cases of ``tests/test_serve_speculative.py`` on reduced
  qwen15-moe-a27b, each written once and driven through the JAX engine
  (one subprocess per group of cases, ``test_torch_prefix.jax_cases``)
  and the port's on the same weights: greedy streams equal across
  k in {0, 2, 4} with acceptance > 0 on motif prompts, EOS inside the
  window, speculation with prefix sharing and preemption, the sampled
  engine (the port draws on the JAX engine's host generator in its
  order, so its streams and ``speculative`` section equal JAX's), and at
  G = 4 under skew 0.9 with the port routing on JAX's draws for every
  chunk and verify window.
* The captured verify step never syncs the host, and is position
  independent: one step core's verify at several (window, positions,
  table, active) sets dispatches the same ops with the same host
  arguments, and its logits and diagnostics equal ``model.decode_step``
  called with fresh tensors."""
import numpy as np
import pytest
import torch

from repro.serve import speculative as JS
from repro.serve import sampling as JSamp
from repro_torch.serve import speculative as TS
from repro_torch.serve import sampling as TSamp
from repro_torch.serve import EngineConfig

from _ep_helpers import one_torch_thread  # noqa: F401 (autouse)
from test_torch_capture import HostSyncGuard
from test_torch_prefill_capture import OpRecorder
from test_torch_prefix import (PortAPI, compare, jax_cases,  # noqa: F401
                               streams, summary)

SPEC_SRC = '''
def motif_requests(api, n, *, gen=16, seed=0, eos_id=None,
                   lens=(12, 9, 11, 7)):
    """Prompts tiled from a 3-token motif: the regime prompt-lookup
    drafting accepts on."""
    rng = np.random.default_rng(seed)
    reqs = []
    for i in range(n):
        motif = rng.integers(0, api.vocab, (3,)).astype(np.int32)
        L = lens[i % len(lens)]
        toks = np.tile(motif, -(-L // 3))[:L]
        reqs.append(api.Request(rid=i, tokens=toks, max_new_tokens=gen,
                                eos_id=eos_id))
    return reqs


def spec_engine(api, k, *, slots=3, prompt_len=12, gen=16, **kw):
    return api.engine(slots=slots, prompt_len=prompt_len, max_new=gen,
                      chunk=4, speculative_k=k, clock=0.05, **kw)


def case_greedy_across_k(api):
    res = {}
    for k in (0, 2, 4):
        out, rep = api.run(spec_engine(api, k), motif_requests(api, 4, seed=2))
        res[str(k)] = dict(out=streams(out), rep=summary(rep))
    return res


def case_eos_mid_window(api):
    base, _ = api.run(spec_engine(api, 0),
                      motif_requests(api, 4, seed=3))
    eos = int([t for toks in base.values() for t in toks[1:-1]][0])
    res = {"eos": eos}
    for k in ((0, 3) if api.refs else (3,)):
        out, rep = api.run(spec_engine(api, k, eos_id=eos),
                           motif_requests(api, 4, seed=3, eos_id=eos))
        res[("ref_" if k == 0 else "") + str(k)] = dict(
            out=streams(out), rep=summary(rep))
    return res


def case_spec_sharing_preemption(api):
    res = {}
    for k in ((0, 3) if api.refs else (3,)):
        rng = np.random.default_rng(11)
        shared = rng.integers(0, api.vocab, (8,)).astype(np.int32)
        reqs = []
        for i in range(6):
            tail = rng.integers(0, api.vocab, (4,)).astype(np.int32)
            reqs.append(api.Request(rid=i, tokens=np.concatenate(
                [shared, tail]), max_new_tokens=10))
        eng = spec_engine(api, k, gen=10, num_kv_blocks=14,
                          prefix_sharing=True)
        out, rep = api.run(eng, reqs)
        res[("ref_" if k == 0 else "") + str(k)] = dict(
            out=streams(out), rep=summary(rep),
            in_use=eng._alloc.blocks_in_use)
    return res


def case_sampled(api):
    out, rep = api.run(spec_engine(api, 3, temperature=0.8, top_k=12),
                       motif_requests(api, 4, seed=2))
    return dict(out=streams(out), rep=summary(rep))


def case_g4_skew(api):
    out, rep = api.run(spec_engine(api, 4, gen=8, moe_policy="harmoeny"),
                       motif_requests(api, 3, gen=8, seed=2))
    return dict(out=streams(out), rep=summary(rep), moe=rep["moe"],
                lb=rep["load_balance"]["decode"])
'''

# the JAX engine at G > 1 records the skewed assignments of every call, by
# call index, one dict an engine (``API.engine`` calls it)
RECORD_SRC = '''
def record_draws(eng, api):
    from repro.core.router import route_skewed
    moe, G = api.cfg.moe, api.G

    def one(key, t_slice):
        layers = []
        for _ in range(api.cfg.num_layers):
            sub = jax.random.fold_in(key, 0)
            layers.append(jax.numpy.stack([route_skewed(
                jax.random.fold_in(sub, g), t_slice,
                top_k=moe.num_experts_per_tok, num_experts=moe.num_experts,
                padded_experts=eng.model.moe_spec.topo.padded_experts,
                alpha=moe.router_skew, n_hot=moe.router_skew_experts
            ).assign for g in range(G)]))
            key = jax.random.fold_in(key, 997)
        return jax.numpy.stack(layers)
    one = jax.jit(one, static_argnums=1)
    rec = {"prefill_chunk": {}, "decode": {}}
    api.draws.append(rec)
    next_key = eng._next_key

    def on_next_key(stream, idx):
        key = next_key(stream, idx)
        pf = np.array_equal(np.asarray(stream), np.asarray(eng._pf_key))
        tokens = (eng.ecfg.prefill_chunk if pf else eng.ecfg.max_slots
                  * (eng.ecfg.speculative_k + 1))
        rec["prefill_chunk" if pf else "decode"][str(idx)] = np.asarray(
            one(key, -(-max(tokens, G) // G))).tolist()
        return key
    eng._next_key = on_next_key
'''

ENGINE_CASES = {"greedy_across_k": 1, "eos_mid_window": 1,
                "spec_sharing_preemption": 1, "sampled": 1, "g4_skew": 4}


@pytest.fixture(scope="module")
def jax_spec(tmp_path_factory):
    return jax_cases(tmp_path_factory, ENGINE_CASES,
                     groups=[["greedy_across_k"], ["g4_skew", "sampled"],
                             ["eos_mid_window", "spec_sharing_preemption"]],
                     extra_src=SPEC_SRC + RECORD_SRC, devices=4)


exec(SPEC_SRC)


def _case(name, jax_spec, G=1):
    results, params = jax_spec
    want = results[name]
    draws = want.pop("draws", None)
    api = PortAPI(params[G], G=G, draws=draws)
    return compare(globals()["case_" + name](api), want), api


def test_greedy_streams_identical_across_speculative_k(jax_spec):
    res, api = _case("greedy_across_k", jax_spec)
    assert res["0"]["out"] == res["2"]["out"] == res["4"]["out"]
    for k in ("2", "4"):
        sp = res[k]["rep"]["speculative"]
        assert res[k]["rep"]["spec_k"] == int(k)
        assert sp["committed_tokens"] > 0
        assert sp["accepted"] > 0
        assert sp["steps_per_committed_token"] < 1.0
        assert sp["tokens_per_step"] > 1.0
        assert res[k]["rep"]["phases"]["verify"][0] > 0
    assert res["0"]["rep"]["speculative"] is None
    assert all(e.report()["jit_entries"].keys()
               == {"prefill_chunk", "decode", "write_blocks"}
               for e in api.engines)


def test_eos_mid_window_streams_exact(jax_spec):
    res, _ = _case("eos_mid_window", jax_spec)
    eos = res["eos"]
    for k in ("ref_0", "3"):
        for toks in res[k]["out"].values():
            assert eos not in toks[:-1]
    assert res["ref_0"]["out"] == res["3"]["out"]
    assert any(toks[-1] == eos for toks in res["3"]["out"].values())


def test_speculative_with_prefix_sharing_and_preemption(jax_spec):
    res, _ = _case("spec_sharing_preemption", jax_spec)
    assert res["ref_0"]["out"] == res["3"]["out"]
    assert res["3"]["rep"]["preemptions"] > 0 \
        or res["ref_0"]["rep"]["preemptions"] > 0
    assert res["3"]["rep"]["prefix_hit_rate"] > 0
    assert res["3"]["in_use"] == 0


def test_sampled_speculative_engine_equals_jax(jax_spec):
    """Streams and the ``speculative`` section equal JAX's exactly: both
    engines draw first tokens and verify windows on
    ``default_rng(skew_seed + 101)`` in the same order, drafts rejected
    (resampled from the residual) among them."""
    res, api = _case("sampled", jax_spec)
    sp = res["rep"]["speculative"]
    assert sp["steps"] > 0 and sp["committed_tokens"] >= sp["steps"]
    assert sp["drafted"] > 0
    assert all(0 <= t < api.cfg.vocab_size
               for toks in res["out"].values() for t in toks)


def test_speculative_at_g4_under_skew_routes_on_jax_draws(jax_spec):
    """k = 4 on four virtual ranks under skew 0.9 (harmoeny, q = 1), the
    port routing every chunk and verify window on the JAX engine's draws:
    equal streams, diagnostics and speculative section.  (The synthetic
    skew router draws a fresh assignment a call, so a k = 4 run routes
    differently from a k = 0 run by construction, in JAX as here; the
    greedy streams across k at G = 4 are held without skew below.)"""
    res, api = _case("g4_skew", jax_spec, G=4)
    assert res["rep"]["speculative"]["drafted"] > 0
    assert res["moe"]["decode/moved_units"] > 0
    assert res["lb"]["send_drops_total"] == 0
    assert api.engines[0].core._skew.shape[2] \
        == -(-3 * 5 // 4)                  # B (k + 1) tokens over 4 ranks


def test_greedy_streams_across_k_at_g4_without_skew(jax_spec):
    """At G = 4 with the router's own choices (harmoeny, q = 1, so units
    move) the verify step's routed B (k + 1) tokens give the k = 0
    streams."""
    import dataclasses
    outs = {}
    for k in (0, 4):
        api = PortAPI(jax_spec[1][1], G=4)
        api.cfg = dataclasses.replace(api.cfg, moe=dataclasses.replace(
            api.cfg.moe, router_skew=0.0))
        out, rep = api.run(spec_engine(api, k, gen=12),
                           motif_requests(api, 3, gen=12, seed=2))
        outs[k] = out
        assert rep["moe"]["decode/moved_units"] > 0
    assert outs[0] == outs[4]


def test_speculative_requires_paged():
    with pytest.raises(ValueError, match="paged"):
        EngineConfig(speculative_k=2)
    assert EngineConfig(speculative_k=2, paged=True).speculative_k == 2


def test_unknown_policy_fails_in_make_proposer(jax_spec):
    api = PortAPI(jax_spec[1][1])
    with pytest.raises(ValueError, match="unknown speculative_policy"):
        api.engine(slots=1, prompt_len=8, max_new=4, chunk=4,
                   speculative_k=2, speculative_policy="tree-of-drafts")


# ----------------------------------------------------------------------
# units, on the same numpy inputs as JAX's
# ----------------------------------------------------------------------
@pytest.mark.parametrize("ctx,k,want", [
    ([5, 6, 7, 9, 5, 6, 7, 9], 3, [5, 6, 7]),
    ([1, 2, 9, 1, 2, 4, 1, 2], 2, [4, 1]),
    ([1, 2, 3], 4, []), ([7, 7], 4, [7]), ([5], 4, [])])
@pytest.mark.parametrize("ngram", [(3, 1), (2, 1)])
def test_ngram_proposer_equals_jax(ctx, k, want, ngram):
    ctx = np.array(ctx, np.int32)
    got = TS.NGramProposer(*ngram).propose(ctx, k)
    assert got.tolist() == JS.NGramProposer(*ngram).propose(ctx, k).tolist()
    assert got.dtype == np.int32
    if ngram == (3, 1) or len(want) < 3:
        assert got.tolist() == want


def test_ngram_proposer_random_contexts_equal_jax():
    rng = np.random.default_rng(0)
    for _ in range(200):
        ctx = rng.integers(0, 4, (int(rng.integers(1, 30)),))
        k = int(rng.integers(0, 6))
        for n in ((3, 1), (2, 2), (4, 1)):
            assert TS.NGramProposer(*n).propose(ctx, k).tolist() \
                == JS.NGramProposer(*n).propose(ctx, k).tolist()


def test_make_proposer_unknown_policy():
    for mod in (TS, JS):
        with pytest.raises(ValueError, match="unknown speculative_policy"):
            mod.make_proposer("tree-of-drafts")
    with pytest.raises(ValueError, match="min_ngram"):
        TS.NGramProposer(max_ngram=1, min_ngram=2)


def test_greedy_verify_exact_match_prefix():
    V = 8
    logits = np.full((4, V), -1.0)
    logits[0, 3] = logits[1, 5] = logits[2, 2] = 1.0
    for drafts, want in (([3, 5, 7], (2, 2)), ([], (0, 3)),
                         ([3, 5, 2], (3, 0)), ([4], (0, 3))):
        assert TS.greedy_verify(logits, drafts) == want
        assert JS.greedy_verify(logits, drafts) == want


@pytest.mark.parametrize("kw", [
    dict(temperature=1.0, top_k=4), dict(temperature=0.7, top_p=0.6),
    dict(temperature=1.0, top_k=6, top_p=0.5),
    dict(temperature=1.3, top_p=0.8)])
def test_rejection_verify_equals_jax_on_one_generator_seed(kw):
    """Tie-heavy and generic rows, in- and out-of-support drafts, up to
    three of them: the same generator seed gives the same accepted count
    and token."""
    rng = np.random.default_rng(3)
    rows = [np.array([0., 1.] * 8), rng.normal(size=24)]
    for row in rows:
        logits = np.tile(row[None], (4, 1)) + rng.normal(
            scale=0.1, size=(4, row.shape[0]))
        for drafts in ([1], [0], [1, 3, 5], [], [2, 2]):
            a, b = (np.random.default_rng(9), np.random.default_rng(9))
            for _ in range(40):
                got = TS.rejection_verify(logits, drafts, a, **kw)
                assert got == JS.rejection_verify(logits, drafts, b, **kw)


N_DRAWS = 4000


def _committed_dist(logits, draft, **kw):
    rng = np.random.default_rng(0)
    rows = np.tile(np.asarray(logits, np.float64)[None], (2, 1))
    counts = {}
    for _ in range(N_DRAWS):
        n_acc, nxt = TS.rejection_verify(rows, [draft], rng, **kw)
        tok = draft if n_acc == 1 else nxt
        counts[tok] = counts.get(tok, 0) + 1
    return {t: c / N_DRAWS for t, c in counts.items()}


def _base_dist(logits, **kw):
    ids, p = TSamp.truncated_probs_np(
        np.asarray(logits, np.float64), temperature=kw["temperature"],
        top_k=kw.get("top_k", 0), top_p=kw.get("top_p", 1.0))
    return {int(t): float(pp) for t, pp in zip(ids, p)}


def _assert_dist_close(emp, ref, tol=0.035):
    assert set(emp) <= set(ref)
    for t, p in ref.items():
        assert abs(emp.get(t, 0.0) - p) < tol, (t, emp.get(t, 0.0), p)


@pytest.mark.parametrize("kw", [
    dict(temperature=1.0, top_k=4), dict(temperature=0.7, top_p=0.6),
    dict(temperature=1.0, top_k=6, top_p=0.5)])
def test_rejection_sampler_matches_base_distribution_tie_heavy(kw):
    logits = np.array([0., 1.] * 8)
    ref = _base_dist(logits, **kw)
    for draft in (1, 0):
        _assert_dist_close(_committed_dist(logits, draft, **kw), ref)


def test_rejection_sampler_matches_base_distribution_generic():
    rng = np.random.default_rng(3)
    logits = rng.normal(size=24)
    kw = dict(temperature=1.3, top_p=0.8)
    ref = _base_dist(logits, **kw)
    draft = max(ref, key=ref.get)
    _assert_dist_close(_committed_dist(logits, draft, **kw), ref)
    rng_a, rng_b = np.random.default_rng(5), np.random.default_rng(5)
    for _ in range(64):
        _, nxt = TS.rejection_verify(np.asarray(logits)[None], [], rng_a,
                                     **kw)
        assert nxt == TSamp.sample_np(logits, rng_b, **kw)
    assert TSamp.sample_np(logits, np.random.default_rng(1), **kw) \
        == JSamp.sample_np(logits, np.random.default_rng(1), **kw)


# ----------------------------------------------------------------------
# the captured verify step
# ----------------------------------------------------------------------
def _verify_engine(jax_spec, G=1, k=3):
    api = PortAPI(jax_spec[1][G], G=G)
    eng = api.engine(slots=3, prompt_len=12, max_new=6, chunk=4,
                     speculative_k=k)
    eng.warmup()
    return eng


@pytest.mark.parametrize("G", [1, 4])
def test_verify_step_never_syncs_the_host(jax_spec, G, monkeypatch):
    from repro_torch.kernels.schedule import ops as schedule_ops
    from repro_torch.serve import Request
    eng = _verify_engine(jax_spec, G)
    guard = HostSyncGuard()
    plain = schedule_ops.rebalance_plain

    def exempt_plain(*args, **kwargs):
        guard.paused += 1
        try:
            return plain(*args, **kwargs)
        finally:
            guard.paused -= 1
    monkeypatch.setattr(schedule_ops, "rebalance_plain", exempt_plain)
    step = eng.core._step

    def guarded(*args):
        with guard:
            return step(*args)
    rng = np.random.default_rng(5)
    for i in range(3):
        eng.submit(Request(rid=i, tokens=np.tile(rng.integers(1, 500, (3,)),
                                                 4), max_new_tokens=6))
    while not eng.active.any():
        eng.step()
    monkeypatch.setattr(eng.core, "_step", guarded)
    for _ in range(2):
        assert eng._decode_work(eng.clock.now())
    assert guard.ops > 100
    assert guard.hits == []


def test_verify_step_is_position_independent(jax_spec, monkeypatch):
    eng = _verify_engine(jax_spec)
    core, model, params = eng.core, eng.model, eng.params
    B, S = core.B, core.S
    seen = {}
    step = core._step

    def recording(*args):
        rec = OpRecorder()
        with rec:
            out = step(*args)
        seen["trace"] = rec.trace
        return out
    monkeypatch.setattr(core, "_step", recording)
    rng = np.random.default_rng(7)
    bps = eng.kv.blocks_per_slot
    windows = [([5, 9, 2], [True, True, False]),
               ([0, 13, 7], [True, False, True]),
               ([11, 3, 16], [True, True, True])]
    traces = []
    for i, (pos, active) in enumerate(windows):
        pos, active = np.array(pos, np.int32), np.array(active)
        toks = rng.integers(1, 500, (B, S)).astype(np.int32)
        table = rng.permutation(np.arange(1, B * bps + 1)).reshape(
            B, bps).astype(np.int32)
        ref_pool = eng.kv.pool
        from repro_torch.serve.paging import map_kv_leaves
        fresh = map_kv_leaves(lambda x, j: x.clone(), ref_pool)
        logits, packed = core.decode(params, toks, eng.kv.pool, pos, table,
                                     active, i)
        traces.append(seen["trace"])
        want, _, _, diags = model.decode_step(
            params, torch.from_numpy(toks), fresh, torch.from_numpy(pos),
            active_mask=torch.from_numpy(active),
            block_table=torch.from_numpy(table),
            block_size=eng.ecfg.kv_block_size)
        assert logits.shape == (B, S, model.cfg.padded_vocab)
        np.testing.assert_array_equal(logits, want.float().numpy())
        got = core.unpack(packed, "decode")
        assert got.keys() == diags.keys()
        for key, v in diags.items():
            np.testing.assert_array_equal(got[key], v.float().numpy(),
                                          err_msg=key)
    for t in traces[1:]:
        diff = [(a, b) for a, b in zip(traces[0], t) if a != b]
        assert len(t) == len(traces[0]) and not diff, \
            f"the verify step depends on its window: {diff[:2]}"
    assert len(traces[0]) > 100
