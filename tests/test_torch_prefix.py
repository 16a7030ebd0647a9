"""The port's prefix-sharing engine against the JAX engine's, on reduced
qwen15-moe-a27b (f32, paged, 4-token blocks, 4-token chunks).

Every engine case of ``tests/test_serve_prefix.py`` (hits across
windows, CoW on a full-prompt hit, sharing on against off, EOS at a block
boundary, preemption that keeps shared blocks, the decode CoW guard, LRU
eviction under pressure, stable entries) is written once (``CASES``) and
driven through an engine factory: the JAX engines in subprocesses (their
converted weights come back with the results), the port's here, on the
same weights.  Each case returns its streams, every request's
``cached_prefix_tokens``, the prefix counters, chunk and step counts,
phases and ``jit_entries`` key set, which must be equal; the port's side
also meets the JAX test's own assertions.

Plus, as ``tests/test_torch_prefill_capture.py`` does for the chunk: the
store's captured prefix gather and block copy never sync the host
(``HostSyncGuard``), and are position independent: one store's gather at
several (chain, length) pairs and copy at several (src, dst) pairs
dispatches the same ops with the same host arguments, with results
bit-equal to ``paging.gather_prefix_blocks`` / ``copy_block`` called with
host ints.  The ``tests/test_torch_speculative.py`` cases use the same
machinery (``jax_cases``, ``PortAPI``)."""
import json
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from repro_torch.configs.qwen15_moe_a27b import CONFIG as TORCH_QWEN
from repro_torch.convert import to_torch
from repro_torch.models.model import build_model
from repro_torch.serve import (Request, ServeEngine, VirtualClock,
                               engine_config_for)
from repro_torch.serve import paging as TP

from _ep_helpers import SRC, FLATTEN_SRC, one_torch_thread, unflatten  # noqa: F401,E501
from test_torch_capture import HostSyncGuard
from test_torch_prefill_capture import OpRecorder

# the cases, as source text: the JAX subprocess runs them on its engines,
# the test on the port's; ``api`` builds engines and runs requests
CASES_SRC = '''
import numpy as np


def summary(rep):
    """What a case compares of a report."""
    keep = ("n_requests", "prefix_hit_rate", "cow_copies", "evictions",
            "resume_cached_tokens", "preemptions", "prefill_chunks",
            "decode_steps", "total_new_tokens", "speculative")
    out = {k: rep.get(k) for k in keep}
    out["cached"] = {str(r["rid"]): r["cached_prefix_tokens"]
                     for r in rep["requests"]}
    out["phases"] = {ph: [s["steps"], s["tokens"]]
                     for ph, s in rep.get("phases", {}).items()}
    out["jit_keys"] = sorted(rep["jit_entries"])
    out["sharing"] = rep["engine"].get("prefix_sharing")
    out["spec_k"] = rep["engine"].get("speculative_k")
    return out


def streams(out):
    return {str(k): [int(t) for t in v] for k, v in out.items()}


def case_hits_across_windows(api):
    L, gen = 14, 5                                   # 14 % 4 != 0
    eng = api.engine(slots=1, prompt_len=L, max_new=gen, chunk=4,
                     prefix_sharing=True)
    rng = np.random.default_rng(0)
    p = rng.integers(0, api.vocab, (L,)).astype(np.int32)
    out1, rep1 = api.run(eng, [api.Request(rid=0, tokens=p.copy(),
                                           max_new_tokens=gen)])
    eng.reset_metrics()
    out2, rep2 = api.run(eng, [api.Request(rid=1, tokens=p.copy(),
                                           max_new_tokens=gen)])
    return dict(out=[streams(out1), streams(out2)],
                reps=[summary(rep1), summary(rep2)],
                in_use=eng._alloc.blocks_in_use)


def case_cow_on_full_prompt_hit(api):
    L, gen = 16, 5                                   # 16 % 4 == 0
    rng = np.random.default_rng(1)
    p = rng.integers(0, api.vocab, (L,)).astype(np.int32)
    eng = api.engine(slots=1, prompt_len=L, max_new=gen, chunk=4,
                     prefix_sharing=True)
    out1, _ = api.run(eng, [api.Request(rid=0, tokens=p.copy(),
                                        max_new_tokens=gen)])
    eng.reset_metrics()
    out2, rep2 = api.run(eng, [api.Request(rid=1, tokens=p.copy(),
                                           max_new_tokens=gen)])
    return dict(out=[streams(out1), streams(out2)], reps=[summary(rep2)])


def differential_requests(api, gen=6):
    rng = np.random.default_rng(2)
    prefix = rng.integers(0, api.vocab, (12,)).astype(np.int32)
    full = rng.integers(0, api.vocab, (16,)).astype(np.int32)
    short = rng.integers(0, api.vocab, (7,)).astype(np.int32)
    reqs = []
    for i, plen in enumerate([16, 14, 13]):
        t = np.concatenate(
            [prefix, np.arange(i, i + plen - 12, dtype=np.int32)])
        reqs.append(api.Request(rid=i, tokens=t, max_new_tokens=gen))
    reqs.append(api.Request(rid=3, tokens=full.copy(), max_new_tokens=gen))
    reqs.append(api.Request(rid=4, tokens=full.copy(), max_new_tokens=4))
    reqs.append(api.Request(rid=5, tokens=short.copy(), max_new_tokens=gen))
    return reqs


def case_differential_sharing_on_off(api):
    res = {}
    for sharing in ((False, True) if api.refs else (True,)):
        eng = api.engine(slots=3, prompt_len=16, max_new=6, chunk=4,
                         prefix_sharing=sharing, num_kv_blocks=9)
        out, rep = api.run(eng, differential_requests(api))
        res[("ref_" if not sharing else "") + str(sharing)] = dict(
            out=streams(out), rep=summary(rep),
            in_use=eng._alloc.blocks_in_use)
    return res


def case_eos_at_block_boundary(api):
    L = 8
    rng = np.random.default_rng(3)
    p = rng.integers(0, api.vocab, (L,)).astype(np.int32)
    solo = api.engine(slots=1, prompt_len=L, max_new=8, chunk=4,
                      prefix_sharing=True)
    out, _ = api.run(solo, [api.Request(rid=0, tokens=p.copy(),
                                        max_new_tokens=8)])
    eos = int(out[0][3])     # pos after out[3] is 12: a block boundary
    eng = api.engine(slots=1, prompt_len=L, max_new=8, chunk=4,
                     prefix_sharing=True)
    out1, _ = api.run(eng, [api.Request(rid=1, tokens=p.copy(),
                                        max_new_tokens=8, eos_id=eos)])
    eng.reset_metrics()
    out2, rep2 = api.run(eng, [api.Request(rid=2, tokens=p.copy(),
                                           max_new_tokens=8, eos_id=eos)])
    return dict(out=[streams(out), streams(out1), streams(out2)],
                reps=[summary(rep2)])


def case_preemption_keeps_shared_blocks(api):
    L, gen = 8, 8
    rng = np.random.default_rng(4)
    prefix = rng.integers(0, api.vocab, (8,)).astype(np.int32)

    def mk():
        out = []
        for i in range(5):
            t = prefix.copy()
            if i:
                t[-1] = (t[-1] + i) % api.vocab
            out.append(api.Request(rid=i, tokens=t, max_new_tokens=gen))
        return out
    res = {}
    if api.refs:
        solo = api.engine(slots=1, prompt_len=L, max_new=gen, chunk=4)
        res["ref"] = streams(api.run(solo, mk())[0])
    eng = api.engine(slots=3, prompt_len=L, max_new=gen, chunk=4,
                     prefix_sharing=True, num_kv_blocks=8)
    out, rep = api.run(eng, mk())
    return dict(res, out=streams(out), rep=summary(rep),
                in_use=eng._alloc.blocks_in_use)


def case_decode_cow_guard(api):
    L, gen = 6, 6                    # pos 6 lands inside block 1
    rng = np.random.default_rng(5)
    p = rng.integers(0, api.vocab, (L,)).astype(np.int32)
    res = {}
    if api.refs:
        solo = api.engine(slots=1, prompt_len=L, max_new=gen, chunk=3,
                          prefix_sharing=True)
        res["ref"] = streams(api.run(solo, [api.Request(
            rid=0, tokens=p.copy(), max_new_tokens=gen)])[0])
    eng = api.engine(slots=1, prompt_len=L, max_new=gen, chunk=3,
                     prefix_sharing=True)
    outputs = {}
    orig = eng._finish

    def finish(st, now):
        outputs[st.req.rid] = list(st.output)
        orig(st, now)
    eng._finish = finish
    eng.submit(api.Request(rid=1, tokens=p.copy(), max_new_tokens=gen))
    while not eng.active.any():
        eng.step()
    # another chain adopts the partly filled block decode writes into
    blk = eng._alloc.chain(1)[int(eng.pos[0]) // 4]
    eng._alloc.alloc_chain(999, 0, shared=[blk])
    shared_ref = eng._alloc.refcount(blk)
    while eng.has_work():
        eng.step()
    return dict(res, out=streams(outputs), cow=eng.report()["cow_copies"],
                shared=shared_ref, holder=list(eng._alloc.chain(999)),
                blk=int(blk))


def case_lru_eviction(api):
    L, gen = 8, 4
    res = {}
    for sharing in ((False, True) if api.refs else (True,)):
        eng = api.engine(slots=2, prompt_len=L, max_new=gen, chunk=4,
                         prefix_sharing=sharing, num_kv_blocks=8)
        out, rep = api.run(eng, api.poisson_requests(
            10, rate=0.0, vocab_size=api.vocab, prompt_len=L,
            max_new_tokens=gen, seed=6))
        res[("ref_" if not sharing else "") + str(sharing)] = dict(
            out=streams(out), rep=summary(rep))
    return res


def case_stable_entries(api):
    L, gen = 8, 4
    eng = api.engine(slots=2, prompt_len=L, max_new=gen, chunk=4,
                     prefix_sharing=True)
    eng.warmup()
    rep = eng.run(api.poisson_requests(
        6, rate=0.0, vocab_size=api.vocab, prompt_len=L,
        max_new_tokens=gen, seed=7, shared_prefix_len=L))
    return dict(rep=summary(rep),
                recompiled=rep["recompiled_after_warmup"])
'''

PREFIX_CASES = ["hits_across_windows", "cow_on_full_prompt_hit",
                "differential_sharing_on_off", "eos_at_block_boundary",
                "preemption_keeps_shared_blocks", "decode_cow_guard",
                "lru_eviction", "stable_entries"]

# the JAX side: one subprocess runs every case of a file on its engines
JAX_BODY = FLATTEN_SRC + '''
import json
import jax
jax.config.update("jax_compilation_cache_dir", CACHE)
jax.config.update("jax_persistent_cache_min_compile_time_secs", 0)
from repro.configs.base import ParallelConfig
from repro.configs.qwen15_moe_a27b import CONFIG
from repro.launch.mesh import make_host_mesh
from repro.models.model import MeshShape, build_model
from repro.serve import (Request, ServeEngine, VirtualClock,
                         engine_config_for, poisson_requests)


class API:
    Request = staticmethod(Request)
    poisson_requests = staticmethod(poisson_requests)
    refs = False            # reference-only runs are the port's side's

    def __init__(self, G):
        import dataclasses
        cfg = CONFIG.reduced()
        if G > 1:
            cfg = dataclasses.replace(cfg, moe=dataclasses.replace(
                cfg.moe, q_tokens=1, router_skew=0.9))
        self.cfg, self.G = cfg, G
        self.vocab = cfg.vocab_size
        self.mesh = make_host_mesh(1, G)
        self.ms = MeshShape(tuple(zip(self.mesh.axis_names,
                                      self.mesh.devices.shape)))
        self.params = None
        self.models = {}

    def model(self, slots, prompt_len):
        key = (slots, prompt_len)
        if key not in self.models:
            self.models[key] = build_model(
                self.cfg, ParallelConfig(attn_chunk=8, loss_chunk=8),
                batch=slots, seq_len=prompt_len, mesh_shape=self.ms,
                mesh=self.mesh)
            if self.params is None:
                with self.mesh:
                    self.params = self.models[key].init(
                        jax.random.PRNGKey(0))
        return self.models[key]

    def engine(self, *, slots, prompt_len, max_new, chunk, bs=4,
               clock=0.1, **kw):
        model = self.model(slots, prompt_len)
        ecfg = engine_config_for(self.cfg, max_slots=slots,
                                 prompt_len=prompt_len,
                                 max_new_tokens=max_new,
                                 prefill_chunk=chunk, paged=True,
                                 kv_block_size=bs, **kw)
        eng = ServeEngine(model, self.params, ecfg, mesh=self.mesh,
                          clock=VirtualClock(clock))
        if self.G > 1:
            record_draws(eng, self)
        return eng

    def run(self, eng, reqs):
        outputs = {}
        orig = eng._finish

        def capture(st, now):
            outputs[st.req.rid] = list(st.output)
            orig(st, now)
        eng._finish = capture
        with self.mesh:
            rep = eng.run(reqs)
        return outputs, rep


out = {}
apis = {}
for name, G in CASE_G.items():
    if G not in apis:
        apis[G] = API(G)
    api = apis[G]
    api.draws = []
    res = globals()["case_" + name](api)
    if G > 1:
        res["draws"] = api.draws
    out[name] = np.array(json.dumps(res))
for G, api in apis.items():
    out.update(flatten(jax.device_get(api.params), f"params{G}/"))
np.savez(OUT, **out)
'''


def jax_cases(tmp_path_factory, case_g, groups, extra_src="", devices=1,
              timeout=600):
    """Run the cases named in ``case_g`` ({name: EP degree}) on JAX
    engines, one subprocess a group of ``groups`` (lists of names), the
    subprocesses side by side; returns ({name: result}, {G: the JAX
    weights converted})."""
    tmp = tmp_path_factory.mktemp("jaxcases")
    assert sorted(n for g in groups for n in g) == sorted(case_g)
    flat = run_jax_side_by_side(
        [f"CASE_G = {({n: case_g[n] for n in group})!r}\n"
         f"CACHE = {str(tmp / f'xla{i}')!r}\n" + CASES_SRC + extra_src
         + JAX_BODY for i, group in enumerate(groups)],
        tmp, devices=devices, timeout=timeout)
    results = {n: json.loads(str(flat[n])) for n in case_g}
    params = {G: to_torch(unflatten(flat, f"params{G}"), device="cpu")
              for G in set(case_g.values())}
    return results, params


def run_jax_side_by_side(bodies, tmp, *, devices=1, timeout=600):
    """Run each of ``bodies`` (each writes ``OUT``, an npz path) in a JAX
    subprocess of its own with ``devices`` emulated host devices, all
    side by side; returns the npz files' entries merged.  Each process
    writes its output to a file of its own: a pipe left unread while
    another process is waited on would fill and stall its writer (XLA's
    cache loads log at length)."""
    env = dict(os.environ, JAX_PLATFORMS="cpu",
               PYTHONPATH=os.path.abspath(SRC) + os.pathsep
               + os.environ.get("PYTHONPATH", ""),
               XLA_FLAGS=(f"--xla_force_host_platform_device_count="
                          f"{devices} --xla_cpu_multi_thread_eigen=false"))
    running = []
    for i, body in enumerate(bodies):
        out, log = tmp / f"side{i}.npz", tmp / f"side{i}.log"
        code = f"import numpy as np\nOUT = {str(out)!r}\n" + body
        with open(log, "w") as f:
            running.append((out, log, subprocess.Popen(
                [sys.executable, "-c", code], env=env, stdout=f,
                stderr=subprocess.STDOUT)))
    flat = {}
    try:
        for out, log, proc in running:
            proc.wait(timeout=timeout)
            assert proc.returncode == 0, log.read_text()[-4000:]
            with np.load(out) as z:
                flat.update({k: z[k] for k in z.files})
    finally:
        for _, _, proc in running:
            if proc.poll() is None:
                proc.kill()
                proc.wait()
    return flat


exec(CASES_SRC)


class PortAPI:
    """The port's side of ``CASES``: engines on the JAX weights, plus the
    cases' reference-only runs (sharing off, speculation off), whose
    streams the port's own runs must equal."""
    Request = staticmethod(Request)
    refs = True

    def __init__(self, params, G=1, draws=None):
        import dataclasses
        from repro_torch.serve import poisson_requests
        self.poisson_requests = poisson_requests
        cfg = TORCH_QWEN.reduced()
        if G > 1:
            cfg = dataclasses.replace(cfg, moe=dataclasses.replace(
                cfg.moe, q_tokens=1, router_skew=0.9))
        self.cfg, self.G, self.params = cfg, G, params
        self.vocab = cfg.vocab_size
        self.draws = draws          # the JAX engines' skew draws, in order
        self.engines = []

    def engine(self, *, slots, prompt_len, max_new, chunk, bs=4,
               clock=0.1, **kw):
        model = build_model(self.cfg, batch=slots, seq_len=prompt_len,
                            device="cpu", ep_degree=self.G)
        ecfg = engine_config_for(self.cfg, max_slots=slots,
                                 prompt_len=prompt_len,
                                 max_new_tokens=max_new,
                                 prefill_chunk=chunk, paged=True,
                                 kv_block_size=bs, **kw)
        eng = ServeEngine(model, self.params, ecfg,
                          clock=VirtualClock(clock), device="cpu")
        if self.draws is not None:
            replay_draws(eng, self.draws[len(self.engines)])
        self.engines.append(eng)
        return eng

    def run(self, eng, reqs):
        outputs = {}
        orig = eng._finish

        def capture(st, now):
            outputs[st.req.rid] = list(st.output)
            orig(st, now)
        eng._finish = capture
        return outputs, eng.run(reqs)


def replay_draws(eng, draws):
    """The port's step core routes on the JAX engine's skewed assignments
    of the same call index (a call JAX did not make, the port's warmup,
    keeps the buffer as it is)."""
    core = eng.core

    def predraw(idx, entry="decode"):
        d = draws[entry].get(str(idx))
        if d is not None:
            buf = core._pf_skew if entry == "prefill_chunk" else core._skew
            buf.copy_(torch.tensor(d, dtype=torch.int32))
    core._predraw = predraw


@pytest.fixture(scope="module")
def jax_prefix(tmp_path_factory):
    return jax_cases(tmp_path_factory, {n: 1 for n in PREFIX_CASES},
                     groups=[["hits_across_windows",
                              "differential_sharing_on_off"],
                             ["cow_on_full_prompt_hit",
                              "eos_at_block_boundary", "stable_entries"],
                             ["preemption_keeps_shared_blocks",
                              "decode_cow_guard", "lru_eviction"]])


@pytest.fixture(scope="module")
def port(jax_prefix):
    return PortAPI(jax_prefix[1][1])


def compare(got, want):
    """A case's results against the JAX engine's: every key but the
    port's own reference runs (``ref*``)."""
    got = json.loads(json.dumps(got))
    assert {k: v for k, v in got.items() if not k.startswith("ref")} \
        == want
    return got


def _case(name, jax_prefix, port):
    return compare(globals()["case_" + name](port), jax_prefix[0][name])


def test_prefix_hit_skips_prefill_across_windows(jax_prefix, port):
    res = _case("hits_across_windows", jax_prefix, port)
    rep1, rep2 = res["reps"]
    assert rep1["prefix_hit_rate"] == 0.0
    assert rep1["prefill_chunks"] == 4
    assert rep2["prefix_hit_rate"] == pytest.approx(12 / 14)
    assert rep2["cached"] == {"1": 12}
    assert rep2["prefill_chunks"] == 1
    assert rep2["phases"]["prefix_tail"] == [1, 2]
    assert res["out"][1]["1"] == res["out"][0]["0"]
    assert res["in_use"] == 0


def test_cow_on_full_prompt_hit(jax_prefix, port):
    res = _case("cow_on_full_prompt_hit", jax_prefix, port)
    rep2 = res["reps"][0]
    assert rep2["cow_copies"] == 1
    assert rep2["cached"] == {"1": 15}
    assert rep2["prefill_chunks"] == 1
    assert res["out"][1]["1"] == res["out"][0]["0"]


def test_differential_sharing_on_off(jax_prefix, port):
    res = _case("differential_sharing_on_off", jax_prefix, port)
    off, on = res["ref_False"], res["True"]
    assert on["rep"]["preemptions"] > 0
    assert on["rep"]["prefix_hit_rate"] > 0
    assert on["out"] == off["out"]
    assert on["in_use"] == off["in_use"] == 0
    assert off["rep"]["jit_keys"] == ["decode", "prefill_chunk",
                                      "write_blocks"]
    assert on["rep"]["jit_keys"] == ["copy_block", "decode",
                                     "gather_prefix", "prefill_chunk",
                                     "write_blocks"]


def test_eos_id_finish_at_block_boundary(jax_prefix, port):
    res = _case("eos_at_block_boundary", jax_prefix, port)
    solo, out1, out2 = res["out"]
    assert out1["1"] == solo["0"][:4]
    assert res["reps"][0]["prefix_hit_rate"] > 0
    assert out2["2"] == out1["1"]


def test_preemption_keeps_shared_blocks_alive(jax_prefix, port):
    res = _case("preemption_keeps_shared_blocks", jax_prefix, port)
    assert res["rep"]["preemptions"] > 0
    assert res["rep"]["resume_cached_tokens"] > 0
    assert res["out"] == res["ref"]
    assert res["in_use"] == 0


def test_decode_cow_guard_on_shared_write_target(jax_prefix, port):
    res = _case("decode_cow_guard", jax_prefix, port)
    assert res["shared"] == 2
    assert res["cow"] >= 1
    assert res["holder"] == [res["blk"]]
    assert res["out"]["1"] == res["ref"]["0"]


def test_lru_eviction_under_pressure_stays_exact(jax_prefix, port):
    res = _case("lru_eviction", jax_prefix, port)
    assert res["True"]["rep"]["evictions"] > 0
    assert res["True"]["out"] == res["ref_False"]["out"]


def test_sharing_jit_entries_stable(jax_prefix, port):
    res = _case("stable_entries", jax_prefix, port)
    rep = res["rep"]
    assert rep["n_requests"] == 6
    assert rep["prefix_hit_rate"] > 0
    assert rep["cow_copies"] > 0
    assert rep["jit_keys"] == ["copy_block", "decode", "gather_prefix",
                               "prefill_chunk", "write_blocks"]
    assert res["recompiled"] is False
    assert rep["sharing"] is True


def test_probe_prefix_is_a_pure_lookup(port):
    """``probe_prefix`` reports the cached prefix in tokens and leaves the
    LRU order as it is (the fleet router's affinity probe)."""
    eng = port.engine(slots=1, prompt_len=12, max_new=3, chunk=4,
                      prefix_sharing=True)
    p = np.arange(1, 13, dtype=np.int32)
    port.run(eng, [Request(rid=0, tokens=p, max_new_tokens=3)])
    before = list(eng._alloc._cached)
    assert eng.probe_prefix(p) == 12
    assert eng.probe_prefix(p[:7]) == 4
    assert eng.probe_prefix(p[::-1].copy()) == 0
    assert list(eng._alloc._cached) == before
    off = port.engine(slots=1, prompt_len=12, max_new=3, chunk=4)
    assert off.probe_prefix(p) == 0


# ----------------------------------------------------------------------
# the captured gather and copy: no host sync, position independent
# ----------------------------------------------------------------------
def _store(port):
    eng = port.engine(slots=2, prompt_len=16, max_new=4, chunk=4,
                      prefix_sharing=True)
    eng.warmup()
    return eng


@pytest.mark.parametrize("entry", ["_gather", "_copy"])
def test_gather_and_copy_never_sync_the_host(port, entry, monkeypatch):
    """A prefix-tail restart (gather) and a full-prompt hit (copy) in a
    live engine, with the store's entry under the guard."""
    eng = _store(port)
    guard = HostSyncGuard()
    fn = getattr(eng.kv, entry)
    calls = []

    def guarded(*args):
        calls.append(1)
        with guard:
            return fn(*args)
    monkeypatch.setattr(eng.kv, entry, guarded)
    p = np.arange(3, 19, dtype=np.int32)               # 16: block-aligned
    port.run(eng, [Request(rid=0, tokens=p, max_new_tokens=2)])
    port.run(eng, [Request(rid=1, tokens=np.concatenate([p[:12], [7, 9]]),
                           max_new_tokens=2),
                   Request(rid=2, tokens=p.copy(), max_new_tokens=2)])
    assert calls                                       # ran, guarded
    assert guard.ops > 3
    assert guard.hits == []


def test_gather_is_position_independent(port, monkeypatch):
    eng = _store(port)
    kv = eng.kv
    rng = np.random.default_rng(5)
    for leaf in TP.kv_leaves(kv.pool):
        leaf.copy_(torch.from_numpy(rng.standard_normal(
            leaf.shape).astype(np.float32)))
    seen = {}
    fn = kv._gather

    def recording(*args):
        rec = OpRecorder()
        with rec:
            fn(*args)
        seen["trace"] = rec.trace
    monkeypatch.setattr(kv, "_gather", recording)
    traces = []
    for rid, (chain, n) in enumerate([([3, 5, 1], 9), ([7], 4),
                                      ([2, 4, 6, 8], 16), ([9, 1], 0)]):
        kv.alloc._chains[100 + rid] = list(chain)
        ref = TP.map_kv_leaves(lambda x, i: x.clone(), kv.scratch)
        kv.gather(100 + rid, n)
        traces.append(seen["trace"])
        TP.gather_prefix_blocks(kv.pool, ref, torch.from_numpy(
            kv.bt_row(100 + rid)), n, s_pad=kv.s_pad,
            block_size=kv.ecfg.kv_block_size, seq_axes=kv.seq_axes)
        for a, b in zip(TP.kv_leaves(kv.scratch), TP.kv_leaves(ref)):
            assert torch.equal(a, b)
        del kv.alloc._chains[100 + rid]
    for t in traces[1:]:
        assert t == traces[0], "the gather depends on its chain or length"
    assert len(traces[0]) > 10


def test_copy_is_position_independent(port, monkeypatch):
    eng = _store(port)
    kv = eng.kv
    rng = np.random.default_rng(6)
    for leaf in TP.kv_leaves(kv.pool):
        leaf.copy_(torch.from_numpy(rng.standard_normal(
            leaf.shape).astype(np.float32)))
    seen = {}
    fn = kv._copy

    def recording(*args):
        rec = OpRecorder()
        with rec:
            fn(*args)
        seen["trace"] = rec.trace
    monkeypatch.setattr(kv, "_copy", recording)
    traces = []
    for src, dst in [(3, 6), (6, 2), (1, 1), (8, 4)]:
        ref = TP.map_kv_leaves(lambda x, i: x.clone(), kv.pool)
        kv.copy(src, dst)
        traces.append(seen["trace"])
        TP.copy_block(ref, src, dst, block_size=kv.ecfg.kv_block_size,
                      seq_axes=kv.seq_axes)
        for a, b in zip(TP.kv_leaves(kv.pool), TP.kv_leaves(ref)):
            assert torch.equal(a, b)
    for t in traces[1:]:
        assert t == traces[0], "the copy depends on its blocks"
