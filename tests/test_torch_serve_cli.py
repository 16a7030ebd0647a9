"""The port's serving CLI (``repro_torch.launch.serve``) against the JAX
package's (``repro.launch.serve``).

Its ``ENGINE_FLAGS`` rows are JAX's; the same argv parses to the same
``EngineConfig``; unported flags raise ``NotImplementedError`` naming the
flag, and ``--replicas`` / ``--disaggregate`` serve a fleet, printing the
JAX CLI's ``[fleet]`` lines.  Then the whole CLI:
``repro.launch.serve.main`` runs in JAX subprocesses on four emulated
host devices, once an argv (greedy and sampled, slab and paged, at
``--model-par`` 1 and 4, with replica slots, with tiered residency, from
a ``--trace`` file, on reduced mixtral-8x7b, paged through its window
ring, with the prefix cache, with the speculative verify step, two
fleets: two ``prefix_affinity`` replicas with the prefix cache, and a
disaggregated prefill/decode pair, on reduced mamba2-2.7b and zamba2-7b
through the slotted state store, and on the dense reduced
phi4-mini-3.8b, paged), recording each run's weights,
streams, noise and skew draws and writing its report (``--out``).  The
port's ``serve(args, device="cpu", params=...)`` on the converted
weights, replaying the JAX draws by call index, must give the same
per-request token streams, and every section of its report the JAX
report's keys (``engine.device`` is the port's own key), and with
``--prefix-sharing`` or ``--speculative-k`` the prefix counters and the
``speculative`` section the JAX report's values; a fleet's ``fleet``
section has the JAX section's keys, routing decisions, per-replica
counts, handoffs moved and pending and aggregate request count.  The
request generators give the reference's requests exactly."""
import dataclasses
import json
import sys

import numpy as np
import pytest

from repro.launch import serve as JCLI
from repro.serve import arrivals as JA
from repro_torch.convert import to_torch
from repro_torch.launch import serve as TCLI
from repro_torch.serve import arrivals as TA
from repro_torch.serve import engine as TE
from repro_torch.serve import stepcore as TSC

from _ep_helpers import (FLATTEN_SRC, SAMPLING_RECORD_SRC,  # noqa: F401
                         keyed_replay, one_torch_thread, unflatten)
from test_torch_prefix import run_jax_side_by_side

BASE = ["--arch", "qwen15-moe-a27b", "--reduced", "--batch", "3",
        "--prompt-len", "12", "--gen", "6", "--seed", "1"]
PAGED = ["--paged", "--kv-block-size", "4", "--prefill-chunk", "4"]
EP = ["--model-par", "4", "--skew", "0.9", "--q-tokens", "1"]
SAMPLED = ["--temperature", "0.8", "--top-k", "5", "--top-p", "0.9"]
CELLS = {
    "g1_slab_greedy": [],
    "g1_paged_sampled": PAGED + SAMPLED + ["--requests", "5"],
    "ep4_sampled": EP + PAGED + ["--temperature", "0.8", "--top-k", "7"],
    "ep4_replicas": EP + PAGED + ["--replica-slots", "1",
                                  "--rebalance-interval", "2"],
    "ep4_residency": EP + ["--resident-experts", "4",
                           "--prefetch-policy", "on_demand"],
    "g1_trace": PAGED + SAMPLED + ["--trace", "{dir}/trace.json"],
    # reduced mixtral (window 64) paged with prompts past the window: the
    # window ring buffer
    "mixtral_ring": ["--arch", "mixtral-8x7b", "--paged", "--prompt-len",
                     "80", "--kv-block-size", "16", "--prefill-chunk", "16",
                     "--requests", "3"],
    # the prefix cache (every prompt shares its first 8 tokens) and the
    # speculative verify step
    "g1_prefix": PAGED + ["--prefix-sharing", "--shared-prefix-len", "8",
                          "--requests", "4"],
    "g1_speculative": PAGED + ["--speculative-k", "3", "--requests", "4"],
    # fleets: two prefix-affinity replicas on the prefix cache, and a
    # prefill-role engine handing off to a decode-role one
    "fleet_affinity": PAGED + ["--replicas", "2", "--routing-policy",
                               "prefix_affinity", "--prefix-sharing",
                               "--shared-prefix-len", "8", "--requests",
                               "6"],
    "fleet_disagg": PAGED + ["--replicas", "2", "--disaggregate",
                             "--requests", "5"],
    # the recurrent families through the slotted state store: mamba2 (no
    # attention) and the zamba2 hybrid (its attention the plain branches)
    "mamba2": ["--arch", "mamba2-2.7b", "--prefill-chunk", "4",
               "--requests", "4"],
    "zamba2": ["--arch", "zamba2-7b", "--prefill-chunk", "4",
               "--requests", "4"],
    # a dense decoder (GQA, tied embeddings): no MoE sections
    "phi4_dense": ["--arch", "phi4-mini-3.8b"] + PAGED + ["--requests", "4"],
}
# the trace cell's records: explicit tokens and drawn prompts, all at t=0
TRACE = [{"prompt_len": 5, "max_new_tokens": 4},
         {"tokens": [7, 8, 9, 10, 11, 12, 13], "max_new_tokens": 6, "rid": 9},
         {"prompt_len": 11, "max_new_tokens": 3}]
# the port's report keys that the JAX report does not have
PORT_ONLY = {("engine", "device")}


def _jax_args(argv, monkeypatch):
    """The namespace the JAX CLI's own parser gives for ``argv``."""
    got = {}
    monkeypatch.setattr(JCLI, "serve", lambda a: got.setdefault("a", a))
    monkeypatch.setattr(sys, "argv", ["serve"] + argv)
    JCLI.main()
    return got["a"]


def test_engine_flags_equal_jax():
    assert [(f, n) for f, n, _ in TCLI.ENGINE_FLAGS] \
        == [(f, n) for f, n, _ in JCLI.ENGINE_FLAGS]
    for (_, _, t), (_, _, j) in zip(TCLI.ENGINE_FLAGS, JCLI.ENGINE_FLAGS):
        assert t.get("default") == j.get("default")
        assert t.get("choices") == j.get("choices")


@pytest.mark.parametrize("argv", [
    BASE, BASE + PAGED + SAMPLED, BASE + EP + ["--policy", "static_opt"],
    BASE + EP + PAGED + ["--replica-slots", "2", "--rebalance-interval", "3",
                         "--moe-policy", "round_robin", "--kv-blocks", "9"],
    BASE + ["--resident-experts", "4", "--prefetch-policy", "none",
            "--fused-moe", "--speculative-policy", "ngram"],
    BASE + PAGED + ["--fused-attention", "--top-p", "0.5"]],
    ids=["plain", "sampled", "static_opt", "replicas", "residency", "fused"])
def test_same_argv_same_engine_config(argv, monkeypatch):
    """Both parsers read ``argv`` alike, and both CLIs derive the same
    model-config changes and the same ``EngineConfig``, field by field."""
    ja = _jax_args(argv, monkeypatch)
    ta = TCLI.build_parser().parse_args(argv)
    assert vars(ta) == vars(ja)
    jcfg, tcfg = JCLI.config_from_args(ja), TCLI.config_from_args(ta)
    for f in dataclasses.fields(tcfg.moe):
        assert getattr(tcfg.moe, f.name) == getattr(jcfg.moe, f.name), f.name
    jec = JCLI._engine_cfg(ja, jcfg, ja.prompt_len, ja.gen)
    tec = TCLI._engine_cfg(ta, tcfg, ta.prompt_len, ta.gen)
    assert dataclasses.asdict(tec) == dataclasses.asdict(jec)


@pytest.mark.parametrize("extra,flag", [
    (["--replicas", "2"], "--replicas"),
    (["--disaggregate", "--replicas", "2", "--paged"], "--disaggregate"),
    (["--paged", "--prefix-sharing"], "--prefix-sharing"),
    (["--paged", "--speculative-k", "2"], "--speculative-k"),
    (["--arch", "whisper-large-v3"], "--arch"),
    (["--data-par", "2"], "--data-par")])
def test_unported_flags_raise_naming_the_flag(extra, flag, capsys):
    """What the port does not serve raises, naming the flag;
    ``--prefix-sharing`` and ``--speculative-k`` are ported and serve,
    printing the JAX CLI's lines, and so do ``--replicas`` and
    ``--disaggregate``, printing its ``[fleet]`` lines."""
    args = TCLI.build_parser().parse_args(BASE + extra)
    if flag in ("--replicas", "--disaggregate"):
        rep = TCLI.serve(args, device="cpu")
        out = capsys.readouterr().out
        fl = rep["fleet"]
        assert fl["aggregate"]["n_requests"] == 3
        assert fl["disaggregated"] is (flag == "--disaggregate")
        lines = ["[fleet] arch=qwen15-moe-a27b replicas=2 ",
                 "[fleet] TTFT p50 ", "[fleet] routing: per_replica=",
                 "[fleet]   replica 0 role=", "[fleet]   replica 1 role=",
                 "[fleet] recompiled_after_warmup=[False, False]"]
        if flag == "--disaggregate":
            lines.append("[fleet] handoffs: moved=3 ")
            assert [r["role"] for r in fl["replicas"]] \
                == ["prefill", "decode"]
        for line in lines:
            assert line in out, line
        return
    if flag in ("--prefix-sharing", "--speculative-k"):
        rep = TCLI.serve(args, device="cpu")
        out = capsys.readouterr().out
        assert rep["n_requests"] == 3
        if flag == "--prefix-sharing":
            assert rep["engine"]["prefix_sharing"] is True
            assert "[serve] prefix cache: hit_rate=" in out
            assert set(rep["jit_entries"]) >= {"gather_prefix",
                                               "copy_block"}
        else:
            assert rep["engine"]["speculative_k"] == 2
            assert "[serve] speculative k=2 policy=ngram" in out
            assert rep["speculative"]["steps"] > 0
        return
    with pytest.raises(NotImplementedError, match=flag):
        TCLI.serve(args, device="cpu")


def test_engine_config_unported_fields_name_the_item():
    """The split roles, prefix sharing and speculation are ported, and on
    the slab each is the JAX engine's ValueError, word for word."""
    from repro.serve import EngineConfig as JEngineConfig
    for kw in (dict(prefix_sharing=True), dict(speculative_k=1),
               dict(role="decode"), dict(role="prefill")):
        with pytest.raises(ValueError) as jerr:
            JEngineConfig(**kw)
        with pytest.raises(ValueError) as err:
            TE.EngineConfig(**kw)
        assert str(err.value) == str(jerr.value)
        assert TE.EngineConfig(**kw, paged=True).paged


# ----------------------------------------------------------------------
# the request generators
# ----------------------------------------------------------------------
def _same_requests(a, b):
    assert len(a) == len(b)
    for x, y in zip(a, b):
        assert (x.rid, x.max_new_tokens, x.arrival_time, x.eos_id) \
            == (y.rid, y.max_new_tokens, y.arrival_time, y.eos_id)
        np.testing.assert_array_equal(x.tokens, y.tokens)
        assert x.tokens.dtype == y.tokens.dtype


@pytest.mark.parametrize("seed", [0, 1, 7])
def test_request_generators_equal_jax(seed, tmp_path):
    kw = dict(vocab_size=500, max_new_tokens=9, seed=seed)
    for gen, extra in (
            ("poisson_requests", dict(rate=4.0, prompt_len=11)),
            ("poisson_requests", dict(rate=0.0, prompt_len=7,
                                      shared_prefix_len=5, rid_base=100)),
            ("poisson_requests", dict(rate=2.5, prompt_len=7,
                                      prompt_len_range=(3, 20), eos_id=2)),
            ("long_context_requests", dict(max_seq_len=96, rate=3.0,
                                           long_frac=0.4)),
            ("bursty_requests", dict(prompt_len=6, burst_size=3,
                                     burst_gap=0.5,
                                     prompt_len_range=(2, 9)))):
        _same_requests(getattr(TA, gen)(10, **kw, **extra),
                       getattr(JA, gen)(10, **kw, **extra))
    assert TA.split_seeds(seed, 4) == JA.split_seeds(seed, 4)
    subs = [(TA, JA)[k].poisson_requests(
        4, rate=3.0, vocab_size=50, prompt_len=5, max_new_tokens=3,
        seed=s, rid_base=10 * i) for i, s in enumerate(
            TA.split_seeds(seed, 3)) for k in (0, 1)]
    _same_requests(TA.merge_requests(*subs[0::2]),
                   JA.merge_requests(*subs[1::2]))
    with pytest.raises(ValueError, match="colliding"):
        TA.merge_requests(subs[0], subs[0])
    records = [{"arrival_time": 0.1 * i, "prompt_len": 3 + i,
                "max_new_tokens": 4} for i in range(5)]
    records.append({"tokens": [5, 6, 7], "rid": 42, "eos_id": 1})
    path = tmp_path / "trace.json"
    path.write_text(json.dumps(records))
    _same_requests(TA.trace_requests(records, vocab_size=80, seed=seed),
                   JA.trace_requests(records, vocab_size=80, seed=seed))
    _same_requests(TA.load_trace(str(path), vocab_size=80),
                   JA.load_trace(str(path), vocab_size=80))


# ----------------------------------------------------------------------
# the whole CLI, JAX in a subprocess on four emulated host devices
# ----------------------------------------------------------------------
JAX_BODY = FLATTEN_SRC + SAMPLING_RECORD_SRC + '''
import json, os, sys
import jax
from repro.launch import serve as S
from repro.serve import ServeEngine
from repro.serve.sampling import sample_tokens
made = []
init = ServeEngine.__init__


def recording_init(self, model, params, ecfg, **kw):
    init(self, model, params, ecfg, **kw)
    top_k = min(ecfg.top_k, model.cfg.padded_vocab)
    width = top_k if top_k > 0 else model.cfg.padded_vocab
    G = model.mesh_shape.sizes.get("model", 1)
    draws = (make_skew_draws(model.cfg, model, G)
             if model.cfg.is_moe and model.cfg.moe.router_skew > 0
             else None)
    made.append((record_sampling(self, width, draws), params))


ServeEngine.__init__ = recording_init
out = {}
for name, argv in CELLS.items():
    sys.argv = ["serve"] + argv + ["--out", os.path.join(DIR, name + ".json")]
    n0 = len(made)
    S.main()
    rec, params = made[-1]
    for other, _ in made[n0:-1]:        # a fleet's other engines
        rec["streams"].update(other["streams"])
    out.update(flatten(jax.device_get(params), name + "/params/"))
    out[name + "/rec"] = np.array(json.dumps(rec))
np.savez(OUT, **out)
'''


def _argv(cell, tmp):
    return BASE + [a.format(dir=tmp) for a in CELLS[cell]]


@pytest.fixture(scope="module")
def jax_cli(tmp_path_factory):
    """The JAX CLI's cells, in three subprocesses side by side."""
    tmp = tmp_path_factory.mktemp("cli")
    (tmp / "trace.json").write_text(json.dumps(TRACE))
    names = list(CELLS)
    bodies = [f"CELLS = { {n: _argv(n, tmp) for n in names[i::3]}!r}\n"
              f"DIR = {str(tmp)!r}\n" + JAX_BODY for i in range(3)]
    flat = run_jax_side_by_side(bodies, tmp, devices=4, timeout=900)
    return tmp, flat


def _key_paths(tree, path=()):
    """Every key path of a report: dict keys, and the keys of the dicts in
    its lists (one list element stands for all)."""
    out = set()
    if isinstance(tree, dict):
        for k, v in tree.items():
            out.add(path + (k,))
            out |= _key_paths(v, path + (k,))
    elif isinstance(tree, list):
        for v in tree:
            out |= _key_paths(v, path + ("[]",))
    return out


@pytest.mark.parametrize("cell", list(CELLS))
def test_cli_streams_and_report_schema_equal_jax(jax_cli, cell, monkeypatch):
    tmp, flat = jax_cli
    rec = json.loads(str(flat[cell + "/rec"]))
    with open(tmp / f"{cell}.json") as f:
        jrep = json.load(f)
    predraw, draw_noise = keyed_replay(rec)
    monkeypatch.setattr(TSC.StepCore, "_predraw", predraw)
    monkeypatch.setattr(TSC.StepCore, "_draw_noise", draw_noise)
    streams = {}
    finish = TE.ServeEngine._finish

    def recording_finish(self, st, now):
        streams[str(st.req.rid)] = [int(t) for t in st.output]
        finish(self, st, now)
    monkeypatch.setattr(TE.ServeEngine, "_finish", recording_finish)
    args = TCLI.build_parser().parse_args(_argv(cell, tmp))
    params = to_torch(unflatten(flat, f"{cell}/params"), device="cpu")
    rep = TCLI.serve(args, device="cpu", params=params)
    assert streams == rec["streams"]
    if cell.startswith("fleet"):
        fl, jfl = rep["fleet"], jrep["fleet"]
        assert _key_paths(fl) == _key_paths(jfl)
        for key in ("decisions", "per_replica"):
            assert fl["routing"][key] == jfl["routing"][key], key
        for key in ("moved", "pending"):
            assert fl["handoffs"][key] == jfl["handoffs"][key], key
        assert fl["aggregate"]["n_requests"] \
            == jfl["aggregate"]["n_requests"] == len(streams)
        assert [r["routed"] for r in fl["replicas"]] \
            == [r["routed"] for r in jfl["replicas"]]
        for mine, theirs in zip(rep["replica_reports"],
                                jrep["replica_reports"]):
            assert _key_paths(mine) - _key_paths(theirs) == PORT_ONLY
            assert _key_paths(theirs) - _key_paths(mine) == set()
            assert mine["recompiled_after_warmup"] is False
        if cell == "fleet_disagg":
            assert fl["handoffs"]["moved"] == len(streams)
            assert [r["n_requests"] for r in fl["replicas"]] \
                == [0, len(streams)]
        return
    assert len(streams) == rep["n_requests"] == jrep["n_requests"]
    if cell == "g1_trace":
        assert sorted(len(v) for v in streams.values()) == [3, 4, 6]
    if cell == "mixtral_ring":
        assert rep["state_pool"] == {**jrep["state_pool"]}
        assert rep["state_pool"]["window_ring"]
        assert rep["state_pool"]["ring_full_chain"]
    if cell == "g1_prefix":
        for key in ("prefix_hit_rate", "cow_copies", "evictions",
                    "resume_cached_tokens"):
            assert rep[key] == jrep[key], key
        assert rep["prefix_hit_rate"] > 0
        assert [r["cached_prefix_tokens"] for r in rep["requests"]] \
            == [r["cached_prefix_tokens"] for r in jrep["requests"]]
        assert rep["phases"].keys() == jrep["phases"].keys()
    if cell == "g1_speculative":
        assert rep["speculative"] == jrep["speculative"]
        assert rep["phases"]["verify"]["tokens"] \
            == jrep["phases"]["verify"]["tokens"]
    if "--temperature" in CELLS[cell]:
        assert rec["noise"]
    if "--skew" in CELLS[cell]:
        assert rec["draws"]["decode"]
    mine, theirs = _key_paths(rep), _key_paths(jrep)
    assert mine - theirs == PORT_ONLY
    assert theirs - mine == set()
    assert rep["jit_entries"].keys() == jrep["jit_entries"].keys()
    for key in ("decode_steps", "prefill_chunks", "preemptions",
                "max_occupancy", "total_new_tokens"):
        assert rep[key] == jrep[key], key
    if cell == "phi4_dense":
        assert "moe" not in rep and "load_balance" not in rep
        assert rep["state_pool"] == jrep["state_pool"]
    if cell in ("mamba2", "zamba2"):
        assert rep["state_pool"] == jrep["state_pool"]
        assert rep["state_pool"]["kind"] == "slot"
        assert rep.get("attention_dispatch") \
            == jrep.get("attention_dispatch")
    assert ("attention_dispatch" in rep) == (cell != "mamba2")
    if cell != "mamba2":
        assert rep["attention_dispatch"].keys() \
            == jrep["attention_dispatch"].keys()
    assert rep.get("attention_fallbacks") == jrep.get("attention_fallbacks")
    if "load_balance" in jrep:
        for phase, sec in jrep["load_balance"].items():
            for key, want in sec.items():
                np.testing.assert_allclose(rep["load_balance"][phase][key],
                                           want, err_msg=f"{phase} {key}")
