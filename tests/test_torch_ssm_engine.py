"""SSM and hybrid serving through the slotted state store: every case of
``tests/test_serve_ssm.py`` on reduced mamba2-2.7b and zamba2-7b, run by
the port's ``ServeEngine`` and by the JAX engine (one subprocess a
family, side by side) on the same weights, converted from JAX.  Each
case is one piece of source text that both sides run (``CASES_SRC``):
greedy streams equal to the one-shot prefill + decode oracle on each side
and equal across the sides (partial final chunks included); the scratch
reset between two requests through one slot (``scratch_resets`` 2);
preemption resume token for token; no capture after warmup; the paged
pool refused with JAX's message word for word; the store's protocol
surface and ``stats()`` equal to JAX's; and the report's key paths,
``state_pool`` section, attention dispatch records and fallbacks equal
to the JAX report's (``engine.device`` is the port's own key)."""
import json

import numpy as np
import pytest
import torch

from repro_torch.configs import get_config
from repro_torch.convert import to_torch
from repro_torch.models.model import build_model
from repro_torch.serve import (EngineConfig, Request, ServeEngine,
                               VirtualClock, engine_config_for)
from repro_torch.serve.statestore import SlotStateStore, make_state_store

from _ep_helpers import FLATTEN_SRC, one_torch_thread, unflatten  # noqa: F401
from test_torch_prefix import run_jax_side_by_side

FAMILIES = {"mamba": "mamba2-2.7b", "zamba": "zamba2-7b"}

CASES_SRC = '''
L_MAX, GEN, CHUNK = 13, 6, 4          # 13 = 4 + 4 + 4 + 1: partial chunk


def prompts(vocab, lens, seed=3):
    rng = np.random.default_rng(seed)
    return [rng.integers(0, vocab, (n,)).astype(np.int32) for n in lens]


def captured(eng, reqs):
    out = {}
    orig = eng._finish

    def cap(st, now):
        out[str(st.req.rid)] = [int(t) for t in st.output]
        orig(st, now)
    eng._finish = cap
    return out, eng.run(reqs)


def key_paths(tree, path=()):
    out = set()
    if isinstance(tree, dict):
        for k, v in tree.items():
            out.add(path + (k,))
            out |= key_paths(v, path + (k,))
    elif isinstance(tree, list):
        for v in tree:
            out |= key_paths(v, path + ("[]",))
    return out


def run_cases(api, family):
    R = api.Request
    res = {}
    eng = api.engine(2)
    ps = prompts(api.vocab, (13, 9, 7))
    out, rep = captured(eng, [R(rid=i, tokens=p, max_new_tokens=GEN)
                              for i, p in enumerate(ps)])
    res["one_shot"] = {
        "streams": out,
        "oracle": {str(i): api.oracle(p, eng.ecfg.max_seq_len)
                   for i, p in enumerate(ps)},
        "state_pool": rep["state_pool"],
        "keys": sorted("/".join(map(str, k)) for k in key_paths(rep)),
        "attention_dispatch": rep.get("attention_dispatch"),
        "attention_fallbacks": rep.get("attention_fallbacks"),
        "counts": [rep[k] for k in ("decode_steps", "prefill_chunks",
                                    "total_new_tokens")]}
    if family == "mamba":
        eng = api.engine(1)
        ps = prompts(api.vocab, (13, 11), seed=7)
        out, rep = captured(eng, [R(rid=i, tokens=p, max_new_tokens=GEN)
                                  for i, p in enumerate(ps)])
        res["reset"] = {
            "streams": out,
            "oracle": {str(i): api.oracle(p, eng.ecfg.max_seq_len)
                       for i, p in enumerate(ps)},
            "scratch_resets": rep["state_pool"]["scratch_resets"]}
    [prompt] = prompts(api.vocab, (13,), seed=11)
    base, _ = captured(api.engine(2),
                       [R(rid=0, tokens=prompt, max_new_tokens=GEN)])
    eng2 = api.engine(2)
    outputs = {}
    orig = eng2._finish

    def cap(st, now):
        outputs[str(st.req.rid)] = [int(t) for t in st.output]
        orig(st, now)
    eng2._finish = cap
    eng2.submit(R(rid=0, tokens=prompt, max_new_tokens=GEN))
    preempted = False
    while eng2.has_work():
        eng2.step(eng2.clock.now())
        if not preempted and eng2.active.any():
            s = int(np.nonzero(eng2.active)[0][0])
            st = api.slots(eng2)[s]
            if st is not None and len(st.output) >= 3:
                eng2._preempt(st)
                preempted = True
    res["preempt"] = {"base": base["0"], "resumed": outputs["0"],
                      "preempted": preempted,
                      "preemptions": eng2.metrics.preemptions,
                      "pool": eng2.report()["state_pool"]["preemptions"]}
    eng = api.engine(2)
    eng.warmup()
    ps = prompts(api.vocab, (13, 9, 11, 7), seed=5)
    rep = eng.run([R(rid=i, tokens=p, max_new_tokens=GEN)
                   for i, p in enumerate(ps)])
    res["warm"] = {"recompiled": rep["recompiled_after_warmup"],
                   "entries": sorted(rep["jit_entries"])}
    try:
        api.engine(2, paged=True)
    except ValueError as e:
        res["paged_refusal"] = str(e)
    store = api.store()
    res["store"] = {"kv_capacity": store.kv_capacity, "stats": store.stats(),
                    "paged": store.paged, "sharing": store.sharing}
    return res
'''
exec(CASES_SRC)

JAX_BODY = FLATTEN_SRC + CASES_SRC + '''
import json
import jax, jax.numpy as jnp
from repro.configs import get_config
from repro.configs.base import ParallelConfig
from repro.models.model import build_model
from repro.serve import (EngineConfig, Request, ServeEngine, VirtualClock,
                         engine_config_for, make_state_store)


class _null_ctx:
    def __enter__(self):
        return self

    def __exit__(self, *a):
        return False


class JaxAPI:
    Request = Request

    def __init__(self, arch):
        self.cfg = get_config(arch).reduced()
        self.vocab = self.cfg.vocab_size
        self.model = build_model(self.cfg, ParallelConfig(attn_chunk=8,
                                                          loss_chunk=8),
                                 batch=1, seq_len=L_MAX)
        self.params = self.model.init(jax.random.PRNGKey(0))

    def engine(self, slots, paged=False):
        if paged:
            ecfg = EngineConfig(max_slots=2, max_seq_len=32,
                                prefill_chunk=4, paged=True)
        else:
            ecfg = engine_config_for(self.cfg, max_slots=slots,
                                     prompt_len=L_MAX, max_new_tokens=GEN,
                                     prefill_chunk=CHUNK)
        return ServeEngine(self.model, self.params, ecfg,
                           clock=VirtualClock(0.5))

    def oracle(self, prompt, s_max):
        logits, caches, pos, _ = self.model.prefill(
            self.params, {"tokens": jnp.asarray(np.asarray(prompt)[None])},
            s_max=s_max)
        out = [int(jnp.argmax(logits, -1)[0])]
        tok = jnp.argmax(logits, -1)[:, None].astype(jnp.int32)
        for _ in range(GEN - 1):
            logits, caches, pos, _ = self.model.decode_step(
                self.params, tok, caches, pos)
            tok = jnp.argmax(logits, -1)[:, None].astype(jnp.int32)
            out.append(int(tok[0, 0]))
        return out

    def slots(self, eng):
        return eng.state_by_slot

    def store(self):
        return make_state_store(self.model, EngineConfig(
            max_slots=2, max_seq_len=32, prefill_chunk=4), s_pad=32,
            ctx=_null_ctx)


api = JaxAPI(ARCH)
out = flatten(jax.device_get(api.params), "params/")
out["res"] = np.array(json.dumps(run_cases(api, FAMILY)))
np.savez(OUT, **{FAMILY + "/" + k: v for k, v in out.items()})
'''


class PortAPI:
    Request = Request

    def __init__(self, arch, params):
        self.cfg = get_config(arch).reduced()
        self.vocab = self.cfg.vocab_size
        self.model = build_model(self.cfg, batch=1, seq_len=L_MAX,
                                 device="cpu")
        self.params = params

    def engine(self, slots, paged=False):
        if paged:
            ecfg = EngineConfig(max_slots=2, max_seq_len=32,
                                prefill_chunk=4, paged=True)
        else:
            ecfg = engine_config_for(self.cfg, max_slots=slots,
                                     prompt_len=L_MAX, max_new_tokens=GEN,
                                     prefill_chunk=CHUNK)
        return ServeEngine(self.model, self.params, ecfg,
                           clock=VirtualClock(0.5), device="cpu")

    def oracle(self, prompt, s_max):
        logits, caches, pos, _ = self.model.prefill(
            self.params, {"tokens": torch.from_numpy(prompt)[None]},
            s_max=s_max)
        tok = logits.argmax(-1)[:, None].to(torch.int32)
        out = [int(tok[0, 0])]
        for _ in range(GEN - 1):
            logits, caches, pos, _ = self.model.decode_step(
                self.params, tok, caches, pos)
            tok = logits.argmax(-1)[:, None].to(torch.int32)
            out.append(int(tok[0, 0]))
        return out

    def slots(self, eng):
        return eng.front.state_by_slot

    def store(self):
        return make_state_store(self.model, EngineConfig(
            max_slots=2, max_seq_len=32, prefill_chunk=4), s_pad=32)


@pytest.fixture(scope="module")
def sides(tmp_path_factory):
    """Both families' JAX runs side by side, then the port's on JAX's
    weights: {family: (port results, JAX results, port api)}."""
    bodies = [f"ARCH = {arch!r}\nFAMILY = {fam!r}\n" + JAX_BODY
              for fam, arch in FAMILIES.items()]
    flat = run_jax_side_by_side(bodies, tmp_path_factory.mktemp("ssm"))
    out = {}
    for fam, arch in FAMILIES.items():
        params = to_torch(unflatten(flat, f"{fam}/params"), device="cpu")
        api = PortAPI(arch, params)
        mine = json.loads(json.dumps(run_cases(api, fam)))
        out[fam] = (mine, json.loads(str(flat[f"{fam}/res"])), api)
    return out


@pytest.mark.parametrize("family", list(FAMILIES))
def test_engine_matches_one_shot(sides, family):
    """Chunked prefill + slotted decode == one-shot, token for token, on
    each side, and the port's streams equal the JAX engine's."""
    mine, theirs, api = sides[family]
    m, t = mine["one_shot"], theirs["one_shot"]
    assert m["streams"] == m["oracle"]
    assert t["streams"] == t["oracle"]
    assert m["streams"] == t["streams"]
    assert m["state_pool"] == t["state_pool"]
    assert m["state_pool"]["kind"] == "slot"
    assert m["counts"] == t["counts"]
    assert isinstance(api.engine(2).kv, SlotStateStore)


@pytest.mark.parametrize("family", list(FAMILIES))
def test_report_schema_and_attention_dispatch_equal_jax(sides, family):
    """Every key path of the JAX report, and the attention dispatch the
    JAX report reads for this path: the hybrid's attention is the plain
    branch (requested False, JAX's reasons), mamba2 has none."""
    mine, theirs, _ = sides[family]
    m, t = mine["one_shot"], theirs["one_shot"]
    assert set(m["keys"]) - set(t["keys"]) == {"engine/device"}
    assert set(t["keys"]) - set(m["keys"]) == set()
    assert m["attention_dispatch"] == t["attention_dispatch"]
    assert m["attention_fallbacks"] == t["attention_fallbacks"]
    if family == "zamba":
        assert set(m["attention_dispatch"]) == {"prefill_continue",
                                                "decode_slab"}
        assert not any(r["requested"] or r["fused"]
                       for r in m["attention_dispatch"].values())
    else:
        assert m["attention_dispatch"] is None


def test_scratch_reset_between_requests(sides):
    """Two requests through ONE slot, back to back: the second stream
    matches its solo oracle, one reset a prefill pickup."""
    mine, theirs, _ = sides["mamba"]
    m, t = mine["reset"], theirs["reset"]
    assert m["streams"] == m["oracle"] == t["streams"]
    assert m["scratch_resets"] == t["scratch_resets"] == 2


@pytest.mark.parametrize("family", list(FAMILIES))
def test_preemption_resume_token_exact(sides, family):
    mine, theirs, _ = sides[family]
    m, t = mine["preempt"], theirs["preempt"]
    assert m["preempted"] and m["preemptions"] == 1 and m["pool"] == 1
    assert m["resumed"] == m["base"] == t["resumed"] == t["base"]


@pytest.mark.parametrize("family", list(FAMILIES))
def test_zero_post_warmup_recompiles(sides, family):
    mine, theirs, _ = sides[family]
    assert mine["warm"]["recompiled"] is False
    assert theirs["warm"]["recompiled"] is False
    assert mine["warm"]["entries"] == theirs["warm"]["entries"] \
        == ["decode", "prefill_chunk", "write_slot"]


@pytest.mark.parametrize("family", list(FAMILIES))
def test_paged_rejected_for_recurrent_state(sides, family):
    mine, theirs, _ = sides[family]
    assert "recurrent" in mine["paged_refusal"]
    assert mine["paged_refusal"] == theirs["paged_refusal"]


def test_slot_store_protocol_surface(sides):
    mine, theirs, api = sides["mamba"]
    assert mine["store"] == theirs["store"]
    store = api.store()
    assert isinstance(store, SlotStateStore)
    assert not store.paged and not store.sharing
    assert store.kv_capacity == 32                 # no KV-length axis
    assert store.plan([1, 2, 3], resumed=False) == (0, [], 0, False)
    assert store.can_admit((0, [], 0, False))
    store.release(rid=0, slot=0)                   # no-op, must not raise
    assert store.probe_prefix([1, 2, 3]) == 0
    with pytest.raises(RuntimeError):
        store.bt_row(0)
    with pytest.raises(NotImplementedError):
        store.export_kv(8)
    with pytest.raises(NotImplementedError):
        store.import_kv([], 8, None)
    stats = store.stats()
    assert stats["kind"] == "slot" and stats["slots"] == 2
    assert stats["pool_bytes"] > 0 and stats["state_bytes_per_slot"] > 0
    assert store.jit_counts() == {"write_slot": 0}     # eager on the CPU
