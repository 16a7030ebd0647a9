"""The port's engine roles and fleet (``serve/fleet.py``, the prefill and
decode roles, ``HandoffRecord``) against the JAX package's, on reduced
qwen15-moe-a27b (f32, paged, 4-token blocks, 4-token chunks; the port's
``build_model`` refuses the JAX test's dense ``TINY``).

Every case of ``tests/test_serve_fleet.py`` is mirrored:

* the router units on stub engines (load, ties to the lowest index,
  prefix affinity beating load, round robin, assignment, validation) run
  through JAX's ``FleetRouter`` and the port's, which must decide alike;
* engine-role validation, word for word; the seeded sub-streams
  (``split_seeds``, ``merge_requests``) equal to JAX's;
* ``HandoffRecord``'s npz round trip for bf16 and f32, and across the two
  frameworks (a JAX blob loads in the port and the reverse, bit for bit,
  with the same ``nbytes``);
* the engine cases, written once (``FLEET_SRC``) and driven through the
  JAX engines in subprocesses side by side (``test_torch_prefix``'s
  machinery: their converted weights come back with the results) and the
  port's here, on the same weights: a one-replica fleet equal to the bare
  engine in tokens and timestamps on a ``VirtualClock``; disaggregated
  equal to unified for the plain, prefix and speculative variants at
  G = 1 and on four ranks (learned routes); a decode role that refuses
  ``submit``; a fixed assignment giving the same streams under every
  policy; no capture again after warmup.  Each port case equals JAX's in
  its streams, routing decisions, every replica's ``load_stats`` after
  each tick and the ``fleet`` section's counters and timestamps.

And the port's own: a JAX prefill engine's records imported by a port
decode engine give JAX's unified streams, with the pool holding the
record's K/V bit for bit, and a port prefill engine's records imported by
a JAX decode engine (a second JAX subprocess) give them too; an import
into a decode engine whose preempted request is partway through its
recompute leaves that recompute alone (streams equal JAX's and the
unified engine's); and the import's captured write never syncs the host
(``HostSyncGuard``) and is position independent (``OpRecorder``)."""
import json

import numpy as np
import pytest
import torch

from repro.serve import FleetRouter as JFleetRouter
from repro.serve import HandoffRecord as JHandoffRecord
from repro.serve import VirtualClock as JClock
from repro.serve import engine_config_for as jax_ecfg
from repro.serve.arrivals import AdmissionQueue as JQueue
from repro_torch.configs.qwen15_moe_a27b import CONFIG as TORCH_QWEN
from repro_torch.convert import to_torch
from repro_torch.models.model import build_model
from repro_torch.serve import (FleetRouter, HandoffRecord, Request,
                               ServeEngine, VirtualClock, engine_config_for,
                               poisson_requests)
from repro_torch.serve import paging as TP
from repro_torch.serve.arrivals import AdmissionQueue

from _ep_helpers import FLATTEN_SRC, one_torch_thread, unflatten  # noqa: F401
from test_torch_capture import HostSyncGuard
from test_torch_prefill_capture import OpRecorder
from test_torch_prefix import run_jax_side_by_side

# the engine cases, as source text: the JAX subprocesses run them on their
# engines, the tests on the port's; ``api`` builds engines and runs them
FLEET_SRC = '''
import numpy as np


def streams(out):
    return {str(k): [int(t) for t in v] for k, v in out.items()}


def fleet_summary(rep):
    """What a case compares of a fleet report (timestamps included: both
    sides run on a VirtualClock, call for call)."""
    fl = rep["fleet"]
    agg = fl["aggregate"]
    return {
        "ticks": fl["ticks"], "disaggregated": fl["disaggregated"],
        "routing": fl["routing"], "handoffs": fl["handoffs"],
        "replicas": [{k: r[k] for k in ("index", "role", "n_requests",
                                         "steps", "routed", "handoffs",
                                         "ttft", "e2e")}
                     for r in fl["replicas"]],
        "aggregate": {k: agg[k] for k in (
            "n_requests", "total_new_tokens", "preemptions",
            "prefix_hit_rate", "ttft", "e2e", "queue_delay")},
        "rows": [sorted([r["rid"], r["ttft"], r["e2e"],
                         r["cached_prefix_tokens"]]
                        for r in rr["requests"])
                 for rr in rep["replica_reports"]],
        "jit_keys": [sorted(rr["jit_entries"])
                     for rr in rep["replica_reports"]],
    }


def fleet_run(api, fleet, reqs):
    """Serve ``reqs`` through ``fleet``: the streams, the report and every
    replica's load_stats after each tick."""
    outputs, loads = {}, []
    for eng in fleet.engines:
        def capture(st, now, orig=eng._finish):
            outputs[st.req.rid] = list(st.output)
            orig(st, now)
        eng._finish = capture
    tick = fleet.tick

    def recorded():
        did = tick()
        loads.append([e.load_stats() for e in fleet.engines])
        return did
    fleet.tick = recorded
    rep = api.under_mesh(lambda: fleet.run(reqs))
    return outputs, rep, loads


def reqs_of(api, n, L, gen, seed, shared=0):
    return api.poisson_requests(n, rate=2.0, vocab_size=api.vocab,
                                prompt_len=L, max_new_tokens=gen, seed=seed,
                                shared_prefix_len=shared)


def case_single_replica(api):
    L, gen = 10, 5
    kw = dict(slots=2, prompt_len=L, max_new=gen, chunk=4)
    bare = api.engine(clock=api.Clock(0.5), **kw)
    want, bare_rep = api.run(bare, reqs_of(api, 5, L, gen, 7))
    eng = api.engine(clock=api.Clock(0.5), **kw)
    got, rep, loads = fleet_run(api, api.Router([eng], policy="load"),
                                reqs_of(api, 5, L, gen, 7))
    return dict(want=streams(want), got=streams(got),
                bare_rows=sorted([r["rid"], r["ttft"], r["e2e"]]
                                 for r in bare_rep["requests"]),
                bare_ttft_p50=bare_rep["ttft"]["p50"],
                bare_n=bare_rep["n_requests"],
                fleet=fleet_summary(rep), loads=loads)


def disagg(api, variant):
    L, gen = 10, 6
    base = dict(slots=2, prompt_len=L, max_new=gen, chunk=4)
    sharing = variant == "prefix"
    spec_k = 4 if variant == "spec" else 0
    reqs = lambda: reqs_of(api, 6, L, gen, 11, 8 if sharing else 0)
    uni = api.engine(clock=api.Clock(0.5), prefix_sharing=sharing, **base)
    want, _ = api.run(uni, reqs())
    clock = api.Clock(0.5)
    pf = api.engine(clock=clock, role="prefill", prefix_sharing=sharing,
                    **base)
    dec = api.engine(clock=clock, role="decode", prefix_sharing=sharing,
                     speculative_k=spec_k, **base)
    fleet = api.Router([pf, dec], policy="load")
    # the JAX decode role at G = 4 needs its entries compiled before its
    # first step (its first decode call, unwarmed, meets uncommitted
    # weights): both sides warm up
    api.under_mesh(fleet.warmup)
    got, rep, loads = fleet_run(api, fleet, reqs())
    return dict(want=streams(want), got=streams(got),
                disaggregated=fleet.disaggregated,
                fleet=fleet_summary(rep), loads=loads)


def case_disagg_plain(api):
    return disagg(api, "plain")


def case_disagg_prefix(api):
    return disagg(api, "prefix")


def case_disagg_spec(api):
    return disagg(api, "spec")


case_disagg_plain_g4 = case_disagg_plain
case_disagg_prefix_g4 = case_disagg_prefix
case_disagg_spec_g4 = case_disagg_spec


def case_decode_rejects_submit(api):
    dec = api.engine(clock=api.Clock(0.5), slots=1, prompt_len=8,
                     max_new=4, chunk=4, role="decode")
    try:
        dec.submit(api.Request(rid=0, tokens=np.arange(8, dtype=np.int32)
                               % 7, max_new_tokens=4))
    except ValueError as e:
        return dict(error=str(e))
    return dict(error=None)


def case_fixed_assignment(api):
    L, gen = 10, 5
    kw = dict(slots=2, prompt_len=L, max_new=gen, chunk=4,
              prefix_sharing=True)

    def run(policy, assignment=None):
        clock = api.Clock(0.5)
        engines = [api.engine(clock=clock, **kw) for _ in range(2)]
        fleet = api.Router(engines, policy=policy, assignment=assignment)
        outs, rep, loads = fleet_run(api, fleet,
                                     reqs_of(api, 6, L, gen, 5, 8))
        placed = {d["rid"]: d["replica"]
                  for d in rep["fleet"]["routing"]["decisions"]}
        return dict(out=streams(outs), placed=placed,
                    fleet=fleet_summary(rep), loads=loads)
    res = {"load": run("load")}
    placed = res["load"]["placed"]
    for policy in ("prefix_affinity", "round_robin"):
        res[policy] = run(policy, assignment=placed)
    for r in res.values():
        r["placed"] = {str(k): v for k, v in r["placed"].items()}
    return res


def case_zero_recompiles(api):
    L, gen = 10, 5
    clock = api.Clock(0.5)
    engines = [api.engine(clock=clock, slots=2, prompt_len=L, max_new=gen,
                          chunk=4, prefix_sharing=True) for _ in range(2)]
    fleet = api.Router(engines, policy="prefix_affinity")
    api.under_mesh(fleet.warmup)
    out, rep, loads = fleet_run(api, fleet, reqs_of(api, 6, L, gen, 3, 8))
    return dict(out=streams(out), fleet=fleet_summary(rep), loads=loads,
                recompiled=[rr["recompiled_after_warmup"]
                            for rr in rep["replica_reports"]])


def mid_recompute_requests(api):
    rng = np.random.default_rng(21)
    return [api.Request(rid=i, tokens=rng.integers(
        0, api.vocab, (n,)).astype(np.int32), max_new_tokens=8)
        for i, n in enumerate((12, 11, 10))]


def case_import_mid_recompute(api):
    """Requests 0 and 1 are prefilled on the prefill engine and imported
    into the decode engine; request 1 is preempted there after two decode
    steps, and its recompute (4 chunks) is one chunk in when request 2's
    record is imported."""
    kw = dict(slots=3, prompt_len=12, max_new=8, chunk=4)
    uni = api.engine(clock=api.Clock(0.5), **kw)
    want, _ = api.run(uni, mid_recompute_requests(api))
    clock = api.Clock(0.5)
    pf = api.engine(clock=clock, role="prefill", **kw)
    dec = api.engine(clock=clock, role="decode", **kw)
    outputs = {}

    def capture(st, now, orig=dec._finish):
        outputs[st.req.rid] = list(st.output)
        orig(st, now)
    dec._finish = capture
    r0, r1, r2 = mid_recompute_requests(api)
    recs = []

    def until(n):
        while len(recs) < n:
            api.under_mesh(pf.step)
            recs.extend(pf.pop_handoffs())
    pf.submit(r0)
    pf.submit(r1)
    until(2)
    for rec in recs[:2]:
        assert dec.import_handoff(rec)
    api.under_mesh(dec.step)
    api.under_mesh(dec.step)
    victim = next(st for st in dec.front.state_by_slot
                  if st is not None and st.req.rid == 1)
    dec._preempt(victim)
    api.under_mesh(dec.step)          # admits it, runs one chunk
    st = dec.front.pf
    mid = dict(rid=st.req.rid, pos=int(st.prefill_pos),
               len=int(st.prefill_len))
    pf.submit(r2)
    until(3)
    imported = dec.import_handoff(recs[2])
    while dec.has_work():
        api.under_mesh(dec.step)
    return dict(want=streams(want), got=streams(outputs), mid=mid,
                imported=imported,
                preemptions=dec.report()["preemptions"])
'''

# the JAX side: one subprocess runs a group of the cases on its engines
JAX_BODY = FLATTEN_SRC + '''
import dataclasses
import json
import jax
jax.config.update("jax_compilation_cache_dir", CACHE)
jax.config.update("jax_persistent_cache_min_compile_time_secs", 0)
from repro.configs.base import ParallelConfig
from repro.configs.qwen15_moe_a27b import CONFIG
from repro.launch.mesh import make_host_mesh
from repro.models.model import MeshShape, build_model
from repro.serve import (FleetRouter, HandoffRecord, Request, ServeEngine,
                         VirtualClock, engine_config_for, poisson_requests)


class API:
    Request = staticmethod(Request)
    poisson_requests = staticmethod(poisson_requests)
    Clock = VirtualClock
    Router = FleetRouter

    def __init__(self, G):
        cfg = CONFIG.reduced()
        if G > 1:
            cfg = dataclasses.replace(cfg, moe=dataclasses.replace(
                cfg.moe, q_tokens=1))
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

    def engine(self, *, slots, prompt_len, max_new, chunk, clock, bs=4,
               **kw):
        ecfg = engine_config_for(self.cfg, max_slots=slots,
                                 prompt_len=prompt_len,
                                 max_new_tokens=max_new,
                                 prefill_chunk=chunk, paged=True,
                                 kv_block_size=bs, **kw)
        return ServeEngine(self.model(slots, prompt_len), self.params, ecfg,
                           mesh=self.mesh, clock=clock)

    def under_mesh(self, fn):
        with self.mesh:
            return fn()

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


def case_xf_export(api):
    """JAX's records for the cross-framework cases: a prefill engine's
    exports of three requests as npz blobs, and a unified engine's
    streams of them."""
    kw = dict(slots=3, prompt_len=12, max_new=8, chunk=4)
    want, _ = api.run(api.engine(clock=api.Clock(0.5), **kw),
                      mid_recompute_requests(api))
    pf = api.engine(clock=api.Clock(0.5), role="prefill", **kw)
    for r in mid_recompute_requests(api):
        pf.submit(r)
    recs = []
    while len(recs) < 3:
        api.under_mesh(pf.step)
        recs.extend(pf.pop_handoffs())
    return dict(want=streams(want),
                blobs=[rec.to_npz_bytes().hex() for rec in recs])


def case_xf_import(api):
    """The port's records (npz files beside this run) imported by a JAX
    decode engine."""
    kw = dict(slots=3, prompt_len=12, max_new=8, chunk=4)
    api.model(3, 12)
    dec = api.engine(clock=api.Clock(0.5), role="decode", **kw)
    outputs = {}

    def capture(st, now, orig=dec._finish):
        outputs[st.req.rid] = list(st.output)
        orig(st, now)
    dec._finish = capture
    with open(PORT_BLOBS) as f:
        blobs = json.load(f)
    for blob in blobs:
        assert dec.import_handoff(HandoffRecord.from_npz_bytes(
            bytes.fromhex(blob)))
    while dec.has_work():
        api.under_mesh(dec.step)
    return dict(got=streams(outputs))


out = {}
apis = {}
for name, G in CASE_G.items():
    if G not in apis:
        apis[G] = API(G)
    out[name] = np.array(json.dumps(globals()["case_" + name](apis[G])))
for G, api in apis.items():
    if api.params is not None:
        out.update(flatten(jax.device_get(api.params), f"params{G}/"))
np.savez(OUT, **out)
'''

CASE_G = {"single_replica": 1, "disagg_plain": 1, "disagg_prefix": 1,
          "disagg_spec": 1, "decode_rejects_submit": 1,
          "fixed_assignment": 1, "zero_recompiles": 1,
          "import_mid_recompute": 1, "xf_export": 1,
          "disagg_plain_g4": 4, "disagg_prefix_g4": 4,
          "disagg_spec_g4": 4}
GROUPS = [["disagg_plain_g4", "disagg_prefix_g4"],
          ["disagg_spec_g4", "decode_rejects_submit"],
          ["disagg_plain", "disagg_prefix", "disagg_spec"],
          ["single_replica", "fixed_assignment"],
          ["zero_recompiles", "import_mid_recompute", "xf_export"]]
# the subprocess whose XLA cache the reverse import reuses
XF_GROUP = next(i for i, g in enumerate(GROUPS) if "xf_export" in g)


def jax_fleet_cases(tmp, case_g, groups, *, port_blobs=(), cache=None):
    """Run the cases named in ``case_g`` ({name: EP degree}) on JAX
    engines, one subprocess a group of ``groups``, side by side (all on
    ``cache``'s XLA cache when given); returns ({name: result}, the npz
    entries)."""
    tmp.mkdir(parents=True, exist_ok=True)
    blobs = tmp / "port_blobs.json"
    blobs.write_text(json.dumps(list(port_blobs)))
    bodies = [f"CASE_G = {({n: case_g[n] for n in group})!r}\n"
              f"CACHE = {str(cache or tmp / f'xla{i}')!r}\n"
              f"PORT_BLOBS = {str(blobs)!r}\n" + FLEET_SRC + JAX_BODY
              for i, group in enumerate(groups)]
    flat = run_jax_side_by_side(bodies, tmp, devices=4, timeout=900)
    return {n: json.loads(str(flat[n])) for n in case_g}, flat


@pytest.fixture(scope="module")
def jax_fleet(tmp_path_factory):
    """The JAX engines' results by case, the JAX weights converted by EP
    degree, and the working directory (whose ``xla{XF_GROUP}`` cache the
    cross-framework case compiled into)."""
    tmp = tmp_path_factory.mktemp("fleet")
    results, flat = jax_fleet_cases(tmp, CASE_G, GROUPS)
    params = {G: to_torch(unflatten(flat, f"params{G}"), device="cpu")
              for G in set(CASE_G.values())}
    return results, params, tmp


exec(FLEET_SRC)


class PortAPI:
    """The port's side of ``FLEET_SRC``: engines on the JAX weights."""
    Request = staticmethod(Request)
    poisson_requests = staticmethod(poisson_requests)
    Clock = VirtualClock
    Router = FleetRouter

    def __init__(self, params, G=1):
        import dataclasses
        cfg = TORCH_QWEN.reduced()
        if G > 1:
            cfg = dataclasses.replace(cfg, moe=dataclasses.replace(
                cfg.moe, q_tokens=1))
        self.cfg, self.G, self.params = cfg, G, params
        self.vocab = cfg.vocab_size
        self.models = {}
        self.engines = []

    def engine(self, *, slots, prompt_len, max_new, chunk, clock, bs=4,
               **kw):
        key = (slots, prompt_len)
        if key not in self.models:
            self.models[key] = build_model(self.cfg, batch=slots,
                                           seq_len=prompt_len, device="cpu",
                                           ep_degree=self.G)
        ecfg = engine_config_for(self.cfg, max_slots=slots,
                                 prompt_len=prompt_len,
                                 max_new_tokens=max_new,
                                 prefill_chunk=chunk, paged=True,
                                 kv_block_size=bs, **kw)
        eng = ServeEngine(self.models[key], self.params, ecfg, clock=clock,
                          device="cpu")
        self.engines.append(eng)
        return eng

    @staticmethod
    def under_mesh(fn):
        return fn()

    def run(self, eng, reqs):
        outputs = {}
        orig = eng._finish

        def capture(st, now):
            outputs[st.req.rid] = list(st.output)
            orig(st, now)
        eng._finish = capture
        return outputs, eng.run(reqs)


def _case(name, jax_fleet, G=1):
    """A case on the port's engines against the JAX engines' result."""
    results, params, _ = jax_fleet
    api = PortAPI(params[G], G=G)
    got = json.loads(json.dumps(globals()["case_" + name](api)))
    assert got == results[name]
    return got, api


# ----------------------------------------------------------------------
# router units (stub engines: no model, no device), JAX's router and the
# port's deciding alike
# ----------------------------------------------------------------------
class _StubEngine:
    def __init__(self, clock, queue_cls, *, role="unified", load=0,
                 prefix=0):
        self.role = role
        self.clock = clock
        self._load = load
        self._prefix = prefix
        self.queue = queue_cls()
        self.submitted = []

    def load_stats(self):
        return {"queued_tokens": self._load, "kv_tokens": 0,
                "kv_utilization": 0.0, "active_slots": 0, "free_slots": 4,
                "pending_handoffs": 0}

    def probe_prefix(self, tokens):
        return self._prefix

    def submit(self, req):
        self.submitted.append(req)


def _req(rid, n=8):
    return Request(rid=rid, tokens=np.arange(n, dtype=np.int32) % 7,
                   max_new_tokens=4)


SIDES = {"jax": (JFleetRouter, JClock, JQueue),
         "port": (FleetRouter, VirtualClock, AdmissionQueue)}


def _both(scenario):
    """``scenario(router_cls, stub)`` on JAX's router and the port's: the
    two results, which must be equal."""
    out = {}
    for side, (router, clock_cls, queue) in SIDES.items():
        clock = clock_cls()

        def stub(c=None, **kw):
            return _StubEngine(c or clock, queue, **kw)
        out[side] = scenario(router, stub)
    assert out["port"] == out["jax"]
    return out["port"]


def test_route_load_picks_least_loaded():
    def scenario(Router, stub):
        fleet = Router([stub(load=50), stub(load=10), stub(load=30)],
                       policy="load")
        return fleet._route(_req(0)), fleet._decisions
    idx, decisions = _both(scenario)
    assert idx == 1
    assert decisions == [{"rid": 0, "replica": 1, "policy": "load",
                          "matched_tokens": 0}]


def test_route_ties_break_to_lowest_index():
    def scenario(Router, stub):
        fleet = Router([stub(load=10), stub(load=10)], policy="load")
        fleet2 = Router([stub(load=5, prefix=8), stub(load=5, prefix=8)],
                        policy="prefix_affinity")
        return fleet._route(_req(0)), fleet2._route(_req(1))
    assert _both(scenario) == (0, 0)


def test_route_prefix_affinity_beats_load():
    """A big cached-prefix match outweighs a moderate load gap (and the
    hit is counted); with affinity_weight 0 the same fleet routes by load
    alone."""
    def scenario(Router, stub):
        fleet = Router([stub(load=10, prefix=0), stub(load=40, prefix=64)],
                       policy="prefix_affinity", affinity_weight=1.0)
        flat = Router([stub(load=10, prefix=0), stub(load=40, prefix=64)],
                      policy="prefix_affinity", affinity_weight=0.0)
        return (fleet._route(_req(0)), fleet._affinity_hits,
                fleet._affinity_hit_tokens, flat._route(_req(1)))
    assert _both(scenario) == (1, 1, 64, 0)


def test_route_round_robin_cycles():
    def scenario(Router, stub):
        fleet = Router([stub(), stub(), stub()], policy="round_robin")
        return [fleet._route(_req(i)) for i in range(6)]
    assert _both(scenario) == [0, 1, 2, 0, 1, 2]


def test_route_assignment_overrides_policy():
    def scenario(Router, stub):
        fleet = Router([stub(load=0), stub(load=999)], policy="load",
                       assignment={7: 1})
        return fleet._route(_req(7)), fleet._decisions[-1]["policy"]
    assert _both(scenario) == (1, "assignment")


@pytest.mark.parametrize("build,match", [
    (lambda R, stub: R([]), "at least one engine"),
    (lambda R, stub: R([stub()], policy="nope"), "routing policy"),
    (lambda R, stub: R([stub(), stub(c=type(stub().clock)())]),
     "own clock"),
    (lambda R, stub: R([stub(role="decode")]), "no unified/prefill"),
    (lambda R, stub: R([stub(role="prefill")]), "no .*decode-role"),
    (lambda R, stub: R([stub()], affinity_weight=-1.0), "affinity_weight")],
    ids=["empty", "policy", "clock", "no_prefill", "no_decode", "weight"])
def test_router_validation(build, match):
    """Each refusal is JAX's ValueError, word for word."""
    def scenario(Router, stub):
        with pytest.raises(ValueError, match=match) as err:
            build(Router, stub)
        return str(err.value)
    _both(scenario)


def test_router_refuses_engines_across_processes():
    """A fleet of ``DistComm`` engines (lockstep on rank 0's clock) has no
    JAX counterpart: the port's router refuses it, naming the
    difference."""
    clock = VirtualClock()
    eng = _StubEngine(clock, AdmissionQueue)
    eng.dist = object()
    with pytest.raises(NotImplementedError, match="no lockstep fleet"):
        FleetRouter([eng])


def test_engine_role_config_validation():
    cfg = TORCH_QWEN.reduced()
    from repro.configs.qwen15_moe_a27b import CONFIG as JQWEN
    for kw, match in ((dict(role="verify", paged=True),
                       "unknown engine role"),
                      (dict(role="prefill"), "require EngineConfig.paged")):
        with pytest.raises(ValueError, match=match) as jerr:
            jax_ecfg(JQWEN.reduced(), max_slots=1, prompt_len=8,
                     max_new_tokens=4, **kw)
        with pytest.raises(ValueError, match=match) as err:
            engine_config_for(cfg, max_slots=1, prompt_len=8,
                              max_new_tokens=4, **kw)
        assert str(err.value) == str(jerr.value)
    for role in ("prefill", "decode"):
        assert engine_config_for(cfg, max_slots=1, prompt_len=8,
                                 max_new_tokens=4, role=role,
                                 paged=True).role == role


def test_split_seeds_and_merge_requests():
    """The fleet tests' seeded sub-streams: replayable, distinct, merged in
    arrival order, equal to JAX's, and colliding rids refused."""
    from repro.serve import merge_requests as jmerge
    from repro.serve import poisson_requests as jpoisson
    from repro.serve import split_seeds as jsplit
    from repro_torch.serve import merge_requests, split_seeds
    seeds = split_seeds(123, 3)
    assert len(set(seeds)) == 3
    assert seeds == split_seeds(123, 3) == jsplit(123, 3)
    kw = dict(rate=2.0, vocab_size=64, prompt_len=8, max_new_tokens=4)
    streams = [poisson_requests(4, seed=s, rid_base=100 * i, **kw)
               for i, s in enumerate(seeds)]
    merged = merge_requests(*streams)
    want = jmerge(*[jpoisson(4, seed=s, rid_base=100 * i, **kw)
                    for i, s in enumerate(seeds)])
    assert len(merged) == 12
    times = [r.arrival_time for r in merged]
    assert times == sorted(times)
    assert [(r.rid, r.arrival_time, r.tokens.tolist()) for r in merged] \
        == [(r.rid, r.arrival_time, r.tokens.tolist()) for r in want]
    with pytest.raises(ValueError, match="colliding rids"):
        merge_requests(streams[0], streams[0])


# ----------------------------------------------------------------------
# the handoff's wire form, within the port and across the frameworks
# ----------------------------------------------------------------------
def _record(cls, kv):
    return cls(rid=3, prompt_tokens=np.arange(6, dtype=np.int32),
               output=[11], pos=6, pad_len=8, prefill_chunk=4,
               max_new_tokens=5, eos_id=None, kv=kv, cached_prefix_tokens=0,
               arrival_time=0.25, admitted_time=0.5, first_token_time=1.0)


def _jax_kv():
    import jax.numpy as jnp
    rng = np.random.default_rng(0)
    return [np.asarray(jnp.asarray(rng.standard_normal((8, 1, 2, 16)),
                                   jnp.bfloat16)),
            rng.standard_normal((8, 1, 2, 16)).astype(np.float32)]


def _same_record(a, b, bits_a, bits_b):
    assert (a.rid, a.pos, a.pad_len, a.prefill_chunk, a.max_new_tokens,
            a.eos_id, a.output, a.cached_prefix_tokens, a.arrival_time,
            a.admitted_time, a.first_token_time) \
        == (b.rid, b.pos, b.pad_len, b.prefill_chunk, b.max_new_tokens,
            b.eos_id, b.output, b.cached_prefix_tokens, b.arrival_time,
            b.admitted_time, b.first_token_time)
    np.testing.assert_array_equal(a.prompt_tokens, b.prompt_tokens)
    assert a.prompt_tokens.dtype == b.prompt_tokens.dtype
    assert len(bits_a) == len(bits_b)
    for x, y in zip(bits_a, bits_b):
        assert x == y
    assert a.nbytes == b.nbytes


def _bits_np(kv):
    return [(str(a.dtype), a.shape, a.tobytes()) for a in kv]


def _bits_torch(kv):
    names = {torch.bfloat16: "bfloat16", torch.float32: "float32"}
    return [(names[t.dtype], tuple(t.shape),
             t.contiguous().view(torch.uint8).numpy().tobytes()) for t in kv]


def test_handoff_record_npz_roundtrip_bfloat16():
    """The port's record in bf16 and f32 comes back bit for bit through
    its own wire form, and through JAX's: a blob the port writes loads in
    JAX and a blob JAX writes loads in the port, the same bytes, dtypes,
    shapes, fields and ``nbytes`` either way."""
    jkv = _jax_kv()
    tkv = [torch.from_numpy(jkv[0].view(np.uint16).copy()).view(
        torch.bfloat16), torch.from_numpy(jkv[1].copy())]
    rec = _record(HandoffRecord, tkv)
    jrec = _record(JHandoffRecord, jkv)
    assert rec.nbytes == jrec.nbytes
    back = HandoffRecord.from_npz_bytes(rec.to_npz_bytes())
    assert [t.dtype for t in back.kv] == [torch.bfloat16, torch.float32]
    _same_record(back, rec, _bits_torch(back.kv), _bits_torch(rec.kv))
    # port -> JAX, and JAX -> port
    in_jax = JHandoffRecord.from_npz_bytes(rec.to_npz_bytes())
    _same_record(in_jax, jrec, _bits_np(in_jax.kv), _bits_np(jrec.kv))
    in_port = HandoffRecord.from_npz_bytes(jrec.to_npz_bytes())
    _same_record(in_port, rec, _bits_torch(in_port.kv), _bits_torch(rec.kv))
    assert _bits_torch(in_port.kv) == [
        (n, s, b) for (n, s, b) in _bits_np(jkv)]


# ----------------------------------------------------------------------
# the engine cases against the JAX engines
# ----------------------------------------------------------------------
def test_single_replica_fleet_matches_bare_engine(jax_fleet):
    res, _ = _case("single_replica", jax_fleet)
    assert res["got"] == res["want"]
    fl = res["fleet"]
    # the lockstep drive keeps the shared clock call for call the bare
    # engine's, so the timestamps (not only the tokens) are equal
    rows = {r[0]: r for r in fl["rows"][0]}
    for rid, ttft, e2e in res["bare_rows"]:
        assert rows[rid][1] == ttft and rows[rid][2] == e2e
    assert fl["aggregate"]["n_requests"] == res["bare_n"]
    assert fl["aggregate"]["ttft"]["p50"] == res["bare_ttft_p50"]


@pytest.mark.parametrize("G", [1, 4])
@pytest.mark.parametrize("variant", ["plain", "prefix", "spec"])
def test_disaggregated_matches_unified_tokens(jax_fleet, variant, G):
    name = f"disagg_{variant}" + ("_g4" if G > 1 else "")
    res, api = _case(name, jax_fleet, G)
    assert res["got"] == res["want"]
    assert res["disaggregated"] is True
    fl = res["fleet"]
    assert fl["handoffs"]["moved"] == 6 and fl["handoffs"]["pending"] == 0
    assert fl["handoffs"]["bytes"] > 0
    roles = {r["role"]: r for r in fl["replicas"]}
    assert roles["prefill"]["handoffs"]["exported"] == 6
    assert roles["decode"]["handoffs"]["imported"] == 6
    assert roles["decode"]["n_requests"] == 6
    assert roles["prefill"]["n_requests"] == 0
    if G > 1:
        assert api.engines[-1].model.moe_spec.topo.num_ranks == 4


def test_decode_role_rejects_submit(jax_fleet):
    res, _ = _case("decode_rejects_submit", jax_fleet)
    assert "import_handoff" in res["error"]


def test_fixed_assignment_identical_across_policies(jax_fleet):
    res, _ = _case("fixed_assignment", jax_fleet)
    for policy in ("prefix_affinity", "round_robin"):
        assert res[policy]["placed"] == res["load"]["placed"]
        assert res[policy]["out"] == res["load"]["out"]


def test_fleet_zero_recompiles_after_warmup(jax_fleet):
    res, api = _case("zero_recompiles", jax_fleet)
    assert res["recompiled"] == [False, False]
    assert sum(res["fleet"]["routing"]["per_replica"]) == 6
    assert res["fleet"]["aggregate"]["n_requests"] == 6
    for eng in api.engines:
        assert eng.report()["jit_entries"].keys() == {
            "prefill_chunk", "decode", "write_blocks", "gather_prefix",
            "copy_block"}


def test_import_leaves_a_recompute_in_flight_alone(jax_fleet):
    """The import writes through a scratch of its own: the decode engine's
    preempted request, one chunk into its recompute when the record
    arrives, keeps its K/V, and every stream equals JAX's and the unified
    engine's."""
    res, api = _case("import_mid_recompute", jax_fleet)
    assert res["mid"]["rid"] == 1
    assert 0 < res["mid"]["pos"] < res["mid"]["len"]
    assert res["imported"] is True
    assert res["preemptions"] == 1
    assert res["got"] == res["want"]
    dec = api.engines[-1]
    assert dec.kv.import_scratch is not None
    assert dec.kv.import_scratch is not dec.kv.scratch


# ----------------------------------------------------------------------
# records across the frameworks
# ----------------------------------------------------------------------
def _pool_positions(kv, bt_row, n):
    """Each pool leaf's positions [0, n) through one chain, KV-length axis
    first."""
    bs = kv.ecfg.kv_block_size
    pos = torch.arange(n)
    phys = torch.from_numpy(bt_row).long()[pos // bs] * bs + pos % bs
    return [leaf.movedim(ax, 0)[phys] for leaf, ax in
            zip(TP.kv_leaves(kv.pool), kv.seq_axes)]


def test_jax_records_serve_in_the_port(jax_fleet):
    """A JAX prefill engine's records, through the npz wire form, imported
    by the port's decode engine: the pool holds each record's K/V bit for
    bit, and the streams are JAX's unified engine's."""
    results, params, _ = jax_fleet
    want = results["xf_export"]["want"]
    api = PortAPI(params[1])
    dec = api.engine(clock=VirtualClock(0.5), role="decode", slots=3,
                     prompt_len=12, max_new=8, chunk=4)
    outputs = {}
    orig = dec._finish

    def capture(st, now):
        outputs[st.req.rid] = list(st.output)
        orig(st, now)
    dec._finish = capture
    for blob in results["xf_export"]["blobs"]:
        rec = HandoffRecord.from_npz_bytes(bytes.fromhex(blob))
        assert dec.import_handoff(rec)
        got = _pool_positions(dec.kv, dec.kv.bt_row(rec.rid), rec.pos)
        for leaf, want_leaf in zip(got, rec.kv):
            assert torch.equal(leaf, want_leaf[:rec.pos])
    while dec.has_work():
        dec.step()
    assert streams(outputs) == want


def test_port_records_serve_in_jax(jax_fleet):
    """The port's prefill engine's records, on the same weights and
    requests, match JAX's records (K/V within f32 rounding) and, imported
    by a JAX decode engine, give JAX's unified streams."""
    results, params, tmp = jax_fleet
    api = PortAPI(params[1])
    pf = api.engine(clock=VirtualClock(0.5), role="prefill", slots=3,
                    prompt_len=12, max_new=8, chunk=4)
    for r in mid_recompute_requests(api):
        pf.submit(r)
    recs = []
    while len(recs) < 3:
        pf.step()
        recs.extend(pf.pop_handoffs())
    theirs = [JHandoffRecord.from_npz_bytes(bytes.fromhex(b))
              for b in results["xf_export"]["blobs"]]
    for mine, jrec in zip(recs, theirs):
        assert (mine.rid, mine.output, mine.pos, mine.pad_len) \
            == (jrec.rid, jrec.output, jrec.pos, jrec.pad_len)
        assert mine.nbytes == jrec.nbytes
        for a, b in zip(mine.kv, jrec.kv):
            np.testing.assert_allclose(a.numpy(), b, rtol=1e-5, atol=1e-5)
    got, _ = jax_fleet_cases(
        tmp / "import", {"xf_import": 1}, [["xf_import"]],
        port_blobs=[r.to_npz_bytes().hex() for r in recs],
        cache=tmp / f"xla{XF_GROUP}")
    assert got["xf_import"]["got"] == results["xf_export"]["want"]


# ----------------------------------------------------------------------
# the import's captured write: no host sync, position independent
# ----------------------------------------------------------------------
def _decode_engine(jax_fleet, slots=2):
    api = PortAPI(jax_fleet[1][1])
    dec = api.engine(clock=VirtualClock(0.5), role="decode", slots=slots,
                     prompt_len=16, max_new=4, chunk=4)
    dec.warmup()
    return api, dec


def test_import_write_never_syncs_the_host(jax_fleet, monkeypatch):
    """A live disaggregated pair, the decode engine's import write under
    the guard."""
    api = PortAPI(jax_fleet[1][1])
    clock = VirtualClock(0.5)
    kw = dict(slots=2, prompt_len=16, max_new=3, chunk=4)
    pf = api.engine(clock=clock, role="prefill", **kw)
    dec = api.engine(clock=clock, role="decode", **kw)
    guard = HostSyncGuard()
    fn = dec.kv._import_write
    calls = []

    def guarded(*args):
        calls.append(1)
        with guard:
            return fn(*args)
    monkeypatch.setattr(dec.kv, "_import_write", guarded)
    rep = FleetRouter([pf, dec]).run(poisson_requests(
        3, rate=2.0, vocab_size=api.vocab, prompt_len=14, max_new_tokens=3,
        seed=4))
    assert rep["fleet"]["handoffs"]["moved"] == 3
    assert len(calls) == 3 * 4                       # 16 / 4 chunks each
    assert guard.ops > 3
    assert guard.hits == []


def test_import_write_is_position_independent(jax_fleet, monkeypatch):
    """One store's import write at several (chain, chunk start, pad_len)
    dispatches the same ops with the same host arguments, and writes what
    ``paging.write_chunk_blocks`` called with host ints writes."""
    _, dec = _decode_engine(jax_fleet)
    kv = dec.kv
    rng = np.random.default_rng(7)
    for tree in (kv.pool, kv.import_scratch):
        for leaf in TP.kv_leaves(tree):
            leaf.copy_(torch.from_numpy(rng.standard_normal(
                leaf.shape).astype(np.float32)))
    seen = {}
    fn = kv._import_write

    def recording(*args):
        rec = OpRecorder()
        with rec:
            fn(*args)
        seen["trace"] = rec.trace
    monkeypatch.setattr(kv, "_import_write", recording)
    traces = []
    for chain, start, pad in [([3, 5, 1, 7], 0, 16), ([2, 4], 4, 8),
                              ([6, 8, 9], 8, 12), ([1], 0, 4)]:
        row = np.full((kv.blocks_per_slot,), TP.NULL_BLOCK, np.int32)
        row[:len(chain)] = chain
        ref = TP.map_kv_leaves(lambda x, i: x.clone(), kv.pool)
        kv._stage_import(np.append(row, [start, pad]))
        traces.append(seen["trace"])
        TP.write_chunk_blocks(ref, kv.import_scratch, torch.from_numpy(row),
                              start, chunk=kv.ecfg.prefill_chunk,
                              block_size=kv.ecfg.kv_block_size,
                              seq_axes=kv.seq_axes, ring_mods=kv.ring_mods,
                              valid_to=pad)
        for a, b in zip(TP.kv_leaves(kv.pool), TP.kv_leaves(ref)):
            assert torch.equal(a, b)
    for t in traces[1:]:
        assert t == traces[0], "the import write depends on its chain"
    assert len(traces[0]) > 10


def test_decode_role_warms_the_import_write(jax_fleet):
    """The decode role builds its import scratch and warms its write; the
    report keeps JAX's ``jit_entries`` keys and a unified or prefill
    engine builds no import scratch until it imports."""
    _, dec = _decode_engine(jax_fleet)
    assert dec.kv.import_entry is not None
    assert set(dec.report()["jit_entries"]) == {"prefill_chunk", "decode",
                                                "write_blocks"}
    api = PortAPI(jax_fleet[1][1])
    for role in ("unified", "prefill"):
        eng = api.engine(clock=VirtualClock(0.5), role=role, slots=1,
                         prompt_len=8, max_new=2, chunk=4)
        assert eng.kv.import_scratch is None
