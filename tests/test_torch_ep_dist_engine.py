"""The serve engine across processes: four gloo processes, each one EP
rank (``DistComm``) of a reduced qwen15-moe-a27b in f32 (q = 1) holding
only its own expert rows of the converted JAX weights
(``convert.shard_params``), serve the trace of
``tests/test_torch_ep_engine.py`` under a ``VirtualClock``, eagerly.

- Greedy streams, admission order (slot history), preemptions and decode
  steps equal the JAX engine's on a (1, 4) mesh, under harmoeny (hosted
  fetch) and round_robin (dense fetch), and every process serves the
  same streams.
- ``report()["load_balance"]`` and the counters of rank 0's report equal
  the ``VirtualGroup`` engine's on the same weights.
- Under the paper's skew (0.9, JAX's draws replayed by call index, each
  process copying its own rank's) the streams equal JAX's.
- Lockstep: with a clock that ticks at another rate in every process,
  every rank admits on rank 0's reading and the streams stay JAX's.
- Serving-time placement across processes (the four-device cells of
  ``tests/test_serve_rebalance.py`` and ``tests/test_serve_residency.py``
  on the paged pool: replica slots with ``rebalance_interval`` 3, the
  replica swap under the hosted and the dense fetch, and residency at 4
  of 8 experts under predictive and on_demand): greedy streams, slot
  history, every replica and residency table, every stage's rows, the
  ``load_balance`` and ``residency`` sections equal the JAX engine's on
  a (1, 4) mesh; every rank holds the same tables after every engine
  step; each swap leaves every live slot holding its expert's row; each
  process's host tier holds its own rows only and stages only those.
- ``launch.serve.serve(args, device="cpu")`` with ``--replica-slots 1``
  under the four-process gloo group writes one report, from rank 0,
  equal to the ``VirtualGroup`` CLI's (streams, counters, load balance,
  swaps, key paths but ``engine.comm``); a process group whose size is
  not ``--model-par`` is refused."""
import dataclasses
import json
import os
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import pytest

from repro_torch.configs.qwen15_moe_a27b import CONFIG as TORCH_QWEN
from repro_torch.convert import to_torch
from repro_torch.launch import serve as TCLI
from repro_torch.models.model import build_model
from repro_torch.serve import Request, ServeEngine, VirtualClock, \
    engine_config_for
from repro_torch.serve import engine as TE

from _ep_helpers import (FLATTEN_SRC,  # noqa: F401
                         PLACEMENT_JAX_BODY, SAMPLING_RECORD_SRC, TESTS,
                         one_torch_thread, run_gloo, run_jax, unflatten)
from _serve_helpers import captured_run

G, SLOTS, L, GEN, C = 4, 3, 12, 6, 4
KW = dict(max_slots=SLOTS, prompt_len=L, max_new_tokens=GEN, prefill_chunk=C,
          kv_block_size=4, num_kv_blocks=0)
# case: (policy, fetch form, skew, each rank's clock tick)
CASES = {
    "harmoeny": ("harmoeny", "hosted", False, [0.1] * G),
    "round_robin": ("round_robin", "dense", False, [0.1] * G),
    "skew": ("harmoeny", "hosted", True, [0.1] * G),
    "clocks": ("harmoeny", "dense", False, [0.1, 0.25, 0.05, 0.4]),
}
CLI_ARGV = ["--arch", "qwen15-moe-a27b", "--reduced", "--batch", "3",
            "--prompt-len", "12", "--gen", "6", "--seed", "1",
            "--model-par", "4", "--skew", "0.9", "--q-tokens", "1",
            "--paged", "--kv-block-size", "4", "--prefill-chunk", "4",
            "--replica-slots", "1", "--rebalance-interval", "3"]
# placement: the JAX cells (one engine each on a model with R replica
# slots) and the port's runs of them, each with its fetch form
R = 1
PKW = dict(KW, paged=True)
JAX_PLACEMENT = {"replicas": dict(replica_slots=R, rebalance_interval=3),
                 "predictive": dict(resident_experts=4),
                 "on_demand": dict(resident_experts=4,
                                   prefetch_policy="on_demand")}
PLACEMENT = {"replicas": ("replicas", "hosted"),
             "replicas_dense": ("replicas", "dense"),
             "predictive": ("predictive", "hosted"),
             "on_demand": ("on_demand", "dense")}

JAX_BODY = FLATTEN_SRC + SAMPLING_RECORD_SRC + '''
import dataclasses, json
import jax
from repro.configs.base import ParallelConfig
from repro.configs.qwen15_moe_a27b import CONFIG
from repro.launch.mesh import make_host_mesh
from repro.models.model import MeshShape, build_model
from repro.serve import Request, ServeEngine, VirtualClock, engine_config_for
mesh = make_host_mesh(1, G)
ms = MeshShape(tuple(zip(mesh.axis_names, mesh.devices.shape)))
out, params = {}, None
for name, (policy, skew) in RUNS.items():
    cfg = CONFIG.reduced()
    cfg = dataclasses.replace(cfg, moe=dataclasses.replace(
        cfg.moe, q_tokens=1, router_skew=0.9 if skew else 0.0))
    model = build_model(cfg, ParallelConfig(attn_chunk=8, loss_chunk=8),
                        batch=KW["max_slots"], seq_len=KW["prompt_len"],
                        mesh_shape=ms, mesh=mesh)
    if params is None:
        with mesh:
            params = model.init(jax.random.PRNGKey(0))
        out = flatten(jax.device_get(params), "params/")
    rng = np.random.default_rng(3)
    reqs = [Request(rid=i, tokens=rng.integers(
                0, 512, (int(rng.integers(3, KW["prompt_len"] + 1)),)
            ).astype(np.int32), max_new_tokens=KW["max_new_tokens"],
            arrival_time=0.3 * i) for i in range(6)]
    eng = ServeEngine(model, params, engine_config_for(
        cfg, paged=True, moe_policy=policy, **KW), mesh=mesh,
        clock=VirtualClock(0.1))
    rec = record_sampling(eng, 1, make_skew_draws(cfg, model, G)
                          if skew else None)
    with mesh:
        rep = eng.run(reqs)
    rec.update(slot_history=eng.slot_history,
               preemptions=rep["preemptions"],
               decode_steps=rep["decode_steps"])
    out[name] = np.array(json.dumps(rec, default=int))
np.savez(OUT, **out)
'''

WORKER = '''
import json, sys
import numpy as np, torch, torch.distributed as dist
rank, port, work, tests = (int(sys.argv[1]), sys.argv[2], sys.argv[3],
                           sys.argv[4])
sys.path.insert(0, tests)
torch.set_num_threads(1)
dist.init_process_group("gloo", init_method=f"tcp://localhost:{port}",
                        rank=rank, world_size=4)
import functools
from _ep_helpers import keyed_replay, unflatten
from _serve_helpers import captured_run
from test_torch_ep_dist_engine import CASES, CLI_ARGV, KW, port_cfg, trace
from repro_torch.convert import shard_params, to_torch
from repro_torch.core.dispatch import DistComm
from repro_torch.launch import serve as TCLI
from repro_torch.models.model import build_model
from repro_torch.serve import ServeEngine, VirtualClock, engine_config_for
from repro_torch.serve import engine as TE
flat = dict(np.load(work + "/jax.npz"))
params = shard_params(to_torch(unflatten(flat, "params"), device="cpu"),
                      rank, 4)
out = {}
for name, (policy, fetch, skew, ticks) in CASES.items():
    comm = DistComm(fetch=fetch)
    cfg = port_cfg(skew)
    model = build_model(cfg, batch=KW["max_slots"], seq_len=KW["prompt_len"],
                        device="cpu", ep_degree=4, comm=comm)
    eng = ServeEngine(model, params, engine_config_for(
        cfg, paged=True, moe_policy=policy, **KW),
        clock=VirtualClock(ticks[rank]), device="cpu")
    if skew:
        rec = json.loads(str(flat["skew"]))
        predraw, _ = keyed_replay(rec)
        eng.core._predraw = functools.partial(predraw, eng.core)
    streams, rep = captured_run(eng, trace())
    out[name] = {"streams": {str(k): v for k, v in streams.items()},
                 "slot_history": [list(h) for h in eng.front.slot_history],
                 "report": rep, "fetch_bytes": comm.fetch_bytes,
                 "skew_buffer": (None if eng.core._skew is None
                                 else list(eng.core._skew.shape))}
from _ep_helpers import RECORD_SRC, replay_draws
from test_torch_ep_dist_engine import (JAX_PLACEMENT, PKW, PLACEMENT,
                                       placement_cfg)
from repro_torch.core.topology import local_slot_of
from repro_torch.serve.placement import expert_leaves, replica_pairs
exec(RECORD_SRC)
pflat = dict(np.load(work + "/placement.npz"))
whole = to_torch(unflatten(pflat, "params"), device="cpu")
pparams = shard_params(whole, rank, 4)
out["placement"] = {}
for name, (cell, fetch) in PLACEMENT.items():
    comm = DistComm(fetch=fetch)
    cfg = placement_cfg()
    model = build_model(cfg, batch=PKW["max_slots"],
                        seq_len=PKW["prompt_len"], device="cpu",
                        ep_degree=4, comm=comm)
    eng = ServeEngine(model, pparams, engine_config_for(
        cfg, **PKW, **JAX_PLACEMENT[cell]), clock=VirtualClock(0.1),
        device="cpu")
    rec = record_placement(eng)
    left = replay_draws(eng, json.loads(str(pflat[cell]))["draws"])
    tables, step = [], eng.step
    def on_step(*a, **k):
        did = step(*a, **k)
        tables.append([None if t is None else t.tolist() for t in (
            eng._replica_ids, eng._residency_ids)])
        return did
    eng.step = on_step
    rec["report"] = eng.run(trace())
    rec.update(tables=tables, left={e: len(d) for e, d in left.items()},
               slot_history=[list(h) for h in eng.front.slot_history],
               swap_bytes=comm.swap_bytes, stages=eng.stage_times(),
               leaf_rows=[w.shape[w.ndim - 3]
                          for w in expert_leaves(pparams)])
    tier = eng._host_tier
    if tier is not None:
        rec["tier"] = {"row0": tier.row0, "n_rows": tier.n_rows,
                       "nbytes": tier.nbytes, "row_bytes": tier.row_bytes}
    if eng._rebalancer is not None:
        # every live slot of this rank holds its expert's row of the
        # whole (rank-major) weights
        topo, lso = model.moe_spec.topo, local_slot_of(model.moe_spec.topo)
        epr, checked, ok = topo.experts_per_rank, 0, True
        for (w, w_rep), (w_all, _) in zip(replica_pairs(pparams),
                                          replica_pairs(whole)):
            for r, e in enumerate(eng._replica_ids[rank]):
                if e < 0:
                    continue
                h = int(topo.host_of[e, 0])
                row = w_all.select(w_all.ndim - 3, h * epr + int(lso[h, e]))
                ok &= bool(torch.equal(w_rep.select(w_rep.ndim - 3, r), row))
                checked += 1
        rec["replica_rows"] = {"checked": checked, "equal": ok}
    out["placement"][name] = rec
streams, finish = {}, TE.ServeEngine._finish
def recording_finish(self, st, now):
    streams[str(st.req.rid)] = [int(t) for t in st.output]
    finish(self, st, now)
TE.ServeEngine._finish = recording_finish
args = TCLI.build_parser().parse_args(
    CLI_ARGV + ["--out", f"{work}/cli_rank{rank}.json"])
rep = TCLI.serve(args, device="cpu")
out["cli"] = {"streams": streams, "report": rep}
json.dump(out, open(f"{work}/rank{rank}.json", "w"),
          default=lambda o: o.item() if hasattr(o, "item") else int(o))
dist.destroy_process_group()
'''


def trace():
    rng = np.random.default_rng(3)
    return [Request(rid=i, tokens=rng.integers(
                0, 512, (int(rng.integers(3, L + 1)),)).astype(np.int32),
                max_new_tokens=GEN, arrival_time=0.3 * i) for i in range(6)]


def port_cfg(skew=False):
    cfg = TORCH_QWEN.reduced()
    return dataclasses.replace(cfg, moe=dataclasses.replace(
        cfg.moe, q_tokens=1, router_skew=0.9 if skew else 0.0))


def placement_cfg():
    """The placement cells' model: the paper's skew, q = 1, R slots."""
    cfg = TORCH_QWEN.reduced()
    return dataclasses.replace(cfg, moe=dataclasses.replace(
        cfg.moe, q_tokens=1, router_skew=0.9, num_replica_slots=R))


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """The JAX engines' records (the plain runs and the placement cells,
    two subprocesses side by side), then the four gloo processes'
    results."""
    work = tmp_path_factory.mktemp("dist_engine")
    jax_runs = {"harmoeny": ("harmoeny", False),
                "round_robin": ("round_robin", False),
                "skew": ("harmoeny", True)}
    body = (f"import numpy as np\nG = {G}\nKW = {KW!r}\n"
            f"RUNS = {jax_runs!r}\n" + JAX_BODY)
    placement = (f"import numpy as np\nG = {G}\nR = {R}\nKW = {PKW!r}\n"
                 f"CELLS = {JAX_PLACEMENT!r}\n"
                 f"CACHE = {str(work / 'xla')!r}\n" + PLACEMENT_JAX_BODY)
    with ThreadPoolExecutor(2) as pool:
        jobs = [pool.submit(run_jax, b, work / f, timeout=600)
                for b, f in ((body, "jax.npz"),
                             (placement, "placement.npz"))]
        flat, pflat = (j.result() for j in jobs)
    run_gloo(WORKER, lambda r: (str(work), TESTS), timeout=420)
    ranks = []
    for r in range(G):
        with open(work / f"rank{r}.json") as fh:
            ranks.append(json.load(fh))
    jax = {n: json.loads(str(flat[n])) for n in jax_runs}
    jax.update({f"placement/{c}": json.loads(str(pflat[c]))
                for c in JAX_PLACEMENT})
    params = to_torch(unflatten(flat, "params"), device="cpu")
    return work, jax, ranks, params


def _as_json(tree):
    """``tree`` as the workers' JSON files hold it."""
    return json.loads(json.dumps(tree, default=lambda o: o.item()
                                 if hasattr(o, "item") else int(o)))


def _virtual_group(params, policy):
    cfg = port_cfg()
    model = build_model(cfg, batch=SLOTS, seq_len=L, device="cpu",
                        ep_degree=G)
    eng = ServeEngine(model, params, engine_config_for(
        cfg, paged=True, moe_policy=policy, **KW), clock=VirtualClock(0.1),
        device="cpu")
    streams, rep = captured_run(eng, trace())
    return streams, _as_json(rep)


@pytest.mark.parametrize("name", ["harmoeny", "round_robin", "skew"])
def test_dist_engine_matches_jax_engine(runs, name):
    _, jax, ranks, _ = runs
    want = jax[name]
    for r, res in enumerate(ranks):
        got = res[name]
        assert got["streams"] == want["streams"], f"rank {r}"
        assert got["slot_history"] == want["slot_history"], f"rank {r}"
        assert got["report"]["preemptions"] == want["preemptions"]
        assert got["report"]["decode_steps"] == want["decode_steps"]
        comm = got["report"]["engine"]["comm"]
        assert comm["rank"] == r and comm["entries"] == "eager"
        assert comm["fetch"] == CASES[name][1] and comm["backend"] == "gloo"
    if name == "skew":
        assert want["draws"]["decode"]
        # one process draws (and replays) its own rank's assignments only
        assert ranks[0][name]["skew_buffer"][1] == 1
    lb = ranks[0][name]["report"]["load_balance"]["decode"]
    assert lb["send_drops_total"] == lb["dest_drops_total"] == 0
    if CASES[name][0] == "harmoeny":
        assert ranks[0][name]["report"]["moe"]["decode/moved_units"] > 0
        assert sum(res[name]["fetch_bytes"] for res in ranks) > 0


@pytest.mark.parametrize("name", ["harmoeny", "round_robin"])
def test_dist_engine_load_balance_equals_virtual_group(runs, name):
    _, _, ranks, params = runs
    streams, rep = _virtual_group(params, CASES[name][0])
    got = ranks[0][name]["report"]
    assert {str(k): v for k, v in streams.items()} \
        == ranks[0][name]["streams"]
    assert got["load_balance"] == rep["load_balance"]
    assert got["moe"] == rep["moe"]
    for key in ("n_requests", "decode_steps", "prefill_chunks",
                "preemptions", "total_new_tokens", "max_occupancy"):
        assert got[key] == rep[key], key
    for res in ranks[1:]:                 # the schedule is replicated
        assert res[name]["report"]["load_balance"] == rep["load_balance"]


def test_dist_engine_lockstep_under_disagreeing_clocks(runs):
    """Each process's clock ticks at its own rate; every rank admits on
    rank 0's reading, so the collectives stay in step and the streams and
    admissions are the JAX engine's (rank 0 ticks as JAX's clock)."""
    _, jax, ranks, _ = runs
    want = jax["harmoeny"]
    for r, res in enumerate(ranks):
        assert res["clocks"]["streams"] == want["streams"], f"rank {r}"
        assert res["clocks"]["slot_history"] == want["slot_history"]
        assert res["clocks"]["report"]["load_balance"] \
            == ranks[0]["harmoeny"]["report"]["load_balance"]
    # the clocks did disagree: the ranks' own timestamps differ
    ttft = [res["clocks"]["report"]["ttft"]["p50"] for res in ranks]
    assert len(set(ttft)) == G


@pytest.mark.parametrize("name", list(PLACEMENT))
def test_dist_placement_matches_jax_engine(runs, name):
    """Every process serves the JAX engine's streams and admissions and
    takes its placement decisions: every replica table after a rebalance,
    every residency table after an applied decision, every stage's rows,
    and rank 0's counters, ``load_balance`` and ``residency``."""
    _, jax, ranks, _ = runs
    cell = PLACEMENT[name][0]
    want = jax[f"placement/{cell}"]
    jrep = want["report"]
    for r, res in enumerate(ranks):
        got = res["placement"][name]
        assert got["left"] == {"prefill_chunk": 0, "decode": 0}  # same calls
        assert got["streams"] == want["streams"], f"rank {r}"
        for key in ("replica_ids", "residency_ids", "stage_rows"):
            assert got[key] == want[key], f"rank {r} {key}"
        comm = got["report"]["engine"]["comm"]
        assert comm["rank"] == r and comm["fetch"] == PLACEMENT[name][1]
    rep = ranks[0]["placement"][name]["report"]
    assert rep["n_requests"] == 6
    assert rep["load_balance"] == jrep["load_balance"]
    lb = rep["load_balance"]["decode"]
    assert lb["send_drops_total"] == lb["dest_drops_total"] == 0
    for key in ("replica_slots", "rebalance_interval", "rebalances",
                "replica_swaps", "replica_ids", "hot_experts",
                "resident_experts", "prefetch_policy", "residency_stages",
                "residency_ids"):
        assert rep["engine"].get(key) == jrep["engine"].get(key), key
    assert rep.get("residency") == jrep.get("residency")
    assert rep["jit_entries"].keys() == jrep["jit_entries"].keys()
    if cell == "replicas":
        assert rep["engine"]["replica_swaps"] >= 1
        assert any(ids != [[-1] * R] * G for ids in want["replica_ids"])
    else:
        assert rep["engine"]["residency_stages"] >= 1
        assert any(want["stage_rows"])


@pytest.mark.parametrize("name", list(PLACEMENT))
def test_dist_placement_tables_equal_on_every_rank(runs, name):
    """The rebalancer and the residency manager run on every process on
    the all-gathered loads: after every engine step every rank holds the
    same ``[G, R]`` replica and ``[G, W]`` residency tables (a rank that
    swapped or staged at another step would leave the lockstep)."""
    _, _, ranks, _ = runs
    tables = [res["placement"][name]["tables"] for res in ranks]
    assert len(tables[0]) \
        == ranks[0]["placement"][name]["report"]["engine"]["steps"]
    for r in range(1, G):
        assert tables[r] == tables[0], f"rank {r}"
    live = [t[0] if PLACEMENT[name][0] == "replicas" else t[1]
            for t in tables[0]]
    assert len({json.dumps(t) for t in live}) > 1      # the tables moved


@pytest.mark.parametrize("name", ["replicas", "replicas_dense"])
def test_dist_replica_swap_fetches_rows_from_their_hosts(runs, name):
    """After the last swap every live slot of every rank holds its
    expert's row of the whole weights, fetched from the rank that hosts
    it; the bytes sent count in ``swap_bytes``, and the hosted form sends
    fewer of them than the dense form, which sends every slot's row."""
    _, _, ranks, _ = runs
    for r, res in enumerate(ranks):
        rows = res["placement"][name]["replica_rows"]
        assert rows["equal"], f"rank {r}"
    assert sum(res["placement"][name]["replica_rows"]["checked"]
               for res in ranks) > 0
    sent = {n: sum(res["placement"][n]["swap_bytes"] for res in ranks)
            for n in ("replicas", "replicas_dense")}
    assert 0 < sent["replicas"] < sent["replicas_dense"]


@pytest.mark.parametrize("name", ["predictive", "on_demand"])
def test_dist_host_tier_holds_only_its_own_rows(runs, name):
    """Each process pins only the expert rows it hosts (JAX's per-rank
    residency cache over the rank's own shard) and stages only those: a
    stage's global rows split over the ranks that host them."""
    _, jax, ranks, _ = runs
    staged = [0] * len(jax[f"placement/{name}"]["stage_rows"])
    for r, res in enumerate(ranks):
        got = res["placement"][name]
        epr = got["leaf_rows"][0]
        assert set(got["leaf_rows"]) == {epr}
        assert got["tier"]["row0"] == r * epr
        assert got["tier"]["n_rows"] == epr
        assert got["tier"]["nbytes"] == epr * got["tier"]["row_bytes"]
        assert len(got["stages"]) == len(staged)
        for i, (st, rows) in enumerate(zip(got["stages"],
                                           got["stage_rows"])):
            mine = [x for x in rows if r * epr <= x < (r + 1) * epr]
            assert st["rows"] == len(mine)
            assert st["bytes"] == len(mine) * got["tier"]["row_bytes"]
            staged[i] += st["rows"]
    assert staged == [len(rows)
                      for rows in jax[f"placement/{name}"]["stage_rows"]]


def _key_paths(tree, path=()):
    out = set()
    if isinstance(tree, dict):
        for k, v in tree.items():
            out.add(path + (k,))
            out |= _key_paths(v, path + (k,))
    elif isinstance(tree, list):
        for v in tree:
            out |= _key_paths(v, path + ("[]",))
    return out


def test_dist_cli_report_equals_virtual_group_cli(runs, monkeypatch):
    work, _, ranks, _ = runs
    files = sorted(p for p in os.listdir(work) if p.startswith("cli_rank"))
    assert files == ["cli_rank0.json"]            # rank 0 writes, alone
    with open(work / "cli_rank0.json") as fh:
        dist_rep = json.load(fh)
    streams, finish = {}, TE.ServeEngine._finish

    def recording_finish(self, st, now):
        streams[str(st.req.rid)] = [int(t) for t in st.output]
        finish(self, st, now)
    monkeypatch.setattr(TE.ServeEngine, "_finish", recording_finish)
    args = TCLI.build_parser().parse_args(CLI_ARGV)
    rep = _as_json(TCLI.serve(args, device="cpu"))
    assert "comm" not in rep["engine"]
    for res in ranks:
        assert res["cli"]["streams"] == streams
    comm = dist_rep["engine"]["comm"]
    assert comm["fetch"] == "hosted" and comm["entries"] == "eager"
    assert _key_paths(dist_rep) - _key_paths(rep) \
        == {("engine", "comm")} | {("engine", "comm", k) for k in comm}
    assert _key_paths(rep) <= _key_paths(dist_rep)
    for key in ("n_requests", "decode_steps", "prefill_chunks",
                "preemptions", "total_new_tokens", "max_occupancy",
                "jit_entries", "load_balance", "moe"):
        assert dist_rep[key] == rep[key], key
    assert dist_rep["moe"]["decode/moved_units"] > 0
    for key in ("replica_swaps", "replica_ids", "hot_experts"):
        assert dist_rep["engine"][key] == rep["engine"][key], key
    assert dist_rep["engine"]["replica_swaps"] >= 1


def test_cli_refuses_a_world_size_other_than_model_par(tmp_path):
    """One process a rank: a process group of 1 cannot run --model-par 4."""
    import torch.distributed as dist
    if dist.is_initialized():
        pytest.skip("a process group is already initialized here")
    dist.init_process_group("gloo", init_method=f"file://{tmp_path}/pg",
                            rank=0, world_size=1)
    try:
        args = TCLI.build_parser().parse_args(CLI_ARGV)
        with pytest.raises(ValueError, match="WORLD_SIZE 1 != --model-par 4"):
            TCLI.serve(args, device="cpu")
    finally:
        dist.destroy_process_group()
