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
- ``replica_slots`` and ``resident_experts`` raise under ``DistComm``.
- ``launch.serve.serve(args, device="cpu")`` under the four-process gloo
  group writes one report, from rank 0, equal to the ``VirtualGroup``
  CLI's (streams, counters, load balance, key paths but
  ``engine.comm``); a process group whose size is not ``--model-par``
  is refused."""
import dataclasses
import json
import os

import numpy as np
import pytest

from repro_torch.configs.qwen15_moe_a27b import CONFIG as TORCH_QWEN
from repro_torch.convert import to_torch
from repro_torch.launch import serve as TCLI
from repro_torch.models.model import build_model
from repro_torch.serve import Request, ServeEngine, VirtualClock, \
    engine_config_for
from repro_torch.serve import engine as TE

from _ep_helpers import (FLATTEN_SRC, SAMPLING_RECORD_SRC,  # noqa: F401
                         TESTS, one_torch_thread, run_gloo, run_jax,
                         unflatten)
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
            "--paged", "--kv-block-size", "4", "--prefill-chunk", "4"]

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
refused = {}
for field, extra in (("replica_slots", dict(replica_slots=1)),
                     ("resident_experts", dict(resident_experts=4))):
    try:
        ServeEngine(model, params, engine_config_for(
            cfg, paged=True, **KW, **extra), device="cpu")
        refused[field] = None
    except NotImplementedError as e:
        refused[field] = str(e)
out["refused"] = refused
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


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """The JAX engine's records, then the four gloo processes' results."""
    work = tmp_path_factory.mktemp("dist_engine")
    jax_runs = {"harmoeny": ("harmoeny", False),
                "round_robin": ("round_robin", False),
                "skew": ("harmoeny", True)}
    body = (f"import numpy as np\nG = {G}\nKW = {KW!r}\n"
            f"RUNS = {jax_runs!r}\n" + JAX_BODY)
    flat = run_jax(body, work / "jax.npz", timeout=600)
    run_gloo(WORKER, lambda r: (str(work), TESTS), timeout=420)
    ranks = []
    for r in range(G):
        with open(work / f"rank{r}.json") as fh:
            ranks.append(json.load(fh))
    jax = {n: json.loads(str(flat[n])) for n in jax_runs}
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


@pytest.mark.parametrize("field", ["replica_slots", "resident_experts"])
def test_dist_engine_refuses_placement(runs, field):
    _, _, ranks, _ = runs
    for res in ranks:
        msg = res["refused"][field]
        assert msg is not None and "ROADMAP item 5" in msg


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
