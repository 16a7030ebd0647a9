"""Shared helpers for the expert-parallel port tests: the JAX side at
G > 1 runs in a subprocess with fake host devices (the main pytest
process keeps one device, see conftest.py) and hands its arrays over
through an npz file."""
import os
import socket
import subprocess
import sys
import textwrap

import numpy as np
import pytest
import torch

from repro_torch.core import dispatch as TD
from repro_torch.core import moe_layer as TM
from repro_torch.core import prefetch as TP
from repro_torch.core.moe_layer import SCALAR_DIAGS, VECTOR_DIAGS

SRC = os.path.join(os.path.dirname(__file__), "..", "src")
TESTS = os.path.dirname(os.path.abspath(__file__))


def run_jax(body: str, out_path, *, devices: int = 4, timeout: int = 300):
    """Run ``body`` (which writes ``OUT``, an npz path) with ``devices``
    emulated XLA host devices; returns the loaded npz as a dict."""
    env = dict(os.environ)
    # one thread a device: the suite runs several workers on a few cores
    env["XLA_FLAGS"] = (f"--xla_force_host_platform_device_count={devices}"
                        " --xla_cpu_multi_thread_eigen=false")
    env["JAX_PLATFORMS"] = "cpu"
    env["PYTHONPATH"] = os.path.abspath(SRC) + os.pathsep + env.get(
        "PYTHONPATH", "")
    code = f"OUT = {str(out_path)!r}\n" + textwrap.dedent(body)
    r = subprocess.run([sys.executable, "-c", code], capture_output=True,
                       text=True, env=env, timeout=timeout)
    assert r.returncode == 0, f"stdout:\n{r.stdout}\nstderr:\n{r.stderr}"
    with np.load(out_path) as z:
        return {k: z[k] for k in z.files}


def run_gloo(script: str, args_of_rank, *, world: int = 4,
             timeout: int = 240) -> None:
    """Run ``script`` in ``world`` processes that form a gloo group on
    ``localhost`` (argv: rank, port, then ``args_of_rank(rank)``); every
    rank must exit 0."""
    with socket.socket() as s:
        s.bind(("localhost", 0))
        port = str(s.getsockname()[1])
    env = dict(os.environ, PYTHONPATH=os.path.abspath(SRC),
               OMP_NUM_THREADS="1")
    procs = [subprocess.Popen([sys.executable, "-c", script, str(r), port,
                               *args_of_rank(r)], env=env,
                              stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                              text=True) for r in range(world)]
    try:
        errs = [p.communicate(timeout=timeout)[1] for p in procs]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    for r, p in enumerate(procs):
        assert p.returncode == 0, f"rank {r}:\n{errs[r][-4000:]}"


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """The port's CPU runs here are many tiny ops: with several test
    workers on a few cores, torch's default of a thread per core makes
    them wait on each other far longer than they compute."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


# flatten / unflatten a nested dict of arrays to "a/b/c" npz keys; the
# same source text runs inside the JAX subprocesses (FLATTEN_SRC)
FLATTEN_SRC = '''
def flatten(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        key = prefix + str(k)
        if isinstance(v, dict):
            out.update(flatten(v, key + "/"))
        else:
            out[key] = np.asarray(v)
    return out
'''
exec(FLATTEN_SRC)


def unflatten(flat, prefix: str):
    """The nested dict under ``prefix`` (keys "prefix/a/b")."""
    tree = {}
    for key, v in flat.items():
        if not key.startswith(prefix + "/"):
            continue
        node = tree
        parts = key[len(prefix) + 1:].split("/")
        for p in parts[:-1]:
            node = node.setdefault(p, {})
        node[parts[-1]] = v
    return tree


def sub_tree(rec, prefix):
    """The entries of ``rec`` under "prefix/", with the prefix cut."""
    return {k[len(prefix) + 1:]: v for k, v in rec.items()
            if k.startswith(prefix + "/")}


def run_captured(monkeypatch, spec, params, x, vmask, comm, skew_key=None):
    """Run the port's block over ``comm`` and capture, per rank in call
    order, the S, layout and FIDS its body used."""
    got = {"S": [], "layout": [], "fids": []}
    schedule, build_layout = TM.schedule, TD.build_layout
    foreign_ids = TP.all_foreign_ids

    def cap_schedule(*a, **kw):
        out = schedule(*a, **kw)
        got["S"].append(out[0])
        return out

    def cap_layout(*a, **kw):
        out = build_layout(*a, **kw)
        got["layout"].append(out)
        return out

    def cap_fids(*a, **kw):
        out = foreign_ids(*a, **kw)
        got["fids"].append(out)
        return out
    monkeypatch.setattr(TM, "schedule", cap_schedule)
    monkeypatch.setattr(TD, "build_layout", cap_layout)
    monkeypatch.setattr(TP, "all_foreign_ids", cap_fids)
    y, diag = TM.moe_block(torch.from_numpy(x), params, spec=spec, comm=comm,
                           skew_key=skew_key,
                           valid_mask=torch.from_numpy(vmask))
    monkeypatch.undo()
    return y, diag, got


def assert_block_matches(rec, y, diag, got, spec):
    """The port's block output, diagnostics and captured integers equal
    the JAX record ``rec``: y within 2e-5, the aux loss within 1e-6,
    everything else exactly."""
    np.testing.assert_allclose(y.numpy(), rec["y"], atol=2e-5, rtol=2e-5)
    jd = sub_tree(rec, "diag")
    assert set(diag) == set(SCALAR_DIAGS) | set(VECTOR_DIAGS) == set(jd)
    for key in jd:
        if key == "aux_loss":
            np.testing.assert_allclose(diag[key].numpy(), jd[key], atol=1e-6)
        else:
            np.testing.assert_array_equal(diag[key].numpy(), jd[key],
                                          err_msg=key)
    G = len(got["S"])
    assert G == len(got["layout"]) == spec.ep_degree
    for S_r in got["S"]:                    # replicated on every rank
        np.testing.assert_array_equal(S_r.numpy(), rec["S"])
    for g, lay in enumerate(got["layout"]):
        for f in lay._fields:
            np.testing.assert_array_equal(
                getattr(lay, f).numpy(), rec["layout/" + f][g],
                err_msg=f"rank {g} {f}")
    K = spec.moe.num_foreign_slots
    if spec.moe.policy != "even_split" and K:
        assert len(got["fids"]) == G
        for f_r in got["fids"]:
            np.testing.assert_array_equal(f_r.numpy(), rec["fids"])


# ----------------------------------------------------------------------
# the serving-time expert placement (replica slots, tiered residency):
# one JAX engine run a cell on a (1, G) mesh and the port's counterpart,
# each recording what the engine decided along the way; the hooks are
# source text that both sides run
# ----------------------------------------------------------------------
RECORD_SRC = '''
def record_placement(eng):
    """Hook ``eng`` so that it records its greedy streams, the replica
    table after every rebalance, the residency table after every applied
    decision and the rows of every stage."""
    rec = {"streams": {}, "replica_ids": [], "residency_ids": [],
           "stage_rows": []}
    finish, rebalance = eng._finish, eng._rebalance_now
    apply_stage, dispatch = eng._apply_pending_stage, eng._dispatch_stage

    def on_finish(st, now):
        rec["streams"][str(st.req.rid)] = [int(t) for t in st.output]
        finish(st, now)

    def on_rebalance():
        rebalance()
        rec["replica_ids"].append(eng._replica_ids.tolist())

    def on_apply():
        apply_stage()
        if eng._residency_ids is not None:
            rec["residency_ids"].append(eng._residency_ids.tolist())

    def on_dispatch(rows):
        rec["stage_rows"].append([int(r) for r in rows])
        dispatch(rows)
    eng._finish, eng._rebalance_now = on_finish, on_rebalance
    eng._apply_pending_stage, eng._dispatch_stage = on_apply, on_dispatch
    return rec
'''
exec(RECORD_SRC)

PLACEMENT_JAX_BODY = FLATTEN_SRC + RECORD_SRC + '''
import dataclasses, json
import jax
# cells that trace the same steps (the tight budgets under each policy)
# compile once
jax.config.update("jax_compilation_cache_dir", CACHE)
jax.config.update("jax_persistent_cache_min_compile_time_secs", 0)
from repro.configs.base import ParallelConfig
from repro.configs.qwen15_moe_a27b import CONFIG
from repro.launch.mesh import make_host_mesh
from repro.models.model import MeshShape, build_model
from repro.serve import Request, ServeEngine, VirtualClock, engine_config_for
cfg = CONFIG.reduced()
cfg = dataclasses.replace(cfg, moe=dataclasses.replace(
    cfg.moe, q_tokens=1, router_skew=0.9, num_replica_slots=R))
mesh = make_host_mesh(1, G)
ms = MeshShape(tuple(zip(mesh.axis_names, mesh.devices.shape)))
model = build_model(cfg, ParallelConfig(attn_chunk=8, loss_chunk=8),
                    batch=KW["max_slots"], seq_len=KW["prompt_len"],
                    mesh_shape=ms, mesh=mesh)
with mesh:
    params = model.init(jax.random.PRNGKey(0))
out = flatten(jax.device_get(params), "params/")
from repro.core.router import route_skewed
moe = cfg.moe


def _skew_draws(key, t_slice):
    layers = []
    for _ in range(cfg.num_layers):
        sub = jax.random.fold_in(key, 0)
        layers.append(jax.numpy.stack([route_skewed(
            jax.random.fold_in(sub, g), t_slice,
            top_k=moe.num_experts_per_tok, num_experts=moe.num_experts,
            padded_experts=model.moe_spec.topo.padded_experts,
            alpha=moe.router_skew, n_hot=moe.router_skew_experts
        ).assign for g in range(G)]))
        key = jax.random.fold_in(key, 997)
    return jax.numpy.stack(layers)


_skew_draws = jax.jit(_skew_draws, static_argnums=1)


def skew_draws(key, tokens):
    """What the MoE blocks of one call on ``key`` draw: [layer][rank]
    [t_slice][k] (the scan folds 997 into the key a layer, the one MoE
    sub-layer folds 0, each rank its index)."""
    return np.asarray(_skew_draws(key, -(-max(tokens, G) // G))).tolist()


def record_draws(eng, rec):
    rec["draws"] = {"prefill_chunk": [], "decode": []}
    next_key = eng._next_key

    def on_next_key(stream, idx):
        key = next_key(stream, idx)
        pf = np.array_equal(np.asarray(stream), np.asarray(eng._pf_key))
        rec["draws"]["prefill_chunk" if pf else "decode"].append(
            skew_draws(key, KW["prefill_chunk"] if pf else KW["max_slots"]))
        return key
    eng._next_key = on_next_key


for name, ekw in CELLS.items():
    rng = np.random.default_rng(3)
    reqs = [Request(rid=i, tokens=rng.integers(
                0, 512, (int(rng.integers(3, KW["prompt_len"] + 1)),)
            ).astype(np.int32), max_new_tokens=KW["max_new_tokens"],
            arrival_time=0.3 * i) for i in range(6)]
    eng = ServeEngine(model, params, engine_config_for(cfg, **KW, **ekw),
                      mesh=mesh, clock=VirtualClock(0.1))
    rec = record_placement(eng)
    record_draws(eng, rec)
    with mesh:
        rec["report"] = eng.run(reqs)
    out[name] = np.array(json.dumps(rec, default=int))
np.savez(OUT, **out)
'''


def placement_jax(tmp_path_factory, *, G, R, KW, CELLS):
    """The JAX engine's records, one a cell, and its converted weights
    (one subprocess on G emulated host devices)."""
    import json
    from repro_torch.convert import to_torch
    tmp = tmp_path_factory.mktemp("placement")
    body = (f"import numpy as np\nG = {G}\nR = {R}\nKW = {KW!r}\n"
            f"CELLS = {CELLS!r}\nCACHE = {str(tmp / 'xla')!r}\n"
            + PLACEMENT_JAX_BODY)
    flat = run_jax(body, tmp / "p.npz", timeout=600)
    params = to_torch(unflatten(flat, "params"), device="cpu")
    return params, {c: json.loads(str(flat[c])) for c in CELLS}


def replay_draws(eng, draws):
    """Make ``eng``'s step core route on the skewed assignments the JAX
    engine drew, call by call (the two frameworks' generators differ):
    its pre-draws copy them into the static buffers instead, the ranks
    the step core runs (all of them, or one process's own under
    ``DistComm``)."""
    core = eng.core
    left = {entry: list(d) for entry, d in draws.items()}

    def predraw(idx, entry="decode"):
        buf = core._pf_skew if entry == "prefill_chunk" else core._skew
        buf.copy_(torch.tensor(left[entry].pop(0), dtype=torch.int32)[
            :, list(core.ranks_here)])
    core._predraw = predraw
    return left


def placement_port(params, *, G, R, KW, ekw, draws, device="cpu"):
    """The port's engine on the same trace, weights and skew draws: its
    record (the report under "report"), the engine, and the JAX draws it
    left unused."""
    import dataclasses
    from repro_torch.configs.qwen15_moe_a27b import CONFIG as TORCH_QWEN
    from repro_torch.models.model import build_model
    from repro_torch.serve import (Request, ServeEngine, VirtualClock,
                                   engine_config_for)
    cfg = TORCH_QWEN.reduced()
    cfg = dataclasses.replace(cfg, moe=dataclasses.replace(
        cfg.moe, q_tokens=1, router_skew=0.9, num_replica_slots=R))
    model = build_model(cfg, batch=KW["max_slots"], seq_len=KW["prompt_len"],
                        device=device, ep_degree=G)
    eng = ServeEngine(model, params, engine_config_for(cfg, **KW, **ekw),
                      clock=VirtualClock(0.1), device=device)
    rng = np.random.default_rng(3)
    reqs = [Request(rid=i, tokens=rng.integers(
                0, 512, (int(rng.integers(3, KW["prompt_len"] + 1)),)
            ).astype(np.int32), max_new_tokens=KW["max_new_tokens"],
            arrival_time=0.3 * i) for i in range(6)]
    rec = record_placement(eng)
    left = replay_draws(eng, draws)
    rec["report"] = eng.run(reqs)
    return rec, eng, left


# ----------------------------------------------------------------------
# truncated sampling: what a JAX engine samples and routes on, recorded by
# call index (warmup's calls included), and the port's StepCore replaying
# it; the recording hooks are source text for the JAX side
# ----------------------------------------------------------------------
SAMPLING_RECORD_SRC = '''
def make_skew_draws(cfg, model, G):
    """What the MoE blocks of one call on ``key`` draw: [layer][rank]
    [t_slice][k] (the scan folds 997 into the key a layer, the one MoE
    sub-layer folds 0, each rank its index)."""
    from repro.core.router import route_skewed
    moe = cfg.moe

    def one(key, t_slice):
        layers = []
        for _ in range(cfg.num_layers):
            sub = jax.random.fold_in(key, 0)
            layers.append(jax.numpy.stack([route_skewed(
                jax.random.fold_in(sub, g), t_slice,
                top_k=moe.num_experts_per_tok, num_experts=moe.num_experts,
                padded_experts=model.moe_spec.topo.padded_experts,
                alpha=moe.router_skew, n_hot=moe.router_skew_experts
            ).assign for g in range(G)]))
            key = jax.random.fold_in(key, 997)
        return jax.numpy.stack(layers)
    one = jax.jit(one, static_argnums=1)
    return lambda key, tokens: np.asarray(
        one(key, -(-max(tokens, G) // G))).tolist()


def record_sampling(eng, width, skew_draws=None):
    """Hook the JAX ``ServeEngine`` ``eng`` so that it records its streams,
    and by call index the Gumbel draw each decode step samples on
    (``noise``, [max_slots, width]) and, under router skew, the skewed
    assignments each prefill chunk and decode step routes on (``draws``;
    with sampling on a decode step splits its key, 0 skew and 1
    sampling)."""
    rec = {"streams": {}, "noise": {},
           "draws": {"prefill_chunk": {}, "decode": {}}}
    next_key, finish = eng._next_key, eng._finish

    def on_next_key(stream, idx):
        key = next_key(stream, idx)
        if key is None:
            return key
        pf = np.array_equal(np.asarray(stream), np.asarray(eng._pf_key))
        skew_key, samp_key = key, None
        if not pf and eng._sample:
            skew_key, samp_key = ((jax.random.fold_in(key, 0),
                                   jax.random.fold_in(key, 1))
                                  if eng._skew else (None, key))
        if samp_key is not None:
            rec["noise"][str(idx)] = np.asarray(jax.random.gumbel(
                samp_key, (eng.ecfg.max_slots, width),
                jax.numpy.float32)).tolist()
        if eng._skew:
            entry = "prefill_chunk" if pf else "decode"
            rec["draws"][entry][str(idx)] = skew_draws(
                skew_key, eng.ecfg.prefill_chunk if pf
                else eng.ecfg.max_slots)
        return key

    def on_finish(st, now):
        rec["streams"][str(st.req.rid)] = [int(t) for t in st.output]
        finish(st, now)
    eng._next_key, eng._finish = on_next_key, on_finish
    return rec
'''


def keyed_replay(rec):
    """``StepCore`` methods (``_predraw``, ``_draw_noise``) that copy the
    JAX engine's skew draws and noise of the same call index (``rec``,
    from ``record_sampling``) into the static buffers (the draws of the
    ranks the step core runs: all of them, or one process's own under
    ``DistComm``); a call JAX did not make (the port's warmup) leaves
    them as they are."""
    def predraw(core, idx, entry="decode"):
        d = rec["draws"][entry].get(str(idx))
        if d is not None:
            buf = core._pf_skew if entry == "prefill_chunk" else core._skew
            buf.copy_(torch.tensor(d, dtype=torch.int32)[
                :, list(core.ranks_here)])

    def draw_noise(core, idx):
        n = rec["noise"].get(str(idx))
        if n is not None:
            core._noise.copy_(torch.tensor(n, dtype=torch.float32))
    return predraw, draw_noise


def replay_on(eng, rec):
    """Make ``eng``'s step core route and sample on ``rec``'s draws."""
    import functools
    predraw, draw_noise = keyed_replay(rec)
    eng.core._predraw = functools.partial(predraw, eng.core)
    eng.core._draw_noise = functools.partial(draw_noise, eng.core)
