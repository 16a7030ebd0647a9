"""Training across the (data, model) grid against the JAX package, on the
CPU, at reduced size in f32.

Fault 1 of this slice (ROADMAP C): JAX's ``build_model`` shards a
training batch's MoE tokens by sequence when the length divides over the
EP degree G (each rank routes positions [g S / G, (g + 1) S / G) of
every row), where the port sliced the flattened tokens, and JAX's
``shard_map`` transpose gives each rank's aux loss the cotangent over G
where the port gave it to rank 0's alone.  So on a (1, G) mesh at B >= 2
the whole model's ``train_loss``, its gradients and its diagnostics are
held to JAX's, G = 2 and 4, including the first reproduction (reduced
qwen15-moe-a27b, B 4, S 16: loss 6.269256 against 6.269198), a dense
lead layer (moonshot-v1-16b-a3b), switch128, and a length that does not
divide (S 18 at G = 4, where neither shards by sequence); and
``model.prefill`` at G = 2 with B = 4.  Tolerances: the loss 2e-5, each
gradient leaf 2e-5 x max(1, its largest JAX magnitude), the diagnostics
1e-4 (``test_torch_train.py``'s).

On the grid: four gloo processes as a (2, 2) grid (``launch/grid.py``),
each row its own EP group over ``DistComm``, run three
``make_train_step`` steps (two microbatches, full remat) of reduced
qwen15-moe-a27b and stablelm-1.6b on their data shards and are held to
JAX's jitted step on ``make_host_mesh(2, 2)``, every process's leaves
against JAX's global ones, to the tolerances of
``test_train_step_microbatch_remat_matches_jax``; and the MoE block on
the (2, 2) grid against a dense per-token oracle, the counterpart of
``tests/test_distributed.py::test_moe_block_oracle_on_2x4_mesh``.
"""
import json

import numpy as np
import pytest
import torch

from repro_torch import tree
from repro_torch.configs.base import ParallelConfig
from repro_torch.configs.registry import get_config
from repro_torch.launch.grid import data_rows, is_expert_path
from repro_torch.launch.steps import loss_and_grads
from repro_torch.models.model import build_model

from _ep_helpers import one_torch_thread, run_gloo  # noqa: F401
from test_torch_prefix import run_jax_side_by_side

LOSS_TOL = GRAD_TOL = 2e-5
# tag: (arch, G, B, S); the first is the reproduction of fault 1
FAULT_CASES = {
    "qwen_g2": ("qwen15-moe-a27b", 2, 4, 16),
    "qwen_g4": ("qwen15-moe-a27b", 4, 4, 16),
    "switch_g2": ("switch128", 2, 2, 16),
    "moonshot_g4": ("moonshot-v1-16b-a3b", 4, 2, 16),
    "qwen_g4_s18": ("qwen15-moe-a27b", 4, 2, 18),
}
PREFILL = ("qwen_g2",)
GRID_ARCHS = ("qwen15-moe-a27b", "stablelm-1.6b")
GRID = dict(data=2, model=2, batch=4, seq=16, microbatch=2, steps=3)
ORACLE = dict(B=4, S=16, d=32, f=64, E=8, k=2)

FAULT_BODY = '''
import jax
from repro.configs import get_config
from repro.configs.base import ParallelConfig
from repro.launch.mesh import make_host_mesh
from repro.models.model import MeshShape, build_model
out = {}
for tag, (arch, G, B, S) in CASES.items():
    mesh = make_host_mesh(1, G)
    ms = MeshShape(tuple(zip(mesh.axis_names, mesh.devices.shape)))
    cfg = get_config(arch).reduced()
    model = build_model(cfg, ParallelConfig(attn_chunk=8, loss_chunk=8),
                        batch=B, seq_len=S, mesh_shape=ms, mesh=mesh)
    out[tag + "|seq_sharded"] = np.asarray(model.moe_spec.seq_sharded)
    rng = np.random.default_rng(0)
    toks = rng.integers(0, cfg.vocab_size, (B, S + 1)).astype(np.int32)
    batch = {"tokens": toks[:, :-1], "labels": toks[:, 1:]}
    with mesh:
        params = model.init(jax.random.PRNGKey(0))
        (loss, diags), grads = jax.jit(jax.value_and_grad(
            model.train_loss, has_aux=True))(params, batch)
        if tag in PREFILL:
            logits, _, _, pdiag = jax.jit(model.prefill)(
                params, {"tokens": batch["tokens"]})
            out[tag + "|prefill_logits"] = np.asarray(logits)
            for k, v in pdiag.items():
                out[tag + "|prefill_diag/" + k] = np.asarray(v)
    out[tag + "|loss"] = np.asarray(loss)
    out[tag + "|tokens"] = batch["tokens"]
    out[tag + "|labels"] = batch["labels"]
    for k, v in diags.items():
        out[tag + "|diag/" + k] = np.asarray(v)
    for i, (p, g) in enumerate(zip(jax.tree.leaves(params),
                                   jax.tree.leaves(grads))):
        out[f"{tag}|p{i}"] = np.asarray(p)
        out[f"{tag}|g{i}"] = np.asarray(g)
np.savez(OUT, **out)
'''

GRID_BODY = '''
import jax
from repro.configs import get_config
from repro.configs.base import ParallelConfig
from repro.data.pipeline import synthetic_batches
from repro.launch.mesh import make_host_mesh
from repro.launch.steps import make_train_step
from repro.models.model import MeshShape, build_model
from repro.optim.adamw import adamw_init
mesh = make_host_mesh(GRID["data"], GRID["model"])
ms = MeshShape(tuple(zip(mesh.axis_names, mesh.devices.shape)))
# the devices' order on the mesh: the port's process ranks
out = {"mesh_ids": np.asarray([[d.id for d in row] for row in mesh.devices])}
for arch in ARCHS:
    cfg = get_config(arch).reduced()
    model = build_model(cfg, ParallelConfig(
        microbatch=GRID["microbatch"], remat="full", attn_chunk=8,
        loss_chunk=8), batch=GRID["batch"], seq_len=GRID["seq"],
        mesh_shape=ms, mesh=mesh)
    with mesh:
        params = model.init(jax.random.PRNGKey(0))
        for i, p in enumerate(jax.tree.leaves(params)):
            out[f"{arch}|p0_{i}"] = np.asarray(p)
        opt = adamw_init(params)
        step = jax.jit(make_train_step(model, lr=1e-3))
        data = synthetic_batches("random", batch=GRID["batch"],
                                 seq_len=GRID["seq"], vocab=cfg.vocab_size,
                                 seed=0)
        for s in range(GRID["steps"]):
            params, opt, loss, diags = step(params, opt, next(data))
            out[f"{arch}|loss{s}"] = np.asarray(loss)
            for k, v in diags.items():
                out[f"{arch}|diag{s}/{k}"] = np.asarray(v)
    for i, p in enumerate(jax.tree.leaves(params)):
        out[f"{arch}|p3_{i}"] = np.asarray(p)
    for i, p in enumerate(jax.tree.leaves((opt.m, opt.v))):
        out[f"{arch}|mv_{i}"] = np.asarray(p)
np.savez(OUT, **out)
'''

WORKER = '''
import json, sys
import numpy as np, torch, torch.distributed as dist
rank, port, workdir = int(sys.argv[1]), sys.argv[2], sys.argv[3]
torch.set_num_threads(1)
dist.init_process_group("gloo", init_method=f"tcp://localhost:{port}",
                        rank=rank, world_size=4)
from repro_torch import tree
from repro_torch.configs.base import MoEConfig, ParallelConfig
from repro_torch.configs.registry import get_config
from repro_torch.convert import expert_shard, shard_params
from repro_torch.core.moe_layer import MoEBlockSpec, moe_block
from repro_torch.data.pipeline import synthetic_batches
from repro_torch.launch.grid import make_grid
from repro_torch.launch.steps import make_train_step
from repro_torch.models.model import build_model
from repro_torch.optim.adamw import adamw_init
a = json.load(open(workdir + "/grid.json"))
GRID, O = a["grid"], a["oracle"]
grid = make_grid(GRID["data"], GRID["model"])
out = {"place": np.asarray([grid.row, grid.col])}
# the MoE block on the grid: this row's data shard over its EP group
inp = np.load(workdir + "/oracle.npz")
spec = MoEBlockSpec(moe=MoEConfig(**a["oracle_moe"]), d_model=O["d"],
                    ep_degree=GRID["model"],
                    tokens_local=O["B"] // GRID["data"] * O["S"], block_m=8)
full = {k: torch.from_numpy(inp[k]) for k in ("router", "w_in", "w_out",
                                                "w_gate")}
x = torch.from_numpy(inp["x"])
rows = x.shape[0] // grid.data
with torch.no_grad():
    y, diag = moe_block(x[grid.row * rows:(grid.row + 1) * rows],
                        expert_shard(full, grid.col, grid.model), spec=spec,
                        comm=grid.comm())
out["oracle_y"] = y.numpy()
out["oracle_drops"] = (diag["send_drops"] + diag["dest_drops"]).numpy()
# three train steps a model on this process's data shard
jax_p0 = np.load(workdir + "/p0.npz")
for arch in a["archs"]:
    cfg = get_config(arch).reduced()
    model = build_model(cfg, ParallelConfig(
        microbatch=GRID["microbatch"], remat="full", attn_chunk=8,
        loss_chunk=8), batch=grid.local_batch(GRID["batch"]),
        seq_len=GRID["seq"], device="cpu", ep_degree=grid.model,
        comm=grid.comm())
    structure = tree.flatten(model.init(0))[1]
    n = sum(1 for k in jax_p0.files if k.startswith(arch + "|"))
    params = shard_params(tree.unflatten(structure, [
        torch.from_numpy(np.array(jax_p0[f"{arch}|{i}"])) for i in range(n)]),
        grid.col, grid.model)
    opt = adamw_init(params)
    step = make_train_step(model, lr=1e-3, grid=grid)
    data = synthetic_batches("random", batch=GRID["batch"],
                             seq_len=GRID["seq"], vocab=cfg.vocab_size,
                             seed=0)
    for s in range(GRID["steps"]):
        batch = grid.shard_batch(next(data), GRID["microbatch"])
        params, opt, loss, diags = step(params, opt, batch)
        out[f"{arch}|loss{s}"] = loss.numpy()
        out.update({f"{arch}|diag{s}/{k}": v.numpy()
                    for k, v in diags.items()})
    out[f"{arch}|step"] = opt.step.numpy()
    out.update({f"{arch}|p3_{i}": p.numpy()
                for i, p in enumerate(tree.leaves(params))})
    out.update({f"{arch}|mv_{i}": p.numpy()
                for i, p in enumerate(tree.leaves((opt.m, opt.v)))})
np.savez(f"{workdir}/out{rank}.npz", **out)
dist.destroy_process_group()
'''

ORACLE_MOE = dict(num_experts=ORACLE["E"], num_experts_per_tok=ORACLE["k"],
                  d_ff_expert=ORACLE["f"], policy="harmoeny",
                  capacity_factor=2.0, num_foreign_slots=4)


@pytest.fixture(scope="module")
def jax_side(tmp_path_factory):
    """JAX's records: the fault cases in three subprocesses and the (2, 2)
    train steps in one an arch, side by side on four emulated devices."""
    tmp = tmp_path_factory.mktemp("grid_jax")
    head = f"PREFILL = {PREFILL!r}\n"
    cases = list(FAULT_CASES.items())
    split = [dict(cases[:2]), dict(cases[2:4]), dict(cases[4:])]
    bodies = [head + f"CASES = {c!r}\n" + FAULT_BODY for c in split]
    bodies += [f"GRID = {GRID!r}\nARCHS = {(arch,)!r}\n" + GRID_BODY
               for arch in GRID_ARCHS]
    return run_jax_side_by_side(bodies, tmp, devices=4)


def _port_model(tag, rec):
    arch, G, B, S = FAULT_CASES[tag]
    cfg = get_config(arch).reduced()
    model = build_model(cfg, ParallelConfig(attn_chunk=8, loss_chunk=8),
                        batch=B, seq_len=S, device="cpu", ep_degree=G)
    leaves, structure = tree.flatten(model.init(0))
    params = tree.unflatten(structure, [
        torch.from_numpy(np.array(rec[f"{tag}|p{i}"]))
        for i in range(len(leaves))])
    assert f"{tag}|p{len(leaves)}" not in rec
    return model, params


@pytest.mark.parametrize("tag", list(FAULT_CASES))
def test_train_loss_and_gradients_at_g_match_jax(jax_side, tag):
    arch, G, B, S = FAULT_CASES[tag]
    rec = jax_side
    model, params = _port_model(tag, rec)
    # JAX's rule: by sequence where the length divides over G
    assert model.moe_spec.seq_sharded == bool(rec[tag + "|seq_sharded"]) \
        == (S % G == 0)
    assert not model.moe_spec_decode.seq_sharded
    batch = {k: torch.from_numpy(rec[f"{tag}|{k}"])
             for k in ("tokens", "labels")}
    loss, diags, grads = loss_and_grads(model, params, batch)
    np.testing.assert_allclose(float(loss), float(rec[tag + "|loss"]),
                               atol=LOSS_TOL, rtol=0)
    jd = {k.split("/", 1)[1]: v for k, v in rec.items()
          if k.startswith(tag + "|diag/")}
    assert sorted(diags) == sorted(jd)
    for k, v in jd.items():
        np.testing.assert_allclose(diags[k].numpy(), v, atol=1e-4,
                                   err_msg=k)
    for i, g in enumerate(grads):
        want = rec[f"{tag}|g{i}"]
        np.testing.assert_allclose(
            g.numpy(), want, rtol=0,
            atol=GRAD_TOL * max(1.0, float(np.abs(want).max())),
            err_msg=f"{tag} leaf {i}")


@pytest.mark.parametrize("tag", PREFILL)
def test_prefill_at_g_matches_jax(jax_side, tag):
    rec = jax_side
    model, params = _port_model(tag, rec)
    with torch.no_grad():
        logits, _, _, diags = model.prefill(
            params, {"tokens": torch.from_numpy(rec[tag + "|tokens"])},
            kernels=False)
    want = rec[tag + "|prefill_logits"]
    np.testing.assert_allclose(logits.numpy(), want, rtol=0,
                               atol=2e-5 * max(1.0, float(np.abs(want).max())))
    for k in diags:
        np.testing.assert_allclose(diags[k].numpy(),
                                   rec[f"{tag}|prefill_diag/{k}"],
                                   atol=1e-4, err_msg=k)


def test_seq_sharded_needs_a_dividing_length():
    """A sequence-sharded block refuses a length that does not divide
    over its ranks (JAX's ``shard_map`` refuses it too)."""
    import dataclasses
    from repro_torch.core.moe_layer import moe_block
    cfg = get_config("qwen15-moe-a27b").reduced()
    model = build_model(cfg, batch=2, seq_len=16, device="cpu", ep_degree=2)
    spec = model.moe_spec
    assert spec.seq_sharded
    p = tree.tree_map(lambda t: t[0], model.init(0)["stack"]["blocks"]
                      ["sub0"]["moe"])
    x = torch.randn(2, 15, cfg.d_model)
    with pytest.raises(ValueError, match="divide over 2 ranks"):
        moe_block(x, p, spec=spec, comm=model.comm, kernels=False)
    with torch.no_grad():
        y, _ = moe_block(x, p, spec=dataclasses.replace(
            spec, seq_sharded=False), comm=model.comm, kernels=False)
    assert y.shape == x.shape


def test_data_rows_follow_jax_batch_axes():
    """JAX reshapes the batch into (n, B / n) microbatches and shards each
    over 'data'; a batch that 'data' does not divide is replicated."""
    assert data_rows(8, 2, 1).tolist() == [4, 5, 6, 7]
    assert data_rows(8, 2, 1, microbatch=2).tolist() == [2, 3, 6, 7]
    assert data_rows(6, 4, 3).tolist() == list(range(6))
    with pytest.raises(ValueError):
        data_rows(4, 2, 0, microbatch=4)


@pytest.fixture(scope="module")
def grid_run(jax_side, tmp_path_factory):
    """The four gloo processes of the (2, 2) grid: the MoE block on its
    oracle's inputs, and the train steps on JAX's initial weights."""
    tmp = tmp_path_factory.mktemp("grid")
    rng = np.random.default_rng(42)
    O = ORACLE
    from repro_torch.core.topology import make_topology
    topo = make_topology(GRID["model"], O["E"])
    n_rows = topo.num_ranks * topo.experts_per_rank
    oracle = {"router": rng.normal(0, 0.3, (O["d"], topo.padded_experts)),
              "w_in": rng.normal(0, 0.3, (n_rows, O["d"], O["f"])),
              "w_gate": rng.normal(0, 0.3, (n_rows, O["d"], O["f"])),
              "w_out": rng.normal(0, 0.3, (n_rows, O["f"], O["d"])),
              "x": rng.normal(size=(O["B"], O["S"], O["d"]))}
    oracle = {k: v.astype(np.float32) for k, v in oracle.items()}
    np.savez(tmp / "oracle.npz", **oracle)
    np.savez(tmp / "p0.npz", **{k.replace("|p0_", "|"): v
                                for k, v in jax_side.items()
                                if "|p0_" in k})
    with open(tmp / "grid.json", "w") as f:
        json.dump({"grid": GRID, "oracle": ORACLE, "oracle_moe": ORACLE_MOE,
                   "archs": GRID_ARCHS}, f)
    run_gloo(WORKER, lambda r: [str(tmp)], world=4)
    return oracle, [dict(np.load(tmp / f"out{r}.npz")) for r in range(4)]


def test_grid_places_ranks_as_jax_mesh(jax_side, grid_run):
    """Process r sits at (r // G, r % G): the mesh's device order."""
    ids = jax_side["mesh_ids"]
    assert ids.tolist() == [[0, 1], [2, 3]]
    for r, rec in enumerate(grid_run[1]):
        assert rec["place"].tolist() == [r // 2, r % 2]
        assert int(ids[r // 2, r % 2]) == r


def test_moe_block_oracle_on_2x2_grid(grid_run):
    """Each data row is its own EP group: every process's output is its
    row's tokens through their top-k experts, per token, densely."""
    from repro_torch.core.router import route_topk
    from repro_torch.core.topology import make_topology
    import torch.nn.functional as F_
    oracle, recs = grid_run
    O = ORACLE
    topo = make_topology(GRID["model"], O["E"])
    rows = np.zeros(O["E"], np.int64)
    for g in range(topo.num_ranks):
        for j in range(topo.experts_per_rank):
            rows[topo.slot_map[g, j]] = g * topo.experts_per_rank + j
    flat = torch.from_numpy(oracle["x"]).reshape(-1, O["d"])
    r = route_topk(flat, torch.from_numpy(oracle["router"]), top_k=O["k"],
                   num_real_experts=O["E"])
    w = {k: torch.from_numpy(oracle[k]) for k in ("w_in", "w_gate", "w_out")}
    y_ref = torch.zeros_like(flat)
    for t in range(flat.shape[0]):
        for j in range(O["k"]):
            e = int(rows[int(r.assign[t, j])])
            h = F_.silu(flat[t] @ w["w_gate"][e]) * (flat[t] @ w["w_in"][e])
            y_ref[t] += float(r.gates[t, j]) * (h @ w["w_out"][e])
    y_ref = y_ref.reshape(O["B"], O["S"], O["d"]).numpy()
    per = O["B"] // GRID["data"]
    for rank, rec in enumerate(recs):
        assert float(rec["oracle_drops"].sum()) == 0
        d = rank // GRID["model"]
        np.testing.assert_allclose(rec["oracle_y"],
                                   y_ref[d * per:(d + 1) * per], atol=2e-4,
                                   rtol=0, err_msg=f"rank {rank}")


def _global_rows(want, path, col):
    """This process's part of JAX's global leaf: its EP rank's expert
    rows (axis 1), or the whole replicated leaf."""
    if not is_expert_path(path):
        return want
    n = want.shape[1] // GRID["model"]
    return want[:, col * n:(col + 1) * n]


@pytest.mark.parametrize("arch", GRID_ARCHS)
def test_grid_train_steps_match_jax_2x2(jax_side, grid_run, arch):
    """Three steps on the (2, 2) grid (microbatched, remat) against JAX's
    jitted step on ``make_host_mesh(2, 2)``: losses 2e-5, diagnostics
    1e-4, moments 2e-5 x the leaf's largest, parameters all but a
    thousandth of entries within 1e-5 and every one within three steps'
    lr (``test_train_step_microbatch_remat_matches_jax``), on every
    process."""
    rec = jax_side
    cfg = get_config(arch).reduced()
    model = build_model(cfg, batch=2, seq_len=GRID["seq"], device="meta")
    shapes = model.param_shapes()
    paths = tree.paths(shapes)
    mv_paths = tree.paths((shapes, shapes))
    for rank, out in enumerate(grid_run[1]):
        col = rank % GRID["model"]
        for s in range(GRID["steps"]):
            np.testing.assert_allclose(float(out[f"{arch}|loss{s}"]),
                                       float(rec[f"{arch}|loss{s}"]),
                                       atol=LOSS_TOL, rtol=0)
            keys = [k for k in rec if k.startswith(f"{arch}|diag{s}/")]
            assert sorted(keys) == sorted(k for k in out
                                          if k.startswith(f"{arch}|diag{s}/"))
            for k in keys:
                np.testing.assert_allclose(out[k], rec[k], atol=1e-4,
                                           err_msg=f"rank {rank} {k}")
        assert int(out[f"{arch}|step"]) == GRID["steps"]
        for i, path in enumerate(mv_paths):
            want = _global_rows(rec[f"{arch}|mv_{i}"], path, col)
            np.testing.assert_allclose(
                out[f"{arch}|mv_{i}"], want, rtol=0,
                atol=GRAD_TOL * max(1.0, float(np.abs(want).max())),
                err_msg=f"rank {rank} moment {path}")
        n_off = n_all = 0
        for i, path in enumerate(paths):
            want = _global_rows(rec[f"{arch}|p3_{i}"], path, col)
            diff = np.abs(out[f"{arch}|p3_{i}"] - want)
            n_off += int((diff > 1e-5).sum())
            n_all += diff.size
            assert diff.max() <= 3 * 1e-3, f"rank {rank} {path}"
        assert n_off <= n_all // 1000, (rank, n_off, n_all)
