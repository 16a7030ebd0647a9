"""The port's checkpointer and fault tolerance (mirrors
``tests/test_checkpoint.py`` and ``tests/test_fault_tolerance.py``):
roundtrip, async save, torn writes, CRC, keep-k; checkpoints written by
the JAX package restored in the port and the other way round, file for
file equal; and the kill-and-resume drill of ``python -m
repro_torch.launch.train --device cpu``, whose resumed run ends
bit-equal to an uninterrupted one (every leaf file compared byte for
byte)."""
import filecmp
import json
import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.checkpoint.checkpointer import Checkpointer as JaxCheckpointer
from repro.optim.adamw import adamw_init as jax_adamw_init
from repro_torch import tree
from repro_torch.checkpoint.checkpointer import Checkpointer
from repro_torch.convert import to_torch
from repro_torch.optim.adamw import adamw_init
from repro_torch.runtime.fault_tolerance import (FailureInjector,
                                                 InjectedFailure,
                                                 run_with_restarts)

SRC = os.path.join(os.path.dirname(__file__), "..", "src")


def _tree():
    return {"a": torch.arange(12.0).reshape(3, 4),
            "b": {"c": torch.ones((5,), dtype=torch.int32)},
            "h": torch.linspace(-2, 2, 6).to(torch.bfloat16)}


def _equal(t, u):
    return all(x.dtype == y.dtype and torch.equal(x, y)
               for x, y in zip(tree.leaves(t), tree.leaves(u)))


def test_roundtrip(tmp_path):
    ck = Checkpointer(str(tmp_path), keep=2)
    t = _tree()
    ck.save(10, t, blocking=True)
    assert ck.latest_step() == 10
    assert _equal(ck.restore(10, t), t)


def test_async_save_snapshots_before_return(tmp_path):
    """The snapshot is taken at ``save``: changing the tree afterwards does
    not reach the checkpoint."""
    ck = Checkpointer(str(tmp_path))
    t = _tree()
    want = tree.tree_map(lambda x: x.clone(), t)
    ck.save(1, t)
    t["a"].add_(1)
    ck.wait()
    assert ck.latest_step() == 1
    assert _equal(ck.restore(1, t), want)


def test_torn_write_invisible(tmp_path):
    ck = Checkpointer(str(tmp_path))
    ck.save(5, _tree(), blocking=True)
    os.makedirs(tmp_path / "step_9")
    with open(tmp_path / "step_9" / "manifest.json", "w") as f:
        json.dump({"step": 9, "leaves": []}, f)
    assert ck.latest_step() == 5


def test_crc_detects_corruption(tmp_path):
    ck = Checkpointer(str(tmp_path))
    ck.save(3, _tree(), blocking=True)
    leaf = tmp_path / "step_3" / "leaf_0.npy"
    arr = np.load(leaf)
    arr.flat[0] += 1
    np.save(leaf, arr)
    with pytest.raises(IOError, match="corrupt"):
        ck.restore(3, _tree())


def test_keep_k_gc(tmp_path):
    ck = Checkpointer(str(tmp_path), keep=2)
    for s in (1, 2, 3, 4):
        ck.save(s, _tree(), blocking=True)
    steps = sorted(int(n[5:-5]) for n in os.listdir(tmp_path)
                   if n.endswith(".done"))
    assert steps == [3, 4]


def test_restore_one_subtree(tmp_path):
    """``only`` loads one top-level subtree; the rest of ``like`` (here on
    the meta device) only numbers the leaves."""
    ck = Checkpointer(str(tmp_path))
    t = {"params": _tree(), "opt": adamw_init(_tree()["a"][None])}
    ck.save(2, t, blocking=True)
    like = {"params": tree.tree_map(
        lambda x: torch.empty(x.shape, dtype=x.dtype, device="meta"),
        t["params"]), "opt": t["opt"]}
    out = ck.restore(2, like, only="params", device="cpu")
    assert _equal(out["params"], t["params"])
    assert all(a is b for a, b in zip(tree.leaves(out["opt"]),
                                      tree.leaves(t["opt"])))


def _jax_state():
    """A parameter tree (one bfloat16 leaf among f32 ones) and its AdamW
    state, JAX's."""
    k = jax.random.PRNGKey(0)
    params = {"embed": jax.random.normal(k, (6, 4)),
              "stack": {"w": jax.random.normal(jax.random.fold_in(k, 1),
                                               (2, 4, 3)).astype(jnp.bfloat16),
                        "norm": jnp.zeros((4,))},
              "lead": [{"x": jnp.arange(3.0)}]}
    return {"params": params, "opt": jax_adamw_init(params)}


def test_jax_checkpoint_restores_in_the_port(tmp_path):
    """A checkpoint JAX wrote restores in the port (CRCs checked) to the
    converted tree; the port writing that tree produces the same manifest
    and the same files, byte for byte."""
    jstate = _jax_state()
    JaxCheckpointer(str(tmp_path / "jax")).save(7, jstate, blocking=True)
    like = to_torch(jax.device_get(jstate), device="cpu")
    got = Checkpointer(str(tmp_path / "jax")).restore(7, like)
    assert _equal(got, like)
    assert got["params"]["stack"]["w"].dtype == torch.bfloat16
    Checkpointer(str(tmp_path / "port")).save(7, like, blocking=True)
    man = [json.load(open(tmp_path / d / "step_7" / "manifest.json"))
           for d in ("jax", "port")]
    assert man[0] == man[1]
    files = sorted(os.listdir(tmp_path / "jax" / "step_7"))
    assert files == sorted(os.listdir(tmp_path / "port" / "step_7"))
    for f in files:
        assert filecmp.cmp(tmp_path / "jax" / "step_7" / f,
                           tmp_path / "port" / "step_7" / f, shallow=False), f


def test_tree_paths_follow_jax():
    """``tree.paths`` names the leaves in JAX's order, as
    ``jax.tree_util.tree_flatten_with_path`` names them (a named tuple's
    fields by their index)."""
    jstate = _jax_state()
    flat = jax.tree_util.tree_flatten_with_path(jstate)[0]
    opt_fields = type(jstate["opt"])._fields

    def name(k):
        if hasattr(k, "key"):
            return str(k.key)
        if hasattr(k, "idx"):
            return str(k.idx)
        return str(opt_fields.index(k.name))
    want = ["/".join(name(k) for k in path) for path, _ in flat]
    state = to_torch(jax.device_get(jstate), device="cpu")
    assert tree.paths(state) == want
    assert "params/stack/w" in want and "params/lead/0/x" in want


def test_port_checkpoint_restores_in_jax(tmp_path):
    """The other way round: JAX's restore reads the port's files, CRCs
    checked, into the values the port saved."""
    jstate = _jax_state()
    state = to_torch(jax.device_get(jstate), device="cpu")
    Checkpointer(str(tmp_path)).save(3, state, blocking=True)
    out = JaxCheckpointer(str(tmp_path)).restore(3, jstate)
    for a, b in zip(jax.tree.leaves(out), tree.leaves(state)):
        if b.dtype == torch.bfloat16:
            np.testing.assert_array_equal(
                np.asarray(a).view(np.uint16), b.view(torch.int16).numpy()
                .view(np.uint16))
        else:
            np.testing.assert_array_equal(np.asarray(a), b.numpy())


def test_failure_injector_and_restarts(monkeypatch):
    monkeypatch.setenv("REPRO_FAIL_AT_STEP", "3")
    inj = FailureInjector.from_env()
    inj.check(2)
    with pytest.raises(InjectedFailure):
        inj.check(3)
    tries = []

    def loop():
        tries.append(1)
        if len(tries) < 3:
            raise InjectedFailure("x")
        return 9
    assert run_with_restarts(loop) == 9 and len(tries) == 3


def _train(ckpt, steps, fail_at=None, seed=0):
    env = dict(os.environ, OMP_NUM_THREADS="1")
    env["PYTHONPATH"] = SRC + os.pathsep + env.get("PYTHONPATH", "")
    if fail_at is not None:
        env["REPRO_FAIL_AT_STEP"] = str(fail_at)
    else:
        env.pop("REPRO_FAIL_AT_STEP", None)
    cmd = [sys.executable, "-m", "repro_torch.launch.train", "--device",
           "cpu", "--arch", "stablelm-1.6b", "--reduced", "--steps",
           str(steps), "--batch", "2", "--seq-len", "16", "--ckpt-dir",
           ckpt, "--ckpt-every", "4", "--log-every", "4", "--seed",
           str(seed)]
    return subprocess.Popen(cmd, stdout=subprocess.PIPE,
                            stderr=subprocess.PIPE, text=True, env=env)


def _done(proc):
    out, err = proc.communicate(timeout=600)
    return proc.returncode, out, err


def test_kill_and_resume_is_bit_exact(tmp_path):
    """Killed at step 10 (after the step-8 checkpoint), resumed, against an
    uninterrupted run: every leaf of the final checkpoints is the same
    file; and a 30-step run lowers the loss."""
    d1, d2 = str(tmp_path / "interrupted"), str(tmp_path / "clean")
    clean, long_run = _train(d2, 16), _train(str(tmp_path / "long"), 30)
    rc, out, err = _done(_train(d1, 16, fail_at=10))
    assert rc != 0 and "injected failure" in out + err
    rc, out, err = _done(_train(d1, 16))
    assert rc == 0, out + err
    assert "[train] resumed from step 8" in out
    assert "[train] step 16 loss" in out
    rc, out, err = _done(clean)
    assert rc == 0, out + err
    step = "step_16"
    files = sorted(os.listdir(os.path.join(d2, step)))
    assert len(files) > 30
    for f in files:
        assert filecmp.cmp(os.path.join(d1, step, f), os.path.join(d2, step, f),
                           shallow=False), f
    rc, out, err = _done(long_run)
    assert rc == 0, out + err
    assert "improved" in out and "NOT improved" not in out, out


def test_train_cli_refuses_data_parallel():
    from repro_torch.launch.train import build_parser, train_loop
    args = build_parser().parse_args(["--arch", "stablelm-1.6b", "--reduced",
                                      "--device", "cpu", "--data-par", "2"])
    with pytest.raises(NotImplementedError, match="data-par"):
        train_loop(args)


def test_train_cli_defaults_to_the_card():
    from repro_torch.launch.train import build_parser
    assert build_parser().parse_args(["--arch", "switch128"]).device == "cuda"


# ----------------------------------------------------------------------
# checkpoints across the (data, model) grid (``launch/grid.py``) and the
# elastic restore onto another grid
# ----------------------------------------------------------------------
GRID_SAVE_WORKER = '''
import sys
import numpy as np, torch, torch.distributed as dist
rank, port, workdir = int(sys.argv[1]), sys.argv[2], sys.argv[3]
torch.set_num_threads(1)
dist.init_process_group("gloo", init_method=f"tcp://localhost:{port}",
                        rank=rank, world_size=4)
from repro_torch import tree
from repro_torch.checkpoint.checkpointer import Checkpointer
from repro_torch.configs.registry import get_config
from repro_torch.launch.grid import make_grid
from repro_torch.models.model import build_model
from repro_torch.optim.adamw import AdamWState
grid = make_grid(2, 2)
cfg = get_config("qwen15-moe-a27b").reduced()
model = build_model(cfg, batch=2, seq_len=16, device="cpu", ep_degree=2,
                    comm=grid.comm())
params = model.init(0)
opt = AdamWState(torch.tensor(3, dtype=torch.int32),
                 tree.tree_map(lambda p: p.float() * 0.5, params),
                 tree.tree_map(lambda p: p.float() ** 2, params))
ck = Checkpointer(workdir + "/grid", keep=0)
state = {"params": params, "opt": opt}
grid.save(ck, 1, state, blocking=True)
grid.save(ck, 2, state)                 # asynchronous
ck.wait()
dist.destroy_process_group()
'''

RESTORE_WORKER = '''
import sys
import numpy as np, torch, torch.distributed as dist
rank, port, workdir = int(sys.argv[1]), sys.argv[2], sys.argv[3]
torch.set_num_threads(1)
dist.init_process_group("gloo", init_method=f"tcp://localhost:{port}",
                        rank=rank, world_size=2)
from repro_torch import tree
from repro_torch.checkpoint.checkpointer import Checkpointer
from repro_torch.configs.registry import get_config
from repro_torch.launch.grid import make_grid
from repro_torch.models.model import build_model
from repro_torch.optim.adamw import adamw_init
grid = make_grid(1, 2)
cfg = get_config("qwen15-moe-a27b").reduced()
model = build_model(cfg, batch=4, seq_len=16, device="cpu", ep_degree=2,
                    comm=grid.comm())
params = model.init(1)
like = {"params": params, "opt": adamw_init(params)}
state = Checkpointer(workdir + "/jax").restore(5, like,
                                               shardings=grid.shardings(like))
np.savez(f"{workdir}/rank{rank}.npz",
         **{str(i): t.numpy() for i, t in enumerate(tree.leaves(state))})
dist.destroy_process_group()
'''

JAX_GRID_SAVE = '''
import jax
from repro.checkpoint.checkpointer import Checkpointer
from repro.configs import get_config
from repro.configs.base import ParallelConfig
from repro.launch.mesh import make_host_mesh
from repro.models.model import MeshShape, build_model
from repro.optim.adamw import adamw_init
mesh = make_host_mesh(2, 2)
ms = MeshShape(tuple(zip(mesh.axis_names, mesh.devices.shape)))
cfg = get_config("qwen15-moe-a27b").reduced()
model = build_model(cfg, ParallelConfig(), batch=4, seq_len=16,
                    mesh_shape=ms, mesh=mesh)
with mesh:
    params = model.init(jax.random.PRNGKey(3))
    opt = adamw_init(params)
    opt = opt._replace(m=jax.tree.map(lambda p: p * 0.5, params))
    Checkpointer(CKPT).save(5, {"params": params, "opt": opt},
                            blocking=True)
np.savez(OUT, ok=np.ones(1))
'''


def _same_files(d1, d2):
    files = sorted(os.listdir(d1))
    assert files == sorted(os.listdir(d2)) and len(files) > 30
    for f in files:
        assert filecmp.cmp(os.path.join(d1, f), os.path.join(d2, f),
                           shallow=False), f


def test_grid_save_is_a_one_process_save(tmp_path):
    """Four gloo processes as a (2, 2) grid, each holding its EP rank's
    expert rows, save once (blocking, then asynchronously): the files are
    byte for byte a one-process save of the same global state (the
    rank-major rows ``VirtualGroup`` holds)."""
    from _ep_helpers import run_gloo
    from repro_torch.configs.registry import get_config
    from repro_torch.models.model import build_model
    from repro_torch.optim.adamw import AdamWState
    run_gloo(GRID_SAVE_WORKER, lambda r: [str(tmp_path)], world=4)
    cfg = get_config("qwen15-moe-a27b").reduced()
    params = build_model(cfg, batch=4, seq_len=16, device="cpu",
                         ep_degree=2).init(0)
    opt = AdamWState(torch.tensor(3, dtype=torch.int32),
                     tree.tree_map(lambda p: p.float() * 0.5, params),
                     tree.tree_map(lambda p: p.float() ** 2, params))
    one = Checkpointer(str(tmp_path / "one"), keep=0)
    for step in (1, 2):
        one.save(step, {"params": params, "opt": opt}, blocking=True)
        _same_files(str(tmp_path / "grid" / f"step_{step}"),
                    str(tmp_path / "one" / f"step_{step}"))


@pytest.fixture(scope="module")
def jax_grid_ckpt(tmp_path_factory):
    """A checkpoint the JAX package writes under ``make_host_mesh(2, 2)``
    (reduced qwen15-moe-a27b, its weights and AdamW state)."""
    from _ep_helpers import run_jax
    tmp = tmp_path_factory.mktemp("jax_grid_ckpt")
    run_jax(f"import numpy as np\nCKPT = {str(tmp / 'jax')!r}\n"
            + JAX_GRID_SAVE, tmp / "ok.npz")
    return tmp


def test_jax_grid_checkpoint_restores_onto_port_grids(jax_grid_ckpt):
    """JAX's (2, 2) checkpoint onto the port's (1, 2) grid (each of two
    gloo processes loads only its own expert rows and every replicated
    leaf whole) and onto one process at G = 1 and G = 2: every leaf
    bit-equal to JAX's file."""
    from _ep_helpers import run_gloo
    from repro_torch.configs.registry import get_config
    from repro_torch.launch.grid import is_expert_path
    from repro_torch.models.model import build_model
    tmp = jax_grid_ckpt
    ck = Checkpointer(str(tmp / "jax"))
    files = [np.load(str(tmp / "jax" / "step_5" / f"leaf_{i}.npy"))
             for i in range(len(ck.manifest(5)["leaves"]))]
    cfg = get_config("qwen15-moe-a27b").reduced()
    for G in (1, 2):
        params = build_model(cfg, batch=4, seq_len=16, device="cpu",
                             ep_degree=G).init(1)
        state = ck.restore(5, {"params": params, "opt": adamw_init(params)})
        got = tree.leaves(state)
        assert len(got) == len(files)
        for t, f in zip(got, files):
            np.testing.assert_array_equal(t.numpy(), f)
    run_gloo(RESTORE_WORKER, lambda r: [str(tmp)], world=2)
    paths = tree.paths({"params": params, "opt": adamw_init(params)})
    for r in range(2):
        with np.load(str(tmp / f"rank{r}.npz")) as z:
            for i, (path, f) in enumerate(zip(paths, files)):
                want = f
                if is_expert_path(path):
                    n = f.shape[1] // 2
                    want = f[:, r * n:(r + 1) * n]
                np.testing.assert_array_equal(z[str(i)], want,
                                              err_msg=f"rank {r} {path}")


def test_restore_onto_other_padded_experts_names_the_leaf(jax_grid_ckpt):
    """Reduced qwen's 8 experts pad to 9 rows at G = 3: the checkpoint's
    expert leaves cannot match, in one process or on a grid, and the
    error names the leaf."""
    from repro_torch.configs.registry import get_config
    from repro_torch.convert import shard_params
    from repro_torch.launch.grid import ProcessGrid
    from repro_torch.models.model import build_model
    ck = Checkpointer(str(jax_grid_ckpt / "jax"))
    cfg = get_config("qwen15-moe-a27b").reduced()
    params = build_model(cfg, batch=3, seq_len=16, device="cpu",
                         ep_degree=3).init(0)
    like = {"params": params, "opt": adamw_init(params)}
    # the first leaf in the checkpoint's order that differs: the first
    # moment of the first MoE block's router, 8 columns against 9
    named = (r"checkpoint leaf 8 \(opt/1/stack/blocks/sub0/moe/router\) "
             r"has shape \[4, 128, 8\]; this process's leaf is "
             r"\[4, 128, 9\]")
    with pytest.raises(ValueError, match=named):
        ck.restore(5, like)
    grid = ProcessGrid(data=1, model=3, rank=1, ep_group=None,
                       dp_group=None, backend="gloo")
    local = shard_params(params, 1, 3)
    like = {"params": local, "opt": adamw_init(local)}
    with pytest.raises(ValueError, match=named):
        ck.restore(5, like, shardings=grid.shardings(like))
    # an expert leaf's slices: 4 rows a rank over 3 ranks are 12 rows
    params = build_model(cfg, batch=4, seq_len=16, device="cpu",
                         ep_degree=2).init(0)
    local = shard_params(params, 1, 2)
    like = {"params": local, "opt": adamw_init(local)}
    with pytest.raises(ValueError, match=r"\(opt/1/stack/blocks/sub0/moe/"
                                         r"w_gate\) has shape \[4, 8, 128, "
                                         r"64\]; .* 3 slices of axis 1: "
                                         r"\[4, 12, 128, 64\]"):
        ck.restore(5, like, shardings=grid.shardings(like))


def _torchrun(ckpt, nproc, data, steps, fail_at=None):
    """``launch.train`` under ``torch.distributed.run``, its output to a
    file beside the checkpoints (``_read`` waits for it)."""
    env = dict(os.environ, OMP_NUM_THREADS="1")
    env["PYTHONPATH"] = SRC + os.pathsep + env.get("PYTHONPATH", "")
    env.pop("REPRO_FAIL_AT_STEP", None)
    if fail_at is not None:
        env["REPRO_FAIL_AT_STEP"] = str(fail_at)
    cmd = [sys.executable, "-m", "torch.distributed.run", "--standalone",
           "--nproc-per-node", str(nproc), "-m", "repro_torch.launch.train",
           "--device", "cpu", "--arch", "qwen15-moe-a27b", "--reduced",
           "--steps", str(steps), "--batch", "4", "--seq-len", "16",
           "--ckpt-dir", ckpt, "--ckpt-every", "2", "--log-every", "2",
           "--data-par", str(data), "--model-par", "2"]
    log = f"{ckpt}.{nproc}.log"
    with open(log, "w") as f:
        return subprocess.Popen(cmd, stdout=f, stderr=subprocess.STDOUT,
                                env=env), log


def _read(run):
    proc, log = run
    proc.wait(timeout=600)
    with open(log) as f:
        out = f.read()
    return proc.returncode, out, ""


def test_grid_kill_and_resume_onto_another_grid(tmp_path):
    """``launch.train --data-par 2 --model-par 2`` on four gloo processes
    under ``torch.distributed.run``, killed at step 3 (after the step-2
    checkpoint) and resumed onto (1, 2), against a run that stops at step
    2 on (2, 2) and goes on from there on (1, 2): both checkpoints are
    the same files, the resumed run skipping the batches the killed one
    took (``examples/elastic_restart.py``, steps 1-3).  The last
    checkpoint restores onto one process at G = 1, every leaf equal to
    its file."""
    from repro_torch.configs.registry import get_config
    from repro_torch.models.model import build_model
    killed, clean = str(tmp_path / "killed"), str(tmp_path / "clean")
    first = [_torchrun(killed, 4, 2, 6, fail_at=3),
             _torchrun(clean, 4, 2, 2)]
    (rc_k, out_k, err_k), (rc_c, out_c, err_c) = map(_read, first)
    assert rc_k != 0 and "injected failure" in out_k + err_k
    assert rc_c == 0, out_c + err_c
    assert "[train] step 2 loss" in out_c
    _same_files(os.path.join(killed, "step_2"), os.path.join(clean, "step_2"))
    second = [_torchrun(killed, 2, 1, 6), _torchrun(clean, 2, 1, 6)]
    for rc, out, err in map(_read, second):
        assert rc == 0, out + err
        assert out.count("[train] resumed from step 2") == 1, out
        assert "[train] step 6 loss" in out
    _same_files(os.path.join(killed, "step_6"), os.path.join(clean, "step_6"))
    cfg = get_config("qwen15-moe-a27b").reduced()
    params = build_model(cfg, batch=4, seq_len=16, device="cpu").init(0)
    ck = Checkpointer(clean)
    state = ck.restore(6, {"params": params, "opt": adamw_init(params)})
    for i, t in enumerate(tree.leaves(state)):
        f = np.load(os.path.join(clean, "step_6", f"leaf_{i}.npy"))
        np.testing.assert_array_equal(t.numpy(), f)
