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
