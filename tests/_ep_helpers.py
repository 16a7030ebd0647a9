"""Shared helpers for the expert-parallel port tests: the JAX side at
G > 1 runs in a subprocess with fake host devices (the main pytest
process keeps one device, see conftest.py) and hands its arrays over
through an npz file."""
import os
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
