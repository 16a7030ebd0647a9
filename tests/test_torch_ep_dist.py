"""``DistComm``: four CPU processes on gloo, each holding only its own
expert rows (``convert.expert_shard``), run the port's MoE block and
give what ``VirtualGroup`` gives in one process on the same inputs: y
within 2e-5, the integer diagnostics exactly, rank 0's aux loss within
1e-6 (the aux loss is each rank's own; the block reports rank 0's).
The skewed case draws each rank's assignment from the same key path in
both, so it also shows that a rank draws alike as a virtual rank and as
a process."""
import json
import os
import socket
import subprocess
import sys
import textwrap

import numpy as np
import pytest
import torch

from repro_torch.configs.base import MoEConfig
from repro_torch.core import dispatch as TD
from repro_torch.core.moe_layer import MoEBlockSpec, moe_block
from repro_torch.core.router import SkewKey

from _ep_helpers import one_torch_thread  # noqa: F401 (autouse)

SRC = os.path.join(os.path.dirname(__file__), "..", "src")
G = 4
B, S, D_MODEL, F, E = 2, 16, 16, 32, 10
CASES = {
    "harmoeny": dict(policy="harmoeny"),
    "round_robin": dict(policy="round_robin"),
    "even_split": dict(policy="even_split", num_foreign_slots=9),
    "static_opt": dict(policy="static_opt",
                       placement=(3, 7, 1, 0, 5, 2, 9, 11, 4, 6, 8, 10)),
    "harmoeny_skew": dict(policy="harmoeny", router_skew=0.9),
}

WORKER = textwrap.dedent('''
    import json, sys
    import numpy as np, torch, torch.distributed as dist
    rank, port, workdir = int(sys.argv[1]), sys.argv[2], sys.argv[3]
    dist.init_process_group("gloo", init_method=f"tcp://localhost:{port}",
                            rank=rank, world_size=int(sys.argv[4]))
    from repro_torch.configs.base import MoEConfig
    from repro_torch.convert import expert_shard
    from repro_torch.core.dispatch import DistComm
    from repro_torch.core.moe_layer import MoEBlockSpec, moe_block
    from repro_torch.core.router import SkewKey
    spec_args = json.load(open(workdir + "/cases.json"))
    inputs = np.load(workdir + "/inputs.npz")
    comm = DistComm()
    out = {}
    for name, a in spec_args.items():
        spec = MoEBlockSpec(moe=MoEConfig(**a["moe"]), **a["block"])
        params = {k: torch.from_numpy(inputs[name + "|" + k])
                  for k in ("router", "w_in", "w_out", "w_gate")}
        y, diag = moe_block(torch.from_numpy(inputs["x"]),
                            expert_shard(params, rank, comm.size), spec=spec,
                            comm=comm, skew_key=SkewKey((5,)),
                            valid_mask=torch.from_numpy(inputs["vmask"]))
        out[name + "|y"] = y.numpy()
        out.update({name + "|" + k: v.numpy() for k, v in diag.items()})
    np.savez(f"{workdir}/rank{rank}.npz", **out)
    dist.destroy_process_group()
''')


def _spec_args(name):
    moe = dict(num_experts=E, num_experts_per_tok=2, d_ff_expert=F,
               capacity_factor=2.0, q_tokens=1, num_foreign_slots=2)
    moe.update(CASES[name])
    return {"moe": moe, "block": dict(d_model=D_MODEL, ep_degree=G,
                                      tokens_local=B * S, block_m=8)}


def _spec(name):
    a = _spec_args(name)
    moe = dict(a["moe"])
    if moe.get("placement"):
        moe["placement"] = tuple(moe["placement"])
    return MoEBlockSpec(moe=MoEConfig(**moe), **a["block"])


def _inputs():
    rng = np.random.default_rng(0)
    x = rng.normal(size=(B, S, D_MODEL)).astype(np.float32)
    vmask = np.ones((B, S), bool)
    vmask[0, 13:] = False
    arrays = {"x": x, "vmask": vmask}
    for name in CASES:
        rows = 12                          # 10 experts padded to 12 slots
        arrays[name + "|router"] = (rng.normal(size=(D_MODEL, 12)) * 0.5
                                    ).astype(np.float32)
        for w, shape in (("w_in", (rows, D_MODEL, F)),
                         ("w_out", (rows, F, D_MODEL)),
                         ("w_gate", (rows, D_MODEL, F))):
            arrays[name + "|" + w] = (rng.normal(size=shape) * 0.3
                                      ).astype(np.float32)
    return arrays


@pytest.fixture(scope="module")
def gloo_results(tmp_path_factory):
    work = tmp_path_factory.mktemp("gloo")
    arrays = _inputs()
    np.savez(work / "inputs.npz", **arrays)
    with open(work / "cases.json", "w") as fh:
        json.dump({n: _spec_args(n) for n in CASES}, fh)
    with socket.socket() as s:
        s.bind(("localhost", 0))
        port = s.getsockname()[1]
    env = dict(os.environ, PYTHONPATH=os.path.abspath(SRC),
               OMP_NUM_THREADS="1")
    procs = [subprocess.Popen(
        [sys.executable, "-c", WORKER, str(r), str(port), str(work), str(G)],
        env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
        for r in range(G)]
    try:
        errs = [p.communicate(timeout=180)[1] for p in procs]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    for r, p in enumerate(procs):
        assert p.returncode == 0, f"rank {r}:\n{errs[r]}"
    ranks = []
    for r in range(G):
        with np.load(work / f"rank{r}.npz") as z:
            ranks.append({k: z[k] for k in z.files})
    return arrays, ranks


@pytest.mark.parametrize("name", list(CASES))
def test_distcomm_on_gloo_equals_virtual_group(gloo_results, name):
    arrays, ranks = gloo_results
    spec = _spec(name)
    params = {k: torch.from_numpy(arrays[name + "|" + k])
              for k in ("router", "w_in", "w_out", "w_gate")}
    y, diag = moe_block(torch.from_numpy(arrays["x"]), params, spec=spec,
                        comm=TD.VirtualGroup(G, "cpu"),
                        skew_key=SkewKey((5,)),
                        valid_mask=torch.from_numpy(arrays["vmask"]))
    for r, got in enumerate(ranks):
        np.testing.assert_allclose(got[name + "|y"], y.numpy(), atol=2e-5,
                                   rtol=2e-5, err_msg=f"rank {r}")
        for key, v in diag.items():
            if key == "aux_loss":
                if r == 0:
                    np.testing.assert_allclose(got[name + "|" + key],
                                               v.numpy(), atol=1e-6)
                continue
            np.testing.assert_array_equal(got[name + "|" + key], v.numpy(),
                                          err_msg=f"rank {r} {key}")
    if name.startswith("harmoeny"):
        assert float(diag["moved_units"]) > 0
        assert float(diag["send_drops"] + diag["dest_drops"]) == 0


def test_distcomm_needs_a_process_group():
    import torch.distributed as dist
    if dist.is_available() and dist.is_initialized():
        pytest.skip("a process group is already initialized here")
    with pytest.raises(RuntimeError, match="process group"):
        TD.DistComm()
