"""``DistComm`` under autograd: the MoE block across 2 and 4 gloo
processes, each holding its own expert rows, gives on every process the
input's and every parameter's gradient that ``VirtualGroup`` gives in one
process (one graph over all ranks), with the dense and the hosted fetch:
under the 0.9 skew with harmoeny (foreign rows, whose gradient goes back
to the hosting rank) and round_robin, and on learned routes with the aux
loss in the loss (the router's gradient summed over the ranks, rank 0's
aux value with the ranks' mean gradient) under harmoeny and even_split
(the gathered expert rows feed each rank's own work).  At G = 4 the skewed
cases also run on ``test_torch_train.py``'s ``MOE_BODY`` routes and
weights and are held to its ``jax.grad`` on a (1, 4) mesh.  Every process
computes the same loss.  Tolerance: 1e-5 x max(1, the reference leaf's
largest magnitude), the MoE block's in ``test_torch_train.py``."""
import json

import numpy as np
import pytest
import torch

from repro_torch.configs.base import MoEConfig
from repro_torch.core import dispatch as TD
from repro_torch.core.moe_layer import MoEBlockSpec, moe_block
from repro_torch.core.router import SkewKey

from _ep_helpers import (one_torch_thread, run_gloo,  # noqa: F401
                         run_jax, unflatten)
from test_torch_train import MOE_BODY

B, S, D_MODEL, F, E = 2, 16, 16, 32, 8
FETCH = ("dense", "hosted")
OWN = {
    "skew_harmoeny": dict(policy="harmoeny", router_skew=0.9),
    "skew_round_robin": dict(policy="round_robin", router_skew=0.9),
    "learned_harmoeny": dict(policy="harmoeny"),
    "learned_even_split": dict(policy="even_split", num_foreign_slots=7),
}
JAX_CASES = ("harmoeny", "round_robin")       # MOE_BODY's, at G = 4
CASES = ([(G, c, f) for G in (2, 4) for c in OWN for f in FETCH]
         + [(4, "jax_" + p, f) for p in JAX_CASES for f in FETCH])
AUX = 0.37                       # the aux loss's weight in the test loss

WORKER = '''
import json, sys
import numpy as np, torch, torch.distributed as dist
rank, port, workdir, world = (int(sys.argv[1]), sys.argv[2], sys.argv[3],
                              int(sys.argv[4]))
torch.set_num_threads(1)
dist.init_process_group("gloo", init_method=f"tcp://localhost:{port}",
                        rank=rank, world_size=world)
from repro_torch.configs.base import MoEConfig
from repro_torch.convert import expert_shard
from repro_torch.core.dispatch import DistComm
from repro_torch.core.moe_layer import MoEBlockSpec, moe_block
from repro_torch.core.router import SkewKey
cases = json.load(open(f"{workdir}/cases{world}.json"))
inp = np.load(f"{workdir}/inputs{world}.npz")
out = {}
for name, a in cases.items():
    spec = MoEBlockSpec(moe=MoEConfig(**a["moe"]), **a["block"])
    full = {k: torch.from_numpy(inp[name + "|p/" + k]) for k in a["leaves"]}
    kw = {}
    if name + "|assign" in inp.files:
        kw["skew_assign"] = torch.from_numpy(
            inp[name + "|assign"][rank:rank + 1])
    elif a["moe"].get("router_skew"):
        kw["skew_key"] = SkewKey((5,))
    for fetch in a["fetch"]:
        params = {k: v.clone().requires_grad_(True)
                  for k, v in expert_shard(full, rank, world).items()}
        x = torch.from_numpy(inp[name + "|x"]).requires_grad_(True)
        y, diag = moe_block(x, params, spec=spec,
                            comm=DistComm(fetch=fetch), kernels=False, **kw)
        loss = ((y * torch.from_numpy(inp[name + "|ct"])).sum()
                + AUX * diag["aux_loss"].sum())
        gx, *gp = torch.autograd.grad(loss, [x, *params.values()],
                                    allow_unused=True,
                                    materialize_grads=True)
        tag = f"{name}|{fetch}|"
        out[tag + "loss"] = loss.detach().numpy()
        out[tag + "gx"] = gx.numpy()
        out.update({tag + "g/" + k: g.numpy() for k, g in zip(params, gp)})
np.savez(f"{workdir}/out{world}_{rank}.npz", **out)
dist.destroy_process_group()
'''.replace("AUX", repr(AUX))


def _jax_spec(policy):
    """``MOE_BODY``'s block."""
    moe = dict(num_experts=8, num_experts_per_tok=1, d_ff_expert=32,
               policy=policy, capacity_factor=1.25, q_tokens=2,
               num_foreign_slots=4, router_skew=0.9, router_skew_experts=1)
    return {"moe": moe, "block": dict(d_model=16, ep_degree=4,
                                      tokens_local=2 * 64, block_m=8,
                                      act="silu")}


def _own_spec(name, G):
    moe = dict(num_experts=E, num_experts_per_tok=2, d_ff_expert=F,
               capacity_factor=2.0, q_tokens=1, num_foreign_slots=2)
    moe.update(OWN[name])
    return {"moe": moe, "block": dict(d_model=D_MODEL, ep_degree=G,
                                      tokens_local=B * S, block_m=8)}


def _inputs(name, G, jax_rec):
    """(spec arguments, the case's npz entries) of one case."""
    if name.startswith("jax_"):
        rec = {k.split("|", 1)[1]: v for k, v in jax_rec.items()
               if k.startswith(name[4:] + "|")}
        a = _jax_spec(name[4:])
        p = unflatten(rec, "params")
        ent = {"x": rec["x"], "ct": rec["ct"], "assign": rec["assign"]}
    else:
        a = _own_spec(name, G)
        spec = MoEBlockSpec(moe=MoEConfig(**a["moe"]), **a["block"])
        rng = np.random.default_rng(G * 100 + sorted(OWN).index(name))
        n_rows = spec.topo.num_ranks * spec.topo.experts_per_rank
        p = {"router": rng.normal(0, 0.3, (D_MODEL, spec.topo.padded_experts)),
             "w_in": rng.normal(0, 0.3, (n_rows, D_MODEL, F)),
             "w_gate": rng.normal(0, 0.3, (n_rows, D_MODEL, F)),
             "w_out": rng.normal(0, 0.3, (n_rows, F, D_MODEL))}
        ent = {"x": rng.normal(size=(B, S, D_MODEL)),
               "ct": rng.normal(size=(B, S, D_MODEL))}
    a["leaves"] = sorted(p)
    ent.update({"p/" + k: v for k, v in p.items()})
    return a, {k: (v.astype(np.float32) if v.dtype.kind == "f" else v)
               for k, v in ent.items()}


def _virtual(a, ent, G):
    """``VirtualGroup(G)``'s loss and gradients on one case."""
    spec = MoEBlockSpec(moe=MoEConfig(**a["moe"]), **a["block"])
    params = {k: torch.from_numpy(ent["p/" + k]).requires_grad_(True)
              for k in a["leaves"]}
    x = torch.from_numpy(ent["x"]).requires_grad_(True)
    kw = ({"skew_assign": torch.from_numpy(ent["assign"])}
          if "assign" in ent else
          {"skew_key": SkewKey((5,))} if a["moe"].get("router_skew")
          else {})
    y, diag = moe_block(x, params, spec=spec, comm=TD.VirtualGroup(G, "cpu"),
                        kernels=False, **kw)
    loss = (y * torch.from_numpy(ent["ct"])).sum() \
        + AUX * diag["aux_loss"].sum()
    gx, *gp = torch.autograd.grad(loss, [x, *params.values()],
                                  allow_unused=True, materialize_grads=True)
    return float(loss.detach()), gx.numpy(), {k: g.numpy()
                                     for k, g in zip(params, gp)}


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """The JAX block's gradients (``MOE_BODY``, one subprocess), every
    case's ``VirtualGroup`` reference, and each process's answers from
    one gloo run a world size."""
    tmp = tmp_path_factory.mktemp("dist_autograd")
    jax_rec = run_jax("import numpy as np\n" + MOE_BODY, tmp / "jax.npz")
    ref = {}
    for G in (2, 4):
        cases, npz = {}, {}
        for (g, name, _) in CASES:
            if g != G or name in cases:
                continue
            a, ent = _inputs(name, G, jax_rec)
            a["fetch"] = list(FETCH)
            cases[name] = a
            npz.update({f"{name}|{k}": v for k, v in ent.items()})
            ref[(G, name)] = _virtual(a, ent, G) + (a, ent)
        with open(tmp / f"cases{G}.json", "w") as f:
            json.dump(cases, f)
        np.savez(tmp / f"inputs{G}.npz", **npz)
        run_gloo(WORKER, lambda r, G=G: [str(tmp), str(G)], world=G)
    out = {G: [dict(np.load(tmp / f"out{G}_{r}.npz")) for r in range(G)]
           for G in (2, 4)}
    return jax_rec, ref, out


def _close(got, want, what):
    np.testing.assert_allclose(got, want, rtol=0, err_msg=what,
                               atol=1e-5 * max(1.0, float(np.abs(want).max())))


@pytest.mark.parametrize("G,name,fetch", CASES)
def test_dist_comm_gradients_match_virtual_group(runs, G, name, fetch):
    jax_rec, ref, out = runs
    loss, gx, gp, a, _ = ref[(G, name)]
    epr = gp["w_in"].shape[0] // G
    tag = f"{name}|{fetch}|"
    for r, rec in enumerate(out[G]):
        # every process computes the same loss, the reference's
        np.testing.assert_allclose(float(rec[tag + "loss"]), loss,
                                   rtol=1e-6, atol=1e-5)
        _close(rec[tag + "gx"], gx, f"rank {r} x")
        for k in a["leaves"]:
            want = gp[k] if k == "router" else gp[k][r * epr:(r + 1) * epr]
            _close(rec[tag + "g/" + k], want, f"rank {r} {k}")
    if name.startswith("jax_"):
        # MOE_BODY's routes give every rank's expert rows a gradient
        for r, rec in enumerate(out[G]):
            assert all(float(np.abs(rec[tag + "g/" + k]).max()) > 0
                       for k in ("w_in", "w_out", "w_gate")), r
        # and the port's VirtualGroup (so each process) is JAX's
        rec = {k.split("|", 1)[1]: v for k, v in jax_rec.items()
               if k.startswith(name[4:] + "|")}
        _close(gx, rec["gx"], "x against jax.grad")
        jg = unflatten(rec, "grads")
        for k in ("w_in", "w_out", "w_gate"):
            _close(gp[k], jg[k], f"{k} against jax.grad")


def test_dist_collectives_build_no_graph_without_grad(monkeypatch):
    """Serving's path: without an input that requires grad, ``DistComm``
    runs the raw collectives and builds no autograd node (checked with a
    stand-in for ``torch.distributed`` in one process)."""
    calls = []

    class FakeDist:
        class ReduceOp:
            MAX = "max"

        @staticmethod
        def all_gather_into_tensor(out, x, group=None):
            calls.append("all_gather")
            out.copy_(x)

        @staticmethod
        def all_to_all_single(out, x, group=None, **kw):
            calls.append("all_to_all")
            out.copy_(x)

        @staticmethod
        def all_reduce(x, op=None, group=None):
            calls.append("all_reduce")

    comm = TD.DistComm.__new__(TD.DistComm)
    comm._dist, comm.group, comm.rank, comm.size = FakeDist, None, 0, 1
    x = torch.randn(1, 3)
    for fn in (comm.all_gather, comm.all_to_all, comm.psum, comm.enter):
        assert fn(x).grad_fn is None
    w = torch.randn(1, 3, requires_grad=True)
    outs = [comm.all_gather(w), comm.all_to_all(w), comm.psum(w),
            comm.enter(w), comm.rank0_mean_grad([w.sum()])]
    assert all(o.grad_fn is not None for o in outs)
    sum(o.sum() for o in outs).backward()
    # all_gather: own slice; all_to_all: reverse; psum: through; enter:
    # the ranks' sum; rank 0's value: over G (= 1)
    torch.testing.assert_close(w.grad, torch.full((1, 3), 5.0))
    assert calls[:7] == ["all_gather", "all_to_all", "all_reduce",
                         "all_gather", "all_to_all", "all_reduce",
                         "all_gather"]
    assert sorted(calls[7:]) == ["all_reduce", "all_to_all"]
