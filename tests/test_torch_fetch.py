"""The foreign-weight fetch's forms (the ``fetch_rows`` collective of
``core/dispatch.py``) against the dense form and the JAX function.

- ``VirtualGroup``'s gather from the rank-major weight equals the dense
  form (each source's ``[G, K]`` outbox, an all-to-all, a sum over
  sources) bit for bit, in f32 and bf16, at G = 2, 4 and 8, on FIDS from
  the harmoeny and round_robin schedules (with and without replica
  tables) and on random FIDS with -1 entries.
- Four gloo processes: ``DistComm(fetch="hosted")`` (only the hosted
  rows, an uneven all-to-all) equals ``DistComm(fetch="dense")``, with and
  without ``fetch_chunk``, and the gather, bit for bit; it sends fewer
  bytes; and under the CPU host-sync guard of the capture tests the dense
  form is clean while the hosted form is caught reading FIDS on the host.
- The port's dense form chunked by ``fetch_chunk`` equals JAX's
  ``fetch_foreign_weights`` under ``shard_map`` on
  ``tests/test_prefetch_fetch.py``'s cells (a chunk that does not divide
  the last dimension, a chunk at or past it, hosts_per_expert 1, 2 and
  4, bf16), and its chunked and unchunked results are equal exactly.
- On the card (``cuda``): the hosted form raises inside a CUDA graph
  capture."""
import json
import os
import textwrap

import numpy as np
import pytest
import torch

from repro_torch.core import dispatch as TD
from repro_torch.core import prefetch as TP
from repro_torch.core import scheduler as TS
from repro_torch.core.dispatch import replica_slot_map
from repro_torch.core.topology import make_topology

from _ep_helpers import (TESTS, one_torch_thread,  # noqa: F401 (autouse)
                         run_gloo, run_jax)

DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}


def _weights(G, E, d, F, dtype, seed):
    topo = make_topology(G, E)
    rows = G * topo.experts_per_rank
    w = np.random.default_rng(seed).normal(size=(rows, d, F))
    return topo, torch.from_numpy(w.astype(np.float32)).to(DTYPES[dtype])


def _fids(topo, kind, K, seed, replicas):
    """FIDS [G, K]: from a skewed schedule under ``kind`` (harmoeny or
    round_robin; the replica table, if any, counted as local holders as
    the MoE block does), or random non-local ids with -1 entries."""
    G, Ep = topo.num_ranks, topo.padded_experts
    rng = np.random.default_rng(seed)
    rep = None
    if replicas:
        rep = torch.from_numpy(rng.integers(-1, topo.num_experts,
                                            (G, 2)).astype(np.int32))
    if kind == "random":
        lso = TD.local_slot_of(topo)
        fids = np.full((G, K), -1, np.int32)
        for g in range(G):
            cand = [e for e in range(topo.num_experts) if lso[g, e] < 0]
            pick = rng.choice(cand, size=min(K, len(cand)), replace=False)
            fids[g, :len(pick)] = pick
        fids[rng.random((G, K)) < 0.3] = -1
        return torch.from_numpy(fids)
    counts = rng.integers(0, 4, (G, Ep)).astype(np.int32)
    counts[:, topo.num_experts:] = 0
    counts[:, 1] += 12 * G                         # one hot expert
    S, _ = TS.schedule(torch.from_numpy(counts), topo, policy=kind, q=1,
                       c_pair=64, num_foreign_slots=K,
                       extra_local=(None if rep is None else
                                    replica_slot_map(rep, Ep) >= 0))
    return TP.all_foreign_ids(S, topo, K, replica_ids=rep)


def dense_group(w_global, fids, topo, chunk=0, calls=None):
    """What every rank's dense fetch gives, the all-to-all assembled here:
    destination me sums, over sources in rank order, the rows each
    source's outbox holds for it."""
    G, epr = topo.num_ranks, topo.experts_per_rank

    def a2a(x):                     # a source's outbox, one source deep
        if calls is not None:
            calls.append(tuple(x.shape))
        return x[None]
    outboxes = [TD.dense_fetch(w_global[s * epr:(s + 1) * epr], fids, s,
                               topo, a2a, chunk) for s in range(G)]
    return [torch.stack([ob[me] for ob in outboxes]).sum(dim=0)
            for me in range(G)]


def _gather_group(w_global, fids, topo, adjacent=True):
    G, epr = topo.num_ranks, topo.experts_per_rank
    rows = [w_global[g * epr:(g + 1) * epr] for g in range(G)]
    if not adjacent:
        rows = [r.clone() for r in rows]
    got = TD.VirtualGroup(G, "cpu").run_ranks(
        lambda me: TP.fetch_foreign_weights(rows[me], fids, me, topo))
    return [TP.join(f) for f in got]


def _oracle(w_global, fids, topo, me):
    """Destination ``me``'s k-th row: its expert's weight, zeros for -1."""
    rows = TD.device_tables(topo, "cpu").expert_row
    return torch.stack([w_global[rows[e]] if e >= 0
                        else torch.zeros_like(w_global[0])
                        for e in fids[me].tolist()])


@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("replicas", [False, True], ids=["", "replicas"])
@pytest.mark.parametrize("kind", ["harmoeny", "round_robin", "random"])
@pytest.mark.parametrize("G,E", [(2, 6), (4, 16), (8, 16)])
def test_virtual_group_gather_equals_dense_fetch(G, E, kind, replicas,
                                                 dtype):
    topo, w = _weights(G, E, 4, 6, dtype, seed=G * 10 + E)
    K = 3
    fids = _fids(topo, kind, K, seed=G + E, replicas=replicas)
    want = dense_group(w, fids, topo)
    got = _gather_group(w, fids, topo, adjacent=G != 8)
    for me in range(G):
        assert got[me].dtype == w.dtype and got[me].shape == (K, 4, 6)
        assert torch.equal(got[me], want[me]), f"rank {me}"
        assert torch.equal(got[me], _oracle(w, fids, topo, me))
    if kind == "round_robin":
        assert (fids < 0).all()         # static policies fetch nothing
    elif kind == "random":
        assert (fids >= 0).any() and (fids < 0).any()
    elif not replicas:                  # a replica may hold the hot expert
        assert (fids >= 0).any()


def test_virtual_group_gather_refuses_shared_hosts():
    topo, w = _weights(4, 2, 2, 3, "float32", seed=1)    # E < G: 2 hosts
    fids = torch.tensor([[1], [0], [-1], [1]], dtype=torch.int32)
    with pytest.raises(ValueError, match="hosts_per_expert"):
        _gather_group(w, fids, topo)


# ----------------------------------------------------------------------
# DistComm on four gloo processes
# ----------------------------------------------------------------------
G4, E4, D4, F4, K4 = 4, 16, 8, 12, 3
DIST_CASES = {f"{kind}/{dt}": (kind, dt) for kind in ("harmoeny", "random")
              for dt in DTYPES}
CHUNK = 5                          # does not divide F4: a padded last chunk

WORKER = textwrap.dedent('''
    import json, sys
    import numpy as np, torch, torch.distributed as dist
    rank, port, work, tests = (int(sys.argv[1]), sys.argv[2], sys.argv[3],
                               sys.argv[4])
    sys.path.insert(0, tests)
    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=f"tcp://localhost:{port}",
                            rank=rank, world_size=4)
    from repro_torch.core.dispatch import DistComm
    from repro_torch.core.topology import make_topology
    from test_torch_capture import HostSyncGuard
    meta = json.load(open(work + "/meta.json"))
    z = np.load(work + "/inputs.npz")
    topo = make_topology(4, meta["E"])
    epr = topo.experts_per_rank
    forms = {"dense": DistComm(fetch="dense"),
             "hosted": DistComm(fetch="hosted")}
    out, sent = {}, {}
    for name, dt in meta["cases"].items():
        w = torch.from_numpy(z[name + "|w"]).to(getattr(torch, dt))
        w_me = w[rank * epr:(rank + 1) * epr]
        fids = torch.from_numpy(z[name + "|fids"])
        for form, comm in forms.items():
            for chunk in (0, meta["chunk"]):
                before = comm.fetch_bytes
                got = comm.fetch_rows(w_me, fids, rank, topo, chunk)
                assert got.done is None         # no side stream on the CPU
                out[f"{name}|{form}|{chunk}"] = got.rows.float().numpy()
                sent[f"{name}|{form}|{chunk}"] = comm.fetch_bytes - before
    guard = {}
    name = next(iter(meta["cases"]))
    w_me = torch.from_numpy(z[name + "|w"])[rank * epr:(rank + 1) * epr]
    fids = torch.from_numpy(z[name + "|fids"])
    for form, comm in forms.items():
        g = HostSyncGuard()
        with g:
            comm.fetch_rows(w_me, fids, rank, topo, 0)
        guard[form] = {"hits": g.hits, "ops": g.ops}
    np.savez(f"{work}/rank{rank}.npz", **out)
    json.dump({"sent": sent, "guard": guard,
               "describe": {f: c.describe() for f, c in forms.items()}},
              open(f"{work}/rank{rank}.json", "w"))
    dist.destroy_process_group()
''')


@pytest.fixture(scope="module")
def gloo_fetch(tmp_path_factory):
    work = tmp_path_factory.mktemp("fetch")
    inputs, cases = {}, {}
    for i, (name, (kind, dt)) in enumerate(DIST_CASES.items()):
        topo, w = _weights(G4, E4, D4, F4, dt, seed=20 + i)
        fids = _fids(topo, kind, K4, seed=30 + i, replicas=False)
        inputs[name + "|w"] = w.float().numpy()
        inputs[name + "|fids"] = fids.numpy()
        cases[name] = dt
    np.savez(work / "inputs.npz", **inputs)
    with open(work / "meta.json", "w") as fh:
        json.dump({"E": E4, "chunk": CHUNK, "cases": cases}, fh)
    run_gloo(WORKER, lambda r: (str(work), TESTS))
    ranks = []
    for r in range(G4):
        with np.load(work / f"rank{r}.npz") as z:
            arrays = {k: z[k] for k in z.files}
        with open(work / f"rank{r}.json") as fh:
            ranks.append((arrays, json.load(fh)))
    return inputs, ranks


@pytest.mark.parametrize("name", list(DIST_CASES))
def test_distcomm_hosted_equals_dense_on_gloo(gloo_fetch, name):
    inputs, ranks = gloo_fetch
    dt = DIST_CASES[name][1]
    topo = make_topology(G4, E4)
    w = torch.from_numpy(inputs[name + "|w"]).to(DTYPES[dt])
    fids = torch.from_numpy(inputs[name + "|fids"])
    gather = _gather_group(w, fids, topo)
    for r, (arrays, meta) in enumerate(ranks):
        dense = arrays[f"{name}|dense|0"]
        for key in (f"{name}|hosted|0", f"{name}|hosted|{CHUNK}",
                    f"{name}|dense|{CHUNK}"):
            np.testing.assert_array_equal(arrays[key], dense,
                                          err_msg=f"rank {r} {key}")
        np.testing.assert_array_equal(gather[r].float().numpy(), dense)
        sent = meta["sent"]
        hosted_rows = int(((fids >= 0)
                           & (torch.from_numpy(topo.host_of[
                               fids.clamp(min=0).numpy(), 0]) == r)).sum())
        row_bytes = D4 * F4 * w.element_size()
        assert sent[f"{name}|hosted|0"] == hosted_rows * row_bytes
        assert sent[f"{name}|dense|0"] == (G4 - 1) * K4 * row_bytes
    assert (fids >= 0).any()


def test_hosted_fetch_reads_the_host_and_dense_does_not(gloo_fetch):
    """Under the capture tests' host-sync guard the dense form dispatches
    no host read; the hosted form is caught (its split sizes and row
    indices come from FIDS on the host), which is why it runs eager."""
    _, ranks = gloo_fetch
    for arrays, meta in ranks:
        g = meta["guard"]
        assert g["dense"]["ops"] > 5 and g["dense"]["hits"] == []
        assert g["hosted"]["hits"]
        assert meta["describe"]["dense"]["capturable"] is False  # gloo
        assert meta["describe"]["hosted"]["fetch"] == "hosted"


def test_distcomm_refuses_an_unknown_fetch_form(tmp_path):
    import torch.distributed as dist
    if dist.is_initialized():
        pytest.skip("a process group is already initialized here")
    dist.init_process_group("gloo", init_method=f"file://{tmp_path}/pg",
                            rank=0, world_size=1)
    try:
        with pytest.raises(ValueError, match="fetch form"):
            TD.DistComm(fetch="sparse")
    finally:
        dist.destroy_process_group()


# ----------------------------------------------------------------------
# the chunked dense form against JAX
# ----------------------------------------------------------------------
# tests/test_prefetch_fetch.py's cells: (G, E, d, F, K, chunks, dtype,
# an unused last slot)
JAX_CELLS = {
    "g8e4": (8, 4, 3, 7, 2, [3, 5], "float32", True),      # 2 hosts
    "g8e2": (8, 2, 2, 5, 1, [2, 3], "float32", False),     # 4 hosts
    "g4e8": (4, 8, 3, 7, 2, [3, 4], "float32", True),      # epr 2
    "g4e2": (4, 2, 2, 7, 1, [7, 16], "float32", False),    # chunk >= F
    "g4e2_bf16": (4, 2, 2, 7, 1, [4], "bfloat16", False),
}

JAX_BODY = '''
import numpy as np, jax, jax.numpy as jnp
from jax.sharding import Mesh, PartitionSpec as P
from repro.core.compat import shard_map
from repro.core.prefetch import fetch_foreign_weights
from repro.core.topology import make_topology
out = {}
for name, (G, E, d, F, K, chunks, dtype, empty) in CELLS.items():
    mesh = Mesh(np.array(jax.devices()[:G]), ("model",))
    topo = make_topology(G, E)
    epr = topo.experts_per_rank
    rng = np.random.default_rng(G * 100 + E)
    w = rng.normal(size=(G * epr, d, F)).astype(np.float32)
    fids = np.zeros((G, K), np.int32)
    for g in range(G):
        local = {int(e) for e in topo.slot_map[g]}
        cand = [e for e in range(E) if e not in local]
        fids[g] = (cand * K)[:K]
    if empty:
        fids[:, -1] = -1
    for c in [0] + chunks:
        def body(w_local):
            return fetch_foreign_weights(
                w_local, jnp.asarray(fids), jax.lax.axis_index("model"),
                topo, axis_name="model", fetch_chunk=c)
        f = shard_map(body, mesh=mesh, in_specs=P("model"),
                      out_specs=P("model"))
        with mesh:
            got = jax.jit(f)(jnp.asarray(w).astype(getattr(jnp, dtype)))
        out[f"{name}/{c}"] = np.asarray(got, np.float32)
    out[name + "/w"], out[name + "/fids"] = w, fids
np.savez(OUT, **out)
'''


@pytest.fixture(scope="module")
def jax_fetch(tmp_path_factory):
    body = f"CELLS = {JAX_CELLS!r}\n" + JAX_BODY
    return run_jax(body, tmp_path_factory.mktemp("jfetch") / "f.npz",
                   devices=8)


@pytest.mark.parametrize("cell", list(JAX_CELLS))
def test_chunked_dense_fetch_equals_jax(jax_fetch, cell):
    G, E, d, F, K, chunks, dtype, _ = JAX_CELLS[cell]
    topo = make_topology(G, E)
    w = torch.from_numpy(jax_fetch[cell + "/w"]).to(DTYPES[dtype])
    fids = torch.from_numpy(jax_fetch[cell + "/fids"])
    base = dense_group(w, fids, topo)

    def same_as_jax(got, want):
        # up to two hosts an expert the shares sum exactly; four quarter
        # shares round by the order of the sum over sources, which XLA
        # and torch choose apart: the repo's float tolerances
        if topo.hosts_per_expert <= 2:
            np.testing.assert_array_equal(got, want)
        else:
            tol = {"float32": 2e-5, "bfloat16": 2e-2}[dtype]
            np.testing.assert_allclose(got, want, atol=tol, rtol=tol)
    want0 = jax_fetch[f"{cell}/0"].reshape(G, K, d, F)
    for me in range(G):
        same_as_jax(base[me].float().numpy(), want0[me])
    for c in chunks:
        calls = []
        got = dense_group(w, fids, topo, chunk=c, calls=calls)
        want = jax_fetch[f"{cell}/{c}"].reshape(G, K, d, F)
        n_chunks = -(-F // c) if c < F else 1
        assert len(calls) == G * n_chunks         # the chunked path ran
        assert all(s[-1] == min(c, F) for s in calls)
        for me in range(G):
            assert torch.equal(got[me], base[me]), (c, me)
            same_as_jax(got[me].float().numpy(), want[me])
    if topo.hosts_per_expert > 1:
        assert float(base[0].abs().sum()) > 0


# ----------------------------------------------------------------------
# on the card
# ----------------------------------------------------------------------
@pytest.mark.cuda
def test_hosted_fetch_raises_inside_a_capture(tmp_path):
    """A one-process gloo group on the card: the hosted fetch refuses a
    CUDA graph capture (its split sizes are host reads), the dense form
    is captured."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the capture is the card's")
    import torch.distributed as dist
    if dist.is_initialized():
        pytest.skip("a process group is already initialized here")
    dist.init_process_group("gloo", init_method=f"file://{tmp_path}/pg",
                            rank=0, world_size=1)
    try:
        topo = make_topology(1, 4)
        w = torch.randn(4, 8, 16, device="cuda")
        fids = torch.full((1, 2), -1, dtype=torch.int32, device="cuda")
        comm = TD.DistComm(fetch="hosted")
        comm.fetch_rows(w, fids, 0, topo)       # eager: fine
        graph = torch.cuda.CUDAGraph()
        with pytest.raises(RuntimeError, match="capture"):
            with torch.cuda.graph(graph):
                comm.fetch_rows(w, fids, 0, topo)
    finally:
        dist.destroy_process_group()
