"""The foreign fetch on its side CUDA stream, and ``DistComm`` on NCCL.

On the CPU there is no stream: the fetch answers with ``done`` None and
the MoE block takes the same path without one (the values are held by
``test_torch_fetch.py`` and the engine tests).  Marked ``cuda`` (skip
without a GPU), on reduced f32 qwen15-moe-a27b at G = 4 with q = 1:

- the fetch's kernels run on a stream other than the compute stream:
  the answer carries a ``done`` event recorded on the communicator's side
  stream, and the profiler puts the fetch's gather on a second stream;
- the captured decode step and prefill chunk hold the fork and the join:
  captured streams equal eager ones, with and without skew, and the
  side stream's rows are the gather's;
- ``VirtualGroup``'s fetch under autograd (training: the ranks' rows
  stacked into a temporary the side stream gathers from) gives on every
  call, with the card's memory reused between calls, the loss and
  gradients of the same fetch on the current stream;
- ``DistComm`` on a one-process NCCL group at G = 1, every entry
  captured, gives ``LocalComm``'s streams; on a gloo group the engine
  refuses to capture and serves the same streams inside
  ``stepcore.eager()``."""
import dataclasses
import os
import shutil

import numpy as np
import pytest
import torch

from repro_torch.configs.registry import get_config
from repro_torch.core import dispatch as TD
from repro_torch.core import prefetch as TP
from repro_torch.core.topology import make_topology
from repro_torch.models.model import build_model
from repro_torch.serve import (Request, ServeEngine, VirtualClock,
                               engine_config_for, stepcore)

from _ep_helpers import one_torch_thread  # noqa: F401 (autouse)
from _serve_helpers import captured_run

SLOTS, L, GEN, C, G = 3, 12, 6, 4, 4


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the side stream is the card's")
    if shutil.which("nvcc") is None and not \
            os.path.exists("/usr/local/cuda/bin/nvcc"):
        pytest.skip("needs nvcc to build the kernels")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def _cfg(skew=0.0):
    cfg = get_config("qwen15-moe-a27b").reduced()
    return dataclasses.replace(cfg, moe=dataclasses.replace(
        cfg.moe, q_tokens=1, router_skew=skew))


def _trace(n=6, seed=9):
    rng = np.random.default_rng(seed)
    return [Request(rid=i, tokens=rng.integers(1, 500, (int(rng.integers(
        3, L + 1)),)), max_new_tokens=GEN, arrival_time=0.2 * i)
        for i in range(n)]


def _engine(cfg, device, ep_degree=G, comm=None):
    params = build_model(cfg, batch=SLOTS, seq_len=L, device="cpu",
                         ep_degree=ep_degree).init(0)
    params = _to(params, device)
    model = build_model(cfg, batch=SLOTS, seq_len=L, device=device,
                        ep_degree=ep_degree, comm=comm)
    ecfg = engine_config_for(cfg, max_slots=SLOTS, prompt_len=L,
                             max_new_tokens=GEN, prefill_chunk=C,
                             kv_block_size=4, paged=True, skew_seed=3)
    return ServeEngine(model, params, ecfg, clock=VirtualClock(0.1),
                       device=device)


def _to(tree, dev):
    if isinstance(tree, dict):
        return {k: _to(v, dev) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_to(v, dev) for v in tree]
    return tree.to(dev)


@pytest.mark.cuda
def test_fetch_runs_on_a_side_stream(cuda):
    """A ``VirtualGroup`` fetch beside a product on the compute stream:
    the answer's ``done`` events, the rows of the gather, and in the
    profiler the fetch's kernels on a second stream."""
    from torch.profiler import ProfilerActivity, profile
    from repro_torch.profiling import streams
    topo = make_topology(G, 16)
    w = torch.randn(16, 64, 96, device="cuda")
    fids = torch.tensor([[4, -1], [0, 9], [-1, -1], [1, 2]],
                        dtype=torch.int32, device="cuda")
    vg = TD.VirtualGroup(G, "cuda")
    rows = [w[g * 4:(g + 1) * 4] for g in range(G)]
    x = torch.randn(2048, 2048, device="cuda")
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        y = x @ x                              # compute-stream work
        got = vg.run_ranks(lambda me: TP.fetch_foreign_weights(
            rows[me], fids, me, topo))
        out = [TP.join(f) for f in got]
        torch.cuda.synchronize()
    assert all(f.done is not None for f in got)
    assert vg._side.stream.cuda_stream \
        != torch.cuda.current_stream().cuda_stream
    exp = TD.device_tables(topo, "cuda").expert_row
    for me in range(G):
        for k, e in enumerate(fids[me].tolist()):
            want = w[exp[e]] if e >= 0 else torch.zeros_like(w[0])
            assert torch.equal(out[me][k], want)
    split = streams(prof, 1)
    assert split["streams"] >= 2 and split["side_ms_per_step"] > 0
    assert float(y.abs().sum()) > 0


@pytest.mark.cuda
@pytest.mark.parametrize("skew", [0.0, 0.9], ids=["learned", "skew"])
def test_captured_fork_and_join_equal_eager(cuda, skew):
    """The decode step and the prefill chunk, each captured with the
    fetch forked onto the side stream and joined before the grouped FFN:
    greedy streams and the schedule's counters equal the eager run's."""
    cfg = _cfg(skew)
    runs = {}
    for eager in (True, False):
        eng = _engine(cfg, "cuda")
        with (stepcore.eager() if eager else _nullcontext()):
            eng.warmup()
            runs[eager] = captured_run(eng, _trace())
    (out_e, rep_e), (out_c, rep_c) = runs[True], runs[False]
    assert out_c == out_e
    assert rep_c["load_balance"] == rep_e["load_balance"]
    assert rep_c["jit_entries"]["decode"] == 1
    assert rep_c["jit_entries"]["prefill_chunk"] == 1
    assert rep_c["moe"]["decode/moved_units"] > 0


def _nullcontext():
    import contextlib
    return contextlib.nullcontext()


@pytest.mark.cuda
def test_fetch_under_autograd_equals_the_current_stream_fetch(cuda):
    """Units move (skew 0.9, q = 1) and the fetched rows carry gradient:
    four calls with the side stream, each after allocations that churn
    the caching allocator, against the same call with the fetch on the
    current stream.  Before the stack was kept for the side stream, the second
    call's loss moved by ~0.1 on full-width switch128 (the gather read
    memory the current stream had reused)."""
    from contextlib import contextmanager

    from repro_torch.configs.base import ParallelConfig
    from repro_torch.core.router import SkewKey
    from repro_torch.launch.steps import loss_and_grads
    cfg = _cfg(skew=0.9)
    B, S = 2, 64
    model = build_model(cfg, ParallelConfig(attn_chunk=S, loss_chunk=S),
                        batch=B, seq_len=S, device=cuda, ep_degree=G)
    params = model.init(0)
    rng = np.random.default_rng(3)
    batch = {k: torch.as_tensor(rng.integers(0, cfg.vocab_size, (B, S)),
                                device=cuda) for k in ("tokens", "labels")}

    def run():
        loss, diags, grads = loss_and_grads(model, params, batch,
                                            skew_key=SkewKey((19,)))
        assert float(diags["moved_units"]) > 0
        return [loss] + grads

    fork = TD._SideStream.fork

    @contextmanager
    def inline(self, *inputs):
        yield None
    TD._SideStream.fork = inline
    try:
        want = run()
    finally:
        TD._SideStream.fork = fork
    for _ in range(4):
        churn = [torch.empty(1 << n, device=cuda) for n in range(10, 22)]
        got = run()
        del churn
        for a, b in zip(got, want):      # the dispatch's atomics reorder
            torch.testing.assert_close(a, b, rtol=1e-5, atol=1e-6)


def test_distcomm_on_nccl_captured_equals_local(cuda, tmp_path):
    """A one-process NCCL group: ``DistComm`` at G = 1 with the dense
    fetch, every entry captured, serves ``LocalComm``'s streams."""
    import torch.distributed as dist
    if dist.is_initialized():
        pytest.skip("a process group is already initialized here")
    cfg = get_config("qwen15-moe-a27b").reduced()
    local = _engine(cfg, "cuda", ep_degree=1)
    local.warmup()
    want, _ = captured_run(local, _trace())
    dist.init_process_group("nccl", init_method=f"file://{tmp_path}/pg",
                            rank=0, world_size=1,
                            device_id=torch.device("cuda", 0))
    try:
        comm = TD.DistComm(fetch="dense")
        assert comm.capturable
        eng = _engine(cfg, "cuda", ep_degree=1, comm=comm)
        eng.warmup()
        got, rep = captured_run(eng, _trace())
    finally:
        dist.destroy_process_group()
    assert got == want
    assert rep["engine"]["comm"]["entries"] == "captured"
    assert rep["jit_entries"]["decode"] == 1
    assert rep["recompiled_after_warmup"] is False


@pytest.mark.cuda
def test_engine_on_gloo_refuses_capture(cuda, tmp_path):
    """gloo's collectives cannot be captured: on the card an engine over
    a gloo ``DistComm`` raises at its first entry unless it runs inside
    ``stepcore.eager()``, where it serves ``LocalComm``'s streams."""
    import torch.distributed as dist
    if dist.is_initialized():
        pytest.skip("a process group is already initialized here")
    cfg = get_config("qwen15-moe-a27b").reduced()
    local = _engine(cfg, "cuda", ep_degree=1)
    local.warmup()
    want, _ = captured_run(local, _trace())
    dist.init_process_group("gloo", init_method=f"file://{tmp_path}/pg",
                            rank=0, world_size=1)
    try:
        comm = TD.DistComm(fetch="dense")
        assert not comm.capturable
        eng = _engine(cfg, "cuda", ep_degree=1, comm=comm)
        with pytest.raises(RuntimeError, match="cannot capture"):
            eng.warmup()
        eng = _engine(cfg, "cuda", ep_degree=1, comm=comm)
        with stepcore.eager():
            eng.warmup()
            got, rep = captured_run(eng, _trace())
    finally:
        dist.destroy_process_group()
    assert got == want
    assert rep["engine"]["comm"]["entries"] == "eager"
    assert rep["engine"]["comm"]["backend"] == "gloo"
