"""Grouped expert FFN of the PyTorch port (kernels/moe_gmm, CPU plain
version) against the JAX package's Pallas kernel in interpret mode, its
oracle ``moe_gmm_ref`` and the tile-scan ``grouped_ffn_ref``.  Same numpy
inputs on both sides."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core.grouped_ffn import grouped_ffn_ref
from repro.kernels.moe_gmm.ops import fused_expert_ffn
from repro.kernels.moe_gmm.ops import tile_group_map as jax_tile_group_map
from repro.kernels.moe_gmm.ref import moe_gmm_ref
from repro_torch.core.grouped_ffn import grouped_ffn, tile_group_map
from repro_torch.kernels.moe_gmm.ops import moe_gmm

_JDT = {"float32": jnp.float32, "bfloat16": jnp.bfloat16}
_TDT = {"float32": torch.float32, "bfloat16": torch.bfloat16}


def _tol(dtype):
    return 2e-2 if dtype == "bfloat16" else 2e-5


def _inputs(sizes, *, M, d, f, bm, seed):
    """Dispatch-buffer x (zero rows past each group's content) + weights."""
    rng = np.random.default_rng(seed)
    G = len(sizes)
    x = np.zeros((M, d), np.float32)
    off = 0
    for s in sizes:
        x[off:off + s] = rng.normal(size=(s, d)) * 0.5
        off += -(-s // bm) * bm
    w_in = rng.normal(size=(G, d, f)).astype(np.float32) * 0.1
    w_gate = rng.normal(size=(G, d, f)).astype(np.float32) * 0.1
    w_out = rng.normal(size=(G, f, d)).astype(np.float32) * 0.1
    return x, w_in, w_gate, w_out


def _np(t):
    return t.float().numpy()


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("gated", [True, False])
@pytest.mark.parametrize("sizes", [
    [16, 0, 24, 8],          # empty group in the middle
    [0, 0, 0, 48],           # all load on the last expert (heavy skew)
    [8, 8, 8, 8],            # uniform
    [48, 0, 0, 0],           # all load on the first expert
])
def test_moe_gmm_sweep_matches_jax(dtype, gated, sizes):
    bm, d, f, M = 8, 32, 64, 64
    x, w_in, w_gate, w_out = _inputs(sizes, M=M, d=d, f=f, bm=bm, seed=0)
    jd, td = _JDT[dtype], _TDT[dtype]
    act = "silu" if gated else "gelu"
    jw = dict(w_gate=jnp.asarray(w_gate).astype(jd)) if gated else {}
    tw = dict(w_gate=torch.from_numpy(w_gate).to(td)) if gated else {}
    jx = [jnp.asarray(a).astype(jd) for a in (x, w_in, w_out)]
    sizes_j = jnp.asarray(sizes, jnp.int32)
    out_k = fused_expert_ffn(*jx, sizes_j, block_m=bm, block_f=32, act=act,
                             interpret=True, **jw)
    tg = jax_tile_group_map(sizes_j, M // bm, bm)
    out_r = moe_gmm_ref(*jx, tg, block_m=bm, act=act, **jw)
    tx = [torch.from_numpy(a).to(td) for a in (x, w_in, w_out)]
    sizes_t = torch.tensor(sizes, dtype=torch.int32)
    tg_t = tile_group_map(sizes_t, M // bm, bm)
    np.testing.assert_array_equal(tg_t.numpy(), np.asarray(tg))
    out_t = moe_gmm(*tx, tg_t, block_m=bm, act=act, **tw)
    assert out_t.dtype == td and out_t.shape == (M, d)
    for ref in (out_k, out_r):
        np.testing.assert_allclose(_np(out_t), np.asarray(ref, np.float32),
                                   atol=_tol(dtype), rtol=_tol(dtype))


def test_moe_gmm_ragged_f_matches_grouped_ffn_ref():
    """f not a multiple of the TPU kernel's 512-wide block (qwen's 1408 =
    2 x 512 + 384, scaled down): the Pallas kernel asserts on such f, so
    the port is held against the XLA tile-scan reference."""
    bm, d, f, M = 8, 32, 176, 64      # 176 = 128 + 48: no 128-block divides it
    sizes = [16, 8, 0, 17]               # rows past 48 are trailing padding
    x, w_in, w_gate, w_out = _inputs(sizes, M=M, d=d, f=f, bm=bm, seed=1)
    ref = grouped_ffn_ref(jnp.asarray(x), jnp.asarray(w_in),
                          jnp.asarray(w_out),
                          jnp.asarray([16, 8, 0, 24], jnp.int32),
                          w_gate=jnp.asarray(w_gate), act="silu", block_m=bm)
    out = grouped_ffn(torch.from_numpy(x), torch.from_numpy(w_in),
                      torch.from_numpy(w_out),
                      torch.tensor([16, 8, 0, 24], dtype=torch.int32),
                      w_gate=torch.from_numpy(w_gate), act="silu",
                      block_m=bm)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), atol=2e-5,
                               rtol=2e-5)


def test_moe_gmm_foreign_groups_equal_concatenated_weights():
    """Foreign groups passed beside the local ones compute exactly what the
    JAX package computes on the concatenated weight rows."""
    bm, d, f, M = 8, 32, 64, 64
    sizes = [8, 0, 16, 3, 0, 9]          # last two groups are "foreign"
    x, w_in, w_gate, w_out = _inputs(sizes, M=M, d=d, f=f, bm=bm, seed=2)
    ref = grouped_ffn_ref(jnp.asarray(x), jnp.asarray(w_in),
                          jnp.asarray(w_out),
                          jnp.asarray([8, 0, 16, 8, 0, 16], jnp.int32),
                          w_gate=jnp.asarray(w_gate), act="silu", block_m=bm)
    t = [torch.from_numpy(a) for a in (w_in, w_out, w_gate)]
    out = grouped_ffn(torch.from_numpy(x), t[0][:4], t[1][:4],
                      torch.tensor([8, 0, 16, 8, 0, 16], dtype=torch.int32),
                      w_gate=t[2][:4], act="silu", block_m=bm,
                      foreign=(t[0][4:], t[1][4:], t[2][4:]))
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), atol=2e-5,
                               rtol=2e-5)


class _RecvComm:
    """Rank ``me`` of ``G``: the all-to-all hands back ``recv`` as the rows
    the other ranks sent, random values in every slot (valid or not)."""

    def __init__(self, G, me, recv):
        self.size, self.rank, self._recv = G, me, recv

    def all_to_all(self, x):
        return self._recv


def _dispatch_buffer(arch, case):
    """A grouped buffer built by the port's schedule and dispatch for a
    reduced config, and its block-aligned group extents."""
    import dataclasses
    from repro_torch.configs.registry import get_config
    from repro_torch.core import dispatch as D
    from repro_torch.core.moe_layer import MoEBlockSpec
    from repro_torch.core.scheduler import schedule
    cfg = get_config(arch).reduced()
    G, me, cf = (4, 0, 1.25) if case == "foreign" else (1, 0, 1.25)
    if case == "overflow":
        cf = 0.25                        # capacity far below the load
    moe = dataclasses.replace(cfg.moe, capacity_factor=cf)
    bm, T = 16, 128 if case == "overflow" else 48
    spec = MoEBlockSpec(moe=moe, d_model=cfg.d_model, ep_degree=G,
                        tokens_local=T * G, block_m=bm)
    E, k, K = moe.num_experts, moe.num_experts_per_tok, moe.num_foreign_slots
    topo = spec.topo
    rng = np.random.default_rng(len(case))
    experts = {"empty_groups": [1, 4], "one_group": [6], "overflow": [5, 6, 7],
               "foreign": [1, 1, 1, 2], "tail": list(range(E))}[case]
    assign = rng.choice(experts, size=(T, k)).astype(np.int32)
    if case == "one_group":
        assign[:, 1] = E                 # the sentinel: padding units
    counts = np.zeros((G, topo.padded_experts), np.int32)
    for g in range(G):                   # every rank is as hot on expert 1
        counts[g] = np.bincount(assign.reshape(-1), minlength=E + 1)[:E]
    S, _ = schedule(torch.from_numpy(counts), topo, policy="harmoeny", q=1,
                    c_pair=spec.c_pair, num_foreign_slots=K)
    layout = D.build_layout(S, torch.from_numpy(assign), me, topo,
                            c_pair=spec.c_pair, c_total=spec.c_total,
                            num_foreign_slots=K, block_m=bm)
    x = torch.from_numpy(rng.normal(size=(T, cfg.d_model)).astype(np.float32))
    recv = torch.from_numpy(rng.normal(
        size=(G, spec.c_pair, cfg.d_model)).astype(np.float32))
    grouped = D.run(_RecvComm(G, me, recv), D.dispatch(
        torch.repeat_interleave(x, k, dim=0), layout, num_ranks=G,
        c_pair=spec.c_pair, c_total=spec.c_total))
    sizes = layout.group_sizes
    return cfg, spec, grouped, D.round_up_j(sizes, bm), sizes, layout


@pytest.mark.parametrize("arch", ["qwen15-moe-a27b", "moonshot-v1-16b-a3b"])
@pytest.mark.parametrize("case", ["empty_groups", "one_group", "foreign",
                                  "overflow", "tail"])
def test_live_row_count_bounds_the_nonzero_rows(arch, case):
    """The count ``fused_expert_ffn`` hands the bf16 kernel: every tile that
    holds a non-zero row lies below it, every tile at or past it is zero
    rows (the kernel writes zeros there without its products), and the
    plain version's output is zero there too."""
    from repro_torch.kernels.moe_gmm.ops import live_row_count, moe_gmm_plain
    cfg, spec, grouped, padded, sizes, layout = _dispatch_buffer(arch, case)
    bm, M = spec.block_m, spec.c_total
    live = live_row_count(padded, M)
    assert live.dtype == torch.int32 and live.shape == (1,)
    n_live = int(live)
    assert n_live % bm == 0 and n_live == min(int(padded.sum()), M)
    nonzero_tiles = (grouped.reshape(M // bm, bm, -1) != 0).any(
        dim=2).any(dim=1)
    assert not nonzero_tiles[n_live // bm:].any()
    if int(layout.send_drops) == 0:      # every live tile holds a real row
        assert nonzero_tiles[:n_live // bm].all()
    epr = spec.topo.experts_per_rank
    if case == "foreign":
        assert int(sizes[epr:].sum()) > 0          # foreign groups hold load
    if case == "empty_groups" or case == "one_group":
        assert int((sizes[:epr] == 0).sum()) >= epr - 2
    if case == "overflow":
        assert int(padded.sum()) > M and int(layout.dest_drops) > 0
        assert n_live == M
    else:
        assert n_live < M                          # a zero tail up to c_total
    rng = np.random.default_rng(3)
    d, f, K = cfg.d_model, cfg.moe.d_ff_expert, spec.moe.num_foreign_slots

    def w(n, a, b):
        return torch.from_numpy(rng.normal(size=(n, a, b)).astype(
            np.float32) * 0.1)
    tg = tile_group_map(padded, M // bm, bm)
    y = moe_gmm_plain(grouped, w(epr, d, f), w(epr, f, d), tg,
                      w_gate=w(epr, d, f), block_m=bm,
                      foreign=(w(K, d, f), w(K, f, d), w(K, d, f)))
    assert torch.equal(y[n_live:], torch.zeros_like(y[n_live:]))
    assert (y[:n_live] != 0).any()


def test_bf16_kernel_check_names_its_block_m_rule():
    """The bf16 kernel tiles rows by 64-row warpgroups: the wrapper's check
    refuses other block_m in bf16 with a message naming the rule, and
    keeps the f32 kernel's 32-row rule."""
    from repro_torch.kernels.moe_gmm.ops import _check
    d, f, G = 64, 64, 2

    def args(dtype, bm, M=192):
        x = torch.zeros((M, d), dtype=dtype)
        w_in = torch.zeros((G, d, f), dtype=dtype)
        w_out = torch.zeros((G, f, d), dtype=dtype)
        tg = torch.zeros((M // bm,), dtype=torch.int32)
        return x, w_in, w_out, None, None, tg, "silu", bm
    with pytest.raises(ValueError, match="bf16 kernel needs block_m % 64"):
        _check(*args(torch.bfloat16, 32))
    with pytest.raises(ValueError, match="block_m % 32 == 0"):
        _check(*args(torch.float32, 48))
    _check(*args(torch.float32, 32))
    _check(*args(torch.bfloat16, 64))
    with pytest.raises(ValueError, match="live_rows must be int32"):
        _check(*args(torch.bfloat16, 64), torch.zeros((2,), dtype=torch.int32))
