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
