"""The PyTorch port's model on reduced qwen15-moe-a27b against the JAX
package, on the same (converted) weights: per-step logits of chunked
prefill on the slab scratch and of paged decode steps.  Tolerance 1e-4:
summation order differs over the 4 layers' products and softmaxes."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.base import ParallelConfig as JPC
from repro.configs.qwen15_moe_a27b import CONFIG as JAX_QWEN
from repro.launch.mesh import make_host_mesh
from repro.models.model import MeshShape
from repro.models.model import build_model as jax_build
from repro_torch.configs.qwen15_moe_a27b import CONFIG as TORCH_QWEN
from repro_torch.convert import to_torch
from repro_torch.models.model import build_model

TOL = 1e-4


@pytest.fixture(scope="module")
def models():
    jc, tc = JAX_QWEN.reduced(), TORCH_QWEN.reduced()
    B, L = 3, 32
    mesh = make_host_mesh(1, 1)
    ms = MeshShape(tuple(zip(mesh.axis_names, mesh.devices.shape)))
    jm = jax_build(jc, JPC(attn_chunk=8, loss_chunk=8), batch=B, seq_len=L,
                   mesh_shape=ms, mesh=mesh)
    with mesh:
        jp = jm.init(jax.random.PRNGKey(0))
    tm = build_model(tc, batch=B, seq_len=L, device="cpu")
    return mesh, jm, jp, tm, to_torch(jax.device_get(jp), device="cpu")


def test_converted_params_keep_jax_layout(models):
    _, _, jp, tm, tp = models
    own = tm.init(0)                    # the port's own seeded init
    flat_j = jax.tree_util.tree_flatten_with_path(jp)[0]
    assert len(flat_j) == sum(1 for _ in _leaves(own))
    for path, leaf in flat_j:
        node_c, node_o = tp, own
        for p in path:
            node_c, node_o = node_c[p.key], node_o[p.key]
        assert tuple(node_c.shape) == leaf.shape == tuple(node_o.shape)
        assert node_c.dtype == node_o.dtype


def _leaves(tree):
    if isinstance(tree, dict):
        for v in tree.values():
            yield from _leaves(v)
    else:
        yield tree


def test_prefill_chunk_logits_match_jax(models):
    mesh, jm, jp, tm, tp = models
    C, S_max = 8, 24
    rng = np.random.default_rng(0)
    jcache, tcache = jm.init_cache(1, S_max), tm.init_cache(1, S_max)
    fn = jax.jit(lambda p, t, c, pos, last: jm.prefill_chunk(p, t, c, pos,
                                                             last),
                 static_argnums=(4,))
    for start, last in ((0, C - 1), (C, C - 1), (2 * C, 4)):   # padded tail
        toks = rng.integers(0, TORCH_QWEN.reduced().vocab_size,
                            (1, C)).astype(np.int32)
        with mesh:
            jl, jcache, _, jd = fn(jp, toks, jcache, jnp.int32(start), last)
        tl, tcache, _, td = tm.prefill_chunk(tp, torch.from_numpy(toks),
                                             tcache, start, last)
        np.testing.assert_allclose(tl.numpy(), np.asarray(jl), atol=TOL,
                                   rtol=TOL)
        for key in jd:
            np.testing.assert_allclose(td[key].numpy(), np.asarray(jd[key]),
                                       atol=TOL, err_msg=key)
    kj = np.asarray(jcache["stack"]["blocks"]["sub0"].k)
    kt = tcache["stack"]["blocks"]["sub0"].k.numpy()
    np.testing.assert_allclose(kt[:, :, :2 * C + 5], kj[:, :, :2 * C + 5],
                               atol=TOL)


def test_paged_decode_logits_match_jax(models):
    mesh, jm, jp, tm, tp = models
    B, bs, nl = 3, 4, 4
    rng = np.random.default_rng(1)
    bt = np.zeros((B, nl), np.int32)
    bt[0] = [3, 7, 1, 0]
    bt[1] = [2, 5, 0, 0]                 # a hole on the null block
    bt[2] = [9, 4, 11, 6]
    num_blocks = 12
    jpool = jm.init_paged_cache(num_blocks, bs)
    tpool = tm.init_paged_cache(num_blocks, bs)
    pos = np.asarray([0, 3, 6], np.int32)
    active = np.asarray([True, True, False])
    fn = jax.jit(lambda p, t, c, pos, a, bt: jm.decode_step(
        p, t, c, pos, active_mask=a, block_table=bt, block_size=bs))
    for _ in range(4):
        tok = rng.integers(0, 512, (B, 1)).astype(np.int32)
        with mesh:
            jl, jpool, _, jd = fn(jp, tok, jpool, pos, active, bt)
        tl, tpool, _, td = tm.decode_step(
            tp, torch.from_numpy(tok), tpool, torch.from_numpy(pos),
            active_mask=torch.from_numpy(active),
            block_table=torch.from_numpy(bt), block_size=bs)
        assert tl.shape == (B, TORCH_QWEN.reduced().padded_vocab)
        np.testing.assert_allclose(tl.numpy()[active],
                                   np.asarray(jl)[active], atol=TOL,
                                   rtol=TOL)
        for key in ("expert_load", "mean_load", "aux_loss"):
            np.testing.assert_allclose(td[key].numpy(), np.asarray(jd[key]),
                                       atol=TOL, err_msg=key)
        pos = pos + 1
