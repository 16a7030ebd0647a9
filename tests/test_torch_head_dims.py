"""The head widths of the two attention kernels, the ``relu_mlp`` MLP and
the last public functions of the port, against the JAX package on the CPU.

- The kernels' domain: every multiple of 8 from 8 to 256 (the Pallas
  kernels take any hd), each run at a padded width the CUDA code is
  compiled for (``padded_head_dim``); hd 100 and 264 are refused with a
  ``ValueError`` naming the domain.  For every hd of the domain the paged
  kernel's planner covers each position of a chain once and both kernels'
  shared memory stays within the H100's 227 KB, with the paged kernel's
  per-warp states and merge inside its ring.
- Reduced qwen15-moe-a27b with ``head_dim=112`` (zamba2-7b's attention
  width) in f32: two ``prefill_chunk``s over the slab scratch and 4
  greedy ``decode_step``s on the paged pool, against JAX's model with
  ``use_pallas=True`` (its Pallas kernels in interpret mode): logits
  within 2e-5 and the same tokens.
- ``relu_mlp``: ``layers.mlp`` against JAX's, and reduced phi4-mini-3.8b
  (dense) and qwen15-moe-a27b (MoE: ReLU shared experts, GELU routed
  experts, as JAX maps ``act``) with it: ``prefill`` logits and greedy
  slab decode steps within 2e-5, the same tokens.
- ``qthreshold.expert_fetch_seconds`` / ``expert_compute_seconds``,
  ``ModelConfig.is_attention_free`` / ``has_decode`` and
  ``EPTopology.is_replicated`` against JAX's."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jax_config
from repro.configs.base import ParallelConfig as JPC
from repro.core import qthreshold as JQ
from repro.core import topology as JT
from repro.launch.mesh import make_host_mesh
from repro.models import layers as JL
from repro.models.model import MeshShape
from repro.models.model import build_model as jax_build
from repro_torch.configs.registry import REGISTRY, get_config
from repro_torch.convert import to_torch
from repro_torch.core import qthreshold as TQ
from repro_torch.core import topology as TT
from repro_torch.kernels.flash_attention import ops as FA
from repro_torch.kernels.paged_attention import ops as PA
from repro_torch.models import layers as TL
from repro_torch.models.model import build_model

from _ep_helpers import one_torch_thread  # noqa: F401 (autouse)

TOL = 2e-5
DOMAIN = range(8, 257, 8)
SMEM_LIMIT = 232_448            # dynamic shared memory a block may have
WARPS, THREADS = 4, 128         # paged_attention.cu's block


# ----------------------------------------------------------------------
# the domain of head widths
# ----------------------------------------------------------------------
@pytest.mark.parametrize("ops", [PA, FA], ids=["paged", "flash"])
def test_every_multiple_of_8_pads_to_the_next_compiled_width(ops):
    for hd in DOMAIN:
        w = ops.padded_head_dim(hd)
        assert w in ops.HEAD_DIMS and w >= hd
        assert all(x < hd for x in ops.HEAD_DIMS if x < w)


@pytest.mark.parametrize("hd", [0, 4, 100, 260, 264])
@pytest.mark.parametrize("ops", [PA, FA], ids=["paged", "flash"])
def test_widths_outside_the_domain_are_refused(ops, hd):
    with pytest.raises(ValueError, match="multiple of 8 from 8 to 256"):
        ops.padded_head_dim(hd)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("B,S,H,Hkv,capacity", [
    (4, 1, 32, 32, 544),         # decode at zamba2-7b's heads
    (1, 32, 32, 32, 544),        # a 32-query chunk over the slab scratch
    (4, 1, 8, 4, 4096),          # GQA rep 2 decode over long chains
    (3, 5, 12, 4, 200),          # a verify window, rep 3
])
def test_launch_plan_covers_each_position_once_at_every_width(
        dtype, B, S, H, Hkv, capacity):
    for hd in DOMAIN:
        for bs in (1, 16):
            n_blocks = -(-capacity // bs)
            plan = PA.launch_plan(B, S, H, Hkv, hd, dtype, n_blocks, bs)
            assert plan.hdp == PA.padded_head_dim(hd)
            cap = n_blocks * bs
            covered = np.zeros(cap, np.int32)
            for s in range(plan.n_splits):
                lo, hi = s * plan.span, min((s + 1) * plan.span, cap)
                assert lo < hi
                covered[lo:hi] += 1
            assert (covered == 1).all()
            ring = PA.smem_bytes(plan, dtype)
            assert ring <= SMEM_LIMIT
            # after the loop the ring holds each warp's (m, l, acc [hdp])
            # and then the merge's weights, l's and the lanes' sums
            state = 4 * WARPS * plan.qt * (plan.hdp + 2)
            merge = 4 * (2 * plan.n_splits * plan.qt + plan.qt + 3
                         + 4 * THREADS)
            assert max(state, merge) <= ring


def test_flash_shared_memory_fits_at_every_width():
    for hd in DOMAIN:
        for dtype in (torch.float32, torch.bfloat16):
            assert FA.smem_bytes(hd, dtype) <= SMEM_LIMIT, (hd, dtype)
    # at 256 the bf16 ring keeps two stages (three would not fit)
    assert FA.smem_bytes(256, torch.bfloat16) == 197_632
    assert 128 * 256 * 2 + 2 * 3 * 64 * 256 * 2 > SMEM_LIMIT


# ----------------------------------------------------------------------
# reduced qwen at head_dim 112 through the kernels' paths
# ----------------------------------------------------------------------
def _mesh():
    mesh = make_host_mesh(1, 1)
    return mesh, MeshShape(tuple(zip(mesh.axis_names, mesh.devices.shape)))


def _pair(jcfg, tcfg, batch, seq_len, use_pallas=False):
    mesh, ms = _mesh()
    jm = jax_build(jcfg, JPC(attn_chunk=8, loss_chunk=8,
                             use_pallas=use_pallas),
                   batch=batch, seq_len=seq_len, mesh_shape=ms, mesh=mesh)
    with mesh:
        jp = jm.init(jax.random.PRNGKey(0))
    tm = build_model(tcfg, batch=batch, seq_len=seq_len, device="cpu")
    return mesh, jm, jp, tm, to_torch(jax.device_get(jp), device="cpu")


def _close(port, ref):
    np.testing.assert_allclose(port.numpy(), np.asarray(ref), atol=TOL,
                               rtol=TOL)


def test_qwen_head_dim_112_chunks_and_paged_decode_match_pallas():
    arch = "qwen15-moe-a27b"
    jcfg = jax_config(arch).reduced().replace(head_dim=112)
    tcfg = get_config(arch).reduced().replace(head_dim=112)
    B, C, S_max, bs = 3, 8, 24, 4
    mesh, jm, jp, tm, tp = _pair(jcfg, tcfg, B, 32, use_pallas=True)
    assert tp["stack"]["blocks"]["sub0"]["attn"]["wq"].shape[-1] == 112
    rng = np.random.default_rng(0)
    # two chunks of one prompt over the slab scratch (the paged kernel's
    # slab-as-pool view), the second padded
    jcache, tcache = jm.init_cache(1, S_max), tm.init_cache(1, S_max)
    chunk = jax.jit(lambda p, t, c, pos, last: jm.prefill_chunk(
        p, t, c, pos, last), static_argnums=(4,))
    for start, last in ((0, C - 1), (C, 4)):
        toks = rng.integers(0, tcfg.vocab_size, (1, C)).astype(np.int32)
        with mesh:
            jl, jcache, _, _ = chunk(jp, toks, jcache, jnp.int32(start), last)
        tl, tcache, _, _ = tm.prefill_chunk(tp, torch.from_numpy(toks),
                                            tcache, start, last)
        _close(tl, jl)
    # 4 greedy decode steps on the paged pool through shuffled chains
    bt = np.asarray([[3, 7, 1, 12, 0, 0, 0, 0], [2, 5, 0, 0, 0, 0, 0, 0],
                     [9, 4, 11, 6, 8, 10, 0, 0]], np.int32)
    jpool, tpool = jm.init_paged_cache(14, bs), tm.init_paged_cache(14, bs)
    pos = np.asarray([0, 3, 13], np.int32)
    step = jax.jit(lambda p, t, c, pos, bt: jm.decode_step(
        p, t, c, pos, block_table=bt, block_size=bs))
    jt = rng.integers(0, tcfg.vocab_size, (B, 1)).astype(np.int32)
    tt = torch.from_numpy(jt)
    for _ in range(4):
        with mesh:
            jl, jpool, _, _ = step(jp, jt, jpool, pos, bt)
        tl, tpool, _, _ = tm.decode_step(
            tp, tt, tpool, torch.from_numpy(pos),
            block_table=torch.from_numpy(bt), block_size=bs)
        _close(tl, jl)
        jt = np.asarray(jnp.argmax(jl, -1)[:, None].astype(jnp.int32))
        tt = tl.argmax(-1)[:, None].to(torch.int32)
        np.testing.assert_array_equal(tt.numpy(), jt)
        pos = pos + 1


# ----------------------------------------------------------------------
# relu_mlp
# ----------------------------------------------------------------------
def test_relu_mlp_matches_jax():
    rng = np.random.default_rng(3)
    d, f = 48, 96
    x = rng.standard_normal((2, 5, d)).astype(np.float32)
    p = jax.device_get(JL.init_mlp(jax.random.PRNGKey(1), d, f, "relu_mlp",
                                   jnp.float32))
    assert set(p) == {"w_in", "w_out"}          # no gate
    ref = JL.mlp(jnp.asarray(x), {k: jnp.asarray(v) for k, v in p.items()},
                 "relu_mlp")
    tp = {k: torch.from_numpy(np.array(v)) for k, v in p.items()}
    _close(TL.mlp(torch.from_numpy(x), tp, "relu_mlp"), ref)
    with pytest.raises(ValueError):              # JAX's refusal
        TL.mlp(torch.from_numpy(x), tp, "tanh_mlp")


@pytest.mark.parametrize("arch", ["phi4-mini-3.8b", "qwen15-moe-a27b"])
def test_relu_mlp_model_prefill_and_decode_match_jax(arch):
    jcfg = jax_config(arch).reduced().replace(act="relu_mlp")
    tcfg = get_config(arch).reduced().replace(act="relu_mlp")
    B, S = 2, 16
    mesh, jm, jp, tm, tp = _pair(jcfg, tcfg, B, S)
    block = tp["stack"]["blocks"]["sub0"]
    dense = block.get("mlp", block.get("shared_mlp"))
    assert set(dense) == {"w_in", "w_out"}      # ReLU, no gate
    if tcfg.is_moe:                             # GELU experts, no gate
        assert tm.moe_spec.act == "gelu" and "w_gate" not in block["moe"]
    toks = np.random.default_rng(4).integers(
        0, tcfg.vocab_size, (B, S)).astype(np.int32)
    with mesh:
        jl, jc, jpos, _ = jax.jit(lambda p, b: jm.prefill(
            p, b, s_max=S + 8))(jp, {"tokens": toks})
    tl, tc, tpos, _ = tm.prefill(tp, {"tokens": torch.from_numpy(toks)},
                                 s_max=S + 8)
    _close(tl, jl)
    step = jax.jit(jm.decode_step)
    for _ in range(2):
        jt = jnp.argmax(jl, -1)[:, None].astype(jnp.int32)
        tt = tl.argmax(-1)[:, None].to(torch.int32)
        np.testing.assert_array_equal(tt.numpy(), np.asarray(jt))
        with mesh:
            jl, jc, jpos, _ = step(jp, jt, jc, jpos)
        tl, tc, tpos, _ = tm.decode_step(tp, tt, tc, tpos)
        _close(tl, jl)


# ----------------------------------------------------------------------
# the last public functions
# ----------------------------------------------------------------------
def test_expert_seconds_match_jax():
    v5e = TQ.HardwareSpec(peak_flops=JQ.V5E.peak_flops,
                          hbm_bw=JQ.V5E.hbm_bw, link_bw=JQ.V5E.ici_bw,
                          dtype_bytes=JQ.V5E.dtype_bytes)
    for G in (1, 4, 16):
        for dense in (True, False):
            assert TQ.expert_fetch_seconds(
                5.77e6, v5e, ep_degree=G, dense_fetch=dense) == \
                JQ.expert_fetch_seconds(5.77e6, ep_degree=G,
                                        dense_fetch=dense)
    for args in ((128, 2048, 1408, 3), (1.5, 768, 3072, 2)):
        assert TQ.expert_compute_seconds(*args, hw=v5e) == \
            JQ.expert_compute_seconds(*args)
    # the defaults are the H100's (NVLink, the bf16 tensor-core rate)
    assert TQ.expert_fetch_seconds(450e9) == 1.0
    assert TQ.expert_compute_seconds(1, 989e12, 1, 1) == 2.0


def test_config_properties_match_jax():
    for arch in REGISTRY:
        j, t = jax_config(arch), get_config(arch)
        assert t.is_attention_free == j.is_attention_free, arch
        assert t.has_decode == j.has_decode, arch


@pytest.mark.parametrize("G,E", [(4, 8), (16, 8), (8, 8), (4, 60)])
def test_topology_is_replicated_matches_jax(G, E):
    assert TT.make_topology(G, E).is_replicated == \
        JT.make_topology(G, E).is_replicated
