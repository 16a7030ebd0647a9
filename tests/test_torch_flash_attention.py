"""Flash attention of the PyTorch port (kernels/flash_attention: the CPU
plain version and the ``ops`` wrapper, which runs it for CPU tensors)
against the JAX package's Pallas kernel in interpret mode and its oracle
``flash_attention_ref``, over the sweep of ``tests/test_kernels.py``
(MHA, GQA rep 2, MQA; causal and full; f32 at 2e-5, bf16 at 2e-2) and
at head widths 80, 112 and 256.  Same
numpy inputs on both sides; the JAX side takes [B, H, S, hd], the port
the model layout [B, S, H, hd]."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.flash_attention.flash_attention import \
    flash_attention_kernel
from repro.kernels.flash_attention.ref import flash_attention_ref
from repro_torch.kernels.flash_attention import ops
from repro_torch.kernels.flash_attention.ops import (flash_attention,
                                                     flash_attention_plain)

_JDT = {"float32": jnp.float32, "bfloat16": jnp.bfloat16}
_TDT = {"float32": torch.float32, "bfloat16": torch.bfloat16}


def _tol(dtype):
    return 2e-2 if dtype == "bfloat16" else 2e-5


def _inputs(seed, B, H, Hkv, Sq, Sk, hd, dtype):
    """numpy draws in the model layout, cast on both sides to ``dtype``;
    returns (JAX [B, H, S, hd] arrays, port [B, S, H, hd] tensors)."""
    rng = np.random.default_rng(seed)
    arrs = [rng.normal(size=(B, S, h, hd)).astype(np.float32)
            for S, h in ((Sq, H), (Sk, Hkv), (Sk, Hkv))]
    j = [jnp.asarray(a.transpose(0, 2, 1, 3)).astype(_JDT[dtype])
         for a in arrs]
    t = [torch.from_numpy(a).to(_TDT[dtype]) for a in arrs]
    return j, t


def _port_to_jax_layout(o):
    return o.float().numpy().transpose(0, 2, 1, 3)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("shape", [
    (1, 4, 4, 64, 16),    # MHA
    (2, 4, 2, 128, 16),   # GQA rep=2
    (1, 8, 1, 64, 32),    # MQA
])
def test_flash_attention_matches_jax_kernel_and_ref(dtype, causal, shape):
    B, H, Hkv, S, hd = shape
    j, t = _inputs(0, B, H, Hkv, S, S, hd, dtype)
    kern = flash_attention_kernel(*j, causal=causal, block_q=32, block_k=32,
                                  interpret=True)
    ref = flash_attention_ref(*j, causal=causal)
    plain = flash_attention_plain(*t, causal=causal)
    wrapped = flash_attention(*t, causal=causal)
    assert plain.dtype == wrapped.dtype == _TDT[dtype]
    assert torch.equal(wrapped, plain)            # CPU tensors -> plain
    for other in (kern, ref):
        np.testing.assert_allclose(_port_to_jax_layout(plain),
                                   np.asarray(other, np.float32),
                                   atol=_tol(dtype), rtol=_tol(dtype))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("hd", [80, 112, 256])
def test_flash_attention_matches_jax_kernel_at_new_widths(hd, dtype):
    """The widths the CUDA kernel pads (80 and 112 to 128) and 256, causal
    GQA rep 2, against the TPU kernel in interpret mode."""
    j, t = _inputs(6, 1, 4, 2, 64, 64, hd, dtype)
    kern = flash_attention_kernel(*j, causal=True, block_q=32, block_k=32,
                                  interpret=True)
    np.testing.assert_allclose(
        _port_to_jax_layout(flash_attention(*t, causal=True)),
        np.asarray(kern, np.float32), atol=_tol(dtype), rtol=_tol(dtype))


@pytest.mark.parametrize("causal", [True, False])
def test_flash_attention_ragged_s_matches_ref(causal):
    """S = 600 is no multiple of the TPU kernel's min(512, S) tile, which
    the JAX kernel asserts (flash_attention.py:78-80); the port's plain
    version and kernel take any S.  Held against the oracle instead."""
    B, H, Hkv, S, hd = 1, 4, 1, 600, 32
    j, t = _inputs(1, B, H, Hkv, S, S, hd, "float32")
    with pytest.raises(AssertionError):
        flash_attention_kernel(*j, causal=causal, interpret=True)
    ref = flash_attention_ref(*j, causal=causal)
    np.testing.assert_allclose(_port_to_jax_layout(flash_attention(
        *t, causal=causal)), np.asarray(ref), atol=2e-5, rtol=2e-5)


def test_flash_attention_full_cross_lengths_match_ref():
    """Without a causal mask Sq and Sk may differ (GQA rep 4)."""
    j, t = _inputs(2, 2, 8, 2, 24, 40, 32, "float32")
    ref = flash_attention_ref(*j, causal=False)
    np.testing.assert_allclose(_port_to_jax_layout(flash_attention(
        *t, causal=False)), np.asarray(ref), atol=2e-5, rtol=2e-5)


@pytest.mark.parametrize("fn", [flash_attention, flash_attention_plain])
def test_causal_flash_attention_rejects_unequal_lengths(fn):
    _, t = _inputs(3, 1, 2, 2, 8, 16, 16, "float32")
    with pytest.raises(ValueError, match="Sq == Sk"):
        fn(*t, causal=True)


def test_cpu_tensors_never_count_kernel_launches():
    _, t = _inputs(4, 1, 2, 2, 16, 16, 16, "float32")
    n0 = ops.flash_attention.launches
    flash_attention(*t, causal=True)
    assert ops.flash_attention.launches == n0


def test_strided_model_layout_views_match_contiguous():
    """The kernel reads q/k/v through strides; the plain version takes the
    same views (here a slice of a fused QKV projection)."""
    rng = np.random.default_rng(5)
    qkv = torch.from_numpy(rng.normal(size=(2, 32, 3, 4, 16))
                           .astype(np.float32))
    q, k, v = qkv.unbind(dim=2)
    assert not q.is_contiguous()
    out = flash_attention(q, k, v, causal=True)
    ref = flash_attention(q.contiguous(), k.contiguous(), v.contiguous(),
                          causal=True)
    assert torch.equal(out, ref)
