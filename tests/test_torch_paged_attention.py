"""Paged attention of the PyTorch port (kernels/paged_attention, CPU plain
version) against the JAX package's Pallas kernel in interpret mode and its
oracle ``paged_attention_ref``: ragged lengths, null-block holes, odd
block sizes, GQA, softcap, decode and multi-query windows; plus the
slab-as-pool prefill view against the port's and the JAX package's
``chunked_attention``.  Same numpy inputs on both sides."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.paged_attention.ops import largest_block_divisor as jlbd
from repro.kernels.paged_attention.ops import paged_attention as jax_paged
from repro.kernels.paged_attention.ref import paged_attention_ref
from repro.models.attention import chunked_attention as jax_chunked
from repro_torch.kernels.paged_attention.ops import (largest_block_divisor,
                                                     paged_attention)
from repro_torch.models.attention import chunked_attention

_JDT = {"float32": jnp.float32, "bfloat16": jnp.bfloat16}
_TDT = {"float32": torch.float32, "bfloat16": torch.bfloat16}


def _tol(dtype):
    return 2e-2 if dtype == "bfloat16" else 2e-5


def _setup(seed, *, B, Hkv, rep, hd, bs, n_logical, lengths, q_len):
    """Pools, shuffled chains covering each row's length, entries past a
    chain on the null block 0 ("holes")."""
    rng = np.random.default_rng(seed)
    num_blocks = 1 + B * n_logical
    P = num_blocks * bs
    k = rng.normal(size=(1, P, Hkv, hd)).astype(np.float32)
    v = rng.normal(size=(1, P, Hkv, hd)).astype(np.float32)
    q = rng.normal(size=(B, q_len, Hkv * rep, hd)).astype(np.float32)
    perm = rng.permutation(np.arange(1, num_blocks))
    bt = np.zeros((B, n_logical), np.int32)
    i = 0
    for b in range(B):
        nv = -(-lengths[b] // bs)
        bt[b, :nv] = perm[i:i + nv]
        i += nv
    return q, k, v, bt, np.asarray(lengths, np.int32)


def _both(arrays, dtype):
    q, k, v, bt, cl = arrays
    jd, td = _JDT[dtype], _TDT[dtype]
    j = [jnp.asarray(a).astype(jd) for a in (q, k, v)] + [jnp.asarray(bt),
                                                         jnp.asarray(cl)]
    t = [torch.from_numpy(a).to(td) for a in (q, k, v)] + [
        torch.from_numpy(bt), torch.from_numpy(cl)]
    return j, t


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("rep", [1, 4])
@pytest.mark.parametrize("softcap", [0.0, 30.0])
@pytest.mark.parametrize("q_len", [1, 4, 32])
def test_paged_attention_matches_jax_ref(dtype, rep, softcap, q_len):
    bs, n_logical = 3, 14                # odd block size
    lengths = [q_len, q_len + 5, q_len + 9]
    j, t = _both(_setup(0, B=3, Hkv=2, rep=rep, hd=16, bs=bs,
                        n_logical=n_logical, lengths=lengths, q_len=q_len),
                 dtype)
    ref = paged_attention_ref(*j, block_size=bs, softcap=softcap)
    out = paged_attention(*t, block_size=bs, softcap=softcap)
    assert out.dtype == _TDT[dtype] and out.shape == t[0].shape
    np.testing.assert_allclose(out.float().numpy(),
                               np.asarray(ref, np.float32),
                               atol=_tol(dtype), rtol=_tol(dtype))


@pytest.mark.parametrize("q_len,rep,bs", [(1, 1, 4), (1, 4, 5), (4, 4, 1),
                                          (32, 1, 7)])
def test_paged_attention_matches_pallas_interpret(q_len, rep, bs):
    """Against the TPU kernel itself (interpret mode), block sizes 1, 4, 5
    and 7 included."""
    n_logical = -(-(q_len + 20) // bs)
    lengths = [q_len, q_len + 20, q_len + 11]
    j, t = _both(_setup(1, B=3, Hkv=2, rep=rep, hd=16, bs=bs,
                        n_logical=n_logical, lengths=lengths, q_len=q_len),
                 "float32")
    kern = jax_paged(*j, block_size=bs, softcap=30.0, interpret=True)
    out = paged_attention(*t, block_size=bs, softcap=30.0)
    np.testing.assert_allclose(out.numpy(), np.asarray(kern), atol=2e-5,
                               rtol=2e-5)


@pytest.mark.parametrize("q_offset", [0, 13])
def test_slab_as_pool_prefill_matches_chunked_attention(q_offset):
    """The prefill-chunk view: a [B, S_max] slab as contiguous block
    chains with an identity table, cache_len = q_offset + C, garbage past
    the write frontier — equal to ``chunked_attention`` over the slab."""
    B, S_max, Hkv, rep, hd, C = 2, 48, 2, 2, 16, 8
    assert largest_block_divisor(S_max) == jlbd(S_max)
    bs = largest_block_divisor(S_max)
    nb = S_max // bs
    rng = np.random.default_rng(2)
    kc = rng.normal(size=(B, S_max, Hkv, hd)).astype(np.float32)
    vc = rng.normal(size=(B, S_max, Hkv, hd)).astype(np.float32)
    q = rng.normal(size=(B, C, Hkv * rep, hd)).astype(np.float32)
    table = (np.arange(B)[:, None] * nb + np.arange(nb)[None]).astype(np.int32)
    out = paged_attention(torch.from_numpy(q),
                          torch.from_numpy(kc).reshape(1, B * S_max, Hkv, hd),
                          torch.from_numpy(vc).reshape(1, B * S_max, Hkv, hd),
                          torch.from_numpy(table), q_offset + C,
                          block_size=bs)
    ours = chunked_attention(torch.from_numpy(q), torch.from_numpy(kc),
                             torch.from_numpy(vc), causal=True, chunk=16,
                             q_offset=q_offset)
    ref = jax_chunked(jnp.asarray(q), jnp.asarray(kc), jnp.asarray(vc),
                      causal=True, chunk=16, q_offset=q_offset)
    np.testing.assert_allclose(ours.numpy(), np.asarray(ref), atol=2e-5,
                               rtol=2e-5)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), atol=2e-5,
                               rtol=2e-5)
