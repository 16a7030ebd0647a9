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
from repro_torch.kernels.paged_attention.ops import (MAX_SPLITS,
                                                     largest_block_divisor,
                                                     launch_plan,
                                                     paged_attention,
                                                     split_plan)
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


# --- split-KV: the kernel's host planner and its split-and-merge arithmetic

@pytest.mark.parametrize("bs", [1, 5, 16, 96])
@pytest.mark.parametrize("B,S,H,Hkv,hd,dtype,capacity", [
    (4, 1, 16, 16, 128, torch.bfloat16, 288),    # serve decode
    (1, 32, 16, 16, 128, torch.bfloat16, 288),   # serve prefill chunk
    (4, 1, 16, 16, 128, torch.bfloat16, 4096),   # long chains
    (3, 4, 8, 2, 64, torch.float32, 480),        # f32 GQA window
    (2, 1, 8, 1, 32, torch.float32, 960),        # MQA decode
])
def test_split_plan_covers_every_position_once(bs, B, S, H, Hkv, hd, dtype,
                                               capacity):
    n_blocks = -(-capacity // bs)
    plan = launch_plan(B, S, H, Hkv, hd, dtype, n_blocks, bs)
    cap = n_blocks * bs
    assert plan.tensor_cores == (dtype == torch.bfloat16 and S * H // Hkv >= 16)
    assert plan.n_tiles * plan.qt >= S * H // Hkv > (plan.n_tiles - 1) * plan.qt
    assert plan.ctas == plan.n_tiles * plan.n_splits * Hkv * B
    covered = np.zeros(cap, np.int32)
    starts = []
    for s in range(plan.n_splits):
        lo, hi = s * plan.span, min((s + 1) * plan.span, cap)
        assert lo < hi                        # no empty span
        covered[lo:hi] += 1
        starts.append(lo)
    assert (covered == 1).all()
    if plan.n_splits > 1 and bs > 1 and plan.span % bs:
        assert any(lo % bs for lo in starts)  # a span starts mid-block


@pytest.mark.parametrize("groups,capacity,min_span", [
    (64, 288, 32), (32, 288, 64), (1, 10, 32), (1000, 4096, 32), (7, 1, 1),
    (1, 1 << 17, 16)])
def test_split_plan_fills_the_card_within_its_limits(groups, capacity,
                                                      min_span):
    n, span = split_plan(capacity, groups, min_span, sms=132)
    assert n * span >= capacity > (n - 1) * span
    assert n <= min(-(-capacity // min_span), MAX_SPLITS)
    assert n * groups >= 2 * 132 or n == min(-(-capacity // min_span),
                                             MAX_SPLITS)


def _split_merge(q, k, v, bt, cl, *, bs, softcap, span, qt, masked="zero"):
    """The kernel's arithmetic in numpy f32: each (row, kv head, q tile)
    chain cut into spans of ``span`` positions, each span's partial
    (m, l, acc) computed on its own, then merged with exp(m_s - M)
    weights.  ``masked="zero"`` gives masked positions p = 0 (the kernel);
    ``masked="tpu"`` computes them as exp(-1e30 - m), the TPU kernel's
    formula, under which a span where a row sees nothing holds
    p = exp(0) = 1 at every position.  Returns the output and the per-span
    partials."""
    B, S, H, hd = q.shape
    Hkv = k.shape[2]
    rep = H // Hkv
    cap = bt.shape[1] * bs
    n_splits = -(-cap // span)
    out = np.zeros((B, S, H, hd), np.float32)
    parts = {}
    for b in range(B):
        L = int(cl[b])
        for g in range(Hkv):
            rows = S * rep
            for t0 in range(0, rows, qt):
                tile = list(range(t0, min(t0 + qt, rows)))
                hi = min(L - S + tile[-1] // rep, cap - 1)
                ms, ls, accs = [], [], []
                for s in range(n_splits):
                    lo, end = s * span, min((s + 1) * span, hi + 1)
                    m = np.full(len(tile), _NEG, np.float32)
                    l = np.zeros(len(tile), np.float32)
                    acc = np.zeros((len(tile), hd), np.float32)
                    for i, row in enumerate(tile):
                        qi, h = row // rep, g * rep + row % rep
                        q_pos = L - S + qi
                        pos = np.arange(lo, max(lo, end))
                        if pos.size == 0:
                            continue                      # dead span
                        phys = bt[b, pos // bs] * bs + pos % bs
                        sc = (k[0, phys, g] @ (q[b, qi, h] * hd ** -0.5))
                        if softcap:
                            sc = softcap * np.tanh(sc / softcap)
                        vis = (pos < L) & ((pos <= q_pos) | (S == 1))
                        sc = np.where(vis, sc, _NEG).astype(np.float32)
                        m[i] = max(_NEG, sc.max())
                        p = np.exp(sc - m[i]).astype(np.float32)
                        if masked == "zero":
                            p = np.where(vis, p, 0.0)
                        l[i] = p.sum()
                        acc[i] = p @ v[0, phys, g]
                    ms.append(m), ls.append(l), accs.append(acc)
                    parts[(b, g, t0, s)] = (m, l, acc)
                M = np.max(ms, axis=0)
                w = np.exp(np.asarray(ms) - M)                # [n_splits, rows]
                l_tot = (w * np.asarray(ls)).sum(0)
                acc_tot = (w[..., None] * np.asarray(accs)).sum(0)
                o = acc_tot / np.maximum(l_tot, 1e-30)[:, None]
                for i, row in enumerate(tile):
                    out[b, row // rep, g * rep + row % rep] = o[i]
    return out, parts


_NEG = np.float32(-1e30)


@pytest.mark.parametrize("case", [
    # decode: spans past a row's length (length 1 and 9 of 48)
    dict(B=3, S=1, rep=1, bs=5, n_logical=10, lengths=[1, 9, 48], span=7,
         qt=1, softcap=0.0),
    # length 1 under a 288-position capacity, serve decode's split
    dict(B=2, S=1, rep=2, bs=16, n_logical=18, lengths=[1, 288], span=58,
         qt=2, softcap=30.0),
    # a chunk: spans past its early rows' causal bound but inside the
    # tile's, and spans past the whole tile's bound
    dict(B=2, S=8, rep=1, bs=3, n_logical=8, lengths=[8, 21], span=4, qt=8,
         softcap=0.0),
    dict(B=1, S=32, rep=1, bs=96, n_logical=3, lengths=[192], span=58,
         qt=16, softcap=0.0),
])
def test_split_merge_matches_plain_and_jax_ref(case):
    c = dict(case)
    span, qt, softcap = c.pop("span"), c.pop("qt"), c.pop("softcap")
    arrays = _setup(3, Hkv=2, hd=16, q_len=c.pop("S"), **c)
    q, k, v, bt, cl = arrays
    bs = c["bs"]
    j, t = _both(arrays, "float32")
    ref = np.asarray(paged_attention_ref(*j, block_size=bs, softcap=softcap))
    plain = paged_attention(*t, block_size=bs, softcap=softcap).numpy()
    np.testing.assert_allclose(plain, ref, atol=2e-5, rtol=2e-5)
    kw = dict(bs=bs, softcap=softcap, span=span, qt=qt)
    got, parts = _split_merge(q, k, v, bt, cl, **kw)
    np.testing.assert_allclose(got, ref, atol=2e-5, rtol=2e-5)
    # the TPU's masked-p formula merges to the same output: exp(m_s - M)
    # weighs a span where a row sees nothing to exactly 0 ...
    tpu, tpu_parts = _split_merge(q, k, v, bt, cl, masked="tpu", **kw)
    np.testing.assert_allclose(tpu, ref, atol=2e-5, rtol=2e-5)
    # ... whose TPU-style partial holds l = its position count, so it must
    # never be added unweighted; the kernel's partial there is exactly
    # empty, as is every dead span's (past a decode row's length)
    trapped = [(key, i) for key, (m, l, _) in tpu_parts.items()
               for i in range(len(m)) if m[i] == _NEG and l[i] > 0]
    empty = [(key, i) for key, (m, l, _) in parts.items()
             for i in range(len(m)) if m[i] == _NEG]
    assert trapped if q.shape[1] > 1 else empty
    assert {key for key, _ in trapped} <= {key for key, _ in empty}
    for key, i in empty:
        m, l, acc = parts[key]
        assert l[i] == 0 and not acc[i].any()
