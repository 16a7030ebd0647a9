"""The port's CUDA kernels against their plain PyTorch versions, on the card.

Marked ``cuda``: on a machine without a GPU (or without nvcc) every test
skips.  The schedule kernel (Alg. 2) is held to its plain version under
``hypothesis``.  Run on the card with

    PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_cuda_kernels.py
"""
import os
import shutil

import numpy as np
import pytest
import torch
from hypothesis import HealthCheck, given, settings
from hypothesis import strategies as st

pytestmark = pytest.mark.cuda


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels run only on the card")
    if shutil.which("nvcc") is None and not \
            os.path.exists("/usr/local/cuda/bin/nvcc"):
        pytest.skip("needs nvcc to build the kernels")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def _tol(dtype):
    return 2e-2 if dtype == torch.bfloat16 else 2e-5


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("gated", [True, False])
@pytest.mark.parametrize("sizes", [
    [40, 0, 7, 64, 0, 3],         # empty groups, a foreign group with rows
    [1, 63, 64, 65, 0, 128],      # groups across the 64-row warpgroup tiles
])
@pytest.mark.parametrize("f", [192, 1408])       # 192: a 64-wide N tail
@pytest.mark.parametrize("bm", [64, 128])
@pytest.mark.parametrize("live", [False, True])  # with the live-row count
def test_moe_gmm_kernel_matches_plain(cuda, dtype, gated, sizes, f, bm,
                                      live):
    from repro_torch.kernels.moe_gmm import ops
    g = torch.Generator(device=cuda).manual_seed(0)
    d = 128
    sizes = torch.tensor(sizes, dtype=torch.int32, device=cuda)
    padded = ((sizes + bm - 1) // bm) * bm
    M = int(padded.sum()) + 2 * bm
    x = torch.zeros((M, d), device=cuda)
    off = 0
    for s, p in zip(sizes.tolist(), padded.tolist()):
        x[off:off + s] = torch.randn((s, d), generator=g, device=cuda) * 0.5
        off += p
    x = x.to(dtype)

    def w(*shape):
        return (torch.randn(shape, generator=g, device=cuda) * 0.1).to(dtype)
    w_in, w_gate, w_out = w(4, d, f), w(4, d, f), w(4, f, d)
    foreign = (w(2, d, f), w(2, f, d), w(2, d, f) if gated else None)
    kw = dict(w_gate=w_gate if gated else None, act="silu" if gated else
              "gelu", block_m=bm, foreign=foreign,
              live_rows=ops.live_row_count(padded, M) if live else None)
    tg = ops.tile_group_map(padded, M // bm, bm)
    n0 = ops.moe_gmm.launches
    got = ops.moe_gmm(x, w_in, w_out, tg, **kw)
    ref = ops.moe_gmm_plain(x, w_in, w_out, tg, **kw)
    torch.cuda.synchronize()
    assert ops.moe_gmm.launches == n0 + 1
    np.testing.assert_allclose(got.float().cpu().numpy(),
                               ref.float().cpu().numpy(),
                               atol=_tol(dtype), rtol=_tol(dtype))


@pytest.mark.parametrize("tokens", [8, 256], ids=["decode", "chunk"])
def test_moe_gmm_kernel_matches_plain_at_mixtral_width(cuda, tokens):
    """mixtral-8x7b's experts (d 4096, f 14,336, gated) at its serve
    dispatches: 8 decode slots or a 256-token chunk, top-2 of 8 experts
    (a seeded draw), two empty foreign groups, bf16."""
    from repro_torch.kernels.moe_gmm import ops
    g = torch.Generator(device=cuda).manual_seed(5)
    d, f, E, K, bm = 4096, 14336, 8, 2, 128
    units = torch.randint(0, E, (2 * tokens,), generator=g, device=cuda)
    sizes = torch.cat([torch.bincount(units, minlength=E),
                       torch.zeros(K, dtype=torch.long, device=cuda)])
    padded = ((sizes + bm - 1) // bm) * bm
    M = int(padded.sum()) + bm
    x = torch.zeros((M, d), dtype=torch.bfloat16, device=cuda)
    off = 0
    for s, p in zip(sizes.tolist(), padded.tolist()):
        x[off:off + s] = (torch.randn((s, d), generator=g, device=cuda)
                          * 0.5).to(torch.bfloat16)
        off += p

    def w(n, a, b):
        return (torch.randn((n, a, b), generator=g, device=cuda)
                * (2.0 / a) ** 0.5).to(torch.bfloat16)
    w_in, w_gate, w_out = w(E, d, f), w(E, d, f), w(E, f, d)
    foreign = (w(K, d, f), w(K, f, d), w(K, d, f))
    tg = ops.tile_group_map(padded.to(torch.int32), M // bm, bm)
    kw = dict(w_gate=w_gate, act="silu", block_m=bm, foreign=foreign,
              live_rows=ops.live_row_count(padded.to(torch.int32), M))
    n0 = ops.moe_gmm.launches
    got = ops.moe_gmm(x, w_in, w_out, tg, **kw)
    ref = ops.moe_gmm_plain(x, w_in, w_out, tg, **kw)
    torch.cuda.synchronize()
    assert ops.moe_gmm.launches == n0 + 1
    np.testing.assert_allclose(got.float().cpu().numpy(),
                               ref.float().cpu().numpy(), atol=2e-2,
                               rtol=2e-2)


@pytest.mark.parametrize("S,bs", [(1, 16), (256, 128)],
                         ids=["decode", "chunk"])
def test_paged_attention_kernel_matches_plain_at_mixtral_heads(cuda, S, bs):
    """mixtral-8x7b's attention (32 q heads over 8 kv heads of 128: GQA
    rep 4) in bf16: decode over shuffled chains up to 1,056 positions,
    and a 256-token chunk over the slab-as-pool view."""
    from repro_torch.kernels.paged_attention import ops
    g = torch.Generator(device=cuda).manual_seed(6)
    H, Hkv, hd, n_blocks = 32, 8, 128, 1280 // bs
    lengths = [S, 257, 640, 1056] if S == 1 else [1024]
    B = len(lengths)
    num_phys = 1 + B * n_blocks
    perm = torch.randperm(num_phys - 1, generator=g, device=cuda) + 1
    table = torch.zeros((B, n_blocks), dtype=torch.int32, device=cuda)
    for b, L in enumerate(lengths):
        nb = -(-L // bs)
        table[b, :nb] = perm[b * n_blocks:b * n_blocks + nb].to(torch.int32)
    P = num_phys * bs
    k = torch.randn((1, P, Hkv, hd), generator=g, device=cuda).bfloat16()
    v = torch.randn((1, P, Hkv, hd), generator=g, device=cuda).bfloat16()
    q = torch.randn((B, S, H, hd), generator=g, device=cuda).bfloat16()
    cl = torch.tensor(lengths, dtype=torch.int32, device=cuda)
    n0 = ops.paged_attention.launches
    got = ops.paged_attention(q, k, v, table, cl, block_size=bs)
    ref = ops.paged_attention_plain(q, k, v, table, cl, block_size=bs)
    torch.cuda.synchronize()
    assert ops.paged_attention.launches == n0 + 1
    np.testing.assert_allclose(got.float().cpu().numpy(),
                               ref.float().cpu().numpy(), atol=2e-2,
                               rtol=2e-2)


@settings(max_examples=400, deadline=None,
          suppress_health_check=[HealthCheck.function_scoped_fixture])
@given(G=st.sampled_from([1, 2, 4, 8]), E=st.integers(1, 128),
       units=st.integers(0, 600), hot=st.floats(0.0, 1.0),
       q=st.integers(1, 64), c_pair=st.integers(8, 256),
       K=st.integers(0, 8), max_iters=st.sampled_from([1, 3, 16, 128]),
       seed=st.integers(0, 2 ** 31 - 1))
def test_schedule_kernel_equals_plain(cuda, G, E, units, hot, q, c_pair, K,
                                      max_iters, seed):
    """Alg. 2 on the card (one CTA) against the numpy plain version, on
    counts with a hot expert of any weight: S and the four diagnostics
    exactly equal."""
    from repro_torch.core.scheduler import initial_assign
    from repro_torch.core.topology import device_tables, make_topology
    from repro_torch.kernels.schedule import ops
    E = max(E, G)
    topo = make_topology(G, E)
    Ep = topo.padded_experts
    rng = np.random.default_rng(seed)
    p = np.full(E, (1.0 - hot) / max(E - 1, 1))
    p[rng.integers(E)] += hot
    counts = np.zeros((G, Ep), np.int32)
    for g in range(G):
        counts[g, :E] = rng.multinomial(rng.integers(0, units + 1), p / p.sum())
    S0 = initial_assign(torch.from_numpy(counts).to(cuda), topo)
    is_local = device_tables(topo, cuda).is_local
    kw = dict(q=q, c_pair=c_pair, num_foreign_slots=K, max_iters=max_iters)
    n0 = ops.rebalance.launches
    S, diag = ops.rebalance(S0, is_local, **kw)
    S_ref, diag_ref = ops.rebalance_plain(S0.cpu(), is_local.cpu(), **kw)
    torch.cuda.synchronize()
    assert ops.rebalance.launches == n0 + 1
    assert torch.equal(diag.cpu(), diag_ref)
    assert torch.equal(S.cpu(), S_ref)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("S,rep,bs,softcap,hd", [
    (1, 1, 16, 0.0, 128),     # decode
    (4, 4, 5, 30.0, 128),     # 16 rows: the bf16 tensor-core route
    (32, 1, 96, 0.0, 128),    # the serve chunk over the slab view
    (1, 8, 16, 0.0, 128),     # GQA decode, an 8-row CUDA-core tile
    (1, 1, 1, 0.0, 64),       # block size 1
    (32, 1, 96, 30.0, 64),
    (2, 8, 7, 0.0, 128),      # 16 rows from two queries
    (3, 2, 3, 30.0, 32),      # a ragged 6-row tile
])
@pytest.mark.parametrize("splits", ["one", "two", "many"])
def test_paged_attention_kernel_matches_plain(cuda, monkeypatch, dtype, S,
                                              rep, bs, softcap, hd, splits):
    """Shuffled chains with null-block tails; row 0 only S long, so every
    span after its first is dead; spans ending mid-block.  The card's SM
    count is replaced so that the planner picks one, two or as many spans
    as the chains have stages.  Two calls in a row: the merge's tickets
    are back at zero after each."""
    from repro_torch.kernels.paged_attention import ops
    g = torch.Generator(device=cuda).manual_seed(1)
    B, Hkv = 3, 2
    n_blocks = -(-800 // bs)
    lengths = [S, S + 37, n_blocks * bs]
    groups = B * Hkv * ops.launch_plan(B, S, Hkv * rep, Hkv, hd, dtype,
                                       n_blocks, bs).n_tiles
    # the planner wants WAVES x sms blocks: 2 x groups of them gives two
    sms = {"one": 1, "two": 2 * groups // ops.WAVES, "many": 10 ** 6}[splits]
    monkeypatch.setattr(ops, "_sm_count", lambda device: sms)
    plan = ops.launch_plan(B, S, Hkv * rep, Hkv, hd, dtype, n_blocks, bs,
                           sms)
    assert plan.n_splits == {"one": 1, "two": 2}.get(splits, plan.n_splits)
    assert splits != "many" or plan.n_splits > 2
    num_phys = 1 + B * n_blocks
    perm = torch.randperm(num_phys - 1, generator=g, device=cuda) + 1
    table = torch.zeros((B, n_blocks), dtype=torch.int32, device=cuda)
    for b, L in enumerate(lengths):           # chains, then null-block holes
        nb = -(-L // bs)
        table[b, :nb] = perm[b * n_blocks:b * n_blocks + nb].to(torch.int32)
    P = num_phys * bs
    k = torch.randn((1, P, Hkv, hd), generator=g, device=cuda).to(dtype)
    v = torch.randn((1, P, Hkv, hd), generator=g, device=cuda).to(dtype)
    q = torch.randn((B, S, Hkv * rep, hd), generator=g, device=cuda).to(dtype)
    cl = torch.tensor(lengths, dtype=torch.int32, device=cuda)
    ref = ops.paged_attention_plain(q, k, v, table, cl, block_size=bs,
                                    softcap=softcap)
    for _ in range(2):
        n0 = ops.paged_attention.launches
        got = ops.paged_attention(q, k, v, table, cl, block_size=bs,
                                  softcap=softcap)
        torch.cuda.synchronize()
        assert ops.paged_attention.launches == n0 + 1
        np.testing.assert_allclose(got.float().cpu().numpy(),
                                   ref.float().cpu().numpy(),
                                   atol=_tol(dtype), rtol=_tol(dtype))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("B,H,Hkv,S,hd", [
    (1, 4, 4, 64, 128),    # MHA, one whole tile
    (2, 8, 2, 77, 64),     # GQA rep 4, ragged last tile
    (1, 8, 1, 130, 32),    # MQA, three tiles
    (2, 2, 2, 1, 16),      # a single position
] + [  # around the bf16 kernel's 128-row q and 64-position kv tiles
    (B, H, Hkv, S, hd) for S in (1, 63, 64, 65, 127, 128, 129, 1024)
    for hd in (64, 128) for B, H, Hkv in ((1, 2, 2), (2, 4, 1))
])
def test_flash_attention_kernel_matches_plain(cuda, dtype, causal, B, H,
                                              Hkv, S, hd):
    from repro_torch.kernels.flash_attention import ops
    g = torch.Generator(device=cuda).manual_seed(2)
    q = torch.randn((B, S, H, hd), generator=g, device=cuda).to(dtype)
    k = torch.randn((B, S, Hkv, hd), generator=g, device=cuda).to(dtype)
    v = torch.randn((B, S, Hkv, hd), generator=g, device=cuda).to(dtype)
    n0 = ops.flash_attention.launches
    got = ops.flash_attention(q, k, v, causal=causal)
    ref = ops.flash_attention_plain(q, k, v, causal=causal)
    torch.cuda.synchronize()
    assert ops.flash_attention.launches == n0 + 1
    np.testing.assert_allclose(got.float().cpu().numpy(),
                               ref.float().cpu().numpy(),
                               atol=_tol(dtype), rtol=_tol(dtype))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_flash_attention_kernel_reads_strided_views(cuda, dtype):
    """Full attention, Sq != Sk, q/k/v as views of fused projections."""
    from repro_torch.kernels.flash_attention import ops
    g = torch.Generator(device=cuda).manual_seed(3)
    q = torch.randn((2, 24, 2, 8, 64), generator=g,
                    device=cuda).to(dtype)[:, :, 0]
    kv = torch.randn((2, 100, 2, 2, 64), generator=g, device=cuda).to(dtype)
    k, v = kv.unbind(dim=2)
    n0 = ops.flash_attention.launches
    got = ops.flash_attention(q, k, v, causal=False)
    ref = ops.flash_attention_plain(q, k, v, causal=False)
    torch.cuda.synchronize()
    assert ops.flash_attention.launches == n0 + 1
    np.testing.assert_allclose(got.float().cpu().numpy(),
                               ref.float().cpu().numpy(),
                               atol=_tol(dtype), rtol=_tol(dtype))


def test_flash_attention_wrapper_raises_on_what_the_kernel_does_not_take(
        cuda):
    from repro_torch.kernels.flash_attention import ops
    z = torch.zeros((1, 8, 2, 160), device=cuda)              # hd > 128
    with pytest.raises(ValueError, match="hd"):
        ops.flash_attention(z, z, z)
    q = torch.zeros((1, 8, 2, 64), device=cuda)
    k = torch.zeros((1, 16, 2, 64), device=cuda)
    with pytest.raises(ValueError, match="Sq == Sk"):
        ops.flash_attention(q, k, k, causal=True)
    h = q.half()
    with pytest.raises(TypeError):
        ops.flash_attention(h, h, h)
    t = torch.zeros((1, 8, 64, 2), device=cuda).transpose(2, 3)
    with pytest.raises(ValueError, match="contiguous"):
        ops.flash_attention(t, t, t)
    b = torch.zeros((1, 8, 2, 68), dtype=torch.bfloat16,
                    device=cuda)[..., :64]               # rows on 8 bytes
    with pytest.raises(ValueError, match="16 bytes"):
        ops.flash_attention(b, b, b, causal=False)


def test_wrappers_raise_on_what_the_kernels_do_not_take(cuda):
    from repro_torch.kernels.moe_gmm import ops as gmm
    from repro_torch.kernels.paged_attention import ops as pa
    x = torch.zeros((128, 96), device=cuda)                  # d % 64 != 0
    w = torch.zeros((1, 96, 64), device=cuda)
    tg = torch.zeros((1,), dtype=torch.int32, device=cuda)
    with pytest.raises(ValueError, match="d % 64"):
        gmm.moe_gmm(x, w, torch.zeros((1, 64, 96), device=cuda), tg)
    q = torch.zeros((1, 1, 2, 160), device=cuda)             # hd > 128
    pool = torch.zeros((1, 16, 2, 160), device=cuda)
    with pytest.raises(ValueError, match="hd"):
        pa.paged_attention(q, pool, pool,
                           torch.zeros((1, 1), dtype=torch.int32,
                                       device=cuda), 1, block_size=16)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("tokens", [4, 32])     # decode, a prefill chunk
def test_moe_gmm_plain_form_at_switch128_dispatch(cuda, dtype, tokens):
    """switch128's plain form (GELU experts, no gate) at its decode and
    prefill-chunk dispatches: d 768, f 3072, 128 experts top-1 plus 4
    empty foreign groups, M the step's c_total, a seeded draw of experts;
    with the live-row count, as the model calls it."""
    from repro_torch.configs.registry import get_config
    from repro_torch.core.moe_layer import MoEBlockSpec
    from repro_torch.kernels.moe_gmm import ops
    cfg = get_config("switch128")
    E, K = cfg.moe.num_experts, cfg.moe.num_foreign_slots
    d, f, bm = cfg.d_model, cfg.moe.d_ff_expert, 128
    M = MoEBlockSpec(moe=cfg.moe, d_model=d, tokens_local=tokens,
                     block_m=bm).c_total
    sizes = np.bincount(np.random.default_rng(tokens).integers(0, E, tokens),
                        minlength=E).tolist() + [0] * K
    g = torch.Generator(device=cuda).manual_seed(3)
    sizes = torch.tensor(sizes, dtype=torch.int32, device=cuda)
    padded = ((sizes + bm - 1) // bm) * bm
    x = torch.zeros((M, d), device=cuda)
    off = 0
    for s, p in zip(sizes.tolist(), padded.tolist()):
        x[off:off + s] = torch.randn((s, d), generator=g, device=cuda) * 0.5
        off += p
    x = x.to(dtype)

    def w(*shape, fan_in):
        return (torch.randn(shape, generator=g, device=cuda)
                * (2.0 / fan_in) ** 0.5).to(dtype)
    w_in, w_out = w(E, d, f, fan_in=d), w(E, f, d, fan_in=f)
    foreign = (w(K, d, f, fan_in=d), w(K, f, d, fan_in=f), None)
    kw = dict(act="gelu", block_m=bm, foreign=foreign,
              live_rows=ops.live_row_count(padded, M))
    tg = ops.tile_group_map(padded, M // bm, bm)
    n0 = ops.moe_gmm.launches
    got = ops.moe_gmm(x, w_in, w_out, tg, **kw)
    ref = ops.moe_gmm_plain(x, w_in, w_out, tg, **kw)
    torch.cuda.synchronize()
    assert ops.moe_gmm.launches == n0 + 1
    np.testing.assert_allclose(got.float().cpu().numpy(),
                               ref.float().cpu().numpy(),
                               atol=_tol(dtype), rtol=_tol(dtype))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("S,slab", [(1, False), (32, True)])
def test_paged_attention_at_switch128_heads(cuda, dtype, S, slab):
    """12 heads of 64 (switch128's MHA): paged decode over shuffled chains
    of 16-token blocks, and a 32-token prefill chunk over the slab viewed
    as one contiguous chain (identity table, 96-position blocks)."""
    from repro_torch.kernels.paged_attention import ops
    g = torch.Generator(device=cuda).manual_seed(4)
    H, hd = 12, 64
    if slab:
        B, bs, lengths, n_blocks = 1, 96, [192], 3
        table = torch.arange(n_blocks, dtype=torch.int32,
                             device=cuda)[None]
        num_phys = n_blocks
    else:
        B, bs, lengths, n_blocks = 4, 16, [1, 77, 200, 288], 18
        num_phys = 1 + B * n_blocks
        perm = torch.randperm(num_phys - 1, generator=g, device=cuda) + 1
        table = torch.zeros((B, n_blocks), dtype=torch.int32, device=cuda)
        for b, L in enumerate(lengths):
            nb = -(-L // bs)
            table[b, :nb] = perm[b * n_blocks:b * n_blocks + nb].to(
                torch.int32)
    k = torch.randn((1, num_phys * bs, H, hd), generator=g,
                    device=cuda).to(dtype)
    v = torch.randn((1, num_phys * bs, H, hd), generator=g,
                    device=cuda).to(dtype)
    q = torch.randn((B, S, H, hd), generator=g, device=cuda).to(dtype)
    cl = torch.tensor(lengths, dtype=torch.int32, device=cuda)
    got = ops.paged_attention(q, k, v, table, cl, block_size=bs)
    ref = ops.paged_attention_plain(q, k, v, table, cl, block_size=bs)
    torch.cuda.synchronize()
    np.testing.assert_allclose(got.float().cpu().numpy(),
                               ref.float().cpu().numpy(),
                               atol=_tol(dtype), rtol=_tol(dtype))


def _engine_streams(cfg, params, *, paged, device):
    from repro_torch.models.model import build_model
    from repro_torch.serve import (Request, ServeEngine, VirtualClock,
                                   engine_config_for)
    model = build_model(cfg, batch=3, seq_len=40, device=device)
    eng = ServeEngine(model, params, engine_config_for(
        cfg, max_slots=3, prompt_len=40, max_new_tokens=8, prefill_chunk=16,
        paged=paged, kv_block_size=8), clock=VirtualClock(0.1),
        device=device)
    rng = np.random.default_rng(5)
    out = {}
    orig = eng._finish

    def capture(st, now):
        out[st.req.rid] = list(st.output)
        orig(st, now)
    eng._finish = capture
    rep = eng.run([Request(rid=i, tokens=rng.integers(
        0, cfg.vocab_size, (int(rng.integers(5, 40)),)), max_new_tokens=8)
        for i in range(5)])
    return out, rep


@pytest.mark.parametrize("arch", ["moonshot-v1-16b-a3b", "switch128"])
@pytest.mark.parametrize("paged", [False, True])
def test_reduced_engine_streams_on_card_equal_cpu(cuda, arch, paged):
    """Reduced f32 models through ``ServeEngine`` on the slab and the paged
    pool: the card's greedy streams (moe_gmm's gated or plain form, the
    paged kernel over the scratch and, paged, the pool) equal the CPU's
    through the plain versions."""
    from repro_torch.configs.registry import get_config
    from repro_torch.models.model import build_model
    cfg = get_config(arch).reduced()
    params = build_model(cfg, batch=3, seq_len=40, device="cpu").init(0)
    out_cpu, _ = _engine_streams(cfg, params, paged=paged, device="cpu")
    on_card = _tree_to(params, cuda)
    out_card, rep = _engine_streams(cfg, on_card, paged=paged, device=cuda)
    assert out_card == out_cpu
    assert rep["state_pool"]["kind"] == ("paged" if paged else "slab")


def _tree_to(tree, dev):
    if isinstance(tree, dict):
        return {k: _tree_to(v, dev) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_tree_to(v, dev) for v in tree]
    return tree.to(dev)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("gated", [True, False])
@pytest.mark.parametrize("n_rep,n_foreign", [(2, 2), (3, 0), (0, 2)])
@pytest.mark.parametrize("bm", [64, 128])
def test_moe_gmm_kernel_with_replica_groups_matches_plain(
        cuda, dtype, gated, n_rep, n_foreign, bm):
    """Three weight sources, local | replica | foreign, each group reading
    its own (f32 2e-5, bf16 2e-2); the replica groups give, bit for bit,
    what the two-source launch gives with those rows appended to the
    local ones; and the foreign-row counter counts only the groups after
    the replicas."""
    from repro_torch.kernels.moe_gmm import ops
    g = torch.Generator(device=cuda).manual_seed(5)
    d, f, n_local = 128, 192, 3
    sizes = [33, 0, 70][:n_local] + [17, 64, 1][:n_rep] + [5, 90][:n_foreign]
    sizes = torch.tensor(sizes, dtype=torch.int32, device=cuda)
    padded = ((sizes + bm - 1) // bm) * bm
    M = int(padded.sum()) + bm
    x = torch.zeros((M, d), device=cuda)
    off = 0
    for s, p in zip(sizes.tolist(), padded.tolist()):
        x[off:off + s] = torch.randn((s, d), generator=g, device=cuda) * 0.5
        off += p
    x = x.to(dtype)

    def w(n):
        return tuple((torch.randn(shape, generator=g, device=cuda) * 0.1
                      ).to(dtype) if m != 2 or gated else None
                     for m, shape in enumerate([(n, d, f), (n, f, d),
                                                (n, d, f)]))
    local, rep, foreign = w(n_local), w(n_rep), w(n_foreign)
    kw = dict(w_gate=local[2], act="silu" if gated else "gelu", block_m=bm,
              replica=rep if n_rep else None,
              foreign=foreign if n_foreign else None,
              live_rows=ops.live_row_count(padded, M))
    tg = ops.tile_group_map(padded, M // bm, bm)
    ops.reset_foreign_rows()
    n0 = ops.moe_gmm.launches
    f_rows = sizes[n_local + n_rep:].sum()
    got = ops.moe_gmm(x, local[0], local[1], tg, foreign_rows=f_rows, **kw)
    ref = ops.moe_gmm_plain(x, local[0], local[1], tg, **kw)
    torch.cuda.synchronize()
    assert ops.moe_gmm.launches == n0 + 1
    assert ops.foreign_rows_total() == (int(f_rows) if n_foreign else 0)
    np.testing.assert_allclose(got.float().cpu().numpy(),
                               ref.float().cpu().numpy(),
                               atol=_tol(dtype), rtol=_tol(dtype))
    if n_rep:
        cat = [None if a is None else torch.cat([a, b])
               for a, b in zip(local, rep)]
        two = ops.moe_gmm(x, cat[0], cat[1], tg, **{**kw, "replica": None,
                                                    "w_gate": cat[2]})
        torch.cuda.synchronize()
        assert torch.equal(two, got)


def _tie_logits(B, V, seed):
    """bf16 logits with many exact ties: a few hundred distinct values
    over the vocabulary, the largest shared by dozens of tokens."""
    g = torch.Generator().manual_seed(seed)
    lv = torch.randint(-400, 8, (B, V), generator=g).float() / 16
    return lv.to(torch.bfloat16).float()


@pytest.mark.parametrize("top_k,top_p", [(0, 1.0), (50, 1.0), (0, 0.9),
                                         (50, 0.9)])
def test_captured_sampler_equals_plain(cuda, top_k, top_p):
    """The decode step's sampler at qwen15-moe-a27b's serve shape (8 rows
    x its 152,064 padded-vocabulary logits), captured in a CUDA graph (a host read would fail
    the capture) and replayed on fresh noise in its static buffer: token
    for token the CPU's plain version on the same tie-heavy logits and
    noise."""
    from repro_torch.serve.sampling import gumbel_, noise_width, sample_tokens
    B, V = 8, 152064
    kw = dict(temperature=0.8, top_k=top_k, top_p=top_p)
    lg = _tie_logits(B, V, 0).to(cuda)
    nz = torch.zeros((B, noise_width(V, top_k)), device=cuda)
    eager = sample_tokens(lg, nz, **kw)          # warm the allocator
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        out = sample_tokens(lg, nz, **kw)
    for seed in range(4):
        lg.copy_(_tie_logits(B, V, seed))
        host = gumbel_(torch.empty(nz.shape), torch.Generator().manual_seed(
            seed))
        nz.copy_(host)
        graph.replay()
        eager = sample_tokens(lg, nz, **kw)
        want = sample_tokens(lg.cpu(), host, **kw)
        torch.cuda.synchronize()
        assert torch.equal(out.cpu(), want), seed
        assert torch.equal(eager.cpu(), want), seed
