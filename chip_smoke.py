#!/usr/bin/env python3
"""Smoke run of the PyTorch port (``src/repro_torch``) on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, each of which must pass (any failure exits non-zero):
  1. environment: the card's name and power limit (nvidia-smi), TF32 off,
     the hand-written CUDA kernels built from ``src/repro_torch/csrc``,
     and the count of tensor-core instructions (HGMMA and HMMA) in each
     library, which must not be 0 for any kernel: bf16 moe_gmm and
     flash_attention run on wgmma, bf16 paged_attention q tiles of 16
     rows on mma.sync;
  2. kernel parity at the main paths' shapes: every kernel against its
     plain PyTorch version on the same inputs (bf16, plus f32 at a smaller
     size; moe_gmm also at the whole-prompt path's dispatch and at one EP
     rank's decode dispatch with foreign groups carrying rows,
     paged_attention also on long decode chains), with its device time, the plain version's, one PyTorch library call's as a
     yardstick, and the card's least time for the work; and the Alg. 2
     kernel (``schedule``, one CTA: the JAX scheduler's while loop)
     against its plain version, S and the four diagnostics exactly
     equal, at the serve paths' decode schedules (timed) and on seeded
     count matrices at G = 1, 4, 8 and Ep = 60, 64, 128 that together
     reach every stop condition and the pair-capacity branch;
  3. the serve path: ``ServeEngine`` serving full-width qwen15-moe-a27b
     (random weights from a seed, bf16, paged KV (asked for: the engine's
     default is the slab), chunked prefill, greedy,
     HarMoEny policy at one rank), with each kernel's launch count over
     that run, which must be > 0; the engine captures its prefill
     chunk, its decode step and the KV store's write each as one CUDA
     graph at warmup and replays them (``jit_entries`` must be
     ``{"prefill_chunk": 1, "decode": 1, "write_blocks": 1}``, or
     ``"write_slot"`` on the slab, with ``recompiled_after_warmup`` False
     after this run and every engine run of phases 4b, 6 and 7);
  4. correctness of what comes out: every request finished with its
     tokens in the vocabulary, finite logits of the expected shape, and,
     on a small configuration, the card's token streams equal to the
     plain versions' streams on the CPU;
  4b. HarMoEny across expert-parallel ranks, once the serve path's memory
     is freed: ``ServeEngine`` on full-width, full-depth qwen15-moe-a27b
     at EP degree 4 on virtual ranks (``VirtualGroup``: four ranks of 15
     experts each, run in lockstep on the one card; 4 foreign slots),
     under the paper's synthetic skew (0.9 of the routing mass on one
     expert, q = 1 so that decode-scale loads clear the movement
     granularity), 4 requests of 64-128 prompt tokens and 8 new tokens,
     once with the harmoeny policy and once with round_robin.  An ``[ep]``
     line per policy gives TTFT and TPOT p50, throughput, peak memory,
     moved units per MoE layer and decode step, the decode and prefill
     max/mean rank-load ratio and straggler wait (units), drop totals,
     ``moe_gmm`` launches and the foreign-group rows through them, and
     ``paged_attention`` launches.  Gates: harmoeny drops nothing, moves
     units at decode and sends rows through ``moe_gmm``'s foreign groups;
     its decode max/mean ratio is below round_robin's; every request
     finishes with tokens in the vocabulary and finite logits; and a
     reduced qwen15-moe-a27b in f32 with learned routing at EP degree 4
     gives the same greedy streams on the card as on the CPU (whose ranks
     are virtual too).  Virtual ranks run one after another, so this
     phase measures balance in units, not the latency gain the paper
     measures across GPUs;
  5. the whole-prompt path, once the serve path's memory is freed:
     full-width, full-depth moonshot-v1-16b-a3b (random bf16 weights from
     a seed) through ``launch.steps``' ``make_prefill_step`` on 4 prompts
     of 1024 tokens (attention through the flash kernel in every layer)
     and 32 greedy ``make_decode_step``s on the slab cache, with the
     prefill time, the decode step time, peak memory and the kernels'
     launch counts over that run; tokens in the vocabulary, finite
     logits, and on the reduced configuration the card's greedy tokens
     equal to the plain versions' tokens on the CPU in f32 (the CUDA-core
     designs), and in bf16 (the tensor-core designs), on the f32 run's
     expert choices, the card's logits within twice the bf16 noise
     measured on the CPU, while three planted faults fall outside it;
  6. the engine across layer patterns, at full width and depth in bf16:
     ``ServeEngine`` on the slab pool (the engine's default) serving
     moonshot-v1-16b-a3b on phase 5's weights (its dense lead layer's
     K/V in the slot rows beside the stacked layers'; 4 slots, 4 requests
     of 64-128 prompt tokens, 8 new tokens), then switch128 (dense/MoE
     periods, GELU experts: ``moe_gmm``'s plain form in its 6 MoE layers,
     12 x 64 heads in ``paged_attention``) on the slab and paged (8
     requests of 64-256 prompt tokens, 32 new tokens).  A ``[serve-slab]``
     or ``[serve-switch]`` line each: TTFT/TPOT p50/p90, throughput, peak
     memory, launches.  Gates: every request finishes with its budget;
     ``moe_gmm`` launched once per MoE layer and step, ``paged_attention``
     once per layer and prefill chunk (and decode step, paged); the
     dispatch shows ``prefill_continue`` fused and, on the slab,
     ``decode_slab``; and reduced moonshot and switch128 in f32, on the
     slab and paged, give the same greedy streams on the card as on the
     CPU.  Phase 2 also holds ``moe_gmm``'s plain form at switch128's
     decode and prefill-chunk dispatches and ``paged_attention`` at its
     head shape against their plain versions;
  7. eager against captured, on the weights of phases 3, 4b and 6 (qwen
     at G = 1 paged; qwen at G = 4 under harmoeny and round_robin, skew
     0.9; moonshot on the slab; switch128 on the slab and paged): the
     same requests served with every entry eager (``stepcore.eager()``)
     and with the captured ones; then prefill chunks of one long prompt
     (one under ``torch.profiler``, the next 3 without) and a window of
     decode steps with every slot decoding (1 traced: an eager step's
     trace holds 10-35 k kernels, whose processing is the phase's longest
     part; 3 not).  A ``[capture]``
     line each: TTFT and TPOT p50; for a prefill chunk and for a decode
     step, wall ms, device busy ms, idle share, host launches (kernels
     and graphs), copies/syncs, and the host ms of the skew pre-draws.
     Gates: equal greedy streams (where a bf16 stream differs, the logits
     at the first differing step within 2e-2 of the largest logit),
     fewer host launches a captured chunk and step than eager ones, at
     most 2 a captured chunk without skew (its graph and the write's),
     one capture of each entry, none eager;
  8. serving-time expert placement, right after phase 4b on its weights
     (which carry 2 zero replica slots a rank): full-width qwen at EP
     degree 4 under harmoeny, skew 0.9, q = 1, paged, 3 requests of
     64-128 prompt tokens and 12 new tokens, served without either
     mechanism, with hot-expert replica slots (``replica_slots=2,
     rebalance_interval=4``: a captured device gather into the replica
     leaves) and with tiered residency (``resident_experts=32``, W = 8
     of 15, under each prefetch policy: every expert row in pinned host
     memory, each decision's rows copied to the card on a side stream).
     A ``[placement]`` line each: TTFT/TPOT p50, decode balance, drops,
     foreign rows through ``moe_gmm``, launches, ``jit_entries``, the
     captured decode step's wall and busy ms with every slot decoding,
     swaps, hot experts and the swap's device ms against its bound, the
     residency counters, the host tier's size and pinning seconds, and
     each stage's rows, bytes, copy ms and GB/s against PCIe Gen5's
     64 GB/s.  Gates: streams equal the run without the mechanism, one
     capture of each entry and of the swap across every swap and stage,
     at least one swap and one stage (none under ``none``), drops 0.
     Phase 2 also holds ``moe_gmm`` with replica groups (a third weight
     source) against its plain version at this path's decode dispatch;
  9. the serving CLI, in processes of its own: first the decode
     step's sampler at the serve shape (8 x the padded vocabulary),
     captured in a CUDA graph, against its plain version on the CPU, token
     for token, on tie-heavy bf16 logits and fixed noise at (top_k, top_p)
     = (0, 1), (50, 1), (0, 0.9), (50, 0.9), with its device ms a step;
     reduced qwen15-moe-a27b in f32, sampled, paged: the card's streams
     equal the CPU's on the same noise; then ``python -m
     repro_torch.launch.serve`` twice at full width and depth, bf16,
     sampled (temperature 0.8, top-k 50): (a) one rank, 8 slots, 24
     Poisson requests at 8 req/s of 128 prompt tokens and 32 new, top-p
     0.9 (a ``[cli]`` line: TTFT p50/p90/p99, TPOT p50/p90, throughput,
     peak memory, launches, the sampler's device ms a step and the noise
     pre-draw's host ms); (b) four virtual EP ranks under 0.9 skew, q = 1,
     harmoeny, 4 requests of 8 new tokens (a ``[cli-ep]`` line, with the
     decode max/mean rank load and moved units).  Gates: each process
     exits 0 and writes its report; every request finishes with its
     budget, tokens in the vocabulary; one capture of each entry; each
     kernel launched once per layer (and rank) and step; the kernels'
     dispatch; (b) drops nothing and moves units;
  10. HarMoEny across processes, and the foreign fetch on its side
     stream: (a) the CLI at full width and G = 1 in its own process under
     ``torch.distributed.run --standalone --nproc-per-node 1``
     (``DistComm`` on NCCL, dense fetch, every entry captured), 4
     requests of 128 prompt tokens and 8 new, against the same argv
     without a launcher (``LocalComm``); each replays its last decode
     graph once more under the profiler (a ``[cli-nccl]`` line).  Gates:
     exit 0, reports written, one capture of each entry, equal greedy
     streams and launches, device work in the NCCL graph beyond the
     ``LocalComm`` graph's; (b) four processes on the one card over gloo
     (gloo's collectives tried on CUDA tensors first), each a
     ``DistComm`` rank with the hosted fetch and eager entries holding
     only its own 15 experts a layer, serving full-width qwen at G = 4
     under skew 0.9 with harmoeny (2 requests of 64-128 prompt tokens,
     8 new), against ``VirtualGroup(4)`` eager on the same weights
     (``[dist]`` lines: each process's peak memory, fetch bytes a call,
     pre-draw host ms, launches).  Gates: streams and ``load_balance``
     equal on every rank, drops 0, units moved, launches per process =
     layers x calls; (c) from phase 7's G = 4 runs, for the decode step
     and the prefill chunk of each policy: wall, busy, idle, the fetch's
     side-stream device ms and how much of it ran beside other kernels,
     against the busy ms of the dense fetch before it (a ``[fetch]``
     line each; phase 7's
     harmoeny run also serves its windows captured with the dense fetch
     on the compute stream, whose tokens must equal the gather's).
     Gate: the eager trace puts the fetch on a stream of its own;
  11. mixtral-8x7b at full width (d 4096, 32 q / 8 kv heads of 128, 8
     experts of f 14,336 top-2, vocab 32,000, bf16), cut to 8 of its 32
     layers (the full depth's ~87 GiB of weights do not fit the card),
     weights drawn once: (a) G = 1, paged, the window of 4096 not binding
     (8 requests of 256-1024 prompt tokens and 32 new; the ``[mixtral]``
     line, with ``pattern_serve``'s gates: every entry captured,
     ``moe_gmm`` once a layer a step, ``paged_attention`` once a layer a
     chunk and a step); (b) the window binding: paged, 2 prompts of 4,600
     with 32 new tokens (``kv_block_size`` 16, chunk 512: rings of 4,096
     positions, chains of 256 blocks allocated whole; ``decode_ring`` and
     the chunk under the window run their plain torch forms, so neither
     launches ``paged_attention``), and the slab clamped to the window, 1
     prompt of 4,000 with 200 new tokens, so that decode wraps it; each
     stream held step by step against ``launch.steps``' one-shot windowed
     oracle on the same weights, fed the engine's tokens: each step's
     token against the oracle's argmax and the engine's logits row
     against the oracle's, before the wrap and after it, gated in bf16 on
     the share of agreeing steps and the median logits error after the
     wrap (``RING_GATES``: the kernels and the oracle's plain attention
     round differently and flip some tokens' experts); after (c), both
     rings again on the same 8 layers cast to f32, where every step's
     token must be the oracle's argmax (up to near ties) and every
     logits row within ``RING_GATES``' bound of the oracle's; (c) G = 4 on
     virtual ranks under 0.9 skew, harmoeny, 4 requests (phase 4b's
     ``[ep]`` line, plus the hosted gather's bytes: 8 rows x 3 matrices
     of 117 MB a layer and call); gates: drops 0, units moved; (d) reduced
     mixtral in f32 (window 64), prompts past the window, slab and paged,
     G = 1 and 4: the card's greedy streams equal the CPU's.  Phase 2
     holds ``moe_gmm`` at (a)'s decode and prefill-chunk dispatches and
     ``paged_attention`` at its decode (GQA rep 4) and prefill chunk.
     ``python3 chip_smoke.py --only-mixtral`` runs phase 1, those parity
     cases and phase 11 alone, and prints no result;
  12. prefix sharing and speculative decoding on the paged pool, full-width
     qwen15-moe-a27b (bf16 weights drawn once from seed 0), 4 slots,
     16-token blocks, chunk 32, strict (``fused_paged_attention`` and
     ``fused_moe_gmm`` on): (a) prefix sharing at G = 1, greedy, 32 new
     tokens: request 0 of 8 Poisson prompts of 576-640 tokens that share
     their first 512 (cut to a multiple of the block size) served alone,
     then requests 1-7, then a ninth whose prompt is request 0's again (a
     full-prompt hit: copy-on-write), once with sharing and once without
     (whose pool asks for one chunk more, so both have the same chains);
     a ``[prefix]`` line: TTFT p50/p90 and TPOT p50 of requests 1-7 with
     and without sharing, the hit rate, each request's cached tokens, CoW
     copies, evictions, chunks, phases, peak memory, and the captured
     gather's and copy's device ms against their bytes at 3.35 TB/s;
     gates: every budget, requests 1-7 start from >= 512 cached tokens, a
     CoW copy, ``jit_entries`` = {prefill_chunk, decode, write_blocks,
     gather_prefix, copy_block: 1} and nothing captured again, each
     kernel once per layer a chunk (prefix-tail chunks included) and a
     step; (b) speculative decoding at G = 1: 4 prompts of 128 tokens
     tiling a 16-token motif, 64 new: k = 0 greedy, k = 4 (ngram) greedy,
     k = 4 sampled (temperature 0.8, top-k 50), k = 4 drafting k = 0's own
     tokens with every third window's last draft wrong (random weights do
     not follow the motifs, so the n-gram proposer drafts almost
     nothing; these drafts make the verify step accept and reject), and
     k = 4 teacher-forced on k = 0's stream; a ``[spec]`` line:
     acceptance, committed tokens a slot-step, verify steps, TPOT p50, and
     with every slot decoding the captured verify (or decode) step's wall
     and busy ms (one traced, three untraced) and the logits' one copy to
     pinned memory; gates: every budget, one capture of each entry, the
     ``verify`` branch fused, each kernel once per layer a verify step,
     tokens in the vocabulary, the drafting run both accepting and
     rejecting; (c) on ``VirtualGroup(4)``, harmoeny, q = 1, 2 requests of
     64-128 tokens, 8 new: k = 4 and k = 0 under skew 0.9, and k = 0 and
     k = 4 teacher-forced with the learned router (a ``[spec-ep]`` line:
     drops, moved units, decode max/mean); gates: drops 0 and units
     moved under skew.  ``[prefix-spec]`` lines give where
     the greedy streams of sharing on and off and of k = 4 and k = 0 part
     (position, tokens, the reference's logit gap between them), and the
     teacher-forced rows held to k = 0's position by position (the share
     whose argmax is k = 0's token, the median and largest logits error);
     where a bf16 stream parts, the same comparisons run again with the
     weights cast to f32, where a stream may part and a teacher-forced
     position disagree only at a near tie (1e-3 of the largest logit) and
     the median logits error must be <= 1e-2, and only then the bf16
     teacher-forced rows must hold ``FORCED_GATES``' bounds, set from the
     f32-checked readings; (d) reduced qwen15-moe-a27b in f32 on motif
     prompts, sharing off with k = 0 and sharing on with k = 4, G = 1 and
     4: card streams, prefix counters and speculative sections equal the
     CPU's.  Phase 2 holds
     ``paged_attention`` at (b)'s verify window and (a)'s prefix-tail
     chunk and ``moe_gmm`` at the verify step's 20 tokens.  ``python3
     chip_smoke.py --only-prefix-spec`` runs phase 1, those parity cases
     and phase 12 alone, and prints no result.
The line before the last is a JSON object of the kernels' numbers; the
last line is ``{"ok": true, "device": {...}}``.  Without a CUDA device, or
without the repository's ``src/`` beside it, the script exits non-zero
and prints no result.
"""
from __future__ import annotations

import contextlib
import gc
import json
import os
import shutil
import subprocess
import sys
import time

HERE = os.path.dirname(os.path.abspath(__file__))
HBM_BYTES_S = 3.35e12                 # H100 SXM data sheet
PEAK_FLOPS = {"bfloat16": 989e12,     # dense tensor-core rate
              "float32": 67e12}       # float32 outside the tensor cores
TOL = {"bfloat16": 2e-2, "float32": 2e-5}
SPIN_HZ = 2.0e9                       # above the H100's top SM clock (1.98 GHz)
REPLACES = {
    "moe_gmm": "src/repro/kernels/moe_gmm/moe_gmm.py:88",
    "paged_attention": "src/repro/kernels/paged_attention/paged_attention.py:126",
    "flash_attention": "src/repro/kernels/flash_attention/flash_attention.py:70",
    # not a Pallas kernel: the JAX scheduler's lax.while_loop (Alg. 2)
    "schedule": "src/repro/core/scheduler.py:205",
}
SOURCES = {name: f"src/repro_torch/csrc/{name}.cu" for name in REPLACES}
# every kernel's bf16 design runs on the tensor cores: wgmma (HGMMA) in
# moe_gmm and flash_attention, mma.sync (HMMA) in paged_attention
TENSOR_CORE = ("moe_gmm", "flash_attention", "paged_attention")


def log(msg: str) -> None:
    print(msg, flush=True)


def cuda_ms(fn, iters: int, warmup: int = 2) -> float:
    """CUDA-event time per call over back-to-back calls: the device time
    plus any gap the host leaves between launches."""
    import torch
    for _ in range(warmup):
        fn()
    start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    torch.cuda.synchronize()
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def device_ms(fn, iters: int, warmup: int = 2) -> float:
    """Device time per call: each timed call is queued behind a spin
    kernel that outlasts its enqueueing on the host, so the card runs its
    kernels back to back and the CUDA events around it see no launch gap
    (one call at a time: a chain of many launches stays within the
    launch queue)."""
    import torch
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    fn()
    torch.cuda.synchronize()
    spin = int(2 * (time.perf_counter() - t0) * SPIN_HZ)
    total = 0.0
    for _ in range(iters):
        start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
        torch.cuda._sleep(spin)
        start.record()
        fn()
        end.record()
        torch.cuda.synchronize()
        total += start.elapsed_time(end)
    return total / iters


def compare(name, got, ref, dtype_name):
    import torch
    g, r = got.float(), ref.float()
    if g.shape != r.shape:
        raise AssertionError(f"{name}: shape {tuple(g.shape)} != {tuple(r.shape)}")
    if not torch.isfinite(g).all():
        raise AssertionError(f"{name}: non-finite kernel output")
    tol = TOL[dtype_name]
    err = (g - r).abs()
    excess = float((err - (tol + tol * r.abs())).max())
    max_err = float(err.max())
    if excess > 0:
        raise AssertionError(f"{name}: max abs err {max_err:.3e} exceeds "
                             f"atol=rtol={tol} by {excess:.3e}")
    return max_err, tol


def bound(bytes_moved: float, flops: float, dtype_name: str):
    t_bytes = bytes_moved / HBM_BYTES_S * 1e3
    t_ops = flops / PEAK_FLOPS[dtype_name] * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def smi_line() -> str:
    """The card's name and power limit as nvidia-smi reports them."""
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]


def tensor_core_counts(build):
    """Tensor-core instructions in each built library, ``HGMMA`` (wgmma)
    and ``HMMA`` (mma.sync) apart, from the toolkit's ``cuobjdump -sass``."""
    tool = shutil.which("cuobjdump") or os.path.join(
        os.path.dirname(build._nvcc()), "cuobjdump")
    if not os.path.exists(tool):
        raise RuntimeError("cuobjdump not found beside nvcc: the tensor-core "
                           "instructions cannot be counted")
    counts = {}
    for name in build.KERNELS:
        sass = subprocess.run([tool, "-sass", str(build._lib_path(name))],
                              capture_output=True, text=True,
                              check=True).stdout
        counts[name] = {op: sass.count(op) for op in ("HGMMA", "HMMA")}
    return counts


# ----------------------------------------------------------------------
# phase 2: kernel parity
# ----------------------------------------------------------------------
def moe_gmm_case(label, sizes, *, M, n_local, d, f, block_m, dtype, seed,
                 time_it, gated=True, n_rep=0):
    """``gated``: SwiGLU experts (the gated form); else GELU experts with no
    gate matrix (the plain form, switch128's).  The groups after the
    ``n_local`` local ones are ``n_rep`` replica groups (their own weight
    source) and then foreign ones."""
    import torch
    import torch.nn.functional as F
    from repro_torch.kernels.moe_gmm import ops
    dev = "cuda"
    g = torch.Generator(device=dev).manual_seed(seed)
    G = len(sizes)
    sizes_t = torch.tensor(sizes, dtype=torch.int32, device=dev)
    padded = ((sizes_t + block_m - 1) // block_m) * block_m
    assert int(padded.sum()) <= M
    x = torch.zeros((M, d), dtype=dtype, device=dev)
    off = 0
    for s, p in zip(sizes, padded.tolist()):
        x[off:off + s] = (torch.randn((s, d), generator=g, device=dev)
                          * 0.5).to(dtype)
        off += p

    def w(n, a, b, fan_in):
        return (torch.randn((n, a, b), generator=g, device=dev)
                * (2.0 / fan_in) ** 0.5).to(dtype)
    K = G - n_local - n_rep
    w_in, w_out = w(n_local, d, f, d), w(n_local, f, d, f)
    w_gate = w(n_local, d, f, d) if gated else None
    replica = ((w(n_rep, d, f, d), w(n_rep, f, d, f),
                w(n_rep, d, f, d) if gated else None) if n_rep else None)
    foreign = ((w(K, d, f, d), w(K, f, d, f),
                w(K, d, f, d) if gated else None) if K else None)
    tg = ops.tile_group_map(padded, M // block_m, block_m)
    # as the main path calls it: with the live-row count of the extents
    kw = dict(w_gate=w_gate, act="silu" if gated else "gelu",
              block_m=block_m, replica=replica, foreign=foreign,
              live_rows=ops.live_row_count(padded, M))
    got = ops.moe_gmm(x, w_in, w_out, tg, **kw)
    every_tile = ops.moe_gmm(x, w_in, w_out, tg, **{**kw, "live_rows": None})
    ref = ops.moe_gmm_plain(x, w_in, w_out, tg, **kw)
    torch.cuda.synchronize()
    dname = str(dtype).split(".")[-1]
    err, tol = compare(f"moe_gmm[{label}]", got, ref, dname)
    compare(f"moe_gmm[{label}, every tile live]", every_tile, ref, dname)
    del every_tile
    rec = {"case": label, "dtype": dname, "form": "gated" if gated else
           "plain", "M": M, "G": G, "d": d, "f": f, "max_abs_err": err,
           "tol": tol}
    if n_rep:
        rec["groups"] = {"local": n_local, "replica": n_rep, "foreign": K}
        rec["rows"] = {"local": sum(sizes[:n_local]),
                       "replica": sum(sizes[n_local:n_local + n_rep]),
                       "foreign": sum(sizes[n_local + n_rep:])}
    if time_it:
        parts = [(w_in, w_out, w_gate)] + [p for p in (replica, foreign) if p]
        all_in = torch.cat([p[0] for p in parts])
        all_out = torch.cat([p[1] for p in parts])
        all_gate = torch.cat([p[2] for p in parts]) if gated else None
        offs = [0] + torch.cumsum(padded, 0).tolist()
        live = [(gi, offs[gi], s) for gi, s in enumerate(sizes) if s]

        def library():            # one matmul chain per live group
            y = torch.zeros_like(x)
            for gi, o, s in live:
                xg = x[o:o + s]
                h = xg @ all_in[gi]
                h = (F.silu(xg @ all_gate[gi]) * h if gated
                     else F.gelu(h, approximate="tanh"))
                y[o:o + s] = h @ all_out[gi]
            return y
        def kernel():
            return ops.moe_gmm(x, w_in, w_out, tg, **kw)
        rec["ms"] = device_ms(kernel, 10)
        rec["event_ms"] = cuda_ms(kernel, 10)
        rec["plain_ms"] = device_ms(
            lambda: ops.moe_gmm_plain(x, w_in, w_out, tg, **kw), 3, 1)
        rec["library_ms"] = device_ms(library, 10)
        # x read over the live rows only (the kernel skips the tiles at or
        # past the live-row count), y written over all M, the live groups'
        # weight matrices (three gated, two plain) read once
        esz = x.element_size()
        live_rows = min(int(padded.sum()), M)
        n_mats = 3 if gated else 2
        bytes_moved = ((live_rows + M) * d * esz
                       + n_mats * len(live) * d * f * esz + tg.numel() * 4)
        flops = 2.0 * n_mats * sum(sizes) * d * f
        rec["bound_ms"], rec["bound_by"] = bound(bytes_moved, flops, dname)
    return rec


def paged_attention_inputs(*, B, S, H, Hkv, hd, bs, lengths, n_blocks,
                           dtype, seed, slab=False, dev="cuda"):
    """q, the pools, the block table and the lengths of one case."""
    import torch
    g = torch.Generator(device=dev).manual_seed(seed)
    if slab:                   # the slab-as-pool view: identity tables
        num_phys = B * n_blocks
        table = torch.arange(num_phys, dtype=torch.int32,
                             device=dev).reshape(B, n_blocks)
    else:                      # shuffled chains, tails on the null block 0
        num_phys = B * n_blocks + 1
        perm = torch.randperm(num_phys - 1, generator=g, device=dev) + 1
        table = torch.zeros((B, n_blocks), dtype=torch.int32, device=dev)
        for b, L in enumerate(lengths):
            nb = -(-L // bs)
            table[b, :nb] = perm[b * n_blocks:b * n_blocks + nb].to(torch.int32)
    P = num_phys * bs
    k_pool = torch.randn((1, P, Hkv, hd), generator=g, device=dev).to(dtype)
    v_pool = torch.randn((1, P, Hkv, hd), generator=g, device=dev).to(dtype)
    q = torch.randn((B, S, H, hd), generator=g, device=dev).to(dtype)
    cl = torch.tensor(lengths, dtype=torch.int32, device=dev)
    return q, k_pool, v_pool, table, cl


def paged_attention_case(label, *, B, S, H, Hkv, hd, bs, lengths, n_blocks,
                         softcap, dtype, seed, time_it, slab=False):
    import torch
    import torch.nn.functional as F
    from repro_torch.kernels.paged_attention import ops
    dev = "cuda"
    q, k_pool, v_pool, table, cl = paged_attention_inputs(
        B=B, S=S, H=H, Hkv=Hkv, hd=hd, bs=bs, lengths=lengths,
        n_blocks=n_blocks, dtype=dtype, seed=seed, slab=slab, dev=dev)
    kw = dict(block_size=bs, softcap=softcap)
    got = ops.paged_attention(q, k_pool, v_pool, table, cl, **kw)
    ref = ops.paged_attention_plain(q, k_pool, v_pool, table, cl, **kw)
    torch.cuda.synchronize()
    dname = str(dtype).split(".")[-1]
    err, tol = compare(f"paged_attention[{label}]", got, ref, dname)
    plan = ops.launch_plan(B, S, H, Hkv, hd, dtype, n_blocks, bs,
                           ops._sm_count(q.device))
    rec = {"case": label, "dtype": dname, "B": B, "S": S, "H": H, "Hkv": Hkv,
           "hd": hd, "block_size": bs, "lengths": list(lengths),
           "route": "tensor cores" if plan.tensor_cores else "CUDA cores",
           "splits": plan.n_splits, "span": plan.span, "ctas": plan.ctas,
           "max_abs_err": err, "tol": tol}
    if time_it:
        # the library call attends over K/V already gathered to [B, H, L, hd]
        L = n_blocks * bs
        log_pos = torch.arange(L, device=dev)
        phys = table.long()[:, log_pos // bs] * bs + log_pos % bs
        rep = H // Hkv
        kg = k_pool[0][phys].repeat_interleave(rep, 2).transpose(1, 2)
        vg = v_pool[0][phys].repeat_interleave(rep, 2).transpose(1, 2)
        q_pos = cl[:, None] - S + torch.arange(S, device=dev)[None]
        mask = ((log_pos[None, None] <= q_pos[:, :, None])
                & (log_pos[None, None] < cl[:, None, None]))[:, None]
        qt = q.transpose(1, 2)
        def kernel():
            return ops.paged_attention(q, k_pool, v_pool, table, cl, **kw)
        rec["ms"] = device_ms(kernel, 20)
        rec["event_ms"] = cuda_ms(kernel, 20)
        rec["plain_ms"] = device_ms(
            lambda: ops.paged_attention_plain(q, k_pool, v_pool, table, cl,
                                              **kw), 10)
        rec["library_ms"] = device_ms(
            lambda: F.scaled_dot_product_attention(qt, kg, vg, attn_mask=mask),
            20)
        esz = q.element_size()
        visible = 0          # (query, kv position) pairs the masks keep
        for b, Lb in enumerate(lengths):
            for i in range(S):
                visible += max(0, min(Lb - S + i + 1, Lb))
        kv_bytes = sum(lengths) * Hkv * hd * 2 * esz
        bytes_moved = 2 * q.numel() * esz + kv_bytes + table.numel() * 4
        flops = 4.0 * visible * H * hd
        rec["bound_ms"], rec["bound_by"] = bound(bytes_moved, flops, dname)
    return rec


def flash_attention_case(label, *, B, H, Hkv, Sq, Sk, hd, causal, dtype,
                         seed):
    import torch
    import torch.nn.functional as F
    from repro_torch.kernels.flash_attention import ops
    dev = "cuda"
    g = torch.Generator(device=dev).manual_seed(seed)
    q = torch.randn((B, Sq, H, hd), generator=g, device=dev).to(dtype)
    k = torch.randn((B, Sk, Hkv, hd), generator=g, device=dev).to(dtype)
    v = torch.randn((B, Sk, Hkv, hd), generator=g, device=dev).to(dtype)
    got = ops.flash_attention(q, k, v, causal=causal)
    ref = ops.flash_attention_plain(q, k, v, causal=causal)
    torch.cuda.synchronize()
    dname = str(dtype).split(".")[-1]
    err, tol = compare(f"flash_attention[{label}]", got, ref, dname)
    rec = {"case": label, "dtype": dname, "B": B, "H": H, "Hkv": Hkv,
           "Sq": Sq, "Sk": Sk, "hd": hd, "causal": causal,
           "max_abs_err": err, "tol": tol}
    qt, kt, vt = (t.transpose(1, 2) for t in (q, k, v))
    def kernel():
        return ops.flash_attention(q, k, v, causal=causal)
    rec["ms"] = device_ms(kernel, 10)
    rec["event_ms"] = cuda_ms(kernel, 10)
    rec["plain_ms"] = device_ms(
        lambda: ops.flash_attention_plain(q, k, v, causal=causal), 3, 1)
    rec["library_ms"] = device_ms(lambda: F.scaled_dot_product_attention(
        qt, kt, vt, is_causal=causal, enable_gqa=H != Hkv), 10)
    esz = q.element_size()
    # (query, key) pairs the mask keeps: the lower triangle when causal
    pairs = Sq * (Sq + 1) // 2 if causal else Sq * Sk
    bytes_moved = 2 * q.numel() * esz + 2 * k.numel() * esz
    flops = 4.0 * B * H * hd * pairs
    rec["bound_ms"], rec["bound_by"] = bound(bytes_moved, flops, dname)
    return rec


EP_DEGREE = 4


def ep_moe_config(cfg, policy="harmoeny", replica_slots=0):
    """The EP phase's model: ``cfg`` under the paper's synthetic skew (0.9
    of the routing mass on one expert) with q = 1, and ``replica_slots``
    hot-expert replica slots a rank."""
    import dataclasses
    return dataclasses.replace(cfg, moe=dataclasses.replace(
        cfg.moe, policy=policy, router_skew=0.9, router_skew_experts=1,
        q_tokens=1, num_replica_slots=replica_slots))


def ep_decode_dispatch(cfg, replica_slots=0):
    """One rank's grouped-buffer extents at the EP phase's decode step (4
    slots, EP degree 4, harmoeny, one skewed draw): the rank whose foreign
    groups carry the most rows.  With ``replica_slots`` R, the skew's hot
    expert (0, hosted by rank 0) sits in replica slot 0 of every other
    rank, as the rebalancer places it, and the rank whose replica groups
    carry the most rows is taken.  Returns (group sizes, M = c_total,
    local groups)."""
    import dataclasses
    import torch
    from repro_torch.core import dispatch as D
    from repro_torch.core.moe_layer import MoEBlockSpec
    from repro_torch.core.router import SkewKey, route_skewed
    from repro_torch.core.scheduler import schedule
    moe = ep_moe_config(cfg, replica_slots=replica_slots).moe
    spec = MoEBlockSpec(moe=moe, d_model=cfg.d_model, ep_degree=EP_DEGREE,
                        tokens_local=4, block_m=128)
    topo, K, R = spec.topo, moe.num_foreign_slots, replica_slots
    rep_ids = torch.full((EP_DEGREE, max(R, 1)), -1, dtype=torch.int32)
    rep_ids[1:, 0] = 0
    extra = D.replica_slot_map(rep_ids, topo.padded_experts) >= 0 if R \
        else None
    assigns = [route_skewed(
        SkewKey((0, 1, g)).generator("cpu"), spec.t_slice,
        top_k=moe.num_experts_per_tok, num_experts=moe.num_experts,
        padded_experts=topo.padded_experts, alpha=moe.router_skew).assign
        for g in range(EP_DEGREE)]
    counts = torch.stack([torch.bincount(a.reshape(-1).long(),
                                         minlength=topo.padded_experts)
                          for a in assigns]).to(torch.int32)
    S, _ = schedule(counts, topo, policy="harmoeny", q=spec.q,
                    c_pair=spec.c_pair, num_foreign_slots=K,
                    extra_local=extra)
    epr = topo.experts_per_rank
    best = None
    for g in range(EP_DEGREE):
        lay = D.build_layout(S, assigns[g], g, topo, c_pair=spec.c_pair,
                             c_total=spec.c_total, num_foreign_slots=K,
                             block_m=spec.block_m, num_replica_slots=R,
                             replica_ids_me=rep_ids[g] if R else None)
        sizes = [int(v) for v in lay.group_sizes]

        def carried(s):          # rows of the replica (else foreign) groups
            return sum(s[epr:epr + R] if R else s[epr:])
        if best is None or carried(sizes) > carried(best):
            best = sizes
    if carried(best) == 0:
        raise AssertionError(f"ep_decode: no rank's "
                             f"{'replica' if R else 'foreign'} groups hold "
                             f"rows")
    return best, spec.c_total, epr


def schedule_counts(G, E, units, hot, seed):
    """[G, Ep] int32 routing counts: each of G sources draws ``units``
    units over E experts, ``hot`` of the mass on one expert (a seeded
    choice), the padded experts empty; and the topology."""
    import numpy as np
    from repro_torch.core.topology import make_topology
    topo = make_topology(G, E)
    rng = np.random.default_rng(seed)
    p = np.full(E, (1.0 - hot) / max(E - 1, 1))
    p[rng.integers(E)] += hot
    counts = np.zeros((G, topo.padded_experts), np.int32)
    for g in range(G):
        counts[g, :E] = rng.multinomial(units, p / p.sum())
    return topo, counts


# (label, G, E, units a source, hot share, seed, q, c_pair, K, max_iters).
# The first three are the serve paths' decode schedules (timed); the rest
# reach every stop condition of the loop and its pair-capacity branch
# between them (found with the plain version, checked below).
def schedule_cases(cfg, switch_cfg):
    from repro_torch.core.moe_layer import MoEBlockSpec
    out = []
    for label, c, G, units, hot, q in (
            ("serve_g1", cfg, 1, 16, 0.0, None),
            ("serve_ep4_skew", cfg, EP_DEGREE, 4, 0.9, 1),
            ("switch_serve_g1", switch_cfg, 1, 4, 0.0, None)):
        spec = MoEBlockSpec(moe=c.moe, d_model=c.d_model, ep_degree=G,
                            tokens_local=4)
        out.append((label, G, c.moe.num_experts, units, hot, 1,
                    q or spec.q, spec.c_pair, c.moe.num_foreign_slots, 128))
    out += [
        ("stop_q", 4, 60, 62, 0.41, 468, 32, 16, 4, 128),
        ("none_allowed_pair", 8, 128, 153, 0.041, 269, 1, 8, 0, 128),
        ("none_allowed", 4, 60, 293, 0.472, 873, 8, 256, 0, 128),
        ("g_min_is_hot", 4, 128, 231, 0.593, 852, 32, 16, 1, 128),
        ("t_s", 8, 60, 234, 0.523, 526, 2, 8, 1, 128),
        ("stop_cap", 4, 128, 134, 0.773, 6, 8, 256, 1, 128),
        ("stop_cap_pair", 8, 128, 151, 0.729, 606, 8, 64, 1, 128),
        ("max_iters", 4, 128, 95, 0.876, 239, 1, 8, 4, 2),
        ("balanced_after_moves", 8, 60, 110, 0.677, 721, 1, 64, 4, 128),
    ]
    return out


def schedule_parity(cfg, switch_cfg):
    """Alg. 2's kernel against its plain version: S and the four
    diagnostics exactly equal on every case; the cases together reach
    every stop condition and the pair-capacity branch."""
    import torch
    from repro_torch.core.scheduler import initial_assign
    from repro_torch.core.topology import device_tables
    from repro_torch.kernels.schedule import ops
    recs, reached = [], set()
    for label, G, E, units, hot, seed, q, c_pair, K, mi in schedule_cases(
            cfg, switch_cfg):
        topo, counts = schedule_counts(G, E, units, hot, seed)
        S0 = initial_assign(torch.from_numpy(counts).cuda(), topo)
        is_local = device_tables(topo, "cuda").is_local
        kw = dict(q=q, c_pair=c_pair, num_foreign_slots=K, max_iters=mi)
        S, diag = ops.rebalance(S0, is_local, **kw)
        S_ref, diag_ref = ops.rebalance_plain(S0, is_local, **kw)
        torch.cuda.synchronize()
        err = max(int((S - S_ref).abs().max()),
                  int((diag - diag_ref).abs().max()))
        if err:
            raise AssertionError(f"schedule[{label}]: kernel S / diag "
                                 f"{diag.tolist()} != plain "
                                 f"{diag_ref.tolist()}")
        *_, stops, pair = ops._rebalance_np(
            S0.cpu().numpy(), is_local.cpu().numpy() != 0, **kw)
        reached.update(stops)
        reached.update(("pair_branch",) if pair else ())
        rec = {"case": label, "dtype": "int32", "G": G,
               "Ep": topo.padded_experts, "diag": diag.tolist(),
               "stops": list(stops), "pair_branch": pair,
               "max_abs_err": float(err)}
        if label.startswith(("serve", "switch")):
            rec["ms"] = device_ms(lambda: ops.rebalance(S0, is_local, **kw),
                                  20)
            rec["event_ms"] = cuda_ms(
                lambda: ops.rebalance(S0, is_local, **kw), 20)
            rec["plain_ms"] = device_ms(
                lambda: ops.rebalance_plain(S0, is_local, **kw), 5)
            rec["library_ms"] = None     # no PyTorch call computes Alg. 2
            # S read and written, is_local read, the diagnostics written;
            # integer operations: the sums over S and, per iteration, a
            # pass over an expert column and the pair matrix
            n = S0.numel()
            iters = int(diag[0])
            rec["bound_ms"], rec["bound_by"] = bound(
                8 * n + 4 * is_local.numel() + 16,
                2 * n + iters * (topo.padded_experts + G * G + 8 * G),
                "float32")
        recs.append(rec)
    want = set(ops.STOPS) | {"pair_branch"}
    if not want <= reached:
        raise AssertionError(f"schedule cases never reached "
                             f"{sorted(want - reached)}")
    return recs


def kernel_parity(cfg, flash_cfg, switch_cfg, *, max_seq_len, prefill_chunk,
                  block_size, flash_batch, flash_len):
    import numpy as np
    import torch
    from repro_torch.core.moe_layer import MoEBlockSpec
    from repro_torch.kernels.paged_attention.ops import largest_block_divisor
    from repro_torch.serve import engine_config_for
    out = {"moe_gmm": [], "paged_attention": [], "flash_attention": [],
           "schedule": schedule_parity(cfg, switch_cfg)}
    E, K = cfg.moe.num_experts, cfg.moe.num_foreign_slots
    d, f = cfg.d_model, cfg.moe.d_ff_expert
    bf = torch.bfloat16
    # decode at 4 slots: 4 tokens x top-4 = 16 units on 16 experts
    dec = [0] * (E + K)
    for e in range(0, 60, 4)[:15]:
        dec[e] = 1
    dec[2] = 1
    # prefill chunk of 32 tokens: 128 units spread over the experts, and
    # one foreign group carrying load (the fetched-weights path)
    pre = [(3 * e + 1) % 5 for e in range(E)] + [0] * K
    pre[E + 1] = 2
    pre[0] += 128 - sum(pre)
    skew = [0] * (E + K)
    skew[7] = 128                        # empty groups, all load on one
    # M is the dispatch buffer's c_total (MoEBlockSpec) at each shape
    for label, sizes, M in (("decode", dec, 8320), ("prefill", pre, 8448),
                            ("one_group", skew, 8448)):
        out["moe_gmm"].append(moe_gmm_case(
            label, sizes, M=M, n_local=E, d=d, f=f, block_m=128, dtype=bf,
            seed=1, time_it=True))
    # the whole-prompt prefill's dispatch: 4 x 1024 tokens x top-6 units
    # spread unevenly (a seeded multinomial) over the local experts, the
    # foreign groups empty as at one rank; M is that step's c_total
    moon_spec = MoEBlockSpec(moe=flash_cfg.moe, d_model=flash_cfg.d_model,
                             tokens_local=flash_batch * flash_len)
    rng = np.random.default_rng(8)
    E2 = flash_cfg.moe.num_experts
    whole = rng.multinomial(moon_spec.units_per_rank,
                            rng.dirichlet(np.full(E2, 4.0))).tolist()
    whole += [0] * flash_cfg.moe.num_foreign_slots
    out["moe_gmm"].append(moe_gmm_case(
        "whole_prompt", whole, M=moon_spec.c_total, n_local=E2,
        d=flash_cfg.d_model, f=flash_cfg.moe.d_ff_expert, block_m=128,
        dtype=bf, seed=8, time_it=True))
    sizes, M, n_local = ep_decode_dispatch(cfg)
    out["moe_gmm"].append(moe_gmm_case(
        "ep_decode", sizes, M=M, n_local=n_local, d=d, f=f, block_m=128,
        dtype=bf, seed=10, time_it=True))
    # the same dispatch with 2 replica slots a rank (phase 8): 15 local, 2
    # replica and 4 foreign groups, replica slot 0 holding the hot expert
    sizes, M, n_local = ep_decode_dispatch(cfg, replica_slots=2)
    out["moe_gmm"].append(moe_gmm_case(
        "ep_replica_decode", sizes, M=M, n_local=n_local, d=d, f=f,
        block_m=128, dtype=bf, seed=15, time_it=True, n_rep=2))
    out["moe_gmm"].append(moe_gmm_case(
        "f32_replica_small", [40, 0, 7, 128, 0, 3, 1, 0], M=640,
        n_local=4, d=256, f=192, block_m=64, dtype=torch.float32, seed=16,
        time_it=False, n_rep=2))
    # switch128's plain form (GELU experts, no gate) at its decode
    # dispatch (4 slots, top-1: 4 rows) and its prefill chunk's (32 rows),
    # each a seeded draw over the 128 experts; M is each step's c_total
    sw = switch_cfg
    Es = sw.moe.num_experts
    draw = np.random.default_rng(11)
    for label, tokens in (("switch_decode", 4),
                          ("switch_prefill_chunk", prefill_chunk)):
        spec = MoEBlockSpec(moe=sw.moe, d_model=sw.d_model,
                            tokens_local=tokens, block_m=128)
        units = draw.integers(0, Es, tokens * sw.moe.num_experts_per_tok)
        sizes = (np.bincount(units, minlength=Es).tolist()
                 + [0] * sw.moe.num_foreign_slots)
        out["moe_gmm"].append(moe_gmm_case(
            label, sizes, M=spec.c_total, n_local=Es, d=sw.d_model,
            f=sw.moe.d_ff_expert, block_m=128, dtype=bf, seed=12,
            time_it=True, gated=False))
    out["moe_gmm"].append(moe_gmm_case(
        "f32_small", [40, 0, 7, 128, 0, 3, 1, 0], M=640, n_local=6, d=256,
        f=192, block_m=64, dtype=torch.float32, seed=2, time_it=False))

    H, Hkv, hd = cfg.num_heads, cfg.num_kv_heads, cfg.resolved_head_dim
    s_pad = -(-max_seq_len // prefill_chunk) * prefill_chunk
    nb = -(-s_pad // block_size)
    out["paged_attention"].append(paged_attention_case(
        "decode", B=4, S=1, H=H, Hkv=Hkv, hd=hd, bs=block_size,
        lengths=[1, 77, 200, s_pad], n_blocks=nb, softcap=0.0, dtype=bf,
        seed=3, time_it=True))
    bs_slab = largest_block_divisor(s_pad)
    out["paged_attention"].append(paged_attention_case(
        "prefill_chunk", B=1, S=prefill_chunk, H=H, Hkv=Hkv, hd=hd,
        bs=bs_slab, lengths=[160 + prefill_chunk], n_blocks=s_pad // bs_slab,
        softcap=0.0, dtype=bf, seed=4, time_it=True, slab=True))
    # long chains, where the kernel is held to the HBM rate: 83.9 MB of K/V
    out["paged_attention"].append(paged_attention_case(
        "long_decode", B=4, S=1, H=H, Hkv=Hkv, hd=hd, bs=block_size,
        lengths=[1024, 2048, 3072, 4096], n_blocks=4096 // block_size,
        softcap=0.0, dtype=bf, seed=9, time_it=True))
    # switch128's 12 heads of 64 at the same serve shapes
    sw_heads = dict(H=sw.num_heads, Hkv=sw.num_kv_heads,
                    hd=sw.resolved_head_dim, softcap=0.0, dtype=bf,
                    time_it=True)
    out["paged_attention"].append(paged_attention_case(
        "switch_decode", B=4, S=1, bs=block_size, lengths=[1, 77, 200, s_pad],
        n_blocks=nb, seed=13, **sw_heads))
    out["paged_attention"].append(paged_attention_case(
        "switch_prefill_chunk", B=1, S=prefill_chunk, bs=bs_slab,
        lengths=[160 + prefill_chunk], n_blocks=s_pad // bs_slab, slab=True,
        seed=14, **sw_heads))
    # the CLI runs' shapes (phase 9), from their argv and the engine's
    # defaults: each run's decode over its chains (an idle slot at length
    # 1, the rest from prompt + 1 up to the pool's end), then the last
    # chunk of a prompt over the slab scratch, which both runs share
    for tag, argv in CLI_RUNS.items():
        prompt = _flag(argv, "--prompt-len")
        ecfg = engine_config_for(cfg, max_slots=_flag(argv, "--batch"),
                                 prompt_len=prompt,
                                 max_new_tokens=_flag(argv, "--gen"))
        B, L, C = ecfg.max_slots, ecfg.max_seq_len, ecfg.prefill_chunk
        s_cli = -(-L // C) * C
        lengths = [1] + [prompt + 1 + (L - prompt - 1) * i // (B - 2)
                         for i in range(B - 1)]
        out["paged_attention"].append(paged_attention_case(
            f"{tag.replace('-', '_')}_decode", B=B, S=1, H=H, Hkv=Hkv, hd=hd,
            bs=ecfg.kv_block_size, lengths=lengths,
            n_blocks=-(-s_cli // ecfg.kv_block_size), softcap=0.0, dtype=bf,
            seed=17, time_it=True))
    bs_cli = largest_block_divisor(s_cli)
    out["paged_attention"].append(paged_attention_case(
        "cli_prefill_chunk", B=1, S=C, H=H, Hkv=Hkv, hd=hd, bs=bs_cli,
        lengths=[-(-prompt // C) * C], n_blocks=s_cli // bs_cli, softcap=0.0,
        dtype=bf, seed=18, time_it=True, slab=True))
    out["paged_attention"].append(paged_attention_case(
        "f32_gqa_softcap", B=3, S=4, H=8, Hkv=2, hd=64, bs=5,
        lengths=[4, 23, 40], n_blocks=8, softcap=30.0, dtype=torch.float32,
        seed=5, time_it=False))
    # flash: the whole-prompt prefill's shape, then f32 GQA rep 4 at a
    # length that is no multiple of the 64-row tiles, causal and full
    out["flash_attention"].append(flash_attention_case(
        "prefill", B=flash_batch, H=flash_cfg.num_heads,
        Hkv=flash_cfg.num_kv_heads, Sq=flash_len, Sk=flash_len,
        hd=flash_cfg.resolved_head_dim, causal=True, dtype=bf, seed=6))
    for causal in (True, False):
        out["flash_attention"].append(flash_attention_case(
            f"f32_gqa_ragged_{'causal' if causal else 'full'}", B=2, H=8,
            Hkv=2, Sq=201, Sk=201, hd=128, causal=causal,
            dtype=torch.float32, seed=7))
    for name, recs in out.items():
        for r in recs:
            log(f"[parity] {name} {json.dumps(r)}")
    return out


# ----------------------------------------------------------------------
# phase 3/4: the main path
# ----------------------------------------------------------------------
def small_reference_check(arch: str = "qwen15-moe-a27b", *,
                          paged: bool = True, seed: int = 0) -> None:
    """``arch`` reduced, in f32, served on the slab or the paged pool: the
    card's greedy streams through the kernels equal the CPU's through the
    plain versions."""
    import torch
    from repro_torch.configs.registry import get_config
    from repro_torch.models.model import build_model
    from repro_torch.serve import Request, ServeEngine, VirtualClock, \
        engine_config_for
    cfg = get_config(arch).reduced()
    rng = torch.Generator().manual_seed(seed)
    reqs = [(int(torch.randint(5, 40, (1,), generator=rng)),) for _ in range(5)]
    prompts = [torch.randint(0, cfg.vocab_size, (n,), generator=rng).numpy()
               for (n,) in reqs]
    streams = {}
    for dev in ("cpu", "cuda"):
        model = build_model(cfg, batch=3, seq_len=40, device=dev)
        params = build_model(cfg, batch=3, seq_len=40, device="cpu").init(seed)
        params = _to(params, dev)
        ecfg = engine_config_for(cfg, max_slots=3, prompt_len=40,
                                 max_new_tokens=8, prefill_chunk=16,
                                 paged=paged, kv_block_size=8)
        eng = ServeEngine(model, params, ecfg, clock=VirtualClock(0.1),
                          device=dev)
        out = {}
        orig = eng._finish

        def capture(st, now, out=out, orig=orig):
            out[st.req.rid] = list(st.output)
            orig(st, now)
        eng._finish = capture
        eng.run([Request(rid=i, tokens=p, max_new_tokens=8)
                 for i, p in enumerate(prompts)])
        streams[dev] = out
    pool = "paged" if paged else "slab"
    if streams["cpu"] != streams["cuda"]:
        raise AssertionError(f"small reference ({arch}, {pool}): card "
                             f"streams {streams['cuda']} != cpu streams "
                             f"{streams['cpu']}")
    log(f"[reference] reduced {arch} f32 on the {pool} pool: {len(prompts)} "
        f"greedy streams on the card equal the CPU plain-version streams")


def _to(tree, dev, dtype=None):
    """The tensors of a parameter tree on ``dev``; floating ones cast to
    ``dtype`` when it is given."""
    if isinstance(tree, dict):
        return {k: _to(v, dev, dtype) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_to(v, dev, dtype) for v in tree]
    if dtype is not None and tree.is_floating_point():
        return tree.to(dev, dtype)
    return tree.to(dev)


def pattern_serve(cfg, params, tag, *, paged, slots, n_requests, prompt_lens,
                  new_tokens, max_seq_len, prefill_chunk, block_size, seed):
    """Serve ``n_requests`` on full-width ``cfg`` through ``ServeEngine`` on
    the slab or the paged pool; print the ``[tag]`` line and hold the
    gates: every request finishes with its budget, each kernel launched
    once per layer of its kind and step, and the dispatch the pool
    implies."""
    import numpy as np
    import torch
    from repro_torch.models.model import build_model
    from repro_torch.models.transformer import layer_pattern
    from repro_torch.serve import EngineConfig, Request, ServeEngine
    model = build_model(cfg, batch=slots, seq_len=max_seq_len)
    eng = ServeEngine(model, params, EngineConfig(
        max_slots=slots, max_seq_len=max_seq_len, prefill_chunk=prefill_chunk,
        paged=paged, kv_block_size=block_size))
    t0 = time.perf_counter()
    eng.warmup()
    warm_s = time.perf_counter() - t0
    rng = np.random.default_rng(seed)
    reqs = [Request(rid=i, tokens=rng.integers(
                0, cfg.vocab_size, (int(rng.integers(*prompt_lens)),)),
                max_new_tokens=new_tokens) for i in range(n_requests)]
    outputs = {}
    orig = eng._finish

    def capture(st, now):
        outputs[st.req.rid] = list(st.output)
        orig(st, now)
    eng._finish = capture
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    read = _reset_launches()
    t0 = time.perf_counter()
    rep = eng.run(reqs)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = read()
    pattern, n_steps, lead = layer_pattern(cfg)
    n_moe = n_steps * pattern.count("moe")
    steps = rep["decode_steps"] + rep["prefill_chunks"]
    expect = {"moe_gmm": n_moe * steps,
              "paged_attention": cfg.num_layers * (
                  rep["prefill_chunks"] + (rep["decode_steps"] if paged
                                           else 0)),
              "flash_attention": 0,
              "schedule": n_moe * steps * (cfg.moe.policy == "harmoeny")}
    summary = {
        "model": cfg.name, "pool": rep["state_pool"]["kind"],
        "requests": rep["n_requests"], "tokens_out": rep["total_new_tokens"],
        "prompt_tokens": int(sum(r.prompt_len for r in reqs)),
        "ttft_p50_s": rep["ttft"]["p50"], "ttft_p90_s": rep["ttft"]["p90"],
        "tpot_p50_s": rep["tpot"]["p50"], "tpot_p90_s": rep["tpot"]["p90"],
        "throughput_tok_s": rep["throughput_tok_s"], "wall_s": wall,
        "warmup_s": warm_s, "decode_steps": rep["decode_steps"],
        "prefill_chunks": rep["prefill_chunks"],
        "preemptions": rep["preemptions"],
        "peak_mem_gib": torch.cuda.max_memory_allocated() / 2**30,
        "moe_layers": n_moe, "attention_layers": cfg.num_layers,
        "launches": launches,
        "attention_dispatch": rep["attention_dispatch"],
        "jit_entries": rep["jit_entries"],
        "recompiled_after_warmup": rep["recompiled_after_warmup"],
    }
    log(f"[{tag}] {json.dumps(summary)}")
    # --- checks -------------------------------------------------------
    check_one_capture(tag, rep)
    if rep["n_requests"] != n_requests or len(outputs) != n_requests:
        raise AssertionError(f"[{tag}] only {rep['n_requests']} of "
                             f"{n_requests} requests finished")
    for rid, toks in outputs.items():
        if len(toks) != new_tokens or not all(0 <= t < cfg.vocab_size
                                              for t in toks):
            raise AssertionError(f"[{tag}] request {rid}: bad stream {toks}")
    if launches != expect:
        raise AssertionError(f"[{tag}] launches {launches} != {expect} "
                             f"({n_moe} MoE and {cfg.num_layers} attention "
                             f"layers a step, {steps} steps)")
    dispatch = {b: {"fused": d["fused"]}
                for b, d in rep["attention_dispatch"].items()}
    want = {"prefill_continue": {"fused": True},
            ("decode" if paged else "decode_slab"): {"fused": paged}}
    if dispatch != want:
        raise AssertionError(f"[{tag}] attention dispatch {dispatch} != "
                             f"{want}")
    cache = model.init_cache(1, prefill_chunk)
    toks = torch.as_tensor(reqs[0].tokens[:prefill_chunk][None],
                           device="cuda")
    logits, _, _, _ = model.prefill_chunk(params, toks, cache, 0)
    if tuple(logits.shape) != (1, cfg.padded_vocab) \
            or not torch.isfinite(logits[:, :cfg.vocab_size]).all():
        raise AssertionError(f"[{tag}] bad logits {tuple(logits.shape)}")
    return summary


def main_path(cfg, *, n_requests, max_seq_len, prefill_chunk, block_size,
              slots, new_tokens, seed):
    """Phase 3: full-width ``cfg`` on random weights, served on the paged
    pool (the ``[main]`` line, with ``pattern_serve``'s gates); returns
    the summary and the weights."""
    import torch
    from repro_torch.models.model import build_model
    t0 = time.perf_counter()
    params = build_model(cfg, batch=slots, seq_len=max_seq_len).init(seed)
    torch.cuda.synchronize()
    n_params = sum(t.numel() for t in _leaves(params))
    log(f"[main] {cfg.name}: {n_params / 1e9:.2f} B parameters drawn on the "
        f"card in {time.perf_counter() - t0:.1f} s "
        f"({torch.cuda.memory_allocated() / 2**30:.1f} GiB)")
    summary = pattern_serve(cfg, params, "main", paged=True, slots=slots,
                            n_requests=n_requests, prompt_lens=(64, 257),
                            new_tokens=new_tokens, max_seq_len=max_seq_len,
                            prefill_chunk=prefill_chunk,
                            block_size=block_size, seed=seed)
    return summary, params


# ----------------------------------------------------------------------
# phase 7: the eager decode step against the captured one
# ----------------------------------------------------------------------
def capture_compare(cfg, params, tag, *, paged, n_requests, prompt_lens,
                    new_tokens, max_seq_len, prefill_chunk, block_size,
                    seed, ep_degree=1, policy=None, window=3,
                    traced=1, dense_inline=False):
    """The same requests served twice on one set of weights, once with
    every entry eager (``stepcore.eager()``) and once captured; then one
    prefill chunk of a long prompt under ``torch.profiler`` and its next
    ``window`` without (an eager chunk's trace at G = 4 holds ~35 k
    kernels, whose processing is the phase's longest part), and, with
    every slot decoding, ``traced`` decode steps under the profiler and
    ``window`` without.  With
    ``dense_inline`` a third engine, captured, whose ``VirtualGroup``
    fetches in the dense form on the compute stream (the port's fetch
    before the gather and the side stream), runs the long prompt's chunks
    and the decode window only, which must give the captured run's
    tokens.  Prints the ``[capture]`` line.  Gates: greedy
    streams equal token for token (or, where a bf16 stream differs, the
    logits at the first differing step within 2e-2 of the largest logit),
    fewer host launches a captured chunk and step than eager ones, at
    most 2 a captured chunk without skew, one capture of each entry."""
    import contextlib
    import numpy as np
    import torch
    from repro_torch.models.model import build_model
    from repro_torch.profiling import profile_steps, untraced_ms
    from repro_torch.serve import EngineConfig, Request, ServeEngine, stepcore
    slots = 4
    model = build_model(cfg, batch=slots, seq_len=max_seq_len,
                        ep_degree=ep_degree)
    ecfg = EngineConfig(max_slots=slots, max_seq_len=max_seq_len,
                        prefill_chunk=prefill_chunk, paged=paged,
                        kv_block_size=block_size, moe_policy=policy,
                        skew_seed=seed)
    rng = np.random.default_rng(seed + 7)
    prompts = [rng.integers(0, cfg.vocab_size,
                            (int(rng.integers(*prompt_lens)),))
               for _ in range(n_requests)]
    budget = 4 * window + 16
    # the prefill window's prompt: 1 + window whole chunks and a partial one
    long_prompt = rng.integers(0, cfg.vocab_size, (min(
        (window + 1) * prefill_chunk + prefill_chunk // 2,
        max_seq_len - budget),))
    fill = [rng.integers(0, cfg.vocab_size, (prefill_chunk,))
            for _ in range(slots - 1)]
    runs = {}
    modes = ("eager", "captured") + (("dense_inline",) if dense_inline
                                      else ())
    mode_s = {}
    for mode in modes:
        t_mode = time.perf_counter()
        ctx = stepcore.eager() if mode == "eager" \
            else contextlib.nullcontext()
        with ctx:
            m = model
            if mode == "dense_inline":
                m = build_model(cfg, batch=slots, seq_len=max_seq_len,
                                ep_degree=ep_degree,
                                comm=DenseInlineGroup(ep_degree))
            eng = ServeEngine(m, params, ecfg)
            eng.warmup()
            core = eng.core
            steps, outputs, record = [], {}, [True]
            decode, finish = core.decode, eng._finish

            def traced_decode(*args, **kwargs):
                nxt, packed = decode(*args, **kwargs)
                if record[0]:
                    steps.append((nxt.copy(), eng.active.copy(),
                                  core.logits[:, :cfg.vocab_size].clone()))
                return nxt, packed

            def capture(st, now):
                outputs[st.req.rid] = list(st.output)
                finish(st, now)
            core.decode, eng._finish = traced_decode, capture
            rep = None
            if mode != "dense_inline":
                rep = eng.run([Request(rid=i, tokens=p,
                                       max_new_tokens=new_tokens)
                               for i, p in enumerate(prompts)])
                served_at = (eng._step_idx, eng._chunk_idx,
                             list(eng.front.free_slots))
            else:
                # the window's calls draw their skew on the same call
                # indices, and its requests take the same slots (skewed
                # routing goes by batch row), as the captured run's window
                eng._step_idx, eng._chunk_idx, free = served_at
                eng.front.free_slots.clear()
                eng.front.free_slots.extend(free)
            record[0] = False
            # prefill chunks of one long prompt, alone on the card
            eng.submit(Request(rid=999, tokens=long_prompt,
                               max_new_tokens=budget))
            eng._admit(eng.clock.now())

            def chunk():
                eng._prefill_work(eng.clock.now())
            pf_prof = profile_steps(chunk, 1, f"{tag}_{mode}_prefill")
            pf_wall = untraced_ms(chunk, window)
            for i, p in enumerate(fill):
                eng.submit(Request(rid=1000 + i, tokens=p,
                                   max_new_tokens=budget))
            while not eng.active.all():
                eng.step()

            def step():
                eng._decode_work(eng.clock.now())
            prof = profile_steps(step, traced, f"{tag}_{mode}")
            wall = untraced_ms(step, window)
            runs[mode] = {
                "rep": rep, "outputs": outputs, "steps": steps,
                "prof": prof, "wall_ms": wall, "pf_prof": pf_prof,
                "pf_wall_ms": pf_wall,
                "jit_after_window": eng.report()["jit_entries"],
                "predraw_ms": core.predraw_ms("decode"),
                "pf_predraw_ms": core.predraw_ms("prefill_chunk"),
                "window_tokens": {st.req.rid: list(st.output)
                                  for st in eng.front.state_by_slot
                                  if st is not None}}
            del eng, core, m
        gc.collect()
        torch.cuda.empty_cache()
        mode_s[mode] = time.perf_counter() - t_mode
    if dense_inline:
        d = runs.pop("dense_inline")
        if d["window_tokens"] != runs["captured"]["window_tokens"]:
            raise AssertionError(
                f"[capture] {tag}: the dense inline fetch's tokens "
                f"{d['window_tokens']} != the gather's "
                f"{runs['captured']['window_tokens']}")
        if d["jit_after_window"] != jit_entries(paged, 1):
            raise AssertionError(f"[capture] {tag}: dense inline captures "
                                 f"{d['jit_after_window']}")
    e, c = runs["eager"], runs["captured"]
    first = None
    if e["outputs"] != c["outputs"]:
        for i, ((te, ae, le), (tc, ac, lc)) in enumerate(
                zip(e["steps"], c["steps"])):
            if (ae != ac).any() or (te[ae] != tc[ac]).any():
                rows = torch.as_tensor(ae, device=le.device)
                gap = float((le[rows] - lc[rows]).abs().max()
                            / le[rows].abs().max())
                first = {"step": i, "logits_gap_rel": gap}
                break
    line = {"config": tag, "dtype": cfg.dtype, "ep_degree": ep_degree,
            "pool": "paged" if paged else "slab",
            "policy": policy or cfg.moe.policy,
            "requests": n_requests, "decode_steps": c["rep"]["decode_steps"],
            "streams_equal": e["outputs"] == c["outputs"],
            "first_difference": first, "seconds": mode_s}
    for mode, r in runs.items():
        p, pf = r["prof"], r["pf_prof"]
        line[mode] = {
            "tpot_p50_s": r["rep"]["tpot"]["p50"],
            "ttft_p50_s": r["rep"]["ttft"]["p50"],
            "prefill_chunk": {
                "prompt_tokens": len(long_prompt),
                "wall_ms": r["pf_wall_ms"],
                "traced_wall_ms": pf["wall_ms_per_step"],
                "device_busy_ms": pf["device_busy_ms_per_step"],
                "device_idle_share": pf["device_idle_share"],
                "device_idle_share_untraced":
                    1.0 - pf["device_busy_ms_per_step"] / r["pf_wall_ms"],
                "kernel_calls": pf["kernel_calls_per_step"],
                "host_launches": pf["host_launches_per_step"]
                + pf["graph_launches_per_step"],
                "graph_launches": pf["graph_launches_per_step"],
                "copies_and_syncs":
                    pf["host_device_syncs_and_copies_per_step"],
                "skew_predraw_host_ms": r["pf_predraw_ms"],
                "streams": pf["streams"],
                "top_kernels_ms": pf["top_kernels_ms_per_step"][:4]},
            "wall_ms_per_decode_step": r["wall_ms"],
            "traced_wall_ms_per_decode_step": p["wall_ms_per_step"],
            "device_busy_ms_per_step": p["device_busy_ms_per_step"],
            "device_idle_share": p["device_idle_share"],
            "kernel_calls_per_step": p["kernel_calls_per_step"],
            "host_launches_per_step": p["host_launches_per_step"]
            + p["graph_launches_per_step"],
            "graph_launches_per_step": p["graph_launches_per_step"],
            "copies_and_syncs_per_step":
                p["host_device_syncs_and_copies_per_step"],
            "skew_predraw_host_ms_per_step": r["predraw_ms"],
            "streams": p["streams"],
            "top_kernels_ms_per_step": p["top_kernels_ms_per_step"][:6],
        }
    if dense_inline:
        line["dense_inline"] = {
            "tokens_equal_captured": True,
            "prefill_chunk": {"wall_ms": d["pf_wall_ms"],
                              "device_busy_ms":
                                  d["pf_prof"]["device_busy_ms_per_step"],
                              "streams": d["pf_prof"]["streams"]},
            "wall_ms_per_decode_step": d["wall_ms"],
            "device_busy_ms_per_step": d["prof"]["device_busy_ms_per_step"],
            "streams": d["prof"]["streams"]}
    log(f"[capture] {json.dumps(line)}")
    check_one_capture(f"capture {tag}", c["rep"])
    if c["jit_after_window"] != jit_entries(paged, 1) \
            or e["rep"]["jit_entries"] != jit_entries(paged, 0) \
            or e["jit_after_window"] != jit_entries(paged, 0):
        raise AssertionError(
            f"[capture] {tag}: captures {e['rep']['jit_entries']} (eager), "
            f"{c['jit_after_window']} (captured, after the window)")
    if first is not None:
        log(f"[capture] {tag}: streams differ first at decode step "
            f"{first['step']}, logits gap {first['logits_gap_rel']:.3e} of "
            f"the largest logit")
        if cfg.dtype == "float32" or first["logits_gap_rel"] > 2e-2:
            raise AssertionError(f"[capture] {tag}: captured stream differs "
                                 f"from the eager one: {first}")
    elif e["outputs"] != c["outputs"]:
        raise AssertionError(f"[capture] {tag}: streams differ, steps "
                             f"agree: {e['outputs']} != {c['outputs']}")
    if not (line["captured"]["host_launches_per_step"]
            < line["eager"]["host_launches_per_step"]):
        raise AssertionError(f"[capture] {tag}: captured host launches a "
                             f"step {line['captured']} not below eager "
                             f"{line['eager']}")
    pf_e, pf_c = (line[m]["prefill_chunk"] for m in ("eager", "captured"))
    if not pf_c["host_launches"] < pf_e["host_launches"]:
        raise AssertionError(f"[capture] {tag}: captured host launches a "
                             f"prefill chunk {pf_c} not below eager {pf_e}")
    skew = cfg.moe.router_skew > 0
    if not skew and pf_c["host_launches"] > 2:
        raise AssertionError(f"[capture] {tag}: a captured prefill chunk "
                             f"made {pf_c['host_launches']} host launches, "
                             f"more than its graph and the write's")
    return line


def jit_entries(paged, n):
    """The engine's ``jit_entries`` with each of its three entries at n."""
    write = "write_blocks" if paged else "write_slot"
    return {"prefill_chunk": n, "decode": n, write: n}


def check_one_capture(tag, rep):
    """The engine captured its prefill chunk, its decode step and the
    store's write once each, at warmup, and replayed them for the whole
    run (the JAX engine's ``jit_entries`` contract)."""
    want = jit_entries(rep["engine"]["paged"], 1)
    if rep["jit_entries"] != want \
            or rep.get("recompiled_after_warmup") is not False:
        raise AssertionError(f"[{tag}] jit_entries {rep['jit_entries']}, "
                             f"recompiled_after_warmup "
                             f"{rep.get('recompiled_after_warmup')}: want "
                             f"{want}, each entry captured once")


def _leaves(tree):
    if isinstance(tree, dict):
        for v in tree.values():
            yield from _leaves(v)
    elif isinstance(tree, list):
        for v in tree:
            yield from _leaves(v)
    else:
        yield tree


def _reset_launches():
    """Every kernel's launch count (and ``moe_gmm``'s foreign rows) set to
    0; returns the reader of the counts."""
    from repro_torch.kernels.moe_gmm import ops as gmm_ops
    from repro_torch.serve.stepcore import kernel_wrappers
    fns = dict(zip(REPLACES, kernel_wrappers()))
    for fn in fns.values():
        fn.launches = 0
    gmm_ops.reset_foreign_rows()
    return lambda: {name: fn.launches for name, fn in fns.items()}


def _foreign_rows() -> int:
    """Foreign-group rows through ``moe_gmm`` since ``_reset_launches``."""
    from repro_torch.kernels.moe_gmm import ops as gmm_ops
    return gmm_ops.foreign_rows_total()


# ----------------------------------------------------------------------
# phase 4b: HarMoEny across expert-parallel ranks
# ----------------------------------------------------------------------
def ep_serve(cfg, params, policy, *, slots, n_requests, max_seq_len,
             prefill_chunk, block_size, new_tokens, seed):
    """Serve ``n_requests`` on ``cfg`` at EP degree 4 under ``policy``;
    returns the ``[ep]`` summary (and its gates' inputs)."""
    import numpy as np
    import torch
    from repro_torch.models.model import build_model
    from repro_torch.serve import EngineConfig, Request, ServeEngine
    ep_cfg = ep_moe_config(cfg, policy)
    model = build_model(ep_cfg, batch=slots, seq_len=max_seq_len,
                        ep_degree=EP_DEGREE)
    ecfg = EngineConfig(max_slots=slots, max_seq_len=max_seq_len,
                        prefill_chunk=prefill_chunk, paged=True,
                        kv_block_size=block_size, moe_policy=policy,
                        skew_seed=seed)
    eng = ServeEngine(model, params, ecfg)
    eng.warmup()
    rng = np.random.default_rng(seed)
    reqs = [Request(rid=i, tokens=rng.integers(
                0, cfg.vocab_size, (int(rng.integers(64, 129)),)),
                max_new_tokens=new_tokens) for i in range(n_requests)]
    outputs = {}
    orig = eng._finish

    def capture(st, now):
        outputs[st.req.rid] = list(st.output)
        orig(st, now)
    eng._finish = capture
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    read = _reset_launches()
    t0 = time.perf_counter()
    rep = eng.run(reqs)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = read()
    lb = rep["load_balance"]
    summary = {
        "policy": policy, "ep_degree": EP_DEGREE,
        "requests": rep["n_requests"], "tokens_out": rep["total_new_tokens"],
        "prompt_tokens": int(sum(r.prompt_len for r in reqs)),
        "ttft_p50_s": rep["ttft"]["p50"], "tpot_p50_s": rep["tpot"]["p50"],
        "throughput_tok_s": rep["throughput_tok_s"], "wall_s": wall,
        "decode_steps": rep["decode_steps"],
        "prefill_chunks": rep["prefill_chunks"],
        "peak_mem_gib": torch.cuda.max_memory_allocated() / 2**30,
        "moved_units_per_layer_decode": rep["moe"]["decode/moved_units"],
        "moved_units_per_layer_prefill": rep["moe"]["prefill/moved_units"],
        "decode_max_mean_ratio": lb["decode"]["max_mean_ratio"],
        "decode_straggler_wait_units": lb["decode"]["straggler_wait_units"],
        "prefill_max_mean_ratio": lb["prefill"]["max_mean_ratio"],
        "prefill_straggler_wait_units": lb["prefill"]["straggler_wait_units"],
        "decode_rank_load_mean": lb["decode"]["rank_load_mean"],
        "drops": {ph: [lb[ph]["send_drops_total"], lb[ph]["dest_drops_total"]]
                  for ph in ("decode", "prefill")},
        "launches": launches, "moe_gmm_foreign_rows": _foreign_rows(),
        "jit_entries": rep["jit_entries"],
    }
    # --- checks of what comes out --------------------------------------
    check_one_capture(f"ep {policy}", rep)
    if rep["n_requests"] != n_requests or len(outputs) != n_requests:
        raise AssertionError(f"[ep] {policy}: only {rep['n_requests']} of "
                             f"{n_requests} requests finished")
    for rid, toks in outputs.items():
        if len(toks) != new_tokens or not all(0 <= t < cfg.vocab_size
                                              for t in toks):
            raise AssertionError(f"[ep] {policy}: request {rid}: bad stream "
                                 f"{toks}")
    cache = model.init_cache(1, prefill_chunk)
    toks = torch.as_tensor(reqs[0].tokens[:prefill_chunk][None],
                           device="cuda")
    logits, _, _, _ = model.prefill_chunk(
        params, toks, cache, 0, skew_key=eng.core.next_key(eng.core.pf_key, 0))
    if tuple(logits.shape) != (1, cfg.padded_vocab) \
            or not torch.isfinite(logits[:, :cfg.vocab_size]).all():
        raise AssertionError(f"[ep] {policy}: bad logits "
                             f"{tuple(logits.shape)}")
    return summary


def ep_path(cfg, *, seed, **shape):
    """Phase 4b: harmoeny and round_robin on the same random weights, each
    ``[ep]`` line printed, and the gates held."""
    from repro_torch.models.model import build_model
    t0 = time.perf_counter()
    # with phase 8's replica leaves (zeros): the models without replica
    # slots do not read them
    params = build_model(ep_moe_config(cfg, replica_slots=PLACEMENT_REPLICAS),
                         batch=shape["slots"], seq_len=shape["max_seq_len"],
                         ep_degree=EP_DEGREE).init(seed)
    n_params = sum(t.numel() for t in _leaves(params))
    log(f"[ep] {cfg.name} at EP degree {EP_DEGREE} on virtual ranks: "
        f"{n_params / 1e9:.2f} B parameters drawn in "
        f"{time.perf_counter() - t0:.1f} s")
    out = {}
    for policy in ("harmoeny", "round_robin"):
        out[policy] = ep_serve(cfg, params, policy, seed=seed, **shape)
        log(f"[ep] {json.dumps(out[policy])}")
    h, rr = out["harmoeny"], out["round_robin"]
    for name, rec in out.items():
        for kernel in ("moe_gmm", "paged_attention"):
            if rec["launches"][kernel] <= 0:
                raise AssertionError(f"[ep] {name}: {kernel} was not "
                                     f"launched")
    # Alg. 2 on the card: once per MoE layer, rank and step under
    # harmoeny, never under round_robin
    n_moe = cfg.num_layers
    steps = h["decode_steps"] + h["prefill_chunks"]
    want = {"harmoeny": EP_DEGREE * n_moe * steps, "round_robin": 0}
    for name, rec in out.items():
        if rec["launches"]["schedule"] != want[name]:
            raise AssertionError(f"[ep] {name}: schedule launched "
                                 f"{rec['launches']['schedule']} times, "
                                 f"not {want[name]}")
    if any(v != 0 for ph in h["drops"].values() for v in ph):
        raise AssertionError(f"[ep] harmoeny dropped units: {h['drops']}")
    if h["moved_units_per_layer_decode"] <= 0:
        raise AssertionError("[ep] harmoeny moved no unit at decode")
    if h["moe_gmm_foreign_rows"] <= 0:
        raise AssertionError("[ep] no foreign-group row went through moe_gmm "
                             "under harmoeny")
    if not h["decode_max_mean_ratio"] < rr["decode_max_mean_ratio"]:
        raise AssertionError(
            f"[ep] harmoeny's decode max/mean rank load "
            f"{h['decode_max_mean_ratio']:.3f} is not below round_robin's "
            f"{rr['decode_max_mean_ratio']:.3f}")
    log(f"[ep] gates held: harmoeny decode max/mean "
        f"{h['decode_max_mean_ratio']:.3f} < round_robin "
        f"{rr['decode_max_mean_ratio']:.3f}; harmoeny drops 0, moved "
        f"{h['moved_units_per_layer_decode']:.3f} units per layer and decode "
        f"step, {h['moe_gmm_foreign_rows']} foreign rows through moe_gmm")
    # phase 7 on these weights: 2 requests of 32-64 tokens a policy
    caps = [capture_compare(ep_moe_config(cfg, policy), params,
                            f"qwen_ep{EP_DEGREE}_{policy}", paged=True,
                            n_requests=2, prompt_lens=(32, 65),
                            new_tokens=shape["new_tokens"],
                            max_seq_len=shape["max_seq_len"],
                            prefill_chunk=shape["prefill_chunk"],
                            block_size=shape["block_size"], seed=seed,
                            ep_degree=EP_DEGREE, policy=policy,
                            dense_inline=policy == "harmoeny")
            for policy in ("harmoeny", "round_robin")]
    return out, caps, params


# ----------------------------------------------------------------------
# phase 8: serving-time expert placement (replica slots, tiered residency)
# ----------------------------------------------------------------------
PCIE_BYTES_S = 64e9          # PCIe Gen5 x16, one direction (data sheet)
PLACEMENT_REPLICAS, PLACEMENT_INTERVAL, PLACEMENT_RESIDENT = 2, 4, 32


def placement_serve(cfg, params, tag, *, ekw, replica_slots, slots,
                    n_requests, new_tokens, max_seq_len, prefill_chunk,
                    block_size, seed, window=3):
    """Serve ``n_requests`` on full-width ``cfg`` at EP degree 4 under
    harmoeny with skew 0.9 and the placement fields ``ekw``; then, with
    every slot decoding, one decode step traced (a G = 4 step's trace
    holds ~35 k kernels) and ``window`` untraced.  Returns the
    ``[placement]`` summary and the streams."""
    import numpy as np
    import torch
    from repro_torch.models.model import build_model
    from repro_torch.profiling import profile_steps, untraced_ms
    from repro_torch.serve import EngineConfig, Request, ServeEngine
    ep_cfg = ep_moe_config(cfg, replica_slots=replica_slots)
    model = build_model(ep_cfg, batch=slots, seq_len=max_seq_len,
                        ep_degree=EP_DEGREE)
    ecfg = EngineConfig(max_slots=slots, max_seq_len=max_seq_len,
                        prefill_chunk=prefill_chunk, paged=True,
                        kv_block_size=block_size, moe_policy="harmoeny",
                        skew_seed=seed, **ekw)
    t0 = time.perf_counter()
    eng = ServeEngine(model, params, ecfg)
    build_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    eng.warmup()
    warm_s = time.perf_counter() - t0
    rng = np.random.default_rng(seed + 8)
    reqs = [Request(rid=i, tokens=rng.integers(
                0, cfg.vocab_size, (int(rng.integers(64, 129)),)),
                max_new_tokens=new_tokens) for i in range(n_requests)]
    outputs = {}
    finish = eng._finish

    def capture(st, now):
        outputs[st.req.rid] = list(st.output)
        finish(st, now)
    eng._finish = capture
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    read = _reset_launches()
    t0 = time.perf_counter()
    rep = eng.run(reqs)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches, foreign = read(), _foreign_rows()
    stages = eng.stage_times()
    swap_ms = None
    if eng._rebalancer is not None:
        # one more replay of the captured swap, on the last swap's rows
        # (the replica leaves get the values they hold)
        swap_ms = device_ms(lambda: eng._swap.entry(eng._swap.pairs), 3, 1)
    # the captured decode step with every slot decoding, mechanism on
    fill = [rng.integers(0, cfg.vocab_size, (prefill_chunk,))
            for _ in range(slots)]
    for i, p in enumerate(fill):
        eng.submit(Request(rid=1000 + i, tokens=p,
                           max_new_tokens=4 * window + 4))
    while not eng.active.all():
        eng.step()
    n_stages = len(eng.stage_log)

    def step():
        eng._decode_work(eng.clock.now())
    prof = profile_steps(step, 1, f"placement_{tag}")
    dec_wall = untraced_ms(step, window)
    window_stages = len(eng.stage_log) - n_stages
    rep_after = eng.report()
    lb = rep["load_balance"]["decode"]
    engine = rep["engine"]
    summary = {
        "config": tag, "ep_degree": EP_DEGREE, "fields": ekw,
        "requests": rep["n_requests"], "tokens_out": rep["total_new_tokens"],
        "ttft_p50_s": rep["ttft"]["p50"], "tpot_p50_s": rep["tpot"]["p50"],
        "wall_s": wall, "engine_build_s": build_s, "warmup_s": warm_s,
        "decode_steps": rep["decode_steps"],
        "prefill_chunks": rep["prefill_chunks"],
        "peak_mem_gib": torch.cuda.max_memory_allocated() / 2**30,
        "decode_max_mean_ratio": lb["max_mean_ratio"],
        "decode_moved_units": rep["moe"]["decode/moved_units"],
        "decode_drops": [lb["send_drops_total"], lb["dest_drops_total"]],
        "launches": launches, "moe_gmm_foreign_rows": foreign,
        "jit_entries": rep["jit_entries"],
        "recompiled_after_warmup": rep.get("recompiled_after_warmup"),
        "decode_step": {
            "wall_ms": dec_wall, "traced_wall_ms": prof["wall_ms_per_step"],
            "device_busy_ms": prof["device_busy_ms_per_step"],
            # of the traced step itself: a stage's rows differ step to step
            "device_idle_share": prof["device_idle_share"],
            "host_launches": prof["host_launches_per_step"]
            + prof["graph_launches_per_step"],
            "copies_and_syncs":
                prof["host_device_syncs_and_copies_per_step"],
            "stages_in_window": window_stages},
    }
    if eng._rebalancer is not None:
        summary["replicas"] = {
            "replica_swaps": engine["replica_swaps"],
            "rebalances": engine["rebalances"],
            "hot_experts": engine["hot_experts"],
            "replica_ids": engine["replica_ids"],
            "swap_rows": eng._replica_ids.size,
            "swap_bytes": sum(w.numel() * w.element_size()
                              for _, w in eng._swap.pairs),
            "swap_ms": swap_ms}
        # the gather reads and writes every replica leaf once
        summary["replicas"]["swap_bound_ms"] = (
            2 * summary["replicas"]["swap_bytes"] / HBM_BYTES_S * 1e3)
    if eng._residency is not None:
        tier = eng._host_tier
        staged = [dict(s, gb_s=s["bytes"] / s["ms"] / 1e6,
                       bound_ms=s["bytes"] / PCIE_BYTES_S * 1e3)
                  for s in stages]
        summary["residency"] = {
            "counters": rep["residency"],
            "residency_stages": engine["residency_stages"],
            "residency_ids": engine["residency_ids"],
            "host_tier_gb": tier.nbytes / 1e9, "row_mb": tier.row_bytes / 1e6,
            "pin_s": tier.pin_s, "fill_s": tier.fill_s,
            "stages": staged,
            "stage_ms_per_row": (sum(s["ms"] for s in staged)
                                 / max(sum(s["rows"] for s in staged), 1)),
            "stage_gb_s": (sum(s["bytes"] for s in staged)
                           / max(sum(s["ms"] for s in staged), 1e-9) / 1e6),
            "bound_ms_per_row": tier.row_bytes / PCIE_BYTES_S * 1e3,
            "modeled_pcie_gb_s": eng._residency.cost.pcie_bw / 1e9}
    # --- checks of what comes out --------------------------------------
    want = jit_entries(True, 1)
    if eng._rebalancer is not None:
        want["replica_swap"] = 1
    if eng._residency is not None:
        want["residency_stage"] = 0
    for r in (rep, rep_after):
        if r["jit_entries"] != want \
                or r.get("recompiled_after_warmup") is not False:
            raise AssertionError(f"[placement] {tag}: jit_entries "
                                 f"{r['jit_entries']}, recompiled "
                                 f"{r.get('recompiled_after_warmup')}: want "
                                 f"{want}")
    if rep["n_requests"] != n_requests or any(
            len(t) != new_tokens or not all(0 <= v < cfg.vocab_size
                                            for v in t)
            for t in outputs.values()):
        raise AssertionError(f"[placement] {tag}: bad streams {outputs}")
    if launches["moe_gmm"] <= 0 or launches["schedule"] != (
            EP_DEGREE * cfg.num_layers
            * (rep["decode_steps"] + rep["prefill_chunks"])):
        raise AssertionError(f"[placement] {tag}: launches {launches}")
    if not torch.isfinite(eng.core.logits[:, :cfg.vocab_size]).all():
        raise AssertionError(f"[placement] {tag}: non-finite logits")
    eng.close()
    del eng
    gc.collect()
    torch.cuda.empty_cache()
    return summary, outputs


def placement_path(cfg, params, *, seed, slots, max_seq_len, prefill_chunk,
                   block_size, n_requests=3, new_tokens=12, **_):
    """Phase 8 on phase 4b's weights (which carry the replica leaves):
    harmoeny without either mechanism; with hot-expert replica slots; with
    tiered residency under each prefetch policy.  Prints a
    ``[placement]`` line each; gates: streams equal the run without the
    mechanism, one capture of each entry and of the swap, a swap and a
    stage happened, drops 0."""
    import torch
    shape = dict(slots=slots, n_requests=n_requests, new_tokens=new_tokens,
                 max_seq_len=max_seq_len, prefill_chunk=prefill_chunk,
                 block_size=block_size, seed=seed)
    runs = {"base": ({}, 0),
            "replicas": (dict(replica_slots=PLACEMENT_REPLICAS,
                              rebalance_interval=PLACEMENT_INTERVAL),
                         PLACEMENT_REPLICAS)}
    for policy in ("predictive", "on_demand", "none"):
        runs[f"residency_{policy}"] = (dict(
            resident_experts=PLACEMENT_RESIDENT, prefetch_policy=policy), 0)
    out, streams = {}, {}
    for tag, (ekw, R) in runs.items():
        out[tag], streams[tag] = placement_serve(
            cfg, params, tag, ekw=ekw, replica_slots=R, **shape)
        log(f"[placement] {json.dumps(out[tag])}")
        # the pinned host tier goes back to the system between runs
        torch._C._host_emptyCache()
    for tag, rec in out.items():
        if streams[tag] != streams["base"]:
            raise AssertionError(f"[placement] {tag}: streams differ from "
                                 f"the run without the mechanism")
        if any(rec["decode_drops"]):
            raise AssertionError(f"[placement] {tag}: drops "
                                 f"{rec['decode_drops']}")
    if out["replicas"]["replicas"]["replica_swaps"] < 1:
        raise AssertionError("[placement] no replica swap took place")
    for policy in ("predictive", "on_demand"):
        if out[f"residency_{policy}"]["residency"]["residency_stages"] < 1:
            raise AssertionError(f"[placement] {policy}: no stage")
    if out["residency_none"]["residency"]["stages"]:
        raise AssertionError("[placement] none staged rows")
    res = out["residency_predictive"]["residency"]
    log(f"[placement] gates held: streams equal the run without each "
        f"mechanism in all {len(out)} runs; {out['replicas']['replicas']['replica_swaps']} "
        f"swap(s) of {out['replicas']['replicas']['swap_bytes'] / 1e9:.2f} GB "
        f"in {out['replicas']['replicas']['swap_ms']:.3f} ms; predictive "
        f"stages {res['residency_stages']}, {res['stage_ms_per_row']:.3f} ms "
        f"a {res['row_mb']:.1f} MB row ({res['stage_gb_s']:.1f} GB/s against "
        f"{PCIE_BYTES_S / 1e9:.0f} GB/s, bound "
        f"{res['bound_ms_per_row']:.3f} ms); foreign rows through moe_gmm "
        f"{out['base']['moe_gmm_foreign_rows']} without replicas, "
        f"{out['replicas']['moe_gmm_foreign_rows']} with")
    return out


def small_ep_reference_check(seed: int = 0) -> None:
    """A reduced qwen15-moe-a27b in f32 with learned routing at EP degree
    4 and q = 1: the card's greedy streams (moe_gmm with foreign groups)
    equal the CPU's, whose four ranks are virtual too."""
    import dataclasses
    import numpy as np
    from repro_torch.configs.registry import get_config
    from repro_torch.models.model import build_model
    from repro_torch.serve import Request, ServeEngine, VirtualClock, \
        engine_config_for
    cfg = get_config("qwen15-moe-a27b").reduced()
    cfg = dataclasses.replace(cfg, moe=dataclasses.replace(cfg.moe,
                                                           q_tokens=1))
    rng = np.random.default_rng(seed)
    prompts = [rng.integers(0, cfg.vocab_size, (int(rng.integers(5, 40)),))
               for _ in range(5)]
    params = build_model(cfg, batch=4, seq_len=40, device="cpu",
                         ep_degree=EP_DEGREE).init(seed)
    streams, moved = {}, {}
    for dev in ("cpu", "cuda"):
        model = build_model(cfg, batch=4, seq_len=40, device=dev,
                            ep_degree=EP_DEGREE)
        ecfg = engine_config_for(cfg, max_slots=4, prompt_len=40,
                                 max_new_tokens=8, prefill_chunk=16,
                                 paged=True, kv_block_size=8)
        eng = ServeEngine(model, _to(params, dev), ecfg,
                          clock=VirtualClock(0.1), device=dev)
        out = {}
        orig = eng._finish

        def capture(st, now, out=out, orig=orig):
            out[st.req.rid] = list(st.output)
            orig(st, now)
        eng._finish = capture
        rep = eng.run([Request(rid=i, tokens=p, max_new_tokens=8)
                       for i, p in enumerate(prompts)])
        streams[dev], moved[dev] = out, rep["moe"]["decode/moved_units"]
    if streams["cpu"] != streams["cuda"]:
        raise AssertionError(f"small EP reference: card streams "
                             f"{streams['cuda']} != cpu streams "
                             f"{streams['cpu']}")
    if moved["cuda"] <= 0:
        raise AssertionError("small EP reference: no unit moved at decode")
    log(f"[reference] reduced qwen15-moe-a27b f32 at EP degree {EP_DEGREE}: "
        f"{len(prompts)} greedy streams on the card equal the CPU "
        f"plain-version streams (moved units per layer and decode step: "
        f"card {moved['cuda']:.3f}, cpu {moved['cpu']:.3f})")


# ----------------------------------------------------------------------
# phase 5: whole-prompt prefill + slab decode
# ----------------------------------------------------------------------
def prefill_decode_path(cfg, *, batch, prompt_len, s_max, new_tokens, seed):
    import numpy as np
    import torch
    from repro_torch.launch.steps import make_decode_step, make_prefill_step
    from repro_torch.models import attention as A
    from repro_torch.models.model import build_model
    t0 = time.perf_counter()
    model = build_model(cfg, batch=batch, seq_len=prompt_len)
    params = model.init(seed)
    torch.cuda.synchronize()
    n_params = sum(t.numel() for t in _leaves(params))
    log(f"[prefill] {cfg.name}: {n_params / 1e9:.2f} B parameters drawn on "
        f"the card in {time.perf_counter() - t0:.1f} s "
        f"({torch.cuda.memory_allocated() / 2**30:.1f} GiB)")
    prompts = torch.as_tensor(np.random.default_rng(seed).integers(
        0, cfg.vocab_size, (batch, prompt_len)), dtype=torch.int32,
        device="cuda")
    prefill = make_prefill_step(model, s_max=s_max)
    decode = make_decode_step(model)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    A.reset_dispatch_log()
    read = _reset_launches()
    t0 = time.perf_counter()
    tok, caches, pos, _ = prefill(params, {"tokens": prompts})
    torch.cuda.synchronize()
    prefill_s = time.perf_counter() - t0
    after_prefill = read()
    out, step_s = [tok], []
    for _ in range(new_tokens):
        t0 = time.perf_counter()
        tok, caches, pos, _ = decode(params, tok, caches, pos)
        torch.cuda.synchronize()
        step_s.append(time.perf_counter() - t0)
        out.append(tok)
    launches = read()
    peak = torch.cuda.max_memory_allocated() / 2**30
    branches = {}
    for rec in A.dispatch_log():
        key = f"{rec['branch']}:{'fused' if rec['fused'] else 'plain'}"
        branches[key] = branches.get(key, 0) + 1
    toks = torch.cat(out, dim=1).cpu().numpy()
    summary = {
        "batch": batch, "prompt_len": prompt_len, "s_max": s_max,
        "new_tokens": new_tokens, "prefill_s": prefill_s,
        "prefill_tok_s": batch * prompt_len / prefill_s,
        "decode_step_p50_s": float(np.percentile(step_s, 50)),
        "decode_step_p90_s": float(np.percentile(step_s, 90)),
        "decode_tok_s": batch * new_tokens / sum(step_s),
        "peak_mem_gib": peak, "launches": launches,
        "launches_in_prefill": after_prefill,
        "attention_dispatch": branches,
    }
    log(f"[prefill] {json.dumps(summary)}")
    # --- checks -------------------------------------------------------
    if int(pos) != prompt_len + new_tokens:
        raise AssertionError(f"position {int(pos)} after the run")
    if toks.shape != (batch, new_tokens + 1) or toks.min() < 0 \
            or toks.max() >= cfg.vocab_size:
        raise AssertionError(f"bad tokens {toks.shape} "
                             f"[{toks.min()}, {toks.max()}]")
    if after_prefill["flash_attention"] != cfg.num_layers \
            or launches["flash_attention"] != cfg.num_layers:
        raise AssertionError(f"flash_attention launched {launches} times, "
                             f"not once per layer of the prefill")
    if launches["moe_gmm"] <= 0:
        raise AssertionError("moe_gmm was not launched on the prefill path")
    logits, _, _, _ = model.decode_step(params, tok, caches, pos)
    if tuple(logits.shape) != (batch, cfg.padded_vocab) \
            or not torch.isfinite(logits[:, :cfg.vocab_size]).all():
        raise AssertionError(f"bad logits {tuple(logits.shape)}")
    return summary, params


def small_prefill_reference_check(seed: int = 0) -> None:
    """Reduced moonshot-v1-16b-a3b in f32 through ``launch.steps``: the
    card's greedy tokens (flash and moe_gmm kernels) equal the CPU's
    (their plain versions).  The prompt of 100 tokens spans a ragged
    second q tile of the flash kernel."""
    import numpy as np
    import torch
    from repro_torch.configs.registry import get_config
    from repro_torch.launch.steps import make_decode_step, make_prefill_step
    from repro_torch.models.model import build_model
    cfg = get_config("moonshot-v1-16b-a3b").reduced()
    B, S, n = 3, 100, 8
    prompts = np.random.default_rng(seed).integers(0, cfg.vocab_size, (B, S))
    params = build_model(cfg, batch=B, seq_len=S, device="cpu").init(seed)
    tokens = {}
    for dev in ("cpu", "cuda"):
        model = build_model(cfg, batch=B, seq_len=S, device=dev)
        p = _to(params, dev)
        tok, caches, pos, _ = make_prefill_step(model, s_max=S + n)(
            p, {"tokens": torch.as_tensor(prompts, device=dev)})
        out = [tok]
        decode = make_decode_step(model)
        for _ in range(n - 1):
            tok, caches, pos, _ = decode(p, tok, caches, pos)
            out.append(tok)
        tokens[dev] = torch.cat(out, dim=1).cpu().numpy()
    if not np.array_equal(tokens["cpu"], tokens["cuda"]):
        raise AssertionError(f"small prefill reference: card tokens "
                             f"{tokens['cuda'].tolist()} != cpu tokens "
                             f"{tokens['cpu'].tolist()}")
    log(f"[reference] reduced {cfg.name} f32: {B} x {n} greedy tokens "
        f"through launch.steps on the card equal the CPU plain-version "
        f"tokens")


# Reduced moonshot in bf16.  The card (tensor-core kernels, cuBLAS) and the
# CPU (plain versions) both round to bf16 after every operation but sum in
# other orders.  Left alone, those roundings flip some tokens' top-k
# experts (eight experts of random weights have close router logits), and a
# flipped token takes another expert's output: the last-position logits
# then move by 0.03-0.36 of the largest logit with the seed, however right
# the kernels are.  So every bf16 run here replays the experts that the f32
# run chose, layer by layer (its gates still come from its own router
# logits), and what is left between bf16 and f32 is rounding that compounds
# over the layers, 0.018-0.051 of the largest logit over eight seeds on the
# CPU (`scripts/bf16_check_controls.py`).  The CPU's gap in the same run is
# the scale of that noise: the card must stay within BF16_NOISE_FACTOR of
# it from the f32 logits, and from the CPU's bf16 logits (two runs each
# within the noise of f32 are at most twice it apart).  Planted faults
# (BF16_FAULTS) move the logits by 0.12-1.05 over those seeds; each must
# fail this limit on the card in every run.
BF16_NOISE_FACTOR = 2.0


@contextlib.contextmanager
def replayed_routes(record=None, replay=None):
    """Within the block, the MoE layers' top-k routing appends each layer's
    chosen experts to ``record``, or, given ``replay``, takes the experts
    of the recorded run in its place (one entry per MoE layer, in order),
    with the gates from this run's router logits at those experts."""
    import torch
    from repro_torch.core import moe_layer, router
    layers = iter(replay) if replay is not None else None

    def route(x, w, *, top_k, num_real_experts):
        out = router.route_topk(x, w, top_k=top_k,
                                num_real_experts=num_real_experts)
        if record is not None:
            record.append(out.assign.cpu())
        if layers is None:
            return out
        assign = next(layers).to(x.device)
        logits = x.float() @ w.float()
        gates = torch.softmax(torch.gather(logits, 1, assign.long()), dim=-1)
        counts = torch.bincount(assign.reshape(-1).long(),
                                minlength=w.shape[1]).to(torch.int32)
        return out._replace(assign=assign, gates=gates, counts=counts)
    moe_layer.route_topk = route
    try:
        yield
    finally:
        moe_layer.route_topk = router.route_topk


@contextlib.contextmanager
def planted_fault(name):
    """A fault planted at a kernel's wrapper for the length of the block:
    flash's scale 10 % too large (q scaled before the kernel), flash
    without its causal mask, or the output of moe_gmm's last live tile
    lost (as if the live-row count were one tile short)."""
    from repro_torch.core import moe_layer
    from repro_torch.kernels.moe_gmm.ops import live_row_count
    from repro_torch.models import attention
    flash, ffn = attention.flash_attention, moe_layer.grouped_ffn

    def flash_scaled(q, k, v, *, causal=True):
        return flash(q * 1.1, k, v, causal=causal)

    def flash_unmasked(q, k, v, *, causal=True):
        return flash(q, k, v, causal=False)

    def ffn_tile_lost(x, w_in, w_out, gsp, *, block_m, **kw):
        y = ffn(x, w_in, w_out, gsp, block_m=block_m, **kw)
        live = int(live_row_count(gsp, x.shape[0]))
        y[max(live - block_m, 0):live] = 0
        return y
    attention.flash_attention = {"flash_scale": flash_scaled,
                                 "flash_mask": flash_unmasked}.get(name, flash)
    moe_layer.grouped_ffn = ffn_tile_lost if name == "moe_gmm_tile" else ffn
    try:
        yield
    finally:
        attention.flash_attention, moe_layer.grouped_ffn = flash, ffn


BF16_FAULTS = ("flash_scale", "flash_mask", "moe_gmm_tile")


def bf16_logit_gaps(seed: int = 0, dev: str = "cuda",
                    replay: bool = True) -> dict:
    """Reduced moonshot-v1-16b-a3b in bf16 through ``launch.steps``: how
    far the last-position logits on ``dev`` (the tensor-core flash and
    moe_gmm kernels on the card) lie from the CPU's (their plain versions)
    and from the CPU's f32 logits on the same weights, and how far they lie
    from the f32 logits with each planted fault; every bf16 run on the f32
    run's expert choices unless ``replay`` is False.  Gaps are shares of
    the largest f32 logit."""
    import dataclasses
    import numpy as np
    import torch
    from repro_torch.configs.registry import get_config
    from repro_torch.launch.steps import make_prefill_step
    from repro_torch.models.model import build_model
    cfg32 = get_config("moonshot-v1-16b-a3b").reduced()
    cfg = dataclasses.replace(cfg32, dtype="bfloat16")
    B, S = 3, 100
    prompts = np.random.default_rng(seed).integers(0, cfg.vocab_size, (B, S))
    params = build_model(cfg, batch=B, seq_len=S, device="cpu").init(seed)
    routes = []

    def last_logits(c, d, p, check_step=False):
        model = build_model(c, batch=B, seq_len=S, device=d)
        batch = {"tokens": torch.as_tensor(prompts, device=d)}
        # the f32 run records its experts, the others replay them
        routing = (dict(record=routes) if c is cfg32
                   else dict(replay=routes if replay else None))
        with replayed_routes(**routing):
            lg, _, _, _ = model.prefill(p, batch, s_max=S + 8)
        if check_step:
            with replayed_routes(**routing):
                tok, _, _, _ = make_prefill_step(model, s_max=S + 8)(p, batch)
            if not torch.equal(tok[:, 0].long(), lg.argmax(dim=-1)):
                raise AssertionError(f"{d}: make_prefill_step's token is not "
                                     f"the argmax of model.prefill's logits")
        return lg[:, :cfg.vocab_size].float().cpu()

    f32 = last_logits(cfg32, "cpu", _to(params, "cpu", torch.float32))
    cpu = last_logits(cfg, "cpu", params, check_step=True)
    p_dev = _to(params, dev)
    card = last_logits(cfg, dev, p_dev, check_step=True)
    if not torch.isfinite(card).all():
        raise AssertionError(f"bf16 prefill: non-finite logits on {dev}")
    scale = float(f32.abs().max())

    def gap(a, b):
        return float((a - b).abs().max()) / scale
    rec = {"card_vs_cpu": gap(card, cpu), "cpu_vs_f32": gap(cpu, f32),
           "card_vs_f32": gap(card, f32),
           "argmax_equal": int((card.argmax(-1) == f32.argmax(-1)).sum())}
    for name in BF16_FAULTS:
        with planted_fault(name):
            rec[f"fault_{name}_vs_f32"] = gap(last_logits(cfg, dev, p_dev), f32)
    return rec


def small_prefill_bf16_check(seed: int = 0) -> dict:
    """The bf16 logits of the card within BF16_NOISE_FACTOR x the CPU's
    bf16 noise of the f32 logits and of the CPU's bf16 logits, and every
    planted fault beyond that limit."""
    rec = bf16_logit_gaps(seed, "cuda")
    limit = BF16_NOISE_FACTOR * rec["cpu_vs_f32"]
    log(f"[reference] reduced moonshot-v1-16b-a3b bf16 on the f32 run's "
        f"experts, last-position logits as a share of the largest f32 logit: "
        f"card vs f32 {rec['card_vs_f32']:.3e}, card vs CPU "
        f"{rec['card_vs_cpu']:.3e} (limit {limit:.3e} = {BF16_NOISE_FACTOR} x "
        f"the CPU's bf16 noise {rec['cpu_vs_f32']:.3e}), argmax equal to "
        f"f32's in {rec['argmax_equal']} of 3 rows; planted faults: "
        + ", ".join(f"{n} {rec[f'fault_{n}_vs_f32']:.3e}" for n in BF16_FAULTS))
    if rec["card_vs_f32"] > limit or rec["card_vs_cpu"] > limit:
        raise AssertionError(f"bf16 prefill logits beyond bf16 noise: {rec}")
    missed = [n for n in BF16_FAULTS if rec[f"fault_{n}_vs_f32"] <= limit]
    if missed:
        raise AssertionError(f"the bf16 logits check passed planted faults "
                             f"{missed}: {rec}")
    return rec


# ----------------------------------------------------------------------
# phase 6: the engine across layer patterns
# ----------------------------------------------------------------------
def switch_path(switch, *, seed, **shape):
    """switch128 at full width and depth (dense/MoE periods, GELU experts:
    ``moe_gmm``'s plain form) on the slab and paged, on one set of random
    weights."""
    import torch
    from repro_torch.models.model import build_model
    t0 = time.perf_counter()
    params = build_model(switch, batch=4,
                         seq_len=shape["max_seq_len"]).init(seed)
    torch.cuda.synchronize()
    n_params = sum(t.numel() for t in _leaves(params))
    log(f"[serve-switch] {switch.name}: {n_params / 1e9:.2f} B parameters "
        f"drawn on the card in {time.perf_counter() - t0:.1f} s "
        f"({torch.cuda.memory_allocated() / 2**30:.1f} GiB)")
    out, caps = {}, []
    for paged in (False, True):
        pool = "paged" if paged else "slab"
        out[f"serve_switch128_{pool}"] = \
            pattern_serve(switch, params, "serve-switch", paged=paged,
                          slots=4, n_requests=8, prompt_lens=(64, 257),
                          new_tokens=32, seed=seed, **shape)
        caps.append(capture_compare(
            switch, params, f"switch128_{pool}", paged=paged, n_requests=4,
            prompt_lens=(64, 129), new_tokens=16, seed=seed, **shape))
    return out, caps


# ----------------------------------------------------------------------
# phase 9: the serving CLI, sampled
# ----------------------------------------------------------------------
# the argv of each CLI run: (a) one rank, sampled, Poisson arrivals;
# (b) four virtual EP ranks under 0.9 skew, sampled
CLI_RUNS = {
    "cli": ["--arch", "qwen15-moe-a27b", "--paged", "--batch", "8",
            "--requests", "24", "--rate", "8", "--prompt-len", "128",
            "--gen", "32", "--temperature", "0.8", "--top-k", "50",
            "--top-p", "0.9", "--seed", "0"],
    "cli-ep": ["--arch", "qwen15-moe-a27b", "--model-par", "4", "--skew",
               "0.9", "--q-tokens", "1", "--policy", "harmoeny", "--paged",
               "--batch", "4", "--requests", "4", "--prompt-len", "128",
               "--gen", "8", "--temperature", "0.8", "--top-k", "50",
               "--seed", "0"],
}
SAMPLER_CASES = [(0, 1.0), (50, 1.0), (0, 0.9), (50, 0.9)]


def _flag(argv, name, cast=int, default=None):
    return cast(argv[argv.index(name) + 1]) if name in argv else default


def cli_run(tag, argv, cfg, sampler_ms):
    """Run the port's CLI (``python -m repro_torch.launch.serve``) in its
    own process on the card, read its report (``--out``) and its
    ``[serve] device`` line, print the ``[tag]`` line and hold the gates:
    exit 0, every request with its budget, tokens in the vocabulary, one
    capture of each entry, each kernel launched once per layer (and rank)
    and step, the kernels' dispatch, and at G > 1 no drop and units
    moved."""
    out = os.path.join(HERE, "build", "cli", f"{tag}.json")
    os.makedirs(os.path.dirname(out), exist_ok=True)
    if os.path.exists(out):
        os.remove(out)
    env = dict(os.environ, PYTHONPATH=os.path.join(HERE, "src"))
    t0 = time.perf_counter()
    r = subprocess.run([sys.executable, "-m", "repro_torch.launch.serve",
                        *argv, "--out", out], capture_output=True,
                       text=True, env=env, cwd=HERE, timeout=900)
    wall = time.perf_counter() - t0
    device = None
    for line in r.stdout.splitlines():
        if line.startswith("[serve] device "):
            device = json.loads(line[len("[serve] device "):])
        elif line.startswith("[serve]"):
            log(f"[{tag}] {line}")
    if r.returncode != 0 or device is None or not os.path.exists(out):
        raise AssertionError(f"[{tag}] the CLI exited {r.returncode}: "
                             f"{r.stderr[-4000:]}")
    with open(out) as f:
        rep = json.load(f)
    n_req, gen = _flag(argv, "--requests"), _flag(argv, "--gen")
    G = _flag(argv, "--model-par", default=1)
    lb, moe = rep["load_balance"], rep["moe"]
    steps = rep["decode_steps"] + rep["prefill_chunks"]
    summary = {
        "argv": " ".join(argv), "device": device["device"],
        "requests": rep["n_requests"], "tokens_out": rep["total_new_tokens"],
        "ttft_p50_s": rep["ttft"]["p50"], "ttft_p90_s": rep["ttft"]["p90"],
        "ttft_p99_s": rep["ttft"]["p99"], "tpot_p50_s": rep["tpot"]["p50"],
        "tpot_p90_s": rep["tpot"]["p90"],
        "throughput_tok_s": rep["throughput_tok_s"],
        "peak_mem_gib": device["peak_mem_gib"],
        "decode_steps": rep["decode_steps"],
        "prefill_chunks": rep["prefill_chunks"],
        "mean_occupancy": rep["mean_occupancy"],
        "launches": device["launches"],
        "sampler_device_ms_a_step": sampler_ms,
        "noise_predraw_host_ms": device["noise_predraw_ms"],
        "noise_predraws": device["noise_predraws"],
        "skew_predraw_host_ms": device["skew_predraw_ms"],
        "process_wall_s": wall, "jit_entries": rep["jit_entries"],
        "recompiled_after_warmup": rep.get("recompiled_after_warmup"),
    }
    if G > 1:
        summary.update({
            "ep_degree": G,
            "decode_max_mean_ratio": lb["decode"]["max_mean_ratio"],
            "prefill_max_mean_ratio": lb["prefill"]["max_mean_ratio"],
            "moved_units_decode": moe["decode/moved_units"],
            "moved_units_prefill": moe["prefill/moved_units"],
            "drops": {ph: [lb[ph]["send_drops_total"],
                           lb[ph]["dest_drops_total"]]
                      for ph in ("decode", "prefill")}})
    log(f"[{tag}] {json.dumps(summary)}")
    # --- checks -------------------------------------------------------
    check_one_capture(tag, rep)
    toks = device["tokens"]
    if rep["n_requests"] != n_req or toks["per_request"] != [gen] \
            or toks["count"] != n_req * gen:
        raise AssertionError(f"[{tag}] {rep['n_requests']} of {n_req} "
                             f"requests finished, lengths "
                             f"{toks['per_request']} (budget {gen})")
    if not 0 <= toks["min"] <= toks["max"] < cfg.vocab_size:
        raise AssertionError(f"[{tag}] token ids {toks['min']}.."
                             f"{toks['max']} outside the vocabulary")
    n_moe = cfg.num_layers
    expect = {"moe_gmm": G * n_moe * steps,
              "paged_attention": cfg.num_layers * steps,
              "flash_attention": 0, "schedule": G * n_moe * steps}
    if device["launches"] != expect:
        raise AssertionError(f"[{tag}] launches {device['launches']} != "
                             f"{expect}")
    dispatch = {b: d["fused"] for b, d in rep["attention_dispatch"].items()}
    if dispatch != {"prefill_continue": True, "decode": True} \
            or not (rep["engine"]["fused_paged_attention"]
                    and rep["engine"]["fused_moe_gmm"]):
        raise AssertionError(f"[{tag}] dispatch {rep['attention_dispatch']}"
                             f", engine {rep['engine']}")
    if G > 1:
        drops = sum(sum(v) for v in summary["drops"].values())
        if drops or moe["decode/moved_units"] <= 0:
            raise AssertionError(f"[{tag}] drops {summary['drops']}, moved "
                                 f"units at decode "
                                 f"{moe['decode/moved_units']}")
    return summary


def _tie_logits(B, V, seed, dev):
    """bf16 logits with many exact ties (a few hundred distinct values)."""
    import torch
    g = torch.Generator().manual_seed(seed)
    lv = torch.randint(-400, 8, (B, V), generator=g).float() / 16
    return lv.to(torch.bfloat16).float().to(dev)


def sampler_parity(cfg, batch):
    """The decode step's sampler at the serve shape ([batch, padded
    vocab]), captured in a CUDA graph as the decode step holds it, against
    its plain version on the CPU on tie-heavy bf16 logits and fixed
    noise, token for token, at each (top_k, top_p) of SAMPLER_CASES; and
    its device ms a step.  Returns {case: ms}."""
    import torch
    from repro_torch.serve.sampling import gumbel_, noise_width, sample_tokens
    V = cfg.padded_vocab
    out_ms = {}
    for top_k, top_p in SAMPLER_CASES:
        kw = dict(temperature=0.8, top_k=top_k, top_p=top_p)
        lg = _tie_logits(batch, V, 0, "cuda")
        nz = torch.zeros((batch, noise_width(V, top_k)), device="cuda")
        sample_tokens(lg, nz, **kw)
        graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(graph):
            out = sample_tokens(lg, nz, **kw)
        for seed in range(3):
            lg.copy_(_tie_logits(batch, V, seed, "cpu"))
            host = gumbel_(torch.empty(nz.shape),
                           torch.Generator().manual_seed(seed))
            nz.copy_(host)
            graph.replay()
            want = sample_tokens(lg.cpu(), host, **kw)
            torch.cuda.synchronize()
            if not torch.equal(out.cpu(), want):
                raise AssertionError(
                    f"sampler (top_k {top_k}, top_p {top_p}) seed {seed}: "
                    f"card {out.cpu().tolist()} != cpu {want.tolist()}")
        out_ms[f"top_k={top_k},top_p={top_p}"] = device_ms(graph.replay, 20)
    log(f"[sampler] {batch} x {V} f32, tie-heavy bf16 logits: the captured "
        f"sampler equals its plain version token for token in "
        f"{len(SAMPLER_CASES)} cases x 3 noise draws; device ms a step "
        f"{json.dumps(out_ms)}")
    return out_ms


def small_sampled_reference_check(seed: int = 0) -> None:
    """Reduced qwen15-moe-a27b in f32, sampled (temperature 0.8, top-k 5,
    top-p 0.9), paged: the card's streams (the captured decode step's
    sampler, the host twin's first tokens) equal the CPU's, on the same
    noise drawn on the host from each step's key."""
    import numpy as np
    import torch
    from repro_torch.configs.registry import get_config
    from repro_torch.models.model import build_model
    from repro_torch.serve import Request, ServeEngine, VirtualClock, \
        engine_config_for
    from repro_torch.serve.sampling import gumbel_
    cfg = get_config("qwen15-moe-a27b").reduced()
    rng = np.random.default_rng(seed)
    prompts = [rng.integers(0, cfg.vocab_size, (int(rng.integers(5, 40)),))
               for _ in range(5)]
    params = build_model(cfg, batch=3, seq_len=40, device="cpu").init(seed)
    streams = {}
    for dev in ("cpu", "cuda"):
        model = build_model(cfg, batch=3, seq_len=40, device=dev)
        ecfg = engine_config_for(cfg, max_slots=3, prompt_len=40,
                                 max_new_tokens=8, prefill_chunk=16,
                                 paged=True, kv_block_size=8,
                                 temperature=0.8, top_k=5, top_p=0.9)
        eng = ServeEngine(model, _to(params, dev), ecfg,
                          clock=VirtualClock(0.1), device=dev)
        core = eng.core

        def host_noise(idx, core=core):
            buf = torch.empty(core._noise.shape)
            core._noise.copy_(gumbel_(buf, core.dec_key.fold_in(
                idx).generator("cpu")))
        core._draw_noise = host_noise
        eng.warmup()
        out = {}
        orig = eng._finish

        def capture(st, now, out=out, orig=orig):
            out[st.req.rid] = list(st.output)
            orig(st, now)
        eng._finish = capture
        rep = eng.run([Request(rid=i, tokens=p, max_new_tokens=8)
                       for i, p in enumerate(prompts)])
        streams[dev] = out
    check_one_capture("sampled reference", rep)
    if streams["cpu"] != streams["cuda"]:
        raise AssertionError(f"sampled reference: card streams "
                             f"{streams['cuda']} != cpu streams "
                             f"{streams['cpu']}")
    log(f"[reference] reduced qwen15-moe-a27b f32, sampled (0.8, top-k 5, "
        f"top-p 0.9), paged: {len(prompts)} streams on the card equal the "
        f"CPU plain-version streams on the same noise")


def cli_path(cfg):
    """Phase 9: the sampler's parity and time, the reduced sampled
    reference, then the two CLI runs; returns their summaries."""
    sampler = sampler_parity(cfg, batch=_flag(CLI_RUNS["cli"], "--batch"))
    small_sampled_reference_check()
    top_k = _flag(CLI_RUNS["cli"], "--top-k")
    top_p = _flag(CLI_RUNS["cli"], "--top-p", float)
    ms = sampler[f"top_k={top_k},top_p={top_p}"]
    return {tag: cli_run(tag, argv, cfg, ms if tag == "cli" else None)
            for tag, argv in CLI_RUNS.items()}


# ----------------------------------------------------------------------
# phase 10: HarMoEny across processes, and the fetch on its side stream
# ----------------------------------------------------------------------
# busy ms of phase 7's captured G = 4 decode step and prefill chunk when
# the fetch was the dense outbox on the compute stream (NVIDIA H100 80GB
# HBM3, 700 W; PERF.md section 5)
DENSE_FETCH_BUSY_MS = {
    "harmoeny": {"decode_step": 139.8, "prefill_chunk": 141.4},
    "round_robin": {"decode_step": 52.4, "prefill_chunk": 140.8}}
# (a): phase 3's traffic cut as phase 9 cuts it, greedy, one rank
NCCL_ARGV = ["--arch", "qwen15-moe-a27b", "--paged", "--batch", "4",
             "--requests", "4", "--prompt-len", "128", "--gen", "8",
             "--seed", "0"]
# (b): phase 4b's traffic cut to 2 requests of 8 new tokens
DIST_REQUESTS, DIST_NEW = 2, 8
# an eager step's kernels run on the compute stream and the fetch's side
# stream (and a copy stream or two); a captured graph's on dozens
EAGER_STREAMS = 4


def DenseInlineGroup(size):
    """A ``VirtualGroup`` whose fetch is the port's form before the
    gather and the side stream: each rank's [G, K] outbox of the rows it
    hosts, stacked, summed over sources, on the compute stream (phase 7's
    in-run comparison for the gather)."""
    import torch
    from repro_torch.core import dispatch as D

    class _Group(D.VirtualGroup):
        def _fetch_rows(self, xs, args):
            boxes = torch.stack([D.dense_outbox(x, f, me, topo)
                                 for x, (f, me, topo, _) in zip(xs, args)])
            return [D.Fetched(boxes[:, dst].sum(dim=0))
                    for dst in range(self.size)]
    return _Group(size)


def fetch_lines(caps):
    """Phase 10 (c), from phase 7's captured G = 4 runs: for the decode
    step and the prefill chunk of each policy, wall, busy (kernel time,
    and the time anything ran) and idle, the fetch's own device ms (its
    side stream's kernels) and how much of it ran beside the main
    stream's, against the dense fetch's busy ms before it
    (``DENSE_FETCH_BUSY_MS``).  Gate: the eager trace puts the
    fetch's kernels on a stream of their own under harmoeny."""
    def one(wall, busy, st):
        union = st.get("union_busy_ms_per_step", 0.0)
        rec = {"wall_ms": wall, "busy_ms": busy, "union_busy_ms": union,
               "idle_share": 1.0 - union / wall,
               "trace_streams": st.get("streams", 0),
               "concurrent_ms": st.get("concurrent_ms_per_step")}
        # a graph's replay shows on the streams CUDA gives its branches
        # (dozens), so only an eager trace names the fetch's own stream
        if rec["trace_streams"] <= EAGER_STREAMS:
            rec.update(fetch_side_ms=st.get("side_ms_per_step"),
                       fetch_overlap_ms=st.get("side_overlap_ms_per_step"),
                       side_kernels=st.get("side_top_kernels_ms_per_step"))
        return rec
    out = {}
    for cap in caps:
        if cap["ep_degree"] == 1:
            continue
        rec = {}
        for mode in ("eager", "captured"):
            c, pf = cap[mode], cap[mode]["prefill_chunk"]
            rec[mode] = {
                "decode_step": one(c["wall_ms_per_decode_step"],
                                   c["device_busy_ms_per_step"],
                                   c["streams"]),
                "prefill_chunk": one(pf["wall_ms"], pf["device_busy_ms"],
                                     pf["streams"])}
        if "dense_inline" in cap:
            d = cap["dense_inline"]
            rec["dense_inline_captured"] = {
                "decode_step": one(d["wall_ms_per_decode_step"],
                                   d["device_busy_ms_per_step"],
                                   d["streams"]),
                "prefill_chunk": one(d["prefill_chunk"]["wall_ms"],
                                     d["prefill_chunk"]["device_busy_ms"],
                                     d["prefill_chunk"]["streams"])}
        rec["dense_fetch_busy_ms_before"] = DENSE_FETCH_BUSY_MS[cap["policy"]]
        out[cap["policy"]] = rec
        log(f"[fetch] {json.dumps({'policy': cap['policy'], **rec})}")
    for what, rec in out["harmoeny"]["eager"].items():
        if not 2 <= rec["trace_streams"] <= EAGER_STREAMS \
                or not rec["fetch_side_ms"]:
            raise AssertionError(f"[fetch] harmoeny {what}: the fetch ran "
                                 f"on no side stream: {rec}")
    return out


PROFILED_CLI = """
import json, sys
import torch
from torch.profiler import ProfilerActivity, profile
from repro_torch.launch import serve as S
from repro_torch.serve import engine as E
ops_out = sys.argv[1]
run = E.ServeEngine.run


def profiled_run(self, requests=(), **kw):
    rep = run(self, requests, **kw)
    # the last decode step's graph once more, under the profiler: what
    # its replay runs on the card, the collectives' work included
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        self.core.decode_entry.graph.replay()
        torch.cuda.synchronize()
    names = {}
    for e in prof.profiler.kineto_results.events():
        if e.device_type() == torch.autograd.DeviceType.CUDA:
            names[e.name()] = names.get(e.name(), 0) + 1
    json.dump(names, open(ops_out, "w"))
    return rep


E.ServeEngine.run = profiled_run
S.main(sys.argv[2:])
"""


def nccl_cli_path(cfg):
    """Phase 10 (a): the CLI at full width, G = 1, in its own process
    under ``torch.distributed.run --standalone --nproc-per-node 1``
    (``DistComm`` on NCCL, dense fetch, every entry captured), and the
    same argv in a process without a launcher (``LocalComm``); each
    replays its last decode graph once more under the profiler.  Gates:
    both exit 0 and write their reports, one capture of each entry,
    equal greedy streams (their digests) and launches, and the NCCL
    run's replayed graph holds device work the ``LocalComm`` graph does
    not (the collectives')."""
    from collections import Counter
    build = os.path.join(HERE, "build", "cli")
    os.makedirs(build, exist_ok=True)
    env = dict(os.environ, PYTHONPATH=os.path.join(HERE, "src"))
    worker = os.path.join(build, "profiled_cli.py")
    with open(worker, "w") as f:
        f.write(PROFILED_CLI)
    runs = {}
    for tag, launcher in (("local", [sys.executable, worker]),
                          ("nccl", [sys.executable, "-m",
                                    "torch.distributed.run", "--standalone",
                                    "--nproc-per-node", "1", worker])):
        out, ops = (os.path.join(build, f"{tag}{x}.json")
                    for x in ("", "_ops"))
        for path in (out, ops):
            if os.path.exists(path):
                os.remove(path)
        t0 = time.perf_counter()
        r = subprocess.run(launcher + [ops] + NCCL_ARGV + ["--out", out],
                           capture_output=True, text=True, env=env,
                           cwd=HERE, timeout=600)
        wall = time.perf_counter() - t0
        device = next((json.loads(line[len("[serve] device "):])
                       for line in r.stdout.splitlines()
                       if line.startswith("[serve] device ")), None)
        if r.returncode != 0 or device is None or not os.path.exists(out):
            raise AssertionError(f"[cli-nccl] {tag}: exited {r.returncode}:"
                                 f" {r.stderr[-4000:]}")
        with open(out) as f:
            rep = json.load(f)
        with open(ops) as f:
            ops = json.load(f)
        check_one_capture(f"cli-nccl {tag}", rep)
        runs[tag] = {"rep": rep, "device": device, "wall": wall,
                     "ops": Counter(ops)}
    loc, nc = runs["local"], runs["nccl"]
    comm_ops = dict(nc["ops"] - loc["ops"])
    summary = {
        "argv": " ".join(NCCL_ARGV), "comm": nc["rep"]["engine"].get("comm"),
        "streams_equal": loc["device"]["tokens"]["streams_sha256"]
        == nc["device"]["tokens"]["streams_sha256"],
        "tokens": nc["device"]["tokens"]["count"],
        "launches": {"nccl": nc["device"]["launches"],
                     "local": loc["device"]["launches"]},
        "tpot_p50_s": {t: r["rep"]["tpot"]["p50"] for t, r in runs.items()},
        "ttft_p50_s": {t: r["rep"]["ttft"]["p50"] for t, r in runs.items()},
        "peak_mem_gib": {t: r["device"]["peak_mem_gib"]
                         for t, r in runs.items()},
        "process_wall_s": {t: r["wall"] for t, r in runs.items()},
        "replayed_decode_graph_ops": {t: sum(r["ops"].values())
                                      for t, r in runs.items()},
        "ops_beyond_local": comm_ops,
        "jit_entries": nc["rep"]["jit_entries"]}
    log(f"[cli-nccl] {json.dumps(summary)}")
    comm = summary["comm"] or {}
    if comm.get("backend") != "nccl" or comm.get("entries") != "captured" \
            or comm.get("fetch") != "dense":
        raise AssertionError(f"[cli-nccl] the launched CLI ran on {comm}")
    if loc["rep"]["engine"].get("comm") is not None:
        raise AssertionError("[cli-nccl] the run without a launcher built a "
                             "DistComm")
    if not summary["streams_equal"]:
        raise AssertionError("[cli-nccl] greedy streams under DistComm on "
                             "NCCL differ from LocalComm's")
    if not comm_ops:
        raise AssertionError(f"[cli-nccl] the NCCL run's replayed decode "
                             f"graph holds no work beyond LocalComm's: "
                             f"{dict(nc['ops'])}")
    if summary["launches"]["nccl"] != summary["launches"]["local"]:
        raise AssertionError(f"[cli-nccl] launches {summary['launches']}")
    return summary


DIST_WORKER = """
import json, sys, time
import numpy as np, torch, torch.distributed as dist
rank, port, here, out = int(sys.argv[1]), sys.argv[2], sys.argv[3], sys.argv[4]
sys.path.insert(0, here + "/src")
sys.path.insert(0, here)
torch.cuda.set_device(0)
dist.init_process_group("gloo", init_method=f"tcp://localhost:{port}",
                        rank=rank, world_size=4)
dev = torch.device("cuda", 0)
probe = {}
for name, fn in {
    "all_gather_into_tensor": lambda x: dist.all_gather_into_tensor(
        x.new_empty((4 * 8,)), x),
    "all_to_all_single even": lambda x: dist.all_to_all_single(
        torch.empty_like(x), x),
    "all_to_all_single uneven": lambda x: dist.all_to_all_single(
        x.new_empty((4 * (rank + 1),)), x.repeat(2)[:10],
        output_split_sizes=[rank + 1] * 4, input_split_sizes=[1, 2, 3, 4]),
    "all_reduce": lambda x: dist.all_reduce(x),
    "broadcast": lambda x: dist.broadcast(x, src=0)}.items():
    try:
        fn(torch.arange(8, device=dev, dtype=torch.bfloat16))
        torch.cuda.synchronize()
        probe[name] = "ok"
    except Exception as e:            # recorded, and the phase fails on it
        probe[name] = f"{type(e).__name__}: {e}"
if any(v != "ok" for v in probe.values()):
    json.dump({"probe": probe}, open(f"{out}/rank{rank}.json", "w"))
    sys.exit(3)
import chip_smoke as CS
from repro_torch.configs.registry import get_config
from repro_torch.core.dispatch import DistComm
from repro_torch.models.model import build_model
from repro_torch.serve import EngineConfig, ServeEngine, stepcore
spec = json.load(open(f"{out}/spec.json"))
cfg = CS.ep_moe_config(get_config("qwen15-moe-a27b"), "harmoeny")
comm = DistComm(fetch="hosted")
model = build_model(cfg, batch=spec["slots"], seq_len=spec["max_seq_len"],
                    ep_degree=4, comm=comm)
t0 = time.perf_counter()
params = model.init(spec["seed"])
torch.cuda.synchronize()
init_s = time.perf_counter() - t0
held = torch.cuda.memory_allocated() / 2**30
ecfg = EngineConfig(**spec["ecfg"])
from repro_torch.serve import Request
reqs = [Request(rid=r["rid"], tokens=np.asarray(r["tokens"]),
                max_new_tokens=r["max_new_tokens"]) for r in spec["requests"]]
streams = {}
with stepcore.eager():
    eng = ServeEngine(model, params, ecfg)
    finish = eng._finish
    def record(st, now):
        streams[str(st.req.rid)] = [int(t) for t in st.output]
        finish(st, now)
    eng._finish = record
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    read = CS._reset_launches()
    t0 = time.perf_counter()
    rep = eng.run(reqs)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
calls = rep["decode_steps"] + rep["prefill_chunks"]
json.dump({"probe": probe, "streams": streams,
           "load_balance": rep["load_balance"], "moe": rep["moe"],
           "comm": rep["engine"]["comm"], "launches": read(),
           "decode_steps": rep["decode_steps"],
           "prefill_chunks": rep["prefill_chunks"],
           "init_s": init_s, "held_gib": held,
           "peak_mem_gib": torch.cuda.max_memory_allocated() / 2**30,
           "fetch_bytes": comm.fetch_bytes,
           "fetch_mb_per_call": comm.fetch_bytes / 1e6 / max(calls, 1),
           "skew_predraw_host_ms": {e: eng.core.predraw_ms(e)
                                    for e in ("prefill_chunk", "decode")},
           "tpot_p50_s": rep["tpot"]["p50"], "ttft_p50_s": rep["ttft"]["p50"],
           "wall_s": wall},
          open(f"{out}/rank{rank}.json", "w"),
          default=lambda o: o.item() if hasattr(o, "item") else int(o))
dist.destroy_process_group()
"""


def dist_spec(cfg, *, seed, slots, max_seq_len, prefill_chunk, block_size,
              **_):
    """Phase 10 (b)'s requests and engine config: 2 requests of 64-128
    prompt tokens and 8 new, harmoeny under skew 0.9, paged, eager."""
    import numpy as np
    rng = np.random.default_rng(seed + 10)
    reqs = [{"rid": i, "tokens": [int(t) for t in rng.integers(
        0, cfg.vocab_size, (int(rng.integers(64, 129)),))],
        "max_new_tokens": DIST_NEW} for i in range(DIST_REQUESTS)]
    ecfg = dict(max_slots=slots, max_seq_len=max_seq_len,
                prefill_chunk=prefill_chunk, paged=True,
                kv_block_size=block_size, moe_policy="harmoeny",
                skew_seed=seed)
    return {"seed": seed, "slots": slots, "max_seq_len": max_seq_len,
            "ecfg": ecfg, "requests": reqs}


def dist_reference(cfg, params, spec):
    """Phase 10 (b)'s reference, on phase 4b's weights: the same requests
    on ``VirtualGroup(4)`` in one process, every entry eager as the gloo
    processes run."""
    import numpy as np
    import torch
    from repro_torch.models.model import build_model
    from repro_torch.serve import EngineConfig, Request, ServeEngine, \
        stepcore
    model = build_model(ep_moe_config(cfg, "harmoeny"), batch=spec["slots"],
                        seq_len=spec["max_seq_len"], ep_degree=EP_DEGREE)
    streams = {}
    with stepcore.eager():
        eng = ServeEngine(model, params, EngineConfig(**spec["ecfg"]))
        finish = eng._finish

        def record(st, now):
            streams[str(st.req.rid)] = [int(t) for t in st.output]
            finish(st, now)
        eng._finish = record
        read = _reset_launches()
        t0 = time.perf_counter()
        rep = eng.run([Request(rid=r["rid"], tokens=np.asarray(r["tokens"]),
                               max_new_tokens=r["max_new_tokens"])
                       for r in spec["requests"]])
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    return {"streams": streams,
            "load_balance": json.loads(json.dumps(rep["load_balance"],
                                                  default=float)),
            "launches": read(), "wall_s": wall,
            "tpot_p50_s": rep["tpot"]["p50"]}


def dist_gloo_path(cfg, spec, ref):
    """Phase 10 (b): four processes on the one card over gloo, each one
    ``DistComm`` rank (hosted fetch, entries eager) holding only its own
    15 experts a layer of the weights phase 4b drew, serving the
    reference's requests.  First each process tries gloo's collectives on
    CUDA tensors.  A ``[dist]`` line per process (peak memory, fetch
    bytes a call, pre-draw host ms, launches) and a gates line.  Gates:
    every collective takes CUDA tensors; greedy streams and
    ``load_balance`` equal the ``VirtualGroup(4)`` run's on every rank;
    drops 0; units moved; each process launched ``moe_gmm`` and
    ``schedule`` once per layer and call, not x 4."""
    import socket
    work = os.path.join(HERE, "build", "dist")
    shutil.rmtree(work, ignore_errors=True)
    os.makedirs(work)
    with open(os.path.join(work, "spec.json"), "w") as f:
        json.dump(spec, f)
    with socket.socket() as sk:
        sk.bind(("localhost", 0))
        port = str(sk.getsockname()[1])
    env = dict(os.environ, PYTHONPATH=os.path.join(HERE, "src"),
               OMP_NUM_THREADS="2")
    t0 = time.perf_counter()
    procs = [subprocess.Popen([sys.executable, "-c", DIST_WORKER, str(r),
                               port, HERE, work], env=env, cwd=HERE,
                              stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                              text=True) for r in range(EP_DEGREE)]
    try:
        errs = [p.communicate(timeout=600)[1] for p in procs]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    wall = time.perf_counter() - t0
    ranks = []
    for r, p in enumerate(procs):
        path = os.path.join(work, f"rank{r}.json")
        rec = json.load(open(path)) if os.path.exists(path) else {}
        if "probe" in rec and any(v != "ok" for v in rec["probe"].values()):
            raise AssertionError(f"[dist] gloo refused CUDA tensors: "
                                 f"{rec['probe']}")
        if p.returncode != 0:
            raise AssertionError(f"[dist] rank {r} exited {p.returncode}: "
                                 f"{errs[r][-4000:]}")
        ranks.append(rec)
    log(f"[dist] gloo on CUDA tensors: {json.dumps(ranks[0]['probe'])}")
    n_layers = cfg.num_layers
    for r, rec in enumerate(ranks):
        line = {k: rec[k] for k in ("comm", "init_s", "held_gib",
                                    "peak_mem_gib", "fetch_bytes",
                                    "fetch_mb_per_call",
                                    "skew_predraw_host_ms", "launches",
                                    "decode_steps", "prefill_chunks",
                                    "tpot_p50_s", "ttft_p50_s", "wall_s")}
        log(f"[dist] rank {r}: {json.dumps(line)}")
        calls = rec["decode_steps"] + rec["prefill_chunks"]
        want = {"moe_gmm": n_layers * calls, "schedule": n_layers * calls,
                "paged_attention": n_layers * calls, "flash_attention": 0}
        if rec["launches"] != want:
            raise AssertionError(f"[dist] rank {r}: launches "
                                 f"{rec['launches']} != {want}")
        if rec["streams"] != ref["streams"]:
            raise AssertionError(f"[dist] rank {r}: streams "
                                 f"{rec['streams']} != VirtualGroup's "
                                 f"{ref['streams']}")
        if rec["load_balance"] != ref["load_balance"]:
            raise AssertionError(f"[dist] rank {r}: load_balance differs "
                                 f"from VirtualGroup's")
    lb, moe = ranks[0]["load_balance"], ranks[0]["moe"]
    drops = sum(lb[ph][k] for ph in ("decode", "prefill")
                for k in ("send_drops_total", "dest_drops_total"))
    if drops or moe["decode/moved_units"] <= 0:
        raise AssertionError(f"[dist] drops {drops}, moved units at decode "
                             f"{moe['decode/moved_units']}")
    summary = {"processes": EP_DEGREE, "wall_s": wall,
               "reference_wall_s": ref["wall_s"],
               "reference_tpot_p50_s": ref["tpot_p50_s"],
               "reference_launches": ref["launches"],
               "decode_max_mean_ratio": lb["decode"]["max_mean_ratio"],
               "moved_units_decode": moe["decode/moved_units"],
               "streams": len(ref["streams"]),
               "peak_mem_gib": [rec["peak_mem_gib"] for rec in ranks],
               "launches": [rec["launches"] for rec in ranks]}
    log(f"[dist] gates held: {json.dumps(summary)}")
    return summary


# ----------------------------------------------------------------------
# phase 11: mixtral-8x7b, its sliding window as slab and paged rings
# ----------------------------------------------------------------------
# full width (d 4096, 32 q / 8 kv heads of 128, 8 experts of f 14336
# top-2, vocab 32,000, bf16), cut in depth: 32 layers are ~87 GiB of
# weights, which do not fit the card's 80 GB; 8 layers are ~22 GiB
MIXTRAL_LAYERS = 8
# (a) G = 1, paged, the window (4096) not binding: bps * bs = 1280
MIX_A = dict(slots=8, n_requests=8, prompt_lens=(256, 1025), new_tokens=32,
             max_seq_len=1024 + 32, prefill_chunk=256, block_size=16)
# (b) the ring binding: paged, chains of M / bs = 256 blocks; the slab
# clamped to the window, which decode wraps
MIX_RING = dict(slots=2, prompt_len=4600, new_tokens=32, prefill_chunk=512,
                block_size=16)
MIX_SLAB = dict(slots=1, prompt_len=4000, new_tokens=200, prefill_chunk=512)
# (c) G = 4 on virtual ranks under 0.9 skew, harmoeny
MIX_EP = dict(slots=4, n_requests=4, max_seq_len=256, prefill_chunk=32,
              block_size=16, new_tokens=8)


def mixtral_config():
    from repro_torch.configs.registry import get_config
    return get_config("mixtral-8x7b").replace(num_layers=MIXTRAL_LAYERS)


def _cast_(tree, dtype):
    """Cast a parameter tree's floating leaves to ``dtype`` in place, one
    leaf at a time, so that the old and new copies of the whole tree are
    never held together."""
    items = tree.items() if isinstance(tree, dict) else enumerate(tree)
    for k, v in list(items):
        if isinstance(v, (dict, list)):
            _cast_(v, dtype)
        elif v.is_floating_point():
            tree[k] = None
            tree[k] = v.to(dtype)
            del v


def mixtral_kernel_parity(mix):
    """Phase 2's mixtral cases at (a)'s shapes: ``moe_gmm`` at the decode
    dispatch (8 slots x top-2 over 8 experts) and at a prefill chunk's
    (256 tokens), each a seeded draw, M each step's c_total; and
    ``paged_attention`` at the decode (GQA rep 4 over chains up to the
    pool's end) and the prefill chunk over the slab scratch."""
    import numpy as np
    import torch
    from repro_torch.core.moe_layer import MoEBlockSpec
    from repro_torch.kernels.paged_attention.ops import largest_block_divisor
    out = {"moe_gmm": [], "paged_attention": []}
    E, K = mix.moe.num_experts, mix.moe.num_foreign_slots
    bf = torch.bfloat16
    draw = np.random.default_rng(22)
    for label, tokens in (("mixtral_decode", MIX_A["slots"]),
                          ("mixtral_prefill_chunk", MIX_A["prefill_chunk"])):
        spec = MoEBlockSpec(moe=mix.moe, d_model=mix.d_model,
                            tokens_local=tokens, block_m=128)
        units = draw.integers(0, E, tokens * mix.moe.num_experts_per_tok)
        sizes = np.bincount(units, minlength=E).tolist() + [0] * K
        out["moe_gmm"].append(moe_gmm_case(
            label, sizes, M=spec.c_total, n_local=E, d=mix.d_model,
            f=mix.moe.d_ff_expert, block_m=128, dtype=bf, seed=23,
            time_it=True))
        torch.cuda.empty_cache()
    heads = dict(H=mix.num_heads, Hkv=mix.num_kv_heads,
                 hd=mix.resolved_head_dim, softcap=0.0, dtype=bf,
                 time_it=True)
    C, L, B = MIX_A["prefill_chunk"], MIX_A["max_seq_len"], MIX_A["slots"]
    s_pad = -(-L // C) * C
    bs = MIX_A["block_size"]
    lengths = [1] + [257 + (L - 257) * i // (B - 2) for i in range(B - 1)]
    out["paged_attention"].append(paged_attention_case(
        "mixtral_decode", B=B, S=1, bs=bs, lengths=lengths,
        n_blocks=s_pad // bs, seed=24, **heads))
    bs_slab = largest_block_divisor(s_pad)
    out["paged_attention"].append(paged_attention_case(
        "mixtral_prefill_chunk", B=1, S=C, bs=bs_slab, lengths=[768 + C],
        n_blocks=s_pad // bs_slab, slab=True, seed=25, **heads))
    # (b)'s slab: the last 512-token chunk over the window-clamped slab
    C, W = MIX_SLAB["prefill_chunk"], mix.sliding_window
    bs_slab = largest_block_divisor(W)
    out["paged_attention"].append(paged_attention_case(
        "mixtral_slab_ring_chunk", B=1, S=C, bs=bs_slab, lengths=[W],
        n_blocks=W // bs_slab, slab=True, seed=26, **heads))
    for name, recs in out.items():
        for r in recs:
            log(f"[parity] {name} {json.dumps(r)}")
    return out


def _serve_streams(model, params, ecfg, reqs):
    """Warm ``ServeEngine`` up (every entry captured), serve ``reqs`` with
    the launch counts reset; (streams, report, launches, wall s, peak
    GiB, KV stats, logits rows).  Each request's logits rows are the
    ones its tokens were taken from: its last prefill chunk's, then its
    slot's row of every decode step (copies on the card of the captured
    entries' output buffers, made after each replay)."""
    import numpy as np
    import torch
    from repro_torch.serve import ServeEngine
    eng = ServeEngine(model, params, ecfg)
    eng.warmup()
    outputs, rows = {}, {}
    orig = eng._finish
    core, V = eng.core, model.cfg.vocab_size

    def capture(st, now):
        outputs[st.req.rid] = list(st.output)
        orig(st, now)
    eng._finish = capture

    def prefill(*args, orig=core.prefill):
        out = orig(*args)
        rows[eng.front.pf.req.rid] = [
            core._pf_logits[0, :V].to(torch.float32, copy=True)]
        return out

    def decode(*args, orig=core.decode):
        out = orig(*args)
        for s in np.nonzero(eng.active)[0]:
            rows[eng.front.state_by_slot[s].req.rid].append(
                core.logits[s, :V].to(torch.float32, copy=True))
        return out
    core.prefill, core.decode = prefill, decode
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    read = _reset_launches()
    t0 = time.perf_counter()
    rep = eng.run(reqs)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = read()
    stats = eng.kv.stats()
    del eng
    return (outputs, rep, launches, wall,
            torch.cuda.max_memory_allocated() / 2**30, stats, rows)


def windowed_oracle(cfg, params, prompt, forced):
    """``launch.steps``' one-shot windowed path on the engine's stream
    ``forced``: the whole prompt on a slab clamped to the window (its
    tail rolled to the ring slots), then slab ring decode steps fed the
    engine's tokens (teacher forcing, so that each step is held on the
    engine's own history).  Returns each step's logits row, recorded from
    the model calls the steps make."""
    import torch
    from repro_torch.launch.steps import make_decode_step, make_prefill_step
    from repro_torch.models.model import build_model
    model = build_model(cfg, batch=1, seq_len=len(prompt))
    rows = []

    def recording(fn):
        def call(*args, **kwargs):
            out = fn(*args, **kwargs)
            rows.append(out[0][0, :cfg.vocab_size].float())
            return out
        return call
    model.prefill = recording(model.prefill)
    model.decode_step = recording(model.decode_step)
    _, caches, pos, _ = make_prefill_step(
        model, s_max=len(prompt) + len(forced))(
        params, {"tokens": torch.as_tensor(prompt[None],
                                           device=model.device)})
    step = make_decode_step(model)
    for t in forced[:-1]:
        tok = torch.tensor([[t]], dtype=torch.int32, device=model.device)
        _, caches, pos, _ = step(params, tok, caches, pos)
    return rows


def oracle_agreement(stream, rows, eng_rows, wrap_at):
    """Step by step, whether the engine's token is the oracle's argmax on
    the same history, and where not, the oracle's logit gap between its
    top token and the engine's, relative to its largest logit (phase 7's
    near-tie measure); and each step's logits error, the largest
    difference between the engine's logits row and the oracle's relative
    to the oracle's largest logit.  Both are read before and after the
    step whose write first wraps the ring (``wrap_at``; 0 when the prompt
    wrapped it)."""
    import statistics
    agree, gaps, errs = [], [], []
    for i, (t, r, e) in enumerate(zip(stream, rows, eng_rows)):
        top, scale = int(r.argmax()), float(r.abs().max())
        agree.append(top == t)
        errs.append(float((e - r).abs().max()) / scale)
        if top != t:
            gaps.append({"step": i, "engine": t, "oracle": top,
                         "logits_gap_rel": float(r[top] - r[t]) / scale})
    if len(errs) != len(stream):
        raise AssertionError(f"{len(errs)} logits rows for {len(stream)} "
                             f"tokens")
    after, err_after = agree[wrap_at:], errs[wrap_at:]
    return {"steps": len(agree), "agree": sum(agree),
            "agree_after_wrap": sum(after), "steps_after_wrap": len(after),
            "stream_equal": all(agree), "disagreements": gaps,
            "logits_err_max": max(errs),
            "logits_err_median": statistics.median(errs),
            "logits_err_max_before_wrap": max(errs[:wrap_at], default=None),
            "logits_err_median_after_wrap": statistics.median(err_after)}


# (b)'s hold on the windowed oracle, by dtype; logits errors are relative
# to the oracle's largest logit (PERF.md's findings hold the readings
# the bounds were set from).  f32: every step's token is the oracle's
# argmax up to near ties, and the median logits error after the wrap is
# small: ~2e-5 a request, ~1e-3 where a prompt token's router sits on a
# near tie (4e-6 of its logit) that summation order flips, which moves
# every later row a little and can flip a decode token's experts (one
# row wholly different); so the median, not the largest, is bounded.
# bf16, where the kernels and the oracle's plain attention round apart
# and more tokens' experts flip: a floor on the share of steps after the
# wrap that take the oracle's token (0.69-0.94 read) and a bound on the
# median logits error after the wrap (0.020-0.085 read)
RING_GATES = {"float32": {"near_tie": 1e-3,
                          "logits_err_median_after_wrap": 1e-2},
              "bfloat16": {"agree_after_wrap": 0.5,
                           "logits_err_median_after_wrap": 0.25}}


def ring_gate_failures(dtype, agreement):
    """The ways ``oracle_agreement``'s readings miss ``RING_GATES``."""
    g, bad = RING_GATES[dtype], []
    for rid, ag in agreement.items():
        if "near_tie" in g and any(d["logits_gap_rel"] > g["near_tie"]
                                   for d in ag["disagreements"]):
            bad.append(f"request {rid}: a token leaves the oracle's beyond "
                       f"a near tie ({g['near_tie']})")
        share = ag["agree_after_wrap"] / ag["steps_after_wrap"]
        if share < g.get("agree_after_wrap", 0.0):
            bad.append(f"request {rid}: {share:.3f} of the steps after the "
                       f"wrap agree < {g['agree_after_wrap']}")
        med = ag["logits_err_median_after_wrap"]
        if med > g["logits_err_median_after_wrap"]:
            bad.append(f"request {rid}: median logits error after the wrap "
                       f"{med} > {g['logits_err_median_after_wrap']}")
    return bad


def ring_serve(mix, params, tag, *, paged):
    """(b): the ring binding.  Paged: 2 prompts of 4600 past the window,
    M = 4096, whole chains of 256 blocks; slab: a prompt of 4000 on the
    clamped slab with 200 new tokens, so that decode wraps.  Each stream
    is held step by step against ``windowed_oracle`` on its own history,
    tokens and logits rows (``oracle_agreement``); the misses of
    ``RING_GATES`` are returned in the line's ``gate_failures`` for the
    caller to raise once both pools have run.  The gates of the pool's
    dispatch and launches raise here."""
    import numpy as np
    from repro_torch.models.model import build_model
    from repro_torch.serve import Request, engine_config_for
    shape = MIX_RING if paged else MIX_SLAB
    n, L, new = shape["slots"], shape["prompt_len"], shape["new_tokens"]
    ecfg = engine_config_for(
        mix, max_slots=n, prompt_len=L, max_new_tokens=new,
        prefill_chunk=shape["prefill_chunk"], paged=paged,
        kv_block_size=shape.get("block_size", 16))
    model = build_model(mix, batch=n, seq_len=ecfg.max_seq_len)
    rng = np.random.default_rng(31 + paged)
    reqs = [Request(rid=i, tokens=rng.integers(0, mix.vocab_size, (L,)),
                    max_new_tokens=new) for i in range(n)]
    outputs, rep, launches, wall, peak, stats, eng_rows = _serve_streams(
        model, params, ecfg, reqs)
    t0 = time.perf_counter()
    wrap_at = max(0, mix.sliding_window - L)      # decode step that wraps
    agreement = {}
    for r in reqs:
        rows = windowed_oracle(mix, params, r.tokens, outputs[r.rid])
        agreement[r.rid] = oracle_agreement(outputs[r.rid], rows,
                                            eng_rows[r.rid], wrap_at)
        del rows
    del eng_rows
    oracle_s = time.perf_counter() - t0
    steps = rep["decode_steps"] + rep["prefill_chunks"]
    dispatch = {b: d["fused"] for b, d in rep["attention_dispatch"].items()}
    line = {"model": f"{mix.name} ({mix.num_layers} of 32 layers)",
            "dtype": mix.dtype, "pool": stats["kind"],
            "window": mix.sliding_window,
            "requests": rep["n_requests"], "prompt_len": L,
            "tokens_out": rep["total_new_tokens"],
            "ttft_p50_s": rep["ttft"]["p50"], "tpot_p50_s": rep["tpot"]["p50"],
            "tpot_p90_s": rep["tpot"]["p90"], "wall_s": wall,
            "oracle_s": oracle_s, "peak_mem_gib": peak,
            "decode_steps": rep["decode_steps"],
            "prefill_chunks": rep["prefill_chunks"], "state_pool": stats,
            "kv_capacity": rep["engine"]["kv_capacity"],
            "attention_dispatch": dispatch, "launches": launches,
            "oracle": agreement,
            "gate_failures": ring_gate_failures(mix.dtype, agreement)}
    log(f"[{tag}] {json.dumps(line)}")
    check_one_capture(tag, rep)
    if rep["n_requests"] != n or any(len(outputs[r.rid]) != new
                                     for r in reqs):
        raise AssertionError(f"[{tag}] not every request finished its "
                             f"{new} tokens")
    want_launch = {"moe_gmm": mix.num_layers * steps,
                   "paged_attention": 0 if paged
                   else mix.num_layers * rep["prefill_chunks"],
                   "flash_attention": 0,
                   "schedule": mix.num_layers * steps}
    if launches != want_launch:
        raise AssertionError(f"[{tag}] launches {launches} != {want_launch}")
    if paged:
        if not (stats["window_ring"] and stats["ring_full_chain"]
                and stats["ring_tokens"] == 4096
                and stats["blocks_per_slot"] == 256):
            raise AssertionError(f"[{tag}] the ring did not engage: {stats}")
        want_dispatch = {"prefill_continue": False, "decode_ring": False}
    else:
        if rep["engine"]["kv_capacity"] != mix.sliding_window:
            raise AssertionError(f"[{tag}] slab not clamped to the window")
        want_dispatch = {"prefill_continue": True, "decode_slab": False}
    if dispatch != want_dispatch:
        raise AssertionError(f"[{tag}] dispatch {dispatch} != "
                             f"{want_dispatch}")
    return line


def raise_ring_failures(lines):
    bad = [f"[{tag}] {f}" for tag, line in lines.items()
           for f in line["gate_failures"]]
    if bad:
        raise AssertionError("(b)'s rings leave the windowed oracle: "
                             + "; ".join(bad))


def mixtral_ep_serve(mix, params):
    """(c): G = 4 on ``VirtualGroup(4)`` under 0.9 skew with harmoeny
    (phase 4b's ``ep_serve``), plus the hosted gather's bytes: each call
    of a layer gathers G x K rows of each expert matrix."""
    rec = ep_serve(mix, params, "harmoeny", seed=0, **MIX_EP)
    K = mix.moe.num_foreign_slots
    row_bytes = mix.d_model * mix.moe.d_ff_expert * 2
    per_call = EP_DEGREE * K * 3 * row_bytes
    calls = mix.num_layers * (rec["decode_steps"] + rec["prefill_chunks"])
    rec.update(model=f"{mix.name} ({MIXTRAL_LAYERS} of 32 layers)",
               fetch_rows_per_layer_call=EP_DEGREE * K * 3,
               fetch_row_mb=row_bytes / 1e6,
               fetch_bytes_per_layer_call=per_call,
               fetch_bytes_total=per_call * calls)
    log(f"[mixtral-ep] {json.dumps(rec)}")
    if any(v != 0 for ph in rec["drops"].values() for v in ph):
        raise AssertionError(f"[mixtral-ep] dropped units: {rec['drops']}")
    if rec["moved_units_per_layer_decode"] <= 0:
        raise AssertionError("[mixtral-ep] harmoeny moved no unit at decode")
    if rec["launches"]["moe_gmm"] != EP_DEGREE * calls:
        raise AssertionError(f"[mixtral-ep] moe_gmm launched "
                             f"{rec['launches']['moe_gmm']} times, not "
                             f"{EP_DEGREE * calls}")
    return rec


def small_mixtral_reference_check(*, ep_degree, paged, seed=0) -> None:
    """(d): reduced mixtral-8x7b in f32 (window 64) with learned routing
    (q = 1 at G = 4), prompts past the window (paged: the ring) or up to
    it with decode wrapping the clamped slab: the card's greedy streams
    equal the CPU plain versions'."""
    import dataclasses
    import numpy as np
    from repro_torch.configs.registry import get_config
    from repro_torch.models.model import build_model
    from repro_torch.serve import Request, ServeEngine, VirtualClock, \
        engine_config_for
    cfg = get_config("mixtral-8x7b").reduced()
    cfg = dataclasses.replace(cfg, moe=dataclasses.replace(cfg.moe,
                                                           q_tokens=1))
    L, new = (100, 8) if paged else (64, 16)
    rng = np.random.default_rng(seed)
    prompts = [rng.integers(0, cfg.vocab_size, (int(rng.integers(40, L)),))
               for _ in range(4)]
    params = build_model(cfg, batch=3, seq_len=L, device="cpu",
                         ep_degree=ep_degree).init(seed)
    streams, ring = {}, {}
    for dev in ("cpu", "cuda"):
        model = build_model(cfg, batch=3, seq_len=L, device=dev,
                            ep_degree=ep_degree)
        ecfg = engine_config_for(cfg, max_slots=3, prompt_len=L,
                                 max_new_tokens=new, prefill_chunk=16,
                                 paged=paged, kv_block_size=16)
        eng = ServeEngine(model, _to(params, dev), ecfg,
                          clock=VirtualClock(0.1), device=dev)
        out = {}
        orig = eng._finish

        def capture(st, now, out=out, orig=orig):
            out[st.req.rid] = list(st.output)
            orig(st, now)
        eng._finish = capture
        rep = eng.run([Request(rid=i, tokens=p, max_new_tokens=new)
                       for i, p in enumerate(prompts)])
        streams[dev] = out
        ring[dev] = rep["state_pool"].get("window_ring", False)
    pool = "paged" if paged else "slab"
    if streams["cpu"] != streams["cuda"] or ring["cuda"] != paged:
        raise AssertionError(f"small mixtral reference (G = {ep_degree}, "
                             f"{pool}): card streams {streams['cuda']} != "
                             f"cpu streams {streams['cpu']} (ring "
                             f"{ring})")
    log(f"[reference] reduced mixtral-8x7b f32, window 64, G = {ep_degree}, "
        f"{pool}{' (ring)' if paged else ' (clamped, decode wraps)'}: "
        f"{len(prompts)} greedy streams on the card equal the CPU "
        f"plain-version streams")


def mixtral_path():
    """Phase 11: full-width mixtral-8x7b cut to ``MIXTRAL_LAYERS`` layers,
    weights drawn once for (a)-(c); then (d).  Returns the summaries."""
    import torch
    from repro_torch.models.model import build_model
    mix = mixtral_config()
    log(f"[mixtral] {mix.name} cut to {MIXTRAL_LAYERS} of 32 layers: the "
        f"full depth's ~87 GiB of bf16 weights do not fit the card's 80 GB")
    t0 = time.perf_counter()
    params = build_model(mix, batch=MIX_A["slots"],
                         seq_len=MIX_A["max_seq_len"]).init(0)
    torch.cuda.synchronize()
    n_params = sum(t.numel() for t in _leaves(params))
    log(f"[mixtral] {n_params / 1e9:.2f} B parameters drawn on the card in "
        f"{time.perf_counter() - t0:.1f} s "
        f"({torch.cuda.memory_allocated() / 2**30:.1f} GiB)")
    out = {"serve": pattern_serve(mix, params, "mixtral", paged=True,
                                  seed=0, **MIX_A)}
    out["ring_paged"] = ring_serve(mix, params, "mixtral-ring", paged=True)
    out["ring_slab"] = ring_serve(mix, params, "mixtral-ring-slab",
                                  paged=False)
    raise_ring_failures({"mixtral-ring": out["ring_paged"],
                         "mixtral-ring-slab": out["ring_slab"]})
    out["ep"] = mixtral_ep_serve(mix, params)
    # the same rings on the same 8 layers and weights in f32: the one
    # change is the precision, which tells bf16 rounding (the kernels and
    # the oracle's plain attention round apart, and some tokens' top-2
    # experts flip) from a fault of the 8-layer path.  The bf16 weights go
    # as the f32 ones come (44.2 GiB)
    gc.collect()
    torch.cuda.empty_cache()
    _cast_(params, torch.float32)
    f32 = mix.replace(dtype="float32")
    out["ring_paged_f32"] = ring_serve(f32, params, "mixtral-ring-f32",
                                       paged=True)
    out["ring_slab_f32"] = ring_serve(f32, params, "mixtral-ring-slab-f32",
                                      paged=False)
    raise_ring_failures({"mixtral-ring-f32": out["ring_paged_f32"],
                         "mixtral-ring-slab-f32": out["ring_slab_f32"]})
    del params
    gc.collect()
    torch.cuda.empty_cache()
    for ep_degree in (1, EP_DEGREE):
        for paged in (False, True):
            small_mixtral_reference_check(ep_degree=ep_degree, paged=paged)
    return out


# ----------------------------------------------------------------------
# phase 12: prefix sharing and speculative decoding on the paged pool
# ----------------------------------------------------------------------
# full-width qwen15-moe-a27b, paged, 16-token blocks, chunk 32, 4 slots
PS = dict(slots=4, prefill_chunk=32, block_size=16)
# (a): 8 prompts of 576-640 tokens sharing their first 512, 32 new tokens
PREFIX_A = dict(n_requests=8, prompt_lens=(576, 640), shared=512,
                new_tokens=32)
# (b): 4 prompts of 128 tokens, each tiling a 16-token motif, 64 new
SPEC_B = dict(n_requests=4, prompt_len=128, motif=16, new_tokens=64, k=4,
              temperature=0.8, top_k=50, sampled_new_tokens=32)
# (c): 2 prompts of 64-128 tokens, 8 new, on 4 virtual EP ranks
SPEC_C = dict(n_requests=2, prompt_lens=(64, 129), new_tokens=8, k=4)


def prefix_spec_kernel_parity(cfg):
    """Phase 2's cases at phase 12's shapes: ``paged_attention`` at (b)'s
    verify window (B 4, S k + 1 = 5, chains of 128-192 positions) and at
    (a)'s prefix-tail chunk (S 32 starting at position 512, over the
    704-position scratch viewed as a pool), and ``moe_gmm`` at the verify
    step's B (k + 1) = 20 tokens x top-4 of 60 experts."""
    import numpy as np
    import torch
    from repro_torch.core.moe_layer import MoEBlockSpec
    from repro_torch.kernels.paged_attention.ops import largest_block_divisor
    from repro_torch.serve.engine import paged_pool_len
    out = {"moe_gmm": [], "paged_attention": []}
    H, Hkv, hd = cfg.num_heads, cfg.num_kv_heads, cfg.resolved_head_dim
    bf, bs, C = torch.bfloat16, PS["block_size"], PS["prefill_chunk"]
    b, S = SPEC_B, SPEC_B["k"] + 1
    s_spec = paged_pool_len(b["prompt_len"] + b["new_tokens"], C, False,
                            b["k"])
    out["paged_attention"].append(paged_attention_case(
        "verify", B=PS["slots"], S=S, H=H, Hkv=Hkv, hd=hd, bs=bs,
        lengths=[133, 150, 171, 192], n_blocks=-(-s_spec // bs),
        softcap=0.0, dtype=bf, seed=41, time_it=True))
    a = PREFIX_A
    s_pre = paged_pool_len(a["prompt_lens"][1] + a["new_tokens"], C, True)
    bs_slab = largest_block_divisor(s_pre)
    out["paged_attention"].append(paged_attention_case(
        "prefix_tail_chunk", B=1, S=C, H=H, Hkv=Hkv, hd=hd, bs=bs_slab,
        lengths=[a["shared"] + C], n_blocks=s_pre // bs_slab, softcap=0.0,
        dtype=bf, seed=42, time_it=True, slab=True))
    tokens = PS["slots"] * S
    spec = MoEBlockSpec(moe=cfg.moe, d_model=cfg.d_model,
                        tokens_local=tokens, block_m=128)
    E = cfg.moe.num_experts
    units = np.random.default_rng(43).integers(
        0, E, tokens * cfg.moe.num_experts_per_tok)
    sizes = (np.bincount(units, minlength=E).tolist()
             + [0] * cfg.moe.num_foreign_slots)
    out["moe_gmm"].append(moe_gmm_case(
        "verify", sizes, M=spec.c_total, n_local=E, d=cfg.d_model,
        f=cfg.moe.d_ff_expert, block_m=128, dtype=bf, seed=44,
        time_it=True))
    for name, recs in out.items():
        for r in recs:
            log(f"[parity] {name} {json.dumps(r)}")
    return out


def _ps_engine_cfg(cfg, *, prompt_len, new_tokens, **kw):
    from repro_torch.serve import engine_config_for
    # strict, as the JAX engine's fused flags make a step: a branch with
    # no kernel raises
    return engine_config_for(
        cfg, max_slots=PS["slots"], prompt_len=prompt_len,
        max_new_tokens=new_tokens, prefill_chunk=PS["prefill_chunk"],
        paged=True, kv_block_size=PS["block_size"],
        fused_paged_attention=True, fused_moe_gmm=True, **kw)


def ps_serve(cfg, params, ecfg, windows, *, ep_degree=1, rows=False,
             forced=None, eager=False, keep=False, proposer=None):
    """Serve ``windows`` (lists of requests, one ``run`` each, the
    metrics reset between them) on one warmed-up engine.  With ``rows``
    the logits row every token was taken from is kept by request, on the
    card in f32: a prompt's last chunk's row, then its slot's row of each
    decode step.  ``forced`` ({rid: a reference stream}) teacher-forces a
    speculative engine drafting with ``StreamDrafts(corrupt=False)``:
    every prompt's first token and every verify window's tokens are the
    reference's, each window's rows are kept by the position they predict
    (``rows``), and the streams are the reference's by construction.
    Returns the streams, the reports, the launches over all windows, wall
    s, peak GiB, the rows, and the engine when ``keep``."""
    import numpy as np
    import torch
    from repro_torch.models.model import build_model
    from repro_torch.serve import ServeEngine, stepcore
    from repro_torch.serve import engine as engine_module
    model = build_model(cfg, batch=PS["slots"], seq_len=ecfg.max_seq_len,
                        ep_degree=ep_degree)
    ctx = stepcore.eager() if eager else contextlib.nullcontext()
    verify = engine_module.greedy_verify
    with ctx:
        eng = ServeEngine(model, params, ecfg)
        if proposer is not None:
            eng._proposer = proposer
        t0 = time.perf_counter()
        eng.warmup()
        warm_s = time.perf_counter() - t0
        outputs, kept, answers = {}, {}, []
        core, V, finish = eng.core, cfg.vocab_size, eng._finish

        def capture(st, now):
            outputs[st.req.rid] = list(st.output)
            finish(st, now)
        eng._finish = capture

        def keep_row(rid, pos, row):
            kept.setdefault(rid, {})[pos] = row[:V].to(torch.float32,
                                                        copy=True)
        if rows or forced:
            def prefill_result(orig=core.prefill_result):
                first, packed = orig()
                st = eng.front.pf
                if st.prefill_done and not st.resumed:
                    keep_row(st.req.rid, 0, core._pf_logits[0])
                    if forced:
                        first = forced[st.req.rid][0]
                return first, packed

            def decode(*args, orig=core.decode):
                out = orig(*args)
                k = eng.ecfg.speculative_k
                for s in np.nonzero(eng.active)[0]:
                    st = eng.front.state_by_slot[s]
                    i = len(st.output)
                    if not k:
                        keep_row(st.req.rid, i, core.logits[s])
                        continue
                    n = min(k, st.req.max_new_tokens - i - 1)
                    for j in range(n + 1):
                        keep_row(st.req.rid, i + j, core.logits[s, j])
                    if forced:
                        answers.append((n, forced[st.req.rid][i + n]))
                return out
            core.prefill_result, core.decode = prefill_result, decode
        if forced:
            engine_module.greedy_verify = lambda logits, drafts: \
                answers.pop(0)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        read = _reset_launches()
        reps = []
        t0 = time.perf_counter()
        try:
            for i, reqs in enumerate(windows):
                if i:
                    eng.reset_metrics()
                reps.append(eng.run(reqs))
        finally:
            engine_module.greedy_verify = verify
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches = read()
    out = {"outputs": outputs, "reps": reps, "launches": launches,
           "wall_s": wall, "warmup_s": warm_s,
           "peak_mem_gib": torch.cuda.max_memory_allocated() / 2**30,
           "rows": {rid: [r[p] for p in sorted(r)] for rid, r in kept.items()},
           "moved": _foreign_rows()}
    if keep:
        out["engine"] = eng
    return out


def parting(ref, other, rows):
    """Where ``other``'s streams part from the reference's: by request, the
    first differing position, both tokens, and the reference's logit gap
    between them relative to its largest logit (``rows``: the reference's
    logits rows, one a position)."""
    out = {}
    for rid, want in ref.items():
        got = other.get(rid)
        if got == want:
            continue
        if not got:
            out[rid] = {"step": 0, "missing": True, "gap_rel": None}
            continue
        i = next((j for j, (a, b) in enumerate(zip(want, got)) if a != b),
                 min(len(want), len(got)))
        rec = {"step": i, "reference": want[i] if i < len(want) else None,
               "other": got[i] if i < len(got) else None, "gap_rel": None}
        if rec["other"] is not None and rec["reference"] is not None:
            r = rows[rid][i]
            rec["gap_rel"] = float(r[rec["reference"]] - r[rec["other"]]) \
                / float(r.abs().max())
        out[rid] = rec
    return out


def teacher_forced(ref, ref_rows, forced_rows):
    """A teacher-forced run's rows against the reference's, position by
    position (the same history at every position): by request, the share
    of positions whose argmax is the reference's token, the logit gaps
    (relative to the reference's largest logit) where not, and the median
    and largest logits error, each row's largest difference from the
    reference's row over the reference's largest logit."""
    import statistics
    out = {}
    for rid, want in ref.items():
        agree, gaps, errs = 0, [], []
        for i, (r, e) in enumerate(zip(ref_rows[rid], forced_rows[rid])):
            scale = float(r.abs().max())
            errs.append(float((e - r).abs().max()) / scale)
            t = int(e.argmax())
            if t == want[i]:
                agree += 1
            else:
                gaps.append(float(r[want[i]] - r[t]) / scale)
        if len(errs) != len(want):
            raise AssertionError(f"{len(errs)} teacher-forced rows for "
                                 f"{len(want)} tokens")
        out[rid] = {"positions": len(errs), "agree": agree,
                    "gaps": sorted(gaps, reverse=True)[:4],
                    "logits_err_median": statistics.median(errs),
                    "logits_err_max": max(errs)}
    return out


def _near_ties(parts):
    """Whether every parting is at a near tie of the reference's logits
    (f32, where a bf16 stream parted)."""
    bound_rel = FORCED_GATES["float32"]["near_tie"]
    return all(p.get("gap_rel") is not None and p["gap_rel"] <= bound_rel
               for p in parts.values())


def _check_budgets(tag, outputs, reqs, vocab):
    for r in reqs:
        toks = outputs.get(r.rid)
        if toks is None or len(toks) != r.max_new_tokens \
                or not all(0 <= t < vocab for t in toks):
            raise AssertionError(f"[{tag}] request {r.rid}: stream {toks} "
                                 f"misses its budget of {r.max_new_tokens} "
                                 f"tokens in the vocabulary")


def _launch_gate(tag, cfg, launches, steps, *, ep_degree=1):
    """Each kernel once per layer (and rank, for ``moe_gmm`` and
    ``schedule``) a prefill chunk, decode step or verify step; the
    schedule under harmoeny only."""
    L = cfg.num_layers
    harmoeny = cfg.moe.policy == "harmoeny"
    want = {"moe_gmm": ep_degree * L * steps, "paged_attention": L * steps,
            "flash_attention": 0,
            "schedule": ep_degree * L * steps * harmoeny}
    if launches != want:
        raise AssertionError(f"[{tag}] launches {launches} != {want} "
                             f"({L} layers, {steps} chunks and steps)")


PREFIX_ENTRIES = {"prefill_chunk": 1, "decode": 1, "write_blocks": 1,
                  "gather_prefix": 1, "copy_block": 1}


def prefix_requests(cfg):
    """(a)'s windows: request 0 alone, then 1-7, then a ninth whose prompt
    is request 0's again.  Request 0's prompt is cut to a multiple of the
    block size, so that the ninth is a full-prompt hit."""
    from repro_torch.serve import Request, poisson_requests
    a = PREFIX_A
    reqs = poisson_requests(a["n_requests"], rate=0.0,
                            vocab_size=cfg.vocab_size,
                            prompt_len=a["prompt_lens"][1],
                            max_new_tokens=a["new_tokens"], seed=0,
                            prompt_len_range=a["prompt_lens"],
                            shared_prefix_len=a["shared"])
    bs = PS["block_size"]
    r0 = reqs[0]
    r0 = Request(rid=0, tokens=r0.tokens[:len(r0.tokens) // bs * bs],
                 max_new_tokens=a["new_tokens"])
    again = Request(rid=a["n_requests"], tokens=r0.tokens.copy(),
                    max_new_tokens=a["new_tokens"])
    return [[r0], reqs[1:], [again]]


def prefix_serve(cfg, params):
    """(a): sharing on, then off, on the same weights.  The run without
    sharing asks for 32 more positions (unused), so that both pools have
    704-position chains and the kernels the same launch plans."""
    a = PREFIX_A
    windows = prefix_requests(cfg)
    L = a["prompt_lens"][1]
    on = ps_serve(cfg, params, _ps_engine_cfg(
        cfg, prompt_len=L, new_tokens=a["new_tokens"], prefix_sharing=True),
        windows, keep=True)
    off = ps_serve(cfg, params, _ps_engine_cfg(
        cfg, prompt_len=L, new_tokens=a["new_tokens"]
        + PS["prefill_chunk"]), windows, rows=True)
    return windows, on, off


def prefix_line(cfg, windows, on, off):
    """(a)'s ``[prefix]`` line, the captured gather's and copy's device ms
    against their bytes, and the gates (other than the streams')."""
    import numpy as np
    import torch
    tag = f"prefix {cfg.dtype}"
    eng = on.pop("engine")
    kv = eng.kv
    reqs = [r for w in windows for r in w]
    cached = {r["rid"]: r["cached_prefix_tokens"]
              for rep in on["reps"] for r in rep["requests"]}
    prompt = {r.rid: r.prompt_len for r in reqs}
    chunks = [rep["prefill_chunks"] for rep in on["reps"]]
    phases = {}
    for rep in on["reps"]:
        for ph, sec in rep["phases"].items():
            p = phases.setdefault(ph, {"steps": 0, "tokens": 0,
                                       "seconds": 0.0})
            for key in p:
                p[key] += sec[key]
    # the captured gather (512 cached positions of a 44-block chain) and
    # copy (one block), replayed on their own after the run
    esz = 2 if cfg.dtype == "bfloat16" else 4
    tok_bytes = 2 * cfg.num_layers * cfg.num_kv_heads \
        * cfg.resolved_head_dim * esz
    h = kv._gather_in.fill()
    h[:-1] = np.arange(1, kv.blocks_per_slot + 1)
    h[-1] = a_shared = PREFIX_A["shared"]
    kv._gather_in.push()
    gather_ms = device_ms(lambda: kv.gather_entry(kv.pool, kv.scratch), 10)
    kv._copy_in.fill()[:] = (1, 2)
    kv._copy_in.push()
    copy_ms = device_ms(lambda: kv.copy_entry(kv.pool), 10)
    g_bytes = 2 * a_shared * tok_bytes          # read the pool, write
    c_bytes = 2 * PS["block_size"] * tok_bytes
    w2 = on["reps"][1]
    line = {
        "model": cfg.name, "dtype": cfg.dtype, "ep_degree": 1,
        "requests": len(reqs), "windows": [len(w) for w in windows],
        "ttft_p50_s": w2["ttft"]["p50"], "ttft_p90_s": w2["ttft"]["p90"],
        "tpot_p50_s": w2["tpot"]["p50"],
        "ttft_p50_s_sharing_off": off["reps"][1]["ttft"]["p50"],
        "ttft_p90_s_sharing_off": off["reps"][1]["ttft"]["p90"],
        "tpot_p50_s_sharing_off": off["reps"][1]["tpot"]["p50"],
        "prefix_hit_rate": (sum(cached.values())
                            / sum(prompt.values())),
        "prefix_hit_rate_by_window": [rep["prefix_hit_rate"]
                                      for rep in on["reps"]],
        "cached_prefix_tokens": cached, "prompt_tokens": prompt,
        "cow_copies": sum(rep["cow_copies"] for rep in on["reps"]),
        "evictions": sum(rep["evictions"] for rep in on["reps"]),
        "prefill_chunks": sum(chunks),
        "prefill_chunks_sharing_off": sum(rep["prefill_chunks"]
                                          for rep in off["reps"]),
        "phases": phases,
        "decode_steps": sum(rep["decode_steps"] for rep in on["reps"]),
        "peak_mem_gib": on["peak_mem_gib"],
        "peak_mem_gib_sharing_off": off["peak_mem_gib"],
        "wall_s": on["wall_s"], "wall_s_sharing_off": off["wall_s"],
        "launches": on["launches"],
        "jit_entries": on["reps"][-1]["jit_entries"],
        "gather_prefix": {"tokens": a_shared, "ms": gather_ms,
                          "bytes": g_bytes,
                          "bound_ms": g_bytes / HBM_BYTES_S * 1e3,
                          "bytes_touched": 3 * kv.s_pad * tok_bytes},
        "copy_block": {"ms": copy_ms, "bytes": c_bytes,
                       "bound_ms": c_bytes / HBM_BYTES_S * 1e3},
        "attention_dispatch": {b: d["fused"] for b, d in
                               on["reps"][-1]["attention_dispatch"].items()},
    }
    del eng, kv
    log(f"[prefix] {json.dumps(line)}")
    for run, tagged in ((on, tag), (off, f"{tag} sharing off")):
        _check_budgets(tagged, run["outputs"], reqs, cfg.vocab_size)
        steps = sum(rep["prefill_chunks"] + rep["decode_steps"]
                    for rep in run["reps"])
        _launch_gate(tagged, cfg, run["launches"], steps)
    short = [r.rid for r in windows[1] if cached[r.rid] < PREFIX_A["shared"]]
    if short:
        raise AssertionError(f"[{tag}] requests {short} start from fewer "
                             f"than {PREFIX_A['shared']} cached tokens: "
                             f"{cached}")
    if line["cow_copies"] < 1:
        raise AssertionError(f"[{tag}] no copy-on-write block copy")
    for rep in on["reps"]:
        if rep["jit_entries"] != PREFIX_ENTRIES \
                or rep.get("recompiled_after_warmup") is not False:
            raise AssertionError(f"[{tag}] jit_entries {rep['jit_entries']}"
                                 f", recompiled_after_warmup "
                                 f"{rep.get('recompiled_after_warmup')}")
    if "prefix_tail" not in phases:
        raise AssertionError(f"[{tag}] no prefix-tail chunk ran")
    return line


def spec_requests(cfg, *, new_tokens=None):
    """(b)'s prompts: 128 tokens, each tiling a 16-token motif."""
    import numpy as np
    from repro_torch.serve import Request
    b = SPEC_B
    rng = np.random.default_rng(12)
    return [Request(rid=i, tokens=np.tile(
        rng.integers(0, cfg.vocab_size, (b["motif"],)),
        b["prompt_len"] // b["motif"]),
        max_new_tokens=new_tokens or b["new_tokens"])
        for i in range(b["n_requests"])]


def step_timing(eng, cfg, reqs, tag):
    """Every slot decoding: one decode (or verify) step under the profiler
    and three without; with speculation, the device ms of the verify
    logits' one copy to pinned host memory.  While the slots fill, the
    engine drafts nothing, so that no request finishes before the last
    one joins."""
    from repro_torch.profiling import profile_steps, untraced_ms
    proposer = getattr(eng, "_proposer", None)
    if proposer is not None:
        eng._proposer = NoDrafts()
    for r in reqs:
        eng.submit(r)
    while not eng.active.all():
        eng.step()
    eng._proposer = proposer

    def step():
        eng._decode_work(eng.clock.now())
    prof = profile_steps(step, 1, tag)
    out = {"wall_ms": untraced_ms(step, 3),
           "traced_wall_ms": prof["wall_ms_per_step"],
           "busy_ms": prof["device_busy_ms_per_step"],
           "idle_share": prof["device_idle_share"],
           "kernel_calls": prof["kernel_calls_per_step"],
           "host_launches": prof["host_launches_per_step"]
           + prof["graph_launches_per_step"],
           "top_kernels_ms": prof["top_kernels_ms_per_step"][:4]}
    core = eng.core
    if core.spec:
        packed = core.decode_entry._out[0]
        buf = core._h_out[packed.numel()]
        out["logits_d2h_ms"] = device_ms(
            lambda: buf.copy_(packed, non_blocking=True), 10)
        out["logits_d2h_bytes"] = packed.numel() * 4
    return out


class NoDrafts:
    """A draft proposer that proposes nothing."""

    def propose(self, context, k):
        import numpy as np
        return np.zeros((0,), np.int32)


class StreamDrafts:
    """A draft proposer (``serve/speculative.py``'s ``propose(context, k)``
    contract) that proposes a reference run's own next tokens; with
    ``corrupt`` the last draft of every third window is made wrong.
    Random weights do not follow the motifs, so the n-gram proposer
    drafts almost nothing at full width; these drafts make the verify
    step accept, commit several tokens a step and reject all the same
    (and, uncorrupted, teacher-force it: ``ps_serve(forced=...)``)."""

    def __init__(self, prompts, streams, vocab, corrupt=True):
        self.by_prompt = [(tuple(int(t) for t in p), s)
                          for p, s in zip(prompts, streams)]
        self.vocab, self.corrupt = vocab, corrupt
        self.calls = 0

    def propose(self, context, k):
        import numpy as np
        prompt, stream = next(
            (p, s) for p, s in self.by_prompt
            if tuple(int(t) for t in context[:len(p)]) == p)
        i = len(context) - len(prompt)
        drafts = np.asarray(stream[i:i + k], np.int32).copy()
        self.calls += 1
        if self.corrupt and drafts.size and self.calls % 3 == 0:
            drafts[-1] = (drafts[-1] + 1) % self.vocab
        return drafts


SPEC_RUNS = ("k0", "k4", "k4_sampled", "k4_forced")


def spec_serve(cfg, params, tags=SPEC_RUNS, *, timing=True):
    """(b): k = 0 greedy (its logits rows kept), k = 4 greedy (ngram),
    k = 4 sampled, k = 4 drafting k = 0's own tokens with every third
    window's last draft wrong (``StreamDrafts``), and k = 4 teacher-forced
    on k = 0's stream, on the same weights; each run's step timing with
    every slot decoding."""
    b = SPEC_B
    spec = dict(speculative_k=b["k"])
    kws = {"k0": {}, "k4": spec, "k4_stream_drafts": spec,
           "k4_forced": spec,
           "k4_sampled": dict(spec, temperature=b["temperature"],
                              top_k=b["top_k"])}
    reqs = spec_requests(cfg)
    runs = {}
    for tag in tags:
        ecfg = _ps_engine_cfg(cfg, prompt_len=b["prompt_len"],
                              new_tokens=b["new_tokens"], **kws[tag])
        proposer, forced = None, None
        if tag in ("k4_stream_drafts", "k4_forced"):
            ref = runs["k0"]["outputs"]
            proposer = StreamDrafts([r.tokens for r in reqs],
                                    [ref[r.rid] for r in reqs],
                                    cfg.vocab_size,
                                    corrupt=tag == "k4_stream_drafts")
            forced = ref if tag == "k4_forced" else None
        reqs_run = spec_requests(cfg, new_tokens=(
            b["sampled_new_tokens"] if tag == "k4_sampled" else None))
        run = ps_serve(cfg, params, ecfg, [reqs_run],
                       rows=tag == "k0", forced=forced, keep=True,
                       proposer=proposer)
        eng = run.pop("engine")
        if timing and tag in ("k0", "k4"):
            # fresh rids for the timing window's slots
            window = spec_requests(cfg)
            for r in window:
                r.rid += 100
            run["step"] = step_timing(eng, cfg, window,
                                      f"spec_{tag}_{cfg.dtype}")
        del eng
        gc.collect()
        runs[tag] = run
    return runs


def spec_line(cfg, runs):
    tag = f"spec {cfg.dtype}"
    reqs = spec_requests(cfg)
    line = {"model": cfg.name, "dtype": cfg.dtype, "ep_degree": 1,
            "requests": len(reqs), "prompt_len": SPEC_B["prompt_len"],
            "new_tokens": SPEC_B["new_tokens"], "k": SPEC_B["k"]}
    for name, run in runs.items():
        rep = run["reps"][0]
        sp = rep.get("speculative") or {}
        line[name] = {
            "tpot_p50_s": rep["tpot"]["p50"], "ttft_p50_s": rep["ttft"]["p50"],
            "throughput_tok_s": rep["throughput_tok_s"],
            "decode_steps": rep["decode_steps"],
            "prefill_chunks": rep["prefill_chunks"],
            "acceptance_rate": sp.get("acceptance_rate"),
            "tokens_per_slot_step": sp.get("tokens_per_step"),
            "verify_steps": sp.get("steps"), "drafted": sp.get("drafted"),
            "accepted": sp.get("accepted"),
            "peak_mem_gib": run["peak_mem_gib"], "launches": run["launches"],
            "jit_entries": rep["jit_entries"],
            "attention_dispatch": {b: d["fused"] for b, d in
                                   rep["attention_dispatch"].items()},
            "step": run.get("step")}
    log(f"[spec] {json.dumps(line)}")
    entries = {"prefill_chunk": 1, "decode": 1, "write_blocks": 1}
    for name, run in runs.items():
        rep = run["reps"][0]
        _check_budgets(f"{tag} {name}", run["outputs"], spec_requests(
            cfg, new_tokens=(SPEC_B["sampled_new_tokens"]
                             if name == "k4_sampled" else None)),
            cfg.vocab_size)
        if rep["jit_entries"] != entries \
                or rep.get("recompiled_after_warmup") is not False:
            raise AssertionError(f"[{tag} {name}] jit_entries "
                                 f"{rep['jit_entries']}")
        _launch_gate(f"{tag} {name}", cfg, run["launches"],
                     rep["prefill_chunks"] + rep["decode_steps"])
        want = {"prefill_continue": True,
                ("verify" if name != "k0" else "decode"): True}
        got = {b: d["fused"] for b, d in rep["attention_dispatch"].items()}
        if got != want:
            raise AssertionError(f"[{tag} {name}] dispatch {got} != {want}")
        if name != "k0" and not rep["speculative"]["steps"]:
            raise AssertionError(f"[{tag} {name}] no verify step ran")
    drafted = runs.get("k4_stream_drafts")
    if drafted is not None:
        sp = drafted["reps"][0]["speculative"]
        if not 0 < sp["accepted"] < sp["drafted"]:
            raise AssertionError(f"[{tag}] the drafted run accepted "
                                 f"{sp['accepted']} of {sp['drafted']}: "
                                 f"both acceptance and rejection must run")
    return line


SPEC_EP_RUNS = ("skew_k4", "skew_k0", "learned_k0", "learned_k4_forced")


def spec_ep_serve(cfg, params, tags=SPEC_EP_RUNS, *, eager=False):
    """(c): k = 4 against k = 0 on ``VirtualGroup(4)`` under 0.9 skew,
    harmoeny, q = 1; then with the learned router (harmoeny, q = 1),
    where the streams depend on the tokens only, k = 0 (its rows kept)
    and k = 4 teacher-forced on k = 0's stream.  (The synthetic skew
    draws a fresh assignment a call, B (k + 1) tokens' worth in a verify
    step and B in a decode step, so k = 4 and k = 0 route apart by
    construction, in JAX as here.)  ``eager``: every run eager (no graph
    pools: the f32 rerun's memory)."""
    import dataclasses
    import numpy as np
    import torch
    from repro_torch.serve import Request
    c = SPEC_C
    rng = np.random.default_rng(21)
    reqs = [Request(rid=i, tokens=rng.integers(
        0, cfg.vocab_size, (int(rng.integers(*c["prompt_lens"])),)),
        max_new_tokens=c["new_tokens"]) for i in range(c["n_requests"])]
    skew = ep_moe_config(cfg)
    learned = dataclasses.replace(skew, moe=dataclasses.replace(
        skew.moe, router_skew=0.0))
    runs = {}
    for tag in tags:
        mcfg = skew if tag.startswith("skew") else learned
        k = 0 if tag.endswith("k0") else c["k"]
        ecfg = _ps_engine_cfg(mcfg, prompt_len=c["prompt_lens"][1],
                              new_tokens=c["new_tokens"], speculative_k=k,
                              moe_policy="harmoeny")
        proposer = forced = None
        if tag == "learned_k4_forced":
            forced = runs["learned_k0"]["outputs"]
            proposer = StreamDrafts(
                [r.tokens for r in reqs], [forced[r.rid] for r in reqs],
                cfg.vocab_size, corrupt=False)
        runs[tag] = ps_serve(mcfg, params, ecfg, [reqs],
                             ep_degree=EP_DEGREE,
                             eager=eager,
                             rows=tag == "learned_k0", forced=forced,
                             proposer=proposer)
        gc.collect()
        torch.cuda.empty_cache()
    return reqs, runs


def spec_ep_line(cfg, reqs, runs):
    tag = f"spec-ep {cfg.dtype}"
    line = {"model": cfg.name, "dtype": cfg.dtype, "ep_degree": EP_DEGREE,
            "requests": len(reqs), "k": SPEC_C["k"]}
    for name, run in runs.items():
        rep = run["reps"][0]
        lb = rep["load_balance"]["decode"]
        line[name] = {
            "tpot_p50_s": rep["tpot"]["p50"],
            "decode_steps": rep["decode_steps"],
            "moved_units_per_layer_decode": rep["moe"]["decode/moved_units"],
            "decode_max_mean_ratio": lb["max_mean_ratio"],
            "drops": [lb["send_drops_total"], lb["dest_drops_total"]],
            "acceptance_rate": (rep.get("speculative") or {}).get(
                "acceptance_rate"),
            "launches": run["launches"], "jit_entries": rep["jit_entries"]}
    log(f"[spec-ep] {json.dumps(line)}")
    for name, run in runs.items():
        rep = run["reps"][0]
        _check_budgets(f"{tag} {name}", run["outputs"], reqs,
                       cfg.vocab_size)
        _launch_gate(f"{tag} {name}", cfg, run["launches"],
                     rep["prefill_chunks"] + rep["decode_steps"],
                     ep_degree=EP_DEGREE)
        if name.startswith("skew"):
            if any(line[name]["drops"]):
                raise AssertionError(f"[{tag} {name}] drops "
                                     f"{line[name]['drops']}")
            if line[name]["moved_units_per_layer_decode"] <= 0:
                raise AssertionError(f"[{tag} {name}] no unit moved")
    return line


# (b) and (c)'s teacher-forced k = 4 runs against the k = 0 rows, by
# dtype (logits errors relative to the reference's largest logit).  f32: a
# position whose argmax is not the reference's token only at a near tie,
# and a small median logits error (read: every position agrees, median
# ~5e-6).  bf16, where different GEMM shapes round apart (k = 4 routes 20
# tokens a step, k = 0 4) and 24 layers of top-4-of-60 routing amplify it:
# a floor on the share of positions that take the reference's token and a
# bound on the median logits error, set from the f32-checked readings
# (0.375-0.625 agree, median 0.196-0.271; PERF.md §6), which rows
# unrelated to the reference's miss (agree ~0, median ~1)
FORCED_GATES = {"float32": {"near_tie": 1e-3, "logits_err_median": 1e-2},
                "bfloat16": {"agree": 0.25, "logits_err_median": 0.5}}


def forced_gate_failures(dtype, forced):
    g, bad = FORCED_GATES[dtype], []
    for name, by_rid in forced.items():
        for rid, f in by_rid.items():
            if "near_tie" in g and any(x > g["near_tie"] for x in f["gaps"]):
                bad.append(f"{name} request {rid}: a position leaves the "
                           f"reference's token beyond a near tie: {f}")
            if f["agree"] / f["positions"] < g.get("agree", 0.0):
                bad.append(f"{name} request {rid}: {f['agree']} of "
                           f"{f['positions']} positions agree")
            if f["logits_err_median"] > g["logits_err_median"]:
                bad.append(f"{name} request {rid}: median logits error "
                           f"{f['logits_err_median']}")
    return bad


def prefix_spec_round(cfg, params, dtype, out, *, prefix=True):
    """(a), (b) and (c) in ``dtype``: the lines and gates, then where the
    greedy streams of sharing on against off and of k = 4 against k = 0
    part, and the teacher-forced rows of k = 4 against k = 0 (G = 1, and
    on 4 ranks with the learned router).  In f32 (the rerun where a bf16
    stream parted) only what the comparisons need: (a) when ``prefix``;
    k = 0, k = 4 teacher-forced (whose rows agreeing at every position
    mean equal streams) and k = 4 drafting k = 0's tokens (which runs in
    bf16 when no rerun comes); (c) eager.  Returns (partings,
    teacher-forced)."""
    import torch
    dcfg = cfg.replace(dtype=dtype)
    f32 = dtype == "float32"
    pairs, launches = {}, {}
    t0 = time.perf_counter()
    if prefix:
        windows, on, off = prefix_serve(dcfg, params)
        out[f"prefix_{dtype}"] = prefix_line(dcfg, windows, on, off)
        pairs["prefix sharing on against off"] = parting(
            off["outputs"], on["outputs"], off["rows"])
        launches["prefix"] = on["launches"]
        del windows, on, off
        gc.collect()
        torch.cuda.empty_cache()
    t_a = time.perf_counter()
    spec = spec_serve(dcfg, params, (
        "k0", "k4_forced", "k4_stream_drafts") if f32 else SPEC_RUNS,
        timing=not f32)
    out[f"spec_{dtype}"] = spec_line(dcfg, spec)
    ref = spec["k0"]
    if "k4" in spec:
        pairs["speculative k4 against k0"] = parting(
            ref["outputs"], spec["k4"]["outputs"], ref["rows"])
    if "k4_stream_drafts" in spec:
        pairs["speculative k4 drafting k0's tokens against k0"] = parting(
            ref["outputs"], spec["k4_stream_drafts"]["outputs"],
            ref["rows"])
    forced = {"speculative k4": teacher_forced(
        ref["outputs"], ref["rows"], spec["k4_forced"]["rows"])}
    launches.update({f"spec_{k}": r["launches"] for k, r in spec.items()})
    del spec, ref
    gc.collect()
    torch.cuda.empty_cache()
    t_b = time.perf_counter()
    reqs, ep = spec_ep_serve(dcfg, params, (
        "learned_k0", "learned_k4_forced") if f32 else SPEC_EP_RUNS,
        eager=f32)
    out[f"spec_ep_{dtype}"] = spec_ep_line(dcfg, reqs, ep)
    ref = ep["learned_k0"]
    forced["speculative k4 on 4 ranks, learned routes"] = teacher_forced(
        ref["outputs"], ref["rows"], ep["learned_k4_forced"]["rows"])
    launches.update({f"spec_ep_{k}": r["launches"] for k, r in ep.items()})
    del ep, ref
    gc.collect()
    torch.cuda.empty_cache()
    log(f"[prefix-spec] {dtype} streams: " + json.dumps(
        {name: (p or "equal") for name, p in pairs.items()}))
    log(f"[prefix-spec] {dtype} teacher-forced: " + json.dumps(forced))
    log(f"[time] phase 12 {dtype}: (a) {t_a - t0:.1f} s, (b) "
        f"{t_b - t_a:.1f} s, (c) {time.perf_counter() - t_b:.1f} s")
    if not f32:
        out["launches"] = launches
    return pairs, forced


def prefix_spec_path():
    """Phase 12: full-width qwen15-moe-a27b on the paged pool with prefix
    sharing (a) and speculative decoding (b) at G = 1, and speculative
    decoding on four virtual EP ranks (c), on one set of weights drawn
    once; where a bf16 stream parts from its reference, the same pairs in
    f32, whose streams may part only at near ties and whose teacher-forced
    rows must hold ``FORCED_GATES``' f32 bounds, and only then the bf16
    rows theirs; then (d).  Returns the lines."""
    import torch
    from repro_torch.configs.registry import get_config
    from repro_torch.models.model import build_model
    cfg = get_config("qwen15-moe-a27b")
    t0 = time.perf_counter()
    params = build_model(cfg, batch=PS["slots"], seq_len=704).init(0)
    torch.cuda.synchronize()
    log(f"[prefix] {cfg.name}: weights drawn in "
        f"{time.perf_counter() - t0:.1f} s "
        f"({torch.cuda.memory_allocated() / 2**30:.1f} GiB)")
    out = {}
    pairs, forced = prefix_spec_round(cfg, params, "bfloat16", out)
    out["streams_bfloat16"], out["forced_bfloat16"] = pairs, forced
    if not any(pairs.values()) and all(
            f["agree"] == f["positions"] for by_rid in forced.values()
            for f in by_rid.values()):
        # no f32 rerun to carry the drafting run: it runs here
        spec_line(cfg.replace(dtype="bfloat16"), spec_serve(
            cfg.replace(dtype="bfloat16"), params,
            ("k0", "k4_stream_drafts"), timing=False))
    else:
        log("[prefix-spec] bf16 streams part from their references: the "
            "same pairs again with the weights in f32")
        _cast_(params, torch.float32)
        pairs32, forced32 = prefix_spec_round(
            cfg, params, "float32", out,
            prefix=bool(pairs["prefix sharing on against off"]))
        out["streams_float32"], out["forced_float32"] = pairs32, forced32
        bad = {n: p for n, p in pairs32.items() if not _near_ties(p)}
        bad_rows = forced_gate_failures("float32", forced32)
        if bad or bad_rows:
            raise AssertionError(f"[prefix-spec] f32 streams part from "
                                 f"their references beyond a near tie: "
                                 f"{bad} {bad_rows}")
    bad_rows = forced_gate_failures("bfloat16", forced)
    if bad_rows:
        raise AssertionError("[prefix-spec] bf16 teacher-forced rows: "
                             + "; ".join(bad_rows))
    del params
    gc.collect()
    torch.cuda.empty_cache()
    for ep_degree in (1, EP_DEGREE):
        small_prefix_spec_reference_check(ep_degree)
    return out


def small_prefix_spec_reference_check(ep_degree, seed: int = 0) -> None:
    """(d): reduced qwen15-moe-a27b in f32 (learned routes, q = 1 at
    G = 4), motif prompts, the last one the first's again: sharing off
    with k = 0, and sharing on with k = 4; the card's greedy streams,
    prefix counters and speculative sections equal the CPU's (so
    acceptance is > 0 on the card where the CPU run shows it)."""
    import dataclasses
    import numpy as np
    from repro_torch.configs.registry import get_config
    from repro_torch.models.model import build_model
    from repro_torch.serve import Request, ServeEngine, VirtualClock, \
        engine_config_for
    cfg = get_config("qwen15-moe-a27b").reduced()
    cfg = dataclasses.replace(cfg, moe=dataclasses.replace(cfg.moe,
                                                           q_tokens=1))
    rng = np.random.default_rng(seed)
    prompts = [np.tile(rng.integers(0, cfg.vocab_size, (3,)), 4)[:n]
               for n in (12, 9, 11, 7)]
    prompts.append(prompts[0].copy())     # a cached prefix of one block
    params = build_model(cfg, batch=3, seq_len=12, device="cpu",
                         ep_degree=ep_degree).init(seed)
    found = {}
    for sharing, k in ((False, 0), (True, 4)):
        res = {}
        for dev in ("cpu", "cuda"):
            model = build_model(cfg, batch=3, seq_len=12, device=dev,
                                ep_degree=ep_degree)
            ecfg = engine_config_for(
                cfg, max_slots=3, prompt_len=12, max_new_tokens=16,
                prefill_chunk=4, paged=True, kv_block_size=4,
                prefix_sharing=sharing, speculative_k=k)
            eng = ServeEngine(model, _to(params, dev), ecfg,
                              clock=VirtualClock(0.1), device=dev)
            out = {}
            orig = eng._finish

            def capture(st, now, out=out, orig=orig):
                out[st.req.rid] = list(st.output)
                orig(st, now)
            eng._finish = capture
            rep = eng.run([Request(rid=i, tokens=p, max_new_tokens=16)
                           for i, p in enumerate(prompts)])
            res[dev] = (out, {key: rep.get(key) for key in (
                "speculative", "prefix_hit_rate", "cow_copies",
                "decode_steps", "prefill_chunks")})
        if res["cpu"] != res["cuda"]:
            raise AssertionError(
                f"small prefix/speculative reference (G = {ep_degree}, "
                f"sharing {sharing}, k {k}): card {res['cuda']} != cpu "
                f"{res['cpu']}")
        found[(sharing, k)] = res["cuda"][1]
    sp = found[(True, 4)]
    log(f"[reference] reduced qwen15-moe-a27b f32 at G = {ep_degree}, "
        f"sharing off k = 0 and sharing on k = 4: card streams, prefix "
        f"counters and speculative sections equal the CPU's (accepted "
        f"drafts {sp['speculative']['accepted']} of "
        f"{sp['speculative']['drafted']}, prefix hit rate "
        f"{sp['prefix_hit_rate']:.3f})")


def main() -> int:
    try:
        import torch
    except ImportError:
        print("chip_smoke: torch is not installed", file=sys.stderr)
        return 2
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    src = os.path.join(HERE, "src")
    if not os.path.isdir(os.path.join(src, "repro_torch")):
        print("chip_smoke: src/repro_torch not found beside the script",
              file=sys.stderr)
        return 2
    sys.path.insert(0, src)
    from repro_torch.configs.registry import get_config
    from repro_torch.kernels import build
    from repro_torch.models.model import build_model

    t_run = time.perf_counter()

    def elapsed(what):
        log(f"[time] {what}: {time.perf_counter() - t_run:.1f} s since start")

    # --- phase 1: environment -------------------------------------------
    log(smi_line())
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    log(f"[env] torch {torch.__version__} cuda {torch.version.cuda} "
        f"device {torch.cuda.get_device_name(0)} x{torch.cuda.device_count()}")
    secs = build.build_all()
    log(f"[env] kernels built in {secs:.1f} s into {build.BUILD_DIR}")
    for name, text in build.build_log.items():
        for line in text.splitlines():
            if any(w in line for w in ("registers", "spill", "Compiling",
                                       "Performance Loss")):
                log(f"[ptxas] {name}: {line.strip()}")
    counts = tensor_core_counts(build)
    log("[sass] " + ", ".join(f"{name}: HGMMA {n['HGMMA']} HMMA {n['HMMA']}"
                              for name, n in counts.items()))
    for name in TENSOR_CORE:
        if sum(counts[name].values()) == 0:
            raise AssertionError(f"{name}: no tensor-core instruction in its "
                                 f"library")

    cfg = get_config("qwen15-moe-a27b")
    moon = get_config("moonshot-v1-16b-a3b")
    switch = get_config("switch128")
    shape = dict(max_seq_len=256 + 32, prefill_chunk=32, block_size=16)
    whole = dict(batch=4, prompt_len=1024, s_max=1024 + 64, new_tokens=32)

    elapsed("built")
    if "--only-prefix-spec" in sys.argv[1:]:
        # a shorter run for work on phase 12: its parity cases and the
        # phase itself, without the kernels line and the result line
        prefix_spec_kernel_parity(cfg)
        prefix_spec_path()
        elapsed("phase 12")
        return 0
    if "--only-mixtral" in sys.argv[1:]:
        # a shorter run for work on phase 11: its parity cases and the
        # phase itself, without the kernels line and the result line
        mixtral_kernel_parity(mixtral_config())
        mixtral_path()
        elapsed("phase 11")
        return 0
    # --- phase 2: kernel parity ------------------------------------------
    parity = kernel_parity(cfg, moon, switch, flash_batch=whole["batch"],
                           flash_len=whole["prompt_len"], **shape)
    for name, recs in mixtral_kernel_parity(mixtral_config()).items():
        parity[name] += recs
    for name, recs in prefix_spec_kernel_parity(cfg).items():
        parity[name] += recs

    elapsed("phase 2")
    # --- phase 3/4: the serve path + small reference ----------------------
    summary, qwen_params = main_path(cfg, n_requests=8, slots=4,
                                     new_tokens=32, seed=0, **shape)
    # phase 7 on phase 3's weights
    captures = [capture_compare(cfg, qwen_params, "qwen_g1", paged=True,
                                n_requests=4, prompt_lens=(64, 129),
                                new_tokens=16, seed=0, **shape)]
    del qwen_params
    small_reference_check()
    gc.collect()                     # the engine holds reference cycles
    torch.cuda.empty_cache()
    log(f"[env] serve path freed: "
        f"{torch.cuda.memory_allocated() / 2**30:.2f} GiB still allocated")

    elapsed("phases 3-4 (+ 7 on qwen)")
    # --- phase 4b: HarMoEny across 4 virtual EP ranks ----------------------
    ep, caps, ep_params = ep_path(cfg, seed=0, slots=4, n_requests=4,
                                  new_tokens=8, **shape)
    captures += caps
    small_ep_reference_check()
    elapsed("phase 4b (+ 7 on G = 4)")
    # --- phase 8: replica slots and tiered residency on 4b's weights --------
    placement = placement_path(cfg, ep_params, seed=0, slots=4, **shape)
    del ep_params
    gc.collect()
    torch.cuda.empty_cache()
    log(f"[env] EP path freed: "
        f"{torch.cuda.memory_allocated() / 2**30:.2f} GiB still allocated")

    elapsed("phase 8")
    # --- phase 5: whole-prompt prefill + slab decode ----------------------
    whole_summary, moon_params = prefill_decode_path(moon, seed=0, **whole)
    small_prefill_reference_check()
    small_prefill_bf16_check()

    elapsed("phase 5")
    # --- phase 6: the engine across layer patterns -------------------------
    # moonshot (a dense lead layer) on the slab, on phase 5's weights
    patterns = {"serve_moonshot_v1_16b_a3b_slab": pattern_serve(
        moon, moon_params, "serve-slab", paged=False, slots=4, n_requests=4,
        prompt_lens=(64, 129), new_tokens=8, seed=0, **shape)}
    captures.append(capture_compare(
        moon, moon_params, "moonshot_slab", paged=False, n_requests=2,
        prompt_lens=(64, 129), new_tokens=8, seed=0, **shape))
    del moon_params
    gc.collect()
    torch.cuda.empty_cache()
    log(f"[env] moonshot freed: "
        f"{torch.cuda.memory_allocated() / 2**30:.2f} GiB still allocated")
    switch_serves, caps = switch_path(switch, seed=0, **shape)
    patterns.update(switch_serves)
    captures += caps
    gc.collect()
    torch.cuda.empty_cache()
    for arch in (moon.name, switch.name):
        for paged in (False, True):
            small_reference_check(arch, paged=paged)

    elapsed("phase 6 (+ 7 on moonshot and switch128)")
    # --- phase 9: the serving CLI, sampled, in its own processes ------------
    log(f"[env] before the CLI runs: "
        f"{torch.cuda.memory_allocated() / 2**30:.2f} GiB still allocated")
    clis = cli_path(cfg)
    elapsed("phase 9")
    # --- phase 10: across processes; the fetch on its side stream -----------
    fetch = fetch_lines(captures)                          # (c), phase 7's
    nccl = nccl_cli_path(cfg)                               # (a)
    elapsed("phase 10 (a)")
    spec = dist_spec(cfg, seed=0, slots=4, **shape)         # (b)
    ref_params = build_model(ep_moe_config(cfg), batch=4,
                             seq_len=shape["max_seq_len"],
                             ep_degree=EP_DEGREE).init(0)
    dist_ref = dist_reference(cfg, ref_params, spec)
    del ref_params
    gc.collect()
    torch.cuda.empty_cache()
    dist = dist_gloo_path(cfg, spec, dist_ref)
    elapsed("phase 10")
    # --- phase 11: mixtral-8x7b and its window rings ------------------------
    gc.collect()
    torch.cuda.empty_cache()
    mixtral = mixtral_path()
    elapsed("phase 11")
    # --- phase 12: prefix sharing and speculative decoding -----------------
    gc.collect()
    torch.cuda.empty_cache()
    prefix_spec = prefix_spec_path()
    elapsed("phase 12")
    # each kernel's launches over the run of the path that carries it
    path_of = {"moe_gmm": summary, "paged_attention": summary,
               "flash_attention": whole_summary, "schedule": summary}
    kernels = []
    for name in REPLACES:
        main_case = parity[name][0]     # decode shapes; flash: the prefill
        kernels.append({
            "name": name, "route": "cuda", "source": SOURCES[name],
            "replaces": REPLACES[name],
            "launches": path_of[name]["launches"][name],
            "launches_by_path": {
                "serve_qwen15_moe_a27b": summary["launches"][name],
                **{f"serve_qwen15_moe_a27b_ep{EP_DEGREE}_{p}":
                   rec["launches"][name] for p, rec in ep.items()},
                **{f"placement_qwen15_moe_a27b_ep{EP_DEGREE}_{tag}":
                   rec["launches"][name] for tag, rec in placement.items()},
                "prefill_decode_moonshot_v1_16b_a3b":
                    whole_summary["launches"][name],
                **{path: rec["launches"][name]
                   for path, rec in patterns.items()},
                **{f"{tag}_qwen15_moe_a27b_sampled": rec["launches"][name]
                   for tag, rec in clis.items()},
                "cli_nccl_qwen15_moe_a27b_g1":
                    nccl["launches"]["nccl"][name],
                f"dist_gloo_qwen15_moe_a27b_ep{EP_DEGREE}_per_process":
                    [rec[name] for rec in dist["launches"]],
                f"dist_reference_qwen15_moe_a27b_ep{EP_DEGREE}_virtual":
                    dist["reference_launches"][name],
                f"serve_mixtral_8x7b_{MIXTRAL_LAYERS}of32_paged":
                    mixtral["serve"]["launches"][name],
                f"ring_mixtral_8x7b_{MIXTRAL_LAYERS}of32_paged":
                    mixtral["ring_paged"]["launches"][name],
                f"ring_mixtral_8x7b_{MIXTRAL_LAYERS}of32_slab":
                    mixtral["ring_slab"]["launches"][name],
                f"ring_mixtral_8x7b_{MIXTRAL_LAYERS}of32_f32_paged":
                    mixtral["ring_paged_f32"]["launches"][name],
                f"ring_mixtral_8x7b_{MIXTRAL_LAYERS}of32_f32_slab":
                    mixtral["ring_slab_f32"]["launches"][name],
                f"serve_mixtral_8x7b_{MIXTRAL_LAYERS}of32_ep{EP_DEGREE}"
                f"_harmoeny": mixtral["ep"]["launches"][name],
                **{f"prefix_spec_qwen15_moe_a27b_{run}": rec[name]
                   for run, rec in prefix_spec["launches"].items()}},
            "max_abs_err": max(r["max_abs_err"] for r in parity[name]
                               if r["dtype"] in ("bfloat16", "int32")),
            "ms": main_case["ms"], "plain_ms": main_case["plain_ms"],
            "bound_ms": main_case["bound_ms"],
            "bound_by": main_case["bound_by"],
            "library_ms": main_case["library_ms"],
            "cases": [{k: r.get(k) for k in ("case", "dtype", "max_abs_err",
                                             "ms", "event_ms", "plain_ms",
                                             "bound_ms", "bound_by",
                                             "library_ms", "splits", "ctas")}
                      for r in parity[name]],
        })
    log(f"[capture] {len(captures)} configurations: captured streams "
        f"equal the eager ones and take fewer host launches a prefill "
        f"chunk and a decode step")
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
