"""Serving CLI (port of ``repro/launch/serve.py``): a thin front end over
the port's continuous-batching engine, with HarMoEny load balancing under
request streams.

On the card (the default), full width, random bf16 weights from seed 0:
  PYTHONPATH=src python -m repro_torch.launch.serve --arch qwen15-moe-a27b \\
      --paged --batch 8 --requests 24 --rate 8 --prompt-len 128 --gen 32 \\
      --temperature 0.8 --top-k 50 --top-p 0.9

The archs are the port's registry: the MoE decoders qwen15-moe-a27b,
moonshot-v1-16b-a3b, switch128 and mixtral-8x7b; mamba2-2.7b and
zamba2-7b; and the dense decoders mistral-nemo-12b, phi4-mini-3.8b and
stablelm-1.6b.  mixtral's sliding window is served as JAX serves it (the
slab clamped to the window; ``--paged`` pools wrap it in ring buffers),
e.g. on the CPU at reduced size:
  serve(build_parser().parse_args(["--arch", "mixtral-8x7b", "--reduced",
      "--paged", "--prompt-len", "80", "--prefill-chunk", "16"]),
      device="cpu")

The flags are the JAX CLI's.  One closed batch of ``--batch`` prompts is
the default; ``--requests N --rate R`` opens the loop with N Poisson
arrivals at R req/s, admitted into freed decode slots as earlier requests
finish; ``--trace FILE`` replays arrival records instead.  ``--paged``
swaps the slab KV pool for the paged block-table pool (block-aware
admission, preemption by recompute); ``--temperature`` / ``--top-k`` /
``--top-p`` switch greedy decoding to truncated sampling.  On the paged
pool ``--prefix-sharing`` makes it a prefix cache (radix index,
copy-on-write blocks, LRU eviction; ``--shared-prefix-len N`` gives the
synthetic prompts a common first N tokens), and ``--speculative-k K``
verifies up to K self-drafted tokens a decode step, e.g. on the card:
  PYTHONPATH=src python -m repro_torch.launch.serve --arch qwen15-moe-a27b \\
      --paged --prefix-sharing --shared-prefix-len 512 --prompt-len 576 \\
      --gen 32 --requests 8 --speculative-k 4
``--model-par G`` builds the model at expert-parallel degree G: G
virtual ranks on the one card (``VirtualGroup``), where ``--skew`` and
``--policy`` / ``--moe-policy`` show the schedule's balance.  The report
gives per-request TTFT/TPOT percentiles, decode tokens/s and the
HarMoEny schedule diagnostics (moved units, drops, load balance).

``--replicas N`` serves through a fleet of N engine replicas behind a
``FleetRouter`` (virtual replicas, as in JAX: one model and one set of
weights, an engine and a KV pool each, one shared clock), routed by
``--routing-policy`` load / prefix_affinity / round_robin
(``--affinity-weight``); ``--disaggregate`` makes the first half of them
prefill-role and the rest decode-role engines, joined by the KV handoff
(needs ``--paged``).  With ``--model-par G`` every replica is a
``VirtualGroup(G)`` engine on the one shared model.  The JAX CLI's
``[fleet]`` lines give the aggregate and per-replica metrics, routing and
handoffs, e.g. on the card:
  PYTHONPATH=src python -m repro_torch.launch.serve --arch qwen15-moe-a27b \\
      --paged --replicas 2 --disaggregate --prompt-len 576 --gen 32 \\
      --requests 8

Across processes, one EP rank each, the launcher's environment takes the
place of JAX's device mesh:
  torchrun --nproc-per-node G -m repro_torch.launch.serve ... --model-par G
(or any launcher that sets ``RANK`` and ``WORLD_SIZE``) builds a
``DistComm`` over the default process group, NCCL on
``cuda:LOCAL_RANK``, with the dense fetch and every entry captured;
``serve(args, device="cpu")`` under an initialized process group runs
it on gloo with the hosted fetch and the entries eager (gloo cannot be
captured).  ``WORLD_SIZE`` must equal ``--model-par``.  Each process holds
only its own expert rows; every process serves the same requests in
lockstep, and only rank 0 prints and writes the report.

``--replica-slots`` / ``--rebalance-interval`` and
``--resident-experts`` / ``--prefetch-policy`` run under a launcher too:
the replica swap fetches each slot's row from its host rank, and each
rank's host tier holds its own rows.

``--fused-attention`` and ``--fused-moe`` are accepted as in JAX: on the
card the hand-written kernels run whatever they say, and the report
gives what ran (True on the card, False on the CPU, where the plain
versions run); a window ring refuses ``--fused-attention``,
``--prefix-sharing``, ``--speculative-k`` and ``--disaggregate`` as the
JAX engine does.  Refused with ``NotImplementedError``: any arch outside
the port's registry; whisper-large-v3 and pixtral-12b, with the serve
engine's refusal (JAX's words, the flag named), before any weights are
drawn; and a fleet under a launcher, which the JAX package has no
lockstep counterpart of (a deliberate difference); ``--data-par > 1``
raises as in JAX.

``serve(args, device=..., params=...)`` runs on the card unless the
caller asks for the CPU, on weights drawn from seed 0 unless the caller
passes a parameter tree (the tests pass JAX's weights, converted).  It
prints the JAX CLI's ``[serve]`` lines, then one of its own,
``[serve] device {...}``: the device, peak device memory, each kernel's
launches over the run, the tokens that came out (count, smallest and
largest id, lengths) and the host ms of the sampling noise and skew
pre-draws.  A fleet prints the JAX CLI's ``[fleet]`` lines and
``[fleet] device {...}``, the same over every replica.
"""
from __future__ import annotations

import argparse
import contextlib
import dataclasses
import hashlib
import json
import os

import numpy as np
import torch

from repro_torch.configs.registry import REGISTRY, get_config
from repro_torch.convert import shard_params
from repro_torch.core.dispatch import DistComm
from repro_torch.core.topology import static_opt_placement
from repro_torch.launch.grid import init_from_env, make_grid
from repro_torch.models.model import build_model
from repro_torch.serve import (ROUTING_POLICIES, EngineConfig, FleetRouter,
                               ServeEngine, WallClock, engine_config_for,
                               load_trace, poisson_requests)
from repro_torch.serve import stepcore
from repro_torch.serve.engine import check_servable
from repro_torch.serve.stepcore import kernel_launches

# One row per EngineConfig knob: the flag and the field it sets; argparse
# takes its type and default from the dataclass field (``add_engine_flags``)
# and ``engine_overrides`` reads the values back by field name.  A
# ``default`` in the row marks the CLI's "0 = auto" (resolved by
# ``engine_config_for``).  The rows are the JAX CLI's.
ENGINE_FLAGS = [
    ("--prefill-chunk", "prefill_chunk",
     dict(default=0, help="prompt tokens per prefill chunk (0 = auto)")),
    ("--paged", "paged",
     dict(help="paged KV pool: block-table attention, block-aware "
               "admission, preemption-by-recompute")),
    ("--kv-block-size", "kv_block_size",
     dict(help="tokens per physical KV block (paged mode)")),
    ("--kv-blocks", "num_kv_blocks",
     dict(help="usable KV blocks (0 = worst case: slab parity)")),
    ("--prefix-sharing", "prefix_sharing",
     dict(help="prefix-sharing KV cache: copy-on-write blocks, radix "
               "prefix index, LRU eviction (needs --paged)")),
    ("--fused-attention", "fused_paged_attention",
     dict(help="the JAX CLI's fused-attention switch (needs --paged); on "
               "the card the hand-written paged_attention kernel runs "
               "whatever it says, and the report gives what ran")),
    ("--fused-moe", "fused_moe_gmm",
     dict(help="the JAX CLI's grouped-GEMM switch (MoE archs only); on "
               "the card the hand-written moe_gmm kernel runs whatever "
               "it says, and the report gives what ran")),
    ("--speculative-k", "speculative_k",
     dict(help="speculative decoding: verify up to k self-drafted tokens "
               "per decode step in one static [B, k+1] forward (needs "
               "--paged; greedy streams stay token-identical)")),
    ("--speculative-policy", "speculative_policy",
     dict(help="draft proposer (ngram = prompt-lookup self-drafting)")),
    ("--temperature", "temperature",
     dict(help="sampling temperature (0 = greedy)")),
    ("--top-k", "top_k",
     dict(help="truncate sampling to the top-k logits (0 = full)")),
    ("--top-p", "top_p",
     dict(help="nucleus sampling: keep the smallest token set with "
               "cumulative probability >= top-p (1 = off)")),
    ("--replica-slots", "replica_slots",
     dict(help="static hot-expert replica slots per rank (0 = "
               "replication off); swaps never re-capture")),
    ("--rebalance-interval", "rebalance_interval",
     dict(help="engine steps between hot-expert weight swaps (0 = "
               "never; needs --replica-slots)")),
    ("--resident-experts", "resident_experts",
     dict(help="tiered expert residency: pod-total device working-set "
               "budget in experts (0 = off; must be a multiple of the "
               "EP degree)")),
    ("--prefetch-policy", "prefetch_policy",
     dict(choices=["predictive", "on_demand", "none"],
          help="residency staging policy: predictive = EMA-driven "
               "next-layer prefetch, on_demand = stage on first touch, "
               "none = frozen initial working set")),
]

POLICIES = ["harmoeny", "round_robin", "even_split", "static_opt"]


def add_engine_flags(ap: argparse.ArgumentParser) -> None:
    """One flag per ``ENGINE_FLAGS`` row, typed and defaulted from its
    ``EngineConfig`` field (bool fields become ``store_true`` switches);
    ``dest`` is the field name."""
    fields = {f.name: f for f in dataclasses.fields(EngineConfig)}
    for flag, name, extra in ENGINE_FLAGS:
        extra = dict(extra)
        default = extra.pop("default", fields[name].default)
        if isinstance(default, bool):
            ap.add_argument(flag, dest=name, action="store_true", **extra)
        else:
            ap.add_argument(flag, dest=name, type=type(default),
                            default=default, **extra)


def engine_overrides(args) -> dict:
    """The parsed value of every ``ENGINE_FLAGS`` knob, keyed by
    ``EngineConfig`` field name, for ``engine_config_for``."""
    return {name: getattr(args, name) for _, name, _ in ENGINE_FLAGS}


def skew_profile(moe, skew: float) -> np.ndarray:
    """Offline per-expert load profile under the synthetic skew router:
    the first ``router_skew_experts`` experts share ``skew`` of the mass,
    the rest split the remainder.  Feeds ``static_opt_placement``, the
    paper's profile-then-place baseline."""
    E, H = moe.num_experts, moe.router_skew_experts
    p = np.full((E,), (1.0 - skew) / max(E - H, 1))
    p[:H] = skew / max(H, 1)
    return (p * 10_000).astype(np.int64)


def check_ported(args) -> None:
    """Refuse, naming the flag, what the port does not serve yet."""
    if args.arch not in REGISTRY:
        raise NotImplementedError(
            f"--arch {args.arch}: not in the port's registry "
            f"{sorted(REGISTRY)}")
    if args.data_par > 1:
        raise NotImplementedError(
            "the serving engine shards the model/expert axis only; "
            "--data-par must be 1 (data-parallel serving is an open item)")


def config_from_args(args):
    """The model config the args ask for, once ``check_ported`` has
    refused what the port does not serve yet."""
    check_ported(args)
    cfg = get_config(args.arch)
    try:
        # the engine's own refusal, before any weights are drawn
        check_servable(cfg)
    except NotImplementedError as e:
        raise NotImplementedError(f"--arch {args.arch}: {e}") from None
    if args.reduced:
        cfg = cfg.reduced()
    if getattr(args, "sliding_window", -1) >= 0:
        cfg = cfg.replace(sliding_window=args.sliding_window)
    if cfg.moe is None:
        return cfg
    moe = dataclasses.replace(cfg.moe, policy=args.policy)
    if args.skew > 0:
        moe = dataclasses.replace(moe, router_skew=args.skew)
    if args.replica_slots > 0:
        moe = dataclasses.replace(moe, num_replica_slots=args.replica_slots)
    if args.q_tokens > 0:
        moe = dataclasses.replace(moe, q_tokens=args.q_tokens)
    if args.policy == "static_opt" and moe.num_experts >= args.model_par:
        # profile-then-place: bin-pack the offline skew profile once
        placement = static_opt_placement(
            skew_profile(moe, moe.router_skew), args.model_par)
        moe = dataclasses.replace(moe, placement=tuple(int(e)
                                                       for e in placement))
    return cfg.replace(moe=moe)


def _engine_cfg(args, cfg, prompt_len, gen, role="unified"):
    return engine_config_for(
        cfg, max_slots=args.batch, prompt_len=prompt_len,
        max_new_tokens=gen, skew_seed=args.seed + 1,
        moe_policy=args.moe_policy or None, role=role,
        **engine_overrides(args))


def process_group_comm(args, device):
    """The launcher's process group as the MoE blocks' communicator, and
    the device this process runs on: a ``DistComm`` over the default
    group when one is initialized or the environment names one
    (``grid.init_from_env``: NCCL on ``cuda:LOCAL_RANK``, gloo when the
    caller asks for the CPU), else None (one process: ``LocalComm`` or
    ``VirtualGroup``).  Serving's grid is one data row, as JAX's serving
    refuses ``--data-par`` > 1.  NCCL takes the dense fetch, whose
    collectives can be captured; gloo the hosted fetch, with the entries
    eager."""
    import torch.distributed as dist
    launched, device = init_from_env(device)
    if not launched:
        return None, device
    world = dist.get_world_size()
    if world != args.model_par:
        raise ValueError(f"WORLD_SIZE {world} != --model-par "
                         f"{args.model_par}: one process runs one EP rank")
    return make_grid(1, args.model_par).comm(), device


def build_serving_engine(args, cfg=None, *, prompt_len=None, gen=None,
                         device="cuda", params=None, comm=None):
    """Config, model and engine from CLI args: the model at expert-parallel
    degree ``--model-par`` on ``device`` (over ``comm`` when given: this
    process's rank), on ``params`` (the whole tree; a ``DistComm`` rank
    keeps its own expert rows of it) or, without them, on weights drawn
    from seed 0."""
    cfg = cfg if cfg is not None else config_from_args(args)
    prompt_len = prompt_len or args.prompt_len
    gen = gen or args.gen
    ecfg = _engine_cfg(args, cfg, prompt_len, gen)
    model = build_model(cfg, batch=args.batch, seq_len=prompt_len,
                        device=device, ep_degree=args.model_par, comm=comm)
    if params is None:
        params = model.init(0)
    elif isinstance(comm, DistComm):
        params = shard_params(params, comm.rank, comm.size)
    return cfg, ServeEngine(model, params, ecfg, device=device)


def build_fleet(args, cfg=None, *, prompt_len=None, gen=None,
                device="cuda", params=None):
    """``--replicas`` virtual replicas behind a ``FleetRouter``: one model
    at expert-parallel degree ``--model-par`` and one set of weights, an
    engine (and KV pool) each, one shared wall clock.  ``--disaggregate``
    makes the first ``replicas // 2`` engines prefill-role and the rest
    decode-role (it needs ``--paged``)."""
    cfg = cfg if cfg is not None else config_from_args(args)
    prompt_len = prompt_len or args.prompt_len
    gen = gen or args.gen
    if args.disaggregate:
        if args.replicas < 2:
            raise ValueError("--disaggregate needs --replicas >= 2 "
                             "(at least one prefill + one decode engine)")
        if not args.paged:
            raise ValueError("--disaggregate hands KV off through the "
                             "paged block machinery; add --paged")
        n_pf = max(1, args.replicas // 2)
        roles = ["prefill"] * n_pf + ["decode"] * (args.replicas - n_pf)
    else:
        roles = ["unified"] * args.replicas
    ecfgs = [_engine_cfg(args, cfg, prompt_len, gen, role) for role in roles]
    model = build_model(cfg, batch=args.batch, seq_len=prompt_len,
                        device=device, ep_degree=args.model_par)
    if params is None:
        params = model.init(0)
    clock = WallClock()
    engines = [ServeEngine(model, params, ecfg, clock=clock, device=device)
               for ecfg in ecfgs]
    return cfg, FleetRouter(engines, policy=args.routing_policy,
                            affinity_weight=args.affinity_weight)


def serve(args, *, device="cuda", params=None):
    cfg = config_from_args(args)
    comm, device = process_group_comm(args, device)
    fleet = args.replicas > 1 or args.disaggregate
    if fleet and comm is not None:
        raise NotImplementedError(
            "--replicas / --disaggregate under a launcher: a fleet of "
            "engines across processes has no JAX counterpart (the JAX "
            "package has no lockstep fleet; a deliberate difference)")
    lead = comm is None or comm.rank == 0         # prints, writes the report
    if args.trace:
        requests = load_trace(args.trace, vocab_size=cfg.vocab_size)
        prompt_len = max(r.prompt_len for r in requests)
        gen = max(r.max_new_tokens for r in requests)
    else:
        n = args.requests or args.batch
        requests = poisson_requests(
            n, rate=args.rate, vocab_size=cfg.vocab_size,
            prompt_len=args.prompt_len, max_new_tokens=args.gen,
            seed=args.seed, shared_prefix_len=args.shared_prefix_len)
        prompt_len, gen = args.prompt_len, args.gen
    if fleet:
        return serve_fleet(args, cfg, requests, prompt_len, gen,
                           device=device, params=params)
    cfg, engine = build_serving_engine(args, cfg, prompt_len=prompt_len,
                                       gen=gen, device=device, params=params,
                                       comm=comm)
    # gloo cannot be captured: its engine runs every entry eagerly
    mode = (stepcore.eager() if comm is not None and not comm.capturable
            else contextlib.nullcontext())
    with mode:
        rep, streams, launches = _serve_run(engine, requests)
    if lead:
        _print_report(args, engine, rep, streams, launches)
    engine.close()
    return rep


def _serve_run(engine, requests):
    """Warm up, then serve ``requests``: the report, the streams by
    request id and each kernel's launches over the run."""
    engine.warmup()                  # capture outside the TTFT window
    streams = {}
    finish = engine._finish

    def record(st, now):
        streams[st.req.rid] = list(st.output)
        finish(st, now)
    engine._finish = record
    cuda = engine.device.type == "cuda"
    if cuda:
        torch.cuda.synchronize(engine.device)
        torch.cuda.reset_peak_memory_stats(engine.device)
    launches0 = kernel_launches()
    rep = engine.run(requests)
    launches = {k: v - launches0[k] for k, v in kernel_launches().items()}
    return rep, streams, launches


def serve_fleet(args, cfg, requests, prompt_len, gen, *, device="cuda",
                params=None):
    """Warm every replica up, serve ``requests`` through the fleet, print
    the JAX CLI's ``[fleet]`` lines and the port's ``[fleet] device``
    line, and write the report to ``--out``."""
    cfg, fleet = build_fleet(args, cfg, prompt_len=prompt_len, gen=gen,
                             device=device, params=params)
    fleet.warmup()                     # capture outside the TTFT window
    streams = {}
    for eng in fleet.engines:
        def record(st, now, finish=eng._finish):
            streams[st.req.rid] = list(st.output)
            finish(st, now)
        eng._finish = record
    dev = fleet.engines[0].device
    cuda = dev.type == "cuda"
    if cuda:
        torch.cuda.synchronize(dev)
        torch.cuda.reset_peak_memory_stats(dev)
    launches0 = kernel_launches()
    rep = fleet.run(requests)
    launches = {k: v - launches0[k] for k, v in kernel_launches().items()}
    fl = rep["fleet"]
    agg, routing, hand = fl["aggregate"], fl["routing"], fl["handoffs"]
    ttft, tpot = agg["ttft"], agg["tpot"]
    print(f"[fleet] arch={args.arch} replicas={fl['n_replicas']} "
          f"policy={routing['policy']} "
          f"disaggregated={fl['disaggregated']} "
          f"requests={agg['n_requests']} rate={args.rate}")
    print(f"[fleet] TTFT p50 {ttft['p50'] * 1e3:.1f} ms  "
          f"p99 {ttft['p99'] * 1e3:.1f} ms   "
          f"TPOT p50 {tpot['p50'] * 1e3:.2f} ms   "
          f"decode {agg['throughput_tok_s']:.1f} tok/s   "
          f"goodput {agg['goodput_req_s']:.2f} req/s")
    hit = routing["affinity_hit_rate"]
    print(f"[fleet] routing: per_replica={routing['per_replica']}  "
          f"affinity_hits={routing['affinity_hits']} "
          f"(rate={hit if hit is None else f'{hit:.2f}'}, "
          f"{routing['affinity_hit_tokens']} cached tokens)")
    if fl["disaggregated"]:
        print(f"[fleet] handoffs: moved={hand['moved']} "
              f"bytes={hand['bytes'] / 2 ** 20:.2f} MiB "
              f"pending={hand['pending']}")
    for r in fl["replicas"]:
        rt = r["ttft"]["p50"]
        print(f"[fleet]   replica {r['index']} role={r['role']:8s} "
              f"routed={r['routed']:3d} finished={r['n_requests']:3d} "
              f"steps={r['steps']:4d} "
              f"ttft_p50={'-' if rt is None else f'{rt * 1e3:.1f}ms'}")
    recompiled = [bool(rr.get("recompiled_after_warmup"))
                  for rr in rep["replica_reports"]]
    print(f"[fleet] recompiled_after_warmup={recompiled}")
    toks = [t for out in streams.values() for t in out]
    print("[fleet] device " + json.dumps({
        "device": (torch.cuda.get_device_name(dev) if cuda else str(dev)),
        "peak_mem_gib": (torch.cuda.max_memory_allocated(dev) / 2 ** 30
                         if cuda else None),
        "launches": launches,
        "jit_entries": [rr["jit_entries"] for rr in rep["replica_reports"]],
        "tokens": {"count": len(toks), "min": min(toks, default=None),
                   "max": max(toks, default=None),
                   "per_request": sorted({len(o) for o in streams.values()}),
                   "streams_sha256": hashlib.sha256(json.dumps(
                       sorted(streams.items()), default=int).encode()
                   ).hexdigest()}}))
    if args.out:
        with open(args.out, "w") as f:
            json.dump(rep, f, indent=2)
        print(f"[fleet] report -> {args.out}")
    for eng in fleet.engines:
        eng.close()
    return rep


def _print_report(args, engine, rep, streams, launches):
    """The JAX CLI's ``[serve]`` lines, the port's ``[serve] device``
    line, and the report to ``--out``."""
    cuda = engine.device.type == "cuda"
    ttft, tpot = rep["ttft"], rep["tpot"]
    print(f"[serve] arch={args.arch} policy={args.policy} skew={args.skew} "
          f"slots={args.batch} requests={rep['n_requests']} rate={args.rate}")
    print(f"[serve] TTFT p50 {ttft['p50'] * 1e3:.1f} ms  "
          f"p99 {ttft['p99'] * 1e3:.1f} ms   "
          f"TPOT p50 {tpot['p50'] * 1e3:.2f} ms   "
          f"decode {rep['throughput_tok_s']:.1f} tok/s "
          f"(occupancy {rep['mean_occupancy']:.2f}/{args.batch})")
    moe = rep.get("moe", {})
    if any(k.endswith("moved_units") for k in moe):
        for phase in ("prefill", "decode"):
            if f"{phase}/moved_units" not in moe:
                continue
            drops = moe.get(f"{phase}/send_drops", 0.0) \
                + moe.get(f"{phase}/dest_drops", 0.0)
            print(f"[serve] {phase} schedule: "
                  f"moved={moe[f'{phase}/moved_units']:.0f} "
                  f"drops={drops:.0f} "
                  f"max_load {moe.get(f'{phase}/max_load_before', 0):.0f}"
                  f"->{moe.get(f'{phase}/max_load_after', 0):.0f}")
    for phase, sec in rep.get("load_balance", {}).items():
        if "max_mean_ratio" not in sec:
            continue
        print(f"[serve] {phase} load: max/mean ratio "
              f"{sec['max_mean_ratio']:.2f}  "
              f"straggler_wait {sec['straggler_wait_units']:.1f} units  "
              f"drops {sec.get('send_drops_total', 0):.0f}/"
              f"{sec.get('dest_drops_total', 0):.0f}")
    eng_rep = rep["engine"]
    if args.replica_slots:
        print(f"[serve] replication: slots={eng_rep['replica_slots']} "
              f"interval={eng_rep.get('rebalance_interval', 0)} "
              f"swaps={eng_rep.get('replica_swaps', 0)} "
              f"hot={eng_rep.get('hot_experts', [])}")
    if args.paged:
        util = rep.get("kv_utilization")
        print(f"[serve] paged KV: blocks={eng_rep['num_kv_blocks']} "
              f"x{eng_rep['kv_block_size']} tokens  "
              f"utilization={util if util is None else f'{util:.2f}'}  "
              f"preemptions={rep['preemptions']}  "
              f"max_concurrency={rep['max_occupancy']}  "
              f"fused_attention={eng_rep['fused_paged_attention']}")
    if args.prefix_sharing:
        hit = rep.get("prefix_hit_rate")
        print(f"[serve] prefix cache: "
              f"hit_rate={hit if hit is None else f'{hit:.2f}'}  "
              f"cow_copies={rep['cow_copies']}  "
              f"evictions={rep['evictions']}  "
              f"resume_cached_tokens={rep['resume_cached_tokens']}")
    if args.resident_experts and "residency" in rep:
        res = rep["residency"]
        hr = res.get("hit_rate")
        print(f"[serve] residency: budget={eng_rep['resident_experts']} "
              f"policy={eng_rep.get('prefetch_policy')}  "
              f"hit_rate={hr if hr is None else f'{hr:.2f}'}  "
              f"swaps={res['swaps']} prefetches={res['prefetches']}  "
              f"stall={res['stall_units']:.4f}s  "
              f"staged={res['bytes_staged'] / 1e6:.1f} MB")
    if args.speculative_k and "speculative" in rep:
        sp = rep["speculative"]
        acc = sp["acceptance_rate"]
        print(f"[serve] speculative k={args.speculative_k} "
              f"policy={args.speculative_policy}: "
              f"acceptance={acc if acc is None else f'{acc:.2f}'}  "
              f"tokens/step={sp['tokens_per_step']:.2f}  "
              f"steps/token={sp['steps_per_committed_token']:.2f}")
    print(f"[serve] jit entries {rep['jit_entries']} "
          f"recompiled_after_warmup={rep.get('recompiled_after_warmup')}")
    # the port's own line: what ran where, and what came out
    toks = [t for out in streams.values() for t in out]
    core = engine.core
    print("[serve] device " + json.dumps({
        "device": (torch.cuda.get_device_name(engine.device) if cuda
                   else str(engine.device)),
        "peak_mem_gib": (torch.cuda.max_memory_allocated(engine.device)
                         / 2 ** 30 if cuda else None),
        "launches": launches,
        "comm": rep["engine"].get("comm"),
        "tokens": {"count": len(toks), "min": min(toks, default=None),
                   "max": max(toks, default=None),
                   "per_request": sorted({len(o) for o in streams.values()}),
                   "streams_sha256": hashlib.sha256(json.dumps(
                       sorted(streams.items()), default=int).encode()
                   ).hexdigest()},
        "noise_predraw_ms": core.predraw_ms("noise"),
        "noise_predraws": core.predraw_calls["noise"],
        "skew_predraw_ms": {e: core.predraw_ms(e)
                            for e in ("prefill_chunk", "decode")}}))
    if args.out:
        with open(args.out, "w") as f:
            json.dump(rep, f, indent=2)
        print(f"[serve] report -> {args.out}")


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--reduced", action="store_true")
    ap.add_argument("--batch", type=int, default=4,
                    help="decode slots (concurrent requests)")
    ap.add_argument("--prompt-len", type=int, default=64)
    ap.add_argument("--gen", type=int, default=16)
    ap.add_argument("--skew", type=float, default=0.0)
    ap.add_argument("--policy", default="harmoeny", choices=POLICIES)
    ap.add_argument("--moe-policy", default="", choices=[""] + POLICIES,
                    help="decode-time scheduling policy override (default: "
                         "--policy everywhere)")
    ap.add_argument("--q-tokens", type=int, default=0,
                    help="scheduler token-unit granularity override (0 = "
                         "auto threshold; small values let tiny decode "
                         "batches redistribute)")
    ap.add_argument("--data-par", type=int, default=0)
    ap.add_argument("--model-par", type=int, default=1,
                    help="expert-parallel degree: virtual ranks on the card, "
                         "or one process a rank under a launcher that sets "
                         "RANK and WORLD_SIZE")
    ap.add_argument("--seed", type=int, default=0)
    add_engine_flags(ap)
    ap.add_argument("--requests", type=int, default=0,
                    help="total requests (default: one closed batch)")
    ap.add_argument("--rate", type=float, default=0.0,
                    help="Poisson arrival rate req/s (0 = all at t=0)")
    ap.add_argument("--sliding-window", type=int, default=-1,
                    help="override the arch's sliding window (-1 = keep)")
    ap.add_argument("--shared-prefix-len", type=int, default=0,
                    help="synthetic prompts share their first K tokens")
    ap.add_argument("--replicas", type=int, default=1,
                    help="engine replicas behind the fleet router (> 1 "
                         "enables fleet mode; virtual replicas share one "
                         "model and one set of weights)")
    ap.add_argument("--routing-policy", default="load",
                    choices=list(ROUTING_POLICIES),
                    help="fleet routing: load = least queued+KV tokens, "
                         "prefix_affinity = load minus cached-prefix "
                         "match (needs --prefix-sharing to matter), "
                         "round_robin = baseline")
    ap.add_argument("--affinity-weight", type=float, default=1.0,
                    help="tokens of load one cached prefix token offsets "
                         "under prefix_affinity routing")
    ap.add_argument("--disaggregate", action="store_true",
                    help="split the fleet into prefill-role and decode-"
                         "role engines linked by KV handoff (needs "
                         "--paged and --replicas >= 2)")
    ap.add_argument("--trace", default="",
                    help="JSON trace file of arrival records")
    ap.add_argument("--out", default="", help="write the report JSON here")
    return ap


def main(argv=None):
    import torch.distributed as dist
    started = dist.is_initialized()
    try:
        serve(build_parser().parse_args(argv))
    finally:
        if dist.is_initialized() and not started:
            dist.destroy_process_group()


if __name__ == "__main__":
    main()
