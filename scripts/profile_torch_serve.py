#!/usr/bin/env python3
"""Where a step's time goes on the GPU, under ``torch.profiler``, on one
of the PyTorch port's paths (random weights, bf16):

    python3 scripts/profile_torch_serve.py [--decode-steps 4]
    python3 scripts/profile_torch_serve.py --arch switch128 --slab
    python3 scripts/profile_torch_serve.py --path ep [--decode-steps 4]
    python3 scripts/profile_torch_serve.py --path prefill [--decode-steps 4]
    python3 scripts/profile_torch_serve.py --eager [--arch ...] [--slab]
    python3 scripts/profile_torch_serve.py --arch mixtral-8x7b --layers 8

``serve`` (the default): a full-width model (``--arch``, default
qwen15-moe-a27b; also moonshot-v1-16b-a3b, switch128 or mixtral-8x7b,
whose 32 layers do not fit one card: ``--layers`` cuts the depth) in
``ServeEngine`` with 4 slots, on the paged KV pool or, with ``--slab``,
on the slab (the engine's default); traces the first 32-token prefill
chunk of a request (and the second, untraced), then, with every slot
decoding, a few pure decode steps: the prefill chunk, the decode step and
the KV store's write captured as CUDA graphs at ``warmup()``, as the
engine runs them, and with ``--eager`` also the same engine with every
entry eager (``stepcore.eager()``), each phase printed for both, in one
call.
``ep``: the same at expert-parallel degree 4 on virtual ranks under the
synthetic skew of ``chip_smoke.py``'s phase 4b (0.9 on one expert,
q = 1), once with the harmoeny schedule and once with round_robin.
``prefill``: full-width, full-depth moonshot-v1-16b-a3b through
``launch.steps``; after one untraced warm-up prefill, traces one
whole-prompt prefill step (4 prompts of 1024 tokens, flash attention)
and then a few slab decode steps.  For each phase it prints one
JSON line (``repro_torch.profiling``): the wall time per step, the
device's busy time (the sum of the CUDA kernels' own times) and idle
share, host launches (kernels and graphs), the kernels that took the most
device time, the host-side operators that took the most CPU time, and the
count of host-device copies and synchronisations.
"""
from __future__ import annotations

import argparse
import gc
import json
import os
import sys
import time

HERE = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, os.path.join(HERE, "..", "src"))


def summarize(prof, label: str, wall_s: float, n_steps: int):
    from repro_torch.profiling import summarize as summary
    rep = summary(prof, label, wall_s, n_steps)
    print(json.dumps(rep), flush=True)
    return rep


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--decode-steps", type=int, default=4)
    ap.add_argument("--path", choices=("serve", "ep", "prefill"),
                    default="serve")
    ap.add_argument("--arch", default="qwen15-moe-a27b",
                    help="the serve path's model")
    ap.add_argument("--layers", type=int, default=0,
                    help="serve / ep paths: the model's first N layers "
                         "(0: the config's depth)")
    ap.add_argument("--slab", action="store_true",
                    help="serve path: the slab KV pool instead of the "
                         "paged one")
    ap.add_argument("--eager", action="store_true",
                    help="serve / ep paths: also profile the eager prefill "
                         "chunk and decode step (stepcore.eager()) beside "
                         "the captured ones")
    args = ap.parse_args()
    import torch
    if not torch.cuda.is_available():
        print("profile_torch_serve: no CUDA device", file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    if args.path == "prefill":
        return profile_prefill(args.decode_steps)
    modes = (True, False) if args.eager else (False,)
    policies = ("harmoeny", "round_robin") if args.path == "ep" else (None,)
    for policy in policies:
        for eager in modes:
            profile_serve(args.decode_steps, arch=args.arch,
                          layers=args.layers, paged=not args.slab,
                          eager=eager,
                          ep_degree=4 if policy else 1,
                          policy=policy or "harmoeny")
            gc.collect()                   # the engine holds cycles
            torch.cuda.empty_cache()
    return 0


def _timed(fn, n_steps: int = 1, traced: bool = True):
    """Run ``fn`` n_steps times, synchronised; returns (profiler or None,
    wall seconds)."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    if not traced:
        t0 = time.perf_counter()
        for _ in range(n_steps):
            fn()
        torch.cuda.synchronize()
        return None, time.perf_counter() - t0
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(n_steps):
            fn()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    return prof, wall


def profile_prefill(decode_steps: int) -> int:
    import numpy as np
    import torch
    from repro_torch.configs.registry import get_config
    from repro_torch.launch.steps import make_decode_step, make_prefill_step
    from repro_torch.models.model import build_model
    cfg = get_config("moonshot-v1-16b-a3b")
    B, S = 4, 1024
    model = build_model(cfg, batch=B, seq_len=S)
    params = model.init(0)
    prompts = torch.as_tensor(np.random.default_rng(0).integers(
        0, cfg.vocab_size, (B, S)), dtype=torch.int32, device="cuda")
    prefill = make_prefill_step(model, s_max=S + 64)
    decode = make_decode_step(model)
    state = {}

    def run_prefill():
        state["out"] = prefill(params, {"tokens": prompts})

    def run_decode():
        tok, caches, pos, _ = state["out"]
        state["out"] = decode(params, tok, caches, pos)
    _timed(run_prefill, traced=False)                 # warm-up
    prof, wall = _timed(run_prefill)
    summarize(prof, "prefill_whole_prompt", wall, 1)
    _, wall = _timed(run_prefill, traced=False)
    print(json.dumps({"phase": "prefill_whole_prompt_unprofiled",
                      "wall_ms_per_step": wall * 1e3}), flush=True)
    prof, wall = _timed(run_decode, decode_steps)
    summarize(prof, "decode_slab", wall, decode_steps)
    _, wall = _timed(run_decode, decode_steps, traced=False)
    print(json.dumps({"phase": "decode_slab_unprofiled",
                      "wall_ms_per_step": wall * 1e3 / decode_steps}),
          flush=True)
    return 0


def profile_serve(decode_steps: int, ep_degree: int = 1,
                  policy: str = "harmoeny", arch: str = "qwen15-moe-a27b",
                  layers: int = 0, paged: bool = True,
                  eager: bool = False) -> int:
    import contextlib
    from repro_torch.serve import stepcore
    with stepcore.eager() if eager else contextlib.nullcontext():
        return _profile_serve(decode_steps, ep_degree, policy, arch, layers,
                              paged, "_eager" if eager else "_captured")


def _profile_serve(decode_steps, ep_degree, policy, arch, layers, paged,
                   mode):
    import dataclasses
    import numpy as np
    import torch
    from torch.profiler import ProfilerActivity, profile
    from repro_torch.configs.registry import get_config
    from repro_torch.models.model import build_model
    from repro_torch.serve import EngineConfig, Request, ServeEngine
    cfg = get_config(arch)
    if layers:
        cfg = cfg.replace(num_layers=layers)
    if ep_degree > 1:             # chip_smoke.py phase 4b's skewed routing
        cfg = dataclasses.replace(cfg, moe=dataclasses.replace(
            cfg.moe, policy=policy, router_skew=0.9, q_tokens=1))
    slots, chunk = 4, 32
    model = build_model(cfg, batch=slots, seq_len=288, ep_degree=ep_degree)
    params = model.init(0)
    eng = ServeEngine(model, params, EngineConfig(
        max_slots=slots, max_seq_len=288, prefill_chunk=chunk,
        paged=paged, kv_block_size=16))
    tag = f"_{cfg.name}{f'_{layers}layers' if layers else ''}" \
        f"_{'paged' if paged else 'slab'}"
    if ep_degree > 1:
        tag += f"_ep{ep_degree}_{policy}"
    tag += mode
    eng.warmup()
    rng = np.random.default_rng(0)
    for i in range(slots):
        eng.submit(Request(rid=i, tokens=rng.integers(0, cfg.vocab_size,
                                                      (128,)),
                           max_new_tokens=64))
    acts = [ProfilerActivity.CPU, ProfilerActivity.CUDA]
    # the first prefill chunk, alone (no slot decodes yet)
    eng._admit(eng.clock.now())
    torch.cuda.synchronize()
    with profile(activities=acts) as prof:
        t0 = time.perf_counter()
        eng._prefill_work(eng.clock.now())
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    summarize(prof, "prefill_chunk" + tag, wall, 1)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    eng._prefill_work(eng.clock.now())
    torch.cuda.synchronize()
    print(json.dumps({"phase": "prefill_chunk_unprofiled" + tag,
                      "wall_ms_per_step": (time.perf_counter() - t0) * 1e3,
                      "skew_predraw_host_ms_per_step":
                          eng.core.predraw_ms("prefill_chunk")}),
          flush=True)
    while not eng.active.all():      # fill every slot
        eng.step()
    # pure decode steps of the 4-slot batch
    with profile(activities=acts) as prof:
        t0 = time.perf_counter()
        for _ in range(decode_steps):
            eng._decode_work(eng.clock.now())
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    summarize(prof, "decode" + tag, wall, decode_steps)
    # the same steps without the profiler, for its overhead
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(decode_steps):
        eng._decode_work(eng.clock.now())
    torch.cuda.synchronize()
    core = eng.core
    print(json.dumps({"phase": "decode_unprofiled" + tag,
                      "wall_ms_per_step": (time.perf_counter() - t0) * 1e3
                      / decode_steps,
                      "jit_entries": eng.report()["jit_entries"],
                      "skew_predraw_host_ms_per_step":
                          core.predraw_ms("decode")}),
          flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
