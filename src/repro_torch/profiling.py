"""Where a step's time goes on the card: ``torch.profiler`` (CPU and CUDA
activities) over a few calls of a step, summarised per step.  Used by
``scripts/profile_torch_serve.py`` and ``chip_smoke.py``'s eager against
captured phase.  A device number here comes only from a run on a CUDA
device.

Per step: the wall time under the profiler (and, from ``untraced_ms``,
without it), the device's busy time (the CUDA kernels' own times,
graph-replayed kernels included) and idle share, host launches
(``cudaLaunchKernel`` and its variants, and ``cudaGraphLaunch``), and
host-device copies and synchronisations; and, by CUDA stream
(``streams``), the work beside the main stream: the MoE block's foreign
fetch runs on a side stream, so its device time and how much of it ran
beside the main stream's kernels are read here.
"""
from __future__ import annotations

import time
from typing import Any, Callable, Dict

LAUNCHES = ("cudaLaunchKernel", "cudaLaunchKernelExC", "cuLaunchKernel",
            "cuLaunchKernelEx")
GRAPH_LAUNCHES = ("cudaGraphLaunch",)
COPIES_AND_SYNCS = ("cudaStreamSynchronize", "cudaDeviceSynchronize",
                    "cudaMemcpyAsync", "cudaMemcpy")


def _dev_time(evt) -> float:
    for name in ("self_device_time_total", "self_cuda_time_total"):
        if hasattr(evt, name):
            return float(getattr(evt, name))
    return 0.0


def summarize(prof, label: str, wall_s: float, n_steps: int,
              top: int = 12) -> Dict[str, Any]:
    """A profiler's events over ``n_steps`` calls that took ``wall_s``."""
    import torch
    events = prof.key_averages()
    kernels = [e for e in events if _dev_time(e) > 0
               and e.device_type == torch.autograd.DeviceType.CUDA]
    busy_us = sum(_dev_time(e) for e in kernels)

    def count(keys):
        return sum(e.count for e in events if e.key in keys) / n_steps
    return {
        "phase": label, "steps": n_steps,
        "wall_ms_per_step": wall_s * 1e3 / n_steps,
        "device_busy_ms_per_step": busy_us / 1e3 / n_steps,
        "device_idle_share": 1.0 - busy_us / 1e6 / wall_s,
        "kernel_calls_per_step": sum(e.count for e in kernels) / n_steps,
        "host_launches_per_step": count(LAUNCHES),
        "graph_launches_per_step": count(GRAPH_LAUNCHES),
        "host_device_syncs_and_copies_per_step": count(COPIES_AND_SYNCS),
        "top_kernels_ms_per_step": [
            (e.key[:60], _dev_time(e) / 1e3 / n_steps, e.count // n_steps)
            for e in sorted(kernels, key=_dev_time, reverse=True)[:top]],
        "top_host_ops_ms_per_step": [
            (e.key[:60], e.self_cpu_time_total / 1e3 / n_steps,
             e.count // n_steps)
            for e in sorted(events, key=lambda e: e.self_cpu_time_total,
                            reverse=True)[:top]],
    }


def _union(spans):
    """Sorted, merged [start, end) intervals."""
    out = []
    for a, b in sorted(spans):
        if out and a <= out[-1][1]:
            out[-1][1] = max(out[-1][1], b)
        else:
            out.append([a, b])
    return out


def _overlap(xs, ys) -> float:
    """Length of the intersection of two merged interval lists."""
    i = j = 0
    total = 0.0
    while i < len(xs) and j < len(ys):
        lo, hi = max(xs[i][0], ys[j][0]), min(xs[i][1], ys[j][1])
        total += max(0.0, hi - lo)
        if xs[i][1] < ys[j][1]:
            i += 1
        else:
            j += 1
    return total


def streams(prof, n_steps: int, top: int = 4) -> Dict[str, Any]:
    """The device work by CUDA stream: the main stream is the one with
    the most kernel time; the rest (in the MoE block, the foreign fetch's
    side stream) give ``side_ms_per_step``, their kernels' time,
    ``side_overlap_ms_per_step``, the part of it that ran while a main
    stream kernel ran too, ``union_busy_ms_per_step``, the time anything
    ran, ``concurrent_ms_per_step``, the kernel time beyond that union
    (what ran beside other work, whichever streams the trace names), and
    the side streams' top kernels by name."""
    import torch
    by_stream: Dict[int, list] = {}
    names: Dict[int, Dict[str, float]] = {}
    for e in prof.profiler.kineto_results.events():
        if e.device_type() != torch.autograd.DeviceType.CUDA \
                or e.duration_ns() <= 0:
            continue
        sid = e.device_resource_id()
        by_stream.setdefault(sid, []).append(
            (e.start_ns(), e.start_ns() + e.duration_ns()))
        per = names.setdefault(sid, {})
        per[e.name()] = per.get(e.name(), 0.0) + e.duration_ns()
    if not by_stream:
        return {"streams": 0}
    total = {s: sum(b - a for a, b in v) for s, v in by_stream.items()}
    main = max(total, key=total.get)
    side = [iv for s, v in by_stream.items() if s != main for iv in v]
    main_u, side_u = _union(by_stream[main]), _union(side)
    all_u = _union(by_stream[main] + side)
    side_names: Dict[str, float] = {}
    for s, per in names.items():
        if s != main:
            for k, v in per.items():
                side_names[k] = side_names.get(k, 0.0) + v
    ms = 1e-6 / n_steps
    return {
        "streams": len(by_stream),
        "main_ms_per_step": total[main] * ms,
        "side_ms_per_step": sum(total[s] for s in total if s != main) * ms,
        "side_overlap_ms_per_step": _overlap(main_u, side_u) * ms,
        "union_busy_ms_per_step": sum(b - a for a, b in all_u) * ms,
        "concurrent_ms_per_step":
            (sum(total.values()) - sum(b - a for a, b in all_u)) * ms,
        "side_top_kernels_ms_per_step": [
            (k[:60], v * ms) for k, v in sorted(
                side_names.items(), key=lambda kv: -kv[1])[:top]],
    }


def profile_steps(fn: Callable[[], Any], n_steps: int,
                  label: str) -> Dict[str, Any]:
    """``fn`` called ``n_steps`` times under the profiler, synchronised."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(n_steps):
            fn()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    return {**summarize(prof, label, wall, n_steps),
            "streams": streams(prof, n_steps)}


def untraced_ms(fn: Callable[[], Any], n_steps: int) -> float:
    """Wall ms per call of ``fn`` without the profiler, synchronised."""
    import torch
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(n_steps):
        fn()
    torch.cuda.synchronize()
    return (time.perf_counter() - t0) * 1e3 / n_steps
