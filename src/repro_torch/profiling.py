"""Where a step's time goes on the card: ``torch.profiler`` (CPU and CUDA
activities) over a few calls of a step, summarised per step.  Used by
``scripts/profile_torch_serve.py`` and ``chip_smoke.py``'s eager against
captured phase.  A device number here comes only from a run on a CUDA
device.

Per step: the wall time under the profiler (and, from ``untraced_ms``,
without it), the device's busy time (the CUDA kernels' own times,
graph-replayed kernels included) and idle share, host launches
(``cudaLaunchKernel`` and its variants, and ``cudaGraphLaunch``), and
host-device copies and synchronisations.
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
    return summarize(prof, label, wall, n_steps)


def untraced_ms(fn: Callable[[], Any], n_steps: int) -> float:
    """Wall ms per call of ``fn`` without the profiler, synchronised."""
    import torch
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(n_steps):
        fn()
    torch.cuda.synchronize()
    return (time.perf_counter() - t0) * 1e3 / n_steps
