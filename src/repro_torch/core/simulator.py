"""Deterministic per-rank time model of one MoE layer's schedule, on an
NVIDIA H100's costs (port of ``repro/core/simulator.py``, whose defaults
are a TPU v5e's).

It prices a schedule S [G, Ep, G] from the real scheduler:

  compute[g]  = load[g] * unit_flops / (peak_flops * mfu)   (expert math)
  fetch[g]    = n_foreign[g] * expert_bytes * fetch_penalty / link_bw
                + host misses * expert_bytes / host_bw,
                overlapped with compute (paper §4.3): busy = max(comp, fetch)
  a2a         = 2 * max_g off-diagonal payload bytes / link_bw
  metadata    = G * Ep * 4 bytes / link_bw + launch latency
  scheduler   = rebalance iterations * per-iteration cost + launch latency

  layer time  = max_g busy[g] + a2a + metadata + scheduler
  idle[g]     = layer - busy[g]   (the paper's Fig. 5/11 waiting time)

The link between ranks is NVLink (``qthreshold.H100.link_bw``) where the
reference's is ICI.  Host code only: numpy, no device part.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Dict

import numpy as np

from repro_torch.core.qthreshold import H100, HardwareSpec
from repro_torch.core.topology import EPTopology, local_slot_of


@dataclass(frozen=True)
class SimCosts:
    hw: HardwareSpec = H100
    d_model: int = 768
    d_ff: int = 3072
    n_matrices: int = 2          # 2 for gelu MLP, 3 for swiglu
    dtype_bytes: int = 2
    # the fetch reads a peer's rows over the link, x2 for link contention
    # (the reference's factor)
    fetch_penalty: float = 2.0
    # Alg. 2's per-iteration cost: the records hold none to separate.  The
    # one-CTA `schedule` kernel reads 6.2-12.7 us a call at 0 to 18
    # iterations, which is launch latency (`chip_smoke.py` phase 2,
    # PERF.md §6; NVIDIA H100 80GB HBM3, 700.00 W), so the whole cost is
    # the launch below and an iteration adds nothing measurable
    sched_iter_us: float = 0.0
    # a kernel launch: the `schedule` kernel's smallest readings, 6.2-6.7
    # us (`chip_smoke.py` phase 2; NVIDIA H100 80GB HBM3, 700.00 W)
    launch_us: float = 6.2
    # achievable share of the expert GEMMs' bound: `moe_gmm` at the serve
    # decode, 0.0953 ms bound / 0.1742 ms measured (`chip_smoke.py` phase
    # 2, PERF.md §6; NVIDIA H100 80GB HBM3, 700.00 W)
    mfu: float = 0.547
    # host-tier staging (tiered residency): a 415.2 MB expert row from
    # pinned host memory at 48 GB/s (`chip_smoke.py` phase 8, PERF.md §7;
    # NVIDIA H100 80GB HBM3, 700.00 W)
    host_bw: float = 48e9

    @property
    def unit_flops(self) -> float:
        return 2.0 * self.d_model * self.d_ff * self.n_matrices

    @property
    def expert_bytes(self) -> float:
        return self.n_matrices * self.d_model * self.d_ff * self.dtype_bytes


def simulate_layer(S: np.ndarray, topo: EPTopology, costs: SimCosts,
                   sched_iters: int = 0, drops: int = 0,
                   extra_local: np.ndarray | None = None,
                   non_local: np.ndarray | None = None,
                   hidden_stages: np.ndarray | None = None
                   ) -> Dict[str, float]:
    """S: [G, Ep, G] schedule.  Returns per-layer timing + balance metrics.

    ``extra_local`` [G, Ep] bool marks experts resident at a destination
    beyond its static shard (the hot-expert replica slots): units there
    cost compute but no fetch.  ``non_local`` [G, Ep] bool demotes
    statically placed experts swapped out of HBM (tiered residency):
    units scheduled to a demoted pair pay a host-tier fetch
    (``expert_bytes / host_bw``) unless ``hidden_stages`` [G, Ep] marks
    the miss as staged ahead of use, when only its bytes, not the stall,
    are charged."""
    G = topo.num_ranks
    S = np.asarray(S)
    load = S.sum(axis=(0, 1)).astype(np.float64)               # per dest
    lsl = local_slot_of(topo).copy()
    if extra_local is not None:
        lsl = np.where(np.asarray(extra_local), np.maximum(lsl, 0), lsl)
    active = np.array([[S[:, e, g].sum() > 0
                        for e in range(topo.padded_experts)]
                       for g in range(G)])                     # [G, Ep]
    demoted = np.zeros_like(active)
    if non_local is not None:
        demoted = np.asarray(non_local) & (lsl >= 0)
        if hidden_stages is not None:
            demoted = demoted & ~np.asarray(hidden_stages)
        lsl = np.where(np.asarray(non_local), -1, lsl)
    foreign = (active & (lsl < 0) & ~demoted).sum(axis=1)
    host_misses = (active & demoted).sum(axis=1)

    link = costs.hw.link_bw
    comp = load * costs.unit_flops / (costs.hw.peak_flops * costs.mfu)
    fetch = foreign * costs.expert_bytes * costs.fetch_penalty / link \
        + host_misses * costs.expert_bytes / costs.host_bw
    busy = np.maximum(comp, fetch)

    offdiag = S.sum(axis=1) * (1 - np.eye(G, dtype=np.int64))
    a2a_bytes = max(offdiag.sum(axis=1).max(), offdiag.sum(axis=0).max()) \
        * costs.d_model * costs.dtype_bytes
    a2a = 2.0 * a2a_bytes / link
    metadata = (G * topo.padded_experts * 4) / link + costs.launch_us * 1e-6
    sched = sched_iters * costs.sched_iter_us * 1e-6 + costs.launch_us * 1e-6

    layer = busy.max() + a2a + metadata + sched
    idle = layer - busy
    total_units = float(S.sum())
    return {
        "layer_s": float(layer),
        "compute_s": float(comp.max()),
        "fetch_s": float(fetch.max()),
        "host_stall_s": float(
            (host_misses * costs.expert_bytes / costs.host_bw).max()),
        "a2a_s": float(a2a),
        "sched_s": float(sched),
        "metadata_s": float(metadata),
        "idle_frac_mean": float(idle.mean() / layer) if layer > 0 else 0.0,
        "idle_frac_max": float(idle.max() / layer) if layer > 0 else 0.0,
        "max_load": float(load.max()),
        "mean_load": float(load.mean()),
        "imbalance": float(load.max() / max(load.mean(), 1e-9)),
        "tokens_per_s": total_units / layer if layer > 0 else 0.0,
        "dropped": float(drops),
    }
