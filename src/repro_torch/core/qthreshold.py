"""Token-transfer threshold q (paper §4.4, Eq. 4) on an NVIDIA H100.

Paper:  q > phi * d_type / (2 * beta), with phi the card's compute rate and
beta the bandwidth of the link experts are fetched over.  Between H100s of
one host that link is NVLink; with a dense all-to-all fetch the zeros of
the other ranks ride the wire, which divides the useful bandwidth by the
EP degree (``dense_fetch``), as in the JAX package's adaptation.
"""
from __future__ import annotations

from dataclasses import dataclass


@dataclass(frozen=True)
class HardwareSpec:
    """NVIDIA H100 SXM, data-sheet figures (dense, no sparsity)."""
    peak_flops: float = 989e12       # bf16 FLOP/s
    hbm_bw: float = 3.35e12          # B/s
    link_bw: float = 450e9           # NVLink, B/s each way
    dtype_bytes: int = 2             # bf16


H100 = HardwareSpec()


def q_threshold(hw: HardwareSpec = H100, *, ep_degree: int = 1,
                dense_fetch: bool = True) -> int:
    """Eq. 4 over the fetch link. Returns a per-chunk token count."""
    penalty = ep_degree if dense_fetch else 1
    beta_eff = hw.link_bw / max(penalty, 1)
    q = hw.peak_flops * hw.dtype_bytes / (2.0 * beta_eff)
    return int(q) + 1
