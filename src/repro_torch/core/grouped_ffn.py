"""Grouped expert FFN over the block-aligned dispatch buffer.

Port of ``repro/core/grouped_ffn.py``.  The JAX package chooses between a
tile-scan reference and the Pallas kernel with ``use_pallas``; here the
MoE block's ``kernels`` flag chooses: ``grouped_ffn`` is
``kernels.moe_gmm``'s entry, which launches the CUDA kernel on the card
and runs its plain version on the CPU, and ``grouped_ffn_ref`` is the
reference on any device, the one autograd can differentiate (training).
The grouped buffer's rows beyond each group's real size are zeros, and
every activation maps 0 to 0, so padding contributes exact zeros.
"""
from __future__ import annotations

from typing import Optional

import torch
from torch.utils.checkpoint import checkpoint

from repro_torch.kernels.moe_gmm.ops import Foreign, moe_gmm_plain
from repro_torch.kernels.moe_gmm.ops import fused_expert_ffn as grouped_ffn
from repro_torch.kernels.moe_gmm.ops import tile_group_map

__all__ = ["grouped_ffn", "grouped_ffn_ref", "tile_group_map"]


def grouped_ffn_ref(x: torch.Tensor, w_in: torch.Tensor, w_out: torch.Tensor,
                    group_sizes_padded: torch.Tensor, *,
                    w_gate: Optional[torch.Tensor] = None, act: str = "silu",
                    block_m: int = 128, replica: Foreign = None,
                    foreign: Foreign = None,
                    foreign_rows: Optional[torch.Tensor] = None
                    ) -> torch.Tensor:
    """``grouped_ffn``'s function through the plain tile products on any
    device, differentiable.  When autograd records it (grad mode, an input
    that requires grad) the call runs under ``torch.utils.checkpoint``, as
    JAX checkpoints its tile scan: each tile's gathered weights are
    recomputed in backward, not stored.  ``foreign_rows`` feeds only the
    kernel's counter and is ignored."""
    M = x.shape[0]
    tg = tile_group_map(group_sizes_padded, M // block_m, block_m)

    def run(x, w_in, w_out, w_gate, replica, foreign):
        return moe_gmm_plain(x, w_in, w_out, tg, w_gate=w_gate, act=act,
                             block_m=block_m, replica=replica,
                             foreign=foreign)
    inputs = [x, w_in, w_out, w_gate, *(replica or ()), *(foreign or ())]
    if not (torch.is_grad_enabled()
            and any(t is not None and t.requires_grad for t in inputs)):
        return run(x, w_in, w_out, w_gate, replica, foreign)
    return checkpoint(run, x, w_in, w_out, w_gate, replica, foreign,
                      use_reentrant=False)
