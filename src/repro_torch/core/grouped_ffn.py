"""Grouped expert FFN over the block-aligned dispatch buffer.

Port of ``repro/core/grouped_ffn.py``.  The JAX package chooses between a
tile-scan reference and the Pallas kernel with ``use_pallas``; here the
tensors' device chooses: ``kernels.moe_gmm`` launches the CUDA kernel on
the card and runs its plain version on the CPU, so this module only names
that entry under the reference's module path.  The grouped buffer's rows
beyond each group's real size are zeros, and every activation maps 0 to
0, so padding contributes exact zeros.
"""
from repro_torch.kernels.moe_gmm.ops import fused_expert_ffn as grouped_ffn
from repro_torch.kernels.moe_gmm.ops import tile_group_map

__all__ = ["grouped_ffn", "tile_group_map"]
