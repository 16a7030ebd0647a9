"""Grouped expert FFN kernel (port of repro/kernels/moe_gmm)."""
