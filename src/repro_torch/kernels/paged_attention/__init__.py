"""Paged attention kernel (port of repro/kernels/paged_attention)."""
