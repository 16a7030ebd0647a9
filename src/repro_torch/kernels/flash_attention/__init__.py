"""Flash attention kernel (port of repro/kernels/flash_attention)."""
