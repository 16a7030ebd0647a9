"""Synthetic token datasets and a prefetching loader (port of ``repro/data/``)."""
