"""Fault-tolerant checkpoints (port of ``repro/checkpoint/``)."""
