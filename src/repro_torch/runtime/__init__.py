"""Failure injection and restart orchestration (port of ``repro/runtime/``)."""
