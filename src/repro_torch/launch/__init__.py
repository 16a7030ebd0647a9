"""Step functions built from a model (port of ``repro/launch``)."""
