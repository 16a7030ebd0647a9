"""Model layers, attention, stacks and the build_model entry point."""
