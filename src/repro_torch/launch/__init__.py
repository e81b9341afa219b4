"""Serving steps of the model zoo (``repro.launch.steps`` without mesh
or jit)."""
