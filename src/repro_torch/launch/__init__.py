"""Launch: serving steps of the model zoo (``repro.launch.steps`` without
mesh or jit) and the serving CLI, ``python -m repro_torch.launch.serve``."""
