"""The benchmark harness of the PyTorch port (see bench/run.py)."""
