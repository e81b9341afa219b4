"""One-launch cascade decision head: CUDA kernel + plain version."""
