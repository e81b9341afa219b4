"""Fused routing head: CUDA kernel + plain version."""
