"""Online-softmax attention: CUDA kernel + plain version."""
