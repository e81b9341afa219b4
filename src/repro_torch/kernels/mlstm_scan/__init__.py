"""Chunkwise mLSTM recurrence: CUDA kernel + plain versions."""
