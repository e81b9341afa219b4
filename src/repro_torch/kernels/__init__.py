"""Hand-written CUDA kernels for Hopper, one per Pallas kernel of the
JAX package on the port's path, each beside its plain PyTorch version.

  router_score/     fused routing head: scores + constraint add + argmin
  router_cascade/   the same plus uncertainty head and depth-1 escalation
  flash_attention/  online-softmax attention (encoder attention) and its
                    gradient
  mlstm_scan/       chunkwise mLSTM recurrence (xLSTM prefill)

Sources live in ``csrc/``; ``build`` compiles them with nvcc into one
shared library at first use and binds it with ctypes.  Each wrapper
launches its kernel for CUDA tensors, runs the plain version for CPU
tensors, and counts its launches in a plain integer attribute
``launches`` (read and reset with ``kernels.launches``).
"""
