"""The float32 flash-attention forward kernel (``flash_attention_kernel``
of ``csrc/flash_attention.cu``, 3xTF32) in the traced stretch: the
least time its calls could take (operations over the TF32 rate, or
bytes over the memory bandwidth, whichever is larger) over its device
time, %."""

from harness.readers import roofline


def match(name):
    return "flash_attention_kernel<" in name and "bf16" not in name


def read(run):
    return roofline(run, "float32", match)
