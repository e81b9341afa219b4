"""The bfloat16 flash-attention forward kernel
(``flash_attention_kernel_bf16`` of ``csrc/flash_attention_bf16.cu``) in
the traced stretch: the least time its calls could take (operations
over the bf16 rate, or bytes over the memory bandwidth, whichever is
larger) over its device time, %."""

from harness.readers import roofline


def match(name):
    return "flash_attention_kernel_bf16" in name


def read(run):
    return roofline(run, "bfloat16", match)
