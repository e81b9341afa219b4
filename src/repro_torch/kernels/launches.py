"""Launch counts of the kernel wrappers: which kernels a run really went
through."""

from __future__ import annotations

from repro_torch.kernels.flash_attention import ops as fa_ops
from repro_torch.kernels.mlstm_scan import ops as ml_ops
from repro_torch.kernels.router_cascade import ops as rc_ops
from repro_torch.kernels.router_score import ops as rs_ops

WRAPPERS = {
    "router_score": rs_ops.router_score_fused,
    "router_cascade": rc_ops.router_score_cascade_fused,
    "flash_attention": fa_ops.flash_attention,
    "flash_attention_bwd": fa_ops.flash_attention_bwd,
    "mlstm_scan": ml_ops.mlstm_chunkwise,
    "mlstm_scan_bwd": ml_ops.mlstm_chunkwise_bwd,
}


def launch_counts() -> dict:
    """Kernel launches per wrapper since the last reset."""
    return {name: fn.launches for name, fn in WRAPPERS.items()}


def reset_launch_counts() -> None:
    for fn in WRAPPERS.values():
        fn.launches = 0
