"""Three-term roofline from a step's counted work (the port of
``repro.launch.roofline``):

    compute    = FLOPs / peak FLOP/s
    memory     = bytes / HBM bytes/s
    collective = collective bytes / (links x link bytes/s)

The FLOPs and bytes come from ``launch.op_costs`` (the reference's come
from its compiled HLO).  ``PRESETS`` keeps the reference's presets by
name, so a test can hold the two modules to the same terms, and adds
``h100``: NVIDIA's H100 SXM data sheet, 989 TFLOP/s dense bf16, 3.35
TB/s HBM3, 80 GB, 450 GB/s of NVLink each way, one link counted.
``h100`` is this module's default and its constants': the port runs on
that card, and no other preset's figure stands for it.
"""

from __future__ import annotations

import dataclasses


@dataclasses.dataclass(frozen=True)
class HWPreset:
    """Per-chip hardware ceilings for one accelerator target."""

    name: str
    peak_flops: float       # FLOP/s (dense matmul, bf16 or vendor peak)
    hbm_bw: float           # bytes/s main-memory bandwidth
    ici_bw: float           # bytes/s per interconnect link
    ici_links: int = 1      # links counted as serializing collectives
    hbm_bytes: float | None = None   # device memory, where stated


PRESETS = {
    # NVIDIA H100 SXM (data sheet): 989 TFLOP/s dense bf16, 3.35 TB/s
    # HBM3, 80 GB, NVLink 900 GB/s all to all = 450 GB/s each way
    "h100": HWPreset("h100", 989e12, 3.35e12, 450e9, 1, 80e9),
    # the reference's presets, by name: its TPU v5e, A100-class GPU and
    # CPU socket figures, never a default here
    "tpu-v5e": HWPreset("tpu-v5e", 197e12, 819e9, 50e9, 1),
    "gpu": HWPreset("gpu", 312e12, 2.04e12, 600e9, 1),
    "cpu": HWPreset("cpu", 1e12, 100e9, 10e9, 1),
}

_DEFAULT = PRESETS["h100"]
PEAK_FLOPS = _DEFAULT.peak_flops
HBM_BW = _DEFAULT.hbm_bw
ICI_BW = _DEFAULT.ici_bw
ICI_LINKS = _DEFAULT.ici_links


def detect_preset() -> HWPreset:
    """The preset of the card present: ``h100`` where
    ``torch.cuda.get_device_name()`` names an H100, ``gpu`` for another
    CUDA card, ``cpu`` without one."""
    import torch
    if not torch.cuda.is_available():
        return PRESETS["cpu"]
    if "H100" in torch.cuda.get_device_name():
        return PRESETS["h100"]
    return PRESETS["gpu"]


def resolve_preset(name: str | None) -> HWPreset:
    """Preset by name; ``None`` or ``"auto"`` detects from the card."""
    if name is None or name == "auto":
        return detect_preset()
    return PRESETS[name]


@dataclasses.dataclass
class Roofline:
    flops: float
    hbm_bytes: float
    collective_bytes: float
    hw: HWPreset = _DEFAULT

    @property
    def t_compute(self):
        return self.flops / self.hw.peak_flops

    @property
    def t_memory(self):
        return self.hbm_bytes / self.hw.hbm_bw

    @property
    def t_collective(self):
        return self.collective_bytes / (self.hw.ici_bw * self.hw.ici_links)

    @property
    def dominant(self):
        terms = {"compute": self.t_compute, "memory": self.t_memory,
                 "collective": self.t_collective}
        return max(terms, key=terms.get)

    @property
    def t_bound(self):
        return max(self.t_compute, self.t_memory, self.t_collective)

    def as_dict(self):
        return {
            "flops": self.flops,
            "hbm_bytes": self.hbm_bytes,
            "collective_bytes": self.collective_bytes,
            "t_compute_s": self.t_compute,
            "t_memory_s": self.t_memory,
            "t_collective_s": self.t_collective,
            "t_bound_s": self.t_bound,
            "dominant": self.dominant,
            "hw": self.hw.name,
        }


def model_flops(cfg, shape, params_active: float) -> float:
    """6·N·D reference FLOPs (N = active params, D = tokens) — global."""
    if shape.kind == "train":
        tokens = shape.global_batch * shape.seq_len
        return 6.0 * params_active * tokens
    if shape.kind == "prefill":
        tokens = shape.global_batch * shape.seq_len
        return 2.0 * params_active * tokens
    # decode: one token per sequence
    return 2.0 * params_active * shape.global_batch


def active_params(cfg, total_params: float) -> float:
    """Active (per-token) parameter count for MoE archs."""
    if cfg.moe is None:
        return total_params
    m = cfg.moe
    dff = m.d_ff_expert or cfg.d_ff
    per_expert = 3 * cfg.d_model * dff
    n_layers_moe = sum(cfg.moe_pattern) * (cfg.num_layers // len(cfg.moe_pattern))
    inactive = per_expert * (m.num_experts - m.top_k) * n_layers_moe
    return total_params - inactive
