"""The dense attention block: pre-norm attention and pre-norm MLP, each
with its residual (``repro.models.blocks.apply_block`` for kind
``"attn"`` without MoE)."""

from __future__ import annotations

import torch
from torch import nn

from repro_torch.models import attention as attn_lib
from repro_torch.models.common import ModelConfig
from repro_torch.models.layers import apply_mlp, apply_norm, init_mlp, init_norm


class Block(nn.ModuleDict):
    """Parameters keyed as the JAX package's block tree: ``norm1``,
    ``mix`` (attention), and with ``d_ff > 0`` ``norm2`` and ``mlp``."""

    def __init__(self, gen: torch.Generator, cfg: ModelConfig,
                 layer_idx: int):
        dtype = cfg.torch_dtype
        mods = {"norm1": init_norm(cfg.d_model, cfg.norm_kind),
                "mix": attn_lib.init_attention(gen, cfg, dtype)}
        if cfg.d_ff > 0:
            mods["norm2"] = init_norm(cfg.d_model, cfg.norm_kind)
            mods["mlp"] = init_mlp(gen, cfg.d_model, cfg.d_ff, dtype, cfg.act)
        super().__init__(mods)
        self.cfg = cfg
        self.layer_idx = layer_idx

    def forward(self, x, positions):
        return apply_block(self, x, self.cfg, layer_idx=self.layer_idx,
                           positions=positions)


def apply_block(p, x, cfg: ModelConfig, *, layer_idx: int, positions):
    h = apply_norm(p["norm1"], x, cfg.norm_eps, cfg.norm_kind)
    window = attn_lib.layer_window(cfg, layer_idx)
    x = x + attn_lib.attend_full(p["mix"], h, cfg, positions,
                                 window).to(x.dtype)
    if "mlp" in p:
        h2 = apply_norm(p["norm2"], x, cfg.norm_eps, cfg.norm_kind)
        x = x + apply_mlp(p["mlp"], h2, cfg.act).to(x.dtype)
    return x
