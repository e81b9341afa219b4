"""The dense encoder: embed -> blocks -> final norm -> (tied) logits.

``Model`` holds the JAX package's parameter tree as modules: ``embed``
(``table``), one ``Block`` per layer where the JAX package stacks a
``units`` tree along a leading layer axis and scans, ``final_norm``,
and ``head`` when embeddings are untied.  The layer loop is a Python
loop.  Modes: ``train`` returns logits, ``encode`` the final-norm
hidden states.
"""

from __future__ import annotations

import math

import torch
from torch import nn

from repro_torch.device import resolve_device
from repro_torch.models.blocks import Block
from repro_torch.models.common import ModelConfig
from repro_torch.models.layers import (apply_dense, apply_embedding,
                                       apply_norm, apply_unembed, init_dense,
                                       init_embedding, init_norm)

MODES = ("train", "encode")


class Model(nn.Module):
    def __init__(self, cfg: ModelConfig, gen: torch.Generator):
        super().__init__()
        self.cfg = cfg
        dtype = cfg.torch_dtype
        self.embed = init_embedding(gen, cfg.vocab_size, cfg.d_model, dtype)
        self.layers = nn.ModuleList(Block(gen, cfg, i)
                                    for i in range(cfg.num_layers))
        self.final_norm = init_norm(cfg.d_model, cfg.norm_kind)
        if not cfg.tie_embeddings:
            self.head = init_dense(gen, cfg.d_model, cfg.vocab_size, dtype)

    def forward(self, tokens, mode: str = "train"):
        if mode not in MODES:
            raise ValueError(f"mode {mode!r} not in {MODES}")
        cfg = self.cfg
        x = apply_embedding(self.embed, tokens)
        if cfg.embed_scale:
            x = x * math.sqrt(cfg.d_model)
        B, S = tokens.shape
        positions = torch.arange(S, device=tokens.device)[None, :].expand(B, S)
        for block in self.layers:
            x = block(x, positions)
        x = apply_norm(self.final_norm, x, cfg.norm_eps, cfg.norm_kind)
        if mode == "encode":
            return x
        if cfg.tie_embeddings:
            return apply_unembed(self.embed, x)
        return apply_dense(self.head, x)


def init_model(cfg: ModelConfig, seed: int = 0, device=None) -> Model:
    """A model with weights drawn from ``torch.Generator(seed)`` on the
    CPU, then moved to ``device`` (default: the card; raises without
    one)."""
    dev = resolve_device(device)
    gen = torch.Generator().manual_seed(seed)
    return Model(cfg, gen).to(dev)


def forward(model: Model, batch, *, mode: str = "train"):
    """Logits (B, S, V) in ``train`` mode, hidden states (B, S, d) in
    ``encode`` mode, for ``batch["tokens"]`` (B, S)."""
    return model(batch["tokens"], mode=mode)


def encode(model: Model, batch):
    """Final-norm hidden states (B, S, d) — used by the Tryage router."""
    return forward(model, batch, mode="encode")


def count_params(model: nn.Module) -> int:
    return sum(p.numel() for p in model.parameters())
