"""The model: embed -> blocks -> final norm -> (tied) logits.

``Model`` holds the JAX package's parameter tree as modules: ``embed``
(``table``), one ``Block`` per layer where the JAX package stacks a
``units`` tree along a leading layer axis and scans (plus its ``rem``
layers), ``final_norm``, and ``head`` when embeddings are untied.
Layer ``i`` has kind ``layer_pattern[i % len(layer_pattern)]``: the
units one after another, then the remainder layers.  The layer loop is
a Python loop.  Modes: ``train`` returns logits, ``encode`` the
final-norm hidden states; ``prefill`` and ``decode`` return logits and
a list with one recurrent state per layer.
"""

from __future__ import annotations

import math

import torch
from torch import nn

from repro_torch.device import resolve_device
from repro_torch.models.blocks import MODES, Block, init_block_state
from repro_torch.models.common import ModelConfig
from repro_torch.models.layers import (apply_dense, apply_embedding,
                                       apply_norm, apply_unembed, init_dense,
                                       init_embedding, init_norm)


class Model(nn.Module):
    def __init__(self, cfg: ModelConfig, gen: torch.Generator):
        super().__init__()
        self.cfg = cfg
        dtype = cfg.torch_dtype
        self.embed = init_embedding(gen, cfg.vocab_size, cfg.d_model, dtype)
        pat = cfg.layer_pattern
        self.layers = nn.ModuleList(Block(gen, cfg, pat[i % len(pat)], i)
                                    for i in range(cfg.num_layers))
        self.final_norm = init_norm(cfg.d_model, cfg.norm_kind)
        if not cfg.tie_embeddings:
            self.head = init_dense(gen, cfg.d_model, cfg.vocab_size, dtype)

    def forward(self, tokens, mode: str = "train", state=None, index=0):
        """``train``: logits; ``encode``: hidden states; ``prefill``:
        (logits, states) from zero states; ``decode``: (logits, states)
        one step on from ``state``, the tokens at position ``index``."""
        if mode not in MODES:
            raise ValueError(f"mode {mode!r} not in {MODES}")
        if mode == "decode" and state is None:
            raise ValueError("decode needs the state of a prefill")
        cfg = self.cfg
        x = apply_embedding(self.embed, tokens)
        if cfg.embed_scale:
            x = x * math.sqrt(cfg.d_model)
        B, S = tokens.shape
        offset = index if mode == "decode" else 0
        positions = (torch.arange(S, device=tokens.device)[None, :]
                     + offset).expand(B, S)
        states = []
        for i, block in enumerate(self.layers):
            x, st = block(x, mode=mode, positions=positions,
                          state=state[i] if mode == "decode" else None)
            states.append(st)
        x = apply_norm(self.final_norm, x, cfg.norm_eps, cfg.norm_kind)
        if mode == "encode":
            return x
        if cfg.tie_embeddings:
            logits = apply_unembed(self.embed, x)
        else:
            logits = apply_dense(self.head, x)
        if mode in ("prefill", "decode"):
            return logits, states
        return logits


def init_model(cfg: ModelConfig, seed: int = 0, device=None) -> Model:
    """A model with weights drawn on ``device`` (default: the card;
    raises without one) from a ``torch.Generator`` seeded with ``seed``
    on that device, so a full-width model is drawn where it lives."""
    dev = resolve_device(device)
    with dev:
        return Model(cfg, torch.Generator(dev).manual_seed(seed))


def init_decode_state(cfg: ModelConfig, batch: int, device=None) -> list:
    """One zero recurrent state per layer (``repro.models.model.
    init_decode_state`` with the stacked units laid out layer by
    layer)."""
    dev = resolve_device(device)
    pat = cfg.layer_pattern
    return [init_block_state(cfg, pat[i % len(pat)], batch, dev)
            for i in range(cfg.num_layers)]


def forward(model: Model, batch, *, mode: str = "train"):
    """Logits (B, S, V) in ``train`` mode, hidden states (B, S, d) in
    ``encode`` mode, for ``batch["tokens"]`` (B, S)."""
    return model(batch["tokens"], mode=mode)


def encode(model: Model, batch):
    """Final-norm hidden states (B, S, d) — used by the Tryage router."""
    return forward(model, batch, mode="encode")


# ------------------------------------------------------------- losses

def cross_entropy(logits, targets, mask):
    """Masked mean CE in f32. logits (B,S,V); targets (B,S); mask (B,S).
    The mean is over ``max(sum(mask), 1)`` as in the reference."""
    logits = logits.float()
    logz = torch.logsumexp(logits, dim=-1)
    gold = logits.gather(-1, targets.long()[..., None])[..., 0]
    mask = mask.float()
    return ((logz - gold) * mask).sum() / mask.sum().clamp_min(1.0)


def lm_loss(model: Model, batch):
    """Causal-LM (decoder) or MLM (encoder) loss. Returns (loss,
    metrics).  No port config has MoE layers, so the loss is the CE
    alone (the reference adds ``router_aux_weight * aux``, 0 here)."""
    cfg = model.cfg
    logits = forward(model, batch, mode="train")
    if cfg.is_encoder:
        ce = cross_entropy(logits, batch["targets"], batch["mask"])
    else:
        tokens = batch.get("targets")
        if tokens is None:
            tokens = batch["tokens"]
        mask = batch.get("mask")
        if mask is None:
            mask = torch.ones_like(tokens)
        ce = cross_entropy(logits[:, :-1], tokens[:, 1:], mask[:, 1:])
    return ce, {"ce": ce, "aux": torch.zeros((), device=ce.device)}


def prefill(model: Model, batch):
    """(logits (B, S, V), per-layer states) over ``batch["tokens"]``."""
    return model(batch["tokens"], mode="prefill")


def decode_step(model: Model, token_batch, state, index):
    """token_batch: {"tokens": (B, 1)} at position ``index``.  Returns
    (logits (B, V), per-layer states)."""
    logits, state = model(token_batch["tokens"], mode="decode", state=state,
                          index=index)
    return logits[:, -1], state


def count_params(model: nn.Module) -> int:
    return sum(p.numel() for p in model.parameters())
