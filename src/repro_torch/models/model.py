"""The model: embed -> blocks -> final norm -> (tied) logits.

``Model`` holds the JAX package's parameter tree as modules: ``embed``
(``table``), one ``Block`` per layer where the JAX package stacks a
``units`` tree along a leading layer axis and scans (plus its ``rem``
layers), ``final_norm``, and ``head`` when embeddings are untied.
Layer ``i`` has kind ``layer_pattern[i % len(layer_pattern)]`` and an
MoE MLP where ``moe_pattern[i % len(moe_pattern)]`` is set: the units
one after another, then the remainder layers.  The layer loop is
a Python loop.  Modes: ``train`` returns logits, ``encode`` the
final-norm hidden states; ``prefill`` and ``decode`` return logits and
a list with one state per layer (a recurrent state, or an attention
layer's KV cache).  Inputs are token ids, or for the modality stubs
(``embed_inputs=False``, the ``vlm`` and ``audio`` families) embeddings
(B, S, d) that take the embedding table's place.

Remat (``train`` and ``encode``, as ``repro.models.model.forward`` does
it): the full units run in groups of ``unit_group`` units (1 unless the
number of full units divides by it), each group under
``torch.utils.checkpoint.checkpoint(use_reentrant=False)``, so only the
groups' boundaries are kept for the backward and each group's forward
runs again inside it; the remainder layers run outside any checkpoint.
The MoE load-balance term leaves each group with the hidden state.
Remat changes no number; a remat'd layer's forward kernels run twice a
training step.
"""

from __future__ import annotations

import math

import torch
from torch import nn
from torch.utils.checkpoint import checkpoint

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
        pat, moes = cfg.layer_pattern, cfg.moe_pattern
        self.layers = nn.ModuleList(
            Block(gen, cfg, pat[i % len(pat)], i, moes[i % len(moes)])
            for i in range(cfg.num_layers))
        self.final_norm = init_norm(cfg.d_model, cfg.norm_kind)
        if not cfg.tie_embeddings:
            self.head = init_dense(gen, cfg.d_model, cfg.vocab_size, dtype)

    def forward(self, tokens=None, mode: str = "train", state=None,
                index=0, embeds=None, cache_capacity=None, with_aux=False,
                remat=False, unit_group=1):
        """``train``: logits, or with ``with_aux`` (logits, the MoE
        layers' load-balance terms summed in layer order, an f32 scalar);
        ``encode``: hidden states; ``prefill``: (logits, states), every
        attention cache of ``cache_capacity`` slots (default S; window
        layers their ring); ``decode``: (logits, states) one step on
        from ``state``, the tokens at position ``index``.  ``embeds``
        (B, S, d) replaces ``tokens``.  ``remat`` and ``unit_group``
        act in ``train`` and ``encode`` modes (see the module)."""
        if mode not in MODES:
            raise ValueError(f"mode {mode!r} not in {MODES}")
        if mode == "decode" and state is None:
            raise ValueError("decode needs the state of a prefill")
        cfg = self.cfg
        x = self._embed_in(tokens, embeds)
        B, S = x.shape[0], x.shape[1]
        offset = index if mode == "decode" else 0
        positions = (torch.arange(S, device=x.device)[None, :]
                     + offset).expand(B, S)
        if cfg.attn.use_mrope:   # text: the three streams are equal
            positions = positions[None].expand(3, B, S)
        states = []
        aux = torch.zeros((), device=x.device) if with_aux else None
        first = 0
        if remat and mode in ("train", "encode"):
            unit = len(cfg.layer_pattern)
            U = cfg.num_layers // unit
            g = unit_group if (unit_group > 1 and U % unit_group == 0) else 1
            for first in range(0, U * unit, g * unit):
                x, a = checkpoint(self._group, x, positions, mode, first,
                                  first + g * unit, use_reentrant=False)
                aux = aux + a if with_aux else None
            first = U * unit
        for i, block in enumerate(self.layers[first:], first):
            x, st, a = block(x, mode=mode, positions=positions,
                             state=state[i] if mode == "decode" else None,
                             index=index, cache_capacity=cache_capacity)
            states.append(st)
            if with_aux and block.use_moe:
                aux = aux + a
        x = apply_norm(self.final_norm, x, cfg.norm_eps, cfg.norm_kind)
        if mode == "encode":
            return x
        if cfg.tie_embeddings:
            logits = apply_unembed(self.embed, x)
        else:
            logits = apply_dense(self.head, x)
        if mode in ("prefill", "decode"):
            return logits, states
        return (logits, aux) if with_aux else logits

    def _group(self, x, positions, mode, lo, hi):
        """Layers [lo, hi) in ``train`` or ``encode`` mode: (x, their MoE
        terms summed in layer order)."""
        aux = torch.zeros((), device=x.device)
        for block in self.layers[lo:hi]:
            x, _, a = block(x, mode=mode, positions=positions)
            if block.use_moe:
                aux = aux + a
        return x, aux

    def _embed_in(self, tokens, embeds):
        """The first block's input.  ``embed_scale`` multiplies by
        sqrt(d_model) rounded to the activations' type first, as the
        JAX package does (in bf16 at d 2560: 50.5, not 50.596)."""
        cfg = self.cfg
        if embeds is not None:
            x = embeds.to(cfg.torch_dtype)
        else:
            x = apply_embedding(self.embed, tokens)
        if cfg.embed_scale:
            x = x * torch.tensor(math.sqrt(cfg.d_model), dtype=x.dtype).item()
        return x


def init_model(cfg: ModelConfig, seed: int = 0, device=None) -> Model:
    """A model with weights drawn on ``device`` (default: the card;
    raises without one) from a ``torch.Generator`` seeded with ``seed``
    on that device, so a full-width model is drawn where it lives."""
    dev = resolve_device(device)
    with dev:
        return Model(cfg, torch.Generator(dev).manual_seed(seed))


def init_decode_state(cfg: ModelConfig, batch: int, cache_len: int = 0,
                      device=None) -> list:
    """One zero state per layer (``repro.models.model.init_decode_state``
    with the stacked units laid out layer by layer): recurrent states,
    and KV caches of ``cache_len`` slots (``min(cache_len, window)`` for
    a window layer)."""
    dev = resolve_device(device)
    pat = cfg.layer_pattern
    return [init_block_state(cfg, pat[i % len(pat)], batch, cache_len, dev,
                             layer_idx=i)
            for i in range(cfg.num_layers)]


def forward(model: Model, batch, *, mode: str = "train"):
    """Logits (B, S, V) in ``train`` mode, hidden states (B, S, d) in
    ``encode`` mode, for ``batch["tokens"]`` (B, S) or
    ``batch["embeds"]`` (B, S, d)."""
    return model(batch.get("tokens"), mode=mode, embeds=batch.get("embeds"))


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


def lm_loss(model: Model, batch, remat=True, unit_group: int = 1):
    """Causal-LM (decoder) or MLM (encoder) loss. Returns (loss,
    metrics): the CE plus ``router_aux_weight`` times the MoE layers'
    summed load-balance term, with {"ce", "aux"}.  ``remat`` and
    ``unit_group`` as ``Model.forward`` takes them (the reference's
    defaults)."""
    cfg = model.cfg
    logits, aux = model(batch.get("tokens"), mode="train",
                        embeds=batch.get("embeds"), with_aux=True,
                        remat=remat, unit_group=unit_group)
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
    loss = ce + cfg.moe.router_aux_weight * aux if cfg.moe else ce
    return loss, {"ce": ce, "aux": aux}


def prefill(model: Model, batch, cache_capacity=None):
    """(logits (B, S, V), per-layer states) over ``batch["tokens"]`` or
    ``batch["embeds"]``; full-attention caches hold ``cache_capacity``
    slots (default S: pass S + the tokens still to decode)."""
    return model(batch.get("tokens"), mode="prefill",
                 embeds=batch.get("embeds"), cache_capacity=cache_capacity)


def decode_step(model: Model, token_batch, state, index):
    """token_batch: {"tokens": (B, 1)} (or {"embeds": (B, 1, d)}) at
    position ``index``.  Returns (logits (B, V), per-layer states)."""
    logits, state = model(token_batch.get("tokens"), mode="decode",
                          state=state, index=index,
                          embeds=token_batch.get("embeds"))
    return logits[:, -1], state


def count_params(model: nn.Module) -> int:
    return sum(p.numel() for p in model.parameters())
