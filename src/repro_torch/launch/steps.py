"""Prefill and greedy decode steps for a model of the zoo: the
counterparts of ``repro.launch.steps.build_prefill_step`` and
``build_decode_step`` on one device, without mesh, sharding or jit.

Both run on the model's device and never move the model.  ``device``
names where the caller expects it to be: left unset it is the card, so
without a CUDA device they raise rather than run on the CPU.
"""

from __future__ import annotations

import torch

from repro_torch.device import module_device, resolve_device
from repro_torch.models import model as model_lib


def _on_device(model, device) -> torch.device:
    dev = resolve_device(device)
    have = module_device(model)
    if have != dev:
        raise ValueError(f"the model is on {have}, not on {dev}")
    return dev


@torch.inference_mode()
def prefill_step(model, batch, *, cache_capacity=None, device=None):
    """batch: {"tokens": (B, S) ints} or, for the modality stubs,
    {"embeds": (B, S, d)}.  Returns (the last position's logits (B, V)
    in f32, per-layer states); full-attention caches hold
    ``cache_capacity`` slots (default S: pass S + the tokens to
    decode)."""
    dev = _on_device(model, device)
    name = "embeds" if "embeds" in batch else "tokens"
    inputs = {name: torch.as_tensor(batch[name], device=dev)}
    logits, state = model_lib.prefill(model, inputs,
                                      cache_capacity=cache_capacity)
    return logits[:, -1].float(), state


@torch.inference_mode()
def serve_step(model, state, tokens, index, *, device=None):
    """One greedy decode step: tokens (B, 1) at position ``index``.
    Returns (next tokens (B, 1) int32, per-layer states)."""
    dev = _on_device(model, device)
    tokens = torch.as_tensor(tokens, device=dev)
    logits, state = model_lib.decode_step(model, {"tokens": tokens}, state,
                                          index)
    return logits.argmax(dim=-1).to(torch.int32)[:, None], state
