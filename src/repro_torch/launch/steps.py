"""Training, prefill and greedy decode steps for a model of the zoo:
the counterparts of ``repro.launch.steps.build_train_step``,
``build_prefill_step`` and ``build_decode_step`` on one device, without
mesh, sharding or jit.

Each runs on the model's device and never moves the model.  ``device``
names where the caller expects it to be: left unset it is the card, so
without a CUDA device they raise rather than run on the CPU.

``PerfKnobs`` keeps the reference's knobs that mean something on one
card: ``microbatch``, ``remat`` and ``unit_group``, and
``moment_dtype``, which must stay ``"float32"``: the reference's update
computes f32 moments whatever it says (``src/repro/optim/adamw.py``
lines 27-31 and 45-47; the knob reaches only its abstract shardings).
``attn_impl``, ``rule_overrides`` and ``donate`` have no single-card
meaning and are not ported: the attention is the kernel's on the card,
there is no mesh to lay rules on, and the step updates the model in
place.
"""

from __future__ import annotations

import dataclasses

import torch

from repro_torch.device import module_device, resolve_device
from repro_torch.models import model as model_lib
from repro_torch.optim.adamw import OptState, adamw_update, grads_of


@dataclasses.dataclass
class PerfKnobs:
    microbatch: int = 1
    moment_dtype: str = "float32"
    remat: bool = True
    unit_group: int = 1      # sqrt-depth remat: boundaries every g units

    def __post_init__(self):
        if self.moment_dtype != "float32":
            raise ValueError(
                f"PerfKnobs: moment_dtype {self.moment_dtype!r}; the moments "
                f"are float32 as the reference's update computes them "
                f"whatever the knob says (src/repro/optim/adamw.py:27-31,"
                f"45-47)")
        if self.microbatch < 1 or self.unit_group < 1:
            raise ValueError(f"PerfKnobs: microbatch {self.microbatch} and "
                             f"unit_group {self.unit_group} must be >= 1")


def train_step(model, opt: OptState, batch, *, knobs: PerfKnobs = PerfKnobs(),
               lr=5e-5, device=None):
    """One AdamW step of ``lm_loss`` (weight decay 1e-5) on ``batch``
    (``{"tokens"}``, ``{"tokens", "mask"}``, or for the MLM, vlm and audio
    families ``{"embeds", "targets", "mask"}``, numpy arrays or tensors):
    ``model`` and ``opt`` are updated in place; returns the loss (an f32
    scalar tensor).  With ``microbatch`` n > 1 the batch is split along
    its first axis, the gradients are added in f32 in microbatch order
    and divided by n, as the loss is; with n = 1 the gradients reach
    AdamW in the parameters' type, as in the reference (its clip rounds
    the scale to the gradients' type)."""
    dev = _on_device(model, device)
    inputs = {k: torch.as_tensor(v, device=dev) for k, v in batch.items()}
    n = knobs.microbatch

    def loss_of(b):
        model.zero_grad(set_to_none=True)
        loss, _ = model_lib.lm_loss(model, b, remat=knobs.remat,
                                    unit_group=knobs.unit_group)
        loss.backward()
        return loss.detach()

    with torch.enable_grad():
        if n == 1:
            loss = loss_of(inputs)
            grads = grads_of(model)
        else:
            B = next(iter(inputs.values())).shape[0]
            if B % n:
                raise ValueError(f"train_step: batch {B} does not split into "
                                 f"{n} microbatches")
            grads = {name: torch.zeros(p.shape, dtype=torch.float32,
                                       device=dev)
                     for name, p in model.named_parameters()}
            loss = torch.zeros((), dtype=torch.float32, device=dev)
            for i in range(n):
                part = {k: v.reshape(n, B // n, *v.shape[1:])[i]
                        for k, v in inputs.items()}
                loss = loss + loss_of(part).float()
                for name, g in grads_of(model).items():
                    grads[name] += g.float()
            grads = {name: g / n for name, g in grads.items()}
            loss = loss / n
    _, new = adamw_update(model, grads, opt, lr=lr, weight_decay=1e-5)
    opt.step = new.step          # mu and nu were updated in place
    model.zero_grad(set_to_none=True)
    return loss


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
