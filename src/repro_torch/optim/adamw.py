"""AdamW over a module's parameters, as ``repro.optim.adamw`` computes it.

Not ``torch.optim.AdamW``: the reference's update differs from it in
ways a parity test sees.  The global-norm clip scales by
``min(1, clip / max(gnorm, 1e-9))`` (``clip_grad_norm_`` uses
``clip / (norm + 1e-6)``); weight decay is added to the Adam direction
of every leaf, biases, norms and the tied embedding included, and
scaled by the learning rate; the step count is incremented before the
schedule and the bias corrections read it.  Moments are f32 whatever
the parameter's type.

Unlike the JAX function, ``adamw_update`` writes the new parameters and
moments in place (a full copy of the weights a step would cost memory
for nothing); it returns the module and the new ``OptState``.  A leaf
of more than ``CHUNK`` elements is read in flat slices of at most that
many, so the update's f32 temporaries take about 1.5 GB however large
the leaf (grok-1's expert weights hold 1.6 B elements a leaf): every
element takes the same operations, so the values are the same; only
the clip's sum of squares adds the slices' sums in turn.

On DTensor parameters (a sharded step, ``launch.steps.shard_model``)
each gradient is first laid out as its parameter, the moments must be
laid out so too (``launch.steps.shard_opt_state``; ``adamw_init`` of a
sharded module makes them so), and the clip's global norm sums every
leaf's squares over all its shards before the square root, so each
device scales by the same norm the meshless step reads.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Callable

import torch
from torch import nn

from repro_torch.sharding.context import is_dtensor, replicating

#: elements of a leaf the update reads at once (a DTensor's whole)
CHUNK = 1 << 26


@dataclasses.dataclass
class OptState:
    step: int
    mu: dict                 # parameter name -> f32 first moment
    nu: dict                 # parameter name -> f32 second moment


def adamw_init(params: nn.Module) -> OptState:
    zeros = {n: torch.zeros_like(p, dtype=torch.float32)
             for n, p in params.named_parameters()}
    return OptState(step=0, mu=zeros,
                    nu={n: z.clone() for n, z in zeros.items()})


@torch.no_grad()
def adamw_update(params: nn.Module, grads: dict, state: OptState, *, lr,
                 b1=0.9, b2=0.999, eps=1e-8, weight_decay=1e-5,
                 grad_clip=1.0):
    """One AdamW step on ``params`` (in place) from ``grads`` (name ->
    gradient, e.g. ``grads_of(params)``).  ``lr`` may be a float or a
    schedule fn(step) -> float.  Returns (params, new state)."""
    step = state.step + 1
    lr_t = float(lr(step)) if callable(lr) else lr
    named = list(params.named_parameters())
    sharded = any(is_dtensor(p) for _, p in named)
    gs = [_laid_as(grads[n], p) for n, p in named]
    with replicating(sharded):
        scale = None
        if grad_clip and grad_clip > 0:
            gnorm = torch.sqrt(sum(_whole(c.float().square().sum())
                                   for g in gs for c in _chunks(g)))
            scale = torch.clamp(grad_clip / gnorm.clamp_min(1e-9), max=1.0)
        c1, c2 = 1 - b1 ** step, 1 - b2 ** step
        for (n, p), g in zip(named, gs):
            for pc, gc, m, v in zip(*(_chunks(t) for t in (
                    p, g, state.mu[n], state.nu[n]))):
                if scale is not None:
                    gc = gc * scale.to(gc.dtype)
                g32 = gc.float()
                m.mul_(b1).add_(g32, alpha=1 - b1)
                v.mul_(b2).add_(g32.square(), alpha=1 - b2)
                p32 = pc.float()
                delta = ((m / c1) / ((v / c2).sqrt() + eps)
                         + weight_decay * p32)
                pc.copy_((p32 - lr_t * delta).to(pc.dtype))
    return params, OptState(step=step, mu=state.mu, nu=state.nu)


def _chunks(t) -> list:
    """Flat views of ``t`` of at most CHUNK elements each (``t`` itself
    when it is smaller, or a DTensor); a parameter or moment written in
    place must be contiguous."""
    if is_dtensor(t) or t.numel() <= CHUNK:
        return [t]
    return list(t.view(-1).split(CHUNK))


def _laid_as(g, p):
    """Gradient ``g`` laid out as its DTensor parameter ``p`` (partial
    sums reduced), or ``g`` itself off a mesh."""
    if is_dtensor(g) and tuple(g.placements) != tuple(p.placements):
        return g.redistribute(p.device_mesh, p.placements)
    return g


def _whole(t):
    """A DTensor's value over all its shards as a plain tensor."""
    return t.full_tensor() if is_dtensor(t) else t


def grads_of(params: nn.Module) -> dict:
    """Name -> ``.grad`` of every parameter (zeros where autograd left
    none, as ``jax.grad`` returns zeros for an unused leaf)."""
    return {n: (p.grad if p.grad is not None else torch.zeros_like(p))
            for n, p in params.named_parameters()}


def exp_decay_schedule(base_lr: float, decay: float,
                       steps_per_decay: int) -> Callable:
    def fn(step):
        return base_lr * decay ** (step / steps_per_decay)
    return fn


def cosine_schedule(base_lr: float, total_steps: int,
                    min_frac=0.1) -> Callable:
    def fn(step):
        t = min(max(step / total_steps, 0.0), 1.0)
        return base_lr * (min_frac + (1 - min_frac) * 0.5
                          * (1 + math.cos(math.pi * t)))
    return fn


def warmup_cosine_schedule(base_lr: float, warmup: int, total_steps: int,
                           min_frac=0.0) -> Callable:
    cos = cosine_schedule(base_lr, max(total_steps - warmup, 1), min_frac)

    def fn(step):
        if step < warmup:
            return base_lr * min(max(step / max(warmup, 1), 0.0), 1.0)
        return cos(step - warmup)
    return fn
